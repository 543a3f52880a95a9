"""The recurrent families against the reference, on the CPU: RecurrentGemma
(RG-LRU blocks and local attention, ``models/rglru.py``) and RWKV-6 (time
and channel mixing, ``models/rwkv6.py``), the plain versions of their
kernels (``kernels.linear_scan``, ``kernels.wkv6``), and both models at
their ``.smoke()`` widths on the reference's ``init_params`` weights
carried over by ``params_from_numpy``.

The reference initialises many leaves to zero (the token-shift mixes, the
decay's base and LoRA output, the bonus u, the group norm, the conv and
gate biases), under which a fault in the shifts or the conv barely moves
an output: every zero-initialised leaf is redrawn here from a seeded
normal (std ``REDRAW_STD``), the same values in both packages.  Inputs
come from numpy's generator.

Tolerances:

* float32: the reference tests' own (``tests/test_rwkv_rglru.py``):
  atol = rtol = 1e-5 (``F32``), and against the chunked WKV atol 3e-4,
  rtol 1e-4 (``CHUNKED``; at the property test's three decay ranges its
  5e-4, 5e-4, ``EXTREME``).  A whole model's float32 full forward at
  1e-5 of its logits' largest magnitude (``F32_REL``).
* bf16 at 2^-6 of the output's largest magnitude (``BF16_REL``, as
  ``tests/test_torch_moe.py``): the two packages round bf16 at other
  points.  The reference's ``prefill`` and ``decode_step`` take no
  activation dtype and run bf16 whatever the parameters' dtype (as the
  port's do by default), so both models' prefill and decode, on float32
  and on bf16 parameters, are held at BF16_REL.
* decode against the port's own full forward at the reference decode
  test's relation (relative max error < 0.02, ``DECODE_REL``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as JRG
from repro.models import rwkv6 as JRWKV
from repro.models import transformer as JT
from repro.models.layers import PSpec as JPSpec

from repro_torch import configs
from repro_torch.kernels import linear_scan, wkv6
from repro_torch.kernels.linear_scan import rglru_coefficients
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RWKV
from repro_torch.models import transformer as T

import lm_weights


# the reference's init_params seeds each leaf with hash(path), randomised
# per process: crc32 of the path instead, for the whole module
# (tests/lm_weights.py)
@pytest.fixture(scope="module", autouse=True)
def _stable_weights():
    yield from lm_weights.stable_weights()

ARCHS = ["recurrentgemma-2b", "rwkv6-1.6b"]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
F32 = dict(atol=1e-5, rtol=1e-5)
CHUNKED = dict(atol=3e-4, rtol=1e-4)
EXTREME = dict(atol=5e-4, rtol=5e-4)
F32_REL = 1e-5
BF16_REL = 2.0 ** -6
DECODE_REL = 0.02
REDRAW_STD = 0.5
# the reference property test's three decay ranges (log of -log w),
# each at a fixed seed
DECAYS = {"wide": (-8.0, 3.0), "fast": (-2.0, 0.0), "slow": (-10.0, -5.0)}
B, S, P = 2, 24, 8          # batch, full length, prompt length
STEPS = 3                   # teacher-forced decode steps


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(f32(x)))


def assert_rel(got, want, rtol, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


def leaves(tree, prefix=""):
    """A nested dict's leaves by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def redrawn_params(jcfg, seed=0):
    """The reference's ``init_params`` tree with every zero-initialised
    leaf redrawn from a seeded normal of std REDRAW_STD (numpy, float32)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0)))
    specs = JT.model_pspecs(jcfg)

    def redraw(spec, x):
        if spec.init != "zeros":
            return x
        return (REDRAW_STD * rng.standard_normal(x.shape)).astype(x.dtype)
    return jax.tree.map(redraw, specs, params,
                        is_leaf=lambda s: isinstance(s, JPSpec))


def layer_caches(jcfg, jc) -> list:
    """The reference's caches ({"groups": one stack a pattern position,
    "rem"}) as one cache a layer, in layer order."""
    plen, groups = jcfg.pattern_len, jcfg.num_groups
    out = []
    for layer in range(jcfg.num_layers):
        g, i = divmod(layer, plen)
        out.append(jax.tree.map(lambda a: a[g], jc["groups"][i])
                   if g < groups else jc["rem"][layer - groups * plen])
    return out


# ------------------------------------------------------------------ RG-LRU

def _rglru_params(seed, w):
    """The reference test's RG-LRU gate parameters, numpy float32."""
    r = np.random.default_rng(seed)
    return {
        "wi": (0.3 * r.standard_normal((w, w))).astype(np.float32),
        "bi": (0.1 * r.standard_normal(w)).astype(np.float32),
        "wa": (0.3 * r.standard_normal((w, w))).astype(np.float32),
        "ba": (0.1 * r.standard_normal(w)).astype(np.float32),
        "lam": (np.abs(r.standard_normal(w)) + 0.3).astype(np.float32),
    }


@pytest.mark.parametrize("chunk", [8, 1024])
def test_rg_lru_matches_the_reference(chunk):
    """The plain linear_scan (through ``rg_lru``) against the reference's
    chunked associative scan, and its coefficients against ``_gates``."""
    Bn, Sn, w = 2, 48, 8
    r = np.random.default_rng(0)
    p = _rglru_params(1, w)
    u = r.standard_normal((Bn, Sn, w)).astype(np.float32)
    h0 = r.standard_normal((Bn, w)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y, hf = JRG.rg_lru(jp, jnp.asarray(u), jnp.asarray(h0), chunk=chunk)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, got_h = RG.rg_lru(tp, torch.from_numpy(u), torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(y), **F32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hf), **F32)
    a, b = JRG._gates(jp, jnp.asarray(u))
    xi, xa = RG._preactivations(tp, torch.from_numpy(u))
    ga, gb = rglru_coefficients(xi, xa, torch.from_numpy(u), tp["lam"])
    np.testing.assert_allclose(ga.numpy(), np.asarray(a), **F32)
    np.testing.assert_allclose(gb.numpy(), np.asarray(b), **F32)


def test_rg_lru_decode_continues_the_sequence():
    """A prefill of 10 then S = 1 steps (the decode path) equal the whole
    sequence, in the port, and the reference's decode steps."""
    Bn, Sn, w = 1, 16, 8
    r = np.random.default_rng(3)
    p = _rglru_params(2, w)
    u = r.standard_normal((Bn, Sn, w)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tu, h0 = torch.from_numpy(u), torch.zeros(Bn, w)
    y_full, _ = RG.rg_lru(tp, tu, h0)
    _, h = RG.rg_lru(tp, tu[:, :10], h0)
    jh = jnp.asarray(h.numpy())
    for step in range(10, Sn):
        yt, h = RG.rg_lru(tp, tu[:, step:step + 1], h)
        jy, jh = JRG.rg_lru({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(u[:, step:step + 1]), jh)
        np.testing.assert_allclose(yt[:, 0].numpy(), y_full[:, step].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(yt.numpy(), np.asarray(jy), **F32)


# --------------------------------------------------------------------- WKV

def _wkv_inputs(seed, Bn=2, Sn=96, H=2, D=8, decay_lo=-6.0, decay_hi=2.0):
    """The reference test's WKV inputs, numpy float32."""
    r = np.random.default_rng(seed)
    mk = lambda: r.standard_normal((Bn, Sn, H, D)).astype(np.float32)
    rr, k, v = mk(), mk(), mk()
    lw = (-np.exp(r.uniform(decay_lo, decay_hi, (Bn, Sn, H, D)))
          ).astype(np.float32)
    u = r.standard_normal((H, D)).astype(np.float32)
    s0 = r.standard_normal((Bn, H, D, D)).astype(np.float32)
    return rr, k, v, lw, u, s0


WKV_CASES = [("default", None, 16), ("default", None, 32)] + [
    (name, rng, 16) for name, rng in DECAYS.items()]


@pytest.mark.parametrize("name,decay,chunk", WKV_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in WKV_CASES])
def test_wkv_matches_the_reference(name, decay, chunk):
    """The plain wkv6 against the reference's oracle ``wkv_sequential`` at
    F32 and its ``wkv_chunked`` at CHUNKED (EXTREME at the property test's
    decay ranges, each at a fixed seed)."""
    if decay is None:
        ins = _wkv_inputs(0)
        tol = CHUNKED
    else:
        seed = 1000 + list(DECAYS).index(name)
        ins = _wkv_inputs(seed, Bn=1, Sn=64, H=1, D=4, decay_lo=decay[0],
                          decay_hi=decay[1])
        tol = EXTREME
    y, st = wkv6(*(torch.from_numpy(a) for a in ins))
    assert y.dtype == st.dtype == torch.float32
    js = [jnp.asarray(a) for a in ins]
    y1, f1 = JRWKV.wkv_sequential(*js)
    y2, f2 = JRWKV.wkv_chunked(*js, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y1), **F32)
    np.testing.assert_allclose(st.numpy(), np.asarray(f1), **F32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(f2), **tol)


def test_wkv_decode_continues_the_sequence():
    """Steps of S = 1 from the state a prefix leaves equal the whole
    sequence (the decode path of time_mix_apply); bf16 r, k, v are
    widened exactly."""
    rr, k, v, lw, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(5))
    rb, kb, vb = (x.bfloat16() for x in (rr, k, v))
    y_full, s_full = wkv6(rb, kb, vb, lw, u, s0)
    y_wide, _ = wkv6(rb.float(), kb.float(), vb.float(), lw, u, s0)
    assert torch.equal(y_full, y_wide)
    _, state = wkv6(rb[:, :40], kb[:, :40], vb[:, :40], lw[:, :40], u, s0)
    for step in range(40, rr.shape[1]):
        sl = slice(step, step + 1)
        yt, state = wkv6(rb[:, sl], kb[:, sl], vb[:, sl], lw[:, sl], u,
                         state)
        np.testing.assert_allclose(yt[:, 0].numpy(), y_full[:, step].numpy(),
                                   **F32)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), **F32)


def wkv6_chunk_algebra(r, k, v, lw, u, state0, C=64, T=16):
    """A torch transcription of ``csrc/wkv6.cu``'s chunked kernel, in
    float32: chunks of C positions (the last zero-filled: r = k = v = 0,
    lw = 0), sub-chunks of T; every decay factor a product of the step
    decays w = exp(lw) (<= 1).  Within sub-chunk I: the exclusive prefix
    H and suffix G products and the total T_I (a product down the chunk,
    and up it for suf); Q = r H, K~ = k G; pre_I, suf_J, decay across
    sub-chunks; y = (Q pre) S_prev + A V with A's
    off-diagonal sub-blocks Q (K~ g_IJ), g_IJ = prod_{J<M<I} T_M, its
    diagonal sub-blocks by a running product down each row j, A_ii = r_i
    . (u k_i); S = decay S_prev + (K~ suf)^T V."""
    Bn, Sn, H, D = r.shape
    n = -(-Sn // C) * C
    NS = C // T

    def pad(x):
        return torch.cat([x.float(), x.new_zeros(Bn, n - Sn, H, D).float()],
                         1)
    rf, kf, vf, w = pad(r), pad(k), pad(v), torch.exp(pad(lw))
    state, ys = state0.clone(), []
    for c0 in range(0, n, C):
        rc, kc, vc, wc = (x[:, c0:c0 + C].reshape(Bn, NS, T, H, D)
                          for x in (rf, kf, vf, w))
        hp, g = torch.ones_like(wc), torch.ones_like(wc)
        for t in range(1, T):
            hp[:, :, t] = hp[:, :, t - 1] * wc[:, :, t - 1]
        for t in range(T - 2, -1, -1):
            g[:, :, t] = g[:, :, t + 1] * wc[:, :, t + 1]
        # each sub-chunk's product, down (tot) and up (tot_up) the chunk
        tot = hp[:, :, -1] * wc[:, :, -1]                  # (B, NS, H, D)
        tot_up = g[:, :, 0] * wc[:, :, 0]
        one = torch.ones_like(tot[:, 0])
        pre, suf = [one], [one] * NS
        for i in range(1, NS):
            pre.append(pre[-1] * tot[:, i - 1])
        for j in range(NS - 2, -1, -1):
            suf[j] = suf[j + 1] * tot_up[:, j + 1]
        decay = pre[-1] * tot[:, -1]
        q, kt = rc * hp, kc * g
        rt = torch.cat([q[:, i] * pre[i][:, None] for i in range(NS)], 1)
        kh = torch.cat([kt[:, j] * suf[j][:, None] for j in range(NS)], 1)
        A = torch.zeros(Bn, H, C, C)
        for i in range(NS):
            rows = slice(i * T, (i + 1) * T)
            for j in range(i):
                gij = one
                for m in range(j + 1, i):
                    gij = gij * tot[:, m]
                A[:, :, rows, j * T:(j + 1) * T] = torch.einsum(
                    "bihk,bjhk->bhij", q[:, i], kt[:, j] * gij[:, None])
            for j in range(T):
                kp = kc[:, i, j]
                A[:, :, i * T + j, i * T + j] = torch.einsum(
                    "bhk,bhk->bh", rc[:, i, j], u[None] * kc[:, i, j])
                for ii in range(j + 1, T):
                    if ii > j + 1:
                        kp = kp * wc[:, i, ii - 1]
                    A[:, :, i * T + ii, i * T + j] = torch.einsum(
                        "bhk,bhk->bh", rc[:, i, ii], kp)
        V = vc.reshape(Bn, C, H, D)
        ys.append(torch.einsum("bchk,bhkv->bchv", rt, state)
                  + torch.einsum("bhij,bjhv->bihv", A, V))
        state = decay[..., None] * state + torch.einsum("bchk,bchv->bhkv",
                                                        kh, V)
    return torch.cat(ys, 1)[:, :Sn], state


WKV_CHUNKED_REL = 2.0 ** -16     # the chunked kernel's limit on y, state


@pytest.mark.parametrize("name", list(DECAYS))
def test_wkv_chunk_algebra(name):
    """The chunked kernel's algebra (``wkv6_chunk_algebra``) at D 64 and
    each decay range: finite (no overflow at the strongest); y and state
    within 2^-16 of their largest magnitudes of the plain wkv6 over 200
    positions (three chunks and a ragged one); at EXTREME of the
    reference's ``wkv_chunked`` (chunk 32) over 192."""
    lo, hi = DECAYS[name]
    ins = [torch.from_numpy(a) for a in _wkv_inputs(
        2000 + list(DECAYS).index(name), Bn=1, Sn=200, H=2, D=64,
        decay_lo=lo, decay_hi=hi)]
    y, st = wkv6_chunk_algebra(*ins)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, st_ref = wkv6(*ins)
    assert (y - y_ref).abs().max() <= WKV_CHUNKED_REL * y_ref.abs().max()
    assert (st - st_ref).abs().max() <= WKV_CHUNKED_REL * st_ref.abs().max()
    head = [x[:, :192] for x in ins[:4]] + ins[4:]
    y, st = wkv6_chunk_algebra(*head)
    y2, f2 = JRWKV.wkv_chunked(*(jnp.asarray(x.numpy()) for x in head),
                               chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), **EXTREME)
    np.testing.assert_allclose(st.numpy(), np.asarray(f2), **EXTREME)


# ------------------------------------------------------------------ blocks

@functools.lru_cache(maxsize=None)
def model(arch, dtype):
    """(port cfg, port model, reference cfg, reference params) on the
    redrawn weights, stored in ``dtype``."""
    jcfg = jconfigs.get_arch(arch).smoke()
    tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(
        DTYPES[dtype])), redrawn_params(jcfg))
    jp = jax.tree.map(jnp.asarray, tree)
    cfg = configs.get_arch(arch).smoke()
    return cfg, T.params_from_numpy(cfg, tree, device="cpu"), jcfg, jp


def block_input(cfg, dtype, seed=4):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), DTYPES[dtype])
    return x, t(x).to(getattr(torch, dtype))


def random_cache(tree, seed, dtype):
    """A cache of the given leaves' shapes from numpy's generator: the
    float32 states as they are, the rest rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = random_cache(v, seed + 1, dtype)
            continue
        a = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        out[k] = jnp.asarray(a, jnp.float32 if v.dtype == torch.float32
                             else DTYPES[dtype])
    return out


def to_torch(tree):
    return {k: (to_torch(v) if isinstance(v, dict) else
                t(v).to(torch.float32 if v.dtype == jnp.float32
                        else torch.bfloat16)) for k, v in tree.items()}


def check_pair(got, want, dtype, what):
    """Outputs and caches: float32 at F32, bf16 at BF16_REL."""
    gl = leaves(got) if isinstance(got, dict) else {"": got}
    wl = leaves(want) if isinstance(want, dict) else {"": want}
    assert set(gl) == set(wl), what
    for key in gl:
        if dtype == "float32":
            np.testing.assert_allclose(f32(gl[key]), f32(wl[key]), **F32,
                                       err_msg=f"{what} {key}")
        else:
            assert_rel(gl[key], wl[key], BF16_REL, f"{what} {key}")


BLOCK_CASES = [(blk, dt, cached) for blk in ("rglru", "time_mix",
                                             "channel_mix")
               for dt in DTYPES for cached in (False, True)]


@pytest.mark.parametrize("blk,dtype,cached", BLOCK_CASES,
                         ids=[f"{b}-{d}-{'cache' if c else 'zeros'}"
                              for b, d, c in BLOCK_CASES])
def test_block_matches_the_reference(blk, dtype, cached):
    """``rglru_block_apply``, ``time_mix_apply`` and ``channel_mix_apply``
    of layer 0 on the redrawn weights, from zeros and from a random
    cache: outputs and new caches."""
    arch = "recurrentgemma-2b" if blk == "rglru" else "rwkv6-1.6b"
    cfg, m, jcfg, jp = model(arch, dtype)
    x, tx = block_input(cfg, dtype)
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    sub = {"rglru": "rec", "time_mix": "tmix", "channel_mix": "cmix"}[blk]
    layer = T.init_layer_cache(cfg, T.layer_kinds(cfg)[0], B, S,
                               getattr(torch, dtype), "cpu")
    empty = layer if blk == "rglru" else layer[sub]
    jcache = random_cache(empty, 7, dtype) if cached else None
    tcache = to_torch(jcache) if cached else None
    fn, jfn = {"rglru": (RG.rglru_block_apply, JRG.rglru_block_apply),
               "time_mix": (RWKV.time_mix_apply, JRWKV.time_mix_apply),
               "channel_mix": (RWKV.channel_mix_apply,
                               JRWKV.channel_mix_apply)}[blk]
    want, wc = jfn(jcfg, jblock[sub], x, cache=jcache)
    with torch.inference_mode():
        got, gc = fn(cfg, m["blocks"][0][sub], tx, cache=tcache)
    assert got.dtype == tx.dtype
    check_pair(got, want, dtype, f"{blk} output")
    check_pair(gc, wc, dtype, f"{blk} cache")
    assert {k: tuple(v.shape) for k, v in leaves(gc).items()} == {
        k: tuple(v.shape) for k, v in leaves(empty).items()}


# ------------------------------------------------------------------ models

def inputs(cfg, n=S, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def cut(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def case(arch, dtype):
    """The reference's and the port's full-forward logits (activations in
    ``dtype``), prefill logits and caches, and STEPS teacher-forced decode
    logits and caches (bf16 activations)."""
    cfg, m, jcfg, jp = model(arch, dtype)
    jin, tin = inputs(cfg)
    qpos = jnp.arange(S)
    x = JT.embed_input(jcfg, jp, jin, qpos, DTYPES[dtype])
    jfull = JT.logits_fn(jcfg, jp, JT.forward_hidden(jcfg, jp, x, qpos)[0])
    jl, jc = JT.prefill(jcfg, jp, cut(jin, 0, P), S)
    want = {"full": jfull, "prefill": jl, "caches": layer_caches(jcfg, jc)}
    with torch.inference_mode():
        full = m(tin, dtype=getattr(torch, dtype))
        pl, pc = T.prefill(cfg, m, cut(tin, 0, P), S)
        # decode writes attention caches in place: keep the prefill's
        got = {"full": full, "prefill": pl, "caches": [clone(c) for c in pc]}
        got["decode"], want["decode"] = [], []
        for step in range(P, P + STEPS):
            jl, jc = JT.decode_step(jcfg, jp, jc, jnp.int32(step),
                                    cut(jin, step, step + 1))
            pl, pc = T.decode_step(cfg, m, pc, step,
                                   cut(tin, step, step + 1))
            want["decode"].append(jl)
            got["decode"].append(pl)
        got["decode_caches"] = pc
        want["decode_caches"] = layer_caches(jcfg, jc)
    return got, want


def check_caches(cfg, got, want, what):
    """Each layer's cache leaves at BF16_REL of their magnitude: the
    float32 states, and the bf16 k, v, conv inputs and shifts."""
    assert len(got) == len(want) == cfg.num_layers
    for layer, (g, w) in enumerate(zip(got, want)):
        gl, wl = leaves(g), leaves(w)
        assert set(gl) == set(wl), (what, layer)
        for key in gl:
            assert gl[key].dtype == (torch.float32 if key.endswith("state")
                                     else torch.bfloat16), key
            assert_rel(gl[key], wl[key], BF16_REL,
                       f"{what} layer {layer} {key}")


MODEL_CASES = [(a, d) for a in ARCHS for d in DTYPES]


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_full_forward_matches_the_reference(arch, dtype):
    got, want = case(arch, dtype)
    cfg = model(arch, dtype)[0]
    assert got["full"].dtype == getattr(torch, dtype)
    assert tuple(got["full"].shape) == (B, S, cfg.vocab_size)
    assert_rel(got["full"], want["full"],
               F32_REL if dtype == "float32" else BF16_REL, "logits")


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_prefill_and_teacher_forced_decode_match_the_reference(arch, dtype):
    """Prefill logits and every layer's cache (RG-LRU conv and state, the
    local layer's ring, RWKV-6's shifts and WKV state), then STEPS decode
    steps against the reference's ``decode_step``: logits and caches."""
    got, want = case(arch, dtype)
    cfg = model(arch, dtype)[0]
    assert_rel(got["prefill"], want["prefill"], BF16_REL, "prefill logits")
    check_caches(cfg, got["caches"], want["caches"], "prefill")
    empty = T.init_cache(cfg, B, S, device="cpu")
    assert [{k: tuple(v.shape) for k, v in leaves(c).items()}
            for c in empty] == [{k: tuple(v.shape)
                                 for k, v in leaves(c).items()}
                                for c in got["caches"]]
    for step, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        assert_rel(g, w, BF16_REL, f"decode logits at {P + step}")
    check_caches(cfg, got["decode_caches"], want["decode_caches"], "decode")


@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_decode_matches_its_own_full_forward(arch, dtype):
    """The reference decode test's relation, on the port alone, over every
    position from P to S (RecurrentGemma's ring of 8 wraps twice)."""
    cfg, m, _, _ = model(arch, dtype)
    _, tin = inputs(cfg, seed=2)
    with torch.inference_mode():
        full = m(tin)
        lg, caches = T.prefill(cfg, m, cut(tin, 0, P), S)
        outs = [lg[:, 0]]
        for step in range(P, S):
            lg, caches = T.decode_step(cfg, m, caches, step,
                                       cut(tin, step, step + 1))
            outs.append(lg[:, 0])
    dec, ref = f32(torch.stack(outs, 1)), f32(full[:, P - 1:])
    assert np.abs(dec - ref).max() / (np.abs(ref).max() + 1e-6) < DECODE_REL


def test_recurrence_wrappers_reject_what_the_kernels_do_not_take():
    x, lam, h0 = torch.zeros(1, 3, 4), torch.zeros(4), torch.zeros(1, 4)
    with pytest.raises(TypeError, match="float32"):
        linear_scan(x.double(), x, x, lam, h0)
    with pytest.raises(ValueError, match="shape"):
        linear_scan(x, x[:, :2], x, lam, h0)
    with pytest.raises(ValueError, match="lam"):
        linear_scan(x, x, x, torch.zeros(5), h0)
    r, u, s0 = torch.zeros(1, 3, 2, 4), torch.zeros(2, 4), torch.zeros(
        1, 2, 4, 4)
    with pytest.raises(TypeError, match="share"):
        wkv6(r, r.bfloat16(), r, r, u, s0)
    with pytest.raises(TypeError, match="float32"):
        wkv6(r, r, r, r.double(), u, s0)
    with pytest.raises(ValueError, match="shape"):
        wkv6(r, r[:, :2], r, r, u, s0)
    with pytest.raises(ValueError, match="state0"):
        wkv6(r, r, r, r, u, s0[..., :3])
