"""The rest of the attention LM zoo against the reference, on the CPU:
Phi-3.5-MoE and OLMoE (mixtures of experts), Gemma-3 (5 local : 1
global, ring caches, the global rope base), Nemotron-4 (squared ReLU,
LayerNorm, half rope), Chameleon (VQ image tokens in the text vocabulary,
qk-norm) and MusicGen (encodec frames, sinusoidal positions, 4 codebook
heads), each at its ``.smoke()`` widths with the reference's
``init_params`` weights carried over by ``params_from_numpy`` in float32
and in bf16, at ``tests/test_torch_lm.py``'s tolerances (logits and
caches at 2^-7 of their largest magnitude; decode against the port's own
full forward at the reference decode test's relative 0.02).

The MoE pair runs both of the reference's MoE paths: the served capacity
dispatch (``moe_dense=False``) and the dense oracle (``moe_dense=True``,
as the reference's decode test runs MoE).  Decode against the full
forward uses the oracle for them: with capacity, a decode step (T = B)
and the full forward (T = B S) drop differently, in both packages.

Gemma-3's smoke window is 8 and its prompts here are 8 long, so its
prefill builds full rings and its decode steps wrap them at once; the
longer prompts, the remainder layers and the reference's ring test are in
``tests/test_torch_lm_zoo_blocks.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.models import transformer as T

import lm_weights


# the reference's init_params seeds each leaf with hash(path), randomised
# per process: crc32 of the path instead, for the whole module
# (tests/lm_weights.py)
@pytest.fixture(scope="module", autouse=True)
def _stable_weights():
    yield from lm_weights.stable_weights()

ARCHS = ["phi3.5-moe-42b-a6.6b", "olmoe-1b-7b", "gemma3-27b",
         "nemotron-4-15b", "chameleon-34b", "musicgen-large"]
MOE_ARCHS = ARCHS[:2]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
LOGIT_RTOL = 2.0 ** -7
CACHE_RTOL = 2.0 ** -7
DECODE_REL = 0.02
B, S, P = 2, 24, 8          # batch, full length, prompt length
STEPS = 2                   # teacher-forced decode steps against the reference
CASES = [(a, d, dense) for a in ARCHS for d in DTYPES
         for dense in ((False, True) if a in MOE_ARCHS else (False,))]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_rel(got, want, rtol, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


def layer_caches(jcfg, jc) -> list:
    """The reference's caches ({"groups": one stack a pattern position,
    "rem"}) as one {"k", "v"} a layer, in layer order."""
    plen, groups = jcfg.pattern_len, jcfg.num_groups
    out = []
    for layer in range(jcfg.num_layers):
        g, i = divmod(layer, plen)
        out.append({k: a[g] for k, a in jc["groups"][i].items()}
                   if g < groups else jc["rem"][layer - groups * plen])
    return out


def inputs(cfg, n=S, seed=1):
    """(reference batch, port batch) of n positions: tokens, or encodec
    frames drawn in float64 and rounded to bf16 once for both."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "encodec":
        fr = jnp.asarray(rng.standard_normal((B, n, cfg.d_model)),
                         jnp.bfloat16)
        return ({"frames": fr}, {"frames": torch.from_numpy(
            np.array(fr.astype(jnp.float32))).to(torch.bfloat16)})
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}


def cut(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def model(arch, dtype):
    jcfg = jconfigs.get_arch(arch).smoke()
    jp = jax.tree.map(lambda x: x.astype(DTYPES[dtype]),
                      JT.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = configs.get_arch(arch).smoke()
    m = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, m, jcfg, jp


@functools.lru_cache(maxsize=None)
def case(arch, dtype, moe_dense):
    """The reference's and the port's full-forward logits, prefill logits
    and caches, and STEPS teacher-forced decode logits."""
    cfg, m, jcfg, jp = model(arch, dtype)
    jin, tin = inputs(cfg)
    qpos = jnp.arange(S)
    x = JT.embed_input(jcfg, jp, jin, qpos)
    jfull = JT.logits_fn(jcfg, jp, JT.forward_hidden(
        jcfg, jp, x, qpos, moe_dense=moe_dense)[0])
    jl, jc = JT.prefill(jcfg, jp, cut(jin, 0, P), S, moe_dense=moe_dense)
    want = {"full": jfull, "prefill": jl, "caches": layer_caches(jcfg, jc)}
    with torch.inference_mode():
        full = m(tin, moe_dense=moe_dense)
        pl, pc = T.prefill(cfg, m, cut(tin, 0, P), S, moe_dense=moe_dense)
        got = {"full": full, "prefill": pl,
               "caches": [{k: c[k].clone() for k in c} for c in pc]}
        got["decode"], want["decode"] = [], []
        for t in range(P, P + STEPS):
            jl, jc = JT.decode_step(jcfg, jp, jc, jnp.int32(t),
                                    cut(jin, t, t + 1), moe_dense=moe_dense)
            pl, pc = T.decode_step(cfg, m, pc, t, cut(tin, t, t + 1),
                                   moe_dense=moe_dense)
            want["decode"].append(jl)
            got["decode"].append(pl)
    return got, want


def case_id(c):
    return f"{c[0]}-{c[1]}" + ("-moe_dense" if c[2] else "")


@pytest.mark.parametrize("c", CASES, ids=case_id)
def test_full_forward_matches_the_reference(c):
    got, want = case(*c)
    cfg = model(*c[:2])[0]
    assert got["full"].dtype == torch.bfloat16
    shape = (B, S) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                      else ()) + (cfg.vocab_size,)
    assert tuple(got["full"].shape) == shape
    assert_rel(got["full"], want["full"], LOGIT_RTOL, "logits")


@pytest.mark.parametrize("c", CASES, ids=case_id)
def test_prefill_and_teacher_forced_decode_match_the_reference(c):
    got, want = case(*c)
    cfg = model(*c[:2])[0]
    assert_rel(got["prefill"], want["prefill"], LOGIT_RTOL, "prefill logits")
    assert len(got["caches"]) == len(want["caches"]) == cfg.num_layers
    kinds = T.layer_kinds(cfg)
    for layer, (g, w) in enumerate(zip(got["caches"], want["caches"])):
        for key in ("k", "v"):
            assert g[key].dtype == torch.bfloat16
            assert_rel(g[key], w[key], CACHE_RTOL, f"layer {layer} {key}")
        if kinds[layer] == "local":          # a full ring of window slots
            assert g["k"].shape[1] == cfg.window_size
    empty = T.init_cache(cfg, B, S, device="cpu")
    assert [c["k"].shape for c in empty] == [c["k"].shape
                                             for c in got["caches"]]
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        assert_rel(g, w, LOGIT_RTOL, f"decode logits at {P + t}")


@pytest.mark.parametrize("arch,dtype", [(a, d) for a in ARCHS
                                        for d in DTYPES])
def test_decode_matches_its_own_full_forward(arch, dtype):
    """The reference decode test's relation, on the port alone, over
    every position from P to S (MoE through the dense oracle, as that
    test runs it)."""
    cfg, m, _, _ = model(arch, dtype)
    _, tin = inputs(cfg, seed=2)
    dense = cfg.moe
    with torch.inference_mode():
        full = m(tin, moe_dense=dense)
        lg, caches = T.prefill(cfg, m, cut(tin, 0, P), S, moe_dense=dense)
        outs = [lg[:, 0]]
        for t in range(P, S):
            lg, caches = T.decode_step(cfg, m, caches, t, cut(tin, t, t + 1),
                                       moe_dense=dense)
            outs.append(lg[:, 0])
    dec, ref = f32(torch.stack(outs, 1)), f32(full[:, P - 1:])
    assert np.abs(dec - ref).max() / (np.abs(ref).max() + 1e-6) < DECODE_REL
