"""The port's LM serving stack (``repro_torch.configs``, ``models``,
``serve.engine``, ``launch.serve``) against the reference's, on the CPU.

``qwen1.5-4b`` and ``glm4-9b`` at their ``.smoke()`` widths, with the
reference's ``init_params`` weights carried over by ``params_from_numpy``
in float32 and in bf16.  Activations are bf16 in both packages (the
reference's ``embed_lookup`` casts to bf16 whatever the parameters'
dtype), and the two round bf16 at different points (XLA fuses elementwise
chains; the port's prefill attention is the flash kernel's plain version,
which keeps the probabilities in float32 for the PV product where the
reference rounds them to bf16).  So:

* logits are held at ``LOGIT_RTOL`` = 2^-7 of their largest magnitude
  (two bf16 steps at it; one step is measured);
* caches (bf16 k and v) at ``CACHE_RTOL`` = 2^-7 of theirs;
* the port's incremental decode against its own full forward at the
  reference test's relation (``tests/test_models_decode.py``: relative
  max error < 0.02);
* served greedy tokens at every step where the reference's top-2 logit
  margin exceeds twice the logit tolerance, up to the first near tie
  that went the other way (every later step of that request conditions
  on a different token).  The share of steps compared is asserted to be
  at least ``MIN_COMPARED``.

Temperature sampling draws from a ``torch.Generator``, not
``jax.random``: its samples are not compared.
"""
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine, sample_logits

ARCHS = ["qwen1.5-4b", "glm4-9b"]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
LOGIT_RTOL = 2.0 ** -7
CACHE_RTOL = 2.0 ** -7
DECODE_REL = 0.02
MIN_COMPARED = 0.75        # 30-32 of 36 steps are compared
B, S, P = 2, 24, 8          # batch, full length, prompt length
ROOT = Path(__file__).resolve().parents[1]
# optional blocks that neither ported config uses, each on the GLM-4-9B
# smoke config: held against the reference like the configs themselves
VARIANTS = {"rmsnorm_bf16": dict(norm_bf16_mul=True),
            "layernorm": dict(norm="layernorm"),
            "layernorm_bf16": dict(norm="layernorm", norm_bf16_mul=True),
            "qk_norm": dict(qk_norm=True), "embed_scale": dict(embed_scale=True),
            "geglu": dict(mlp="geglu"), "relu2": dict(mlp="relu2"),
            "gelu": dict(mlp="gelu"), "tied": dict(tie_embeddings=True)}
# chip_smoke.py's bf16 decode gate, on a GLM-4-9B cut to 8 layers of
# d_model 1024 (8 heads of 128, KV 2, d_ff 3424, vocab 8192): there both
# deliberate faults move the logits well past the bf16 noise (at the
# smoke widths attention barely moves them)
WITNESS = dict(d_model=1024, num_heads=8, d_ff=3424, num_layers=8,
               vocab_size=8192)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_rel(got, want, rtol, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES])
def model(request):
    arch, dtype = request.param
    jcfg = jconfigs.get_arch(arch).smoke()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda x: x.astype(DTYPES[dtype]), jp)
    cfg = configs.get_arch(arch).smoke()
    m = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return cfg, m, jcfg, jp, toks.astype(np.int32)


def test_configs_match_the_reference():
    for arch in ARCHS:
        want = jconfigs.get_arch(arch)
        got = configs.get_arch(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(got.smoke()) == \
            dataclasses.asdict(want.smoke())
        assert got.param_count() == want.param_count()
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert set(configs.NOT_PORTED) | set(ARCHS) == set(configs.ASSIGNED)
    for name in configs.NOT_PORTED:
        with pytest.raises(KeyError, match="ROADMAP queue A item 5"):
            configs.get_arch(name)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
                                  "gemma3-27b", "recurrentgemma-2b",
                                  "rwkv6-1.6b", "chameleon-34b",
                                  "musicgen-large"])
def test_unsupported_families_are_refused(arch):
    cfg = ArchConfig(**dataclasses.asdict(jconfigs.get_arch(arch).smoke()))
    with pytest.raises(ValueError, match="ROADMAP queue A item 5"):
        T.model_pspecs(cfg)
    with pytest.raises(ValueError, match="lacks"):
        T.init_params(cfg, device="cpu")


def test_full_forward_matches_the_reference(model):
    cfg, m, jcfg, jp, toks = model
    qpos = jnp.arange(S)
    x = JT.embed_input(jcfg, jp, {"tokens": jnp.asarray(toks)}, qpos)
    hidden, _, _ = JT.forward_hidden(jcfg, jp, x, qpos)
    want = JT.logits_fn(jcfg, jp, hidden)
    with torch.inference_mode():
        got = m(torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    assert_rel(got, want, LOGIT_RTOL, "logits")


def test_prefill_and_teacher_forced_decode_match_the_reference(model):
    cfg, m, jcfg, jp, toks = model
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :P])}, S)
    with torch.inference_mode():
        pl, pc = T.prefill(cfg, m, {"tokens": torch.from_numpy(
            toks[:, :P]).long()}, S)
    assert_rel(pl, jl, LOGIT_RTOL, "prefill logits")
    for key in ("k", "v"):
        want = jc["groups"][0][key]                         # (L, B, S, KH, D)
        got = torch.stack([c[key] for c in pc])
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert_rel(got, want, CACHE_RTOL, f"cache {key}")
        assert not f32(got)[:, :, P:].any()
    empty = T.init_cache(cfg, B, S, device="cpu")
    assert [(c["k"].shape, c["v"].dtype) for c in empty] == \
        [(c["k"].shape, c["v"].dtype) for c in pc]
    for t in range(P, P + 8):
        step = toks[:, t:t + 1]
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.int32(t),
                                {"tokens": jnp.asarray(step)})
        with torch.inference_mode():
            pl, pc = T.decode_step(cfg, m, pc, t, {"tokens": torch.from_numpy(
                step).long()})
        assert_rel(pl, jl, LOGIT_RTOL, f"decode logits at {t}")


def test_decode_matches_its_own_full_forward(model):
    cfg, m, _, _, toks = model
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full = m(tt)
        lg, caches = T.prefill(cfg, m, {"tokens": tt[:, :P]}, S)
        outs = [lg[:, 0]]
        for t in range(P, S):
            lg, caches = T.decode_step(cfg, m, caches, t,
                                       {"tokens": tt[:, t:t + 1]})
            outs.append(lg[:, 0])
    dec, ref = f32(torch.stack(outs, 1)), f32(full[:, P - 1:])
    assert np.abs(dec - ref).max() / (np.abs(ref).max() + 1e-6) < DECODE_REL


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_optional_blocks_match_the_reference(variant):
    """Norms in bf16 and LayerNorm, qk-norm, the embedding scale, the
    GeGLU, squared-ReLU and GELU MLPs and a tied head: the full forward,
    the prefill's logits and caches and a decode step against the
    reference's, on its weights, at the tolerances above."""
    change = VARIANTS[variant]
    jcfg = dataclasses.replace(jconfigs.get_arch("glm4-9b").smoke(), **change)
    cfg = dataclasses.replace(configs.get_arch("glm4-9b").smoke(), **change)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                      JT.init_params(jcfg, jax.random.PRNGKey(2)))
    # the zero-initialised scales and biases at random values, so that
    # each block's own arithmetic shows
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.asarray(0.5 * rng.standard_normal(x.shape),
                                        x.dtype)
        if any(getattr(k, "key", None) in ("scale", "bias", "q_norm",
                                           "k_norm") for k in path) else x,
        jp)
    m = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    tt = torch.from_numpy(toks).long()
    qpos = jnp.arange(S)
    x = JT.embed_input(jcfg, jp, {"tokens": jnp.asarray(toks)}, qpos)
    want = JT.logits_fn(jcfg, jp, JT.forward_hidden(jcfg, jp, x, qpos)[0])
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :P])}, S)
    with torch.inference_mode():
        assert_rel(m(tt), want, LOGIT_RTOL, f"{variant} logits")
        pl, pc = T.prefill(cfg, m, {"tokens": tt[:, :P]}, S)
        assert_rel(pl, jl, LOGIT_RTOL, f"{variant} prefill logits")
        for key in ("k", "v"):
            assert_rel(torch.stack([c[key] for c in pc]),
                       jc["groups"][0][key], CACHE_RTOL, f"{variant} {key}")
        for t in (P,):
            jl, jc = JT.decode_step(jcfg, jp, jc, jnp.int32(t),
                                    {"tokens": jnp.asarray(toks[:, t:t + 1])})
            pl, pc = T.decode_step(cfg, m, pc, t, {"tokens": tt[:, t:t + 1]})
            assert_rel(pl, jl, LOGIT_RTOL, f"{variant} decode at {t}")


def bf16_decode_witness(change: dict) -> dict:
    """chip_smoke.py's ``lm_decode_vs_full`` on GLM-4-9B cut by
    ``change``, with the reference's weights in bf16 (it raises unless the
    port's float32 decode is within 1e-4 of its full forward, its bf16
    decode passes the gate, and each deliberate fault fails it), beside
    the reference's own decode on the same weights and tokens: its bf16
    full forward's and its decode's relative max distances from its
    float32 full forward, and its decode against its bf16 full forward
    (the relation of tests/test_models_decode.py)."""
    sys.path.insert(0, str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    jcfg = dataclasses.replace(jconfigs.get_arch("glm4-9b"), **change)
    cfg = dataclasses.replace(configs.get_arch("glm4-9b"), **change)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                      JT.init_params(jcfg, jax.random.PRNGKey(0)))
    m = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    port = smoke.lm_decode_vs_full(cfg, m, "cpu")
    b, p, n = smoke.LM_DECODE_CHECK
    toks = jnp.asarray(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, p + n)), jnp.int32)
    qpos = jnp.arange(p + n)
    full = {}
    for dt in (jnp.bfloat16, jnp.float32):
        x = JT.embed_input(jcfg, jp, {"tokens": toks}, qpos, dt)
        full[dt] = JT.logits_fn(jcfg, jp, JT.forward_hidden(
            jcfg, jp, x, qpos)[0])[:, p - 1:]
    lg, caches = JT.prefill(jcfg, jp, {"tokens": toks[:, :p]}, p + n)
    outs = [lg[:, 0]]
    for t in range(p, p + n):
        lg, caches = JT.decode_step(jcfg, jp, caches, jnp.int32(t),
                                    {"tokens": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    dec = jnp.stack(outs, 1)
    rel = lambda a, w: smoke.rel_max(torch.tensor(f32(a)),
                                     torch.tensor(f32(w)))
    noise = rel(full[jnp.bfloat16], full[jnp.float32])
    ref = dict(full_forward_vs_float32=noise,
               vs_float32=rel(dec, full[jnp.float32]),
               relation=rel(dec, full[jnp.bfloat16]))
    ref["ratio"] = ref["vs_float32"] / noise
    return {"port": port["bfloat16"], "reference": ref}


def test_bf16_decode_gate_against_the_reference():
    """The gate passes the port's decode and fails both faults
    (``lm_decode_vs_full`` raises otherwise), and the reference's own
    decode stands within the gate's factor of its float32 forward too."""
    got = bf16_decode_witness(WITNESS)
    print(json.dumps(got))
    assert got["reference"]["ratio"] < got["port"]["factor"]


def _requests(make, cfg, n=6, prompt_len=12, max_new=6):
    rng = np.random.default_rng(3)
    return [make(rid=i, prompt=rng.integers(0, cfg.vocab_size, prompt_len,
                                            dtype=np.int32),
                 max_new_tokens=max_new) for i in range(n)]


def test_serve_engine_matches_the_reference(model):
    cfg, m, jcfg, jp, _ = model
    jeng = JServeEngine(jcfg, jp, max_seq=32)
    # the reference's top-2 margin at each step, in units of the logit
    # tolerance at that step's logits' scale
    margins = []
    sample = jeng._sample

    def recording_sample(logits):
        lg = f32(logits[:, -1])
        top2 = np.sort(lg, axis=-1)[:, -2:]
        tol = LOGIT_RTOL * np.abs(lg).max(-1)
        margins.append((top2[:, 1] - top2[:, 0]) / tol)
        return sample(logits)
    jeng._sample = recording_sample
    jreqs = _requests(JRequest, jcfg)
    for r in jreqs:
        jeng.submit(r)
    jstats = jeng.run()

    eng = ServeEngine(cfg, m, max_seq=32)
    reqs = _requests(Request, cfg)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    for key in ("tokens", "rounds", "batch_hist"):
        assert stats[key] == jstats[key], key
    for key in ("submitted", "taken", "waiting"):
        assert stats["queue"][key] == jstats["queue"][key], key
    assert stats["batch_hist"] == [6] and stats["tokens"] == 6 * 5
    assert len(eng.timings["prefill_s"]) == 1
    assert len(eng.timings["decode_s"]) == 5

    margins = np.stack(margins, 1)                      # (requests, steps)
    compared = 0
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        assert len(r.out_tokens) == len(jr.out_tokens) == 6
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
        for step, (t, jt) in enumerate(zip(r.out_tokens, jr.out_tokens)):
            if margins[i, step] > 2.0:
                assert t == jt, (i, step)
                compared += 1
            elif t != jt:
                break          # a near tie went the other way: inputs differ
    print(f"greedy tokens compared at {compared} of {margins.size} steps")
    assert compared >= MIN_COMPARED * margins.size, (compared, margins.size)


def test_sample_logits_greedy_and_top_k():
    g = torch.Generator().manual_seed(0)
    lg = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 0.0, 0.0, 4.0]])
    assert sample_logits(lg, g).tolist() == [1, 0]
    for _ in range(20):
        t = sample_logits(lg, g, temperature=1.0, top_k=2).tolist()
        assert t[0] in (1, 3) and t[1] in (0, 3)


def test_launch_serve_schedule_matches_the_reference_launcher(capsys):
    stats = serve_main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                        "--requests", "5", "--max-new", "3"])
    # QueueDVFS(thresholds=(2, 6), levels (1, 4, 8)): 5 waiting -> 4, then 1
    assert stats["rounds"] == 2 and stats["batch_hist"] == [4, 1]
    assert stats["tokens"] == 5 * 2
    assert "rounds=2" in capsys.readouterr().out


if __name__ == "__main__":
    # the witness at other cuts of GLM-4-9B: d_model, layers, vocab
    d, layers, vocab = map(int, sys.argv[1:4])
    print(json.dumps(bf16_decode_witness(dict(
        d_model=d, num_heads=d // 128, d_ff=13696 * d // 4096,
        num_layers=layers, vocab_size=vocab))))
