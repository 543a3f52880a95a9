"""The zoo's new blocks against the reference, on the CPU: Gemma-3's
ring caches (the reference's wrap test, a prompt longer than the window,
the remainder layers), the rope base of local and global layers,
MusicGen's frames, sinusoidal positions and codebook heads, the windowed
flash kernel's plain version, ``models.registry`` and the launcher on
an MoE config.  Tolerances as in ``tests/test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.serve import main as jserve_main
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.kernels import flash_attention_kernel
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import transformer as T

import lm_weights

from test_torch_lm_zoo import (CACHE_RTOL, DECODE_REL, LOGIT_RTOL,
                               assert_rel, f32, layer_caches)


# the reference's init_params seeds each leaf with hash(path), randomised
# per process: crc32 of the path instead, for the whole module
# (tests/lm_weights.py)
@pytest.fixture(scope="module", autouse=True)
def _stable_weights():
    yield from lm_weights.stable_weights()


def gemma(num_layers=None):
    """Gemma-3 smoke (window 8, rope base 1e4 local / 1e6 global) in
    bf16, optionally at another depth: (cfg, model, jcfg, jparams)."""
    change = {} if num_layers is None else {"num_layers": num_layers}
    jcfg = dataclasses.replace(jconfigs.get_arch("gemma3-27b").smoke(),
                               **change)
    cfg = dataclasses.replace(configs.get_arch("gemma3-27b").smoke(),
                              **change)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                      JT.init_params(jcfg, jax.random.PRNGKey(0)))
    m = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, m, jcfg, jp


def test_ring_buffer_wraps_correctly():
    """The reference's test_ring_buffer_wraps_correctly case: window 8,
    one sequence of 32 (4x past the window), prompt 4, decode to the end;
    the port's decode against the reference's full-forward logits, at
    that test's relation."""
    cfg, m, jcfg, jp = gemma()
    assert cfg.window_size == 8
    S = 32
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, S))
    qpos = jnp.arange(S)
    x = JT.embed_input(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                       qpos)
    ref = JT.logits_fn(jcfg, jp, JT.forward_hidden(jcfg, jp, x, qpos)[0])
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        lg, caches = T.prefill(cfg, m, {"tokens": tt[:, :4]}, S)
        assert [c["k"].shape[1] for c in caches] == [8] * 5 + [S]
        outs = [lg[:, 0]]
        for t in range(4, S):
            lg, caches = T.decode_step(cfg, m, caches, t,
                                       {"tokens": tt[:, t:t + 1]})
            outs.append(lg[:, 0])
    dec, want = f32(torch.stack(outs, 1)), f32(ref[:, 3:])
    assert np.abs(dec - want).max() / (np.abs(want).max() + 1e-6) < DECODE_REL


def test_prefill_longer_than_the_window_builds_the_reference_rings():
    """8 layers (one 5 local + 1 global group, then 2 remainder local
    layers, the full model's tail shape): a prompt of 20 past the window
    of 8 leaves each local ring holding positions 12..19 at slots
    pos mod 8, equal to the reference's caches; then a decode step."""
    cfg, m, jcfg, jp = gemma(num_layers=8)
    assert T.layer_kinds(cfg) == ["local"] * 5 + ["attn"] + ["local"] * 2
    B, S, P = 2, 24, 20
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks).long()
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jt[:, :P]}, S)
    with torch.inference_mode():
        pl, pc = T.prefill(cfg, m, {"tokens": tt[:, :P]}, S)
        assert_rel(pl, jl, LOGIT_RTOL, "prefill logits")
        for layer, (g, w) in enumerate(zip(pc, layer_caches(jcfg, jc))):
            for key in ("k", "v"):
                assert_rel(g[key], w[key], CACHE_RTOL, f"{layer} {key}")
        # the ring's layout from the full forward's own k: slot s holds
        # position p with p mod 8 == s, p in 12..19
        qpos = torch.arange(P)
        x = T.embed_input(cfg, m, {"tokens": tt[:, :P]}, qpos)
        h = L.apply_norm(cfg, m["blocks"][0]["norm1"], x)
        _, k, v = L.attn_qkv(cfg, m["blocks"][0]["attn"], h, qpos, "local")
        pos = torch.arange(P - 8, P)
        assert torch.equal(pc[0]["k"][:, pos % 8], k[:, pos])
        assert torch.equal(pc[0]["v"][:, pos % 8], v[:, pos])
        for t in (P,):
            jl, jc = JT.decode_step(jcfg, jp, jc, jnp.int32(t),
                                    {"tokens": jt[:, t:t + 1]})
            pl, pc = T.decode_step(cfg, m, pc, t, {"tokens": tt[:, t:t + 1]})
            assert_rel(pl, jl, LOGIT_RTOL, f"decode at {t}")


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_attention_takes_its_layer_kinds_rope_base(kind):
    """Local layers rotate at rope_base (1e4), global ones at
    rope_base_global (1e6), as the reference's attn_apply does; the
    reference's output at the other base is far from both."""
    jcfg = jconfigs.get_arch("gemma3-27b").smoke()
    cfg = configs.get_arch("gemma3-27b").smoke()
    assert cfg.rope_base_global == 1e6 and cfg.rope_base == 1e4
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(1))
    layer = 0 if kind == "local" else 5
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][layer]["attn"])
    p = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")["blocks"][layer]["attn"]
    S = 16
    x = np.random.default_rng(4).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    qpos = jnp.arange(S)
    want = JL.attn_apply(jcfg, jp, jnp.asarray(x), qpos, kind=kind)[0]
    other = "attn" if kind == "local" else "local"
    moved = dataclasses.replace(jcfg, rope_base=jcfg.rope_base_global,
                                rope_base_global=jcfg.rope_base)
    # the other base with this kind's window: the output at the wrong base
    wrong = JL.attn_apply(moved, jp, jnp.asarray(x), qpos, kind=kind)[0]
    with torch.inference_mode():
        got = L.attn_apply(cfg, p, torch.from_numpy(x), torch.arange(S),
                           kind=kind)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert np.abs(np.asarray(wrong) - np.asarray(want)).max() > 1e-3, other


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_musicgen_frames_and_codebook_heads(dtype):
    """Frames (B, S, d) in, sinusoidal positions added at qpos (also at a
    decode position), 4 codebook heads out: embed_input, logits_fn,
    prefill (B, 1, 4, V) and a decode step against the reference's."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg = jconfigs.get_arch("musicgen-large").smoke()
    cfg = configs.get_arch("musicgen-large").smoke()
    assert cfg.num_codebooks == 4 and cfg.pos_emb == "sinusoidal"
    jp = jax.tree.map(lambda a: a.astype(jdt),
                      JT.init_params(jcfg, jax.random.PRNGKey(3)))
    m = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert tuple(m["embed"]["head"].shape) == (4, cfg.d_model,
                                               cfg.vocab_size)
    B, S, P = 2, 12, 6
    fr = jnp.asarray(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)), jnp.bfloat16)
    tf = torch.from_numpy(np.array(fr.astype(jnp.float32))).to(
        torch.bfloat16)
    for pos in (jnp.arange(S), jnp.arange(40, 40 + S)):
        want = JT.embed_input(jcfg, jp, {"frames": fr}, pos)
        got = T.embed_input(cfg, m, {"frames": tf},
                            torch.from_numpy(np.array(pos)))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.float(), torch.tensor(f32(want)))
    hidden = np.random.default_rng(6).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want = JT.logits_fn(jcfg, jp, jnp.asarray(hidden, jnp.bfloat16))
    got = T.logits_fn(cfg, m, torch.from_numpy(hidden).to(torch.bfloat16))
    assert tuple(got.shape) == (B, S, 4, cfg.vocab_size)
    assert_rel(got, want, LOGIT_RTOL, "codebook logits")
    jl, jc = JT.prefill(jcfg, jp, {"frames": fr[:, :P]}, S)
    jl2, _ = JT.decode_step(jcfg, jp, jc, jnp.int32(P),
                            {"frames": fr[:, P:P + 1]})
    with torch.inference_mode():
        pl, pc = T.prefill(cfg, m, {"frames": tf[:, :P]}, S)
        pl2, _ = T.decode_step(cfg, m, pc, P, {"frames": tf[:, P:P + 1]})
    assert tuple(pl.shape) == tuple(pl2.shape) == (B, 1, 4, cfg.vocab_size)
    assert_rel(pl, jl, LOGIT_RTOL, "prefill logits")
    assert_rel(pl2, jl2, LOGIT_RTOL, "decode logits")


@pytest.mark.parametrize("window", [1, 5, 8, 13, 40])
def test_windowed_flash_plain_version_matches_the_reference(window):
    """flash_attention_kernel's plain version (the CPU path) with a
    window against the reference's attention_dense(window=) on the same
    q, k, v (KV expanded), float32 at the reference's attention test
    tolerance; window 0 is the causal kernel."""
    B, S, H, D = 2, 40, 4, 32
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    pos = jnp.arange(S)
    want = JL.attention_dense(jnp.asarray(q)[:, :, :, None], jnp.asarray(k),
                              jnp.asarray(v), pos, pos,
                              window=window)[:, :, :, 0]
    got = flash_attention_kernel(*(torch.from_numpy(t) for t in (q, k, v)),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    causal = flash_attention_kernel(*(torch.from_numpy(t) for t in (q, k, v)))
    band = flash_attention_kernel(*(torch.from_numpy(t) for t in (q, k, v)),
                                  window=S)
    assert torch.equal(causal, band)          # a window of S is no window
    with pytest.raises(ValueError, match="window"):
        flash_attention_kernel(*(torch.from_numpy(t) for t in (q, k, v)),
                               window=-1)


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_make_dummy_batch_is_the_reference_bitwise(arch):
    """Every assigned arch (a recurrent one through its config alone),
    every kind: the same arrays as the reference's, bit for bit; and
    batch_specs' shapes and dtypes."""
    jcfg = jconfigs.get_arch(arch).smoke()
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    for kind in ("train", "prefill", "decode"):
        want = JR.make_dummy_batch(jcfg, kind, 2, 16)
        got = R.make_dummy_batch(cfg, kind, 2, 16)
        assert set(got) == set(want), kind
        for key, w in want.items():
            g = got[key]
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), key
            if g.dtype == torch.bfloat16:
                g, w = g.view(torch.int16), np.asarray(w).view(np.int16)
            assert np.array_equal(g.numpy(), np.asarray(w)), (kind, key)
    for shape in SHAPES.values():
        want = JR.batch_specs(jcfg, shape)
        got = R.batch_specs(cfg, shape)
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k, t in got.items()} == \
            {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}
        assert all(t.device.type == "meta" for t in got.values())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-27b",
                                  "musicgen-large"])
def test_input_specs_match_the_reference(arch):
    """input_specs at every shape of a smoke config: the batch, the
    parameter count and dtype, and each layer's cache (a local layer's
    at its ring length), as the reference's stacked specs unstack."""
    jcfg = jconfigs.get_arch(arch).smoke()
    cfg = configs.get_arch(arch).smoke()
    for shape in SHAPES.values():
        shape = dataclasses.replace(shape, seq_len=64, global_batch=2)
        want = JR.input_specs(jcfg, shape)
        got = R.input_specs(cfg, shape)
        assert set(got) == set(want)
        assert sum(t.numel() for t in jax.tree.leaves(got["params"])) == \
            sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
                want["params"]))
        dt = "float32" if shape.kind == "train" else "bfloat16"
        assert {str(t.dtype) for t in jax.tree.leaves(
            got["params"], is_leaf=torch.is_tensor)} == {f"torch.{dt}"}
        if shape.kind == "decode":
            plen, groups = jcfg.pattern_len, jcfg.num_groups
            jcache = []
            for layer in range(jcfg.num_layers):
                g, i = divmod(layer, plen)
                if g < groups:          # stacked: drop the layer axis
                    jcache.append({k: tuple(s.shape[1:]) for k, s in
                                   want["caches"]["groups"][i].items()})
                else:
                    jcache.append({k: tuple(s.shape) for k, s in want[
                        "caches"]["rem"][layer - groups * plen].items()})
            assert [{k: tuple(c[k].shape) for k in c}
                    for c in got["caches"]] == jcache


def test_launch_serve_olmoe_schedule_matches_the_reference_launcher(capsys):
    """``launch.serve --arch olmoe-1b-7b --smoke`` (the launcher's
    defaults: 12 requests, prompts of 16, 16 new tokens) schedules as
    the reference launcher does; MusicGen is refused (frames)."""
    stats = serve_main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                        "cpu"])
    jstats = jserve_main(["--arch", "olmoe-1b-7b", "--smoke"])
    for key in ("rounds", "batch_hist", "tokens"):
        assert stats[key] == jstats[key], key
    assert stats["batch_hist"] == [8, 4] and stats["tokens"] == 180
    assert "rounds=2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_main(["--arch", "musicgen-large", "--smoke", "--device",
                    "cpu"])
