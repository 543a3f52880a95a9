"""The port's training stack (``repro_torch.optim``, ``data.pipeline``,
``train.step``, ``ft.loop``, ``launch.train``) against the reference's,
on the CPU, at smoke widths and a few steps.

* ``cosine_schedule`` at two float32 ulps (rtol 2^-22: XLA's cos and
  torch's differ by one at some arguments) and two ``adamw_update`` steps
  (with and without clipping) at rtol 1e-6 of each leaf's largest
  magnitude against the reference's on the same numpy values;
  ``quantize_tensor`` and ``ef_compress`` bit for bit.
* The pipeline: the reference draws with ``jax.random``, the port with a
  ``torch.Generator``, so ``batch_from_draws`` is given the reference's
  own draws (made here with ``jax.random`` as its ``batch`` makes them)
  and must give its batch bit for bit; the port's own batches keep the
  properties of ``tests/test_data_compress.py:20,28,49``.
* The train step: microbatch 4 against 1 at the reference test's 5e-3
  (loss) and 5e-4 (parameters), the loss falling in the reference
  integration test's setting (120 steps, last ten below the first ten
  by 0.15), the fault-tolerant loop's contract of
  ``tests/test_ckpt_ft.py:62,84,121`` (deterministic resume, retry,
  straggler), and the launcher on the CPU.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim.compress import dequantize_tensor as jdequantize
from repro.optim.compress import ef_compress as jef_compress
from repro.optim.compress import quantize_tensor as jquantize

from repro_torch import configs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import (PipelineConfig, SyntheticTokenPipeline,
                                       batch_from_draws)
from repro_torch.ft.loop import FaultTolerantLoop, LoopConfig
from repro_torch.launch import train as train_launcher
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import cosine_schedule
from repro_torch.optim.compress import (dequantize_tensor, ef_compress,
                                        quantize_tensor)
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: the suite runs several worker
    processes at once, and smoke-width steps on many threads each
    oversubscribe the cores (a step then takes tens of times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ optimiser

@pytest.mark.parametrize("warmup,total", [(10, 120), (100, 10_000), (0, 7)])
def test_cosine_schedule_matches_reference(warmup, total):
    for step in list(range(0, total + 20, max(total // 50, 1))) + [warmup]:
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                              peak_lr=3e-3, warmup_steps=warmup,
                              total_steps=total)
        want = jcosine(jnp.int32(step), peak_lr=3e-3, warmup_steps=warmup,
                       total_steps=total)
        assert got.dtype == torch.float32 and got.shape == ()
        # XLA's float32 cos and torch's differ by an ulp at some
        # arguments (about 5 % of t in [0, 1]): two ulps of float32
        np.testing.assert_allclose(float(got), float(want), rtol=2.0 ** -22)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # unclipped, clipped
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "e": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = AdamWConfig(lr=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jadamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = adamw_init(tp)
    for step in range(2):
        grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        lr = float(cosine_schedule(step, peak_lr=1e-2, warmup_steps=1,
                                   total_steps=5))
        jp, jst, jm = jadamw_update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, jst, jp,
                                    JAdamWConfig(lr=1e-2), lr=lr)
        tp, tst, tm = adamw_update({k: torch.from_numpy(v) for k, v in
                                    grads.items()}, tst, tp, cfg, lr=lr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (tst["mu"][k], jst["mu"][k]),
                              (tst["nu"][k], jst["nu"][k])):
                # rtol 1e-6 of the leaf's largest magnitude (where p and
                # lr x step nearly cancel, an ulp of either is more)
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()))
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        assert tst["count"].dtype == torch.int32


def test_quantize_and_error_feedback_bitwise():
    rng = np.random.default_rng(1)
    grads = {"a": (rng.standard_normal((64,)) * 3).astype(np.float32),
             "b": (rng.standard_normal((4, 9)) * 1e-3).astype(np.float32)}
    ef_j, ef_t = None, None
    for _ in range(3):
        qj, sj, ef_j = jef_compress({k: jnp.asarray(v) for k, v in
                                     grads.items()}, ef_j)
        qt, st, ef_t = ef_compress({k: torch.from_numpy(v) for k, v in
                                    grads.items()}, ef_t)
        for k in grads:
            np.testing.assert_array_equal(qt[k].numpy(), np.asarray(qj[k]))
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
            np.testing.assert_array_equal(ef_t[k].numpy(),
                                          np.asarray(ef_j[k]))
    g = (rng.standard_normal((100,)) * 7).astype(np.float32)
    q, s = quantize_tensor(torch.from_numpy(g))
    jq, js = jquantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(dequantize_tensor(q, s).numpy(),
                                  np.asarray(jdequantize(jq, js)))


# ------------------------------------------------------------- pipeline

def _reference_draws(cfg, step):
    """The reference's ``batch``'s own random numbers, drawn as it draws
    them (``data/pipeline.py:35-56``)."""
    B, S, V = cfg.global_batch, cfg.seq_len + 1, cfg.vocab_size
    k = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step)
    if cfg.kind == "frames":
        kf, kl = jax.random.split(k)
        return {"frames": np.asarray(jax.random.normal(
                    kf, (B, cfg.seq_len, cfg.d_model), jnp.bfloat16)
                    .astype(jnp.float32)),
                "labels": np.asarray(jax.random.randint(
                    kl, (B, cfg.seq_len, cfg.num_codebooks), 0, V,
                    jnp.int32))}
    ka, _, k0, kn, km = jax.random.split(k, 5)
    kpool = jax.random.PRNGKey(cfg.seed + 7919)
    return {"pool_a": np.asarray(1 + 2 * jax.random.randint(
                jax.random.fold_in(kpool, 0), (cfg.n_styles,), 0,
                (V - 1) // 2)),
            "pool_c": np.asarray(jax.random.randint(
                jax.random.fold_in(kpool, 1), (cfg.n_styles,), 0, V)),
            "style": np.asarray(jax.random.randint(ka, (B,), 0,
                                                   cfg.n_styles)),
            "x0": np.asarray(jax.random.randint(k0, (B, 1), 0, V)),
            "noise": np.asarray(jax.random.randint(kn, (B, S), 0, V)),
            "u": np.asarray(jax.random.uniform(km, (B, S)))}


@pytest.mark.parametrize("kw", [
    dict(vocab_size=101, seq_len=32, global_batch=4),
    # a vocabulary whose products x a pass int32's range: the recurrence
    # wraps as the reference's int32 scan does
    dict(vocab_size=151936, seq_len=128, global_batch=8, seed=3),
    dict(vocab_size=50304, seq_len=64, global_batch=3, seed=7,
         noise_prob=0.3, n_styles=3),
    dict(vocab_size=17, seq_len=8, global_batch=2, kind="frames",
         d_model=16, num_codebooks=4)])
def test_batch_from_reference_draws_is_bitwise(kw):
    for step in (0, 5):
        want = JPipeline(JPipelineConfig(**kw)).batch(step)
        got = batch_from_draws(PipelineConfig(**kw),
                               _reference_draws(JPipelineConfig(**kw), step))
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k].astype(jnp.float32)
                           if k == "frames" else want[k])
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _pipe(seed=0, **kw):
    return SyntheticTokenPipeline(PipelineConfig(
        **{**dict(vocab_size=101, seq_len=32, global_batch=4, seed=seed),
           **kw}), device="cpu")


def test_batches_deterministic_and_seekable():
    p1, p2 = _pipe(), _pipe()
    for s in (0, 7, 3, 7):          # out-of-order seek
        assert torch.equal(p1.batch(s)["tokens"], p2.batch(s)["tokens"])
    assert not torch.equal(p1.batch(1)["tokens"], p1.batch(2)["tokens"])
    assert not torch.equal(p1.batch(1)["tokens"],
                           _pipe(seed=1).batch(1)["tokens"])
    assert p1.batch(0)["tokens"].dtype == torch.int32


def test_tokens_have_learnable_structure():
    """Most transitions follow the affine recurrence (noise_prob ~5%)."""
    x = _pipe(seq_len=64, global_batch=8).batch(0)["tokens"].numpy()
    consistent = total = 0
    for row in x:
        for a in range(1, 101, 2):
            c = (row[1] - a * row[0]) % 101
            pred = (a * row[:-1] + c) % 101
            if (pred == row[1:]).mean() > 0.5:
                consistent += (pred == row[1:]).sum()
                total += len(pred)
                break
    assert total > 0 and consistent / total > 0.8


def test_frames_mode_shapes():
    b = _pipe(vocab_size=17, seq_len=8, global_batch=2, kind="frames",
              d_model=16, num_codebooks=4).batch(0)
    assert b["frames"].shape == (2, 8, 16)
    assert b["frames"].dtype == torch.bfloat16
    assert b["labels"].shape == (2, 8, 4)
    assert int(b["labels"].max()) < 17 and int(b["labels"].min()) >= 0


# ----------------------------------------------------------- train step

def _model(arch, seed=0):
    cfg = configs.get_arch(arch).smoke()
    return cfg, T.init_params(cfg, device="cpu", seed=seed,
                              requires_grad=True)


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


def test_microbatching_matches_full_batch():
    """The reference test's setting (glm4-9b smoke, seq 32, batch 8,
    ce_chunk 16, remat none) and tolerances."""
    cfg, p1 = _model("glm4-9b")
    _, p2 = _model("glm4-9b")
    batch = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8),
        device="cpu").batch(0)
    s1 = make_train_step(cfg, microbatch=1, ce_chunk=16, remat="none")
    s2 = make_train_step(cfg, microbatch=4, ce_chunk=16, remat="none")
    p1, _, m1 = s1(p1, adamw_init(p1), batch, 0)
    p2, _, m2 = s2(p2, adamw_init(p2), batch, 0)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    err = max(float((a - b).abs().max()) for a, b in
              zip(p1.state_dict().values(), p2.state_dict().values()))
    assert err < 5e-4
    assert set(m1) == {"loss", "ce", "lb_loss", "z_loss", "grad_norm", "lr"}
    assert all(v.dtype == torch.float32 for v in m1.values())


def test_loss_decreases_tiny_lm():
    """The reference integration test's setting: qwen1.5-4b smoke, 120
    steps at lr 3e-3 (warmup 10), batch 8 of 64 tokens."""
    cfg, params = _model("qwen1.5-4b")
    opt = adamw_init(params)
    pipe = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, seed=1),
        device="cpu")
    step = make_train_step(cfg, opt=AdamWConfig(lr=3e-3), ce_chunk=32,
                           moe_dense=True, total_steps=120, warmup_steps=10)
    losses = []
    for s in range(120):
        params, opt, m = step(params, opt, pipe.batch(s), s)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.15


def test_moe_step_trains():
    """A few steps of the MoE with its auxiliary losses in the loss."""
    cfg, params = _model("olmoe-1b-7b")
    opt = adamw_init(params)
    pipe = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
        device="cpu")
    step = make_train_step(cfg, opt=AdamWConfig(lr=3e-3), ce_chunk=16)
    for s in range(3):
        params, opt, m = step(params, opt, pipe.batch(s), s)
        assert all(np.isfinite(float(v)) for v in m.values())
        assert float(m["lb_loss"]) > 0


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_recurrent_archs_train_on_the_cpu(arch):
    """Their kernels' plain versions differentiate; the launcher refuses
    them on the card (no backward kernel yet)."""
    cfg, params = _model(arch)
    assert "slice 17" in train_launcher.card_refusal(cfg)
    batch = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2),
        device="cpu").batch(0)
    params, _, m = make_train_step(cfg, ce_chunk=8)(
        params, adamw_init(params), batch, 0)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert train_launcher.card_refusal(configs.get_arch("qwen1.5-4b")) \
        is None


def test_prefill_and_decode_steps_wrap_the_model():
    cfg, params = _model("qwen1.5-4b")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, caches = make_prefill_step(cfg, 16)(params,
                                                 {"tokens": tokens[:, :8]})
        want, want_caches = T.prefill(cfg, params, {"tokens": tokens[:, :8]},
                                      16)
        assert torch.equal(got, want)
        got, _ = make_decode_step(cfg)(params, caches, 8,
                                       {"tokens": tokens[:, 8:]})
        want, _ = T.decode_step(cfg, params, want_caches, 8,
                                {"tokens": tokens[:, 8:]})
    assert torch.equal(got, want)


# ------------------------------------------------- fault-tolerant loop

def _tiny_setup(tmp_path, steps=30, ckpt_every=10):
    cfg, params = _model("qwen1.5-4b")
    pipe = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
        device="cpu")
    step = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), ce_chunk=16,
                           moe_dense=True)
    ckpt = CheckpointManager(tmp_path / "ckpt", keep=2, async_save=False)
    return cfg, params, pipe, step, ckpt


def test_resume_is_deterministic(tmp_path):
    """Train 30 straight vs 20, checkpoint, restore into a fresh model and
    10 more: identical parameters (seekable data, exact resume)."""
    cfg, pA, pipe, step, _ = _tiny_setup(tmp_path)

    def run(p, o, lo, hi):
        for s in range(lo, hi):
            p, o, _ = step(p, o, pipe.batch(s), s)
        return p, o

    pA, oA = run(pA, adamw_init(pA), 0, 30)
    _, pB = _model("qwen1.5-4b")
    pB, oB = run(pB, adamw_init(pB), 0, 20)
    m = CheckpointManager(tmp_path / "c2", async_save=False)
    loop = FaultTolerantLoop(LoopConfig(total_steps=30, ckpt_every=100), m,
                             step, pipe)
    loop._checkpoint(19, {"params": pB, "opt": oB})
    _, pC = _model("qwen1.5-4b", seed=9)            # other weights
    oC = adamw_init(pC)
    state, log = loop.run(pC, oC)                    # resumes at 20
    assert [r["step"] for r in log] == list(range(20, 30))
    assert _params_equal(pA, state["params"])
    assert torch.equal(oA["count"], state["opt"]["count"])


def test_retry_on_injected_failure(tmp_path):
    cfg, params, pipe, step, ckpt = _tiny_setup(tmp_path)
    loop = FaultTolerantLoop(LoopConfig(total_steps=25, ckpt_every=5), ckpt,
                             step, pipe)
    fails = {12}

    def injector(s):
        if s in fails:
            fails.discard(s)
            return True
        return False

    state, log = loop.run(params, adamw_init(params), fail_injector=injector)
    assert log[-1]["step"] == 24
    assert [r["step"] for r in log].count(10) == 2   # replayed from 9
    assert all(np.isfinite(r["loss"]) for r in log)


def test_straggler_detection(tmp_path):
    cfg, params, pipe, step, ckpt = _tiny_setup(tmp_path)
    seen = []

    def slow_step(p, o, b, s):
        if int(s) == 10:
            time.sleep(0.5)
        return step(p, o, b, s)

    loop = FaultTolerantLoop(
        LoopConfig(total_steps=15, ckpt_every=100, straggler_factor=3.0),
        ckpt, slow_step, pipe, on_straggler=lambda s, dt, ema: seen.append(s))
    loop.run(params, adamw_init(params))
    assert 10 in seen and loop.straggler_steps == seen


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    out = train_launcher.main(["--smoke", "--device", "cpu", "--steps", "12",
                               "--batch", "4", "--seq", "32",
                               "--ckpt-dir", str(tmp_path), "--ckpt-every",
                               "6", "--log-every", "4"])
    assert [r["step"] for r in out["log"]] == list(range(12))
    assert np.isfinite(out["last"])
    assert (tmp_path / "qwen1.5-4b-smoke" / "LATEST").read_text() == "11"
    text = capsys.readouterr().out
    assert "step    11 loss" in text and "done in" in text
    # a second run resumes past the last checkpoint: nothing left to do
    assert train_launcher.main(["--smoke", "--device", "cpu", "--steps",
                                "12", "--batch", "4", "--seq", "32",
                                "--ckpt-dir", str(tmp_path)]) == {}
