"""The port's training loss and every gradient leaf against the
reference's ``jax.value_and_grad``, on the CPU, at smoke widths.

Archs: a dense transformer (qwen1.5-4b: MHA, QKV biases), a MoE
(olmoe-1b-7b: qk-norm, capacity dispatch with ``moe_dense=False``, the
load-balance and router z-losses in the loss), a windowed one
(gemma3-27b: five local layers of window 8 and a global one), MusicGen
(frames, four codebook heads) and the recurrent pair (recurrentgemma-2b:
two RG-LRU layers and a local-attention one, through ``LinearScan`` and
``FlashAttention``; rwkv6-1.6b: WKV through ``WKV6``, against the
reference's ``wkv_chunked``, one chunk at S 16 and two of 32 at S 64).  Weights are the reference's
``init_params`` (crc32 path seeds, tests/lm_weights.py) with every leaf it
initialises to zeros (biases, norm scales, qk-norm) redrawn from a normal
of std 0.1, so that each takes a gradient of its own size; the port
holds them through ``params_from_numpy(requires_grad=True)``.

* float32: the reference's own functions at float32 activations
  (``embed_input(dtype=float32)``, ``forward_hidden``, ``chunked_ce``,
  the loss of ``train_loss``) against ``train_loss(dtype=float32)``: the
  loss within 1e-5 relative, every gradient leaf within 1e-4 of its
  largest magnitude.
* bfloat16 as the reference runs it (``train_loss``, bf16 activations):
  the loss within ``BF16_LOSS`` relative and every leaf within
  ``BF16_LEAF`` = 2^-4 of its largest magnitude.  The two packages round
  bf16 at different points (the port's plain flash keeps P in float32
  for P V, XLA fuses elementwise chains), so one weight set's worst leaf
  sits at a share of the limit that ``scripts/train_bf16_margins.py``
  prints over ten weight sets.

The three ``remat`` modes are held against each other, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.models import transformer as T

import lm_weights


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: the suite runs several worker
    processes at once, and smoke-width steps on many threads each
    oversubscribe the cores (a step then takes tens of times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _stable_weights():
    yield from lm_weights.stable_weights()


ARCHS = ["qwen1.5-4b", "olmoe-1b-7b", "gemma3-27b", "musicgen-large",
         "recurrentgemma-2b", "rwkv6-1.6b"]
RECURRENT = ["recurrentgemma-2b", "rwkv6-1.6b"]
B, S, CE_CHUNK = 2, 16, 8
F32_LOSS, F32_LEAF = 1e-5, 1e-4
BF16_LOSS, BF16_LEAF = 2.0 ** -10, 2.0 ** -4
LB_COEF, Z_COEF = 0.01, 1e-4


def reference_tree(cfg, key: int, rng):
    """The reference's smoke weights, zero leaves redrawn (numpy)."""
    tree = JT.init_params(cfg, jax.random.PRNGKey(key))

    def redraw(x):
        x = np.asarray(x)
        if x.dtype.kind == "f" and not np.any(x):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(redraw, tree)


def make_batch(cfg, rng, S=S):
    """numpy batch: tokens (B, S + 1) or frames (B, S, d) and labels."""
    if cfg.frontend == "encodec":
        return {"frames": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S, cfg.num_codebooks),
                                       dtype=np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1),
                                   dtype=np.int32)}


def reference_loss(jcfg, dtype, S=S):
    """The reference's loss as a function of (params, batch): its
    ``train_loss`` (bf16) or the same steps at float32 activations."""
    if dtype == "bfloat16":
        return lambda p, b: JT.train_loss(jcfg, p, b, moe_dense=False,
                                          remat="none", ce_chunk=CE_CHUNK)

    def loss(params, batch):
        if "frames" in batch:
            inputs, labels = {"frames": batch["frames"]}, batch["labels"]
        else:
            inputs = {"tokens": batch["tokens"][:, :-1]}
            labels = batch["tokens"][:, 1:]
        qpos = jnp.arange(S)
        x = JT.embed_input(jcfg, params, inputs, qpos, dtype=jnp.float32)
        hidden, _, aux = JT.forward_hidden(jcfg, params, x, qpos,
                                           moe_dense=False, remat="none")
        ce, z_ce = JT.chunked_ce(jcfg, params, hidden, labels, CE_CHUNK)
        total = ce + LB_COEF * aux["lb_loss"] + Z_COEF * (aux["z_loss"]
                                                          + z_ce)
        return total, {"loss": total, "ce": ce, "lb_loss": aux["lb_loss"],
                       "z_loss": aux["z_loss"] + z_ce}
    return loss


def reference_leaf(cfg, tree, name: str) -> np.ndarray:
    """The reference tree's leaf for the port's parameter ``name``
    (``blocks.{layer}.…``: the scanned stacks unstacked)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        node = tree
        for p in parts:
            node = node[p]
        return np.asarray(node)
    layer = int(parts[1])
    g, i = divmod(layer, cfg.pattern_len)
    if g < cfg.num_groups:
        node = tree["blocks"][i]
    else:
        node = tree["rem_blocks"][layer - cfg.num_groups * cfg.pattern_len]
    for p in parts[2:]:
        node = node[p]
    node = np.asarray(node)
    return node[g] if g < cfg.num_groups else node


def compare(arch: str, dtype: str, key: int = 0, remat: str = "full",
            seq: int = S):
    """(loss relative error, {leaf: error / its largest magnitude},
    port metrics, reference metrics) of one weight set at ``seq``
    positions."""
    jcfg = jconfigs.get_arch(arch).smoke()
    cfg = configs.get_arch(arch).smoke()
    rng = np.random.default_rng(key)
    tree = reference_tree(jcfg, key, rng)
    batch = make_batch(cfg, rng, seq)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(reference_loss(jcfg, dtype, seq),
                                      has_aux=True)(tree, jbatch)
    model = T.params_from_numpy(cfg, tree, device="cpu", requires_grad=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tdt = getattr(torch, dtype)
    if "frames" in tb:
        tb["frames"] = tb["frames"].to(torch.bfloat16) \
            if dtype == "bfloat16" else tb["frames"]
    loss, metrics = T.train_loss(cfg, model, tb, moe_dense=False,
                                 remat=remat, ce_chunk=CE_CHUNK, dtype=tdt)
    loss.backward()
    want = float(jl)
    loss_err = abs(float(loss.detach()) - want) / abs(want)
    errs = {}
    for name, p in model.named_parameters():
        w = reference_leaf(cfg, jg, name).astype(np.float32)
        # a leaf the loss does not read (MusicGen's token table) has none
        g = (p.grad.float().numpy() if p.grad is not None
             else np.zeros_like(w))
        errs[name] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return loss_err, errs, metrics, jm


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_float32(arch):
    loss_err, errs, metrics, jm = compare(arch, "float32")
    assert loss_err < F32_LOSS
    worst = max(errs, key=errs.get)
    assert errs[worst] < F32_LEAF, (worst, errs[worst])
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jm[k]), rtol=F32_LOSS, atol=1e-7,
                                   err_msg=k)
    if arch == "olmoe-1b-7b":
        assert float(metrics["lb_loss"].detach()) > 0
        assert float(metrics["z_loss"].detach()) > 0


def test_rwkv_two_wkv_chunks_float32():
    """RWKV-6 at S 64, where the reference's wkv_chunked runs two chunks
    of 32 and carries the state between them."""
    loss_err, errs, _, _ = compare("rwkv6-1.6b", "float32", seq=64)
    assert loss_err < F32_LOSS
    worst = max(errs, key=errs.get)
    assert errs[worst] < F32_LEAF, (worst, errs[worst])


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "musicgen-large"])
def test_train_loss_and_grads_bfloat16(arch):
    loss_err, errs, _, _ = compare(arch, "bfloat16")
    assert loss_err < BF16_LOSS
    worst = max(errs, key=errs.get)
    assert errs[worst] < BF16_LEAF, (worst, errs[worst])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-27b", *RECURRENT])
def test_remat_modes_agree(arch):
    """remat "none", "full" (each layer recomputed) and "dots" (matmul
    outputs kept) give the same loss and gradients, bit for bit."""
    cfg = configs.get_arch(arch).smoke()
    rng = np.random.default_rng(5)
    tree = reference_tree(jconfigs.get_arch(arch).smoke(), 5, rng)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, rng).items()}
    results = {}
    for remat in ("none", "full", "dots"):
        model = T.params_from_numpy(cfg, tree, device="cpu",
                                    requires_grad=True)
        loss, _ = T.train_loss(cfg, model, batch, remat=remat,
                               ce_chunk=CE_CHUNK)
        loss.backward()
        results[remat] = (loss.detach(), {n: p.grad for n, p in
                                          model.named_parameters()})
    base_loss, base = results["none"]
    for remat in ("full", "dots"):
        loss, grads = results[remat]
        assert torch.equal(loss, base_loss), remat
        for n, g in grads.items():
            assert torch.equal(g, base[n]), (remat, n)
