"""The port's mixture-of-experts block (``repro_torch.models.moe``)
against the reference's ``repro.models.moe``, on the CPU, on the
reference's weights (``params_from_numpy``) at the OLMoE smoke config (4
experts, top-2, d_model 128, d_ff 160).

The dispatch is integer for integer the reference's: the top-k experts
in ``lax.top_k``'s order, each assignment's rank within its expert, the
kept mask and the buffer rows, at capacity factors from no drops (64) to
half the tokens' share (0.5).  The reference's function does not return
them, so they are recomputed here from its ``_router`` and
``jax.lax.top_k`` with its own lines.  float32 outputs at atol 1e-5 (the
reference test's tolerance between its two implementations); the
auxiliary losses at rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JMOE
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

import lm_weights


# the reference's init_params seeds each leaf with hash(path), randomised
# per process: crc32 of the path instead, for the whole module
# (tests/lm_weights.py)
@pytest.fixture(scope="module", autouse=True)
def _stable_weights():
    yield from lm_weights.stable_weights()

CAPACITY_FACTORS = (64.0, 1.25, 1.0, 0.5)
OUT_ATOL, AUX_RTOL = 1e-5, 1e-5
MLPS = ("swiglu", "geglu", "relu2", "gelu")


def setup_for(mlp="swiglu", shape=(2, 16), seed=0):
    """(port cfg, port mlp params, reference cfg, reference mlp params,
    x as numpy float32) for layer 0's MoE."""
    jcfg = dataclasses.replace(jconfigs.get_arch("olmoe-1b-7b").smoke(),
                               mlp=mlp)
    cfg = dataclasses.replace(configs.get_arch("olmoe-1b-7b").smoke(),
                              mlp=mlp)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mlp"])
    model = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    p = model["blocks"][0]["mlp"]
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return cfg, p, jcfg, jp, x


@pytest.fixture(scope="module")
def setup():
    return setup_for()


def reference_dispatch(jcfg, jp, x, cf):
    """The reference moe_apply's integers (its lines, moe.py:81-100)."""
    B, S, d = x.shape
    T_, E, K = B * S, jcfg.num_experts, jcfg.experts_per_token
    C = max(int(np.ceil(cf * T_ * K / E)), 1)
    probs, _ = JMOE._router(jcfg, jp, jnp.asarray(x).reshape(T_, d))
    _, gate_idx = jax.lax.top_k(probs, K)
    flat_e = gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - 1
    my_pos = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    keep = my_pos < C
    dst = jnp.where(keep, flat_e * C + my_pos, E * C)
    return {"C": C, "gate_idx": np.asarray(gate_idx),
            "rank": np.asarray(my_pos), "keep": np.asarray(keep),
            "dst": np.asarray(dst)}


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_moe_apply_matches_the_reference(setup, cf):
    cfg, p, jcfg, jp, x = setup
    want, jaux = JMOE.moe_apply(jcfg, jp, jnp.asarray(x), capacity_factor=cf)
    with torch.inference_mode():
        got, aux = MOE.moe_apply(cfg, p, torch.from_numpy(x),
                                 capacity_factor=cf)
        r = MOE.dispatch(cfg, p, torch.from_numpy(x).reshape(-1, x.shape[-1]),
                         capacity_factor=cf)
    ref = reference_dispatch(jcfg, jp, x, cf)
    assert r["C"] == ref["C"]
    for key in ("gate_idx", "rank", "keep", "dst"):
        assert np.array_equal(r[key].numpy(), ref[key]), key
    if cf <= 1.0:
        assert not ref["keep"].all()        # these factors drop
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=0)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=AUX_RTOL)


def test_moe_apply_dense_matches_the_reference(setup):
    cfg, p, jcfg, jp, x = setup
    want, jaux = JMOE.moe_apply_dense(jcfg, jp, jnp.asarray(x))
    with torch.inference_mode():
        got, aux = MOE.moe_apply_dense(cfg, p, torch.from_numpy(x))
        drop_free, _ = MOE.moe_apply(cfg, p, torch.from_numpy(x),
                                     capacity_factor=64.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(drop_free.numpy(), got.numpy(), atol=OUT_ATOL,
                               rtol=0)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=AUX_RTOL)


@pytest.mark.parametrize("mlp", MLPS)
def test_expert_mlp_kinds_match_the_reference(mlp):
    """The four expert MLPs (SwiGLU, GeGLU, squared ReLU, GELU) through
    both implementations, in float32 and bf16 activations."""
    cfg, p, jcfg, jp, x = setup_for(mlp, shape=(2, 8), seed=1)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jx = jnp.asarray(x, jdt)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dt)
        with torch.inference_mode():
            got = MOE.moe_apply(cfg, p, tx, capacity_factor=1.25)[0]
            got_dense = MOE.moe_apply_dense(cfg, p, tx)[0]
        want = JMOE.moe_apply(jcfg, jp, jx, capacity_factor=1.25)[0]
        want_dense = JMOE.moe_apply_dense(jcfg, jp, jx)[0]
        assert got.dtype == dt
        # float32: the reference test's atol.  bf16: the two round at
        # different points inside the expert MLP (XLA fuses the gate's
        # activation and product; PyTorch rounds g, act(g) and the
        # product), three roundings of up to 2^-8 each that reach the
        # output through wo's sum, and the output's own: 2^-6 of the
        # output's largest value
        for g, w in ((got, want), (got_dense, want_dense)):
            w = np.asarray(w.astype(jnp.float32))
            atol = OUT_ATOL if dt == torch.float32 else \
                2.0 ** -6 * np.abs(w).max()
            np.testing.assert_allclose(g.float().numpy(), w, atol=atol,
                                       rtol=0, err_msg=f"{mlp} {dt}")


def test_load_balance_loss_uniform_is_one():
    """Perfectly uniform routing gives lb_loss == 1 (Switch
    normalisation), as in the reference's test."""
    T_, E = 64, 4
    probs = torch.full((T_, E), 1.0 / E)
    sel = torch.zeros((T_, E))
    sel[torch.arange(T_), torch.arange(T_) % E] = 1.0
    want = JMOE.aux_losses(jnp.asarray(probs.numpy()),
                           jnp.asarray(sel.numpy()))
    got = MOE.aux_losses(probs, sel)
    np.testing.assert_allclose(float(got), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_capacity_drops_are_bounded(setup):
    """The reference test's property: with drops the output stays finite
    and its norm below 1.5 times the drop-free output's; and a dropped
    (token, k) contributes nothing."""
    cfg, p, _, _, x = setup
    tx = torch.from_numpy(x)
    with torch.inference_mode():
        y, _ = MOE.moe_apply(cfg, p, tx, capacity_factor=1.0)
        y_full, _ = MOE.moe_apply(cfg, p, tx, capacity_factor=64.0)
        r = MOE.dispatch(cfg, p, tx.reshape(-1, cfg.d_model),
                         capacity_factor=1.0)
    assert bool(torch.isfinite(y).all())
    assert float(y.norm()) <= float(y_full.norm()) * 1.5
    T_, K = x.shape[0] * x.shape[1], cfg.experts_per_token
    dropped_everywhere = ~r["keep"].view(T_, K).any(1)
    assert bool((y.reshape(T_, -1)[dropped_everywhere] == 0).all())
    # capacity from the call's own token count: decode (T = B) and a
    # prefill (T = B S) of the same batch drop differently
    assert MOE.capacity(cfg, 8) == max(int(np.ceil(1.25 * 8 * 2 / 4)), 1)
    assert MOE.capacity(cfg, 8 * 4096) == 20480


def test_top_k_ties_go_to_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = MOE._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[0, 1], [1, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_forward_hidden_sums_the_aux_losses():
    """forward_hidden's lb_loss and z_loss, summed over the MoE layers of
    the OLMoE smoke model in float32, against the reference's at rtol
    1e-5; a dense model's are zero tensors."""
    jcfg = jconfigs.get_arch("olmoe-1b-7b").smoke()
    cfg = configs.get_arch("olmoe-1b-7b").smoke()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    m = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    qpos = jnp.arange(16)
    x = JT.embed_input(jcfg, jp, {"tokens": jnp.asarray(toks)}, qpos,
                       jnp.float32)
    _, _, want = JT.forward_hidden(jcfg, jp, x, qpos)
    with torch.inference_mode():
        tq = torch.arange(16)
        tx = T.embed_input(cfg, m, {"tokens": torch.from_numpy(toks)}, tq,
                           torch.float32)
        _, _, got = T.forward_hidden(cfg, m, tx, tq)
    for key in ("lb_loss", "z_loss"):
        assert got[key].dtype == torch.float32 and got[key].dim() == 0
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=AUX_RTOL)
    dense = configs.get_arch("glm4-9b").smoke()
    dm = T.init_params(dense, device="cpu")
    with torch.inference_mode():
        _, _, aux = T.forward_hidden(dense, dm, T.embed_input(
            dense, dm, {"tokens": torch.from_numpy(toks)}, tq), tq)
    assert all(torch.equal(aux[k], torch.zeros(())) for k in aux)
