"""Plain PyTorch versions of the port's kernels against the JAX reference.

The same seeded numpy inputs go through the reference function (its jnp
oracle and, where there is one, its Pallas kernel in interpret mode) and
through the port's wrapper on CPU tensors, which runs the plain version.
Integer outputs are compared bitwise; so are float link loads, which are
sums of integers below 2**24.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snn as jsnn
from repro.core.dvfs import DVFSController as JDVFS
from repro.core.energy import PEEnergyModel as JEnergy
from repro.kernels.explog.ops import fx_exp as j_fx_exp
from repro.kernels.explog.ref import fx_exp_ref as j_fx_exp_ref
from repro.kernels.lif.ops import lif_params_fx as j_lif_params_fx
from repro.kernels.lif.ops import lif_step as j_lif_step
from repro.kernels.lif.ref import lif_step_ref as j_lif_step_ref
from repro.kernels.link_load.ops import link_loads_csc as j_link_loads_csc
from repro.kernels.link_load.ref import link_loads_ref as j_link_loads_ref

from repro_torch.core import snn
from repro_torch.core.dvfs import DVFSController
from repro_torch.core.energy import PEEnergyModel
from repro_torch.kernels import (compact_lanes, event_link_loads,
                                 flash_attention_bwd,
                                 flash_attention_kernel, fx_exp, fx_log,
                                 launch_counts, lif_step, linear_scan,
                                 link_loads_csc, mac_conv2d, mac_gemm,
                                 noc_link_loads, reset_launch_counts,
                                 syn_accum, wkv6)
from repro_torch.kernels.explog.ref import LN2, LOG_TABLE, MAX_EXP_ARG
from repro_torch.kernels.lif.ops import lif_params_fx
from repro_torch.kernels.link_load.ref import link_loads_ref
from repro_torch.kernels.syn_accum.ref import (pack_spikes, popcount_words,
                                               unpack_spikes)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wide_int32(rng, n):
    """Full-range int32 plus the edges where wraps and clips happen."""
    edges = [0, 1, -1, I32.min, I32.max, MAX_EXP_ARG, -MAX_EXP_ARG,
             MAX_EXP_ARG + 1, -MAX_EXP_ARG - 1, LN2, -LN2, -LN2 - 1,
             -2 * LN2, 16 * LN2, 15 * LN2 + 1, 1 << 15, -(1 << 15)]
    return np.concatenate([np.array(edges, np.int32),
                           rng.integers(I32.min, I32.max, n, np.int64,
                                        endpoint=True).astype(np.int32),
                           rng.integers(-(16 << 15), 16 << 15, n,
                                        np.int32)])


# ------------------------------------------------------------------ fx_exp

def test_fx_exp_matches_reference_bitwise():
    x = _wide_int32(np.random.default_rng(0), 20000)
    got = fx_exp(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_fx_exp_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(
        got[:4096], np.asarray(j_fx_exp(jnp.asarray(x[:4096]),
                                        impl="pallas")))


def test_fx_exp_keeps_shape_and_alpha():
    x = _t(np.arange(-12, 12, dtype=np.int32).reshape(2, 3, 4) * 9000)
    assert fx_exp(x).shape == (2, 3, 4)
    kw = dict(tau_ms=10.0, v_th=1.0, v_reset=0.0, ref_ticks=2, v_min=-1.0)
    assert lif_params_fx(**kw, device="cpu") == j_lif_params_fx(**kw)


def test_explog_cuda_constants_match_the_plain_version():
    """The kernel's ladder table and LN2 are the plain version's."""
    src = (CSRC / "explog.cu").read_text()
    table = re.search(r"kLogTable\[15\]\s*=\s*\{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in table.split(",")) == LOG_TABLE
    assert int(re.search(r"kLn2\s*=\s*(\d+)", src).group(1)) == LN2


# ------------------------------------------------------------------ LIF

@pytest.mark.parametrize("v_min", [None, -(1 << 15)])
def test_lif_step_matches_reference_bitwise(v_min):
    rng = np.random.default_rng(1)
    n = 40000
    v = np.concatenate([_wide_int32(rng, n // 2),
                        rng.integers(-3 << 15, 3 << 15, n, np.int32)])
    m = v.size
    ref_ct = np.concatenate([rng.integers(-3, 4, m - 2, np.int32),
                             np.array([I32.min, I32.max], np.int32)])
    i_syn = np.concatenate([rng.integers(-(2 << 15), 2 << 15, m - 4,
                                         np.int32),
                            np.array([I32.max, I32.min, I32.max, -1],
                                     np.int32)])
    for alpha in (29650, int(rng.integers(1, I32.max))):
        kw = dict(alpha=alpha, v_th=1 << 15, v_reset=0, ref_ticks=2,
                  v_min=v_min)
        got = lif_step(_t(v), _t(ref_ct), _t(i_syn), **kw)
        want = j_lif_step_ref(jnp.asarray(v), jnp.asarray(ref_ct),
                              jnp.asarray(i_syn), **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pallas = j_lif_step(jnp.asarray(v[:8192]), jnp.asarray(ref_ct[:8192]),
                        jnp.asarray(i_syn[:8192]), **kw)
    got = lif_step(_t(v[:8192]), _t(ref_ct[:8192]), _t(i_syn[:8192]), **kw)
    for g, w in zip(got, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ link loads

def _random_incidence(rng, n_src, n_links, max_tree):
    rows = [rng.choice(n_links, rng.integers(0, max_tree + 1),
                       replace=False) for _ in range(n_src)]
    link_ids = np.concatenate(rows).astype(np.int32)
    src_of_entry = np.repeat(np.arange(n_src, dtype=np.int32),
                             [r.size for r in rows])
    order = np.argsort(link_ids, kind="stable")
    link_ptr = np.zeros(n_links + 1, np.int64)
    np.cumsum(np.bincount(link_ids, minlength=n_links), out=link_ptr[1:])
    dense = np.zeros((n_src, n_links), np.float32)
    dense[src_of_entry, link_ids] = 1.0
    return link_ids, src_of_entry, src_of_entry[order], link_ptr, dense


@pytest.mark.parametrize("n_src,n_links,max_tree", [(64, 48, 12),
                                                    (300, 1000, 40)])
def test_link_loads_match_reference_and_dense(n_src, n_links, max_tree):
    rng = np.random.default_rng(n_src)
    link_ids, src_of_entry, src_sorted, link_ptr, dense = \
        _random_incidence(rng, n_src, n_links, max_tree)
    w = rng.integers(0, 201, (2, n_src)).astype(np.float32)
    got = link_loads_csc(_t(w), _t(src_sorted), _t(link_ptr),
                         n_links=n_links).numpy()
    np.testing.assert_array_equal(got, w @ dense)
    np.testing.assert_array_equal(
        got, np.asarray(j_link_loads_ref(jnp.asarray(w), link_ids,
                                         src_of_entry, n_links)))
    np.testing.assert_array_equal(
        link_loads_ref(_t(w), _t(link_ids), _t(src_of_entry),
                       n_links).numpy(), got)
    pallas = j_link_loads_csc(jnp.asarray(w[0]), jnp.asarray(src_sorted),
                              jnp.asarray(link_ptr), n_links=n_links)
    np.testing.assert_array_equal(got[0], np.asarray(pallas))
    one = link_loads_csc(_t(w[1]), _t(src_sorted), _t(link_ptr),
                         n_links=n_links)
    assert one.shape == (n_links,)
    np.testing.assert_array_equal(one.numpy(), got[1])


# ------------------------------------------------------------------ syn_accum

def test_spike_words_match_reference():
    rng = np.random.default_rng(3)
    for n in (200, 50, 32, 7):
        spk = rng.integers(0, 2, (6, n)).astype(np.int32)
        words = pack_spikes(_t(spk), n)
        jwords = np.asarray(jsnn.pack_spikes(jnp.asarray(spk), n))
        np.testing.assert_array_equal(words.numpy(), jwords.view(np.int32))
        np.testing.assert_array_equal(unpack_spikes(words, n).numpy(), spk)
        np.testing.assert_array_equal(popcount_words(words).numpy(),
                                      np.asarray(jsnn.popcount_words(
                                          jnp.asarray(jwords))))


@pytest.mark.parametrize("full_range", [False, True])
def test_syn_accum_matches_reference_einsum(full_range):
    rng = np.random.default_rng(4 + full_range)
    P, NE, NI, N = 300, 200, 50, 250
    exc = rng.integers(I32.min, I32.max, (P, 7), np.int64,
                       endpoint=True).astype(np.int32)
    inh = rng.integers(I32.min, I32.max, (P, 2), np.int64,
                       endpoint=True).astype(np.int32)
    quiet = rng.random(P) < 0.7                        # PEs with no arrivals
    exc[quiet], inh[quiet] = 0, 0
    if full_range:                                     # sums must wrap
        w_ff = rng.integers(I32.min, I32.max, (P, NE, N), np.int64,
                            endpoint=True).astype(np.int32)
        w_inh = rng.integers(I32.min, I32.max, (P, NI, NE), np.int64,
                             endpoint=True).astype(np.int32)
    else:
        w_ff = (rng.random((P, NE, N)) < 0.3).astype(np.int32) * 2458
        w_inh = (rng.random((P, NI, NE)) < 0.5).astype(np.int32) * -9830
    got = syn_accum(_t(exc), _t(inh), _t(w_ff), _t(w_inh)).numpy()
    arr_e = jsnn.unpack_spikes(jnp.asarray(exc.view(np.uint32)), NE)
    arr_i = jsnn.unpack_spikes(jnp.asarray(inh.view(np.uint32)), NI)
    want = jnp.einsum("pe,pen->pn", arr_e, jnp.asarray(w_ff))
    want = want.at[:, :NE].add(jnp.einsum("pi,pie->pe", arr_i,
                                          jnp.asarray(w_inh)))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got[quiet].any()


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        fx_exp(x)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes differ"):
        lif_step(z, z, z[:4], alpha=1, v_th=1, v_reset=0, ref_ticks=1)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        syn_accum(torch.zeros(4, 6, dtype=torch.int32),
                  torch.zeros(4, 2, dtype=torch.int32),
                  torch.zeros(4, 200, 250, dtype=torch.int32),
                  torch.zeros(4, 50, 200, dtype=torch.int32))
    with pytest.raises(ValueError, match="bad shapes"):
        link_loads_csc(torch.zeros(4), z[:3], torch.zeros(3,
                                                          dtype=torch.int64),
                       n_links=5)
    with pytest.raises(ValueError, match="unsupported device"):
        fx_exp(torch.zeros(4, dtype=torch.int32, device="meta"))


def test_plain_versions_do_not_count_launches():
    reset_launch_counts()
    fx_exp(torch.zeros(4, dtype=torch.int32))
    event_link_loads(torch.zeros(2, dtype=torch.int32), torch.ones(3),
                     torch.zeros(3, 2, dtype=torch.int32), n_links=4)
    mac_gemm(torch.ones(2, 3, dtype=torch.int8),
             torch.ones(3, 2, dtype=torch.uint8))
    fx_log(torch.ones(4, dtype=torch.int32))
    mac_conv2d(torch.ones(1, 3, 3, 2, dtype=torch.int8),
               torch.ones(2, 2, 2, 4, dtype=torch.uint8))
    flash_attention_kernel(*[torch.ones(1, 4, 2, 8)] * 3)
    flash_attention_bwd(*[torch.ones(1, 4, 2, 8)] * 4,
                        torch.zeros(1, 2, 4), torch.ones(1, 4, 2, 8))
    compact_lanes(torch.ones(5, dtype=torch.bool), 3)
    noc_link_loads(torch.ones(3), torch.ones(3),
                   torch.zeros(1, 4, dtype=torch.int32), n_links=4)
    linear_scan(*[torch.ones(1, 3, 4)] * 3, torch.ones(4), torch.ones(1, 4))
    wkv6(*[torch.ones(1, 3, 2, 4)] * 4, torch.ones(2, 4),
         torch.ones(1, 2, 4, 4))
    assert launch_counts() == {"fx_exp": 0, "lif_step": 0,
                               "link_loads_csc": 0, "noc_link_loads": 0,
                               "syn_accum": 0,
                               "event_link_loads": 0, "mac_gemm": 0,
                               "fx_log": 0, "mac_conv2d": 0,
                               "flash_attention_kernel": 0,
                               "flash_attention_bwd": 0,
                               "compact_lanes": 0, "linear_scan": 0,
                               "wkv6": 0}


# ------------------------------------------------------------------ tick pieces

def test_shot_noise_hash_matches_reference():
    for seed in (0, 1, 2, 7, 12345, 2**31 - 1):
        assert snn.shot_seed32(seed) == int(
            jsnn._shot_seed32(jax.random.PRNGKey(seed)))
    x = np.random.default_rng(5).integers(0, 2**32, 5000, np.uint64)
    np.testing.assert_array_equal(
        snn.fmix32(_t(x.astype(np.int64))).numpy(),
        np.asarray(jsnn._fmix32(jnp.asarray(x.astype(np.uint32)))))
    seed32 = snn.shot_seed32(3)
    for t in (0, 1, 999, 2**30):
        np.testing.assert_array_equal(
            snn.shot_noise_lanes(seed32, t, 4, 64 * 250, "cpu").numpy(),
            np.asarray(jsnn.shot_noise_lanes(jnp.uint32(seed32), t, 4,
                                             64 * 250)))


def test_dvfs_and_energy_match_reference():
    rng = np.random.default_rng(6)
    n = rng.integers(0, 260, 4000).astype(np.int32)
    pl = DVFSController().select_pl(_t(n))
    np.testing.assert_array_equal(pl.numpy(),
                                  np.asarray(JDVFS().select_pl(n)))
    syn = rng.integers(0, 15000, 4000).astype(np.int32)
    for dvfs in (True, False):
        got = PEEnergyModel().tick_energy(pl, 250, _t(syn), dvfs=dvfs)
        want = JEnergy().tick_energy(jnp.asarray(pl.numpy()), 250,
                                     jnp.asarray(syn), dvfs=dvfs)
        for k in want:
            assert got[k].dtype == torch.float32, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0)
