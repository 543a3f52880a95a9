"""The port's event-mode compaction and its every-source link loads
against the JAX reference, on the CPU.

``compact_lanes`` (``kernels/event_gather``) replaces the reference's two
tag sorts: the event tick's two-level ``compact`` (reached through the
closure of the reference's event tick, where it lives) and the one-level
``active_source_set``.  Its plain version must list the same ids, in the
same order and width, and flag the same overflow, bit for bit: over mesh
sizes around the 64-lane chunk, caps, densities and both overflow kinds
(more set lanes than the list holds; more active chunks than
``EVENT_MAX_CHUNKS``).  ``event_link_loads(idx=None)`` walks every source
and must equal the reference's full-width path.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper as jpaper
from repro.core import snn as jsnn
from repro.kernels.event_gather import active_source_set as j_active_set
from repro.kernels.event_gather import event_link_loads_ref as j_event_ref

from repro_torch.core import snn
from repro_torch.kernels.event_gather import (active_source_set,
                                              compact_lanes,
                                              compact_lanes_ref,
                                              event_link_loads)

P_GRID = (1, 63, 64, 65, 1000, 4096, 4097)
CAPS = (1, 7, 64, 1024)


def reference_compact(P: int, cap: int):
    """The reference's ``compact`` for P PEs and ``src_cap`` cap, with its
    geometry, from the closure of its event tick.  Building the tick reads
    only the params and the noise model, so no weights are made."""
    net = types.SimpleNamespace(
        params=dataclasses.replace(jpaper.SYNFIRE, n_pes=P),
        noise_model="gauss", kicks_per_tick=0)
    tick = jsnn.make_synfire_tick(net, dvfs=None, em=None,
                                  key=jax.random.PRNGKey(0), event=True,
                                  src_cap=cap)
    cells = dict(zip(tick.__code__.co_freevars,
                     (c.cell_contents for c in tick.__closure__)))
    return jax.jit(cells["compact"]), cells["cap_eff"], cells["kc"]


def masks(P: int, rng) -> dict:
    """Input sets: empty, full, sparse and half full at random, and one
    lane in each of the first 17 chunks (more active chunks than the
    two-level compaction selects, with few lanes)."""
    out = {"empty": np.zeros(P, bool), "full": np.ones(P, bool),
           "sparse": rng.random(P) < 0.01, "half": rng.random(P) < 0.5}
    spread = np.zeros(P, bool)
    spread[::snn.EVENT_CHUNK][:snn.EVENT_MAX_CHUNKS + 1] = True
    out["one_per_chunk"] = spread
    return out


@pytest.mark.parametrize("P", P_GRID)
def test_compact_matches_reference(P):
    """``snn.compact`` (two-level: at most 16 active chunks) equals the
    reference's on every mask and cap, sentinels and overflow flag
    included; both overflow kinds occur on the grid."""
    rng = np.random.default_rng(P)
    kinds = set()
    for cap in CAPS:
        j_compact, cap_eff, kc = reference_compact(P, cap)
        for name, m in masks(P, rng).items():
            jidx, jchunks = j_compact(jnp.asarray(m))
            jfits = (int(m.sum()) <= cap_eff) & (int(jchunks) <= kc)
            idx, fits = snn.compact(torch.from_numpy(m), cap)
            assert idx.dtype == torch.int32 and fits.shape == (), name
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx),
                                          err_msg=f"{name} cap {cap}")
            assert bool(fits) == bool(jfits), (name, cap)
            if not jfits:
                kinds.add("lanes" if m.sum() > cap_eff else "chunks")
    assert kinds == ({"lanes", "chunks"} if P > 16 * 64 else
                     {"lanes"} if P > 1 else set())


@pytest.mark.parametrize("P", P_GRID)
def test_active_source_set_is_one_level_compaction(P):
    """``active_source_set`` (every chunk) equals the reference's one
    sort, and ``compact_lanes`` gives the same with batch rows."""
    rng = np.random.default_rng(P + 1)
    ms = masks(P, rng)
    w = np.stack([m * rng.integers(1, 5, P) for m in ms.values()]).astype(
        np.float32)
    for cap in CAPS + (P,):
        jidx, jn = j_active_set(jnp.asarray(w), cap)
        idx, n = active_source_set(torch.from_numpy(w), cap)
        assert idx.shape == (len(ms), min(cap, P))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        one, fits, n1 = compact_lanes(torch.from_numpy(w[1] != 0), cap)
        np.testing.assert_array_equal(one.numpy(), np.asarray(jidx[1]))
        assert int(n1) == int(jn[1]) and bool(fits) == (int(jn[1]) <= cap)


def test_compact_lanes_ref_counts_every_set_lane():
    """n_active counts all set lanes, also those past the selected
    chunks, and fits needs both the lane and the chunk bound."""
    m = torch.zeros(2000, dtype=torch.bool)
    m[::64] = True                                  # 32 chunks, 1 lane each
    idx, fits, n = compact_lanes_ref(m, 64, 16)
    assert int(n) == 32 and not bool(fits)
    assert idx.tolist() == list(range(0, 16 * 64, 64)) + [2000] * 48
    idx, fits, n = compact_lanes_ref(m, 64, None)
    assert bool(fits) and idx.tolist()[:32] == list(range(0, 2000, 64))


@pytest.mark.parametrize("batch", [1, 2])
def test_event_link_loads_every_source_matches_reference(batch):
    """idx=None: every source's tree, quiet sources skipped; equal to the
    reference's full-width compaction followed by its gather, bitwise,
    with padding sentinels in the rows and half the sources quiet."""
    rng = np.random.default_rng(batch)
    P, n_links, L = 300, 700, 12
    rows = rng.integers(0, n_links, (P, L)).astype(np.int32)
    rows[rng.random((P, L)) < 0.3] = n_links
    pk = rng.integers(0, 60, P) * (rng.random(P) < 0.5)
    w = np.stack([pk, pk * rng.integers(1, 5, P)])[:batch].astype(np.float32)
    w = w.reshape((P,) if batch == 1 else (batch, P))
    got = event_link_loads(None, torch.from_numpy(w), torch.from_numpy(rows),
                           n_links=n_links).numpy()
    jw = jnp.asarray(w.reshape(-1, P))
    jidx, _ = j_active_set(jw[-1], P)      # the flits row: same sources
    want = np.stack([np.asarray(j_event_ref(jidx, jw[b], jnp.asarray(rows),
                                            n_links))
                     for b in range(batch)]).reshape(got.shape)
    np.testing.assert_array_equal(got, want)
    dense = np.zeros((P, n_links + 1), np.float32)
    np.add.at(dense, (np.repeat(np.arange(P), L), rows.ravel()), 1.0)
    np.testing.assert_array_equal(got, w @ dense[:, :n_links])
