"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test needs a CUDA device and skips without one.
Run them on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

No JAX here: the card machine runs the port alone.  Each kernel is
held bitwise against the plain PyTorch version on the same inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.board import BoardSpec, compile_board
from repro_torch.chip import ChipSim, compile
from repro_torch.chip.mesh_noc import SparseIncidence
from repro_torch.chip.workloads import (adaptive_control_workload,
                                        hybrid_workload, stdp_pair_workload,
                                        synfire_graph)
from repro_torch.kernels import (compact_lanes, event_link_loads,
                                 flash_attention_bwd, flash_attention_kernel,
                                 fx_exp, fx_log, launch_counts, lif_step,
                                 linear_scan, link_loads_csc, mac_conv2d,
                                 mac_gemm, noc_link_loads,
                                 reset_launch_counts, syn_accum, wkv6)
from repro_torch.kernels.event_gather.ops import route as event_gather_route
from repro_torch.kernels.event_gather.ref import (compact_lanes_ref,
                                                  event_link_loads_ref)
from repro_torch.kernels.explog.ops import exp_table, fx_exp_launch
from repro_torch.kernels.explog.ref import FX_ONE, LN2, fx_exp_ref, fx_log_ref
from repro_torch.kernels.flash_attn.ops import _forward as flash_forward
from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                flash_attention_ref)
from repro_torch.kernels.lif.ref import lif_step_ref
from repro_torch.kernels.linear_scan.ref import linear_scan_ref
from repro_torch.kernels.link_load.ref import (link_loads_csc_ref,
                                               noc_link_loads_ref)
from repro_torch.kernels.mac_conv.ops import route as conv_route
from repro_torch.kernels.mac_conv.ref import mac_conv2d_ref
from repro_torch.kernels.mac_gemm.ref import mac_gemm_ref
from repro_torch.kernels.syn_accum.ref import syn_accum_ref
from repro_torch.kernels.wkv6.ops import route as wkv6_route
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.learn import (PES, STDP, LearnSlot, init_learn_state,
                               make_learn_step)
from repro_torch.learn.adaptive import adaptive_control_graph
from repro_torch.obs import default_probes

pytestmark = pytest.mark.gpu
I32 = np.iinfo(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ints(rng, shape, lo=I32.min, hi=I32.max):
    return torch.from_numpy(rng.integers(lo, hi, shape, np.int64,
                                         endpoint=True).astype(np.int32))


def test_fx_exp_kernel(cuda):
    rng = np.random.default_rng(0)
    x = torch.cat([_ints(rng, 1 << 20), _ints(rng, 1 << 16, -16 << 15,
                                              16 << 15)])
    before = fx_exp.launches
    got = fx_exp(x.to(cuda))
    torch.cuda.synchronize()
    assert fx_exp.launches == before + 1
    assert torch.equal(got.cpu(), fx_exp_ref(x))


def _exp_domain():
    """Every x of fx_exp's clamped domain, 4 past each end, and the int32
    ends."""
    return torch.cat([torch.arange(-(15 << 15) - 4, (15 << 15) + 5),
                      torch.tensor([I32.min, I32.min + 1, I32.max - 1,
                                    I32.max])]).to(torch.int32)


@pytest.mark.parametrize("route", ["table", "ladder"])
def test_fx_exp_kernel_routes_every_input(cuda, route):
    """Both routes over the whole clamped domain; the table's corrections
    to the card's exp lie near the exact exp's [-7, 2]."""
    x = _exp_domain()
    out = torch.empty_like(x, device=cuda)
    fx_exp_launch(x.to(cuda), out, route)
    assert torch.equal(out.cpu(), fx_exp_ref(x))
    table = exp_table(cuda).cpu()
    assert -16 <= int(table[:LN2].min()) and int(table[:LN2].max()) <= 16


@pytest.mark.parametrize("route", ["table", "ladder"])
@pytest.mark.parametrize("n", range(1, 10))
def test_fx_exp_kernel_tails_and_unaligned_views(cuda, route, n):
    x = _ints(np.random.default_rng(n), n + 1, -16 << 15, 16 << 15)
    xc = x.to(cuda)
    for view, want in ((xc[:n], x[:n]), (xc[1:], x[1:])):  # x[1:] unaligned
        out = torch.empty(n, dtype=torch.int32, device=cuda)
        fx_exp_launch(view, out, route)
        assert torch.equal(out.cpu(), fx_exp_ref(want))
    assert torch.equal(fx_exp(xc[1:]).cpu(), fx_exp_ref(x[1:]))


@pytest.mark.parametrize("v_min", [None, -(1 << 15)])
def test_lif_kernel(cuda, v_min):
    rng = np.random.default_rng(1)
    n = 1 << 20
    v, i_syn = _ints(rng, n), _ints(rng, n, -(2 << 15), 2 << 15)
    ref = _ints(rng, n, -3, 3)
    kw = dict(alpha=29650, v_th=1 << 15, v_reset=0, ref_ticks=2,
              v_min=v_min)
    got = lif_step(v.to(cuda), ref.to(cuda), i_syn.to(cuda), **kw)
    for g, w in zip(got, lif_step_ref(v, ref, i_syn, **kw)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_link_load_kernel(cuda, batch):
    rng = np.random.default_rng(2)
    n_src, n_links = 4096, 3968
    link_ids = rng.integers(0, n_links, 20000).astype(np.int32)
    order = np.argsort(link_ids, kind="stable")
    src = rng.integers(0, n_src, 20000).astype(np.int32)[order]
    ptr = np.zeros(n_links + 1, np.int64)
    np.cumsum(np.bincount(link_ids, minlength=n_links), out=ptr[1:])
    w = torch.from_numpy(rng.integers(0, 200, (batch, n_src)).astype(
        np.float32))
    w = w[0] if batch == 1 else w
    args = (torch.from_numpy(src), torch.from_numpy(ptr))
    got = link_loads_csc(w.to(cuda), *(a.to(cuda) for a in args),
                         n_links=n_links)
    assert torch.equal(got.cpu(), link_loads_csc_ref(w, *args, n_links))


def test_link_loads_csc_rows_past_the_grid(cuda):
    """More rows than the grid's y extent: one launch for each 65535."""
    rng = np.random.default_rng(3)
    n_src, n_links, rows = 8, 5, 65535 + 2
    link_ids = rng.integers(0, n_links, 20).astype(np.int32)
    order = np.argsort(link_ids, kind="stable")
    src = torch.from_numpy(rng.integers(0, n_src, 20).astype(np.int32)[order])
    ptr = np.zeros(n_links + 1, np.int64)
    np.cumsum(np.bincount(link_ids, minlength=n_links), out=ptr[1:])
    ptr = torch.from_numpy(ptr)
    w = torch.from_numpy(rng.integers(0, 200, (rows, n_src)).astype(
        np.float32))
    before = link_loads_csc.launches
    got = link_loads_csc(w.to(cuda), src.to(cuda), ptr.to(cuda),
                         n_links=n_links)
    assert link_loads_csc.launches == before + 2
    assert torch.equal(got.cpu(), link_loads_csc_ref(w, src, ptr, n_links))


# noc_link_loads: (sources, links, entries); links with no source, one
# heavy link, P not a multiple of 4, one source
NOC_CASES = [(4096, 3968, 1054), (4099, 700, 12000), (1, 5, 3)]


@pytest.mark.parametrize("route", ["padded", "csc"])
@pytest.mark.parametrize("n_src,n_links,nnz", NOC_CASES)
def test_noc_link_loads_kernel(cuda, route, n_src, n_links, nnz):
    rng = np.random.default_rng(n_links)
    link_ids = rng.integers(0, n_links // 2 + 1, nnz).astype(np.int32)
    link_ids[: nnz // 10] = n_links - 1
    src = rng.integers(0, n_src, nnz)
    sinc = SparseIncidence.from_rows(
        [np.unique(link_ids[src == p]) for p in range(n_src)], n_links,
        np.zeros(n_src, np.int32))
    pk = torch.from_numpy(rng.integers(0, 201, n_src).astype(np.float32))
    fl = torch.from_numpy(rng.integers(1, 5, n_src).astype(np.float32))
    pk[0], fl[0] = pk[0] + 1, 3
    src_sorted, link_ptr = sinc.csc
    plan = ((torch.from_numpy(sinc.link_major), None) if route == "padded"
            else (torch.from_numpy(src_sorted),
                  torch.from_numpy(link_ptr.astype(np.int32))))
    want = noc_link_loads_ref(pk, fl, *plan, n_links)
    before = noc_link_loads.launches
    got = noc_link_loads(pk.to(cuda), fl.to(cuda),
                         *(None if t is None else t.to(cuda) for t in plan),
                         n_links=n_links)
    torch.cuda.synchronize()
    assert noc_link_loads.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert float(want[1].sum()) > float(want[0].sum())


@pytest.mark.parametrize("route", ["padded", "csc"])
@pytest.mark.parametrize("w", [1, 3, 64])
def test_noc_link_loads_kernel_fleet_rows(cuda, route, w):
    """A fleet's (w, P) packets, with the run's (P,) flits and with
    per-instance (w, P) flits: the 2w rows in one launch, equal to the
    plain version."""
    n_src, n_links, nnz = NOC_CASES[0]
    rng = np.random.default_rng(w)
    link_ids = rng.integers(0, n_links, nnz).astype(np.int32)
    src = rng.integers(0, n_src, nnz)
    sinc = SparseIncidence.from_rows(
        [np.unique(link_ids[src == p]) for p in range(n_src)], n_links,
        np.zeros(n_src, np.int32))
    src_sorted, link_ptr = sinc.csc
    plan = ((torch.from_numpy(sinc.link_major), None) if route == "padded"
            else (torch.from_numpy(src_sorted),
                  torch.from_numpy(link_ptr.astype(np.int32))))
    pk = torch.from_numpy(rng.integers(0, 201, (w, n_src))
                          .astype(np.float32))
    for fl in (torch.from_numpy(rng.integers(1, 5, n_src)
                                .astype(np.float32)),
               torch.from_numpy(rng.integers(1, 5, (w, n_src))
                                .astype(np.float32))):
        want = noc_link_loads_ref(pk, fl, *plan, n_links)
        before = noc_link_loads.launches
        got = noc_link_loads(pk.to(cuda), fl.to(cuda),
                             *(None if t is None else t.to(cuda)
                               for t in plan), n_links=n_links)
        torch.cuda.synchronize()
        assert noc_link_loads.launches == before + 1
        assert got.shape == (2, w, n_links)
        assert torch.equal(got.cpu(), want)


def test_event_link_loads_kernel_fleet_rows(cuda):
    """Event-mode loads of a fleet: (2, w, P) packet and flit rows in one
    launch, equal to the plain version."""
    rng = np.random.default_rng(6)
    n_src, n_links, L, w = 4096, 3968, 16, 8
    rows = rng.integers(0, n_links, (n_src, L)).astype(np.int32)
    rows[rng.random((n_src, L)) < 0.3] = n_links
    wts = torch.from_numpy(rng.integers(0, 5, (2, w, n_src))
                           .astype(np.float32))
    rows = torch.from_numpy(rows)
    before = event_link_loads.launches
    got = event_link_loads(None, wts.to(cuda), rows.to(cuda),
                           n_links=n_links)
    assert event_link_loads.launches == before + 1
    assert torch.equal(got.cpu(), event_link_loads_ref(None, wts, rows,
                                                       n_links))


# syn_accum inputs: (P, spike words); the kernel gives a block up to 16 PEs,
# 4 of 1001 and 16 of 4099, so neither P fills its last block
def _words(rng, P, case):
    exc, inh = _ints(rng, (P, 7)), _ints(rng, (P, 2))      # bits >= NE, NI
    if case == "idle":
        exc[:], inh[:] = 0, 0
    elif case == "one_full":
        exc[:], inh[:] = 0, 0
        exc[P // 2], inh[P // 2] = -1, -1                # every bit set
    elif case == "wave":
        keep = torch.from_numpy(rng.random(P) < 0.01)
        exc[~keep], inh[~keep] = 0, 0
    else:                                                # "thirds"
        exc[::3], inh[::3] = 0, 0
    return exc, inh


@pytest.mark.parametrize("P,case", [(512, "thirds"), (512, "idle"),
                                    (1001, "one_full"), (1001, "wave"),
                                    (4099, "wave"), (1, "one_full")])
def test_syn_accum_kernel(cuda, P, case):
    """Dense form: full-range weights whose sums wrap int32, garbage bits
    above NE and NI in the last words, P not a multiple of the block's
    PEs, an all-idle tick, one PE with every bit set."""
    rng = np.random.default_rng(3 + P)
    NE, NI, N = 200, 50, 250
    exc, inh = _words(rng, P, case)
    w_ff, w_inh = _ints(rng, (P, NE, N)), _ints(rng, (P, NI, NE))
    got = syn_accum(*(t.to(cuda) for t in (exc, inh, w_ff, w_inh)))
    want = syn_accum_ref(exc, inh, w_ff, w_inh)
    assert torch.equal(got.cpu(), want)
    assert (case == "idle") == (not want.any())


@pytest.mark.parametrize("P", [512, 1001])
@pytest.mark.parametrize("fits", [True, False])
def test_syn_accum_listed_kernel(cuda, fits, P):
    """Event form: listed PEs only while the set fits (the rest zero, the
    sentinel P and ids in a partly filled last block ignored), every PE
    when it overflowed."""
    rng = np.random.default_rng(4)
    NE, NI, N = 200, 50, 250
    exc, inh = _ints(rng, (P, 7)), _ints(rng, (P, 2))
    w_ff, w_inh = _ints(rng, (P, NE, N)), _ints(rng, (P, NI, NE))
    pes = torch.tensor([3, 70, 71, 500, P - 1] + [P] * 59,
                       dtype=torch.int32)
    args = (exc, inh, w_ff, w_inh, pes, torch.tensor(fits))
    got = syn_accum(*(t.to(cuda) for t in args))
    assert torch.equal(got.cpu(), syn_accum_ref(*args))


# compaction grid: P around the 64-lane chunk and up to a 4097-PE mesh,
# caps, and masks that overflow by lanes and by chunks
COMPACT_MASKS = ("empty", "full", "sparse", "half", "one_per_chunk")


def _mask(rng, P, kind):
    if kind in ("empty", "full"):
        return torch.full((P,), kind == "full")
    if kind == "one_per_chunk":                     # 17 chunks, 1 lane each
        m = torch.zeros(P, dtype=torch.bool)
        m[::64][:17] = True
        return m
    return torch.from_numpy(rng.random(P) < (0.01 if kind == "sparse"
                                             else 0.5))


@pytest.mark.parametrize("max_chunks", [16, None])
@pytest.mark.parametrize("P", [1, 63, 64, 65, 1000, 4096, 4097, 65536])
def test_compact_lanes_kernel(cuda, P, max_chunks):
    rng = np.random.default_rng(P)
    for kind in COMPACT_MASKS:
        m = _mask(rng, P, kind)
        for cap in (1, 7, 64, 1024, P):
            before = compact_lanes.launches
            got = compact_lanes(m.to(cuda), cap, max_chunks)
            assert compact_lanes.launches == before + 1
            for g, w in zip(got, compact_lanes_ref(m, cap, max_chunks)):
                assert g.dtype == w.dtype and torch.equal(g.cpu(), w), \
                    (kind, cap)


def test_compact_lanes_kernel_rows_and_limit(cuda):
    """A leading batch axis takes one block a row; more lanes than one
    block holds are refused, not sorted."""
    rng = np.random.default_rng(9)
    m = torch.from_numpy(rng.random((3, 700)) < 0.05)
    got = compact_lanes(m.to(cuda), 20, 4)
    for g, w in zip(got, compact_lanes_ref(m, 20, 4)):
        assert torch.equal(g.cpu(), w)
    with pytest.raises(ValueError, match="at most 65536"):
        compact_lanes(torch.zeros(65537, dtype=torch.bool, device=cuda), 64)


@pytest.mark.parametrize("L", [16, 13])
@pytest.mark.parametrize("n_links,batch,kernel", [
    (3968, 1, "smem"), (3968, 2, "smem"), (3968, 3, "global"),
    (20000, 1, "global"), (20000, 2, "global")])
def test_event_link_loads_kernel(cuda, n_links, batch, kernel, L):
    """Both routes (chosen by shape), batch 1-3, rows of 16 slots (16-byte
    loads) and 13: every source (idx None, quiet sources skipped), every
    source listed, and a buffer with sentinel lanes and quiet sources;
    rows padded with sentinels."""
    rng = np.random.default_rng(5)
    n_src = 4096
    assert event_gather_route(batch, n_links) == kernel
    rows = rng.integers(0, n_links, (n_src, L)).astype(np.int32)
    rows[rng.random((n_src, L)) < 0.3] = n_links           # padding
    w = rng.integers(0, 5, (3, n_src)).astype(np.float32)[:batch]
    w = torch.from_numpy(w.reshape(-1) if batch == 1 else w)
    rows = torch.from_numpy(rows)
    for idx in (None, np.arange(n_src, dtype=np.int32),
                np.sort(np.concatenate([rng.choice(n_src, 900, False),
                                        np.full(100, n_src)])).astype(
                    np.int32)):
        idx = None if idx is None else torch.from_numpy(idx)
        got = event_link_loads(None if idx is None else idx.to(cuda),
                               w.to(cuda), rows.to(cuda), n_links=n_links)
        assert torch.equal(got.cpu(), event_link_loads_ref(idx, w, rows,
                                                           n_links))


@pytest.mark.parametrize("a_t,b_t", [(torch.int8, torch.int8),
                                     (torch.uint8, torch.uint8),
                                     (torch.int8, torch.uint8),
                                     (torch.uint8, torch.int8)])
@pytest.mark.parametrize("m,k,n", [(600, 1, 256), (37, 45, 29),
                                   (64, 128, 64), (1000, 777, 513),
                                   (1, 400, 120), (1, 4096, 512),
                                   (129, 65, 257), (128, 128, 128),
                                   (300, 1000, 70), (70, 32, 90),
                                   (70, 33, 90)])
def test_mac_gemm_kernel(cuda, a_t, b_t, m, k, n):
    rng = np.random.default_rng(m + k + n)

    def operand(shape, dtype):
        lo, hi = (-128, 127) if dtype == torch.int8 else (0, 255)
        return torch.from_numpy(rng.integers(lo, hi, shape, np.int64,
                                             endpoint=True)).to(dtype)
    a, b = operand((m, k), a_t), operand((k, n), b_t)
    got = mac_gemm(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), mac_gemm_ref(a, b))


@pytest.mark.parametrize("k", [64, 45])
def test_mac_gemm_kernel_unaligned_a(cuda, k):
    """A whose rows are not 16-byte aligned (a view one byte into its
    storage) goes through the kernel's padded copy of A."""
    rng = np.random.default_rng(k)
    flat = torch.from_numpy(rng.integers(-128, 127, 70 * k + 1, np.int64,
                                         endpoint=True)).to(torch.int8)
    a = flat.to(cuda)[1:].view(70, k)
    b = torch.from_numpy(rng.integers(-128, 127, (k, 90), np.int64,
                                      endpoint=True)).to(torch.int8)
    assert a.data_ptr() % 16
    got = mac_gemm(a, b.to(cuda))
    assert torch.equal(got.cpu(), mac_gemm_ref(flat[1:].view(70, k), b))


# operands that fill every sum past the int32 range: the kernel wraps as
# the reference's int32 accumulation (and the plain version) does
WRAP_GEMMS = [(255, (2, 40000), (40000, 3), torch.uint8),
              (-128, (1, 140000), (140000, 1), torch.int8),
              (255, (64, 40000), (40000, 64), torch.uint8)]


@pytest.mark.parametrize("fill,a_shape,b_shape,dtype", WRAP_GEMMS)
def test_mac_gemm_kernel_wraps(cuda, fill, a_shape, b_shape, dtype):
    a = torch.full(a_shape, fill, dtype=dtype)
    b = torch.full(b_shape, fill, dtype=dtype)
    want = mac_gemm_ref(a, b)
    assert (want.long() == (a_shape[1] * fill * fill + 2**31) % 2**32
            - 2**31).all()
    assert torch.equal(mac_gemm(a.to(cuda), b.to(cuda)).cpu(), want)


def test_fx_log_kernel_every_int32(cuda):
    """Every positive int32 in chunks, then 0, negatives and INT32_MIN."""
    chunk = 1 << 26
    for lo in range(1, 1 << 31, chunk):
        x = torch.arange(lo, min(lo + chunk, 1 << 31), dtype=torch.int64,
                         device=cuda).to(torch.int32)
        assert torch.equal(fx_log(x), fx_log_ref(x)), lo
    x = torch.tensor([0, -1, -5, -(1 << 15), I32.min + 1, I32.min],
                     dtype=torch.int32, device=cuda)
    assert torch.equal(fx_log(x), fx_log_ref(x))


@pytest.mark.parametrize("start,stop", [(0, None), (1, None), (3, -2),
                                        (0, 3)])
def test_fx_log_kernel_unaligned_views_and_tails(cuda, start, stop):
    """Views that start off a 16-byte boundary take the one-element loop;
    lengths not a multiple of 4 leave a tail."""
    rng = np.random.default_rng(7)
    x = _ints(rng, (1 << 16) + 3)[start:stop]
    assert torch.equal(fx_log(x.to(cuda)).cpu(), fx_log_ref(x))


def test_fx_log_kernel(cuda):
    rng = np.random.default_rng(6)
    edges = [I32.min, -5, -1, 0, 1, 2, FX_ONE - 1, FX_ONE, FX_ONE + 1,
             I32.max] + [1 << k for k in range(31)]
    x = torch.cat([torch.tensor(edges, dtype=torch.int32),
                   _ints(rng, 1 << 20), _ints(rng, 1 << 16, 1, 1 << 22)])
    before = fx_log.launches
    got = fx_log(x.to(cuda))
    torch.cuda.synchronize()
    assert fx_log.launches == before + 1
    assert torch.equal(got.cpu(), fx_log_ref(x))


CONV_CASES = [
    ((1, 8, 8, 16), (3, 3, 16, 32), (1, 1), "VALID"),
    ((2, 16, 16, 8), (3, 3, 8, 64), (1, 1), "SAME"),
    ((1, 28, 28, 1), (5, 5, 1, 6), (1, 1), "VALID"),
    ((1, 14, 14, 64), (1, 1, 64, 128), (1, 1), "VALID"),
    ((1, 16, 16, 16), (3, 3, 16, 32), (2, 2), "SAME"),
    ((1, 32, 32, 3), (3, 3, 3, 130), (1, 1), "SAME"),
    ((1, 7, 9, 4), (2, 4, 4, 8), (1, 2), "VALID"),
]


def _bytes(rng, shape, dtype):
    lo, hi = (-128, 127) if dtype == torch.int8 else (0, 255)
    return torch.from_numpy(rng.integers(lo, hi, shape, np.int64,
                                         endpoint=True)).to(dtype)


@pytest.mark.parametrize("xs,ws,stride,pad", CONV_CASES)
def test_mac_conv2d_kernel(cuda, xs, ws, stride, pad):
    rng = np.random.default_rng(sum(xs) + sum(ws))
    x, w = _bytes(rng, xs, torch.int8), _bytes(rng, ws, torch.int8)
    got = mac_conv2d(x.to(cuda), w.to(cuda), stride=stride, padding=pad)
    assert torch.equal(got.cpu(), mac_conv2d_ref(x, w, stride=stride,
                                                 padding=pad))


@pytest.mark.parametrize("xs,ws,pad", [
    ((1, 2, 3, 40000), (1, 1, 40000, 2), "VALID"),
    ((1, 4, 4, 3700), (3, 3, 3700, 2), "SAME")])
def test_mac_conv2d_kernel_wraps(cuda, xs, ws, pad):
    x = torch.full(xs, 255, dtype=torch.uint8)
    w = torch.full(ws, 255, dtype=torch.uint8)
    got = mac_conv2d(x.to(cuda), w.to(cuda), padding=pad)
    assert torch.equal(got.cpu(), mac_conv2d_ref(x, w, padding=pad))


@pytest.mark.parametrize("x_t,w_t", [(torch.int8, torch.int8),
                                     (torch.uint8, torch.uint8),
                                     (torch.int8, torch.uint8),
                                     (torch.uint8, torch.int8)])
def test_mac_conv2d_kernel_signedness(cuda, x_t, w_t):
    rng = np.random.default_rng(8)
    x, w = _bytes(rng, (2, 23, 19, 40), x_t), _bytes(rng, (3, 3, 40, 70),
                                                      w_t)
    got = mac_conv2d(x.to(cuda), w.to(cuda), stride=(2, 1), padding="SAME")
    assert torch.equal(got.cpu(), mac_conv2d_ref(x, w, stride=(2, 1),
                                                 padding="SAME"))


# the tensor-core route (Cin % 16 == 0): Cout and B Ho Wo off the 128 x
# N tiles, N of 64, 128 and 256, two tiles of 256 channels, stride (2, 1),
# both paddings, and a split-K shape (4 output tiles, 18 K tiles)
WGMMA_CONV_CASES = [
    ((1, 13, 11, 16), (3, 3, 16, 70), (1, 1), "SAME"),
    ((2, 17, 9, 48), (3, 2, 48, 200), (2, 1), "VALID"),
    ((1, 9, 10, 48), (1, 1, 48, 40), (2, 1), "SAME"),
    ((1, 12, 12, 16), (3, 3, 16, 300), (1, 1), "VALID"),
    ((1, 20, 20, 256), (3, 3, 256, 256), (1, 1), "SAME"),
]
PAIRS = [(torch.int8, torch.int8), (torch.uint8, torch.uint8),
         (torch.int8, torch.uint8), (torch.uint8, torch.int8)]


@pytest.mark.parametrize("x_t,w_t", PAIRS)
@pytest.mark.parametrize("xs,ws,stride,pad", WGMMA_CONV_CASES)
def test_mac_conv2d_wgmma_kernel(cuda, xs, ws, stride, pad, x_t, w_t):
    rng = np.random.default_rng(sum(xs) + sum(ws) + stride[0])
    x, w = _bytes(rng, xs, x_t), _bytes(rng, ws, w_t)
    xc, wc = x.to(cuda), w.to(cuda)
    assert conv_route(xc, wc) == "wgmma"
    before = mac_conv2d.launches
    got = mac_conv2d(xc, wc, stride=stride, padding=pad)
    torch.cuda.synchronize()
    assert mac_conv2d.launches == before + 1
    assert torch.equal(got.cpu(), mac_conv2d_ref(x, w, stride=stride,
                                                 padding=pad))


def test_mac_conv2d_wgmma_kernel_wraps(cuda):
    """uint8 255s over K = 3 * 3 * 4096 > 33025 taps: every interior sum
    leaves the int32 range and wraps, split K's atomics included."""
    x = torch.full((1, 5, 5, 4096), 255, dtype=torch.uint8)
    w = torch.full((3, 3, 4096, 20), 255, dtype=torch.uint8)
    want = mac_conv2d_ref(x, w, padding="SAME")
    assert int(want[0, 2, 2, 0]) == (9 * 4096 * 255 * 255 + 2**31) % 2**32 \
        - 2**31
    xc = x.to(cuda)
    assert conv_route(xc, w.to(cuda)) == "wgmma"
    assert torch.equal(mac_conv2d(xc, w.to(cuda), padding="SAME").cpu(),
                       want)


@pytest.mark.parametrize("cin,kernel", [(15, "dp4a"), (16, "wgmma"),
                                        (24, "dp4a")])
def test_mac_conv2d_route_boundary(cuda, cin, kernel):
    rng = np.random.default_rng(cin)
    x = _bytes(rng, (2, 10, 9, cin), torch.int8)
    w = _bytes(rng, (3, 3, cin, 36), torch.uint8)
    xc, wc = x.to(cuda), w.to(cuda)
    assert conv_route(xc, wc) == kernel
    got = mac_conv2d(xc, wc, stride=(2, 1), padding="SAME")
    assert torch.equal(got.cpu(), mac_conv2d_ref(x, w, stride=(2, 1),
                                                 padding="SAME"))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [8, 64, 80, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1000])
def test_flash_attention_kernel_f32_tiles(cuda, s, d, causal):
    """The float32 3xTF32 kernel off its 64-query and 32-kv tile edges,
    D zero-filled to 64 or 128, at the float32 tolerance."""
    shape = (2, s, 2, d)
    gen = torch.Generator().manual_seed(s * 1000 + d + 7)
    q, k, v = (torch.randn(shape, generator=gen) for _ in range(3))
    got = flash_attention_kernel(q.to(cuda), k.to(cuda), v.to(cuda),
                                 causal=causal)
    fold = lambda t: t.transpose(1, 2).reshape(4, s, d)
    want = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal)
    want = want.reshape(2, 2, s, d).transpose(1, 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-4)


# bfloat16: one rounding of the output (rtol 2^-7 is one bf16 ulp)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 1e-4)),
                                       (torch.bfloat16, (4e-3, 2 ** -7))])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(32, 32), (128, 64)])
@pytest.mark.parametrize("shape", [(2, 64, 2, 16), (1, 200, 3, 128),
                                   (1, 130, 2, 40), (1, 97, 3, 20)])
def test_flash_attention_kernel(cuda, shape, bq, bk, causal, dtype, tol):
    B, S, H, D = shape
    gen = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for _ in range(3))
    got = flash_attention_kernel(q.to(cuda), k.to(cuda), v.to(cuda),
                                 causal=causal, bq=bq, bk=bk)
    assert got.dtype == dtype
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    want = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal)
    want = want.reshape(B, H, S, D).transpose(1, 2)
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 40, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 200, 4096])
def test_flash_attention_kernel_bf16_tiles(cuda, s, d, causal):
    """The bf16 tensor-core kernel off its 128-query and 64-kv tile
    edges, D zero-filled to its 64-value blocks, B H = 4 heads."""
    shape = (2, s, 2, d)
    gen = torch.Generator().manual_seed(s * 1000 + d)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16()
               for _ in range(3))
    got = flash_attention_kernel(q.to(cuda), k.to(cuda), v.to(cuda),
                                 causal=causal)
    fold = lambda t: t.transpose(1, 2).reshape(4, s, d)
    want = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal)
    want = want.reshape(2, 2, s, d).transpose(1, 2)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=4e-3,
                               rtol=2 ** -7)


# the band of a local layer: 1 (the diagonal alone) to past S (causal);
# S across the 64- and 128-row query tiles, so the first kv tile of a
# query tile is often partly outside the band (rows whose band starts past
# it), and some rows meet whole masked tiles before their first key
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 1e-4)),
                                       (torch.bfloat16, (4e-3, 2 ** -7))])
@pytest.mark.parametrize("window", [1, 8, 63, 64, 100, 1024])
@pytest.mark.parametrize("s,d", [(1, 64), (65, 128), (200, 40),
                                 (1000, 128), (4096, 64)])
def test_flash_attention_kernel_window(cuda, s, d, window, dtype, tol):
    """Both kernels with a sliding window against the plain version with
    the same window, at their causal tolerances."""
    shape = (1, s, 3, d)
    gen = torch.Generator().manual_seed(s * 1000 + d + window)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for _ in range(3))
    got = flash_attention_kernel(q.to(cuda), k.to(cuda), v.to(cuda),
                                 window=window)
    fold = lambda t: t.transpose(1, 2).reshape(3, s, d)
    want = flash_attention_ref(fold(q), fold(k), fold(v), window=window)
    want = want.reshape(1, 3, s, d).transpose(1, 2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=tol[0], rtol=tol[1])


def _expand_kv(q, k, v):
    """k and v repeated to q's head count (query head h meets KV head
    h // G, the reference's grouping)."""
    G = q.shape[2] // k.shape[2]
    return k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)


# head_dim 129-256: bf16 on the warp-specialised kernel (two consumers of
# the same 64 rows of a head pair for G even, 128 rows of one head for G
# odd; D zero-filled to 256), float32 on the 3xTF32 wgmma kernel; H over
# H_kv heads, S across the 64- and 128-row query tiles and the 2-stage
# K/V ring, causal, full and banded (RecurrentGemma's window 2048)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 1e-4)),
                                       (torch.bfloat16, (4e-3, 2 ** -7))])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64),
                                           (True, 2048)])
@pytest.mark.parametrize("h,hkv", [(2, 2), (10, 1), (4, 2), (3, 1)])
@pytest.mark.parametrize("s,d", [(1, 256), (65, 256), (129, 200),
                                 (300, 136), (1000, 200), (2200, 256)])
def test_flash_attention_kernel_head_dim_256(cuda, s, d, h, hkv, causal,
                                             window, dtype, tol):
    gen = torch.Generator().manual_seed(s * 1000 + d + window + h)
    q = torch.randn(1, s, h, d, generator=gen).to(dtype)
    k, v = (torch.randn(1, s, hkv, d, generator=gen).to(dtype)
            for _ in range(2))
    got = flash_attention_kernel(q.to(cuda), k.to(cuda), v.to(cuda),
                                 causal=causal, window=window)
    ke, ve = _expand_kv(q, k, v)
    fold = lambda t: t.transpose(1, 2).reshape(h, s, d)
    want = flash_attention_ref(fold(q), fold(ke), fold(ve), causal=causal,
                               window=window)
    want = want.reshape(1, h, s, d).transpose(1, 2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=tol[0], rtol=tol[1])


# every route with K and V at H_kv < H heads against the same K and V
# expanded to H: bf16 D 40 (one column block), 100 (plain loads), 128,
# 196 (D 256 kernel, plain loads) and 256 (TMA); float32 D 40, 100,
# 128, 198 (element loads) and 256; G even (head pairs) and odd
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("h,hkv", [(4, 2), (6, 2), (3, 1), (10, 1)])
@pytest.mark.parametrize("d", [40, 100, 128, 196, 198, 256])
def test_flash_attention_kv_heads_equal_the_expanded_call(cuda, d, h, hkv,
                                                          window, dtype):
    """The kernel reads KV head h // G in place: bit for bit the result
    of the call with K and V expanded to every query head."""
    s = 300
    gen = torch.Generator().manual_seed(d * 100 + h + window)
    q = torch.randn(2, s, h, d, generator=gen).to(dtype).to(cuda)
    k, v = (torch.randn(2, s, hkv, d, generator=gen).to(dtype).to(cuda)
            for _ in range(2))
    got = flash_attention_kernel(q, k, v, window=window)
    ke, ve = _expand_kv(q, k, v)
    want = flash_attention_kernel(q, ke.contiguous(), ve.contiguous(),
                                  window=window)
    assert torch.equal(got, want)


def _watch_flash_kv(monkeypatch):
    """Record the K heads of every flash call the model layers make, and
    count ``Tensor.repeat_interleave`` calls (the K/V expansion)."""
    from repro_torch.models import layers as L
    seen = {"kv_heads": [], "q_heads": [], "repeats": 0}
    flash, repeat = L.flash_attention_kernel, torch.Tensor.repeat_interleave

    def recording(q, k, v, **kw):
        seen["q_heads"].append(q.shape[2])
        seen["kv_heads"].append(k.shape[2])
        return flash(q, k, v, **kw)

    def counting(self, *args, **kw):
        seen["repeats"] += 1
        return repeat(self, *args, **kw)
    monkeypatch.setattr(L, "flash_attention_kernel", recording)
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", counting)
    return seen


# S across the 32-position tiles and the 6-stage ring (192), W across the
# 32-channel stripes
@pytest.mark.parametrize("B,S,W", [(1, 1, 1), (2, 37, 100), (3, 100, 2560),
                                   (8, 1, 2560), (1, 4097, 33), (2, 31, 31),
                                   (1, 32, 32), (2, 33, 65), (1, 191, 64),
                                   (1, 192, 95), (2, 193, 64)])
def test_linear_scan_kernel(cuda, B, S, W):
    """The RG-LRU kernel against its plain version on the card, y and h
    bit for bit (the same float32 operations, no FMA in the recurrence);
    Griffin-range decays so that the state carries across the walk."""
    gen = torch.Generator().manual_seed(B * 1000 + S + W)
    xi, xa, u = (torch.randn(B, S, W, generator=gen) for _ in range(3))
    a0 = torch.empty(W).uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(a0) / 8.0))
    h0 = torch.randn(B, W, generator=gen)
    args = [t.to(cuda) for t in (xi, xa, u, lam, h0)]
    y, h = linear_scan(*args)
    y_ref, h_ref = linear_scan_ref(*args)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


# the sequential route holds the state at atol = rtol = 1e-5 (the same
# rounded products and sums); the chunked one (D 64, S >= 64) holds y and
# the state within 2^-16 of their largest magnitudes (another order of
# summation); y within 2^-16 on both
WKV_REL = 2.0 ** -16
# the recurrent tests' decay ranges: log(-lw) uniform in each
WKV_DECAYS = {"wide": (-8.0, 3.0), "fast": (-2.0, 0.0),
              "slow": (-10.0, -5.0)}


def _wkv_check(cuda, args):
    y, st = wkv6(*(t.to(cuda) for t in args))
    y_ref, st_ref = wkv6_ref(*args)
    assert y.dtype == st.dtype == torch.float32
    y, st = y.cpu(), st.cpu()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert (y - y_ref).abs().max() <= WKV_REL * y_ref.abs().max()
    B, S, H, D = args[0].shape
    if wkv6_route(S, D) == "chunked":
        assert (st - st_ref).abs().max() <= WKV_REL * st_ref.abs().max()
    else:
        torch.testing.assert_close(st, st_ref, atol=1e-5, rtol=1e-5)


def _wkv_args(gen, B, S, H, D, dtype, decay=(-6.0, 1.0)):
    r, k, v = (torch.randn(B, S, H, D, generator=gen).to(dtype)
               for _ in range(3))
    lw = -torch.exp(torch.empty(B, S, H, D).uniform_(*decay, generator=gen))
    u = 0.5 * torch.randn(H, D, generator=gen)
    s0 = torch.randn(B, H, D, D, generator=gen)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D", [(1, 1, 1, 8), (2, 50, 3, 16),
                                     (1, 200, 2, 32), (2, 64, 4, 64),
                                     (8, 1, 32, 64), (1, 33, 2, 128)])
def test_wkv6_kernel(cuda, B, S, H, D, dtype):
    """The WKV kernels against their plain version (wkv_sequential), each
    route at its tolerance (``_wkv_check``); (2, 64, 4, 64) is on the
    chunked route, the rest on the sequential one."""
    gen = torch.Generator().manual_seed(B * 100 + S + H + D)
    _wkv_check(cuda, _wkv_args(gen, B, S, H, D, dtype))


@pytest.mark.parametrize("decay", list(WKV_DECAYS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [63, 64, 65, 200, 4097])
def test_wkv6_kernel_chunked(cuda, S, dtype, decay):
    """S around the chunk (63 stays sequential), ragged chunks and a long
    walk at D 64, at the three decay ranges, the strongest included:
    finite, y and state within 2^-16 of their largest magnitudes."""
    gen = torch.Generator().manual_seed(S + 7 * list(WKV_DECAYS).index(decay))
    args = _wkv_args(gen, 2, S, 3, 64, dtype, WKV_DECAYS[decay])
    reset_launch_counts()
    _wkv_check(cuda, args)
    assert wkv6.route_launches[wkv6_route(S, 64)] == 1


def test_recurrent_kernels_count_their_launches(cuda):
    reset_launch_counts()
    linear_scan(*[torch.ones(1, 3, 4, device=cuda)] * 3,
                torch.ones(4, device=cuda), torch.ones(1, 4, device=cuda))
    wkv6(*[torch.ones(1, 3, 2, 8, device=cuda)] * 4,
         torch.ones(2, 8, device=cuda), torch.ones(1, 2, 8, 8, device=cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["linear_scan"] == counts["wkv6"] == 1
    assert wkv6.route_launches == {"sequential": 1, "chunked": 0}
    wkv6(*[torch.ones(1, 64, 2, 64, device=cuda)] * 4,
         torch.ones(2, 64, device=cuda), torch.ones(1, 2, 64, 64, device=cuda))
    torch.cuda.synchronize()
    assert launch_counts()["wkv6"] == 2
    assert wkv6.route_launches == {"sequential": 1, "chunked": 1}
    reset_launch_counts()
    assert wkv6.route_launches == {"sequential": 0, "chunked": 0}
    with pytest.raises(ValueError, match="head size"):
        wkv6(*[torch.ones(1, 3, 2, 12, device=cuda)] * 4,
             torch.ones(2, 12, device=cuda),
             torch.ones(1, 2, 12, 12, device=cuda))


def test_new_kernels_count_their_launches(cuda):
    reset_launch_counts()
    fx_log(torch.ones(5, dtype=torch.int32, device=cuda))
    mac_conv2d(torch.ones(1, 4, 4, 2, dtype=torch.uint8, device=cuda),
               torch.ones(2, 2, 2, 3, dtype=torch.int8, device=cuda))
    flash_attention_kernel(*[torch.ones(1, 4, 1, 8, device=cuda)] * 3)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fx_log"] == counts["mac_conv2d"] == \
        counts["flash_attention_kernel"] == 1


def test_wrapper_rejects_non_contiguous(cuda):
    x = torch.zeros(64, dtype=torch.int32, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        fx_exp(x)


def test_card_run_matches_cpu_run(cuda):
    """64-PE shot-noise ring, sparse NoC: the card's records equal the
    CPU's (plain versions) bit for bit, through every kernel."""
    graph = synfire_graph(64, noise_model="shot", device="cpu")
    prog = compile(graph)
    reset_launch_counts()
    got = ChipSim(prog, noc_mode="sparse", device=cuda).run(100)
    counts = launch_counts()
    want = ChipSim(prog, noc_mode="sparse", device="cpu").run(100)
    assert counts["syn_accum"] == counts["lif_step"] == 100
    assert counts["noc_link_loads"] == 100
    assert counts["link_loads_csc"] == 0
    for k, w in want.items():
        g = got[k].cpu()
        if w.is_floating_point() and k.startswith("e_"):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), k


def test_card_event_run_matches_cpu_run(cuda):
    """The same ring in event mode (event tick + event NoC accounting):
    the card's records equal the CPU's and the card's dense run."""
    graph = synfire_graph(64, noise_model="shot", device="cpu")
    prog = compile(graph)
    kw = dict(noc_mode="sparse", exec_mode="event")
    reset_launch_counts()
    got = ChipSim(prog, device=cuda, **kw).run(100)
    counts = launch_counts()
    want = ChipSim(prog, device="cpu", **kw).run(100)
    dense = ChipSim(prog, device=cuda, noc_mode="sparse",
                    exec_mode="dense").run(100)
    assert counts["event_link_loads"] == counts["syn_accum"] == 100
    assert counts["compact_lanes"] == 100
    assert counts["noc_link_loads"] == counts["link_loads_csc"] == 0
    for k, w in want.items():
        assert torch.equal(got[k], dense[k]), k
        g = got[k].cpu()
        if w.is_floating_point() and k.startswith("e_"):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), k


def test_card_hybrid_matches_cpu(cuda):
    reset_launch_counts()
    got = hybrid_workload(64, 16, n_ticks=100, device=cuda)
    counts = launch_counts()
    want = hybrid_workload(64, 16, n_ticks=100, device="cpu")
    assert counts["mac_gemm"] >= 1 and counts["lif_step"] == 100
    for k, w in want["recs"].items():
        g = got["recs"][k].cpu()
        if k.startswith("e_") or k in ("xhat", "hidden_out"):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(g, w), k


# ------------------------------------------------------ on-mesh learning

def _learn_records_close(got: dict, want: dict, close=()) -> None:
    """Card records against the CPU's: energies at rtol 1e-6, the float32
    sums over the decoders (``close``) and every slot's dw and arrived
    error at rtol 1e-5, everything else bitwise."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].cpu()
        if k.startswith("e_"):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        elif k in close or k.endswith(("/dw", "/err")):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(g, w), k


def test_card_stdp_pair_matches_cpu(cuda):
    """STDP on the card: every record equal to the CPU's; fx_exp launched
    for the LIF alpha and once for the trace decays, not every tick."""
    reset_launch_counts()
    got = stdp_pair_workload(n_pre=16, n_post=4, n_ticks=128, device=cuda)
    counts = launch_counts()
    want = stdp_pair_workload(n_pre=16, n_post=4, n_ticks=128, device="cpu")
    assert counts["fx_exp"] == 2 and counts["lif_step"] == 128
    _learn_records_close(got["recs"], want["recs"])


def test_card_adaptive_control_matches_cpu(cuda):
    kw = dict(n_channels=3, n_neurons=50, n_ticks=256, period=256)
    reset_launch_counts()
    got = adaptive_control_workload(device=cuda, **kw)
    counts = launch_counts()
    want = adaptive_control_workload(device="cpu", **kw)
    assert counts["fx_exp"] == 2 and counts["lif_step"] == 256
    _learn_records_close(got["recs"], want["recs"],
                         close=("u", "y", "track_err", "dec_norm"))


def test_card_learn_group_matches_cpu(cuda):
    """A 64-slot PES group and a 64-slot STDP group advanced 5 ticks on
    the card and on the CPU: traces and STDP weights bitwise, decoders
    bitwise (elementwise float32), dw at rtol 1e-5."""
    rng = np.random.default_rng(0)
    slots = ([LearnSlot(f"p{i}", "pes", PES(learning_rate=1e-4), "a", "b",
                        16, 2, (i % 8,)) for i in range(64)]
             + [LearnSlot(f"s{i}", "stdp", STDP(), "a", "b", 12, 4,
                          (i % 8,)) for i in range(64)])

    class Program:
        learn_slots, n_pes = tuple(slots), 8
    states = {d: init_learn_state(Program, d) for d in (cuda, "cpu")}
    steps = {d: make_learn_step(Program, d) for d in (cuda, "cpu")}
    for _ in range(5):
        rec = {}
        for g in states["cpu"].groups:
            s, names = g[0], [s.name for s in g]
            rec[states["cpu"].signal_key(names, "pre")] = torch.from_numpy(
                (rng.random((len(g), s.n_pre)) < 0.3).astype(np.float32))
            other = "err" if s.kind == "pes" else "post"
            rec[states["cpu"].signal_key(names, other)] = torch.from_numpy(
                rng.standard_normal((len(g), s.n_post)).astype(np.float32)
                if s.kind == "pes"
                else (rng.random((len(g), s.n_post)) < 0.3).astype(
                    np.float32))
        upd = {}
        for d in (cuda, "cpu"):
            states[d], upd[d] = steps[d](
                states[d], {k: v.to(d) for k, v in rec.items()})
        _learn_records_close(upd[cuda], upd["cpu"])
    for name in states["cpu"]:
        for k, v in states["cpu"][name].items():
            assert torch.equal(states[cuda][name][k].cpu(), v), (name, k)


def test_card_probes_match_cpu(cuda):
    """A plastic 2x2 board with the default probes at stride 20: the
    card's probe output equals the CPU's (float32 sums over the decoders
    at rtol 1e-5), and keep_records=False returns it alone."""
    kw = dict(n_channels=4, n_neurons=50, n_ticks=128, period=128)
    prog = compile_board(adaptive_control_graph(device="cpu", **kw),
                         BoardSpec.parse("2x2", chip="1x1"), refine=False)
    specs = default_probes(prog, stride=20)
    got = ChipSim(prog, device=cuda).run(128, probes=specs,
                                         keep_records=False)
    want = ChipSim(prog, device="cpu").run(128, probes=specs)
    assert set(got) == {"probes"} and set(got["probes"]) == set(
        want["probes"])
    for name, w in want["probes"].items():
        torch.testing.assert_close(got["probes"][name].cpu(), w,
                                   rtol=1e-5, atol=1e-12)


def test_lm_prefill_launches_flash_once_a_layer(cuda, monkeypatch):
    """A smoke-width GLM-4-9B prefill on the card: the flash kernel once a
    layer, handed K and V at the model's KV heads with no
    ``repeat_interleave`` copy, logits and caches within the CPU's (the
    plain version) at one bf16 step of their magnitude (2^-7 relative:
    two steps)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get_arch("glm4-9b").smoke()
    cpu = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card = card.to(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)))
    with torch.inference_mode():
        want, wc = T.prefill(cfg, cpu, {"tokens": toks}, 48)
        before = flash_attention_kernel.launches
        seen = _watch_flash_kv(monkeypatch)
        got, gc = T.prefill(cfg, card, {"tokens": toks.to(cuda)}, 48)
        torch.cuda.synchronize()
        monkeypatch.undo()
    assert flash_attention_kernel.launches == before + cfg.num_layers
    assert seen["kv_heads"] == [cfg.num_kv_heads] * cfg.num_layers
    assert cfg.num_kv_heads < cfg.num_heads and seen["repeats"] == 0
    for g, w in [(got, want)] + [(a[k], b[k]) for a, b in zip(gc, wc)
                                 for k in ("k", "v")]:
        g, w = g.float().cpu(), w.float()
        assert (g - w).abs().max() <= 2.0 ** -7 * w.abs().max()


def test_recurrentgemma_prefill_hands_flash_its_kv_heads(cuda, monkeypatch):
    """A smoke-width RecurrentGemma prefill on the card (4 query heads
    over 1 KV head): the flash kernel once a local layer, handed K and V
    at the model's one KV head with no ``repeat_interleave`` copy."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get_arch("recurrentgemma-2b").smoke()
    card = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card = card.to(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20))).to(cuda)
    n_local = T.layer_kinds(cfg).count("local")
    with torch.inference_mode():
        before = flash_attention_kernel.launches
        seen = _watch_flash_kv(monkeypatch)
        T.prefill(cfg, card, {"tokens": toks}, 24)
        torch.cuda.synchronize()
        monkeypatch.undo()
    assert n_local > 0 and flash_attention_kernel.launches == before + n_local
    assert seen["kv_heads"] == [cfg.num_kv_heads] * n_local
    assert seen["q_heads"] == [cfg.num_heads] * n_local
    assert cfg.num_kv_heads < cfg.num_heads and seen["repeats"] == 0


def test_lm_bf16_decode_on_the_card_matches_the_cpu(cuda):
    """A smoke-width GLM-4-9B served in bf16: prefill of 16 tokens (the
    flash kernel) and 8 decode steps (dense attention over the cache
    written in place) on the card against the CPU's on the same weights:
    every step's logits and every layer's final cache within 2^-7 of
    their largest magnitude (two bf16 steps)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get_arch("glm4-9b").smoke()
    cpu = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card = card.to(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)))
    runs = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        tt = toks.to(dev)
        with torch.inference_mode():
            lg, caches = T.prefill(cfg, m, {"tokens": tt[:, :16]}, 24)
            outs = [lg]
            for t in range(16, 24):
                lg, caches = T.decode_step(cfg, m, caches, t,
                                           {"tokens": tt[:, t:t + 1]})
                outs.append(lg)
        runs[dev] = outs, caches
    (want, wc), (got, gc) = runs["cpu"], runs["cuda"]
    assert len(got) == 9 and got[-1].dtype == torch.bfloat16
    for g, w in list(zip(got, want)) + [(a[k], b[k]) for a, b in zip(gc, wc)
                                        for k in ("k", "v")]:
        g, w = g.float().cpu(), w.float()
        assert (g - w).abs().max() <= 2.0 ** -7 * w.abs().max()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
                                  "gemma3-27b", "musicgen-large"])
def test_lm_zoo_on_the_card_matches_the_cpu(cuda, arch):
    """Smoke-width MoE (capacity dispatch), Gemma-3 (window 8: the
    windowed flash kernel in its local layers' prefill, ring caches
    wrapped by the decode) and MusicGen (frames, codebook heads) in bf16:
    a prefill of 20 and 8 decode steps on the card against the CPU's on
    the same weights; every MoE layer's routing (top-k experts, ranks,
    kept mask, buffer rows) equal at every call; logits and final caches
    within 2^-7 of their largest magnitude (two bf16 steps)."""
    from repro_torch import configs
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    cfg = configs.get_arch(arch).smoke()
    cpu = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card = card.to(cuda)
    rng = np.random.default_rng(2)
    if cfg.frontend == "encodec":
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (2, 28, cfg.d_model))).to(torch.bfloat16)}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 28)))}
    cut = lambda b, lo, hi: {k: v[:, lo:hi] for k, v in b.items()}
    orig, runs = MOE.dispatch, {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        routes = []

        def recording(*args, **kw):
            routes.append(orig(*args, **kw))
            return routes[-1]
        MOE.dispatch = recording
        try:
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.inference_mode():
                before = flash_attention_kernel.launches
                lg, caches = T.prefill(cfg, m, cut(b, 0, 20), 28)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    assert flash_attention_kernel.launches == \
                        before + cfg.num_layers
                outs = [lg]
                for t in range(20, 28):
                    lg, caches = T.decode_step(cfg, m, caches, t,
                                               cut(b, t, t + 1))
                    outs.append(lg)
        finally:
            MOE.dispatch = orig
        runs[dev] = outs, caches, routes
    (want, wc, wr), (got, gc, gr) = runs["cpu"], runs["cuda"]
    assert len(gr) == len(wr) == (9 * cfg.num_layers if cfg.moe else 0)
    for g, w in zip(gr, wr):
        assert g["C"] == w["C"]
        for key in ("gate_idx", "rank", "keep", "dst"):
            assert torch.equal(g[key].cpu(), w[key]), key
    if cfg.window_size:
        assert gc[0]["k"].shape[1] == cfg.window_size
    for g, w in list(zip(got, want)) + [(a[k], b[k]) for a, b in zip(gc, wc)
                                        for k in ("k", "v")]:
        g, w = g.float().cpu(), w.float()
        assert (g - w).abs().max() <= 2.0 ** -7 * w.abs().max()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_recurrent_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """Smoke-width RecurrentGemma (RG-LRU layers through linear_scan, the
    local layer's windowed flash at window 8, its ring wrapped by the
    decode) and RWKV-6 (wkv6) in bf16: a prefill of 20 and 8 decode steps
    on the card against the CPU's on the same weights (the zero leaves
    redrawn from a seeded normal); each prefill launches each layer's
    kernel once; logits and every final cache leaf within 2^-7 of their
    largest magnitude (two bf16 steps)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get_arch(arch).smoke()
    cpu = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(3)
    specs = T.model_pspecs(cfg)["blocks"]
    with torch.no_grad():
        for spec, block in zip(specs, cpu["blocks"]):
            for sub, leaves in spec.items():
                for name, ps in leaves.items():
                    if ps.init == "zeros":
                        block[sub][name].copy_(0.5 * torch.randn(
                            ps.shape, generator=gen))
    card = T.init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 28)))
    kinds = T.layer_kinds(cfg)
    want_launches = {"flash_attention_kernel": kinds.count("local"),
                     "linear_scan": kinds.count("rglru"),
                     "wkv6": kinds.count("rwkv")}
    runs = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        tt = toks.to(dev)
        with torch.inference_mode():
            before = launch_counts()
            lg, caches = T.prefill(cfg, m, {"tokens": tt[:, :20]}, 28)
            if dev == "cuda":
                torch.cuda.synchronize()
                after = launch_counts()
                assert {k: after[k] - before[k] for k in want_launches} == \
                    want_launches
            outs = [lg]
            for t in range(20, 28):
                lg, caches = T.decode_step(cfg, m, caches, t,
                                           {"tokens": tt[:, t:t + 1]})
                outs.append(lg)
        runs[dev] = outs, caches
    (want, wc), (got, gc) = runs["cpu"], runs["cuda"]
    flat = lambda c: ([x for v in c.values() for x in flat(v)]
                      if isinstance(c, dict) else [c])
    pairs = list(zip(got, want)) + [(a, b) for g, w in zip(gc, wc)
                                    for a, b in zip(flat(g), flat(w))]
    for g, w in pairs:
        g, w = g.float().cpu(), w.float()
        assert (g - w).abs().max() <= 2.0 ** -7 * w.abs().max()


def test_optimize_routes_on_the_card_matches_the_cpu(cuda):
    from repro_torch.board import BoardSpec
    from repro_torch.chip.workloads import hybrid_farm_board_graph
    from repro_torch.routeopt import optimize_routes
    board = BoardSpec.parse("2x2", chip="4x2")
    runs = {}
    for dev in ("cpu", cuda):
        res = optimize_routes(hybrid_farm_board_graph(board, device=dev),
                              board, n_ticks=24, max_iters=3, device=dev)
        runs[str(dev)] = res
    a, b = runs["cpu"], runs[str(cuda)]
    assert (a.iterations, a.converged) == (b.iterations, b.converged)
    drop = ("compile_s", "measure_s")
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in a.trajectory] == \
        [{k: v for k, v in r.items() if k not in drop} for r in b.trajectory]
    assert a.route == b.route


# ------------------------------------------------ flash attention backward

# chip_smoke.py's flash_attention_bwd rows: (B, S, H, H_kv, D), dtype,
# window; the backward's limit, of each gradient's largest magnitude
# (bf16: P and dS are rounded to bf16 for their products; float32: 3xTF32)
BWD_ROWS = {"bwd-b": ((1, 4096, 20, 20, 128), torch.bfloat16, 0),
            "bwd-g": ((1, 4096, 32, 2, 128), torch.bfloat16, 0),
            "bwd-w": ((1, 4096, 32, 16, 128), torch.bfloat16, 1024),
            "bwd-m": ((1, 4096, 32, 32, 64), torch.bfloat16, 0),
            "bwd-f": ((1, 1024, 20, 20, 128), torch.float32, 0)}
BWD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -14}


def _bwd_case(cuda, shape, dtype, causal, window, seed):
    """Inputs on the card, the kernels' gradients and the plain
    version's (on the card), with the forward's own output and lse."""
    B, S, H, Hkv, D = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda h: torch.randn(B, S, h, D, generator=gen,
                                device=cuda).to(dtype)
    q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
    o, lse = flash_forward(q, k, v, causal, window, True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    return got, want


def _assert_bwd_close(got, want, dtype):
    """Each gradient within BWD_TOL of the larger of its own largest
    magnitude and dV's.  dQ and dK vanish where every query meets one key
    (S 1, window 1: P is one-hot and dP - delta is 0 in exact
    arithmetic); there both versions give the float32 rounding of that
    cancellation, at the scale of the products, which dV (P^T dO)
    carries."""
    scale = float(want[2].float().abs().max())
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all()), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * max(float(w.float().abs().max()),
                                           scale), (name, err)


@pytest.mark.parametrize("row", sorted(BWD_ROWS))
def test_flash_attention_bwd_kernel_rows(cuda, row):
    shape, dtype, window = BWD_ROWS[row]
    got, want = _bwd_case(cuda, shape, dtype, True, window, 0)
    _assert_bwd_close(got, want, dtype)


# S across the 64-row tiles and the wgmma route's 128-row blocks (1, one
# short, one over, at and around 128, ragged), windows from the diagonal
# alone to past S, G 1-16 (8 and 16: the group split across blocks), D
# padded to 64 or 128 (8 and 40: plain loads, not multiples of 16 bytes
# in float32), causal and full
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1),
                                           (True, 64), (True, 100),
                                           (False, 33)])
@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2), (4, 1), (16, 2),
                                   (32, 2)])
@pytest.mark.parametrize("s,d", [(1, 64), (63, 128), (65, 40), (127, 128),
                                 (128, 64), (129, 128), (200, 8),
                                 (1000, 128)])
def test_flash_attention_bwd_kernel_sweep(cuda, s, d, h, hkv, causal,
                                          window, dtype):
    got, want = _bwd_case(cuda, (2, s, h, hkv, d), dtype, causal, window,
                          s + d + h + window)
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("shape", [(1, 700, 8, 2, 128),
                                   BWD_ROWS["bwd-b"][0],
                                   BWD_ROWS["bwd-g"][0]])
def test_flash_attention_bwd_is_bitwise_reproducible(cuda, shape):
    """No atomics: two calls give the same bits, at G 1 and where the
    wgmma route splits the group across blocks (bwd-g: 16 query heads
    a KV head, summed in head order)."""
    a, _ = _bwd_case(cuda, shape, torch.bfloat16, True, 0, 3)
    b, _ = _bwd_case(cuda, shape, torch.bfloat16, True, 0, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _bwd_kernel_names(call):
    """The flash_bwd kernels the profiler saw three calls of ``call``
    launch (it has been seen to drop a call's records)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].split("<")[0].removeprefix("void ")
            for e in prof.key_averages() if "flash_bwd" in e.key}


# (B, S, H, H_kv, D), dtype, q's offset in elements -> the kernels
BWD_ROUTES = [((1, 256, 20, 20, 128), torch.bfloat16, 0, "wgmma"),
              ((1, 256, 32, 2, 128), torch.bfloat16, 0, "wgmma"),
              ((1, 256, 8, 8, 64), torch.bfloat16, 0, "wgmma"),
              ((1, 256, 4, 2, 128), torch.bfloat16, 4, "mma"),
              ((1, 256, 4, 2, 100), torch.bfloat16, 0, "mma"),
              ((1, 256, 4, 4, 128), torch.float32, 0, "mma"),
              ((1, 256, 8, 2, 64), torch.float32, 0, "mma"),
              ((1, 256, 4, 2, 30), torch.float32, 0, "mma")]


@pytest.mark.parametrize("shape,dtype,offset,route", BWD_ROUTES)
def test_flash_attention_bwd_route(cuda, shape, dtype, offset, route):
    """Aligned bf16 LM shapes (D 64 and 128, contiguous) launch the wgmma
    kernels, an unaligned view, a head size off the multiples of 8 and
    float32 the mma.sync ones, as bwd_route says, with the sum pass at
    H_kv < H on the wgmma route and in float32; the launch count is
    bwd_launches'."""
    from repro_torch.kernels.flash_attn.ops import bwd_launches, bwd_route
    B, S, H, Hkv, D = shape
    gen = torch.Generator(device=cuda).manual_seed(S + H + D)
    rnd = lambda h: torch.randn(B, S, h, D, generator=gen,
                                device=cuda).to(dtype)
    q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
    if offset:                     # q's data off a 16-byte boundary
        q = torch.cat([torch.zeros(offset, device=cuda, dtype=dtype),
                       q.flatten()])[offset:].view(B, S, H, D)
    o, lse = flash_forward(q, k, v, True, 0, True)
    assert bwd_route(q, k, v, o, do) == route
    call = lambda: flash_attention_bwd(q, k, v, o, lse, do)
    names = _bwd_kernel_names(call)
    tag = "_wgmma" if route == "wgmma" else ""
    want = {f"flash_bwd_dkdv{tag}_kernel", f"flash_bwd_dq{tag}_kernel",
            "flash_bwd_prep_kernel" if tag else "flash_bwd_delta_kernel"}
    if Hkv != H and (tag or dtype == torch.float32):
        want.add("flash_bwd_reduce_kernel")
    assert names == want
    reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == \
        bwd_launches(q, k, v, o, do) == len(want)
    _assert_bwd_close(got, flash_attention_bwd_ref(q, k, v, o, lse, do),
                      dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,window", [(64, 0), (128, 100), (200, 0),
                                      (256, 2048)])
@pytest.mark.parametrize("s", [1, 129, 1000])
def test_flash_attention_lse_output(cuda, s, d, window, dtype):
    """Every forward route writes the log-sum-exp of the plain version,
    and its output is bit for bit the call's without lse."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(1, s, 4, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(1, s, 2, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    o, lse = flash_forward(q, k, v, True, window, True)
    assert torch.equal(o, flash_forward(q, k, v, True, window, False)[0])
    ke, ve = _expand_kv(q, k, v)
    fold = lambda t: t.transpose(1, 2).reshape(4, s, d)
    _, want = flash_attention_ref(fold(q), fold(ke), fold(ve),
                                  window=window, return_lse=True)
    assert lse.shape == (1, 4, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse.reshape(4, s), want, atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("hkv,bwd", [(4, 3), (2, 4)])
def test_flash_backward_counts_its_launches(cuda, hkv, bwd):
    """Autograd through flash_attention_kernel on the card: one forward
    launch (with lse) and the backward's kernels: three (lse and delta,
    dK and dV, dQ), and the sum of the query heads' partial dK and dV
    where H_kv < H."""
    q = torch.randn(1, 100, 4, 64, device=cuda,
                    dtype=torch.bfloat16).requires_grad_()
    k, v = (torch.randn(1, 100, hkv, 64, device=cuda,
                        dtype=torch.bfloat16).requires_grad_()
            for _ in range(2))
    reset_launch_counts()
    out = flash_attention_kernel(q, k, v)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention_kernel"] == 1
    assert counts["flash_attention_bwd"] == bwd
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))


def test_cuda_training_without_a_backward_kernel_raises(cuda):
    """No fallback: head_dim 256 and the recurrent kernels refuse grad on
    the card, and the launcher refuses the recurrent archs there."""
    from repro_torch.launch import train as train_launcher
    q = torch.ones(1, 8, 2, 256, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="slice 17"):
        flash_attention_kernel(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="slice 17"):
        linear_scan(*[torch.ones(1, 3, 4, device=cuda,
                                 requires_grad=True)] * 3,
                    torch.ones(4, device=cuda), torch.ones(1, 4, device=cuda))
    with pytest.raises(NotImplementedError, match="slice 17"):
        wkv6(*[torch.ones(1, 3, 2, 64, device=cuda,
                          requires_grad=True)] * 4,
             torch.ones(2, 64, device=cuda),
             torch.ones(1, 2, 64, 64, device=cuda))
    with pytest.raises(SystemExit):
        train_launcher.main(["--arch", "recurrentgemma-2b", "--smoke",
                             "--steps", "1"])


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "olmoe-1b-7b", "gemma3-27b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Three steps of the smoke model in float32 on the card (flash and
    its backward) and on the CPU (plain versions): losses and weights."""
    from repro_torch import configs
    from repro_torch.data.pipeline import (PipelineConfig,
                                           SyntheticTokenPipeline)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = configs.get_arch(arch).smoke()
    runs = {}
    for dev in ("cpu", cuda):
        params = T.init_params(cfg, device="cpu", seed=0).to(dev)
        params.requires_grad_(True)
        opt = adamw_init(params)
        pipe = SyntheticTokenPipeline(PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=64, global_batch=4),
            device=dev)
        step = make_train_step(cfg, ce_chunk=32, dtype=torch.float32)
        losses = []
        for s in range(3):
            params, opt, m = step(params, opt, pipe.batch(s), s)
            losses.append(float(m["loss"]))
        runs[str(dev)] = losses, {k: v.float().cpu() for k, v in
                                  params.state_dict().items()}
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for name, w in pc.items():
        assert float((pg[name] - w).abs().max()) <= \
            1e-3 * float(w.abs().max()), name
