#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
drives the main path (``synfire_graph`` -> ``compile`` -> ``ChipSim.run``
-> ``chip_power_table``) through the entry points a user calls, and
checks what comes out:

1. device   — card name and count, torch/CUDA versions, nvidia-smi.
2. build    — nvcc build of every kernel, its wall time and registers.
3. paper    — the 8-PE test chip (Gaussian noise, dense NoC), 1200 ticks:
              80-tick wave on every PE and the Table III bands.
4. board    — the 4096-PE ring at the uncut Table II widths (shot noise,
              sparse NoC), 300 ticks: PE p first fires > 100 spikes at
              tick 10 p.
   profile  — the same ring again for its steady tick time, and 20
              ticks under torch.profiler: device busy time per tick, the
              device's idle share, the kernels that take the time, and
              each hand kernel's device time per launch inside the tick.
5. kernels  — each kernel against its plain PyTorch version, bitwise, on
              the card at the main path's shapes (the 4096-PE ring's
              weights and incidence).  ``ms`` is the kernel's own device
              time per launch (torch.profiler) with the L2 cache flushed
              before every launch, as a tick reads its inputs cold;
              ``warm_ms`` is the same back to back, with the inputs left
              in L2; ``call_ms`` is one wrapper call back to back (CUDA
              events, host included); the plain version and one PyTorch
              library call (where there is one) are timed with L2
              flushed; ``bound_ms`` is the least time the card could
              take.  ``main_path_ms`` is the device time per launch in
              the profiled ticks, beside the bound of those ticks' data.
6. parity   — the 256-PE shot-noise ring on the card and on the CPU:
              integer records bitwise, float energies at rtol=1e-6.

Launch counters are zeroed just before each main-path run (phases 3 and
4) and read just after; a kernel of that path that never launched fails
the run.  Every phase prints one JSON line; any failed check raises.  The
last lines are the card's nvidia-smi name and power limit, the kernels
line and ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when no CUDA device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.chip import ChipSim, chip_power_table, compile  # noqa: E402
from repro_torch.chip.workloads import synfire_graph  # noqa: E402
from repro_torch.kernels import (_build, fx_exp, launch_counts,  # noqa: E402
                                 lif_step, link_loads_csc,
                                 reset_launch_counts, syn_accum)
from repro_torch.kernels.explog.ops import to_fx  # noqa: E402
from repro_torch.kernels.explog.ref import fx_exp_ref  # noqa: E402
from repro_torch.kernels.lif.ref import lif_step_ref  # noqa: E402
from repro_torch.kernels.link_load.ref import link_loads_csc_ref  # noqa: E402
from repro_torch.kernels.syn_accum.ref import (pack_spikes,  # noqa: E402
                                               popcount_words,
                                               spike_words, syn_accum_ref)

# H100 SXM published peaks (NVIDIA datasheet): HBM bandwidth and
# the float32 rate outside the tensor cores, used for int32 adds as well
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

PAPER_TICKS, BOARD_PES, BOARD_TICKS = 1200, 4096, 300
PARITY_PES, PARITY_TICKS = 256, 100
PROFILE_WARM, PROFILE_TICKS = 5, 20
L2_FLUSH_BYTES = 256 << 20      # five times the H100's 50 MB L2
# device symbol of each wrapper's kernel (csrc/*.cu)
KERNEL_SYMBOLS = {"lif_step": "lif_step_kernel", "fx_exp": "fx_exp_kernel",
                  "link_loads_csc": "link_loads_csc_kernel",
                  "syn_accum": "syn_accum_kernel"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def l2_flusher(dev):
    """A call that evicts the L2 cache by writing a buffer five times its
    size, so that the next launch reads its inputs from HBM."""
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device=dev).zero_


def cuda_ms(fn, iters: int, flush=None, warmup: int = 3) -> float:
    """Mean milliseconds per call, timed with CUDA events after
    ``warmup`` calls: over ``iters`` back-to-back calls, or, with
    ``flush``, around each call alone with ``flush()`` run before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush()
        pairs.append((torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)))
        pairs[-1][0].record()
        fn()
        pairs[-1][1].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_kernels(fn, iters: int) -> tuple[dict, float]:
    """Run ``fn`` ``iters`` times under torch.profiler.  Returns the
    device kernels it ran, name -> (launches, total device µs), and the
    wall µs of the profiled window (which the profiler itself slows)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if str(evt.device_type).endswith("CUDA") and us > 0:
            kernels[evt.key] = (evt.count, float(us))
    return kernels, wall_us


def per_launch_ms(kernels: dict, name: str):
    """(launches, mean device ms per launch) of ``name``'s kernel in a
    profile from ``device_kernels``; (0, None) when it is not there."""
    hits = [(n, us) for key, (n, us) in kernels.items()
            if KERNEL_SYMBOLS[name] in key]
    launches = sum(n for n, _ in hits)
    return launches, (sum(us for _, us in hits) / launches / 1e3
                      if launches else None)


def kernel_device_ms(name: str, fn, iters: int = 20, flush=None):
    """Mean device time of one launch of ``name``'s kernel, with
    ``flush()`` before each call when given (the flush's own kernel is
    not counted), or None when the profiler recorded no such kernel."""
    call = fn if flush is None else (lambda: (flush(), fn()))
    return per_launch_ms(device_kernels(call, iters)[0], name)[1]


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """Least time for the work: bytes over HBM bandwidth or operations
    over the CUDA-core rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def first_strong_ticks(recs: dict, n_pes: int) -> list:
    """Per PE, the first tick at which more than 100 exc neurons fire."""
    strong = (recs["spikes_exc"][:, :n_pes].sum(2) > 100).cpu().numpy()
    return [int(np.argmax(col)) if col.any() else -1 for col in strong.T]


# ---------------------------------------------------------------- phases

def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)
    return smi[0] if smi else "nvidia-smi gave no output"


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, ptxas=regs)


def phase_paper(dev) -> dict:
    reset_launch_counts()
    graph = synfire_graph(8, device=dev)
    sim = ChipSim(compile(graph), device=dev)
    recs = sim.run(PAPER_TICKS)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(not sim.use_sparse_noc(), "8-PE chip must use the dense NoC")
    for name in ("fx_exp", "syn_accum", "lif_step"):
        check(counts[name] > 0, f"paper chip: {name} never launched")
    spk = recs["spikes_exc"].sum(2).cpu().numpy()
    for p in range(8):
        strong = np.flatnonzero(spk[:, p] > 100)
        check(len(strong) >= 5 and np.all(np.abs(np.diff(strong[:5]) - 80)
                                          <= 2),
              f"paper chip: PE{p} wave ticks {strong[:6].tolist()}")
    pl = recs["pl"].cpu().numpy()
    frac = np.bincount(pl.ravel(), minlength=3) / pl.size
    check(frac[0] > 0.9 and frac[2] > 0.005, f"PL shares {frac}")
    tab = chip_power_table(sim, recs)
    red = tab["per_pe"]["reduction"]
    check(0.55 <= red["baseline"] <= 0.72, f"baseline reduction {red}")
    check(0.15 <= red["neuron"] <= 0.27, f"neuron reduction {red}")
    check(0.04 <= red["synapse"] <= 0.25, f"synapse reduction {red}")
    check(0.52 <= red["total"] <= 0.72, f"total reduction {red}")
    check(abs(tab["per_pe"]["pl3"]["baseline"] - 66.44) < 0.1, "PL3 base")
    check(abs(tab["per_pe"]["dvfs"]["baseline"] - 24.3) < 3.0, "DVFS base")
    emit("paper_chip_8pe", ticks=PAPER_TICKS, launches=counts,
         per_pe_mw={m: tab["per_pe"][m] for m in ("dvfs", "pl3")},
         reduction=red, pl_shares=frac.tolist())
    return counts


def phase_board(dev) -> tuple:
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    graph = synfire_graph(BOARD_PES, noise_model="shot", device=dev)
    t1 = time.perf_counter()
    prog = compile(graph)
    sim = ChipSim(prog, device=dev)
    t2 = time.perf_counter()
    recs = sim.run(BOARD_TICKS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = launch_counts()
    check(sim.use_sparse_noc(), "4096-PE ring must use the sparse NoC")
    check(counts["link_loads_csc"] == BOARD_TICKS,
          f"link_load launched {counts['link_loads_csc']} times")
    for name, n in counts.items():
        check(n > 0, f"board ring: {name} never launched")
    first = first_strong_ticks(recs, 25)
    check(all(abs(f - 10 * p) <= 1 for p, f in enumerate(first)),
          f"board ring wave: first strong ticks {first}")
    tab = chip_power_table(sim, recs)
    del recs
    t4 = time.perf_counter()
    sim.run(BOARD_TICKS)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t4
    emit("board_ring_4096pe", ticks=BOARD_TICKS, n_links=prog.noc.n_links,
         build_s=t1 - t0, compile_s=t2 - t1, run_s=t3 - t2,
         us_per_tick=(t3 - t2) / BOARD_TICKS * 1e6,
         us_per_tick_second_run=steady_s / BOARD_TICKS * 1e6,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts, first_strong_ticks=first,
         per_pe_mw={m: tab["per_pe"][m]["total"] for m in ("dvfs", "pl3")},
         noc_peak_link_load=tab["noc"]["peak_link_load"])
    return sim, prog, counts


def phase_tick_profile(sim) -> dict:
    """Where a steady tick of the 4096-PE ring spends its device time.

    Returns, per hand kernel the tick launches, its launches per tick and
    device ms per launch there; for syn_accum also the mean exc and inh
    spike bits it walked a tick, counted by replaying the profiled ticks
    from a copy of the state (outside the profile: the tick is
    deterministic)."""
    state, step = sim.make_stepper()
    for t in range(PROFILE_WARM):
        state, _ = step(state, t)
    ticks = iter(range(PROFILE_WARM, 10**9))
    saved = {k: v.clone() for k, v in state.items()}

    def one_tick():
        nonlocal state
        state, _ = step(state, next(ticks))
    kernels, wall_us = device_kernels(one_tick, PROFILE_TICKS)
    # device_kernels runs tick PROFILE_WARM unprofiled, then profiles
    state, bits = saved, torch.zeros(2, dtype=torch.int64, device=sim.device)
    for t in range(PROFILE_WARM, PROFILE_WARM + 1 + PROFILE_TICKS):
        if t > PROFILE_WARM:
            for i, buf in enumerate((state["exc_buf"], state["inh_buf"])):
                bits[i] += popcount_words(buf[t % buf.shape[0]]).sum()
        state, _ = step(state, t)
    main = {}
    for name in KERNEL_SYMBOLS:
        n, ms = per_launch_ms(kernels, name)
        if n:
            main[name] = {"launches_per_tick": n / PROFILE_TICKS, "ms": ms}
    main["syn_accum"]["bits"] = (bits.double() / PROFILE_TICKS).tolist()
    busy_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    emit("tick_profile_4096pe", ticks=PROFILE_TICKS, hand_kernels=main,
         profiled_wall_us_per_tick=wall_us / PROFILE_TICKS,
         device_busy_us_per_tick=busy_us / PROFILE_TICKS,
         device_idle_share=1.0 - busy_us / wall_us,
         kernel_launches_per_tick=sum(c for c, _ in kernels.values())
         / PROFILE_TICKS,
         top=[{"kernel": k[:90], "launches_per_tick": c / PROFILE_TICKS,
               "us_per_tick": us / PROFILE_TICKS} for k, (c, us) in top])
    return main


def phase_kernels(dev, sim, prog, main: dict) -> list:
    """Each kernel against its plain version at the main path's shapes;
    ``main`` is what ``phase_tick_profile`` measured inside the tick."""
    net = sim.program.graph.semantics.net.to(dev)
    P, NE, N = net.w_ff.shape
    NI = net.w_inh.shape[1]
    WE, WI = spike_words(NE), spike_words(NI)
    flush = l2_flusher(dev)
    gen = np.random.default_rng(11)
    rows = []

    def syn_bytes(n_e, n_i):
        """Bytes syn_accum must move: the words, the weight rows of the
        set bits, the (P, N) output."""
        return (P * (WE + WI) + n_e * N + n_i * NE + P * N) * 4

    def record(name, source, replaces, call, plain, got, want, nbytes, nops,
               iters, plain_iters, library=None, main_bound_ms=None,
               **extra):
        err = max_abs_err(got, want)
        check(torch.equal(got, want), f"{name}: kernel != plain version")
        b_ms, b_by = bound_ms(nbytes, nops)
        ms = (kernel_device_ms(name, call, flush=flush)
              or cuda_ms(call, iters, flush))
        in_tick = main.get(name, {})
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=err, ms=ms, warm_ms=kernel_device_ms(name, call),
            call_ms=cuda_ms(call, iters),
            plain_ms=cuda_ms(plain, plain_iters, flush),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=(cuda_ms(library, max(plain_iters, 20), flush)
                        if library else None),
            main_path_ms=in_tick.get("ms"),
            main_path_launches_per_tick=in_tick.get("launches_per_tick"),
            main_path_bound_ms=main_bound_ms if in_tick else None,
            **extra))
        emit("kernel_check", **rows[-1])

    # LIF over every neuron of the ring, with the net's parameters
    v = torch.from_numpy(gen.integers(-2 << 15, 2 << 15, (P, N), np.int32))
    rc = torch.from_numpy(gen.integers(-1, 3, (P, N), np.int32))
    i_syn = torch.from_numpy(gen.integers(-1 << 15, 1 << 15, (P, N),
                                          np.int32))
    v, rc, i_syn = v.to(dev), rc.to(dev), i_syn.to(dev)
    lif_bound = bound_ms(6 * 4 * v.numel(), 8 * v.numel())
    record("lif_step", "src/repro_torch/csrc/lif.cu",
           "src/repro/kernels/lif/lif.py:22",
           lambda: lif_step(v, rc, i_syn, **net.lif),
           lambda: lif_step_ref(v, rc, i_syn, **net.lif),
           torch.stack(lif_step(v, rc, i_syn, **net.lif)),
           torch.stack(lif_step_ref(v, rc, i_syn, **net.lif)),
           6 * 4 * v.numel(), 8 * v.numel(), 200, 20,
           main_bound_ms=lif_bound[0], neurons=v.numel())

    # fx_exp on the path's one element (the LIF decay argument), and on a
    # 2**20-element sample spanning +-16 in s16.15
    arg = torch.tensor([int(to_fx(np.float32(-1.0 / 10.0)))],
                       dtype=torch.int32, device=dev)
    x = torch.from_numpy(gen.integers(-16 << 15, 16 << 15, 1 << 20,
                                      np.int32)).to(dev)
    check(torch.equal(fx_exp(arg), fx_exp_ref(arg)), "fx_exp: alpha")
    record("fx_exp", "src/repro_torch/csrc/explog.cu",
           "src/repro/kernels/explog/explog.py:27", lambda: fx_exp(arg),
           lambda: fx_exp_ref(arg), fx_exp(x), fx_exp_ref(x), 8, 60, 500,
           50, elements=1,
           ms_1m=kernel_device_ms("fx_exp", lambda: fx_exp(x), flush=flush),
           warm_ms_1m=kernel_device_ms("fx_exp", lambda: fx_exp(x)),
           plain_ms_1m=cuda_ms(lambda: fx_exp_ref(x), 20, flush),
           bound_ms_1m=bound_ms(8 * x.numel(), 60 * x.numel())[0])

    # link loads over the ring's CSC incidence, packets and flits batched
    src_sorted, link_ptr = prog.noc.device_plan(prog.sinc, dev)
    L = prog.noc.n_links
    w = torch.from_numpy(gen.integers(0, 201, (2, P)).astype(np.float32))
    w = w.to(dev)
    want = link_loads_csc_ref(w, src_sorted, link_ptr, L)
    with warnings.catch_warnings():             # sparse CSR is "beta"
        warnings.simplefilter("ignore")
        inc_t = torch.sparse_csr_tensor(
            link_ptr, src_sorted.long(),
            torch.ones(src_sorted.numel(), device=dev), (L, P),
            check_invariants=True)
    w_t = w.t().contiguous()
    check(torch.equal((inc_t @ w_t).t(), want), "link_load: library call")
    nnz = src_sorted.numel()
    ll_bytes = w.numel() * 4 + nnz * 4 + (L + 1) * 8 + 2 * L * 4
    record("link_loads_csc", "src/repro_torch/csrc/link_load.cu",
           "src/repro/kernels/link_load/link_load.py:34",
           lambda: link_loads_csc(w, src_sorted, link_ptr, n_links=L),
           lambda: link_loads_csc_ref(w, src_sorted, link_ptr, L),
           link_loads_csc(w, src_sorted, link_ptr, n_links=L), want,
           ll_bytes, 2 * nnz, 500, 50, library=lambda: inc_t @ w_t,
           main_bound_ms=bound_ms(ll_bytes, 2 * nnz)[0], nnz=nnz,
           n_links=L)

    # syn_accum on the ring's weights, a wave's worth of arrivals: eight
    # PEs receive about half their exc and inh sources, the rest nothing
    spk_e = torch.zeros(P, NE, dtype=torch.int32)
    spk_i = torch.zeros(P, NI, dtype=torch.int32)
    hot = torch.from_numpy(gen.choice(P, 8, replace=False))
    spk_e[hot] = torch.from_numpy(gen.integers(0, 2, (8, NE), np.int32))
    spk_i[hot] = torch.from_numpy(gen.integers(0, 2, (8, NI), np.int32))
    we, wi = pack_spikes(spk_e, NE).to(dev), pack_spikes(spk_i, NI).to(dev)
    want = syn_accum_ref(we, wi, net.w_ff, net.w_inh)
    n_e, n_i = int(spk_e.sum()), int(spk_i.sum())
    arr = torch.cat([spk_e, spk_i], 1).float().unsqueeze(1).to(dev)
    w_all = torch.cat([net.w_ff.float(), torch.nn.functional.pad(
        net.w_inh.float(), (0, N - NE))], 1)
    check(torch.equal(torch.bmm(arr, w_all).squeeze(1).to(torch.int32),
                      want), "syn_accum: library call")
    tick_e, tick_i = main["syn_accum"]["bits"]
    record("syn_accum", "src/repro_torch/csrc/syn_accum.cu",
           "src/repro/core/snn.py:328 (int32 einsums, no Pallas kernel)",
           lambda: syn_accum(we, wi, net.w_ff, net.w_inh),
           lambda: syn_accum_ref(we, wi, net.w_ff, net.w_inh),
           syn_accum(we, wi, net.w_ff, net.w_inh), want,
           syn_bytes(n_e, n_i), n_e * N + n_i * NE, 500, 3,
           library=lambda: torch.bmm(arr, w_all),
           main_bound_ms=bound_ms(syn_bytes(tick_e, tick_i),
                                  tick_e * N + tick_i * NE)[0],
           set_bits=n_e + n_i, pes=P, main_path_bits_per_tick=tick_e + tick_i)
    del w_all
    return rows


def phase_parity(dev) -> None:
    graph = synfire_graph(PARITY_PES, noise_model="shot", device="cpu")
    prog = compile(graph)
    gpu_sim = ChipSim(prog, device=dev)
    check(gpu_sim.use_sparse_noc(), "256-PE ring must use the sparse NoC")
    got = gpu_sim.run(PARITY_TICKS)
    want = ChipSim(prog, device="cpu").run(PARITY_TICKS)
    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if k.startswith("e_"):
            rel = float(((g.double() - w.double()).abs()
                         / w.double().abs().clamp_min(1e-30)).max())
            check(rel <= 1e-6, f"parity: {k} rel err {rel}")
            worst = max(worst, rel)
        else:
            check(torch.equal(g, w), f"parity: {k} differs card vs CPU")
    first = first_strong_ticks(got, 10)
    check(all(abs(f - 10 * p) <= 1 for p, f in enumerate(first)),
          f"parity ring wave: {first}")
    emit("card_vs_cpu_256pe", ticks=PARITY_TICKS, records=len(want),
         integer_records="bitwise", energy_max_rel_err=worst,
         first_strong_ticks=first)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    counts_a = phase_paper(dev)
    sim, prog, counts_b = phase_board(dev)
    main = phase_tick_profile(sim)
    rows = phase_kernels(dev, sim, prog, main)
    for row in rows:
        row["launches"] = counts_b[row["name"]]
        row["launches_paper_chip"] = counts_a[row["name"]]
    del sim, prog
    torch.cuda.empty_cache()
    phase_parity(dev)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
