#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
drives the port's paths through the entry points a user calls (the
synfire main path ``synfire_graph`` -> ``compile`` -> ``ChipSim.run`` ->
``chip_power_table`` in dense and event mode, the hybrid channel and
farm, the DNN pipeline), and checks what comes out:

1. device   — card name and count, torch/CUDA versions, nvidia-smi, and
              the integer issue rate (SMs x 128 lanes x clocks.max.sm)
              that bounds the integer kernels.
2. build    — nvcc build of every kernel, its wall time and registers,
              and the tensor-core instructions of each kernel's SASS
              (cuobjdump): every instantiation of the bf16 flash kernels
              (D <= 128 and D 256) must hold HGMMA, of the float32 flash
              kernels TF32 HGMMA,
              and of mac_gemm's and mac_conv2d's tensor-core kernels (each
              signedness pairing, and each tile N of mac_conv) IGMMA; and
              the SASS instructions per element of fx_log's and fx_exp's
              loops (``python3 chip_smoke.py --sass LIB`` prints the same
              for another build of the library, and needs no card).
3. paper    — the 8-PE test chip (Gaussian noise, dense NoC), 1200 ticks:
              80-tick wave on every PE and the Table III bands.
4. board    — the 4096-PE ring at the uncut Table II widths (shot noise,
              sparse NoC), exec_mode="dense", 300 ticks: PE p first
              fires > 100 spikes at tick 10 p; the NoC accounting's one
              kernel (noc_link_loads) launched once a tick.
   profile  — the same ring again for its steady tick time, and 20
              ticks under torch.profiler: device busy time per tick, the
              device's idle share, the kernels that take the time, and
              each hand kernel's device time per launch inside the tick;
              the dense tick's NoC accounting alone runs noc_link_loads'
              kernel and no where, floor-divide or cat kernel.
5. event    — the same ring under exec_mode="auto", which resolves to
              event mode: every record equal to the dense run's
              (energies at rtol=1e-6), event_link_loads and the input
              set's compaction (compact_lanes) launched once every tick
              (the dense ring: no compaction), steady µs/tick beside the
              dense one, and a profile of the event tick, in which no sort
              kernel may run; then the 32-PE shot net with src_cap 4 and
              2 (overflow ticks), event == dense bitwise.
6. hybrid   — hybrid_workload at the reference's widths (256 neurons,
              hidden 64, 600 ticks) on the card and on the CPU: integer
              records bitwise, xhat/hidden_out at rtol=1e-5, energies at
              rtol=1e-6, rmse inside the reference's band (< 0.25); its
              steady tick and a profile.
7. farm     — hybrid_farm_graph(n_pairs=2048), 4096 PEs, 256 ticks,
              exec_mode="auto" (event) against "dense": every record
              bitwise, graded payload bits conserved, the dense run's
              NoC accounting one noc_link_loads launch a tick on the
              farm's own plan (its route, fan-in and in-tick time),
              µs/tick of both and a profile of each tick.
   board    — the reference benchmark's 48-chip board (4x12 chips of
              4x2 QPEs, 1536 PEs) through BoardSpec.parse ->
              *_board_graph -> compile_board -> ChipSim.run ->
              chip_power_table: the synfire ring at Table II widths,
              400 ticks, dense on the board's sparse plan and in event
              mode, records equal; the 768-channel farm board in event
              mode, its chip-to-chip shares of flits and NoC energy equal
              to BENCH_pr4.json's row of the same board; each run held
              against the CPU (every kernel's plain version) over a window
              of its ticks with chip-to-chip traffic, from the card's own
              state: records bitwise, energies at rtol=1e-6; per run the
              set-up seconds, µs and launches a tick, a profile, the
              chip-to-chip share of flits and energy; then the 1x1-board
              golden (compile_board == compile, bitwise).
   learn    — on-mesh learning through adaptive_control_workload and
              stdp_pair_workload at the reference learning benchmark's
              widths: the adaptive-control loop (6 channels of 100
              neurons, PES, 2048 ticks) on one chip and on a 2x2 board of
              2x1-QPE chips (refine=False: loops cross chips) converges;
              its convergence tick, final error and learning-energy share
              beside BENCH_pr5.json's row; fx_exp launched twice (the LIF
              alpha, and the trace decay once a run), lif_step once a
              tick, mac_gemm once (the drive's encode, checked against
              mac_gemm_ref at its (2048, 1) x (1, 100) shape); the whole
              run held against the same workload on the CPU (spikes,
              traces, PLs, packets and link loads bitwise, the float32
              sums over the decoders at rtol 1e-5, energies at rtol
              1e-6, the same convergence tick); µs, launches and device
              busy µs a tick beside the frozen twin's (no plasticity).
              The STDP pair (24 x 8, 512 ticks), every record against
              the CPU's.  The loop on the 48-chip board, one channel a
              PE pair (768, one PES group of 768 slots), 256 ticks, its
              drive's encode and a window of ticks against the CPU, its
              tick beside the frozen twin's.
   probes   — the 4096-PE ring (dense) with the default probe set at a
              stride of 64 and keep_records=False: every probe equal,
              bitwise, to the same fold of an unprobed run's records; µs
              and launches a tick with and without probes.
   serve    — the serving tier through FleetEngine.serve at the
              reference serving benchmark's widths (the three rows of
              benchmarks/serve_fleet.py: adaptive and KWS fleets of up to
              64 instances of 1 x 64 neurons, 96 sessions each, and the
              adaptive fleet of 8 on a 2x1 board of 2x2 chips, Poisson
              rate 8, rounds of 64 ticks): each schedule equal to
              BENCH_pr7.json's (completed, rounds, widths, preemptions,
              and ticks served and run on the adaptive row), joules a
              request to its 6 decimals, lif_step once a batched tick and
              mac_gemm once a round (the round's stacked encode); each row
              again keeping its outputs, on the card and on the card
              machine's CPU, every session compared (n_spk and r bitwise,
              the other outputs at rtol 1e-5, energy at 1e-6); a fleet of
              one equal to ChipSim.run bitwise; preemption (rtol 3e-6)
              and suspend to disk and restore in a fresh engine (bitwise)
              at the reference tests' sizes; every NoC and exec mode equal
              to the dense fleet, bitwise; observability on: span chains,
              health, the dev/* counters against the records' host sums, a
              fleet trace, µs a tick beside the bare serve; lif_step and
              the stacked encode against their plain versions at the
              fleet's shapes; the batched tick's launches, device busy µs
              and idle share at widths 16, 32 and 64.
8. dnn      — tiled_dnn_workload on the card and on the CPU: 4 frames
              out, the same latency and records.
9. kernels  — each kernel against its plain PyTorch version, bitwise, on
              the card at its path's shapes (the 4096-PE ring's weights
              and incidence, with flits of 1-4 a packet beside the ring's
              own single flits, and the farm's plan on both routes with a
              dense tick's packets and graded flits; fx_exp at the paths'
              one element and at 2^20, each also on the route its size
              does not take, with the table route's bank conflicts, and
              a fx_exp_routes line of both kernels over n beside the
              uint16 mantissa table, filled per block or multicast
              across a cluster; a tick's input set
              for the compaction, the farm's padded rows, the hybrid
              encode's operands;
              event_link_loads also on its global-memory route,
              compact_lanes also on an overflowing set; mac_gemm also at
              int8 4096^3, the Fig. 15 uint8 (64,128)x(128,64), the
              Fig. 22/23 FC tile 1x4096x512 and uint8 255s at
              64x40000x64, whose sums wrap int32, each a kernel_check
              line nested in its entry of the kernels line).
              ``ms`` is the kernel's own device time per launch
              (torch.profiler) with the L2 cache flushed before every
              launch, as a tick reads its inputs cold (noc_link_loads,
              whose evict_last lines outlive the flush, reads copies of
              its plan and flits that no launch has read); ``warm_ms`` is
              the same back to back, with the inputs left in L2;
              ``call_ms`` is one wrapper call back to back (CUDA events,
              host included); an op that launches a pass besides its
              kernel (the operand pack of mac_gemm and of mac_conv2d's
              tensor-core route) counts both in ``ms`` and the pass alone
              in ``pass_ms``;
              the plain version and one PyTorch library call (where
              there is one) are timed with L2 flushed;
              ``bound_ms`` is the least time the card could take, the
              larger of ``bound_bytes_ms`` and ``bound_ops_ms`` (integer
              kernels at the integer issue rate of phase 1).
              ``main_path_ms`` is the device time per launch in the
              profiled ticks, beside the bound of those ticks' data.
10. parity  — the 256-PE shot-noise ring on the card and on the CPU
              (the default exec_mode, event at this size): integer
              records bitwise, float energies at rtol=1e-6.
11. mac_efficiency — the port's Fig. 14/15 rows
              (``repro_torch.bench.mac_efficiency``): the uint8 (64, 128)
              x (128, 64) product through mac_gemm, bitwise, and every
              modeled TOPS/W within 10 % of the paper's.
12. dnn_layers — the port's Fig. 22/23 rows
              (``repro_torch.bench.dnn_layers``): every layer at its full
              published size, conv rows through mac_conv2d, FC rows
              through mac_gemm, each bitwise against its plain version,
              every speedup inside the band its row prints.
13. elementary — fx_log / fx_log_float over 2^20 values, bitwise
              against fx_log_ref, and the reference's accuracy bands
              (within 3e-4 of ln over [1e-2, 6e4], x <= 0 flagged,
              ln 1 = 0 +- 1).
14. attention — a 4096-token causal prefill at GLM-4-9B's head layout
              (32 heads of 128, bfloat16) through flash_attention_kernel
              against its plain version (atol 4e-3, rtol 2^-7: one bf16
              rounding), and float32 at S = 1024 (atol 2e-5, rtol 1e-4).
15. route_opt — the profile-guided route optimiser
              (``routeopt.optimize_routes``) on the reference board
              benchmark's --route-opt rows (hybrid farm boards of 4x12
              and 2x2 chips of 4x2 QPEs, n_ticks 64, up to 4 iterations;
              the 2x2 row again in event mode on the sparse NoC): each
              row's baseline and optimised peak and mean chip-to-chip
              flits, peak on-chip flits, iterations, convergence and
              improvement equal to BENCH_pr9.json's; the optimised program
              against the fixed-route one: equal check_delivery
              signatures, every record but the NoC's bitwise over a run of
              each on the sparse NoC (noc_link_loads on each routed plan),
              whose per-link peak equals the optimiser's profile; the
              optimise, compile and measure seconds, µs a tick of both.
16. lm_serve — GLM-4-9B at its published widths and depth (40 layers,
              d_model 4096, 32 x 128 heads, KV 2, d_ff 13696, vocab
              151552; 9.40 B parameters drawn on the card from a seed,
              bf16) through ``ServeEngine.run``: stream (a) the reference
              launcher's defaults (12 requests, prompts of 16, 16 new
              tokens, max_seq 64), its schedule equal to the reference
              launcher's; stream (b) 4 prompts of 4096 tokens; the flash
              kernel 40 times a prefill batch; every request its tokens,
              in the vocabulary; incremental decode against the full
              forward: with float32 activations relative max error
              < 1e-4; in bf16, as served, the decode's distance from the
              float32 full forward within 1.5 times the bf16 full
              forward's own and layer 0's cache within 2^-8 of the full
              forward's k and v, a gate that two deliberate faults (a
              query head meeting the wrong KV head, the cache written
              one slot late) must fail in the same run; the reference
              test's relation (< 0.02 at its smoke widths) reported
              beside it; a decode step's
              launches, device busy time and idle share; a float32 twin
              of 2 layers at full width, the card (TF32 off) against the
              card machine's CPU; prefill ms a batch, decode ms a step,
              tokens/s a stream.
17. lm_moe  — OLMoE-1B-7B at its published widths and depth (16 layers,
              d_model 2048, 16 x 128 heads, 64 experts top-8 of d_ff
              1024, vocab 50304; 6.92 B parameters drawn on the card,
              bf16) through the same two streams: the reference
              launcher's schedule, 16 flash launches a prefill batch and
              no other hand kernel; layer 0's MoE input of stream (b) on
              the card and on the card machine's CPU: the routing of all
              16384 tokens (top-k experts, ranks, kept mask, buffer rows)
              equal, a call on its first 256 tokens within 2^-6 of the
              CPU's output; the share of assignments dropped there (C
              2560) and in a decode step at batch 8 (C 2); the decode gate
              of lm_serve with the MoE's dense oracle (as the reference's
              decode test runs MoE), failed by the gate values left
              un-renormalised and by the late cache slot; a decode step's
              profile; the float32 twin of 2 layers, card against CPU,
              with every layer's routing equal.
18. lm_zoo  — Phi-3.5-MoE (4 of 32 layers), Gemma-3-27B (8 of 62: one
              5 local + 1 global group and 2 remainder local layers),
              Nemotron-4-15B (4 of 32), Chameleon-34B (4 of 48) and
              MusicGen-large (all 48, on frames, 4 codebook heads) at
              their published widths, drawn on the card one after another:
              one prefill of 4 x 4096 (flash once a layer; Gemma-3's local
              layers with the window of 1024), 4 decode steps, the decode
              gate failed by the late cache slot; Gemma-3 also the gate
              over a prefill of 1000 and 48 steps across the ring's wrap
              at 1024, failed by the ring slot one late, and its layer 0
              ring after the 4096 prefill (positions 3072..4095 at slots
              pos mod 1024) equal to the full forward's k and v.
19. lm_recurrent — RecurrentGemma-2B (26 layers: 18 RG-LRU, 8 local
              attention of 10 x 256 heads over 1 KV head, window 2048;
              2.89 B parameters) and RWKV-6-1.6B (24 layers, 32 WKV heads
              of 64; 1.60 B) at published widths and full depth, drawn on
              the card from a seed, bf16, the leaves the reference
              initialises to zeros (and lam) redrawn in RWKV's and
              Griffin's own ranges; each through lm_serve's two streams
              (schedules equal to the launcher's), each prefill batch
              launching flash 8 and linear_scan 18 times (RecurrentGemma)
              or wkv6 24 times and flash never (RWKV-6); the cache bytes a
              sequence holds after 16 and 4096 positions (equal for
              RWKV-6, capped by the ring for RecurrentGemma); a decode
              step's profile at batch 8; lm_serve's decode gate, the
              "dense" truth running the recurrent layers through their
              kernels' plain versions, and the cache check on layer 0's
              recurrent state against one prefill of all the positions
              (and RecurrentGemma's first local layer's ring), failed by
              the conv window kept one step late (RG-LRU), by the
              time-mix shift left unadvanced (RWKV-6) and, across the
              ring's wrap at 2048, by the ring slot one late; the float32
              twin (RecurrentGemma's first rglru and local layers;
              RWKV-6's first two), card against CPU.
20. lm_train — training on the card.  Qwen1.5-4B at its published
              widths and full depth (40 layers, d_model 2560, 20 x 128
              heads, d_ff 6912, vocab 151936; 3.95 B float32 parameters
              drawn on the card, their gradients and AdamW's two moments:
              63.2 GB) through ``launch/train.py``'s ``main`` at the
              reference launcher's defaults (batch 8, seq 128, lr 1e-3,
              remat "full", ce_chunk 128), 8 steps, ``--ckpt-every`` past
              the last one; then 2 steps at batch 1 x 4096.  Each shape:
              the loss at every step (all finite; the 8 steps' last three
              below their first three), ms a step and tokens a second
              (host clock ending in a synchronize), the peak memory, flash
              launches a step (40 forward and 40 recomputed under remat,
              3 x 40 backward kernels, no other hand kernel), one more
              step split into forward, backward and optimiser, and one
              under the profiler (device busy ms, idle share, top
              kernels).  The gradient gate at full width, depth 2, batch 1
              x 4096: ``train_loss``'s gradients with the kernels against
              the same call with flash through its plain version on the
              card, bf16 leaf by leaf within 1.5 times the plain bf16
              run's own distance from the plain float32 run (at least
              2^-8 of the leaf's largest magnitude), float32
              within 2^-12 of each leaf's largest magnitude; a backward
              without the delta term and one taking dK from P in place of
              dS must fail it in both dtypes.  OLMoE-1B-7B at full width,
              4 of 16 layers: 4 steps with the load-balance and router
              z-losses in the loss, each MoE layer's routing in the first
              step's forward equal to the CPU's on the same input.  The
              reference's training tests at smoke widths: the loss falling
              over 120 steps (qwen1.5-4b, lr 3e-3: last ten below the
              first ten by 0.15), microbatch 4 against 1 (glm4-9b: loss
              within 5e-3, weights within 5e-4), and the fault-tolerant
              loop's resume (bitwise) and retry in a temp directory.
    The kernel rows of these paths (mac_conv2d at VGG-16 conv3, at
    batch 32 of it, at ResNet-50's 3x3 and MobileNetV2's 1x1 layers,
    fx_log at 2^20 values, flash_attention_kernel at the LM prefill's
    layer-0 input, at the attention phase's batch 1 and at float32
    S = 1024, and lm_zoo's layer 0 inputs: Gemma-3's local layer with
    the window of 1024 (row 8w; its bound counts the band's scores, its
    library call is SDPA with the band as a boolean mask) and MusicGen's
    D = 64 (row 8m), and lm_recurrent's: RecurrentGemma's first local
    layer, D 256 and window 2048, in bf16 and float32 (rows 8r, 8r'),
    and linear_scan and wkv6 on layer 0's arguments in stream b's
    prefill and the decode step after it, wkv6's prefill again with the
    strongest decays; its prefill takes the chunked kernel, its decode
    step the sequential one) are timed as in phase 9; the two
    integer
    kernels are held bitwise, flash at its tolerance (on the LM input,
    element by element: 2^-8 (sum_k p_k |v_k| + |got|) + 2^-7 |want|, the
    kernel's bf16 p and the two outputs' roundings); each second shape
    is a kernel_check line of its own, nested in its kernel's entry of
    the kernels line.  flash_attention_bwd's row (the kernels of a call,
    ``ms`` their sum; bf16 rows on the wgmma route, float32 on mma.sync,
    each row with its route and the kernels the profiler saw launched)
    is held against ``flash_attention_bwd_ref`` at 2^-6
    (bf16) and 2^-14 (float32) of each gradient's largest magnitude, on
    the arguments of the first flash backward (the last layer's) in
    lm_train's 1 x 4096 step (bwd-b) and, nested, GLM-4-9B's 32 over 2
    heads (bwd-g), Gemma-3's window 1024 (bwd-w), MusicGen's D 64
    (bwd-m) and float32 at S 1024 (bwd-f); its bound is the five
    products of the backward at the bf16 rate (float32: CUDA cores, and
    three TF32 products beside), its library time SDPA's backward: one
    SDPA forward and backward less the forward alone (CUDA events).
    Row 8 (batch 1) also gives its ``lse`` case: the forward with the
    log-sum-exp written, its lse against the plain version's, and its
    cold time with and without lse.  mac_conv2d's rows also time the
    kernel that the
    shape's route does not take, and a ``conv_routes`` line times both
    kernels on every Fig. 22/23 conv layer; the flash rows name the
    device kernels of the SDPA call they are compared with.

Launch counters are zeroed just before each path's run (phases 3-8 and
11-20, and each learning path, the probed run, each serving row and
each route_opt row; lm_serve's and lm_moe's two streams are one path
each, lm_zoo's five prefill-and-decode runs are summed into one, as
are lm_recurrent's two archs' streams; the
graph's build is part of the path, except in phase 5, which reuses phase
4's net) and read just after; a kernel of that path that never launched
fails the run.  Every phase prints one JSON line (the serving, routing
and LM phases with their ``phase_s``; a ``script`` line gives the whole
run's seconds); any failed check raises.  The last lines are the card's nvidia-smi name and
power limit,
the kernels line and ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gzip
import io
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.bench import dnn_layers, mac_efficiency  # noqa: E402
from repro_torch.board import BoardSpec, compile_board, partition  # noqa: E402
from repro_torch.chip import ChipSim, chip_power_table, compile  # noqa: E402
from repro_torch.chip.workloads import (  # noqa: E402
    adaptive_control_workload, hybrid_farm_board_graph, hybrid_farm_graph,
    hybrid_workload, stdp_pair_workload, synfire_board_graph, synfire_graph,
    tiled_dnn_workload)
from repro_torch.configs import paper  # noqa: E402
from repro_torch.core import snn  # noqa: E402
from repro_torch.core.dvfs import DVFSController  # noqa: E402
from repro_torch.core.energy import PEEnergyModel  # noqa: E402
from repro_torch.core.quant import quantize_per_axis  # noqa: E402
from repro_torch.kernels import (_build, compact_lanes,  # noqa: E402
                                 event_link_loads, flash_attention_bwd,
                                 flash_attention_kernel,
                                 fx_exp, fx_log, launch_counts, lif_step,
                                 linear_scan, mac_conv2d, mac_gemm,
                                 noc_link_loads, reset_launch_counts,
                                 syn_accum, wkv6)
from repro_torch.kernels.event_gather.ops import (  # noqa: E402
    launch as event_gather_launch)
from repro_torch.kernels.event_gather.ops import (  # noqa: E402
    route as event_gather_route)
from repro_torch.kernels.event_gather.ref import (  # noqa: E402
    compact_lanes_ref, event_link_loads_ref)
from repro_torch.kernels.explog.ops import (  # noqa: E402
    EXP_TABLE_MIN_N, exp_route, exp_table, from_fx, fx_exp_launch,
    fx_exp_mantissa_launch, fx_log_float, to_fx)
from repro_torch.kernels.explog.ref import (FX_ONE, LN2,  # noqa: E402
                                            fx_exp_ref, fx_log_ref)
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, keep_mask)
from repro_torch.kernels.lif.ref import lif_step_ref  # noqa: E402
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    linear_scan_ref)
from repro_torch.kernels.link_load.ref import (  # noqa: E402
    noc_link_loads_ref)
from repro_torch.kernels.mac_conv.ops import launch as conv_launch  # noqa: E402
from repro_torch.kernels.mac_conv.ops import route as conv_route  # noqa: E402
from repro_torch.kernels.mac_conv.ref import mac_conv2d_ref  # noqa: E402
from repro_torch.kernels.mac_gemm.ref import mac_gemm_ref  # noqa: E402
from repro_torch.kernels.syn_accum.ref import (pack_spikes,  # noqa: E402
                                               popcount_words,
                                               spike_words, syn_accum_ref)
from repro_torch.kernels.wkv6.ops import route as wkv6_route  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.core.nef import build_ensemble, encode_drive  # noqa: E402
from repro_torch.core.dvfs import QueueDVFS  # noqa: E402
from repro_torch.learn.adaptive import adaptive_control_graph  # noqa: E402
from repro_torch.learn.engine import group_slots  # noqa: E402
from repro_torch.obs.probes import default_probes  # noqa: E402
from repro_torch.obs.spans import load_spans, validate_spans  # noqa: E402
from repro_torch.obs.trace import write_fleet_trace  # noqa: E402
from repro_torch.serve.fleet import (SCENARIOS, FleetEngine,  # noqa: E402
                                     PoissonTraffic, Session,
                                     adaptive_scenario, stim_windows)
from repro_torch.serve.fleet.engine import broadcast_state  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import rglru as lm_rglru  # noqa: E402
from repro_torch.models import rwkv6 as lm_rwkv  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.routeopt import check_delivery, optimize_routes  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.data.pipeline import (PipelineConfig,  # noqa: E402
                                       SyntheticTokenPipeline)
from repro_torch.ft.loop import FaultTolerantLoop, LoopConfig  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update)
from repro_torch.optim.adamw import named_leaves  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

# H100 SXM published peaks (NVIDIA datasheet): HBM bandwidth, the
# float32 rate outside the tensor cores and the dense int8, bf16 and TF32
# tensor-core rates.  An SM's four schedulers issue one warp instruction
# a cycle each, 128 lanes: integer work is bounded at that issue rate, not
# at the 64-lane INT32 pipe, because its adds, shifts and moves also run
# as IMADs on the FMA pipe beside it.  The rate, SMs x 128 x
# clocks.max.sm, is read from the card in phase 1 (``RATES``)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
INT_ISSUE_LANES_PER_SM = 128
RATES: dict = {}
INT8_TENSOR_OPS_PER_S = 1979e12
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12

PAPER_TICKS, BOARD_PES, BOARD_TICKS = 1200, 4096, 300
PARITY_PES, PARITY_TICKS = 256, 100
PROFILE_WARM, PROFILE_TICKS = 5, 20
HYBRID_TICKS, HYBRID_RMSE_MAX = 600, 0.25   # band of tests/test_nef_hybrid.py
FARM_PAIRS, FARM_TICKS = 2048, 256
# the reference benchmark's headline board (benchmarks/board_scale.py);
# its ring's wave reaches PE 32, the first on the second chip, at tick
# 320, so the ring runs 400 ticks to load the chip-to-chip tier
BOARD_GRID, BOARD_CHIP, BOARD_RING_TICKS = "4x12", "4x2", 400
# the windows (first tick, ticks) each board run is held against the CPU
# in: the ring's spans the wave's first chip-to-chip crossing
BOARD_RING_WINDOW, BOARD_FARM_WINDOW = (305, 30), (100, 16)
# the reference benchmark's row of the same farm board, whose chip-to-chip
# shares of flits and NoC energy the port's must equal to the 4 decimals
# it keeps
BOARD_FARM_BENCH = ("BENCH_pr4.json", "board_hybrid_4x12chips_1536pe")
GOLDEN_PES, GOLDEN_TICKS = 64, 120
# on-mesh learning at the reference learning benchmark's widths
# (benchmarks/learning.py:109): 6 adaptive-control channels of 100
# neurons, 2048 ticks, on one chip and on a 2x2 board of 2x1-QPE chips
# (refine=False: the loops cross chips); its rows in BENCH_pr5.json are
# printed beside the port's convergence tick, final error and learning
# energy share.  Each run is held against the same run on the CPU
LEARN_CHANNELS, LEARN_NEURONS, LEARN_TICKS = 6, 100, 2048
LEARN_BOARD = ("2x2", "2x1")
LEARN_BENCH = "BENCH_pr5.json"
LEARN_SEED = 0
STDP_PRE, STDP_POST, STDP_TICKS = 24, 8, 512
# the adaptive loop on the headline board: one channel a PE pair
LEARN_BIG_CHANNELS, LEARN_BIG_TICKS, LEARN_BIG_WINDOW = 768, 256, (32, 16)
LEARN_STEADY_TICKS = 256        # ticks timed for µs a tick, plastic/frozen
# records of the adaptive loop that are float32 sums over the decoders
ADAPT_FLOAT = ("u", "y", "track_err", "dec_norm")
# the probes phase: the 4096-PE ring with the default probe set
PROBE_TICKS, PROBE_STRIDE = 300, 64
# the serving tier at the reference serving benchmark's widths
# (benchmarks/serve_fleet.py:30-37, 45-56, 104-125; rows of
# BENCH_pr7.json): per row the name, scenario and its widths, top batch
# level, sessions, traffic seed, board (grid, chip) and the schedule the
# traffic's seed fixes
SERVE_TC, SERVE_RATE, SERVE_TICKS = 64, 8.0, (128, 384)
SERVE_BENCH = "BENCH_pr7.json"
SERVE_ROWS = (
    ("serve_fleet_adaptive_chip_w64", "adaptive",
     dict(n_channels=1, n_neurons=64), 64, 96, 0, None,
     dict(completed=96, rounds=18, preemptions=0, ticks_served=26111,
          ticks_run=29248, width_hist={"16": 5, "32": 4, "64": 8})),
    ("serve_fleet_kws_chip_w64", "kws",
     dict(n_pairs=1, n_neurons=64, hidden=16), 64, 96, 1, None,
     dict(completed=96, rounds=18, preemptions=0,
          width_hist={"16": 5, "32": 4, "64": 8})),
    ("serve_fleet_adaptive_board2x1_w8", "adaptive",
     dict(n_channels=1, n_neurons=64), 8, 12, 2, ("2x1", "2x2"),
     dict(completed=12, rounds=11, preemptions=0,
          width_hist={"2": 2, "4": 3, "8": 5})),
)
# outputs held card against CPU bitwise; the others at rtol 1e-5
SERVE_EXACT = ("n_spk", "r")
# the preemption and suspend checks at the reference tests' sizes
# (tests/test_serve_fleet.py): adaptive 1 x 32, rounds of 32 ticks
SERVE_SMALL_TC, SERVE_SMALL_N = 32, 32
SERVE_PROFILE_WIDTHS = (16, 32, 64)
# the profile-guided route optimiser on the reference board benchmark's
# --route-opt rows (benchmarks/board_scale.py:42-46, 105-140): the farm
# board of 4x12 chips of 4x2 QPEs and of 2x2 chips, n_ticks 64, up to 4
# iterations; each row's trajectory as BENCH_pr9.json has it (the
# reference on the CPU gives the same values at this tree): (peak
# chip-to-chip flits, mean chip-to-chip flits, peak on-chip flits) of the
# baseline and of the optimised program, iterations, converged,
# improvement.  The 2x2 row runs twice, the second time in event mode on
# the sparse NoC (event_link_loads)
ROUTE_BENCH = "BENCH_pr9.json"
ROUTE_TICKS, ROUTE_ITERS = 64, 4
ROUTE_ROWS = (("board_hybrid_4x12chips_1536pe_opt", "4x12", {}),
              ("board_hybrid_2x2chips_128pe_opt", "2x2", {}),
              ("board_hybrid_2x2chips_128pe_opt", "2x2",
               {"exec_mode": "event", "noc_mode": "sparse"}))
# the values of a row held to the reference's, and how many decimals
# the row keeps of each
ROUTE_KEYS = {"peak_xlink_flits": 0, "base_peak_xlink_flits": 0,
              "mean_xlink_flits": 4, "base_mean_xlink_flits": 4,
              "peak_onchip_flits": 0, "base_peak_onchip_flits": 0,
              "iters": 0, "converged": 0, "improvement": 4}
# record keys that depend on routing (the NoC's); every other record
# must be bitwise equal under any legal routing
ROUTE_NOC_KEYS = ("link_load", "link_flits", "e_noc", "e_noc_xchip",
                  "load_xchip", "flits_xchip", "touched_links")
# LM serving: GLM-4-9B at its published widths and depth, random weights
# drawn on the card from a seed, bf16.  Stream (a) is the reference
# launcher's defaults (src/repro/launch/serve.py); its schedule is what
# `python -m repro.launch.serve --smoke` prints on the CPU (the schedule
# depends on the queue alone).  Stream (b): 4 prompts of 4096 tokens, the
# attention phase's prefill shape at batch 4
LM_ARCH, LM_SEED = "glm4-9b", 0
LM_STREAMS = (
    ("a", dict(requests=12, prompt_len=16, max_new=16, max_seq=64),
     dict(rounds=2, batch_hist=[8, 4], tokens=180)),
    ("b", dict(requests=4, prompt_len=4096, max_new=16, max_seq=4096 + 16),
     dict(rounds=1, batch_hist=[4], tokens=60)),
)
# decode against the full forward (tests/test_models_decode.py's
# relation): batch, prompt, decode steps, the relative max error that
# test allows at smoke widths, and the float32 activations' limit
LM_DECODE_CHECK, LM_DECODE_REL, LM_DECODE_F32_REL = (2, 16, 8), 0.02, 1e-4
# the served bf16 decode: its logits' relative max distance from the
# float32 full forward (same weights, the reference's dense model
# attention) at most LM_DECODE_BF16_FACTOR times the bf16 full forward's
# own distance from it (measured on the same inputs; on the CPU, on the
# reference's weights at 8 layers of d_model 1024 and 4 of 4096, the
# ratio is 0.94 and 1.05 in the port and 1.00 and 0.98 in the reference,
# and a query head meeting the wrong KV head or the cache written one
# slot late give 2.4-63: tests/test_torch_lm.py), and layer 0's cache
# within one bf16 step (2^-8 of its largest value) of the full forward's
# k and v.  Both faults are run too, and must fail the gate
LM_DECODE_BF16_FACTOR, LM_CACHE0_REL = 1.5, 2.0 ** -8
LM_FAULTS = ("gqa_head_map", "cache_slot")
# the float32 twin: 2 layers at full width, card (TF32 off; float32 flash
# is the 3xTF32 kernel) against the card machine's CPU, prefill logits at
# this relative max error
LM_TWIN_LAYERS, LM_TWIN_SHAPE, LM_TWIN_REL = 2, (2, 16), 1e-4
LM_PROFILE_STEPS = 5
# lm_moe: OLMoE-1B-7B (arXiv:2409.02060) at its published widths and
# depth, served as lm_serve's GLM-4-9B; its decode gate runs the MoE's
# dense oracle (as tests/test_models_decode.py runs MoE), and the faults
# are the gate values left un-renormalised and the late cache slot.
# Layer 0's MoE input of stream b, card against CPU: the routing of all
# 16384 tokens equal; the outputs of a call on its first MOE_CPU_TOKENS
# tokens (C from that T) within MOE_OUT_REL of their largest magnitude:
# the expert MLP's bf16 roundings sit at the same points on both, only
# the products' summation order differs, so one bf16 step (2^-8) of the
# intermediates, through two products, and the output's own rounding
MOE_ARCH, MOE_FAULTS = "olmoe-1b-7b", ("gate_norm", "cache_slot")
MOE_CPU_TOKENS, MOE_OUT_REL = 256, 2.0 ** -6
# lm_train: launch/train.py at the reference launcher's defaults, then
# batch 1 x 4096 (shape: batch, seq, steps)
TRAIN_ARCH, TRAIN_SEED, TRAIN_LR = "qwen1.5-4b", 0, 1e-3
TRAIN_SHAPES = {"b8_s128": (8, 128, 8), "b1_s4096": (1, 4096, 2)}
# the gradient gate: full width, depth cut to 2, batch 1 x 4096; bf16
# leaf by leaf within GATE_BF16 x the plain bf16 run's distance from the
# plain float32 one (the kernel adds the bf16 roundings of P and dS, a
# few of the many that bf16 activations make), and never below
# GATE_BF16_ULP of the leaf's largest magnitude (a weight's gradient
# leaves a bf16 product: one rounding at its own scale); float32 within
# GATE_F32 of the leaf's largest magnitude (3xTF32 products, ~2^-21 each)
GATE_LAYERS, GATE_SEQ, GATE_BF16, GATE_F32 = 2, 4096, 1.5, 2.0 ** -12
GATE_BF16_ULP = 2.0 ** -8
TRAIN_FAULTS = ("no_delta", "dk_from_p")
MOE_TRAIN = ("olmoe-1b-7b", 4, 4)         # arch, layers of 16, steps
# flash_attention_bwd's rows: (B, S, H, H_kv, D), dtype, window; bwd-b is
# lm_train's own layer-0 input.  The limit, of each gradient's largest
# magnitude: bf16 rounds P and dS for their products, float32 is 3xTF32
BWD_ROWS = {"bwd-g": ((1, 4096, 32, 2, 128), torch.bfloat16, 0),
            "bwd-w": ((1, 4096, 32, 16, 128), torch.bfloat16, 1024),
            "bwd-m": ((1, 4096, 32, 32, 64), torch.bfloat16, 0),
            "bwd-f": ((1, 1024, 20, 20, 128), torch.float32, 0)}
BWD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -14}
LSE_TOL = 1e-4                 # natural-log units, |lse - plain|
# lm_zoo: each other attention arch at its published widths, depth cut to
# fit one card beside the rest of the run (layers kept of the published
# count): Phi-3.5-MoE 4 of 32 (41.9 B parameters do not fit whole),
# Gemma-3-27B 8 of 62 (one 5 local + 1 global group and 2 remainder
# local layers, the full model's tail), Nemotron-4-15B 4 of 32,
# Chameleon-34B 4 of 48, MusicGen-large all 48.  One prefill batch of
# ZOO_PREFILL (flash in every layer), ZOO_DECODE_STEPS greedy steps, the
# decode gate with the late cache slot; Gemma-3 also the gate over the
# ring's wrap at 1024 (GEMMA_RING_CHECK: batch, prompt, steps) with the
# ring slot one late, and its ring after the 4096-token prefill
ZOO = (("phi3.5-moe-42b-a6.6b", 4), ("gemma3-27b", 8),
       ("nemotron-4-15b", 4), ("chameleon-34b", 4), ("musicgen-large", 48))
ZOO_PREFILL, ZOO_DECODE_STEPS = (4, 4096), 4
ZOO_FAULTS, GEMMA_RING_CHECK = ("cache_slot",), (1, 1000, 48)
# lm_recurrent: the recurrent pair at published widths and full depth,
# RecurrentGemma-2B (arXiv:2402.19427: 26 layers, 8 x (rglru, rglru,
# local) and 2 remainder rglru layers; d_model 2560, RG-LRU width 2560,
# 10 x 256 heads over 1 KV head, window 2048) and RWKV-6-1.6B
# (arXiv:2404.05892: 24 layers, 32 WKV heads of 64), through lm_serve's
# two streams.  Each prefill batch launches these kernels so many times;
# the decode gate's faults (beside lm_serve's gate, RecurrentGemma's ring
# crossing its wrap at 2048: RG_RING_CHECK, batch, prompt, steps); the
# float32 twin's 2 layers (RecurrentGemma: its first rglru and first
# local layer)
RECURRENT_ARCHS = ("recurrentgemma-2b", "rwkv6-1.6b")
RECURRENT_PREFILL = {
    "recurrentgemma-2b": {"flash_attention_kernel": 8, "linear_scan": 18,
                          "wkv6": 0},
    "rwkv6-1.6b": {"flash_attention_kernel": 0, "linear_scan": 0,
                   "wkv6": 24}}
RECURRENT_FAULTS = {"recurrentgemma-2b": ("conv_shift",),
                    "rwkv6-1.6b": ("token_shift",)}
RG_RING_CHECK = (1, 2040, 16)
RECURRENT_TWIN = {"recurrentgemma-2b": ("rglru", "local")}
# the leaves the reference initialises to zeros (lam: to ones), under
# which a token-shift or conv fault barely moves the output: redrawn on
# the card from the phase's seed, in the ranges RWKV-6 and Griffin use
# (token-shift mixes uniform in [0, 1]; w0 uniform in [-6, 1], per-step
# decays 0.07 to 0.9975; u and the conv taps normal, std 0.5; lam such
# that a = exp(-8 softplus(lam)), the decay at a saturated gate, is
# uniform in [0.9, 0.999], Griffin's own range) or, for the rest, normal
# with std 0.1
RECURRENT_REDRAW = {
    "mu_base": ("uniform", 0.0, 1.0), "mu_wkvrg": ("uniform", 0.0, 1.0),
    "mix_k": ("uniform", 0.0, 1.0), "mix_r": ("uniform", 0.0, 1.0),
    "w0": ("uniform", -6.0, 1.0), "u": ("normal", 0.5),
    "conv_w": ("normal", 0.5), "lam": ("decay", 0.9, 0.999),
    "w2_decay": ("normal", 0.1), "ln_x_scale": ("normal", 0.1),
    "ln_x_bias": ("normal", 0.1), "conv_b": ("normal", 0.1),
    "bi": ("normal", 0.1), "ba": ("normal", 0.1)}
# the recurrent kernels against their plain versions: linear_scan at the
# reference test's atol = rtol = 1e-5 (the same float32 formula, so in
# practice bitwise); wkv6's y at 2^-16 of its largest magnitude, rtol 0
# (sums of D = 64 products in another order), its state on the
# sequential route at atol = rtol = 1e-5 (the same rounded products and
# sums), on the chunked route (prefill) at 2^-16 of its largest
# magnitude too (the chunked algebra sums in another order)
WKV_Y_REL = 2.0 ** -16
# the recurrent tests' strongest decay range: log(-lw) ~ U(-8, 3)
WKV_STRONG_DECAY = (-8.0, 3.0)
# operations an element of linear_scan: two sigmoids (exp, add, divide),
# the decay's multiply and exp, 1 - exp(2 log a) (3), max, sqrt, two
# multiplies for b, the recurrence's multiply and add
SCAN_OPS = 18
GEMM_SAMPLE = 4096              # the int8 GEMM sample: 4096^3
FLOAT_RTOL, FLOAT_ATOL, ENERGY_RTOL = 1e-5, 1e-6, 1e-6
L2_FLUSH_BYTES = 256 << 20      # five times the H100's 50 MB L2
LOG_SAMPLE = 1 << 20            # fx_log's check: 2^20 int32 values
EXP_SAMPLE = 1 << 20            # fx_exp's check: 2^20 int32 values
# fx_exp's operations an element, the table route's arithmetic: clamp
# (2), bias, multiply-high, shift, r (IMAD), exp in float32 (4), the
# lookup and its add (2), the saturating shift (4)
EXP_OPS = 16
CONV_BATCH = 32                 # mac_conv2d's second check: VGG conv3 x 32
# mac_gemm's wrap check: uint8 255s summed over K = 40000 leave int32;
# the reference's int32 matmul keeps the low 32 bits
WRAP_K = 40000
WRAP_VALUE = (WRAP_K * 255 * 255 + 2**31) % 2**32 - 2**31
# attention: GLM-4-9B's head layout (32 query heads of 128, K and V
# expanded to them; the LM rows take the model's own K and V heads)
ATTN_S, ATTN_H, ATTN_D, ATTN_F32_S = 4096, 32, 128, 1024
# bf16: one bf16 rounding of the output (rtol 2^-7 is one ulp) plus a
# small atol, far below the prefill's typical |o| of 0.03; f32: the
# reference's test tolerance
ATTN_TOL = {torch.bfloat16: (4e-3, 2 ** -7), torch.float32: (2e-5, 1e-4)}
# device symbols of each wrapper's kernels (csrc/*.cu), as regular
# expressions on the profiler's kernel names: the kernel each call
# launches once, and the passes a call launches besides it, which count
# in the op's device time (mac_gemm and mac_conv2d's tensor-core route:
# the operand pack of imma.cuh, which transposes B and zeroes a split-K
# output; mac_gemm's K <= 32 and mac_conv2d's Cin % 16 != 0 take a dp4a
# kernel alone)
KERNEL_SYMBOLS = {"lif_step": r"\blif_step_kernel\b",
                  "fx_exp": r"\bfx_exp_(table|ladder)_kernel\b",
                  "noc_link_loads": r"\bnoc_link_loads_kernel\b",
                  "syn_accum": r"\bsyn_accum_kernel\b",
                  "event_link_loads": r"\bevent_link_loads(_smem)?_kernel\b",
                  "compact_lanes": r"\bcompact_lanes_kernel\b",
                  "mac_gemm": r"\bmac_gemm(_dp4a)?_kernel\b",
                  "fx_log": r"\bfx_log_kernel\b",
                  "mac_conv2d": r"\bmac_conv(_igmma)?_kernel\b",
                  "flash_attention_kernel":
                      r"\bflash_attn_(wgmma|tf32)(_d256)?_kernel\b",
                  "linear_scan": r"\blinear_scan_kernel\b",
                  "wkv6": r"\bwkv6(_chunked)?_kernel\b",
                  "flash_attention_bwd":
                      r"\bflash_bwd_(delta|prep|dkdv|dq|reduce)"
                      r"(_wgmma)?_kernel\b"}
PASS_SYMBOLS = {"mac_gemm": r"\bimma_pack_kernel\b",
                "mac_conv2d": r"\bimma_pack_kernel\b"}
# tensor-core SASS: wgmma is HGMMA (bf16, and TF32 as HGMMA.*TF32) /
# IGMMA (int8), mma.sync is HMMA / IMMA; the kernels (symbol in the
# mangled name: instantiations) whose every instantiation must hold the
# instruction named
TENSOR_CORE_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")
TENSOR_CORE_KERNELS = {"flash_attn_wgmma_kernel": (8, "HGMMA"),
                       "flash_attn_wgmma_d256_kernel": (8, "HGMMA"),
                       "flash_attn_tf32_kernel": (4, "HGMMA.TF32"),
                       "flash_attn_tf32_d256_kernel": (4, "HGMMA.TF32"),
                       "mac_gemm_kernel": (4, "IGMMA"),
                       "mac_conv_igmma_kernel": (12, "IGMMA"),
                       "flash_bwd_dkdv_wgmma_kernel": (4, "HGMMA"),
                       "flash_bwd_dq_wgmma_kernel": (2, "HGMMA")}
# kernels whose ptxas notes that serialise wgmma (C7510-C7515: a full
# wait after every wgmma) phase_build reports
WGMMA_NOTE_KERNELS = r"flash_bwd_\w+_wgmma_kernel"
# kernels whose SASS instructions per element phase 2 counts
SASS_LOOP_KERNELS = ("fx_log_kernel", "fx_exp_table_kernel",
                     "fx_exp_ladder_kernel", "fx_exp_mantissa_kernel",
                     "fx_exp_mantissa_multicast_kernel")
# PyTorch kernels of the flit weighting that the tick's NoC accounting
# no longer launches: torch.where, floor division, torch.stack's cat
NOC_HELPER_KERNELS = r"where|div_floor|CatArrayBatchedCopy"


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


def per_launch_ms(kernels: dict, name: str, passes_only: bool = False):
    """(launches, mean device ms per launch) of ``name``'s kernel (a
    wrapper's, or a kernel's own symbol) in a profile from
    ``device_kernels``, the passes a call adds included (or,
    with ``passes_only``, those passes alone); (0, None) when it is not
    there."""
    launches, us, pass_us = 0, 0.0, 0.0
    for key, (n, t) in kernels.items():
        if re.search(KERNEL_SYMBOLS.get(name, rf"\b{name}\b"), key):
            launches, us = launches + n, us + t
        elif name in PASS_SYMBOLS and re.search(PASS_SYMBOLS[name], key):
            pass_us += t
    total = pass_us if passes_only else us + pass_us
    return launches, (total / launches / 1e3 if launches else None)


def kernel_device_ms(name: str, fn, iters: int = 20, flush=None):
    """Mean device time of one launch of ``name``'s kernel (see
    ``per_launch_ms``), with ``flush()`` before each call when given (the
    flush's own kernel is not counted), or None when the profiler
    recorded no such kernel."""
    call = fn if flush is None else (lambda: (flush(), fn()))
    return per_launch_ms(device_kernels(call, iters)[0], name)[1]


def copy_device_ms(x: torch.Tensor, flush, iters: int = 20):
    """Mean device time of ``Tensor.copy_`` of ``x``, L2 flushed before
    each call: the time of the bytes alone (None when the profiler
    recorded no copy)."""
    out = torch.empty_like(x)
    kernels = device_kernels(lambda: (flush(), out.copy_(x)), iters)[0]
    # a same-type copy is a device-to-device memcpy ("Memcpy DtoD")
    us = [t for k, (_, t) in kernels.items()
          if re.search(r"copy|memcpy", k, re.I)]
    return sum(us) / iters / 1e3 if us else None


def bound_parts(n_bytes: float, n_ops: float = 0.0,
                ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple:
    """(ms for the bytes at HBM bandwidth, ms for the operations at the
    rate of their type, default the CUDA-core float32 rate)."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3


def bound_ms(n_bytes: float, n_ops: float = 0.0,
             ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work: the larger of ``bound_parts``, and which
    one it is."""
    t_bytes, t_ops = bound_parts(n_bytes, n_ops, ops_per_s)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compare_records(got: dict, want: dict, what: str, close=()) -> float:
    """Hold two runs' records against each other: energies (``e_*``) at
    rtol=1e-6, the ``close`` float keys at rtol=1e-5 (atol 1e-6), every
    other record bitwise.  Returns the worst energy relative error."""
    check(set(got) == set(want), f"{what}: record keys differ")
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].cpu(), w.cpu()
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: {k} dtype/shape differ")
        if k.startswith("e_"):
            rel = float(((g.double() - w.double()).abs()
                         / w.double().abs().clamp_min(1e-30)).max()) \
                if g.numel() else 0.0
            check(rel <= ENERGY_RTOL, f"{what}: {k} rel err {rel}")
            worst = max(worst, rel)
        elif k in close:
            check(torch.allclose(g, w, rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
                  f"{what}: {k} outside rtol {FLOAT_RTOL}")
        else:
            check(torch.equal(g, w), f"{what}: {k} differs")
    return worst


def check_launched(counts: dict, names, what: str) -> None:
    for name in names:
        check(counts[name] > 0, f"{what}: {name} never launched")


def first_strong_ticks(recs: dict, n_pes: int) -> list:
    """Per PE, the first tick at which more than 100 exc neurons fire."""
    strong = (recs["spikes_exc"][:, :n_pes].sum(2) > 100).cpu().numpy()
    return [int(np.argmax(col)) if col.any() else -1 for col in strong.T]


def kernel_row(rows: list, flush, name, source, replaces, call, plain, got,
               want, nbytes, nops, iters, plain_iters, library=None,
               main_bound_ms=None, in_tick=None,
               ops_per_s=CUDA_CORE_OPS_PER_S, tol=None, prof_iters=20,
               cold_call=None, per_call=1, library_ms=None,
               **extra) -> None:
    """Hold ``name``'s kernel against its plain version (bitwise, or at
    ``tol`` = (atol, rtol): |got - want| <= atol + rtol |want| element by
    element, atol a number or a tensor of want's shape) on
    ``got``/``want``, time it, its plain
    version and ``library`` (one PyTorch call computing the same
    function), and append and print its kernel_check row.  ``cold_call``,
    where given, takes ``call``'s place in the cold timing (``prof_iters``
    + 1 calls): for a kernel whose loads keep lines in L2 past the flush,
    a call on inputs that no launch has read yet.  ``per_call``: kernels
    a call launches (``ms`` and ``warm_ms`` are a call's, their sum);
    ``library_ms``: the library's time measured by the caller, in place
    of timing ``library``."""
    err = max_abs_err(got, want)
    if tol is None:
        check(torch.equal(got, want), f"{name}: kernel != plain version")
    else:
        atol, rtol = tol
        check(bool(((got.float() - want.float()).abs()
                     <= atol + rtol * want.float().abs()).all()),
              f"{name}: kernel != plain version at atol, rtol {tol}: "
              f"max abs err {err}")
        if torch.is_tensor(atol):
            tol = ("per element", rtol)
    b_ms, b_by = bound_ms(nbytes, nops, ops_per_s)
    b_bytes, b_ops = bound_parts(nbytes, nops, ops_per_s)
    cold_fn = cold_call or call
    cold = device_kernels(lambda: (flush(), cold_fn()), prof_iters)[0]
    ms = per_launch_ms(cold, name)[1]
    ms = ms * per_call if ms else cuda_ms(call, iters, flush)
    warm = kernel_device_ms(name, call, prof_iters)
    in_tick = in_tick or {}
    rows.append(dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=err, ms=ms,
        warm_ms=warm * per_call if warm else None,
        call_ms=cuda_ms(call, iters),
        plain_ms=cuda_ms(plain, plain_iters, flush),
        bound_ms=b_ms, bound_by=b_by, bound_bytes_ms=b_bytes,
        bound_ops_ms=b_ops, ops_per_s=ops_per_s,
        library_ms=(library_ms if library_ms is not None else
                    cuda_ms(library, max(plain_iters, 20), flush)
                    if library else None),
        main_path_ms=in_tick.get("ms"),
        main_path_launches_per_tick=in_tick.get("launches_per_tick"),
        main_path_bound_ms=main_bound_ms if in_tick else None,
        **({"tolerance": list(tol)} if tol else {}),
        **({"pass_ms": per_launch_ms(cold, name, passes_only=True)[1]}
           if name in PASS_SYMBOLS else {}), **extra))
    emit("kernel_check", **rows[-1])


# ---------------------------------------------------------------- phases

def nvidia_smi(query: str) -> list:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()


def phase_device() -> str:
    smi = nvidia_smi("name,power.limit")
    clock = nvidia_smi("clocks.max.sm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = re.match(r"\s*([0-9.]+)\s*MHz", clock[0] if clock else "")
    check(mhz is not None, f"nvidia-smi clocks.max.sm: {clock}")
    RATES["int"] = sms * INT_ISSUE_LANES_PER_SM * float(mhz.group(1)) * 1e6
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi, sm_count=sms,
         clocks_max_sm=clock[0], int_ops_per_s=RATES["int"])
    return smi[0] if smi else "nvidia-smi gave no output"


def sass_functions(lib: Path) -> dict:
    """Per kernel function of a built library (mangled name), its SASS
    instructions (``cuobjdump -sass``) as (address, text) pairs, a branch
    to a label given the label's address."""
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    fns, fn, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        label = re.match(r"\s*(\.L\w+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if head:
            fn = fns.setdefault(head.group(1), [])
        elif label:
            pending.append(label.group(1))
        elif ins and fn is not None:
            addr = int(ins.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            fn.append((addr, ins.group(2)))
    return {name: [(a, re.sub(r"`?\((\.L\w+)\)", lambda m: hex(
        labels.get(m.group(1), -1)), t)) for a, t in ins]
        for name, ins in fns.items()}


def opcode(text: str) -> str:
    """The opcode of a SASS instruction, past its predicate."""
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def tensor_core_sass(fns: dict) -> dict:
    """Per kernel function, the count of each tensor-core instruction,
    TF32 wgmma counted apart as HGMMA.TF32."""
    counts = {}
    for name, ins in fns.items():
        c = counts.setdefault(name, {})
        for _, text in ins:
            op = re.match(r"(" + "|".join(TENSOR_CORE_OPS) + r")(\.\S*)?$",
                          opcode(text))
            if op:
                key = op.group(1) + (".TF32" if "TF32" in (op.group(2) or "")
                                     else "")
                c[key] = c.get(key, 0) + 1
    return counts


def loop_cost(ins: list) -> dict:
    """A kernel's SASS instructions, and of its loop (a backward branch)
    that loads the most int32 elements a pass and stores to global memory
    (not a loop that fills shared memory), the instructions a pass per
    element loaded (an LDG's width over 4 bytes)."""
    best = {"instructions": len(ins)}
    for addr, text in ins:
        target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if not target or int(target.group(1), 16) > addr:
            continue
        body = [opcode(t) for a, t in ins
                if int(target.group(1), 16) <= a <= addr]
        body = [op for op in body if op != "NOP"]
        if not any(op.startswith("STG") for op in body):
            continue
        elements = sum(4 if ".128" in op else 2 if ".64" in op else 1
                       for op in body if op.startswith("LDG"))
        if elements > best.get("loop_elements", 0):
            best.update(loop_instructions=len(body), loop_elements=elements,
                        per_element=len(body) / elements)
    return best


def sass_loop_costs(fns: dict) -> dict:
    return {sym: loop_cost(ins) for sym in SASS_LOOP_KERNELS
            for name, ins in fns.items() if sym in name}


def wgmma_notes(log: str) -> dict:
    """{kernel matching WGMMA_NOTE_KERNELS: ptxas's notes (C7510-C7515)
    that serialise its wgmma}; empty where none is left."""
    out = {}
    for line in log.splitlines():
        m = re.search(r"\((C751[0-5])\)[^']*'(\w+)'", line)
        if m and re.search(WGMMA_NOTE_KERNELS, m.group(2)):
            out.setdefault(m.group(2), []).append(
                line.split(m.group(1), 1)[-1].strip(" )"))
    return out


def bwd_call_launches(cfg, dtype) -> int:
    """flash_attention_bwd's launches a call in a layer of ``cfg`` at
    ``dtype`` (``bwd_launches`` on the layer's head shapes)."""
    q = torch.empty(1, 1, cfg.num_heads, cfg.head_dim, dtype=dtype)
    k = torch.empty(1, 1, cfg.num_kv_heads, cfg.head_dim, dtype=dtype)
    return flash_ops.bwd_launches(q, k, k, q, q)


def phase_build() -> dict:
    t0 = time.perf_counter()
    _build.library()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    functions = sass_functions(_build.build())
    sass = tensor_core_sass(functions)
    tc = {fn: ops for fn, ops in sass.items() if ops}
    for symbol, (want, op) in TENSOR_CORE_KERNELS.items():
        fns = [fn for fn in sass if symbol in fn]
        check(len(fns) == want and all(sass[fn].get(op) for fn in fns),
              f"build: {symbol} has {len(fns)} instantiations (want "
              f"{want}, each with {op}), tensor-core instructions "
              f"{[sass[fn] for fn in fns]}")
    loops = sass_loop_costs(functions)
    check(all("per_element" in loops.get(k, {}) for k in SASS_LOOP_KERNELS),
          f"build: no element loop found in {loops}")
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, ptxas=regs,
         tensor_core_sass=tc, sass_per_element=loops,
         wgmma_serialised=wgmma_notes(_build.build_log))
    return loops


def phase_paper(dev) -> dict:
    reset_launch_counts()
    graph = synfire_graph(8, device=dev)
    sim = ChipSim(compile(graph), device=dev)
    recs = sim.run(PAPER_TICKS)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(not sim.use_sparse_noc(), "8-PE chip must use the dense NoC")
    check_launched(counts, ("fx_exp", "syn_accum", "lif_step"), "paper chip")
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
    sim = ChipSim(prog, exec_mode="dense", device=dev)
    t2 = time.perf_counter()
    recs = sim.run(BOARD_TICKS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = launch_counts()
    check(sim.use_sparse_noc(), "4096-PE ring must use the sparse NoC")
    check(counts["noc_link_loads"] == BOARD_TICKS
          and counts["link_loads_csc"] == 0,
          f"board ring NoC launches {counts}")
    check(counts["compact_lanes"] == 0, "the dense ring ran the compaction")
    check_launched(counts, ("fx_exp", "syn_accum", "lif_step",
                            "noc_link_loads"), "board ring")
    first = first_strong_ticks(recs, 25)
    check(all(abs(f - 10 * p) <= 1 for p, f in enumerate(first)),
          f"board ring wave: first strong ticks {first}")
    tab = chip_power_table(sim, recs)
    t4 = time.perf_counter()
    sim.run(BOARD_TICKS)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t4
    emit("board_ring_4096pe", ticks=BOARD_TICKS, n_links=prog.noc.n_links,
         exec_mode="dense",
         build_s=t1 - t0, compile_s=t2 - t1, run_s=t3 - t2,
         us_per_tick=(t3 - t2) / BOARD_TICKS * 1e6,
         us_per_tick_second_run=steady_s / BOARD_TICKS * 1e6,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts, first_strong_ticks=first,
         per_pe_mw={m: tab["per_pe"][m]["total"] for m in ("dvfs", "pl3")},
         noc_peak_link_load=tab["noc"]["peak_link_load"])
    return sim, prog, counts, recs, steady_s / BOARD_TICKS * 1e6


def profile_ticks(sim, exec_mode=None):
    """Profile ``PROFILE_TICKS`` steady ticks of ``sim``'s stepper (in
    ``exec_mode`` where given) after ``PROFILE_WARM`` unprofiled ones.
    Returns (main, summary, saved, step): per hand kernel the tick
    launches, its launches per tick and device ms per launch; the
    window's device busy time, idle share, launches and top kernels; the
    state before the window (for replays: the tick is deterministic) and
    the stepper."""
    state, step = sim.make_stepper(exec_mode=exec_mode)
    for t in range(PROFILE_WARM):
        state, _ = step(state, t)
    ticks = iter(range(PROFILE_WARM, 10**9))
    saved = {k: v.clone() for k, v in state.items()}

    def one_tick():
        nonlocal state
        state, _ = step(state, next(ticks))
    kernels, wall_us = device_kernels(one_tick, PROFILE_TICKS)
    main = {}
    for name in KERNEL_SYMBOLS:
        n, ms = per_launch_ms(kernels, name)
        if n:
            main[name] = {"launches_per_tick": n / PROFILE_TICKS, "ms": ms}
    busy_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    summary = dict(
        ticks=PROFILE_TICKS,
        profiled_wall_us_per_tick=wall_us / PROFILE_TICKS,
        device_busy_us_per_tick=busy_us / PROFILE_TICKS,
        device_idle_share=1.0 - busy_us / wall_us,
        kernel_launches_per_tick=sum(c for c, _ in kernels.values())
        / PROFILE_TICKS,
        sort_launches_per_tick=sum(c for k, (c, _) in kernels.items()
                                   if "sort" in k.lower()) / PROFILE_TICKS,
        top=[{"kernel": k[:90], "launches_per_tick": c / PROFILE_TICKS,
              "us_per_tick": us / PROFILE_TICKS} for k, (c, us) in top])
    return main, summary, saved, step


def noc_accounting_kernels(sim, state) -> dict:
    """The device kernels, name -> launches, of the dense tick's NoC
    accounting alone (``noc_loads`` and ``traffic_energy_j`` on a tick's
    packets with the ring's static packet costs, as ``make_stepper`` wires
    them): one noc_link_loads launch a call and none of
    ``NOC_HELPER_KERNELS``.  The launches are the wrapper's own count;
    the profile shows which kernels ran.  Its counts are reported, not
    checked: the profiler loses a kernel's record now and then (20
    profiled ticks of the board ring, the same ticks each run, counted
    174 launches a tick in one run and 173.9 or 173.95 in others)."""
    prog, noc, dev = sim.program, sim.noc, sim.device
    _, rec = sim.make_stepper()[1]({k: v.clone() for k, v in state.items()},
                                   PROFILE_WARM)
    packets = rec["packets"].to(torch.float32)
    plan = noc.device_plan(prog.sinc, dev)
    flits, bits = noc.packet_costs(torch.as_tensor(prog.payload_bits,
                                                   device=dev))
    tree_links = torch.as_tensor(prog.tree_links, dtype=torch.float32,
                                 device=dev)
    before = launch_counts()["noc_link_loads"]
    kernels, _ = device_kernels(lambda: (
        noc.noc_loads(packets, plan, flits),
        noc.traffic_energy_j(packets, tree_links, bits)), 5)
    # device_kernels makes one call outside the profile, then 5 in it
    launches = launch_counts()["noc_link_loads"] - before
    helpers = [k for k in kernels if re.search(NOC_HELPER_KERNELS, k)]
    check(not helpers and launches == 6
          and per_launch_ms(kernels, "noc_link_loads")[0] > 0,
          f"dense NoC accounting: {launches} noc_link_loads launches in 6 "
          f"calls, {per_launch_ms(kernels, 'noc_link_loads')[0]} in the "
          f"profile of 5; kernels {list(kernels)}")
    return {k[:90]: n / 5 for k, (n, _) in kernels.items()}


# device_kernels runs tick PROFILE_WARM unprofiled, then profiles these
PROFILED = range(PROFILE_WARM + 1, PROFILE_WARM + 1 + PROFILE_TICKS)


def phase_tick_profile(sim, label: str) -> dict:
    """Where a steady tick of the 4096-PE ring spends its device time.

    Returns ``profile_ticks``' per-kernel dict; for syn_accum also the
    mean exc and inh spike bits it walked a tick and, in event mode, the
    mean active sources of event_link_loads, counted by replaying the
    profiled ticks from the saved state, outside the profile."""
    main, summary, state, step = profile_ticks(sim)
    check(not sim.use_event_mode() or summary["sort_launches_per_tick"] == 0,
          f"{label}: the event tick ran sort kernels")
    if not sim.use_event_mode():
        summary["noc_accounting_kernels"] = noc_accounting_kernels(sim, state)
    bits = torch.zeros(2, dtype=torch.int64, device=sim.device)
    active = 0
    for t in range(PROFILE_WARM, PROFILED.stop):
        if t in PROFILED:
            for i, buf in enumerate((state["exc_buf"], state["inh_buf"])):
                bits[i] += popcount_words(buf[t % buf.shape[0]]).sum()
        state, rec = step(state, t)
        if t in PROFILED:
            active += rec["active_sources"]
    main["syn_accum"]["bits"] = (bits.double() / PROFILE_TICKS).tolist()
    if "event_link_loads" in main:
        main["event_link_loads"]["active_sources"] = \
            float(active) / PROFILE_TICKS
    emit(label, hand_kernels=main, **summary)
    return main


def phase_kernels(dev, sim, prog, main: dict, main_event: dict,
                  farm_rows: torch.Tensor, farm_links: int, farm_main: dict,
                  farm_noc: dict, encode_ops: tuple, sass: dict) -> list:
    """Each kernel against its plain version at the main path's shapes;
    ``main``/``main_event`` are what ``phase_tick_profile`` measured
    inside the dense and the event tick of the 4096-PE ring;
    ``farm_rows`` is the 4096-PE farm's padded incidence,
    ``farm_main`` its profiled event ticks, ``farm_noc`` its incidence,
    a dense tick's packets and flits and that tick's noc_link_loads
    profile, ``encode_ops`` the hybrid encode's int8 operands, ``sass``
    phase 2's SASS instructions an element of fx_exp's two kernels."""
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

    def record(name, *args, in_tick=None, **kw):
        kernel_row(rows, flush, name, *args,
                   in_tick=main.get(name, {}) if in_tick is None else in_tick,
                   **kw)

    # LIF over every neuron of the ring, with the net's parameters
    v = torch.from_numpy(gen.integers(-2 << 15, 2 << 15, (P, N), np.int32))
    rc = torch.from_numpy(gen.integers(-1, 3, (P, N), np.int32))
    i_syn = torch.from_numpy(gen.integers(-1 << 15, 1 << 15, (P, N),
                                          np.int32))
    v, rc, i_syn = v.to(dev), rc.to(dev), i_syn.to(dev)
    int_rate = RATES["int"]
    lif_bound = bound_ms(6 * 4 * v.numel(), 8 * v.numel(), int_rate)
    record("lif_step", "src/repro_torch/csrc/lif.cu",
           "src/repro/kernels/lif/lif.py:22",
           lambda: lif_step(v, rc, i_syn, **net.lif),
           lambda: lif_step_ref(v, rc, i_syn, **net.lif),
           torch.stack(lif_step(v, rc, i_syn, **net.lif)),
           torch.stack(lif_step_ref(v, rc, i_syn, **net.lif)),
           6 * 4 * v.numel(), 8 * v.numel(), 200, 20,
           main_bound_ms=lif_bound[0], ops_per_s=int_rate, neurons=v.numel())

    # fx_exp on the path's one element (the LIF decay argument), on the
    # ladder route; other shape: a 2^20-element sample spanning +-16 in
    # s16.15, on the table route.  Each row also times the route its
    # shape does not take; ``fx_exp_routes`` times both over n
    arg = torch.tensor([int(to_fx(np.float32(-1.0 / 10.0)))],
                       dtype=torch.int32, device=dev)
    x = torch.from_numpy(gen.integers(-16 << 15, 16 << 15, EXP_SAMPLE,
                                      np.int32)).to(dev)
    check(torch.equal(fx_exp(arg), fx_exp_ref(arg)), "fx_exp: alpha")

    def exp_row(rows, xx, **extra):
        n, route = xx.numel(), exp_route(xx.numel())
        other = "ladder" if route == "table" else "table"
        out = torch.empty_like(xx)
        kernel_row(rows, flush, "fx_exp", "src/repro_torch/csrc/explog.cu",
                   "src/repro/kernels/explog/explog.py:27", lambda: fx_exp(xx),
                   lambda: fx_exp_ref(xx), fx_exp(xx), fx_exp_ref(xx), 8 * n,
                   EXP_OPS * n, 500 if n == 1 else 200, 50 if n == 1 else 20,
                   ops_per_s=int_rate, elements=n,
                   kernel=f"fx_exp_{route}_kernel",
                   sass_per_element=sass[f"fx_exp_{route}_kernel"][
                       "per_element"],
                   other_kernel=f"fx_exp_{other}_kernel",
                   other_kernel_ms=kernel_device_ms(
                       "fx_exp", lambda: fx_exp_launch(xx, out, other),
                       flush=flush),
                   other_kernel_warm_ms=kernel_device_ms(
                       "fx_exp", lambda: fx_exp_launch(xx, out, other)),
                   other_sass_per_element=sass[f"fx_exp_{other}_kernel"][
                       "per_element"], **extra)
        return rows[-1]
    # shared-memory bank conflicts of the table route's lookups on the
    # sample, counted from its residues: a warp's 32 lanes read one
    # int8 each of a component of their int4s at once
    xs = np.clip(x.cpu().numpy().astype(np.int64), -15 << 15, 15 << 15)
    words = (xs % LN2 >> 2).reshape(-1, 32, 4).transpose(0, 2, 1)
    words = words.reshape(-1, 32)                   # one lookup a row
    banks = words % 32
    ways = np.zeros(len(words), np.int64)
    for b in range(32):
        w = np.sort(np.where(banks == b, words, -1), axis=1)
        ways = np.maximum(ways, ((np.diff(w, axis=1) != 0) & (w[:, 1:] >= 0)
                                 ).sum(1) + (w[:, 0] >= 0))
    table = exp_table(dev)[:LN2]
    big = exp_row([], x, shape_tag="2^20 elements",
                  table_corrections=[int(table.min()), int(table.max())],
                  bank_ways_mean=float(ways.mean()),
                  bank_ways_max=int(ways.max()),
                  copy_ms=copy_device_ms(x, flush),
                  copy_call="Tensor.copy_ of the same 8 MB (no kernel of "
                            "the port: the bytes' own time)")
    exp_row(rows, arg, main_path="LIF decay alpha (once per build)",
            other_shapes=[big])
    # both routes over n, and the uint16 mantissa table they were chosen
    # over (every block fills it, or a cluster shares one multicast load)
    kernels = {
        "fx_exp_ladder_kernel": lambda xx, out: fx_exp_launch(xx, out,
                                                              "ladder"),
        "fx_exp_table_kernel": lambda xx, out: fx_exp_launch(xx, out,
                                                             "table"),
        "fx_exp_mantissa_kernel": lambda xx, out: fx_exp_mantissa_launch(
            xx, out, False),
        "fx_exp_mantissa_multicast_kernel":
            lambda xx, out: fx_exp_mantissa_launch(xx, out, True)}
    routes = []
    for n in (1, 1 << 10, 1 << 14, 1 << 15, 1 << 16, 1 << 18, EXP_SAMPLE):
        xx, out = x[:n].contiguous(), torch.empty(n, dtype=torch.int32,
                                                  device=dev)
        for kernel, launch in kernels.items():
            out.fill_(0)
            launch(xx, out)
            check(torch.equal(out, fx_exp_ref(xx)), f"{kernel} n={n}")
            routes.append(dict(
                n=n, kernel=kernel,
                chosen=kernel == f"fx_exp_{exp_route(n)}_kernel",
                ms=kernel_device_ms(kernel, lambda: launch(xx, out),
                                    flush=flush),
                warm_ms=kernel_device_ms(kernel, lambda: launch(xx, out))))
    emit("fx_exp_routes", table_min_n=EXP_TABLE_MIN_N,
         sass_per_element={k: sass[k]["per_element"] for k in kernels},
         routes=routes)

    # the tick's NoC accounting, noc_link_loads, over a plan of a path:
    # held against its plain version and against the library call, the
    # sparse CSR product of the (n_links, P) incidence with the (P, 2)
    # rows (made beforehand).  Its plan and flits carry an L2 evict_last
    # policy that outlives the flush, so each cold launch reads copies of
    # them that no launch has read before
    def noc_plans(sinc):
        src_sorted, link_ptr = (torch.as_tensor(a, device=dev)
                                for a in sinc.csc)
        return {"padded": (torch.as_tensor(sinc.link_major, device=dev),
                           None),
                "csc": (src_sorted.to(torch.int32),
                        link_ptr.to(torch.int32))}

    def noc_row(rows, sinc, pk, fl, route, in_tick, **extra):
        L, p = sinc.n_links, noc_plans(sinc)[route]
        src_sorted, link_ptr = noc_plans(sinc)["csc"]
        nnz = src_sorted.numel()
        with warnings.catch_warnings():             # sparse CSR is "beta"
            warnings.simplefilter("ignore")
            inc_t = torch.sparse_csr_tensor(
                link_ptr.long(), src_sorted.long(),
                torch.ones(nnz, device=dev), (L, sinc.n_sources),
                check_invariants=True)
        w_t = torch.stack([pk, pk * fl]).t().contiguous()

        def call():
            return noc_link_loads(pk, fl, *p, n_links=L)

        def plain():
            return noc_link_loads_ref(pk, fl, *p, L)
        fresh = iter([(fl.clone(), *(None if t is None else t.clone()
                                     for t in p)) for _ in range(21)])

        def cold_call():
            f, *q = next(fresh)
            return noc_link_loads(pk, f, *q, n_links=L)
        got, want = call(), plain()
        check(torch.equal((inc_t @ w_t).t(), want),
              "noc_link_loads: library call")
        nbytes = 2 * pk.numel() * 4 + sum(
            t.numel() * t.element_size() for t in p if t is not None) \
            + 2 * L * 4
        kernel_row(rows, flush, "noc_link_loads",
                   "src/repro_torch/csrc/link_load.cu",
                   "src/repro/kernels/link_load/link_load.py:34", call,
                   plain, got, want, nbytes, 3 * nnz, 500, 50,
                   library=lambda: inc_t @ w_t, cold_call=cold_call,
                   main_bound_ms=bound_ms(nbytes, 3 * nnz)[0],
                   in_tick=in_tick, plan=route, fan_in=sinc.max_fan_in,
                   nnz=nnz, n_links=L, library_call="sparse CSR (n_links, "
                   "P) @ (P, 2): torch.sparse_csr_tensor mm", **extra)
        return rows[-1]

    # the ring: packets 0-200 a source and flits 1-4 a packet, which
    # differ from the packets, so a swapped or dropped row shows; also the
    # ring's own flits (spike packets: 1 each) and the other route.  The
    # farm's dense tick: a tick's packets and graded flits on its plan,
    # both routes
    noc = prog.noc
    pk = torch.from_numpy(gen.integers(0, 201, (2, P))[0].astype(
        np.float32)).to(dev)
    flits = torch.from_numpy(np.random.default_rng(12).integers(
        1, 5, P).astype(np.float32)).to(dev)
    ring_flits, _ = noc.packet_costs(torch.as_tensor(prog.payload_bits,
                                                     device=dev))
    route = "padded" if noc.device_plan(prog.sinc, dev)[1] is None \
        else "csc"
    other_route = "csc" if route == "padded" else "padded"
    other = [noc_row([], prog.sinc, pk, ring_flits, route, {},
                     shape_tag="the ring's own flits (1 a packet)"),
             noc_row([], prog.sinc, pk, flits, other_route, {},
                     shape_tag=f"the {other_route} route")]
    f_sinc = farm_noc["sinc"]
    f_route = "padded" if farm_noc["noc"].device_plan(f_sinc, dev)[1] \
        is None else "csc"
    for r in (f_route, "csc" if f_route == "padded" else "padded"):
        noc_row(other, f_sinc, farm_noc["packets"], farm_noc["flits"], r,
                farm_noc["in_tick"] if r == f_route else {},
                shape_tag=f"the farm's dense tick, the {r} route"
                + (" (its route)" if r == f_route else ""))
    noc_row(rows, prog.sinc, pk, flits, route,
            main.get("noc_link_loads", {}),
            main_path="4096-PE ring, dense mode", other_shapes=other)

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
           library=lambda: torch.bmm(arr, w_all), ops_per_s=int_rate,
           main_bound_ms=bound_ms(syn_bytes(tick_e, tick_i),
                                  tick_e * N + tick_i * NE, int_rate)[0],
           set_bits=n_e + n_i, pes=P, main_path_bits_per_tick=tick_e + tick_i,
           main_path_ms_event_tick=main_event["syn_accum"]["ms"])
    del w_all

    # the event tick's compaction of its input set at the ring's size: a
    # wave's eight receiving PEs and four kicked ones into 64 lanes; other
    # shape: half the PEs set, which overflows the lanes and the chunks.
    # Library: the compaction in torch, two torch.sort calls (the plain
    # version)
    def compact_row(rows, m, in_tick, **extra):
        geometry = (snn.EVENT_SRC_CAP, snn.EVENT_MAX_CHUNKS)

        def call():
            return compact_lanes(m, *geometry)

        def plain():
            return compact_lanes_ref(m, *geometry)
        got, want = call(), plain()
        nbytes = P + got[0].numel() * 4 + 1 + 4
        kernel_row(
            rows, flush, "compact_lanes",
            "src/repro_torch/csrc/event_gather.cu",
            "src/repro/core/snn.py:348 compact and src/repro/kernels/"
            "event_gather/ops.py:35 active_source_set (jax.lax.sort, no "
            "Pallas kernel)", call, plain,
            torch.cat([t.reshape(-1).to(torch.int32) for t in got]),
            torch.cat([t.reshape(-1).to(torch.int32) for t in want]),
            nbytes, P, 500, 50, library=plain, ops_per_s=int_rate,
            main_bound_ms=bound_ms(nbytes, P, int_rate)[0], in_tick=in_tick,
            library_call="two torch.sort calls (the plain version)",
            pes=P, set_lanes=int(m.sum()), fits=bool(got[1]), **extra)
        return rows[-1]
    m = torch.zeros(P, dtype=torch.bool)
    m[torch.from_numpy(gen.choice(P, 12, replace=False))] = True
    half = torch.from_numpy(gen.random(P) < 0.5).to(dev)
    over = compact_row([], half, {},
                       shape_tag="half the PEs set: overflow")
    check(not over["fits"], "compact_lanes: half the PEs must overflow")
    compact_row(rows, m.to(dev), main_event["compact_lanes"],
                main_path="4096-PE ring, event mode", other_shapes=[over])

    # event-mode link loads over the 4096-PE farm's padded rows, every
    # source (idx None: the kernel walks all of them, as the event tick
    # does), each active: one packet, 1-4 flits (graded payloads).  The
    # other route (global memory) is timed on the same input
    Pf, Lr = farm_rows.shape
    w = torch.stack([torch.ones(Pf), torch.from_numpy(
        gen.integers(1, 5, Pf).astype(np.float32))]).to(dev)
    want = event_link_loads_ref(None, w, farm_rows, farm_links)
    ids = farm_rows.reshape(-1).long()
    w_entry = w[:, :, None].expand(2, Pf, Lr).reshape(2, -1).contiguous()
    acc = torch.zeros(2, farm_links + 1, device=dev)
    check(torch.equal(acc.index_add(1, ids, w_entry)[:, :farm_links], want),
          "event_link_loads: library call")
    valid = int((farm_rows < farm_links).sum())
    route = event_gather_route(2, farm_links)
    other = "global" if route == "smem" else "smem"
    other_out = torch.empty_like(want)
    event_gather_launch(None, w, farm_rows, other_out, other)
    check(torch.equal(other_out, want), f"event_link_loads: {other} route")

    def ev_bytes(active, slots, links):
        """The (2, P) weights, the row of each active source, the (2,
        n_links) output."""
        return 2 * Pf * 4 + active * slots * 4 + 2 * links * 4
    farm_ev = farm_main["event_link_loads"]
    act = farm_ev["active_sources"]
    ring_ev = main_event["event_link_loads"]
    record("event_link_loads", "src/repro_torch/csrc/event_gather.cu",
           "src/repro/kernels/event_gather/event_gather.py:28",
           lambda: event_link_loads(None, w, farm_rows, n_links=farm_links),
           lambda: event_link_loads_ref(None, w, farm_rows, farm_links),
           event_link_loads(None, w, farm_rows, n_links=farm_links), want,
           ev_bytes(Pf, Lr, farm_links), 2 * valid, 500, 50,
           library=lambda: torch.zeros(2, farm_links + 1,
                                       device=dev).index_add_(1, ids,
                                                              w_entry),
           main_bound_ms=bound_ms(ev_bytes(act, Lr, farm_links),
                                  2 * act * Lr)[0],
           in_tick=farm_ev, sources=Pf, tree_slots=Lr, entries=valid,
           n_links=farm_links, main_path="4096-PE hybrid farm, event mode",
           main_path_active_sources=act, kernel=route, other_kernel=other,
           other_kernel_ms=kernel_device_ms(
               "event_link_loads",
               lambda: event_gather_launch(None, w, farm_rows, other_out,
                                           other), flush=flush),
           ring_in_tick_ms=ring_ev["ms"],
           ring_active_sources=ring_ev["active_sources"])

    # the int8 MAC GEMM at the hybrid encode's shape; other shapes: an
    # int8 4096^3 product, the paper's Fig. 15 uint8 (64,128)x(128,64),
    # the Fig. 22/23 FC tile (1x4096x512 int8) and uint8 255s at
    # 64x40000x64, whose sums wrap int32
    def gemm_row(rows, a, b, iters, plain_iters, library=None,
                 library_call=None, prof_iters=20, **extra):
        got, want = mac_gemm(a, b), mac_gemm_ref(a, b)
        if library is not None:
            check(torch.equal(library(), want), "mac_gemm: library call")
        (m, k), n = a.shape, b.shape[1]
        kernel_row(
            rows, flush, "mac_gemm", "src/repro_torch/csrc/mac_gemm.cu",
            "src/repro/kernels/mac_gemm/mac_gemm.py:30",
            lambda: mac_gemm(a, b), lambda: mac_gemm_ref(a, b), got, want,
            m * k + k * n + m * n * 4, 2 * m * n * k, iters, plain_iters,
            library=library, ops_per_s=INT8_TENSOR_OPS_PER_S, in_tick={},
            prof_iters=prof_iters, shape=[m, k, n],
            dtypes=[str(t.dtype).removeprefix("torch.") for t in (a, b)],
            library_call=library_call, **extra)
        return rows[-1]

    def operand(shape, dtype):
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        return torch.from_numpy(gen.integers(lo, hi, shape, np.int64)).to(
            dtype).to(dev)
    G = GEMM_SAMPLE
    big_a, big_b = operand((G, G), torch.int8), operand((G, G), torch.int8)
    big_b_cm = big_b.t().contiguous().t()   # column-major: cuBLASLt's "TN"
    other = [gemm_row(
        [], big_a, big_b, 10, 3, library=lambda: torch._int_mm(big_a,
                                                               big_b_cm),
        library_call="torch._int_mm, B transposed to column-major "
                     "beforehand (not timed)", prof_iters=5,
        shape_tag=f"int8 {G}^3")]
    other.append(gemm_row(
        [], operand((64, 128), torch.uint8), operand((128, 64), torch.uint8),
        500, 50, library_call="none: torch._int_mm takes int8 only",
        shape_tag="Fig. 15 uint8"))
    fc = next(g for n, _, g in dnn_layers.LAYERS if n == "vgg16_fc_tile")
    fc_a, fc_b = (torch.from_numpy(t).to(dev)
                  for t in dnn_layers.layer_operands("mm", fc, False))
    fc_b_cm = fc_b.t().contiguous().t()
    try:
        torch._int_mm(fc_a, fc_b_cm)
        fc_lib = {"library": lambda: torch._int_mm(fc_a, fc_b_cm),
                  "library_call": "torch._int_mm, B column-major"}
    except RuntimeError as err:
        fc_lib = {"library_call": f"none: torch._int_mm refuses M = 1 "
                                  f"({str(err).splitlines()[0][:120]})"}
    other.append(gemm_row([], fc_a, fc_b, 200, 20,
                          shape_tag="Fig. 22/23 vgg16_fc_tile", **fc_lib))
    wrap_a = torch.full((64, WRAP_K), 255, dtype=torch.uint8, device=dev)
    wrap_b = torch.full((WRAP_K, 64), 255, dtype=torch.uint8, device=dev)
    wrap = gemm_row([], wrap_a, wrap_b, 50, 5,
                    library_call="none: torch._int_mm takes int8 only",
                    shape_tag="uint8 255s, int32 wrap")
    check(torch.equal(mac_gemm(wrap_a, wrap_b), torch.full(
        (64, 64), WRAP_VALUE, dtype=torch.int32, device=dev)),
          "mac_gemm: the 255s product is not the wrapped int32 sum")
    other.append(wrap)
    xq, enc_q = encode_ops
    gemm_row(rows, xq, enc_q, 500, 50,
             library_call="none: torch._int_mm needs K % 8 = 0",
             main_path="hybrid encode (once per build)", other_shapes=other)
    return rows


def phase_event_ring(dev, prog, dense_recs: dict, dense_us: float):
    """The 4096-PE ring of phase 4 under the default exec_mode ("auto",
    which must resolve to event mode) against phase 4's dense run."""
    sim = ChipSim(prog, device=dev)
    check(sim.use_event_mode(), "4096-PE ring: auto must pick event mode")
    reset_launch_counts()
    t0 = time.perf_counter()
    recs = sim.run(BOARD_TICKS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["event_link_loads"] == counts["compact_lanes"]
          == BOARD_TICKS, f"event ring launches {counts}")
    check(counts["syn_accum"] == counts["lif_step"] == BOARD_TICKS,
          f"event ring launches {counts}")
    check(counts["noc_link_loads"] == counts["link_loads_csc"] == 0,
          "event ring ran the dense NoC kernel")
    worst = compare_records(recs, dense_recs, "event vs dense ring")
    del recs
    t1 = time.perf_counter()
    sim.run(BOARD_TICKS)
    torch.cuda.synchronize()
    steady_us = (time.perf_counter() - t1) / BOARD_TICKS * 1e6

    # overflow: the 32-PE shot net whose input set outgrows a tiny buffer
    fields = dict(n_pes=32, n_exc=16, n_inh=4, fan_in_exc=8, fan_in_inh=4,
                  neurons_per_core=20, synapses_per_core=400, l_th1=2,
                  l_th2=7)
    sp = dataclasses.replace(paper.SYNFIRE, **fields)
    net = snn.build_synfire(sp=sp, w_exc=0.25, noise_sigma=0.0,
                            noise_model="shot", kicks_per_tick=3, device=dev)

    def run(**ev):
        tick = snn.make_synfire_tick(
            net, dvfs=DVFSController(sp.l_th1, sp.l_th2),
            em=PEEnergyModel(), seed=1, **ev)
        return snn.run_ticks(tick, snn.synfire_init_state(net), 48)
    dense = run()
    for cap in (4, 2):
        got = run(event=True, src_cap=cap)
        for k in dense:
            check(torch.equal(got[k], dense[k]),
                  f"32-PE src_cap={cap}: {k} event != dense")
    emit("event_ring_4096pe", ticks=BOARD_TICKS, exec_mode="event",
         launches=counts, records_vs_dense="bitwise",
         energy_max_rel_err=worst, run_s=run_s,
         us_per_tick=run_s / BOARD_TICKS * 1e6,
         us_per_tick_second_run=steady_us,
         dense_us_per_tick_second_run=dense_us,
         overflow_net_32pe="src_cap 4 and 2: event == dense bitwise")
    return sim, counts


def phase_hybrid(dev):
    """The hybrid NEF -> event-MAC pipeline at the reference's widths."""
    reset_launch_counts()
    t0 = time.perf_counter()
    got = hybrid_workload(n_ticks=HYBRID_TICKS, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check_launched(counts, ("fx_exp", "mac_gemm", "lif_step"), "hybrid")
    check(counts["lif_step"] == HYBRID_TICKS, f"hybrid launches {counts}")
    want = hybrid_workload(n_ticks=HYBRID_TICKS, device="cpu")
    worst = compare_records(got["recs"], want["recs"], "hybrid card vs CPU",
                            close=("xhat", "hidden_out"))
    check(got["rmse"] < HYBRID_RMSE_MAX, f"hybrid rmse {got['rmse']}")
    out, inn = got["graded_bits_out"], got["graded_bits_in"]
    check(out.sum() > 0 and np.array_equal(out[:-1], inn[1:]),
          "hybrid: graded payload not conserved")
    t1 = time.perf_counter()
    got["sim"].run(HYBRID_TICKS)
    torch.cuda.synchronize()
    steady_us = (time.perf_counter() - t1) / HYBRID_TICKS * 1e6
    main, summary, _, _ = profile_ticks(got["sim"])
    ens = got["sim"].program.graph.semantics.ens
    x = got["x"]
    xq, _ = quantize_per_axis(torch.as_tensor(x.astype(np.float32),
                                              device=dev), axis=1)
    emit("hybrid", ticks=HYBRID_TICKS, neurons=ens.n_neurons,
         hidden=int(got["sim"].program.graph.semantics.wq.shape[1]),
         launches=counts, rmse=got["rmse"], rmse_cpu=want["rmse"],
         total_spikes=got["total_spikes"], records_vs_cpu="bitwise",
         energy_max_rel_err=worst, build_run_report_s=run_s,
         us_per_tick_second_run=steady_us,
         event_vs_frame=got["event_vs_frame"], synops=got["synops"],
         profile=dict(hand_kernels=main, **summary))
    return counts, (xq, ens.enc_q)


def phase_farm(dev):
    """The board-scale hybrid farm: 2048 channels on 4096 PEs, event
    mode (auto) against dense."""
    reset_launch_counts()
    t0 = time.perf_counter()
    graph = hybrid_farm_graph(FARM_PAIRS, device=dev)
    prog = compile(graph)
    sim = ChipSim(prog, device=dev)
    t1 = time.perf_counter()
    check(sim.use_event_mode(), "farm: auto must pick event mode")
    recs = sim.run(FARM_TICKS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launch_counts()
    check_launched(counts, ("fx_exp", "mac_gemm", "lif_step",
                            "event_link_loads"), "farm")
    check(counts["event_link_loads"] == FARM_TICKS, f"farm {counts}")
    reset_launch_counts()
    t3 = time.perf_counter()
    dense = sim.run(FARM_TICKS, exec_mode="dense")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    dense_counts = launch_counts()
    check(sim.use_sparse_noc()
          and dense_counts["noc_link_loads"] == FARM_TICKS
          and dense_counts["event_link_loads"] == 0,
          f"farm dense NoC launches {dense_counts}")
    compare_records(recs, dense, "farm event vs dense",
                    close=("hidden_out",))
    bits_out = recs["graded_bits_out"].sum(1)
    check(bits_out.sum() > 0
          and torch.equal(bits_out[:-1], recs["graded_bits_in"].sum(1)[1:]),
          "farm: graded payload not conserved")
    check(float(recs["link_flits"].sum()) > float(recs["link_load"].sum())
          > 0, "farm: no multi-flit traffic")
    t5 = time.perf_counter()
    sim.run(FARM_TICKS)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t5) / FARM_TICKS * 1e6
    rows = prog.sinc.padded_rows

    main, summary, _, _ = profile_ticks(sim)
    main["event_link_loads"]["active_sources"] = float(
        recs["active_sources"][PROFILED.start:PROFILED.stop].double().mean())
    # the dense tick's NoC accounting on the farm's own plan: its route,
    # its fan-in, noc_link_loads' time in the tick, and one profiled
    # tick's packets and (graded) flits for the kernel rows
    dense_main, dense_summary, _, _ = profile_ticks(sim, "dense")
    plan = prog.noc.device_plan(prog.sinc, dev)
    t = PROFILED.start
    noc_in = dict(
        sinc=prog.sinc, noc=prog.noc, in_tick=dense_main["noc_link_loads"],
        packets=dense["packets"][t].to(torch.float32).contiguous(),
        flits=prog.noc.packet_costs(dense["payload_bits"][t])[0])
    check(bool((noc_in["flits"] > 1).any()), "farm: no multi-flit packet")
    dense_noc = dict(route="padded" if plan[1] is None else "csc",
                     max_fan_in=prog.sinc.max_fan_in, nnz=prog.sinc.nnz,
                     noc_link_loads=dense_main["noc_link_loads"])
    emit("hybrid_farm_4096pe", pairs=FARM_PAIRS, pes=prog.n_pes,
         n_links=prog.noc.n_links, tree_slots=rows.shape[1],
         ticks=FARM_TICKS, launches=counts, records_vs_dense="bitwise",
         build_compile_s=t1 - t0, us_per_tick=(t2 - t1) / FARM_TICKS * 1e6,
         us_per_tick_second_run=steady,
         dense_us_per_tick=(t4 - t3) / FARM_TICKS * 1e6,
         dense_launches=dense_counts, dense_noc=dense_noc,
         dense_profile=dict(hand_kernels=dense_main, **dense_summary),
         payload_bits=float(recs["payload_bits"].sum()),
         active_sources_mean=float(recs["active_sources"].double().mean()),
         profile=dict(hand_kernels=main, **summary))
    return (counts, torch.as_tensor(rows, device=dev), prog.noc.n_links,
            main, noc_in)


def board_run(sim, what: str, exec_mode: str, ticks: int) -> tuple:
    """Run ``sim`` (its NoC mode) for ``ticks`` in ``exec_mode`` twice
    (the second for the steady time) and profile its tick: (records,
    fields)."""
    t0 = time.perf_counter()
    recs = sim.run(ticks, exec_mode=exec_mode)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    sim.run(ticks, exec_mode=exec_mode)
    torch.cuda.synchronize()
    steady_us = (time.perf_counter() - t1) / ticks * 1e6
    main, summary, _, _ = profile_ticks(sim, exec_mode)
    check(exec_mode != "event" or summary["sort_launches_per_tick"] == 0,
          f"{what}: the event tick ran sort kernels")
    x_flits = float(recs["flits_xchip"].sum())
    tot = float(recs["link_flits"].sum())
    return recs, dict(
        exec_mode=exec_mode, ticks=ticks, run_s=run_s,
        us_per_tick=run_s / ticks * 1e6, us_per_tick_second_run=steady_us,
        launches_per_tick=summary["kernel_launches_per_tick"],
        device_busy_us_per_tick=summary["device_busy_us_per_tick"],
        device_idle_share=summary["device_idle_share"],
        hand_kernels=main, flits_total=tot, xchip_frac=x_flits / tot,
        energy_noc_j=float(recs["e_noc"].sum()),
        energy_xchip_j=float(recs["e_noc_xchip"].sum()))


def window_vs_cpu(sim, recs: dict, what: str, exec_mode: str, start: int,
                  ticks: int, close=()) -> dict:
    """Hold ticks [start, start + ticks) of ``recs``, a card run of
    ``sim`` in ``exec_mode``, against the same ticks stepped on the CPU,
    where every wrapper runs its plain version, from the card's own state
    at tick ``start``: the board's kernels at its own shapes and plan
    against their plain versions.  Records as ``compare_records``;
    returns the window's fields."""
    state, step = sim.make_stepper(exec_mode=exec_mode)
    for t in range(start):
        state, _ = step(state, t)
    cpu = ChipSim(sim.program, noc_mode=sim.noc_mode, device="cpu")
    t0 = time.perf_counter()
    want = cpu.run(ticks, exec_mode=exec_mode, start=start,
                   state={k: v.cpu() for k, v in state.items()})
    cpu_s = time.perf_counter() - t0
    got = {k: v[start:start + ticks] for k, v in recs.items()}
    worst = compare_records(got, want, f"{what} card vs CPU", close=close)
    return dict(ticks=[start, start + ticks],
                records="bitwise" + (f"; {len(close)} float keys at rtol "
                                     f"{FLOAT_RTOL}" if close else ""),
                energy_max_rel_err=worst, cpu_s=cpu_s,
                flits_xchip=float(want["flits_xchip"].sum())
                if "flits_xchip" in want else 0.0)


def board_plan(sim) -> dict:
    """The board program's sparse plan: route, fan-in, links."""
    prog = sim.program
    return dict(route="padded" if prog.noc.device_plan(
        prog.sinc, sim.device)[1] is None else "csc",
        max_fan_in=prog.sinc.max_fan_in, nnz=prog.sinc.nnz,
        n_links=prog.noc.n_links, n_xchip_links=prog.noc.n_xchip_links,
        cut_flits=prog.part.cut_flits,
        chips_used=int((prog.part.chips_of_graph() > 0).sum()),
        worst_path_latency_s=prog.worst_path_latency_s)


def phase_multichip_board(dev) -> dict:
    """The reference benchmark's headline board, 4x12 chips of 4x2 QPEs
    (48 chips, 1536 PEs), through BoardSpec.parse -> *_board_graph ->
    compile_board -> ChipSim.run -> chip_power_table: the synfire ring at
    Table II widths (shot noise, 400 ticks: the wave enters the second
    chip at tick 320), dense on the sparse NoC (noc_link_loads
    on the board's plan) and in event mode (compact_lanes,
    event_link_loads), event == dense bitwise; the hybrid farm board
    (768 channels of 32 neurons -> 16) in event mode, its chip-to-chip
    split equal to the reference benchmark's row.  Each run is held
    against the CPU's plain versions over a window of its ticks with
    chip-to-chip traffic (``window_vs_cpu``).  Then the 1x1-board golden
    at a small size: compile_board == compile, bitwise."""
    board = BoardSpec.parse(BOARD_GRID, chip=BOARD_CHIP)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    graph = synfire_board_graph(board, noise_model="shot", device=dev)
    t1 = time.perf_counter()
    part = partition(graph, board)
    t2 = time.perf_counter()
    prog = compile_board(graph, board, part=part)
    sim = ChipSim(prog, device=dev)
    t3 = time.perf_counter()
    check(prog.n_pes == board.n_pes, f"board PEs {prog.n_pes}")
    check(sim.use_sparse_noc() and sim.use_event_mode(),
          "the board ring must use the sparse NoC and event mode")
    before = launch_counts()
    dense, dense_f = board_run(sim, "board ring", "dense", BOARD_RING_TICKS)
    mid = launch_counts()
    check(mid["noc_link_loads"] - before["noc_link_loads"]
          >= BOARD_RING_TICKS
          and mid["compact_lanes"] == before["compact_lanes"],
          f"board ring dense launches {mid}")
    event, event_f = board_run(sim, "board ring", "event", BOARD_RING_TICKS)
    after = launch_counts()
    check(after["compact_lanes"] - mid["compact_lanes"] >= BOARD_RING_TICKS
          and after["event_link_loads"] - mid["event_link_loads"]
          >= BOARD_RING_TICKS, f"board ring event launches {after}")
    worst = compare_records(event, dense, "board ring event vs dense")
    windows = {mode: window_vs_cpu(sim, recs, f"board ring {mode}", mode,
                                   *BOARD_RING_WINDOW)
               for mode, recs in (("dense", dense), ("event", event))}
    check(windows["dense"]["flits_xchip"] > 0,
          "board ring: no chip-to-chip traffic in the CPU window")
    first = first_strong_ticks(dense, 36)
    check(all(abs(f - 10 * p) <= 1 for p, f in enumerate(first)),
          f"board ring wave: first strong ticks {first}")
    check(float(dense["flits_xchip"].sum()) > 0,
          "board ring: the wave never crossed a chip")
    tab = chip_power_table(sim, dense)
    check(tab["board"] == (board.chips_x, board.chips_y)
          and "xchip" in tab["noc"],
          "board power table")
    ring = dict(build_s=t1 - t0, partition_s=t2 - t1,
                compile_s=t3 - t2, plan=board_plan(sim), dense=dense_f,
                event=event_f, records_event_vs_dense="bitwise",
                card_vs_cpu=windows,
                energy_max_rel_err=worst, first_strong_ticks=first,
                noc_xchip=tab["noc"]["xchip"],
                worst_hop_latency_s=tab["noc"]["worst_hop_latency_s"])
    del dense, event, sim, prog, graph

    t0 = time.perf_counter()
    fgraph = hybrid_farm_board_graph(board, device=dev)
    t1 = time.perf_counter()
    fpart = partition(fgraph, board)
    t2 = time.perf_counter()
    fprog = compile_board(fgraph, board, part=fpart)
    # the channels' chip-to-chip links carry more sources than the
    # reference's auto-select allows the sparse NoC (MAX_SPARSE_COLS), so
    # "auto" is dense there; event mode and its accounting are asked for
    fsim = ChipSim(fprog, noc_mode="sparse", device=dev)
    t3 = time.perf_counter()
    frecs, farm_f = board_run(fsim, "farm board", "event", FARM_TICKS)
    bits_out = frecs["graded_bits_out"].sum(1)
    check(bits_out.sum() > 0 and torch.equal(
        bits_out[:-1], frecs["graded_bits_in"].sum(1)[1:]),
        "farm board: graded payload not conserved")
    fwindow = window_vs_cpu(fsim, frecs, "farm board", "event",
                            *BOARD_FARM_WINDOW, close=("hidden_out",))
    check(fwindow["flits_xchip"] > 0,
          "farm board: no chip-to-chip traffic in the CPU window")
    bench, row = BOARD_FARM_BENCH
    ref = next(r["values"] for r in json.loads(
        (ROOT / bench).read_text())["rows"] if r["name"] == row)
    split = {"xchip_flit_frac": farm_f["xchip_frac"],
             "xchip_energy_frac": farm_f["energy_xchip_j"]
             / farm_f["energy_noc_j"]}
    check(all(abs(v - ref[k]) <= 5e-5 for k, v in split.items()),
          f"farm board: chip-to-chip split {split} != {bench} {row} "
          f"{ {k: ref[k] for k in split} }")
    ftab = chip_power_table(fsim, frecs)
    farm = dict(pairs=len(fgraph.populations) // 2, build_s=t1 - t0,
                partition_s=t2 - t1, compile_s=t3 - t2,
                auto_exec_mode="event" if ChipSim(
                    fprog, device=dev).use_event_mode() else "dense",
                plan=board_plan(fsim), event=farm_f, card_vs_cpu=fwindow,
                xchip_split_vs_reference=f"{bench} {row}: equal",
                noc_xchip=ftab["noc"]["xchip"])
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launched(counts, ("fx_exp", "syn_accum", "lif_step",
                            "noc_link_loads", "compact_lanes",
                            "event_link_loads", "mac_gemm"),
                   "multichip board")
    max_mem = torch.cuda.max_memory_allocated()
    del frecs, fsim, fprog, fgraph

    # the 1x1-board golden at a small size: the same records bit for bit
    small = synfire_graph(GOLDEN_PES, noise_model="shot", device=dev)
    single = compile(small)
    one = compile_board(small, BoardSpec(1, 1, chip=single.mesh))
    for k in ("link_ids", "source_ptr", "tree_hops"):
        check(np.array_equal(getattr(single.sinc, k), getattr(one.sinc, k)),
              f"1x1 board: sinc.{k} differs")
    for mode in ("dense", "event"):
        a = ChipSim(single, device=dev).run(GOLDEN_TICKS, exec_mode=mode,
                                            noc_mode="sparse")
        b = ChipSim(one, device=dev).run(GOLDEN_TICKS, exec_mode=mode,
                                         noc_mode="sparse")
        check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a),
              f"1x1 board != single chip ({mode})")
    emit("multichip_board", board=f"{BOARD_GRID} chips of {BOARD_CHIP} QPEs",
         chips=board.n_chips, pes=board.n_pes, launches=counts,
         max_memory_allocated=max_mem, synfire_ring=ring, hybrid_farm=farm,
         golden_1x1=f"{GOLDEN_PES}-PE ring, {GOLDEN_TICKS} ticks, dense "
                    f"and event: compile_board == compile, bitwise")
    return counts


def steady_us(sim, ticks: int, **run_kw) -> float:
    """µs a tick of a second run of ``sim`` (the first warms it)."""
    sim.run(ticks, **run_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(ticks, **run_kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ticks * 1e6


def tick_cost(sim) -> dict:
    """A steady tick of ``sim``: µs a tick and, from a profile, launches
    a tick, device busy µs a tick and the device's idle share."""
    _, summary, _, _ = profile_ticks(sim)
    return dict(us_per_tick=steady_us(sim, LEARN_STEADY_TICKS),
                **{k: summary[k] for k in (
                    "kernel_launches_per_tick", "device_busy_us_per_tick",
                    "device_idle_share")})


def learn_close(recs: dict) -> tuple:
    """The adaptive loop's float32 sums over the decoders, and every
    slot's dw and arrived error, held at rtol 1e-5 against the CPU."""
    return ADAPT_FLOAT + tuple(k for k in recs
                               if k.endswith(("/dw", "/err")))


def bench_row(name: str) -> dict:
    return next(r["values"] for r in json.loads(
        (ROOT / LEARN_BENCH).read_text())["rows"] if r["name"] == name)


def frozen_twin(dev, board, channels: int, ticks: int):
    """The adaptive loop without plasticity (fixed decoders), compiled
    as the plastic one."""
    graph = adaptive_control_graph(channels, LEARN_NEURONS, n_ticks=ticks,
                                   plastic=False, device=dev)
    prog = (compile(graph) if board is None
            else compile_board(graph, board, refine=False))
    return ChipSim(prog, device=dev)


def drive_vs_cpu(sim, what: str) -> dict:
    """The adaptive loop's reference drive, encoded at the graph's build
    by mac_gemm at the path's (T, 1) x (1, N) shape, against the plain
    versions: the kernel's int32 sums against ``mac_gemm_ref`` on the
    same operands, and the whole drive table against an independent CPU
    build of the ensemble (every wrapper's plain version), bitwise."""
    sem = sim.program.graph.semantics
    r = torch.as_tensor(np.asarray(sem.r_table, np.float32)[:, None],
                        device=sim.device)
    xq, _ = quantize_per_axis(r, axis=1)
    got = mac_gemm(xq, sem.ens.enc_q)
    want = mac_gemm_ref(xq.cpu(), sem.ens.enc_q.cpu())
    check(torch.equal(got.cpu(), want),
          f"{what}: mac_gemm {tuple(xq.shape)} x "
          f"{tuple(sem.ens.enc_q.shape)} != mac_gemm_ref")
    ens = build_ensemble(sem.ens.n_neurons, 1, seed=LEARN_SEED,
                         device="cpu")
    drive = encode_drive(ens, np.asarray(sem.r_table)[:, None])
    check(torch.equal(sem.drive_fx.cpu(), drive),
          f"{what}: the card's drive table != the CPU's")
    return dict(mac_gemm_shape=[list(xq.shape), list(sem.ens.enc_q.shape)],
                vs_plain="bitwise", drive_table_vs_cpu="bitwise")


def phase_learn_adaptive(dev, board=None) -> dict:
    """The adaptive-control loop with on-mesh PES learning at the
    reference benchmark's widths through ``adaptive_control_workload``,
    on one chip or on the 2x2 board (refine=False): it converges, its
    convergence tick, final error and learning-energy share beside the
    reference's BENCH_pr5.json row, the whole run against the same
    workload on the CPU (every wrapper's plain version, mac_gemm's
    encode of the drive included), and its tick beside the frozen
    twin's."""
    spec = None if board is None else BoardSpec.parse(board[0],
                                                      chip=board[1])
    where = "chip" if board is None else f"board{board[0]}"
    label = f"learn_adaptive_{where}"
    kw = dict(n_channels=LEARN_CHANNELS, n_neurons=LEARN_NEURONS,
              n_ticks=LEARN_TICKS, board=spec, refine=False, seed=LEARN_SEED)
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = adaptive_control_workload(device=dev, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check_launched(counts, ("fx_exp", "lif_step", "mac_gemm"), label)
    # fx_exp: the LIF alpha at the ensemble's build, the trace decay once
    # a run; lif_step once a tick
    check(counts["fx_exp"] == 2 and counts["lif_step"] == LEARN_TICKS,
          f"{label} launches {counts}")
    check(rep["convergence_tick"] >= 0 and rep["final_err"] < 0.1,
          f"{label}: never converged (final_err {rep['final_err']})")
    sim, recs = rep["sim"], rep["recs"]
    if spec is not None:
        check(float(recs["flits_xchip"].sum()) > 0,
              f"{label}: no chip-to-chip traffic")
    t0 = time.perf_counter()
    cpu = adaptive_control_workload(device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    worst = compare_records(recs, cpu["recs"], f"{label} card vs CPU",
                            close=learn_close(recs))
    check(cpu["convergence_tick"] == rep["convergence_tick"],
          f"{label}: convergence tick {rep['convergence_tick']} on the "
          f"card, {cpu['convergence_tick']} on the CPU")
    vs_cpu = dict(ticks=[0, LEARN_TICKS], records=(
        f"bitwise; {len(learn_close(recs))} float keys at rtol "
        f"{FLOAT_RTOL}"), energy_max_rel_err=worst, cpu_s=cpu_s,
        convergence_tick="equal", encode=drive_vs_cpu(sim, label))
    ref = bench_row(f"learn_adaptive_{where}_{LEARN_CHANNELS}ch")
    emit(label, channels=LEARN_CHANNELS, neurons=LEARN_NEURONS,
         pes=sim.program.n_pes, ticks=LEARN_TICKS, run_s=run_s,
         launches=counts, noc_mode="sparse" if sim.use_sparse_noc()
         else "dense", convergence_tick=rep["convergence_tick"],
         final_err=rep["final_err"], initial_err=rep["initial_err"],
         learn_energy_frac=rep["learn_energy_frac"],
         e_learn_j=rep["e_learn_j"], dec_norm=rep["dec_norm"],
         reference={"source": LEARN_BENCH, "conv_tick": ref["conv_tick"],
                    "final_err": ref["final_err"],
                    "learn_energy_frac": ref["learn_energy_frac"]},
         flits_xchip=float(recs["flits_xchip"].sum())
         if "flits_xchip" in recs else 0.0,
         card_vs_cpu=vs_cpu, plastic=tick_cost(sim),
         frozen=tick_cost(frozen_twin(dev, spec, LEARN_CHANNELS,
                                      LEARN_TICKS)))
    return counts


def phase_learn_stdp(dev) -> dict:
    """The STDP pair at the reference benchmark's widths, every record
    against the CPU's plain versions."""
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = stdp_pair_workload(n_pre=STDP_PRE, n_post=STDP_POST,
                             n_ticks=STDP_TICKS, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check_launched(counts, ("fx_exp", "lif_step"), "stdp pair")
    check(counts["fx_exp"] == 2 and counts["lif_step"] == STDP_TICKS,
          f"stdp pair launches {counts}")
    cpu = stdp_pair_workload(n_pre=STDP_PRE, n_post=STDP_POST,
                             n_ticks=STDP_TICKS, device="cpu")
    worst = compare_records(rep["recs"], cpu["recs"], "stdp pair card vs CPU")
    check(rep["w_mean_last"] != rep["w_mean_first"]
          and rep["post_spikes"] > 0, "stdp pair: no learning")
    ref = bench_row("learn_stdp_pair")
    emit("learn_stdp_pair", n_pre=STDP_PRE, n_post=STDP_POST,
         ticks=STDP_TICKS, run_s=run_s, launches=counts,
         records_vs_cpu="bitwise", energy_max_rel_err=worst,
         **{k: rep[k] for k in ("w_mean_first", "w_mean_last",
                                "post_spikes", "e_learn_j",
                                "learn_energy_frac")},
         reference={"source": LEARN_BENCH, **{
             k: ref[k] for k in ("w_mean_last", "post_spikes",
                                 "learn_energy_frac")}},
         plastic=tick_cost(rep["sim"]))
    return counts


def phase_learn_board(dev) -> dict:
    """The adaptive loop on the reference's headline board (4x12 chips of
    4x2 QPEs): one channel a PE pair, 768 channels on its 1536 PEs,
    refine=False, so every loop crosses chips and the PES group holds
    hundreds of slots; the drive's encode and a window of ticks against
    the CPU; launches and µs a tick beside the frozen twin's."""
    board = BoardSpec.parse(BOARD_GRID, chip=BOARD_CHIP)
    channels = LEARN_BIG_CHANNELS
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = adaptive_control_workload(
        n_channels=channels, n_neurons=LEARN_NEURONS,
        n_ticks=LEARN_BIG_TICKS, board=board, refine=False,
        seed=LEARN_SEED, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    sim, recs = rep["sim"], rep["recs"]
    noc = ("noc_link_loads",) if sim.use_sparse_noc() else ()
    check_launched(counts, ("fx_exp", "lif_step", "mac_gemm") + noc,
                   "learn board")
    check(counts["fx_exp"] == 2 and counts["lif_step"] == LEARN_BIG_TICKS,
          f"learn board launches {counts}")
    check(float(recs["flits_xchip"].sum()) > 0,
          "learn board: no chip-to-chip traffic")
    window = window_vs_cpu(sim, recs, "learn board", None,
                           *LEARN_BIG_WINDOW, close=learn_close(recs))
    window["encode"] = drive_vs_cpu(sim, "learn board")
    groups = group_slots(sim.program.learn_slots)
    emit("learn_board_48chip", board=f"{BOARD_GRID} chips of {BOARD_CHIP} "
         f"QPEs", channels=channels, pes=sim.program.n_pes,
         learn_slots=len(sim.program.learn_slots),
         slot_groups=[len(g) for g in groups], ticks=LEARN_BIG_TICKS,
         run_s=run_s, launches=counts,
         noc_mode="sparse" if sim.use_sparse_noc() else "dense",
         final_err=rep["final_err"], initial_err=rep["initial_err"],
         learn_energy_frac=rep["learn_energy_frac"],
         flits_xchip=float(recs["flits_xchip"].sum()), card_vs_cpu=window,
         plastic=tick_cost(sim),
         frozen=tick_cost(frozen_twin(dev, board, channels,
                                      LEARN_BIG_TICKS)))
    return counts


def fold_records(x: torch.Tensor, op: str, stride: int, alpha: float):
    """A probe's windowed reduction of the (T, ...) records ``x``, tick
    by tick in the probe step's order."""
    T = x.shape[0]
    s = T if stride is None else min(stride, T)
    out, ema = [], None
    for w0 in range(0, T, s):
        acc = None
        for t in range(w0, min(w0 + s, T)):
            v = x[t].to(torch.float32)
            if op == "ema":
                ema = v.clone() if ema is None else \
                    ema * (1.0 - alpha) + alpha * v
            elif acc is None or op == "last":
                acc = v.clone()
            elif op == "peak":
                acc = torch.maximum(acc, v)
            else:
                acc = acc + v
        n = torch.tensor(float(min(w0 + s, T) - w0), device=x.device)
        out.append(ema if op == "ema" else acc / n if op == "mean" else acc)
    return torch.stack(out)


def phase_probes(dev, sim) -> dict:
    """The 4096-PE ring (dense) with the default probe set and
    keep_records=False: every probe equal to the same fold of the
    unprobed card run's records; µs and launches a tick with and without
    probes."""
    recs = sim.run(PROBE_TICKS)
    specs = default_probes(sim.program, stride=PROBE_STRIDE)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.run(PROBE_TICKS, probes=specs, keep_records=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check(set(out) == {"probes"}, "probes: records kept")
    check_launched(counts, ("syn_accum", "lif_step", "noc_link_loads"),
                   "probes")
    for p in specs:
        want = fold_records(recs[p.key], p.op, p.stride, p.alpha)
        check(torch.equal(out["probes"][p.name], want),
              f"probe {p.name} != the fold of the unprobed records")
    del recs
    # whole runs, set-up and record writes included: bare, probed with
    # the records kept, probed without them
    runs = {"bare": {}, "probed": dict(probes=specs),
            "probed_no_records": dict(probes=specs, keep_records=False)}
    ticks = 50
    launches = {k: sum(c for c, _ in device_kernels(
        lambda: sim.run(ticks, **kw), 1)[0].values()) / ticks
        for k, kw in runs.items()}
    emit("probes", pes=sim.program.n_pes, ticks=PROBE_TICKS,
         stride=PROBE_STRIDE, probes=[p.name for p in specs],
         run_s=run_s, launches=counts,
         probes_vs_unprobed_records="bitwise",
         us_per_tick={k: steady_us(sim, PROBE_TICKS, **kw)
                      for k, kw in runs.items()},
         launches_per_tick=launches)
    return counts


def fleet_dvfs(fleet: int) -> QueueDVFS:
    """The reference benchmark's ladder (benchmarks/serve_fleet.py:30):
    levels fleet/4, fleet/2, fleet, thresholds scaled with them."""
    lo, mid = max(1, fleet // 4), max(1, fleet // 2)
    return QueueDVFS(thresholds=(max(2, lo // 2), max(3, mid // 2)),
                     batch_levels=(lo, mid, fleet))


def serve_row(row, dev, keep_outputs: bool, obs=None) -> tuple:
    """One headline row served through ``FleetEngine.serve`` on ``dev``:
    (engine, result, wall seconds)."""
    _, kind, kw, fleet, sessions, seed, board, _ = row
    sc = SCENARIOS[kind](device=dev, **kw)
    bd = None if board is None else BoardSpec.parse(board[0], chip=board[1])
    eng = FleetEngine(sc, round_ticks=SERVE_TC, dvfs=fleet_dvfs(fleet),
                      board=bd, keep_outputs=keep_outputs, obs=obs,
                      device=dev)
    tr = PoissonTraffic(rate=SERVE_RATE, n_sessions=sessions,
                        tick_range=SERVE_TICKS, seed=seed)
    t0 = time.perf_counter()
    out = eng.serve(tr)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return eng, out, time.perf_counter() - t0


def serve_metrics(st: dict, wall_s: float) -> dict:
    return dict(wall_s=wall_s, sessions_per_s=st["sessions_per_s"],
                ticks_per_s=st["ticks_per_s"],
                request_p50_s=st["request_latency_s"]["p50"],
                request_p99_s=st["request_latency_s"]["p99"],
                tick_p50_us=st["tick_latency_s"]["p50"] * 1e6,
                tick_p99_us=st["tick_latency_s"]["p99"] * 1e6)


def compare_sessions(got: list, want: list, what: str) -> dict:
    """Per session, outputs against another run's: ``SERVE_EXACT`` keys
    bitwise, the other float outputs at rtol 1e-5 (atol 1e-6), energy_j
    at rtol 1e-6.  Returns the worst errors."""
    check(sorted(s.sid for s in got) == sorted(s.sid for s in want),
          f"{what}: different sessions")
    by_sid = {s.sid: s for s in want}
    worst = {"energy_rel": 0.0}
    for s in got:
        w = by_sid[s.sid]
        check(s.ticks_done == w.ticks_done and s.ticks_run == w.ticks_run,
              f"{what}: sid {s.sid} ticks differ")
        for k, v in w.outputs.items():
            g = s.outputs[k]
            check(g.shape == v.shape and g.dtype == v.dtype,
                  f"{what}: sid {s.sid} {k} shape/dtype")
            if k in SERVE_EXACT:
                check(np.array_equal(g, v), f"{what}: sid {s.sid} {k} "
                      "differs")
            else:
                check(np.allclose(g, v, rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
                      f"{what}: sid {s.sid} {k} outside rtol {FLOAT_RTOL}")
                worst[k] = max(worst.get(k, 0.0), float(np.abs(
                    g.astype(np.float64) - v).max()) if g.size else 0.0)
        rel = abs(s.energy_j - w.energy_j) / w.energy_j
        check(rel <= ENERGY_RTOL, f"{what}: sid {s.sid} energy rel {rel}")
        worst["energy_rel"] = max(worst["energy_rel"], rel)
    return worst


def solo_session(sc, dev, seed: int, total: int, tc: int):
    """An uninterrupted single-session run (a width-1 fleet)."""
    eng = FleetEngine(sc, round_ticks=tc, capacity=1, device=dev,
                      dvfs=QueueDVFS(thresholds=(2,), batch_levels=(1, 1)))
    sess = Session(sid=0, stream=sc.stream(seed), total_ticks=total)
    return eng.serve(None, sessions=[sess])["sessions"][0]


def serve_fleet_of_one(dev) -> dict:
    """Adaptive 1 x 64, 3 rounds of 64 ticks through a width-1 fleet:
    every output equal to ``ChipSim.run`` of the same program with the
    whole stimulus preloaded, on the card, bitwise."""
    sc = adaptive_scenario(n_neurons=64, device=dev)
    T, seed = 3 * SERVE_TC, 41
    reset_launch_counts()
    sess = solo_session(sc, dev, seed, T, SERVE_TC)
    counts = launch_counts()
    stim = sc.stream(seed).segment(0, T)
    recs = ChipSim(compile(sc.graph(T, stim)), device=dev).run(T)
    for k in sc.output_keys:
        check(np.array_equal(sess.outputs[k], recs[k].cpu().numpy()),
              f"fleet of one: {k} != ChipSim.run")
    # one batched tick at construction shows the record layout
    check(counts["lif_step"] == 1 + T, f"fleet of one launches {counts}")
    return dict(ticks=T, outputs=list(sc.output_keys),
                vs_chipsim_run="bitwise", launches=counts)


def serve_preempt_suspend(dev) -> dict:
    """The reference tests' preemption and suspend configurations on the
    card: sessions narrowed out of the fleet finish equal to their solo
    runs (rtol 3e-6, atol 1e-7: the width changes the batch's float
    sums), and a session suspended to disk and finished in a fresh engine
    equals its solo run bitwise."""
    tc = SERVE_SMALL_TC
    sc = adaptive_scenario(n_neurons=SERVE_SMALL_N, device=dev)
    totals = [2 * tc, 5 * tc, 5 * tc]
    specs = PoissonTraffic(rate=10.0, n_sessions=3, seed=2,
                           tick_range=(1, 1)).drain()
    sessions = [Session(sid=sp.sid, stream=sc.stream(sp.seed),
                        total_ticks=totals[sp.sid]) for sp in specs]
    eng = FleetEngine(sc, round_ticks=tc, device=dev,
                      dvfs=QueueDVFS(thresholds=(3,), batch_levels=(1, 4)))
    out = eng.serve(None, sessions=sessions)
    check(out["stats"]["completed"] == 3 and out["stats"]["preemptions"]
          >= 1, f"preemption: {out['stats']}")
    worst = 0.0
    for sess in out["sessions"]:
        ref = solo_session(sc, dev, specs[sess.sid].seed, sess.total_ticks,
                           tc)
        for k in sc.output_keys:
            check(np.allclose(sess.outputs[k], ref.outputs[k], rtol=3e-6,
                              atol=1e-7), f"preempted sid {sess.sid} {k}")
            worst = max(worst, float(np.abs(
                sess.outputs[k].astype(np.float64) - ref.outputs[k]).max()))
    T, seed = 5 * tc, 99
    ref = solo_session(sc, dev, seed, T, tc)
    with tempfile.TemporaryDirectory() as d:
        kw = dict(round_ticks=tc, capacity=1, ckpt_dir=d, device=dev,
                  dvfs=QueueDVFS(thresholds=(2,), batch_levels=(1, 1)))
        eng1 = FleetEngine(sc, max_rounds=2, **kw)
        s1 = Session(sid=7, stream=sc.stream(seed), total_ticks=T)
        eng1.serve(None, sessions=[s1])
        check([s.sid for s in eng1.suspend()] == [7], "suspend")
        part1 = {k: np.concatenate(v) for k, v in s1.outputs.items()}
        eng2 = FleetEngine(sc, **kw)
        s2 = eng2.restore_session(7, stream=sc.stream(seed), total_ticks=T)
        done = eng2.serve(None, sessions=[s2])["sessions"][0]
    for k in sc.output_keys:
        check(np.array_equal(np.concatenate([part1[k], done.outputs[k]]),
                             ref.outputs[k]), f"suspend/restore: {k}")
    return dict(preemptions=out["stats"]["preemptions"],
                preempted_vs_solo_max_abs_err=worst,
                suspend_restore_vs_solo="bitwise")


def serve_observed(dev, bare_tick_us: float) -> dict:
    """The adaptive headline row with observability on: span chains
    valid, health not critical, a fleet trace written and read back, µs
    a tick beside the bare serve's; then again with every tick's records
    kept on the side, and each dev/* counter equal to the host sums of
    those records over the active slots of each round."""
    row = SERVE_ROWS[0]
    eng, out, wall = serve_row(row, dev, keep_outputs=False, obs=True)
    o = out["obs"]
    check(o["health"]["status"] != "critical", f"health {o['health']}")
    check(validate_spans(o["spans"].events, require_complete=True) == [],
          "span chains")
    with tempfile.TemporaryDirectory() as d:
        path = write_fleet_trace(Path(d) / "fleet.json.gz",
                                 load_spans(o["spans"].write(
                                     Path(d) / "spans.json.gz")))
        trace = json.loads(gzip.decompress(path.read_bytes()))
    check(trace["otherData"]["n_requests"] == row[4], "fleet trace")
    obs_tick_us = out["stats"]["tick_latency_s"]["p50"] * 1e6

    sc = SCENARIOS[row[1]](device=dev, **row[2])
    eng = FleetEngine(sc, round_ticks=SERVE_TC, dvfs=fleet_dvfs(row[3]),
                      keep_outputs=False, obs=True, device=dev)
    kept, step = [], eng._step
    keys = {s.key for s in eng._dev_specs}

    def recording(state, t):
        state, rec = step(state, t)
        kept.append({k: rec[k] for k in keys})
        return state, rec
    eng._step = recording
    out = eng.serve(PoissonTraffic(rate=SERVE_RATE, n_sessions=row[4],
                                   tick_range=SERVE_TICKS, seed=row[5]))
    snap = out["obs"]["metrics"]
    rounds = out["obs"]["spans"].counters
    check(len(kept) == len(rounds) * SERVE_TC, "recorded ticks")
    want = {s.name: 0.0 for s in eng._dev_specs}
    for r, c in enumerate(rounds):
        ticks = kept[r * SERVE_TC:(r + 1) * SERVE_TC]
        for s in eng._dev_specs:
            v = torch.stack([x[s.key] for x in ticks])[:, :c["n_active"]]
            v = v.double().cpu()
            if s.op == "sum":
                want[s.name] += float(v.sum())
            else:
                want[s.name] = max(want[s.name], float(v.max()))
    for s in eng._dev_specs:
        got = snap[f"dev/{s.name}" + ("" if s.op == "sum" else "_peak")]
        check(got == want[s.name], f"dev/{s.name}: {got} != host "
              f"{want[s.name]}")
    return dict(health=o["health"]["status"], span_events=len(
        o["spans"].events), trace_events=len(trace["traceEvents"]),
        dev_counters_vs_records="equal", dev_counters=want,
        tick_p50_us_obs=obs_tick_us, tick_p50_us_bare=bare_tick_us,
        wall_s_obs=wall)


def serve_modes(dev) -> dict:
    """Every NoC and exec mode serves on the card: a 12-PE program (6
    loops of 16 neurons; the KWS farm of 6 pairs, whose flits vary per
    instance and tick) through the sparse NoC accounting (noc_link_loads
    on the fleet's 2w rows, once a batched tick) and event mode
    (event_link_loads, the same) gives the dense fleet's outputs and
    energies bitwise."""
    out = {}
    for kind, kw in (("adaptive", dict(n_channels=6, n_neurons=16)),
                     ("kws", dict(n_pairs=6, n_neurons=16, hidden=4))):
        sc = SCENARIOS[kind](device=dev, **kw)
        runs, launches = [], {}
        for noc, ex, kernel in (("dense", "dense", None),
                                ("sparse", "dense", "noc_link_loads"),
                                ("sparse", "event", "event_link_loads")):
            eng = FleetEngine(sc, round_ticks=SERVE_SMALL_TC, device=dev,
                              noc_mode=noc, exec_mode=ex,
                              dvfs=QueueDVFS(thresholds=(2,),
                                             batch_levels=(2, 4)))
            reset_launch_counts()
            res = eng.serve(PoissonTraffic(rate=3.0, n_sessions=5, seed=6,
                                           tick_range=(SERVE_SMALL_TC,
                                                       3 * SERVE_SMALL_TC)))
            counts = launch_counts()
            ticks = sum(res["stats"]["width_hist"].values()) * SERVE_SMALL_TC
            if kernel is not None:
                check(counts[kernel] == ticks, f"serve {kind} {noc}/{ex}: "
                      f"{kernel} {counts[kernel]} launches in {ticks} ticks")
                launches[f"{noc}/{ex}"] = {kernel: counts[kernel],
                                           "batched_ticks": ticks}
            runs.append(res["sessions"])
        for other in runs[1:]:
            for a, b in zip(runs[0], other):
                check(a.energy_j == b.energy_j, f"serve {kind} modes: "
                      "energy differs")
                for k in sc.output_keys:
                    check(np.array_equal(a.outputs[k], b.outputs[k]),
                          f"serve {kind} modes: {k} differs")
        out[kind] = dict(pes=eng.program.n_pes, links=eng.sim.noc.n_links,
                         vs_dense="bitwise", launches=launches)
    return out


def serve_kernels_at_shapes(dev) -> dict:
    """lif_step at the fleet's batched shape and mac_gemm at one round's
    stacked encode, each against its plain version, bitwise; the round's
    whole drive against a CPU build of the ensemble's."""
    sc = adaptive_scenario(n_neurons=64, device=dev)
    streams = [sc.stream(i) for i in range(64)]
    sig = np.stack([s.signal(64 * i, SERVE_TC)
                    for i, s in enumerate(streams)])
    x = torch.as_tensor(sig.reshape(-1, 1), device=dev)
    xq, _ = quantize_per_axis(x, axis=1)
    got = mac_gemm(xq, sc.ens.enc_q)
    check(torch.equal(got.cpu(), mac_gemm_ref(xq.cpu(),
                                              sc.ens.enc_q.cpu())),
          "serve encode: mac_gemm != mac_gemm_ref")
    cpu_sc = adaptive_scenario(n_neurons=64, device="cpu")
    check(torch.equal(stim_windows(sc.ens, sig)["drive"].cpu(),
                      stim_windows(cpu_sc.ens, sig)["drive"]),
          "serve encode: the card's drive != the CPU's")
    gen = torch.Generator().manual_seed(5)
    v = torch.randint(-2**16, 2**16, (64, 1, 64), generator=gen,
                      dtype=torch.int32)
    ref = torch.randint(0, 3, (64, 1, 64), generator=gen, dtype=torch.int32)
    i_syn = torch.randint(-2**15, 2**16, (64, 1, 64), generator=gen,
                          dtype=torch.int32)
    want = lif_step_ref(v, ref, i_syn, **sc.ens.lif)
    got = lif_step(v.to(dev), ref.to(dev), i_syn.to(dev), **sc.ens.lif)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "serve lif_step (64, 1, 64) != lif_step_ref")
    return dict(mac_gemm_shape=[list(xq.shape), list(sc.ens.enc_q.shape)],
                lif_step_shape=[64, 1, 64], vs_plain="bitwise",
                drive_vs_cpu="bitwise")


def serve_tick_profile(dev) -> dict:
    """The batched tick of the adaptive headline program at widths 16,
    32 and 64 under torch.profiler: launches, device busy µs and idle
    share a tick, and at width 64 the kernels that take the time."""
    sc = adaptive_scenario(n_neurons=64, device=dev)
    eng = FleetEngine(sc, round_ticks=SERVE_TC, device=dev,
                      dvfs=fleet_dvfs(64))
    init, step = eng.sim.make_batched_stepper()
    out = {}
    for w in SERVE_PROFILE_WIDTHS:
        state = broadcast_state(init, w)
        # each instance's local ticks, made before the profile: the
        # engine's round computes them once as well
        ticks = iter(torch.arange(PROFILE_TICKS + 1, dtype=torch.int32,
                                  device=dev)[:, None]
                     + torch.arange(w, dtype=torch.int32, device=dev))

        def one_tick():
            nonlocal state
            state, _ = step(state, next(ticks))
        kernels, wall_us = device_kernels(one_tick, PROFILE_TICKS)
        busy = sum(us for _, us in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
        out[str(w)] = dict(
            launches_per_tick=sum(c for c, _ in kernels.values())
            / PROFILE_TICKS,
            device_busy_us_per_tick=busy / PROFILE_TICKS,
            profiled_wall_us_per_tick=wall_us / PROFILE_TICKS,
            device_idle_share=1.0 - busy / wall_us,
            top=[{"kernel": k[:90], "launches_per_tick": c / PROFILE_TICKS,
                  "us_per_tick": us / PROFILE_TICKS}
                 for k, (c, us) in top] if w == 64 else None)
    return out


def phase_serve(dev) -> dict:
    """The serving tier through ``FleetEngine.serve``: the fleet of one,
    the reference serving benchmark's three rows (schedules equal to its
    table, joules a request to BENCH_pr7.json's 6 decimals, each row
    again keeping its outputs on the card and on the card machine's CPU,
    every session compared), preemption and suspend, observability on,
    the kernels at the fleet's shapes, and the batched tick's profile."""
    t_phase = time.perf_counter()
    paths, report = {}, {"fleet_of_one": serve_fleet_of_one(dev)}
    bench = {r["name"]: r["values"] for r in json.loads(
        (ROOT / SERVE_BENCH).read_text())["rows"]}
    rows = {}
    for row in SERVE_ROWS:
        name, want = row[0], row[7]
        reset_launch_counts()
        eng, out, wall = serve_row(row, dev, keep_outputs=False)
        counts = launch_counts()
        st = out["stats"]
        got = {k: st[k] for k in want}
        check(got == want, f"{name}: schedule {got} != {want}")
        jpr = round(st["joules_per_request"], 6)
        check(jpr == round(bench[name]["joules_per_request"], 6),
              f"{name}: {st['joules_per_request']} J a request, "
              f"{SERVE_BENCH} {bench[name]['joules_per_request']}")
        # lif_step once a batched tick at every width (and once at the
        # engine's construction), mac_gemm once a round (and once for
        # the program's default stimulus)
        batched = sum(st["width_hist"].values())
        check_launched(counts, ("fx_exp", "lif_step", "mac_gemm"), name)
        check(counts["lif_step"] == 1 + batched * SERVE_TC
              and counts["mac_gemm"] == 1 + batched,
              f"{name}: launches {counts} for {batched} rounds")
        paths[name] = counts
        _, card, _ = serve_row(row, dev, keep_outputs=True)
        t0 = time.perf_counter()
        _, cpu, _ = serve_row(row, "cpu", keep_outputs=True)
        cpu_s = time.perf_counter() - t0
        worst = compare_sessions(card["sessions"], cpu["sessions"],
                                 f"{name} card vs CPU")
        rows[name] = dict(
            schedule=got, joules_per_request=st["joules_per_request"],
            reference_joules_per_request=bench[name]["joules_per_request"],
            pes=eng.program.n_pes, launches=counts,
            noc_mode="sparse" if eng.sim.use_sparse_noc() else "dense",
            exec_mode="event" if eng.sim.use_event_mode() else "dense",
            **serve_metrics(st, wall),
            card_vs_cpu=dict(sessions=len(cpu["sessions"]), cpu_s=cpu_s,
                             exact=list(SERVE_EXACT), **worst))
    report["rows"] = rows
    report["preemption_suspend"] = serve_preempt_suspend(dev)
    report["observed"] = serve_observed(
        dev, rows[SERVE_ROWS[0][0]]["tick_p50_us"])
    report["modes"] = serve_modes(dev)
    report["kernels_at_serve_shapes"] = serve_kernels_at_shapes(dev)
    report["batched_tick_profile"] = serve_tick_profile(dev)
    launches = [p["launches_per_tick"]
                for p in report["batched_tick_profile"].values()]
    report["launches_per_tick_equal_across_widths"] = \
        max(launches) - min(launches) < 0.5
    emit("serve", phase_s=time.perf_counter() - t_phase, **report)
    return paths


def route_values(res) -> dict:
    """A ``RouteOptResult`` as the reference benchmark's ``_opt`` row."""
    base, opt = res.baseline, res.profile
    return {"peak_xlink_flits": opt.peak_xlink,
            "base_peak_xlink_flits": base.peak_xlink,
            "mean_xlink_flits": opt.mean_xlink,
            "base_mean_xlink_flits": base.mean_xlink,
            "peak_onchip_flits": opt.peak_onchip,
            "base_peak_onchip_flits": base.peak_onchip,
            "iters": res.iterations, "converged": int(res.converged),
            "improvement": res.improvement}


def route_records_vs_baseline(res, base_prog, dev) -> dict:
    """The optimised program against the fixed-route compile: equal
    delivery signatures (``check_delivery``), and every record but the
    NoC's bitwise over a run of each on the sparse NoC (noc_link_loads on
    each routed board plan), whose per-link peak flits must equal the
    optimiser's measured profile."""
    t0 = time.perf_counter()
    sig = check_delivery(res.program)
    check(sig == check_delivery(base_prog),
          "route_opt: delivery signatures differ")
    sig_s = time.perf_counter() - t0
    ra = ChipSim(res.program, noc_mode="sparse", device=dev).run(ROUTE_TICKS)
    rb = ChipSim(base_prog, noc_mode="sparse", device=dev).run(ROUTE_TICKS)
    neuron = sorted(k for k in ra if not k.startswith(ROUTE_NOC_KEYS))
    check(set(ra) == set(rb), "route_opt: record keys differ")
    for k in neuron:
        check(torch.equal(ra[k], rb[k]), f"route_opt: record {k} differs")
    check(np.array_equal(ra["link_flits"].amax(0).cpu().numpy(),
                         res.profile.peak),
          "route_opt: sparse NoC peak != the optimiser's profile")
    return dict(signatures_equal=len(sig), check_delivery_s=sig_s,
                neuron_records_bitwise=neuron,
                sparse_peak_equals_profile=True)


def phase_route_opt(dev) -> dict:
    """The profile-guided route optimiser (``routeopt.optimize_routes``)
    on the reference board benchmark's --route-opt rows: each row's
    baseline and optimised peaks and means, iterations and convergence
    equal to BENCH_pr9.json's; the optimised program against the
    fixed-route one (``route_records_vs_baseline``); per iteration the
    compile and measure seconds, and µs a tick of both programs."""
    t_phase = time.perf_counter()
    bench = {r["name"]: r["values"] for r in json.loads(
        (ROOT / ROUTE_BENCH).read_text())["rows"]}
    paths, rows = {}, []
    for name, grid, sim_kw in ROUTE_ROWS:
        board = BoardSpec.parse(grid, chip=BOARD_CHIP)
        reset_launch_counts()
        t0 = time.perf_counter()
        res = optimize_routes(hybrid_farm_board_graph(board, device=dev),
                              board, n_ticks=ROUTE_TICKS,
                              max_iters=ROUTE_ITERS, sim_kw=sim_kw,
                              device=dev)
        torch.cuda.synchronize()
        optimize_s = time.perf_counter() - t0
        counts = launch_counts()
        label = f"route_opt_{grid}" + ("_event" if sim_kw else "")
        paths[label] = counts
        check_launched(counts, ("lif_step", "fx_exp", "mac_gemm") + (
            ("event_link_loads",) if sim_kw else ()), label)
        got = route_values(res)
        want = bench[name]
        for k, nd in ROUTE_KEYS.items():
            check(round(float(got[k]), nd) == round(float(want[k]), nd),
                  f"{label}: {k} {got[k]} != {ROUTE_BENCH} {want[k]}")
        base_prog = compile_board(hybrid_farm_board_graph(board, device=dev),
                                  board)
        checks = route_records_vs_baseline(res, base_prog, dev)
        tick_us = {which: steady_us(ChipSim(prog, device=dev, **sim_kw),
                                    ROUTE_TICKS)
                   for which, prog in (("baseline", base_prog),
                                       ("optimised", res.program))}
        rows.append(dict(
            row=name, sim_kw=sim_kw, chips=board.n_chips, pes=board.n_pes,
            ports=res.program.board.ports_per_edge, values=got,
            reference=f"{ROUTE_BENCH} {name}: equal", optimize_s=optimize_s,
            reference_optimize_s=want.get("optimize_s"),
            per_iteration=[{k: r[k] for k in ("iter", "compile_s",
                                              "measure_s", "cut_flits")}
                           for r in res.trajectory],
            trajectory=res.trajectory, launches=counts,
            route=dict(tree_orient=len(res.route.tree_orient),
                       chip_orient=len(res.route.chip_orient),
                       ports=len(res.route.ports)),
            tick_us=tick_us, **checks))
        del res, base_prog
    emit("route_opt", phase_s=time.perf_counter() - t_phase, rows=rows)
    return paths


def lm_requests(cfg, n: int, prompt_len: int, max_new: int, seed: int):
    """The launcher's stream: prompts from numpy's generator."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               prompt_len, dtype=np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def lm_stream(cfg, model, spec: dict, want: dict, seed: int, what: str,
              per_prefill: dict | None = None):
    """Serve one stream through ``ServeEngine.run`` and check it: the
    schedule, each prefill batch's kernel launches (``per_prefill``,
    kernel -> launches; default ``num_layers`` flash launches), every
    request ``max_new`` tokens in [0, vocab)."""
    per_prefill = per_prefill or {"flash_attention_kernel": cfg.num_layers}
    eng = ServeEngine(cfg, model, max_seq=spec["max_seq"])
    reqs = lm_requests(cfg, spec["requests"], spec["prompt_len"],
                       spec["max_new"], seed)
    for r in reqs:
        eng.submit(r)
    per_batch = []
    prefill = lm.prefill

    def counted(*args, **kw):
        n0 = launch_counts()
        out = prefill(*args, **kw)
        n1 = launch_counts()
        per_batch.append({k: n1[k] - n0[k] for k in per_prefill})
        return out
    lm.prefill = counted
    try:
        t0 = time.perf_counter()
        stats = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        lm.prefill = prefill
    got = {k: stats[k] for k in want}
    check(got == want, f"{cfg.name} {what}: schedule {got} != {want}")
    check(per_batch == [per_prefill] * stats["rounds"],
          f"{cfg.name} {what}: launches a prefill batch {per_batch}")
    for r in reqs:
        check(len(r.out_tokens) == spec["max_new"]
              and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"{cfg.name} {what}: request {r.rid} tokens {r.out_tokens}")
    generated = sum(len(r.out_tokens) for r in reqs)
    dec = np.asarray(eng.timings["decode_s"]) * 1e3
    return reqs, dict(
        spec=spec, schedule=got, launches_per_prefill=per_batch,
        wall_s=wall, prefill_ms=[s * 1e3 for s in eng.timings["prefill_s"]],
        decode_ms_p50=float(np.percentile(dec, 50)),
        decode_ms_mean=float(dec.mean()), decode_steps=len(dec),
        tokens_generated=generated, tokens_per_s=generated / wall,
        decode_tokens_per_s=stats["tokens"] / (dec.sum() / 1e3))


def lm_decode_profile(cfg, model, dev, batch: int, prompt: int,
                      max_seq: int) -> dict:
    """One decode step at stream (a)'s widest batch under the profiler:
    launches, device busy µs and the idle share of the step's wall time
    (which the profiler itself slows), beside its CUDA-event time and the
    bound of reading every weight and the cache once."""
    toks = torch.zeros((batch, prompt), dtype=torch.long, device=dev)
    with torch.no_grad():
        _, caches = lm.prefill(cfg, model, {"tokens": toks}, max_seq)
        one = {"tokens": toks[:, :1]}
        step = lambda: lm.decode_step(cfg, model, caches, prompt, one)
        kernels, wall_us = device_kernels(step, LM_PROFILE_STEPS)
        step_ms = cuda_ms(step, LM_PROFILE_STEPS)
    launches = sum(n for n, _ in kernels.values()) / LM_PROFILE_STEPS
    busy_us = sum(us for _, us in kernels.values()) / LM_PROFILE_STEPS
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    cache = tree_bytes(caches)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    return dict(batch=batch, position=prompt, launches_per_step=launches,
                busy_us=busy_us, wall_us=wall_us / LM_PROFILE_STEPS,
                idle_share=1.0 - busy_us / (wall_us / LM_PROFILE_STEPS),
                step_ms=step_ms, bound_ms=bound_ms(weights + cache)[0],
                top_kernels=[dict(name=k, launches=n / LM_PROFILE_STEPS,
                                  us=us / LM_PROFILE_STEPS)
                             for k, (n, us) in top])


def tree_leaves(tree) -> list:
    """The tensors of a nested list / dict tree."""
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in tree_leaves(x)]


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def rel_max(got, want) -> float:
    """Relative max error: max |got - want| over max |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-6)


def lm_batch(cfg, dev, shape, seed):
    """A served input of (B, S) positions from numpy's generator: tokens,
    or, for the encodec frontend, standard normal frames (B, S, d) in
    bf16."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "encodec":
        return {"frames": torch.from_numpy(rng.standard_normal(
            tuple(shape) + (cfg.d_model,))).to(torch.bfloat16).to(dev)}
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, tuple(shape))).to(dev)}


def lm_cut(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


def lm_full_dense(cfg, model, batch, dtype, moe_dense=True):
    """The full-sequence forward with the reference's model attention at
    these lengths (``attention_dense``, banded in local layers: p rounded
    to v's dtype before P V) in every attention layer, the recurrent
    layers through their kernels' plain versions (the sequential RG-LRU
    and WKV), and the MoE's dense oracle: its logits and each attention
    layer's k and v (None for a recurrent layer)."""
    L = lm_layers
    S = lm.seq_len(batch)
    qpos = torch.arange(S, device=model["embed"]["table"].device)
    x = lm.embed_input(cfg, model, batch, qpos, dtype)
    kv = []
    for kind, bp in zip(lm.layer_kinds(cfg), model["blocks"]):
        if kind in ("rglru", "rwkv"):
            h = L.apply_norm(cfg, bp["norm1"], x)
            if kind == "rglru":
                x = x + lm_rglru.rglru_block_apply(cfg, bp["rec"], h,
                                                   scan=linear_scan_ref)[0]
                h = L.apply_norm(cfg, bp["norm2"], x)
                x = x + L.mlp_apply(cfg, bp["mlp"], h)
            else:
                x = x + lm_rwkv.time_mix_apply(cfg, bp["tmix"], h,
                                               wkv=wkv6_ref)[0]
                h = L.apply_norm(cfg, bp["norm2"], x)
                x = x + lm_rwkv.channel_mix_apply(cfg, bp["cmix"], h)[0]
            kv.append(None)
            continue
        h = L.apply_norm(cfg, bp["norm1"], x)
        q, k, v = L.attn_qkv(cfg, bp["attn"], h, qpos, kind)
        kv.append((k, v))
        window = cfg.window_size if kind == "local" else 0
        x = x + L.attn_out(cfg, bp["attn"], L.attention_dense(
            q, k, v, qpos, qpos, window=window))
        h = L.apply_norm(cfg, bp["norm2"], x)
        if cfg.moe:
            moe = lm_moe.moe_apply_dense if moe_dense else lm_moe.moe_apply
            x = x + moe(cfg, bp["mlp"], h, aux=False)[0]
        else:
            x = x + L.mlp_apply(cfg, bp["mlp"], h)
    x = L.apply_norm(cfg, model["final_norm"], x)
    return lm.logits_fn(cfg, model, x), kv


def lm_decode(cfg, model, batch, P: int, dtype, moe_dense=False):
    """``prefill`` of the first P positions, then ``decode_step`` over
    the rest: the logits at positions P-1.. and the caches."""
    S = lm.seq_len(batch)
    lg, caches = lm.prefill(cfg, model, lm_cut(batch, 0, P), S, dtype=dtype,
                            moe_dense=moe_dense)
    outs = [lg[:, 0]]
    for t in range(P, S):
        lg, caches = lm.decode_step(cfg, model, caches, t,
                                    lm_cut(batch, t, t + 1), dtype=dtype,
                                    moe_dense=moe_dense)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1), caches


@contextlib.contextmanager
def lm_fault(kind):
    """A deliberate decode fault, for the gate to catch: ``gqa_head_map``
    (query head h meets KV head h mod KH, not h // G), ``cache_slot``
    (each step's k and v written one slot late), ``ring_slot`` (a local
    layer's ring written one slot past ``pos mod window``, its positions
    kept), ``gate_norm`` (the MoE's top-k gate values left
    un-renormalised), ``conv_shift`` (an RG-LRU decode step keeps its conv
    window one step late: ``full[:, -cw:-1]`` for ``full[:, -(cw-1):]``)
    or ``token_shift`` (an RWKV-6 decode step leaves the time mixing's
    shift where it was, so the next step reads x_{t-2} as x_{t-1})."""
    L = lm_layers
    module, name = {"gqa_head_map": (L, "attention_dense"),
                    "cache_slot": (L, "attn_apply"),
                    "ring_slot": (L, "ring_slot"),
                    "gate_norm": (lm_moe, "_gates"),
                    "conv_shift": (lm_rglru, "_causal_conv"),
                    "token_shift": (lm_rwkv, "time_mix_apply"),
                    None: (None, None)}[kind]
    if name is None:
        yield
        return
    orig = getattr(module, name)

    def gqa(q, k, v, qpos, kpos, **kw):
        B, S, KH, G, D = q.shape
        return orig(q.reshape(B, S, G, KH, D).transpose(2, 3), k, v, qpos,
                    kpos, **kw)

    def slot(cfg, p, x, qpos, *, cache=None, kv_len=None, **kw):
        return orig(cfg, p, x, qpos, cache=cache,
                    kv_len=None if kv_len is None else kv_len + 1, **kw)

    def ring(kv_len, window):
        return (kv_len + 1) % window

    def gates(cfg, probs):
        return lm_moe._top_k(probs, cfg.experts_per_token)

    def conv_late(p, u, conv_cache):
        out, new = orig(p, u, conv_cache)
        if u.shape[1] == 1:                       # a decode step
            cw = p["conv_w"].shape[0]
            new = torch.cat([conv_cache.to(u.dtype), u], 1)[:, -cw:-1]
        return out, new

    def shift_kept(cfg, p, x, cache=None, **kw):
        out, new = orig(cfg, p, x, cache=cache, **kw)
        if cache is not None:                     # a decode step
            new = dict(new, shift=cache["shift"])
        return out, new
    setattr(module, name, {"gqa_head_map": gqa, "cache_slot": slot,
                           "ring_slot": ring, "gate_norm": gates,
                           "conv_shift": conv_late,
                           "token_shift": shift_kept}[kind])
    try:
        yield
    finally:
        setattr(module, name, orig)


def cache_vs_kv(cfg, cache, k, v, S: int, kind: str) -> float:
    """An attention layer's cache after positions 0..S-1 against the full
    forward's k and v (B, S, KH, D): each slot against the position it
    holds (a ring's slot s the position ``ring_positions`` gives, else
    slot p position p), relative max error."""
    Sc = cache["k"].shape[1]
    if kind == "local" and Sc == cfg.window_size and S > Sc:
        pos = lm_layers.ring_positions(S - 1, Sc, k.device)
    else:
        pos = torch.arange(min(S, Sc), device=k.device)
    slots = torch.arange(len(pos), device=k.device)
    return max(rel_max(cache[c][:, slots], t[:, pos])
               for c, t in (("k", k), ("v", v)))


def cache_check(cfg, caches, kv, full_caches, S: int) -> float:
    """The decode's caches after positions 0..S-1, relative max error: a
    recurrent layer 0's state (RG-LRU: conv and state; RWKV-6: both
    shifts and the WKV state) against the one a prefill of all S
    positions leaves (``full_caches``), and the first attention layer's
    cache against the full forward's k and v (``cache_vs_kv``); the
    larger."""
    kinds = lm.layer_kinds(cfg)
    errs = []
    if kinds[0] not in lm.ATTN_KINDS:
        errs += [rel_max(g, w) for g, w in zip(tree_leaves(caches[0]),
                                               tree_leaves(full_caches[0]))]
    first = next((i for i, k in enumerate(kinds) if k in lm.ATTN_KINDS),
                 None)
    if first is not None:
        errs.append(cache_vs_kv(cfg, caches[first], *kv[first], S,
                                kinds[first]))
    return max(errs)


def lm_decode_vs_full(cfg, model, dev, *, faults=LM_FAULTS,
                      sizes=LM_DECODE_CHECK, moe_dense=False,
                      seed=2) -> dict:
    """Incremental decode against the full forward (the relation of
    tests/test_models_decode.py; ``moe_dense``: the MoE's dense oracle in
    both, as that test runs MoE).  float32 activations: against the
    served full forward (the float32 flash kernel), below
    LM_DECODE_F32_REL.  bf16, as served: against the float32 full forward,
    within LM_DECODE_BF16_FACTOR of the bf16 full forward's own distance
    from it (for an MoE config the larger of the dense-attention and the
    served bf16 full forward's: the routing's near ties), and layer 0's
    cache within LM_CACHE0_REL of the full forward's k and v (a
    recurrent family: ``cache_check``); each of ``faults`` must fail that
    gate.  The
    reference's relation (decode against the bf16 full forward, both with
    its dense attention) is reported beside 0.02, and against the served
    bf16 forward (flash).  ``sizes``: batch, prompt, decode steps."""
    B, P, n = sizes
    batch = lm_batch(cfg, dev, (B, P + n), seed)
    with torch.no_grad():
        dec, _ = lm_decode(cfg, model, batch, P, torch.float32, moe_dense)
        f32 = dict(rel=rel_max(dec, model(batch, dtype=torch.float32,
                                          moe_dense=moe_dense)[:, P - 1:]),
                   limit=LM_DECODE_F32_REL)
        check(f32["rel"] < LM_DECODE_F32_REL,
                 f"{cfg.name}: float32 decode vs full forward {f32}")
        want, kv = lm_full_dense(cfg, model, batch, torch.bfloat16,
                                 moe_dense)
        truth = lm_full_dense(cfg, model, batch, torch.float32,
                              moe_dense)[0][:, P - 1:]
        want = want[:, P - 1:]
        served = model(batch, moe_dense=moe_dense)[:, P - 1:]
        full_caches = (None if lm.layer_kinds(cfg)[0] in lm.ATTN_KINDS
                       else lm.prefill(cfg, model, batch, P + n)[1])
        noise = rel_max(want, truth)
        served_noise = rel_max(served, truth)
        if cfg.moe:
            # top-k routing is discontinuous: a bf16 rounding can move a
            # near tie off the float32 routing in one bf16 forward and not
            # in another, so the floor is the larger of the two bf16 full
            # forwards' distances (the served one through flash)
            noise = max(noise, served_noise)
        readings = {}
        for fault in (None,) + tuple(faults):
            with lm_fault(fault):
                dec, caches = lm_decode(cfg, model, batch, P, torch.bfloat16,
                                        moe_dense)
            vs_f32 = rel_max(dec, truth)
            readings[fault or "sound"] = dict(
                vs_float32=vs_f32, ratio=vs_f32 / max(noise, 1e-30),
                cache0=cache_check(cfg, caches, kv, full_caches, P + n),
                reference_relation=rel_max(dec, want),
                served_relation=rel_max(dec, served))
    passes = lambda r: (r["ratio"] < LM_DECODE_BF16_FACTOR
                        and r["cache0"] <= LM_CACHE0_REL)
    bf16 = dict(sizes=list(sizes), moe_dense=moe_dense,
                full_forward_vs_float32=noise,
                served_forward_vs_float32=served_noise,
                factor=LM_DECODE_BF16_FACTOR,
                cache0_limit=LM_CACHE0_REL, readings=readings,
                within_reference_relation=readings["sound"][
                    "reference_relation"] < LM_DECODE_REL)
    check(passes(readings["sound"]),
             f"{cfg.name}: bf16 decode vs the float32 forward {bf16}")
    for fault in faults:
        check(not passes(readings[fault]),
                 f"{cfg.name}: the bf16 decode gate misses {fault}: {bf16}")
    return {"float32": f32, "bfloat16": bf16}


@contextlib.contextmanager
def moe_dispatches():
    """Record every ``moe.dispatch`` result (the MoE layers' routing, in
    call order) while the block runs."""
    orig, seen = lm_moe.dispatch, []

    def recording(*args, **kw):
        seen.append(orig(*args, **kw))
        return seen[-1]
    lm_moe.dispatch = recording
    try:
        yield seen
    finally:
        lm_moe.dispatch = orig


MOE_INTEGERS = ("gate_idx", "rank", "keep", "dst")


def same_dispatch(got: list, want: list, what: str) -> None:
    """Two runs' MoE routings, layer by layer: the same capacity and the
    same top-k experts, ranks, kept mask and buffer rows."""
    check(len(got) == len(want), f"{what}: {len(got)} != {len(want)} MoE calls")
    for i, (g, w) in enumerate(zip(got, want)):
        check(g["C"] == w["C"], f"{what}: layer {i} capacity")
        for key in MOE_INTEGERS:
            check(torch.equal(g[key].cpu(), w[key].cpu()),
                  f"{what}: layer {i} {key} differs")


def twin_launches(cfg) -> dict:
    """The hand kernels a prefill of ``cfg`` launches, by layer kind."""
    kinds = lm.layer_kinds(cfg)
    return {"flash_attention_kernel": sum(k in lm.ATTN_KINDS for k in kinds),
            "linear_scan": kinds.count("rglru"), "wkv6": kinds.count("rwkv")}


def lm_twin(cfg, dev, pattern=None) -> dict:
    """The float32 twin: ``LM_TWIN_LAYERS`` layers at full width (of the
    layer kinds ``pattern`` where given), weights drawn on the CPU (a
    recurrent family's redrawn as ``redraw_recurrent``) and copied to the
    card; prefill logits of the card (TF32 off, the float32 flash kernel,
    linear_scan, wkv6) against the CPU's (plain versions), each layer's
    kernel launched once, and an MoE's routing in every layer, card ==
    CPU."""
    import copy
    twin = dataclasses.replace(cfg, num_layers=LM_TWIN_LAYERS, **(
        {"layer_pattern": pattern} if pattern else {}))
    t0 = time.perf_counter()
    cpu_model = lm.init_params(twin, dtype=torch.float32, device="cpu",
                               seed=LM_SEED)
    redrawn = (redraw_recurrent(cpu_model, LM_SEED)
               if cfg.family in ("rglru", "rwkv6") else None)
    card_model = copy.deepcopy(cpu_model).to(dev)
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, LM_TWIN_SHAPE))
    S = LM_TWIN_SHAPE[1]
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    with torch.no_grad():
        n0 = launch_counts()
        with moe_dispatches() as card_routes:
            got, _ = lm.prefill(twin, card_model, {"tokens": toks.to(dev)},
                                S, dtype=torch.float32)
        torch.cuda.synchronize()
        n1 = launch_counts()
        launched = {k: n1[k] - n0[k] for k in twin_launches(twin)}
        check(launched == twin_launches(twin),
              f"{cfg.name} twin: launches {launched}")
        t0 = time.perf_counter()
        with moe_dispatches() as cpu_routes:
            want, _ = lm.prefill(twin, cpu_model, {"tokens": toks}, S,
                                 dtype=torch.float32)
        cpu_s = time.perf_counter() - t0
    got = got.cpu()
    check(got.dtype == want.dtype == torch.float32
          and bool(torch.isfinite(got).all()), f"{cfg.name} twin: output")
    rel = rel_max(got, want)
    check(rel < LM_TWIN_REL, f"{cfg.name} twin: card vs CPU {rel}")
    same_dispatch(card_routes, cpu_routes, f"{cfg.name} twin")
    out = dict(layers=LM_TWIN_LAYERS, shape=list(LM_TWIN_SHAPE),
               dtype="float32", init_and_copy_s=init_s, cpu_prefill_s=cpu_s,
               rel_err=rel, tolerance=LM_TWIN_REL)
    if pattern or redrawn:
        out.update(kinds=lm.layer_kinds(twin), launches=launched,
                   redrawn=sorted(redrawn))
    if cfg.moe:
        out["moe_layers_routed_equal"] = len(card_routes)
    return out


def prompts(reqs, dev) -> dict:
    """A stream's same-length prompts as one token batch on ``dev``."""
    return {"tokens": torch.from_numpy(np.stack([r.prompt for r in reqs]))
            .long().to(dev)}


def layer0_attention(cfg, model, batch) -> tuple:
    """Layer 0's flash-kernel inputs for ``batch`` as the prefill hands
    them over: q (B, S, H, D), k and v (B, S, H_kv, D)."""
    L = lm_layers
    with torch.no_grad():
        S = lm.seq_len(batch)
        qpos = torch.arange(S, device=model["embed"]["table"].device)
        x = lm.embed_input(cfg, model, batch, qpos)
        h = L.apply_norm(cfg, model["blocks"][0]["norm1"], x)
        q, k, v = L.attn_qkv(cfg, model["blocks"][0]["attn"], h, qpos,
                             lm.layer_kinds(cfg)[0])
    B = q.shape[0]
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim).contiguous(),
            k.contiguous(), v.contiguous())


def phase_lm_serve(dev) -> tuple[dict, tuple]:
    """GLM-4-9B at its published widths and depth on the card: weights
    drawn on the card leaf by leaf, the two streams served through
    ``ServeEngine.run`` (the reference launcher's defaults, and 4 prompts
    of 4096 tokens), decode against the full forward, the decode step's
    profile, and the float32 twin against the CPU.  Returns the stream
    run's launch counts and layer 0's flash inputs of stream (b)."""
    t_phase = time.perf_counter()
    cfg = lm_configs.get_arch(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, dtype=torch.bfloat16, device=dev,
                           seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(),
          f"lm_serve: {n_params} parameters, config {cfg.param_count()}")
    streams, reqs = {}, {}
    reset_launch_counts()
    for i, (what, spec, want) in enumerate(LM_STREAMS):
        reqs[what], streams[what] = lm_stream(cfg, model, spec, want,
                                              LM_SEED + i, what)
    counts = launch_counts()
    check(counts["flash_attention_kernel"] == cfg.num_layers * sum(
        s["schedule"]["rounds"] for s in streams.values()),
        f"lm_serve launches {counts}")
    check(all(n == 0 for k, n in counts.items()
              if k != "flash_attention_kernel"),
          f"lm_serve: other kernels launched {counts}")
    max_mem = torch.cuda.max_memory_allocated()
    (_, spec_a, _) = LM_STREAMS[0]
    profile_a = lm_decode_profile(cfg, model, dev,
                                  max(streams["a"]["schedule"]["batch_hist"]),
                                  spec_a["prompt_len"], spec_a["max_seq"])
    decode = lm_decode_vs_full(cfg, model, dev)
    attn_in = layer0_attention(cfg, model, prompts(reqs["b"], dev))
    del model, reqs
    torch.cuda.empty_cache()
    twin = lm_twin(cfg, dev)
    torch.cuda.empty_cache()
    emit("lm_serve", arch=LM_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.head_dim],
         kv_heads=cfg.num_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         params=n_params, dtype="bfloat16", init_s=init_s,
         streams=streams, launches=counts, max_memory_allocated=max_mem,
         decode_profile=profile_a, decode_vs_full=decode,
         float32_twin=twin,
         card=torch.cuda.get_device_name(0),
         phase_s=time.perf_counter() - t_phase)
    return counts, attn_in


def moe_input(cfg, model, dev, reqs) -> torch.Tensor:
    """Layer 0's MoE input (norm2 of the residual after attention) in
    ``reqs``' prefill: (B, S, d) bf16."""
    L = lm_layers
    batch = prompts(reqs, dev)
    blk = model["blocks"][0]
    with torch.no_grad():
        qpos = torch.arange(batch["tokens"].shape[1], device=dev)
        x = lm.embed_input(cfg, model, batch, qpos)
        a, _ = L.attn_apply(cfg, blk["attn"], L.apply_norm(
            cfg, blk["norm1"], x), qpos, kind=lm.layer_kinds(cfg)[0])
        return L.apply_norm(cfg, blk["norm2"], x + a)


def moe_vs_cpu(cfg, model, dev, h) -> dict:
    """Layer 0's MoE on ``h`` on the card and on the card machine's CPU:
    the routing of every token equal; the outputs of a call on the first
    MOE_CPU_TOKENS tokens (their own capacity) within MOE_OUT_REL; the
    share of (token, k) assignments dropped."""
    p = model["blocks"][0]["mlp"]
    p_cpu = {k: v.detach().cpu() for k, v in p.items()}
    with torch.no_grad():
        xt = h.reshape(-1, cfg.d_model)
        t0 = time.perf_counter()
        card = lm_moe.dispatch(cfg, p, xt)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = lm_moe.dispatch(cfg, p_cpu, xt.cpu())
        cpu_s = time.perf_counter() - t0
        same_dispatch([card], [cpu], f"{cfg.name} layer 0 prefill routing")
        x = h[:1, :MOE_CPU_TOKENS]
        with moe_dispatches() as got_r:
            got = lm_moe.moe_apply(cfg, p, x, aux=False)[0]
        with moe_dispatches() as want_r:
            want = lm_moe.moe_apply(cfg, p_cpu, x.cpu(), aux=False)[0]
    same_dispatch(got_r, want_r, f"{cfg.name} layer 0 routing, "
                  f"{MOE_CPU_TOKENS} tokens")
    rel = rel_max(got.cpu(), want)
    check(got.dtype == torch.bfloat16 and rel <= MOE_OUT_REL,
          f"{cfg.name}: MoE card vs CPU {rel}")
    return dict(tokens=xt.shape[0], capacity=card["C"],
                dropped_share=1.0 - float(card["keep"].float().mean()),
                routing_equal=True, card_dispatch_s=card_s,
                cpu_dispatch_s=cpu_s, output_tokens=MOE_CPU_TOKENS,
                output_capacity=got_r[0]["C"], output_rel_err=rel,
                output_limit=MOE_OUT_REL)


def moe_decode_drops(cfg, model, dev, batch: int, prompt: int,
                     max_seq: int) -> dict:
    """One decode step at ``batch`` after a prefill of ``prompt``: each
    MoE layer's capacity and share of assignments dropped."""
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (batch, prompt + 1))).to(dev)
    with torch.no_grad():
        _, caches = lm.prefill(cfg, model, {"tokens": toks[:, :prompt]},
                               max_seq)
        with moe_dispatches() as routes:
            lm.decode_step(cfg, model, caches, prompt,
                           {"tokens": toks[:, prompt:]})
    shares = [1.0 - float(r["keep"].float().mean()) for r in routes]
    return dict(batch=batch, capacity=routes[0]["C"],
                dropped_share_by_layer=shares,
                dropped_share_mean=float(np.mean(shares)))


def phase_lm_moe(dev) -> dict:
    """OLMoE-1B-7B at its published widths and depth on the card (6.92 B
    parameters drawn on the card, bf16): lm_serve's two streams through
    ``ServeEngine.run``, one flash launch a layer a prefill batch and no
    other hand kernel; layer 0's routing against the CPU's, the drop
    shares; decode against the full forward (the MoE's dense oracle)
    with two faults; the decode step's profile; the float32 twin.
    Returns the streams' launch counts."""
    t_phase = time.perf_counter()
    cfg = lm_configs.get_arch(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, dtype=torch.bfloat16, device=dev,
                           seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(),
          f"lm_moe: {n_params} parameters, config {cfg.param_count()}")
    streams, reqs = {}, {}
    reset_launch_counts()
    for i, (what, spec, want) in enumerate(LM_STREAMS):
        reqs[what], streams[what] = lm_stream(cfg, model, spec, want,
                                              LM_SEED + i, what)
    counts = launch_counts()
    check(counts["flash_attention_kernel"] == cfg.num_layers * sum(
        s["schedule"]["rounds"] for s in streams.values()),
        f"lm_moe launches {counts}")
    check(all(n == 0 for k, n in counts.items()
              if k != "flash_attention_kernel"),
          f"lm_moe: other kernels launched {counts}")
    max_mem = torch.cuda.max_memory_allocated()
    routing = moe_vs_cpu(cfg, model, dev,
                         moe_input(cfg, model, dev, reqs["b"]))
    (_, spec_a, _) = LM_STREAMS[0]
    width = max(streams["a"]["schedule"]["batch_hist"])
    drops = moe_decode_drops(cfg, model, dev, width, spec_a["prompt_len"],
                             spec_a["max_seq"])
    profile_a = lm_decode_profile(cfg, model, dev, width,
                                  spec_a["prompt_len"], spec_a["max_seq"])
    decode = lm_decode_vs_full(cfg, model, dev, faults=MOE_FAULTS,
                               moe_dense=True)
    del model, reqs
    torch.cuda.empty_cache()
    twin = lm_twin(cfg, dev)
    torch.cuda.empty_cache()
    emit("lm_moe", arch=MOE_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.head_dim],
         kv_heads=cfg.num_kv_heads, experts=[cfg.num_experts,
                                            cfg.experts_per_token],
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=n_params,
         active_params=cfg.active_param_count(), dtype="bfloat16",
         init_s=init_s, streams=streams, launches=counts,
         max_memory_allocated=max_mem, prefill_routing_vs_cpu=routing,
         decode_drops=drops, decode_profile=profile_a,
         decode_vs_full=decode, float32_twin=twin,
         card=torch.cuda.get_device_name(0),
         phase_s=time.perf_counter() - t_phase)
    return counts


def zoo_arch(arch: str, layers: int, dev, seed: int) -> tuple:
    """One arch of lm_zoo: (its report, its launch counts, layer 0's
    flash inputs of its prefill batch)."""
    cfg = dataclasses.replace(lm_configs.get_arch(arch), num_layers=layers)
    t0 = time.perf_counter()
    model = lm.init_params(cfg, dtype=torch.bfloat16, device=dev, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = ZOO_PREFILL
    batch = lm_batch(cfg, dev, (B, S), seed)
    frames = lm_batch(cfg, dev, (B, ZOO_DECODE_STEPS), seed + 1)
    heads = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    reset_launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = lm.prefill(cfg, model, batch, S + ZOO_DECODE_STEPS)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        check(tuple(logits.shape) == (B, 1) + heads + (cfg.vocab_size,)
              and bool(torch.isfinite(logits.float()).all()),
              f"lm_zoo {arch}: prefill logits {tuple(logits.shape)}")
        ring = None
        if arch == "gemma3-27b":
            # layer 0's ring after the prefill: positions S-1024 .. S-1 at
            # slots pos mod 1024, the full forward's own k and v
            _, k, v = lm_layers.attn_qkv(
                cfg, model["blocks"][0]["attn"], lm_layers.apply_norm(
                    cfg, model["blocks"][0]["norm1"], lm.embed_input(
                        cfg, model, batch, torch.arange(S, device=dev))),
                torch.arange(S, device=dev), "local")
            w = cfg.window_size
            pos = torch.arange(S - w, S, device=dev)
            check(caches[0]["k"].shape[1] == w
                  and torch.equal(caches[0]["k"][:, pos % w], k[:, pos])
                  and torch.equal(caches[0]["v"][:, pos % w], v[:, pos]),
                  f"lm_zoo {arch}: layer 0's ring after {S} positions")
            ring = dict(window=w, positions=[S - w, S - 1], equal=True)
            del k, v
        step_ms = []
        nxt = logits
        for t in range(ZOO_DECODE_STEPS):
            one = (lm_cut(frames, t, t + 1) if "frames" in frames else
                   {"tokens": nxt[:, -1].argmax(-1)[:, None]})
            t0 = time.perf_counter()
            nxt, caches = lm.decode_step(cfg, model, caches, S + t, one)
            nxt.float().sum().item()                 # read back, as served
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(nxt.float()).all()),
              f"lm_zoo {arch}: decode logits")
    counts = launch_counts()
    check(counts["flash_attention_kernel"] == layers
          and all(n == 0 for k, n in counts.items()
                  if k != "flash_attention_kernel"),
          f"lm_zoo {arch}: launches {counts}")
    del caches
    attn_in = layer0_attention(cfg, model, batch)
    gates = {"decode_vs_full": lm_decode_vs_full(
        cfg, model, dev, faults=ZOO_FAULTS, moe_dense=cfg.moe)}
    if arch == "gemma3-27b":
        gates["ring_wrap"] = lm_decode_vs_full(
            cfg, model, dev, faults=("ring_slot",), sizes=GEMMA_RING_CHECK)
    params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    report = dict(layers=[layers, lm_configs.get_arch(arch).num_layers],
                  d_model=cfg.d_model, heads=[cfg.num_heads, cfg.head_dim],
                  kv_heads=cfg.num_kv_heads, d_ff=cfg.d_ff,
                  vocab=cfg.vocab_size, params=params, init_s=init_s,
                  prefill=list(ZOO_PREFILL), prefill_ms=prefill_ms,
                  decode_ms=step_ms, logits=list(nxt.shape), ring=ring,
                  launches=counts, **gates)
    return report, counts, attn_in


def phase_lm_zoo(dev) -> tuple[dict, dict]:
    """The other attention archs at published widths (ZOO's depths), one
    after another, each freed before the next is drawn.  Returns the
    summed launch counts of their prefill and decode runs, and layer 0's
    flash inputs of Gemma-3's (local, window 1024) and MusicGen's (D 64)
    prefill batches."""
    t_phase = time.perf_counter()
    archs, total, attn = {}, {}, {}
    for i, (arch, layers) in enumerate(ZOO):
        archs[arch], counts, attn_in = zoo_arch(arch, layers, dev,
                                                LM_SEED + i)
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        if arch == "gemma3-27b":
            attn["window"] = (attn_in, lm_configs.get_arch(arch).window_size)
        elif arch == "musicgen-large":
            attn["musicgen"] = (attn_in, 0)
        else:
            del attn_in
    emit("lm_zoo", archs=archs, launches=total,
         card=torch.cuda.get_device_name(0),
         phase_s=time.perf_counter() - t_phase)
    return total, attn


def pspec_count(cfg) -> int:
    """The parameters of ``cfg``'s tree (the reference's tree, leaf for
    leaf: tests/test_torch_lm.py), every leaf counted (``param_count``
    leaves out LayerNorm biases and RWKV-6's ``ln0``)."""
    def walk(node):
        if isinstance(node, lm_layers.PSpec):
            return int(np.prod(node.shape))
        items = node.values() if isinstance(node, dict) else node
        return sum(walk(x) for x in items)
    return walk(lm.model_pspecs(cfg))


def redraw_recurrent(model, seed: int) -> dict:
    """Redraw ``model``'s RECURRENT_REDRAW leaves (the recurrent blocks'
    zero-initialised leaves and lam) in place, on the model's device from
    a generator seeded with ``seed``, in float32 and then the leaf's
    dtype.  Returns each leaf name's law and the elements redrawn."""
    dev = model["embed"]["table"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    drawn = {}
    for block in model["blocks"]:
        for sub in ("rec", "tmix", "cmix"):
            if sub not in block:
                continue
            for name, prm in block[sub].items():
                if name not in RECURRENT_REDRAW:
                    continue
                law, *arg = RECURRENT_REDRAW[name]
                x = torch.empty(prm.shape, dtype=torch.float32, device=dev)
                if law == "normal":
                    x.normal_(0.0, arg[0], generator=gen)
                else:
                    x.uniform_(arg[0], arg[1], generator=gen)
                if law == "decay":    # lam of a decay a at a saturated gate
                    x = torch.log(torch.expm1(-torch.log(x) / 8.0))
                with torch.no_grad():
                    prm.copy_(x.to(prm.dtype))
                entry = drawn.setdefault(name, [law, *arg, 0])
                entry[-1] += x.numel()
    return drawn


@contextlib.contextmanager
def first_calls(module, name: str):
    """Record the arguments of ``module.name``'s first call with S > 1
    (a prefill) and its first with S = 1 (a decode step), keyed
    "prefill" and "decode"; S is dim 1 of the first argument."""
    orig, seen = getattr(module, name), {}

    def recording(*args, **kw):
        key = "decode" if args[0].shape[1] == 1 else "prefill"
        seen.setdefault(key, args)
        return orig(*args, **kw)
    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def seq_cache_bytes(cfg, positions: int) -> int:
    """The cache bytes one sequence holds after ``positions`` positions
    (its caches sized to hold them: ``init_cache`` at max_seq =
    ``positions``), bf16 activations."""
    return tree_bytes(lm.init_cache(cfg, 1, positions, device="cpu"))


def recurrent_arch(arch: str, dev, seed: int) -> tuple:
    """One arch of lm_recurrent at published widths and full depth: (its
    report, the launch counts of its two streams, the kernels' inputs at
    its prefill and decode shapes)."""
    cfg = lm_configs.get_arch(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, dtype=torch.bfloat16, device=dev, seed=seed)
    redrawn = redraw_recurrent(model, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == pspec_count(cfg),
          f"lm_recurrent {arch}: {n_params} parameters, tree "
          f"{pspec_count(cfg)}")
    want = RECURRENT_PREFILL[arch]
    streams, reqs = {}, {}
    reset_launch_counts()
    for i, (what, spec, sched) in enumerate(LM_STREAMS):
        reqs[what], streams[what] = lm_stream(cfg, model, spec, sched,
                                              seed + i, what,
                                              per_prefill=want)
    counts = launch_counts()
    wkv_routes = dict(wkv6.route_launches)
    check_launched(counts, [k for k, n in want.items() if n],
                   f"lm_recurrent {arch}")
    # RWKV-6's prefills of 4096 take the chunked kernel, its 16-token
    # prompts and decode steps the sequential one
    check(all(wkv_routes.values()) if want["wkv6"] else
          not any(wkv_routes.values()),
          f"lm_recurrent {arch}: wkv6 routes {wkv_routes}")
    check(all(n == 0 for k, n in counts.items()
              if not want.get(k)), f"lm_recurrent {arch}: {counts}")
    max_mem = torch.cuda.max_memory_allocated()
    # the cache a sequence holds: O(1) for RWKV-6, capped by the ring of
    # the local layers (and O(1) in the rglru layers) for RecurrentGemma
    cache_bytes = {n: seq_cache_bytes(cfg, n) for n in (16, 4096)}
    if cfg.window_size:
        check(cache_bytes[4096] == seq_cache_bytes(cfg, cfg.window_size)
              == seq_cache_bytes(cfg, 4 * cfg.window_size)
              and cache_bytes[16] <= cache_bytes[4096],
              f"lm_recurrent {arch}: cache bytes {cache_bytes}")
    else:
        check(cache_bytes[16] == cache_bytes[4096],
              f"lm_recurrent {arch}: cache bytes {cache_bytes}")
    (_, spec_a, _) = LM_STREAMS[0]
    profile_a = lm_decode_profile(cfg, model, dev,
                                  max(streams["a"]["schedule"]["batch_hist"]),
                                  spec_a["prompt_len"], spec_a["max_seq"])
    gates = {"decode_vs_full": lm_decode_vs_full(
        cfg, model, dev, faults=RECURRENT_FAULTS[arch])}
    if cfg.window_size:
        gates["ring_wrap"] = lm_decode_vs_full(
            cfg, model, dev, faults=("ring_slot",), sizes=RG_RING_CHECK)
    # the kernels' own inputs: stream b's prefill (its first local layer's
    # flash input, layer 0's recurrence) and a decode step after it
    batch = prompts(reqs["b"], dev)
    S = lm.seq_len(batch)
    del reqs
    with torch.no_grad(), \
            first_calls(lm_layers, "flash_attention_kernel") as fl, \
            first_calls(lm_rglru, "linear_scan") as ls, \
            first_calls(lm_rwkv, "wkv6") as wk:
        logits, caches = lm.prefill(cfg, model, batch, S + 1)
        lm.decode_step(cfg, model, caches, S,
                       {"tokens": logits[:, -1].argmax(-1)[:, None]})
    del caches
    inputs = {"flash": fl.get("prefill"), "linear_scan": ls or None,
              "wkv6": wk or None}
    report = dict(
        layers=cfg.num_layers, kinds={k: lm.layer_kinds(cfg).count(k)
                                      for k in set(cfg.layer_pattern)},
        d_model=cfg.d_model, heads=[cfg.num_heads, cfg.head_dim],
        kv_heads=cfg.num_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        window=cfg.window_size, params=n_params,
        param_count=cfg.param_count(), tree_params=pspec_count(cfg),
        redrawn=redrawn, dtype="bfloat16", init_s=init_s, streams=streams,
        launches=counts, wkv6_route_launches=wkv_routes,
        max_memory_allocated=max_mem,
        cache_bytes_per_sequence=cache_bytes, decode_profile=profile_a,
        **gates)
    del model
    torch.cuda.empty_cache()
    report["float32_twin"] = lm_twin(cfg, dev, RECURRENT_TWIN.get(arch))
    torch.cuda.empty_cache()
    return report, counts, inputs


def phase_lm_recurrent(dev) -> tuple[dict, dict]:
    """RecurrentGemma-2B and RWKV-6-1.6B at published widths and full
    depth, one after the other, each freed before the next is drawn.
    Returns the summed launch counts of their streams, and the kernels'
    inputs: RecurrentGemma's first local layer's flash input (D 256,
    window 2048) and each recurrence kernel's prefill and decode
    arguments."""
    t_phase = time.perf_counter()
    archs, total, inputs = {}, {}, {}
    for i, arch in enumerate(RECURRENT_ARCHS):
        archs[arch], counts, ins = recurrent_arch(arch, dev, LM_SEED + i)
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        inputs.update({k: v for k, v in ins.items() if v})
    emit("lm_recurrent", archs=archs, launches=total,
         card=torch.cuda.get_device_name(0),
         phase_s=time.perf_counter() - t_phase)
    return total, inputs


def phase_dnn(dev) -> dict:
    reset_launch_counts()
    got = tiled_dnn_workload(device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = tiled_dnn_workload(device="cpu")
    check(got["n_frames_out"] == want["n_frames_out"] == 4,
          f"dnn frames out {got['n_frames_out']}")
    check(got["latency_s"] == want["latency_s"], "dnn latency differs")
    compare_records(got["recs"], want["recs"], "dnn card vs CPU")
    emit("dnn_pipeline", pes=got["n_pes_used"], mesh=got["mesh"],
         frames_out=got["n_frames_out"], latency_s=got["latency_s"],
         compute_s=got["compute_s"], noc_s=got["noc_s"],
         ticks=int(got["recs"]["pl"].shape[0]), launches=counts,
         records_vs_cpu="bitwise")
    return counts


def phase_parity(dev) -> None:
    graph = synfire_graph(PARITY_PES, noise_model="shot", device="cpu")
    prog = compile(graph)
    gpu_sim = ChipSim(prog, device=dev)
    check(gpu_sim.use_sparse_noc(), "256-PE ring must use the sparse NoC")
    got = gpu_sim.run(PARITY_TICKS)
    want = ChipSim(prog, device="cpu").run(PARITY_TICKS)
    worst = compare_records(got, want, "parity card vs CPU")
    first = first_strong_ticks(got, 10)
    check(all(abs(f - 10 * p) <= 1 for p, f in enumerate(first)),
          f"parity ring wave: {first}")
    emit("card_vs_cpu_256pe", ticks=PARITY_TICKS, records=len(want),
         exec_mode="event" if gpu_sim.use_event_mode() else "dense",
         integer_records="bitwise", energy_max_rel_err=worst,
         first_strong_ticks=first)


def run_bench(bench, dev) -> tuple[list, dict, float]:
    """Run a ``repro_torch.bench`` module's ``main`` on the card with its
    CSV rows captured; returns the rows, the launch counts of the run and
    its wall seconds."""
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = bench.main(device=dev)
    torch.cuda.synchronize()
    return rows, launch_counts(), time.perf_counter() - t0


def csv_rows(rows: list) -> list:
    return [f"{r['name']},{r['us_per_call']:.1f},{r['derived']}"
            for r in rows]


def phase_mac_efficiency(dev) -> dict:
    """Fig. 14/15 through the port's bench module."""
    rows, counts, run_s = run_bench(mac_efficiency, dev)
    check_launched(counts, ("mac_gemm",), "mac_efficiency")
    fig15 = [r for r in rows if "within10pct" in r["values"]]
    check(len(fig15) == 3 and all(r["values"]["within10pct"] for r in fig15),
          f"Fig. 15 model outside 10 %: {csv_rows(fig15)}")
    emit("mac_efficiency", launches=counts, run_s=run_s,
         rows=csv_rows(rows), fig15_vs_plain="bitwise")
    return counts


def phase_dnn_layers(dev) -> dict:
    """Fig. 22/23 through the port's bench module, every layer at its
    full published size."""
    rows, counts, run_s = run_bench(dnn_layers, dev)
    check_launched(counts, ("mac_conv2d", "mac_gemm"), "dnn_layers")
    check(len(rows) == 2 * len(dnn_layers.LAYERS),
          f"dnn_layers: {len(rows)} rows")
    for (name, kind, g), row in zip(dnn_layers.LAYERS, rows[::2]):
        full = ([[1, g["h"], g["w"], g["cin"]],
                 [g["kh"], g["kw"], g["cin"], g["cout"]]] if kind == "conv"
                else [[g["m"], g["k"]], [g["k"], g["n"]]])
        check(row["values"]["shapes"] == full,
              f"{name} ran at {row['values']['shapes']}, not {full}")
    for row in rows:
        lo, hi = row["values"]["speedup_band"]
        check(lo <= row["values"]["speedup"] <= hi,
              f"{row['name']}: speedup outside its band")
    emit("dnn_layers", launches=counts, run_s=run_s, rows=csv_rows(rows),
         layers_vs_plain="bitwise, full size")
    return counts


def phase_elementary(dev) -> tuple[dict, tuple]:
    """fx_log and fx_log_float over 2^20 values: bitwise against the
    plain version, and the reference's accuracy bands."""
    gen = np.random.default_rng(13)
    edge = np.array([-2**31, -5, -1, 0, 1, 2, FX_ONE - 1, FX_ONE,
                     FX_ONE + 1, 2**31 - 1] + [2**k for k in range(31)])
    x = np.concatenate([edge, gen.integers(-2**31, 2**31,
                                           LOG_SAMPLE - edge.size)])
    x = torch.from_numpy(x.astype(np.int32)).to(dev)
    xf32 = gen.uniform(1e-2, 6e4, LOG_SAMPLE).astype(np.float32)
    xf = torch.from_numpy(xf32).to(dev)
    flags = torch.tensor([-5, 0, 1, FX_ONE], dtype=torch.int32, device=dev)
    reset_launch_counts()
    got, got_f, got_flags = fx_log(x), fx_log_float(xf), fx_log(flags)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["fx_log"] == 3, f"elementary launches {counts}")
    want = fx_log_ref(x)
    check(torch.equal(got, want), "fx_log != plain version")
    want_f = from_fx(fx_log_ref(torch.round(xf * FX_ONE).to(torch.int32)))
    check(torch.equal(got_f, want_f), "fx_log_float != plain version")
    err = float(np.max(np.abs(got_f.cpu().numpy().astype(np.float64) - np.log(
        np.round(xf32 * FX_ONE) / FX_ONE))))
    check(err < 3e-4, f"fx_log_float: max |err| {err} vs ln")
    fl = got_flags.cpu().tolist()
    check(fl[0] < -(2**29) and fl[1] < -(2**29) and abs(fl[3]) <= 1,
          f"fx_log flags {fl}")
    emit("elementary", launches=counts, values=LOG_SAMPLE,
         vs_plain="bitwise", log_max_abs_err_vs_ln=err, flags=fl)
    return counts, (x, got, want)


def attention_inputs(dev, s, dtype, seed):
    """q, k, v (1, s, 32, 128) standard normal from a seeded generator
    on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((1, s, ATTN_H, ATTN_D), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype) for _ in range(3)]


def attention_plain(q, k, v, causal=True, window=0):
    """The plain version on the op's layout: q (B, S, H, D), k and v
    (B, S, H_kv, D), expanded to the H query heads first."""
    B, S, H, D = q.shape
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    return flash_attention_ref(fold(q), fold(k), fold(v), causal=causal,
                               window=window
                               ).reshape(B, H, S, D).transpose(1, 2)


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal prefill of S scores, within ``window``
    keys of each query (0: no window)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def phase_attention(dev) -> tuple[dict, dict]:
    """The GLM-4-9B-shaped causal prefill in bfloat16, and float32 at
    S = 1024, through flash_attention_kernel against its plain version."""
    ins = {torch.bfloat16: attention_inputs(dev, ATTN_S, torch.bfloat16, 0),
           torch.float32: attention_inputs(dev, ATTN_F32_S, torch.float32,
                                           1)}
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = {dt: flash_attention_kernel(*qkv) for dt, qkv in ins.items()}
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["flash_attention_kernel"] == 2, f"attention {counts}")
    errs, shares, wants = {}, {}, {}
    for dt, qkv in ins.items():
        got = outs[dt]
        want = wants[dt] = attention_plain(*qkv)
        atol, rtol = ATTN_TOL[dt]
        check(got.dtype == dt and got.shape == qkv[0].shape
              and bool(torch.isfinite(got).all()), f"attention {dt} output")
        errs[str(dt)] = max_abs_err(got, want)
        check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
              f"attention {dt}: max abs err {errs[str(dt)]}")
        shares[str(dt)] = float(((got.float() - want.float()).abs() / (
            atol + rtol * want.float().abs())).max())
    emit("attention", launches=counts, run_s=run_s,
         shapes={"bfloat16": [1, ATTN_S, ATTN_H, ATTN_D],
                 "float32": [1, ATTN_F32_S, ATTN_H, ATTN_D]},
         causal=True, max_abs_err=errs,
         tolerance={str(dt): tol for dt, tol in ATTN_TOL.items()},
         limit_share=shares)
    return counts, {dt: (ins[dt], outs[dt], wants[dt]) for dt in ins}


def lse_case(flush, qkv) -> dict:
    """The forward writing its log-sum-exp (as training calls it) on
    ``qkv``: the lse against the plain version's, the output bit for bit
    the call's without lse, and the cold device time with and without."""
    q, k, v = qkv
    B, S, H, D = q.shape
    out, lse = flash_ops._forward(q, k, v, True, 0, True)
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    _, want = flash_attention_ref(fold(q), fold(k), fold(v), return_lse=True)
    err = max_abs_err(lse.reshape(B * H, S), want)
    check(err <= LSE_TOL, f"flash lse: max abs err {err} > {LSE_TOL}")
    check(torch.equal(out, flash_attention_kernel(q, k, v)),
          "flash: the output with lse differs from the call without")
    del want, out, lse
    return dict(max_abs_err=err, tolerance=LSE_TOL, dtype=str(q.dtype),
                ms_with_lse=cuda_ms(
                    lambda: flash_ops._forward(q, k, v, True, 0, True), 10,
                    flush),
                ms_without_lse=cuda_ms(
                    lambda: flash_attention_kernel(q, k, v), 10, flush))


def phase_accel_kernels(dev, log: tuple, attn: dict, lm_attn: tuple,
                        zoo_attn: dict, rec_in: dict) -> list:
    """The kernel rows of phases 12-14 at their paths' shapes: mac_conv2d
    at VGG-16 conv3 (and batch 32 of it), fx_log at phase 13's 2^20
    values, flash_attention_kernel at phase 16's LM prefill (layer 0 of
    stream (b): (4, 4096, 32, 128) bf16; and phase 14's batch 1 and its
    float32 S = 1024, and lm_zoo's layer 0 inputs: Gemma-3's local layer,
    window 1024, and MusicGen's D = 64); ``log`` and ``attn`` are phases
    13 and 14's inputs, outputs and plain outputs, ``lm_attn`` phase 16's
    q, k, v, ``zoo_attn`` lm_zoo's ((q, k, v), window), ``rec_in``
    lm_recurrent's kernel inputs (``phase_lm_recurrent``)."""
    flush = l2_flusher(dev)
    rows = []

    # mac_conv2d at the Fig. 22/23 path's layers: VGG-16 conv3 (and batch
    # 32 of it) and, as other shapes, ResNet-50's 3x3 (Cout 64) and
    # MobileNetV2's 1x1 (Cin 24: the dp4a route); library: im2col
    # (Tensor.unfold + a copy) then torch._int_mm, two calls.  Each row
    # also times the route its shape does not take (``other_kernel_ms``):
    # dp4a, or for Cin % 16 != 0 the wgmma kernel on x and w with Cin
    # zero-padded to a multiple of 16 (the same sums)
    def conv_operands(name):
        layer = next(g for n, _, g in dnn_layers.LAYERS if n == name)
        return [torch.from_numpy(t).to(dev)
                for t in dnn_layers.layer_operands("conv", layer, False)]

    def other_route(xx, w):
        """(kernel, call) of the route mac_conv2d(xx, w) does not take."""
        if conv_route(xx, w) == "wgmma":
            out = torch.empty_like(mac_conv2d(xx, w))
            return "dp4a", lambda: conv_launch(xx, w, out, (1, 1), 0, 0,
                                               "dp4a")
        pad = -w.shape[2] % 16
        xp = torch.nn.functional.pad(xx, (0, pad)).contiguous()
        wp = torch.nn.functional.pad(w, (0, 0, 0, pad)).contiguous()
        check(torch.equal(mac_conv2d(xp, wp), mac_conv2d_ref(xx, w)),
              "mac_conv2d: Cin-padded wgmma route")
        return "wgmma (Cin zero-padded to 16 k)", lambda: mac_conv2d(xp, wp)

    def conv_row(rows, xx, w, iters, plain_iters, prof_iters=20, **extra):
        KH, KW, Cin, Cout = w.shape
        w_cm = w.reshape(-1, Cout).t().contiguous().t()   # column-major

        def im2col_int_mm():
            cols = xx.unfold(1, KH, 1).unfold(2, KW, 1)   # B,Ho,Wo,C,KH,KW
            return torch._int_mm(cols.permute(0, 1, 2, 4, 5, 3).reshape(
                -1, KH * KW * Cin), w_cm)
        got, want = mac_conv2d(xx, w), mac_conv2d_ref(xx, w)
        check(torch.equal(im2col_int_mm(), want.reshape(-1, Cout)),
              "mac_conv2d: library call")
        other, other_call = other_route(xx, w)
        m, k = got.numel() // Cout, KH * KW * Cin
        kernel_row(
            rows, flush, "mac_conv2d", "src/repro_torch/csrc/mac_conv.cu",
            "src/repro/kernels/mac_conv/mac_conv.py:27",
            lambda: mac_conv2d(xx, w), lambda: mac_conv2d_ref(xx, w), got,
            want, xx.numel() + w.numel() + got.numel() * 4, 2 * m * Cout * k,
            iters, plain_iters, library=im2col_int_mm,
            ops_per_s=INT8_TENSOR_OPS_PER_S, prof_iters=prof_iters,
            shape={"x": list(xx.shape), "w": list(w.shape),
                   "padding": "VALID"},
            conv_kernel=conv_route(xx, w), other_kernel=other,
            other_kernel_ms=kernel_device_ms("mac_conv2d", other_call,
                                            prof_iters, flush),
            library_call="Tensor.unfold + copy, torch._int_mm (two calls)",
            **extra)
        return rows[-1]
    gen = np.random.default_rng(17)
    x, w = conv_operands("vgg16_conv3_256")
    xb = torch.from_numpy(gen.integers(-128, 128, (CONV_BATCH,) + tuple(
        x.shape[1:]), np.int64).astype(np.int8)).to(dev)
    other = [conv_row([], xb, w, 5, 3, 5, shape_tag=f"batch {CONV_BATCH}")]
    del xb
    for name in ("resnet50_3x3_b2", "mobilenetv2_pw"):
        other.append(conv_row([], *conv_operands(name), 100, 20,
                              shape_tag=f"Fig. 22/23 {name}"))
    conv_row(rows, x, w, 200, 20, main_path="Fig. 22/23 vgg16_conv3_256",
             other_shapes=other)

    # every Fig. 22/23 conv layer through both kernels, cold (L2
    # flushed): the route each takes must be the faster one
    layers = []
    for name, kind, _ in dnn_layers.LAYERS:
        if kind != "conv":
            continue
        xx, ww = conv_operands(name)
        other, other_call = other_route(xx, ww)
        layers.append(dict(
            layer=name, conv_kernel=conv_route(xx, ww),
            ms=kernel_device_ms("mac_conv2d", lambda: mac_conv2d(xx, ww),
                                20, flush),
            other_kernel=other,
            other_kernel_ms=kernel_device_ms("mac_conv2d", other_call, 20,
                                            flush)))
    emit("conv_routes", layers=layers)

    # fx_log over the elementary path's 2^20 values
    log_x, log_got, log_want = log
    n = log_x.numel()
    kernel_row(rows, flush, "fx_log", "src/repro_torch/csrc/explog.cu",
               "src/repro/kernels/explog/explog.py:46",
               lambda: fx_log(log_x), lambda: fx_log_ref(log_x), log_got,
               log_want, 8 * n, 80 * n, 200, 20,
               ops_per_s=RATES["int"], elements=n,
               main_path="elementary (fx_log op)")

    # flash attention at the GLM-4-9B prefill (bf16), then float32 S=1024;
    # library: scaled_dot_product_attention on the (B, H, S, D) views,
    # causal, or with the window's band as a boolean attn_mask, with its
    # own grouping of the query heads over fewer K and V heads
    def sdpa(q, k, v, mask=None):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=mask is None,
            enable_gqa=k.shape[2] != q.shape[2]).transpose(1, 2)

    def attn_row(rows, entry, ops_per_s, iters, tol=None, window=0,
                 **extra):
        """The flash row on ``entry``'s inputs; the bound counts the
        scores the band keeps (two products of 2 D operations a score)
        and the bytes of q, k and v at their own head counts and of the
        output."""
        (q, k, v), got, want = entry
        B, S, H, D = q.shape
        mask = None
        if window:
            i = torch.arange(S, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
        lib = lambda: sdpa(q, k, v, mask)
        lib_kernels = device_kernels(lib, 3)[0]
        kernel_row(
            rows, flush, "flash_attention_kernel",
            "src/repro_torch/csrc/flash_attn.cu",
            "src/repro/kernels/flash_attn/flash_attn.py:32",
            lambda: flash_attention_kernel(q, k, v, window=window),
            lambda: attention_plain(q, k, v, window=window), got, want,
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            4 * band_pairs(S, window) * D * H * B, iters,
            3, library=lib, ops_per_s=ops_per_s,
            tol=tol or ATTN_TOL[q.dtype], prof_iters=5, shape=list(q.shape),
            dtype=str(q.dtype).removeprefix("torch."), causal=True,
            window=window,
            library_call=("scaled_dot_product_attention(attn_mask=band)"
                          if window else
                          "scaled_dot_product_attention(is_causal=True)"),
            library_kernels=sorted(lib_kernels, key=lambda n:
                                   -lib_kernels[n][1])[:3],
            **extra)
        return rows[-1]
    # float32: the CUDA cores' float32 bound, and beside it that of the
    # kernel's three TF32 products
    (q32, _, _), _, _ = attn[torch.float32]
    B, S, H, D = q32.shape
    at_f32 = attn_row([], attn[torch.float32], CUDA_CORE_OPS_PER_S, 10,
                      bound_ms_3xtf32=bound_ms(
                          4 * q32.numel() * 4, 3 * 2 * S * S * D * H * B,
                          TF32_TENSOR_OPS_PER_S)[0])
    at_b1 = attn_row([], attn[torch.bfloat16], BF16_TENSOR_OPS_PER_S, 5,
                     shape_tag="attention phase (batch 1)",
                     lse_case=lse_case(flush, attn[torch.bfloat16][0]))
    # the LM path's own input: layer 0 of stream (b)'s prefill.  The
    # kernel rounds p to bf16 before P V (as the reference's model
    # attention; l sums the float32 p) where the plain version keeps it
    # in float32, and each output is rounded to bf16 once.  With bf16's
    # unit roundoff 2^-8: |got - want| <= 2^-8 sum_k p_k |v_k| (the plain
    # version applied to |v|, in float32) + 2^-8 |got| + 2^-8 |want|; the
    # last term is taken as rtol 2^-7, whose other half covers float32's
    # order and ex2.approx (2^-22)
    def model_row(rows, qkv, window, **extra):
        """A row at a model's own layer-0 input, held at the per-element
        bound above."""
        lq, lk, lv = qkv
        lm_got = flash_attention_kernel(lq, lk, lv, window=window)
        lm_want = attention_plain(lq, lk, lv, window=window)
        lm_atol = 2.0 ** -8 * (attention_plain(lq.float(), lk.float(),
                                               lv.abs().float(),
                                               window=window)
                               + lm_got.float().abs())
        lm_tol = (lm_atol, 2.0 ** -7)
        share = lambda atol, rtol: float(((lm_got.float() - lm_want.float())
                                          .abs() / (atol + rtol * lm_want
                                                    .float().abs())).max())
        return attn_row(
            rows, (qkv, lm_got, lm_want), BF16_TENSOR_OPS_PER_S, 5,
            tol=lm_tol, window=window,
            tolerance_atol="2^-8 (sum_k p_k |v_k| + |got|)",
            limit_share=share(lm_atol, lm_tol[1]),
            # beside it, the share of atol 4e-3 with rtol 2^-6
            limit_share_4e3_2m6=share(4e-3, 2.0 ** -6), **extra)
    zoo_rows = []
    for key, what in (("window", "lm_zoo prefill (Gemma-3-27B layer 0, "
                                 "local, window 1024): row 8w"),
                      ("musicgen", "lm_zoo prefill (MusicGen-large layer 0, "
                                   "frames, D 64): row 8m")):
        qkv, window = zoo_attn[key]
        zoo_rows.append(model_row([], qkv, window, shape_tag=what))
    # RecurrentGemma-2B's first local layer (layer 2) in lm_recurrent's
    # prefill of stream b: D 256, 10 query heads over 1 KV head (K and V
    # as the prefill hands them over, unexpanded), window 2048; bf16 (the
    # warp-specialised TMA kernel) and the same input in float32 (the
    # 3xTF32 wgmma kernel; bound also at the three TF32 products)
    rg_cfg = lm_configs.get_arch("recurrentgemma-2b")
    rg_window = rg_cfg.window_size
    rq, rk, rv = rec_in.pop("flash")
    check(rk.shape[2] == rv.shape[2] == rg_cfg.num_kv_heads
          < rq.shape[2] == rg_cfg.num_heads,
          f"lm_recurrent: flash got K and V at {rk.shape[2]} heads, not "
          f"the model's {rg_cfg.num_kv_heads} KV heads")
    zoo_rows.append(model_row(
        [], (rq, rk, rv), rg_window,
        shape_tag="lm_recurrent prefill (RecurrentGemma-2B layer 2, local, "
                  "window 2048, D 256): row 8r"))
    qkv32 = tuple(t.float() for t in (rq, rk, rv))
    del rq, rk, rv
    got32 = flash_attention_kernel(*qkv32, window=rg_window)
    want32 = attention_plain(*qkv32, window=rg_window)
    B, S, H, D = qkv32[0].shape
    zoo_rows.append(attn_row(
        [], (qkv32, got32, want32), CUDA_CORE_OPS_PER_S, 3, window=rg_window,
        bound_ms_3xtf32=bound_ms(
            (2 * qkv32[0].numel() + qkv32[1].numel() + qkv32[2].numel()) * 4,
            3 * 4 * band_pairs(S, rg_window) * D * H * B,
            TF32_TENSOR_OPS_PER_S)[0],
        shape_tag="the same in float32 (flash_attn_tf32_d256_kernel): row "
                  "8r'"))
    del qkv32, got32, want32
    torch.cuda.empty_cache()
    model_row(rows, lm_attn, 0,
              main_path="lm_serve prefill (GLM-4-9B layer 0, stream b)",
              other_shapes=[at_b1, at_f32] + zoo_rows)

    # the recurrences at lm_recurrent's shapes, on their own arguments:
    # layer 0's in stream b's prefill (the main path's shape) and in the
    # decode step after it (S = 1); no library call computes them
    def scan_row(rows, args, iters, plain_iters, **extra):
        xi, xa, u, lam, h0 = args
        (y, hf), (y_ref, hf_ref) = linear_scan(*args), linear_scan_ref(*args)
        check(torch.allclose(hf, hf_ref, atol=1e-5, rtol=1e-5),
              f"linear_scan: h_final {max_abs_err(hf, hf_ref)}")
        B, S, W = u.shape
        kernel_row(
            rows, flush, "linear_scan", "src/repro_torch/csrc/linear_scan.cu",
            "src/repro/models/rglru.py:72 rg_lru (jax.lax.associative_scan; "
            "no Pallas kernel)", lambda: linear_scan(*args),
            lambda: linear_scan_ref(*args), y, y_ref,
            4 * (4 * B * S * W + W + 2 * B * W), SCAN_OPS * B * S * W, iters,
            plain_iters, tol=(1e-5, 1e-5), shape=[B, S, W],
            h_final_max_abs_err=max_abs_err(hf, hf_ref), **extra)
        return rows[-1]

    def wkv_row(rows, args, iters, plain_iters, **extra):
        r, k, v, lw, u, s0 = args
        (y, st), (y_ref, st_ref) = wkv6(*args), wkv6_ref(*args)
        B, S, H, D = r.shape
        which = wkv6_route(S, D)
        check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
              f"wkv6 ({which}): not finite")
        y_limit = WKV_Y_REL * float(y_ref.abs().max())
        st_limit = WKV_Y_REL * float(st_ref.abs().max())
        if which == "chunked":
            check(max_abs_err(st, st_ref) <= st_limit,
                  f"wkv6: state {max_abs_err(st, st_ref)} > {st_limit}")
        else:
            check(torch.allclose(st, st_ref, atol=1e-5, rtol=1e-5),
                  f"wkv6: state {max_abs_err(st, st_ref)}")
        n = B * S * H * D
        kernel_row(
            rows, flush, "wkv6", "src/repro_torch/csrc/wkv6.cu",
            "src/repro/models/rwkv6.py:102 wkv_chunked (einsums; no Pallas "
            "kernel)", lambda: wkv6(*args), lambda: wkv6_ref(*args), y,
            y_ref, 3 * n * r.element_size() + 8 * n + 4 * H * D
            + 8 * B * H * D * D, 5 * D * D * B * S * H, iters, plain_iters,
            tol=(y_limit, 0.0), shape=[B, S, H, D],
            dtype=str(r.dtype).removeprefix("torch."), wkv6_route=which,
            tolerance_atol=f"2^-16 of max |y| ({y_limit})",
            state_max_abs_err=max_abs_err(st, st_ref),
            state_tolerance=(f"2^-16 of max |state| ({st_limit})"
                             if which == "chunked" else "atol 1e-5 rtol 1e-5"),
            **extra)
        return rows[-1]
    ls, wk = rec_in["linear_scan"], rec_in["wkv6"]
    scan_row(rows, ls["prefill"], 20, 1,
             main_path="lm_recurrent prefill (RecurrentGemma-2B layer 0, "
                       "stream b)",
             other_shapes=[scan_row([], ls["decode"], 50, 5,
                                    shape_tag="decode step (S = 1)")])
    # the prefill input again with the strongest decays on the chunked
    # route: no overflow, the same limits
    r, k, v, lw, u, s0 = wk["prefill"]
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    strong = (r, k, v, -torch.exp(torch.empty_like(lw).uniform_(
        *WKV_STRONG_DECAY, generator=gen)), u, s0)
    wkv_row(rows, wk["prefill"], 20, 1,
            main_path="lm_recurrent prefill (RWKV-6-1.6B layer 0, stream b)",
            other_shapes=[wkv_row([], wk["decode"], 50, 5,
                                  shape_tag="decode step (S = 1)"),
                          wkv_row([], strong, 5, 1,
                                  shape_tag="the prefill input, log decays "
                                            "-exp(U(-8, 3))")])
    del strong
    return rows


# ------------------------------------------------------------- lm_train

@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def plain_flash(q, k, v, *, causal=True, window=0, **_):
    """flash_attention_kernel's plain version on card tensors, autograd
    through it: the gradient gate's truth."""
    return attention_plain(q, k, v, causal, window)


def bwd_dk_from_p(q, k, v, o, lse, do, *, causal=True, window=0):
    """A faulty backward: ``flash_attention_bwd_ref`` with dK taken from P
    (P^T Q) in place of dS."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    dq, _, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)
    s = qf @ kf.transpose(-1, -2) / float(np.sqrt(D))
    p = torch.where(keep_mask(S, causal, window, q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    dk = (p.transpose(-1, -2) @ qf).reshape(B, H // G, G, S, D).sum(2)
    return dq, dk.transpose(1, 2).to(k.dtype), dv


def train_faults(fault: str):
    """The backward that ``fault`` puts in flash_attention_bwd's place:
    the kernels with O zeroed (delta = 0: no delta term), or dK from P."""
    if fault == "no_delta":
        return lambda q, k, v, o, lse, do, **kw: flash_attention_bwd(
            q, k, v, torch.zeros_like(o), lse, do, **kw)
    return bwd_dk_from_p


def flash_backward(bwd):
    """FlashAttention's backward running ``bwd(q, k, v, o, lse, do,
    causal=, window=)`` in place of flash_attention_bwd, inside the
    block."""
    def backward(ctx, do):
        return (*bwd(*ctx.saved_tensors, do.contiguous(), causal=ctx.causal,
                     window=ctx.window), None, None)
    return patched(flash_ops.FlashAttention, "backward",
                   staticmethod(backward))


def train_split(cfg, params, opt, batch, dtype, ce_chunk: int) -> dict:
    """One more step in its three parts, each ending in a synchronize:
    the forward (``train_loss``), the backward and the AdamW update."""
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    loss, _ = lm.train_loss(cfg, params, batch, remat="full",
                            ce_chunk=ce_chunk, dtype=dtype)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    loss.backward()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    adamw_update(None, opt, params, AdamWConfig(lr=TRAIN_LR), lr=TRAIN_LR)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    for p in named_leaves(params).values():
        p.grad = None
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return dict(forward_ms=ms[0], backward_ms=ms[1], optimizer_ms=ms[2],
                step_ms=sum(ms))


def step_profile(fn) -> dict:
    """One call of ``fn`` (a train step) under the profiler: device busy
    ms, the idle share of its wall time (which the profiler slows), and
    the kernels that take the time."""
    kernels, wall_us = device_kernels(fn, 1)
    busy_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    flash = {name: sum(us for k, (_, us) in kernels.items()
                       if re.search(KERNEL_SYMBOLS[name], k)) / 1e3
             for name in ("flash_attention_kernel", "flash_attention_bwd")}
    return dict(launches=sum(n for n, _ in kernels.values()),
                busy_ms=busy_us / 1e3, wall_ms=wall_us / 1e3,
                idle_share=1.0 - busy_us / wall_us, flash_ms=flash,
                top_kernels=[dict(name=k[:120], launches=n, ms=us / 1e3)
                             for k, (n, us) in top])


def train_shape(cfg, dev, what: str, tmp: str) -> tuple[dict, tuple]:
    """``launch/train.py``'s main at ``TRAIN_SHAPES[what]`` on the card,
    then one split step and one profiled step on its final state.
    Returns the shape's record and the first flash backward's arguments
    (layer 0's, the last layer's gradient)."""
    batch, seq, steps = TRAIN_SHAPES[what]
    free_card()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with first_bwd() as seen:
        t0 = time.perf_counter()
        out = train_main([
            "--arch", TRAIN_ARCH, "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--lr", str(TRAIN_LR),
            "--ckpt-dir", f"{tmp}/{what}", "--ckpt-every", str(steps + 1),
            "--seed", str(TRAIN_SEED), "--log-every", "1"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    counts = launch_counts()
    max_mem = torch.cuda.max_memory_allocated()
    log = out["log"]
    losses = [r["loss"] for r in log]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"lm_train {what}: losses {losses}")
    L = cfg.num_layers
    per_call = bwd_call_launches(cfg, torch.bfloat16)
    check(counts["flash_attention_kernel"] == 2 * L * steps
          and counts["flash_attention_bwd"] == per_call * L * steps,
          f"lm_train {what}: flash launches {counts}")
    check(all(n == 0 for k, n in counts.items()
              if k not in ("flash_attention_kernel", "flash_attention_bwd")),
          f"lm_train {what}: other kernels launched {counts}")
    params, opt = out["state"]["params"], out["state"]["opt"]
    del out
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(),
          f"lm_train: {n_params} parameters, config {cfg.param_count()}")
    pipe = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=TRAIN_SEED), device=dev)
    ce_chunk = min(seq, 512)
    split = train_split(cfg, params, opt, pipe.batch(steps), torch.bfloat16,
                        ce_chunk)
    step_fn = make_train_step(cfg, opt=AdamWConfig(lr=TRAIN_LR),
                              ce_chunk=ce_chunk, total_steps=steps,
                              warmup_steps=10)
    prof_batch = pipe.batch(steps + 1)
    prof = step_profile(lambda: float(step_fn(params, opt, prof_batch,
                                              steps)[2]["loss"]))
    del params, opt, step_fn
    free_card()
    dts = [r["dt"] for r in log]
    steady = dts[1:] or dts
    return dict(batch=batch, seq=seq, steps=steps, losses=losses,
                step_ms=[d * 1e3 for d in dts],
                steady_step_ms=float(np.median(steady)) * 1e3,
                tokens_per_s=batch * seq / float(np.median(steady)),
                run_s=run_s, max_memory_allocated=max_mem,
                flash_forward_launches_per_step=(
                    counts["flash_attention_kernel"] / steps),
                flash_bwd_launches_per_step=(
                    counts["flash_attention_bwd"] / steps),
                split_step=split, profile=prof, launches=counts,
                params=n_params), seen.get("args")


@contextlib.contextmanager
def first_bwd():
    """Record (clones of) the first flash backward's arguments and
    keywords, as ``seen["args"]``, while the block runs."""
    seen = {}

    def recording(*args, **kw):
        if "args" not in seen:
            seen["args"] = (tuple(a.detach().clone() for a in args), kw)
        return flash_attention_bwd(*args, **kw)
    with flash_backward(recording):
        yield seen


def grads_of(cfg, model, batch, dtype) -> dict:
    """{leaf: gradient} of ``train_loss`` (remat "none")."""
    for p in model.parameters():
        p.grad = None
    loss, _ = lm.train_loss(cfg, model, batch, remat="none", ce_chunk=128,
                            dtype=dtype)
    loss.backward()
    out = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return out


def gradient_gate(dev) -> dict:
    """Qwen1.5-4B at full width, depth GATE_LAYERS, batch 1 x GATE_SEQ:
    the gradients with the kernels against flash's plain version on the
    card (the gate of GATE_BF16 / GATE_F32), and each fault of
    TRAIN_FAULTS failing it."""
    cfg = dataclasses.replace(lm_configs.get_arch(TRAIN_ARCH),
                              num_layers=GATE_LAYERS)
    model = lm.init_params(cfg, device=dev, seed=TRAIN_SEED + 1,
                           requires_grad=True)
    batch = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=GATE_SEQ, global_batch=1,
        seed=TRAIN_SEED + 1), device=dev).batch(0)
    plain = {}
    with patched(lm_layers, "flash_attention_kernel", plain_flash):
        for dt in (torch.bfloat16, torch.float32):
            plain[dt] = grads_of(cfg, model, batch, dt)
    # the plain bf16 run's distance from the plain float32 run, a leaf
    dist = {n: float((g - plain[torch.float32][n]).abs().max())
            for n, g in plain[torch.bfloat16].items()}
    limit = {torch.bfloat16: {
                 n: max(GATE_BF16 * d, GATE_BF16_ULP * float(
                     plain[torch.bfloat16][n].abs().max()))
                 for n, d in dist.items()},
             torch.float32: {n: GATE_F32 * float(g.abs().max())
                             for n, g in plain[torch.float32].items()}}

    def share(got, dt):
        """The worst leaf's error over its limit, and the leaf."""
        s = {n: float((g - plain[dt][n]).abs().max()) / limit[dt][n]
             for n, g in got.items()}
        worst = max(s, key=s.get)
        return s[worst], worst

    out = {"layers": GATE_LAYERS, "seq": GATE_SEQ,
           "bf16_limit": f"max({GATE_BF16} x |plain bf16 - plain f32|, "
                         f"{GATE_BF16_ULP} x max |leaf|), a leaf",
           "f32_limit": f"{GATE_F32} x max |leaf|"}
    for dt in (torch.bfloat16, torch.float32):
        key = str(dt).removeprefix("torch.")
        reset_launch_counts()
        sh, leaf = share(grads_of(cfg, model, batch, dt), dt)
        counts = launch_counts()
        check(counts["flash_attention_bwd"] ==
              bwd_call_launches(cfg, dt) * GATE_LAYERS,
              f"gradient gate {key}: launches {counts}")
        check(sh <= 1.0, f"gradient gate {key}: {leaf} at {sh} of its limit")
        faults = {}
        for fault in TRAIN_FAULTS:
            with flash_backward(train_faults(fault)):
                fsh, fleaf = share(grads_of(cfg, model, batch, dt), dt)
            check(fsh > 1.0, f"gradient gate {key}: fault {fault} passed "
                  f"({fleaf} at {fsh})")
            faults[fault] = dict(share=fsh, leaf=fleaf)
        out[key] = dict(share=sh, worst_leaf=leaf, faults=faults)
    del model, plain
    free_card()
    return out


def moe_train(dev) -> dict:
    """OLMoE-1B-7B at full width, MOE_TRAIN's layers, its steps at batch
    8 x 128: finite losses with the auxiliary losses in them, and each
    MoE layer's routing in the first step's forward equal to the CPU's
    on the same input."""
    arch, layers, steps = MOE_TRAIN
    cfg = dataclasses.replace(lm_configs.get_arch(arch), num_layers=layers)
    model = lm.init_params(cfg, device=dev, seed=TRAIN_SEED,
                           requires_grad=True)
    opt = adamw_init(model)
    pipe = SyntheticTokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
        seed=TRAIN_SEED), device=dev)
    step = make_train_step(cfg, opt=AdamWConfig(lr=TRAIN_LR), ce_chunk=128,
                           total_steps=steps, warmup_steps=10)
    calls = []
    orig = lm_moe.dispatch

    def recording(cfg_, p, xt, **kw):
        r = orig(cfg_, p, xt, **kw)
        if len(calls) < layers:          # the first step's forward
            calls.append(({"router": p["router"].detach().to(
                "cpu", copy=True)}, xt.detach().to("cpu", copy=True), r))
        return r
    metrics = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(lm_moe, "dispatch", recording):
        for s in range(steps):
            model, opt, m = step(model, opt, pipe.batch(s), s)
            metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          f"lm_train moe: metrics {metrics}")
    check(all(m["lb_loss"] > 0 and m["z_loss"] > 0 for m in metrics),
          f"lm_train moe: auxiliary losses {metrics}")
    check(counts["flash_attention_bwd"] ==
          bwd_call_launches(cfg, torch.bfloat16) * layers * steps,
          f"lm_train moe: launches {counts}")
    with torch.no_grad():
        cpu = [orig(cfg, p, xt) for p, xt, _ in calls]
    same_dispatch([r for _, _, r in calls], cpu,
                  f"{arch} first training step routing")
    del model, opt
    free_card()
    return dict(arch=arch, layers=layers, of_layers=lm_configs.get_arch(
        arch).num_layers, steps=steps, batch=8, seq=128, metrics=metrics,
        run_s=run_s, launches=counts, routing_equal_cpu=True,
        dropped_share=[1.0 - float(r["keep"].float().mean())
                       for _, _, r in calls])


def smoke_training(dev, tmp: str) -> dict:
    """The reference's training tests at their smoke widths, on the card:
    the loss falling (tests/test_integration_train.py:16), microbatching
    (:34), and the fault-tolerant loop's resume and retry
    (tests/test_ckpt_ft.py:62,84)."""
    def model(arch, seed=0):
        cfg = lm_configs.get_arch(arch).smoke()
        return cfg, lm.init_params(cfg, device=dev, seed=seed,
                                   requires_grad=True)

    def pipe(cfg, seq, batch, seed=0):
        return SyntheticTokenPipeline(PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            seed=seed), device=dev)

    # loss decreases: qwen1.5-4b smoke, 120 steps, lr 3e-3
    cfg, params = model("qwen1.5-4b")
    opt, p = adamw_init(params), pipe(cfg, 64, 8, seed=1)
    step = make_train_step(cfg, opt=AdamWConfig(lr=3e-3), ce_chunk=32,
                           moe_dense=True, total_steps=120, warmup_steps=10)
    t0 = time.perf_counter()
    losses = []
    for s in range(120):
        params, opt, m = step(params, opt, p.batch(s), s)
        losses.append(float(m["loss"]))
    loss_s = time.perf_counter() - t0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(last < first - 0.15, f"smoke loss {first} -> {last}")
    # microbatch 4 against 1: glm4-9b smoke
    cfg, p1 = model("glm4-9b")
    _, p2 = model("glm4-9b")
    batch = pipe(cfg, 32, 8).batch(0)
    p1, _, m1 = make_train_step(cfg, microbatch=1, ce_chunk=16,
                                remat="none")(p1, adamw_init(p1), batch, 0)
    p2, _, m2 = make_train_step(cfg, microbatch=4, ce_chunk=16,
                                remat="none")(p2, adamw_init(p2), batch, 0)
    dloss = abs(float(m1["loss"]) - float(m2["loss"]))
    dparam = max(float((a - b).abs().max()) for a, b in
                 zip(p1.state_dict().values(), p2.state_dict().values()))
    check(dloss < 5e-3 and dparam < 5e-4,
          f"microbatch: loss {dloss}, params {dparam}")
    # resume: 30 steps straight against 20, a checkpoint, a restore into
    # other weights and 10 more; retry: a failure injected at step 12
    cfg, pa = model("qwen1.5-4b")
    tp = pipe(cfg, 32, 4)
    step = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), ce_chunk=16,
                           moe_dense=True)
    oa = adamw_init(pa)
    for s in range(30):
        pa, oa, _ = step(pa, oa, tp.batch(s), s)
    _, pb = model("qwen1.5-4b")
    ob = adamw_init(pb)
    for s in range(20):
        pb, ob, _ = step(pb, ob, tp.batch(s), s)
    loop = FaultTolerantLoop(
        LoopConfig(total_steps=30, ckpt_every=100),
        CheckpointManager(f"{tmp}/resume", async_save=False), step, tp)
    loop._checkpoint(19, {"params": pb, "opt": ob})
    _, pc = model("qwen1.5-4b", seed=9)
    state, log = loop.run(pc, adamw_init(pc))
    resumed = state["params"].state_dict().values()
    check([r["step"] for r in log] == list(range(20, 30))
          and all(torch.equal(a, b) for a, b in zip(
              pa.state_dict().values(), resumed)),
          "fault-tolerant loop: resume is not bitwise")
    fails = {12}

    def injector(s):
        if s in fails:
            fails.discard(s)
            return True
        return False
    _, pr = model("qwen1.5-4b")
    loop = FaultTolerantLoop(
        LoopConfig(total_steps=25, ckpt_every=5),
        CheckpointManager(f"{tmp}/retry", async_save=False), step, tp)
    _, rlog = loop.run(pr, adamw_init(pr), fail_injector=injector)
    check(rlog[-1]["step"] == 24 and all(np.isfinite(r["loss"])
                                         for r in rlog),
          "fault-tolerant loop: retry")
    free_card()
    return dict(loss_decreases=dict(first10=first, last10=last, steps=120,
                                    run_s=loss_s, losses=losses[::10]),
                microbatch=dict(loss_diff=dloss, param_diff=dparam),
                resume_bitwise=True, retry_steps=len(rlog))


def phase_lm_train(dev) -> tuple[dict, tuple]:
    """Training on the card (see the module docstring, phase 20).
    Returns the 8-step run's launch counts and the 1 x 4096 run's first
    flash backward arguments (bwd-b's row)."""
    t_phase = time.perf_counter()
    cfg = lm_configs.get_arch(TRAIN_ARCH)
    shapes, bwd_in = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for what in TRAIN_SHAPES:
            shapes[what], args = train_shape(cfg, dev, what, tmp)
            bwd_in = args
        gate = gradient_gate(dev)
        moe = moe_train(dev)
        smoke = smoke_training(dev, tmp)
    losses = shapes["b8_s128"]["losses"]
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"lm_train: loss not falling {losses}")
    emit("lm_train", arch=TRAIN_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.head_dim],
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, shapes=shapes,
         gradient_gate=gate, moe=moe, smoke=smoke,
         card=torch.cuda.get_device_name(0),
         phase_s=time.perf_counter() - t_phase)
    return shapes["b8_s128"]["launches"], bwd_in


def bwd_rows(dev, bwd_in) -> list:
    """flash_attention_bwd's row on lm_train's layer-0 arguments (bwd-b)
    with BWD_ROWS nested, each against flash_attention_bwd_ref."""
    flush = l2_flusher(dev)

    def row(rows, args, window, iters, **extra):
        q, k, v, o, lse, do = args
        B, S, H, D = q.shape
        dtype = q.dtype
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                           window=window)
        plain = lambda: flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                window=window)
        got, want = call(), plain()
        # the route (bf16 rows: the wgmma kernels, float32: mma.sync),
        # a call's launches by the wrapper's count, and the kernels the
        # profiler saw three calls launch (late in the run it has been
        # seen to record none: then only the count is checked)
        route = flash_ops.bwd_route(q, k, v, o, do)
        before = flash_attention_bwd.launches
        call()
        launched = flash_attention_bwd.launches - before
        sym = KERNEL_SYMBOLS["flash_attention_bwd"]
        seen = sorted({re.search(sym, n).group(0)
                       for n in device_kernels(call, 3)[0]
                       if re.search(sym, n)})
        want_route = "wgmma" if dtype == torch.bfloat16 else "mma"
        tag = "_wgmma" if want_route == "wgmma" else ""
        check(route == want_route
              and launched == flash_ops.bwd_launches(q, k, v, o, do)
              and (not seen or {f"flash_bwd_dkdv{tag}_kernel",
                                f"flash_bwd_dq{tag}_kernel"} <= set(seen)),
              f"flash_attention_bwd {extra.get('shape_tag')}: route "
              f"{route}, {launched} launches, kernels {seen}")
        flat = lambda ts: torch.cat([t.flatten() for t in ts])
        atol = torch.cat([torch.full((t.numel(),), BWD_TOL[dtype] * float(
            t.float().abs().max()), device=dev) for t in want])
        # the library: SDPA's backward, the time of one forward and
        # backward less that of the forward alone (CUDA events, L2
        # flushed), and the device kernels the backward ran, by name
        leaf = lambda t: t.transpose(1, 2).detach().requires_grad_()
        lq, lk, lv = leaf(q), leaf(k), leaf(v)
        mask = None if not window else keep_mask(S, True, window, dev)
        dot = do.transpose(1, 2)
        fwd = lambda: torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask, is_causal=mask is None,
            enable_gqa=k.shape[2] != H)
        fwd_bwd = lambda: torch.autograd.grad(fwd(), (lq, lk, lv), dot)
        lib_fwd_bwd_ms = cuda_ms(fwd_bwd, 3, flush)
        lib_fwd_ms = cuda_ms(fwd, 3, flush)
        lib = device_kernels(fwd_bwd, 2)[0]
        lib_bwd = [n for n in sorted(lib, key=lambda n: -lib[n][1])
                   if re.search(r"bwd|backward|bprop|dgrad|cutlassB", n,
                                re.I)]
        del lq, lk, lv
        pairs = band_pairs(S, window)
        nbytes = (2 * q.numel() * 2 + 2 * k.numel() * 2) * q.element_size() \
            + lse.numel() * 4
        nops = 5 * 2 * pairs * D * H * B
        rate = (BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16
                else CUDA_CORE_OPS_PER_S)
        more = {}
        if dtype == torch.float32:
            more["bound_ms_3xtf32"] = bound_ms(nbytes, 3 * nops,
                                               TF32_TENSOR_OPS_PER_S)[0]
        kernel_row(
            rows, flush, "flash_attention_bwd",
            "src/repro_torch/csrc/flash_attn_bwd.cu",
            "src/repro/models/layers.py:298 _flash_bwd (plain jnp "
            "custom_vjp; no Pallas kernel)", call, plain, flat(got),
            flat(want), nbytes, nops, iters, 2, ops_per_s=rate,
            tol=(atol, 0.0), prof_iters=3,
            per_call=flash_ops.bwd_launches(q, k, v, o, do),
            library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
            library_fwd_bwd_ms=lib_fwd_bwd_ms, library_fwd_ms=lib_fwd_ms,
            shape=[B, S, H, k.shape[2], D],
            dtype=str(dtype).removeprefix("torch."), causal=True,
            window=window,
            tolerance_atol=f"{BWD_TOL[dtype]} x max |grad|, each of dq, "
                           f"dk, dv",
            library_call="scaled_dot_product_attention: forward + backward "
                         "less the forward",
            library_kernels=lib_bwd[:3], bwd_route=route,
            bwd_launches_a_call=launched,
            bwd_kernels=seen or "not recorded (profiler)", **more, **extra)
        return rows[-1]

    others = []
    for tag, (shape, dtype, window) in BWD_ROWS.items():
        B, S, H, Hkv, D = shape
        gen = torch.Generator(device=dev).manual_seed(S + H + D + window)
        rnd = lambda h: torch.randn(B, S, h, D, generator=gen,
                                    device=dev).to(dtype)
        q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
        o, lse = flash_ops._forward(q, k, v, True, window, True)
        others.append(row([], (q, k, v, o, lse, do), window,
                          5 if dtype == torch.bfloat16 else 10,
                          shape_tag=tag))
        del q, k, v, do, o, lse
        free_card()
    (args, kw) = bwd_in
    cfg = lm_configs.get_arch(TRAIN_ARCH)
    check(args[0].shape == (1, TRAIN_SHAPES["b1_s4096"][1], cfg.num_heads,
                            cfg.head_dim)
          and args[0].dtype == torch.bfloat16 and not kw.get("window"),
          f"bwd-b: layer input {tuple(args[0].shape)} {args[0].dtype}")
    rows = []
    row(rows, args, 0, 5, shape_tag="bwd-b",
        main_path="lm_train 1 x 4096 step (Qwen1.5-4B, the backward of "
                  "the last layer's attention)", other_shapes=others)
    return rows


def main() -> int:
    if sys.argv[1:2] == ["--sass"]:
        # any build's fx_exp / fx_log kernels, whatever their names
        for lib in sys.argv[2:]:
            fns = sass_functions(Path(lib))
            print(json.dumps({"library": lib, "sass_per_element": {
                name: loop_cost(ins) for name, ins in fns.items()
                if re.search(r"fx_(exp|log)\w*_kernel", name)}}))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    dev = torch.device("cuda")
    # the plain versions' float32 products in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    sass = phase_build()
    paths = {"paper_chip_8pe": phase_paper(dev)}
    sim, prog, paths["board_ring_4096pe"], dense_recs, dense_us = \
        phase_board(dev)
    main = phase_tick_profile(sim, "tick_profile_4096pe")
    ev_sim, paths["event_ring_4096pe"] = phase_event_ring(
        dev, prog, dense_recs, dense_us)
    del dense_recs
    main_event = phase_tick_profile(ev_sim, "tick_profile_4096pe_event")
    paths["hybrid"], encode_ops = phase_hybrid(dev)
    paths["hybrid_farm_4096pe"], farm_rows, farm_links, farm_main, \
        farm_noc = phase_farm(dev)
    paths["multichip_board"] = phase_multichip_board(dev)
    paths["learn_adaptive_chip"] = phase_learn_adaptive(dev)
    paths["learn_adaptive_board2x2"] = phase_learn_adaptive(dev, LEARN_BOARD)
    paths["learn_stdp_pair"] = phase_learn_stdp(dev)
    paths["learn_board_48chip"] = phase_learn_board(dev)
    paths["probes_ring_4096pe"] = phase_probes(dev, sim)
    paths.update(phase_serve(dev))
    paths.update(phase_route_opt(dev))
    paths["lm_serve"], lm_attn = phase_lm_serve(dev)
    paths["lm_moe"] = phase_lm_moe(dev)
    paths["lm_zoo"], zoo_attn = phase_lm_zoo(dev)
    paths["lm_recurrent"], rec_in = phase_lm_recurrent(dev)
    paths["dnn_pipeline"] = phase_dnn(dev)
    paths["mac_efficiency"] = phase_mac_efficiency(dev)
    paths["dnn_layers"] = phase_dnn_layers(dev)
    paths["elementary"], log = phase_elementary(dev)
    paths["attention"], attn = phase_attention(dev)
    rows = phase_kernels(dev, sim, prog, main, main_event, farm_rows,
                         farm_links, farm_main, farm_noc, encode_ops, sass)
    rows += phase_accel_kernels(dev, log, attn, lm_attn, zoo_attn, rec_in)
    del log, attn, lm_attn, zoo_attn, rec_in, sim, ev_sim, prog
    free_card()
    paths["lm_train"], bwd_in = phase_lm_train(dev)
    rows += bwd_rows(dev, bwd_in)
    del bwd_in
    free_card()
    # each kernel's launches on the path it was checked at
    home = {"event_link_loads": "hybrid_farm_4096pe", "mac_gemm": "hybrid",
            "compact_lanes": "event_ring_4096pe",
            "mac_conv2d": "dnn_layers", "fx_log": "elementary",
            "flash_attention_kernel": "lm_serve",
            "linear_scan": "lm_recurrent", "wkv6": "lm_recurrent",
            "flash_attention_bwd": "lm_train"}
    for row in rows:
        name = row["name"]
        row["launches"] = paths[home.get(name, "board_ring_4096pe")][name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items()}
    phase_parity(dev)
    emit("script", seconds=time.perf_counter() - t_script)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
