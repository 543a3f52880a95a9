#!/usr/bin/env python3
"""The wgmma_d256 route's backward kernels (``csrc/flash_attn_bwd_d256.cu``)
against variants of them, in turns on one card:

    PYTHONPATH=src python3 scripts/flash_bwd_d256_variants.py [--work DIR]

Each variant is a copy of the port's package under DIR (default
``tmp_chip/d256_variants``, which .gitignore lists) holding only the two
backward sources, with ``flash_attn_bwd_d256.cu`` edited; the trees build
in parallel.  Then bwd-r (RecurrentGemma-2B's 1 x 4096 x 10 heads of 256
over one KV head, window 2048, bf16; o and lse from the plain forward)
runs on each tree in turns (staged, redundant, noload, then the reverse),
each in a fresh process: every kernel's mean device µs over 10 cold calls
(L2 flushed, torch.profiler) and each gradient's largest error over its
largest magnitude against ``flash_attention_bwd_ref`` on the card.  One
JSON line a run, after each tree's ptxas lines for the two kernels.

Variants:
  staged     the kernels as they are: each consumer warpgroup computes the
             score products for half of a tile's columns (m64n32k16) and
             stages its half of P^T and dS^T (dS) in bf16, then
             accumulates half of D's columns over the whole tile;
  redundant  the alternative: each consumer computes S^T and dP^T (S and
             dP) for the whole tile (m64n64k16, 7/5 of the score
             products) and keeps P^T and dS^T (dS) in registers as the A
             operand of its dV and dK (dQ) columns (m64n128k16, A in
             registers): no staging, no barrier between the consumers;
  noload     the staged kernels with producers that bring the streamed
             tiles in for the first two tiles only (wrong gradients): the
             time the streamed loads cost.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = "flash_attn_bwd_d256.cu"
SOURCES = ("flash_attn_bwd.cu", KERNEL)
ORDER = ("staged", "redundant", "noload")

# the register-A m64n128k16 product the redundant variant needs
RS_M64N128K16 = '''
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64],
                                                       const uint32_t* a,
                                                       uint64_t db) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %69, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      OUTS "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\\n}\\n"
      : ACC : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void issue_scores64(float (&acc)[32], uint32_t a,
                                               uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4 * D2_NCH; ++ks) {
    const int off = (ks / 4) * D2_SQ + (ks % 4) * 32;
    sm90::wgmma_ss_m64n64k16(acc, sm90::desc_sw128(a + off, 16, 1024),
                             sm90::desc_sw128(b + off, 16, 1024), ks > 0);
  }
  sm90::wgmma_commit();
}

__device__ __forceinline__ void issue_accumulate_rs(float (&acc)[64],
                                                    const uint32_t (&a)[16],
                                                    uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D2_ROWS / 16; ++ks) {
    wgmma_rs_m64n128k16_tb(acc, a + 4 * ks,
                           sm90::desc_sw128(b + ks * 2048, D2_SQ, 1024));
  }
  sm90::wgmma_commit();
}
'''.replace("OUTS", '"' + ", ".join(f"%{i}" for i in range(64)) + '"') \
    .replace("ACC", ", ".join(f'"+f"(d[{i}])' for i in range(64)))

DKDV_REDUNDANT = '''      const int q0 = (qt_lo + i) * D2_ROWS;
      sm90::mbar_wait(mb(kMbFull + st), (i / D2_ST) & 1);
      const uint32_t sq = base + ring(st), sdo = sq + D2_TILE;
      float s[32], dp[32];
      sm90::wgmma_fence();
      issue_scores64(s, base, sq);
      issue_scores64(dp, base + D2_TILE, sdo);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      const float* rl = reinterpret_cast<const float*>(sm + rows(st));
      const float* rd = rl + D2_ROWS;
      const bool edge = edge_tile(q0, D2_ROWS, k0, D2_ROWS, S, causal,
                                  window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + col0 + e % 2;
        const float p = fast_exp2(s[e] * scale_log2 - rl[col]);
        s[e] = (!edge || keeps(q0 + col, row0 + 8 * ((e / 2) % 2), S,
                               causal, window)) ? p : 0.f;
      }
      uint32_t pb[16], dsb[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) pb[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
      sm90::wgmma_fence();
      issue_accumulate_rs(dvacc, pb, sdo + 2 * c * D2_SQ);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int col = 8 * (x / 2) + col0;
        dsb[x] = pack_bf16(s[2 * x] * (dp[2 * x] - rd[col]) * scale,
                           s[2 * x + 1] * (dp[2 * x + 1] - rd[col + 1]) *
                               scale);
      }
      sm90::wgmma_fence();
      issue_accumulate_rs(dkacc, dsb, sq + 2 * c * D2_SQ);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(pb);
      sm90::fence_regs(dsb);
      sm90::fence_regs(dvacc);
      sm90::fence_regs(dkacc);
'''

DQ_REDUNDANT = '''      const int kv0 = (j0 + j) * D2_ROWS;
      sm90::mbar_wait(mb(kMbFull + st), (j / D2_ST) & 1);
      const uint32_t sk = base + ring(st), sv = sk + D2_TILE;
      float s[32], dp[32];
      sm90::wgmma_fence();
      issue_scores64(s, base, sk);
      issue_scores64(dp, base + D2_TILE, sv);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      const bool edge = edge_tile(q0, D2_ROWS, kv0, D2_ROWS, S, causal,
                                  window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e / 2) % 2;
        const float p = fast_exp2(s[e] * scale_log2 - rl[hh]);
        s[e] = (!edge || keeps(row0 + 8 * hh,
                               kv0 + 8 * (e / 4) + col0 + e % 2, S, causal,
                               window)) ? p : 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      uint32_t dsb[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float d = rd[x % 2];
        dsb[x] = pack_bf16(s[2 * x] * (dp[2 * x] - d) * scale,
                           s[2 * x + 1] * (dp[2 * x + 1] - d) * scale);
      }
      sm90::wgmma_fence();
      issue_accumulate_rs(dqacc, dsb, sk + 2 * c * D2_SQ);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dsb);
      sm90::fence_regs(dqacc);
'''


def splice(src: str, start: str, end: str, new: str) -> str:
    """src with the text from ``start`` up to (not including) ``end``
    replaced by ``new``; each anchor must occur once."""
    assert src.count(start) == 1 and src.count(end) == 1, (start, end)
    i, j = src.index(start), src.index(end)
    return src[:i] + new + src[j:]


def variant(name: str, src: str) -> str:
    """The kernel source of variant ``name``."""
    if name == "staged":
        return src
    if name == "noload":
        for loop_var, tx in (("i", "2 * D2_TILE + 512"), ("j", "2 * D2_TILE")):
            old = f"      sm90::mbar_expect_tx(mb(kMbFull + st), {tx});\n"
            assert src.count(old) == 1, old
            src = src.replace(old, f"      if ({loop_var} >= D2_ST) {{\n"
                              "        sm90::mbar_arrive(mb(kMbFull + st));"
                              "\n        continue;\n      }\n" + old)
        return src
    src = src.replace("// this consumer's half of a staged tile",
                      RS_M64N128K16 + "\n// this consumer's half of a "
                      "staged tile", 1)
    release = "      if (lane == 0) sm90::mbar_arrive(mb(kMbEmpty + st));"
    src = splice(src, "      const int qc0 = (qt_lo + i) * D2_ROWS",
                 release + "   // stage read\n    }\n#pragma unroll\n"
                 "    for (int hh = 0; hh < 2; ++hh) {\n      const int kv =",
                 DKDV_REDUNDANT)
    return splice(src, "      const int kc0 = (j0 + j) * D2_ROWS",
                  release + "   // stage read\n    }\n#pragma unroll\n"
                  "    for (int hh = 0; hh < 2; ++hh) {\n      const int row "
                  "=", DQ_REDUNDANT)


def make_tree(work: Path, name: str) -> Path:
    """A copy of the package with the two backward sources, ``name``'s
    kernel edit applied; returns its ``src``."""
    dst = work / name / "src" / "repro_torch"
    if dst.parent.exists():
        shutil.rmtree(dst.parent)
    shutil.copytree(ROOT / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    for cu in (dst / "csrc").glob("*.cu"):
        if cu.name not in SOURCES:
            cu.unlink()
    kernel = dst / "csrc" / KERNEL
    kernel.write_text(variant(name, kernel.read_text()))
    return dst.parent


def measure(label: str) -> dict:
    """bwd-r on the package on sys.path (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attn.ref import (flash_attention_bwd_ref,
                                                    flash_attention_ref)
    dev = torch.device("cuda")
    B, S, H, Hkv, D, window = 1, 4096, 10, 1, 256, 2048
    gen = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda h: torch.randn(B, S, h, D, generator=gen,
                                device=dev).bfloat16()
    q, do, k, v = rnd(H), rnd(H), rnd(Hkv), rnd(Hkv)
    fold = lambda t: t.repeat_interleave(H // t.shape[2], 2).transpose(
        1, 2).reshape(B * H, S, D).float()
    o, lse = flash_attention_ref(fold(q), fold(k), fold(v), window=window,
                                 return_lse=True)
    o = o.reshape(B, H, S, D).transpose(1, 2).bfloat16().contiguous()
    lse = lse.reshape(B, H, S).contiguous()
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    call = lambda: flash_attention_bwd(q, k, v, o, lse, do, window=window)
    got = call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    us = {re.search(r"flash_bwd_\w+", e.key).group(0):
          e.self_device_time_total / e.count
          for e in prof.key_averages() if "flash_bwd" in e.key}
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, window=window)
    rel = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
           for g, w in zip(got, want)]
    return {"variant": label, "kernel_us_cold": us,
            "sum_us": sum(us.values()), "rel_errs_dq_dk_dv": rel,
            "card": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=str(ROOT / "tmp_chip" /
                                          "d256_variants"))
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    work = Path(args.work)
    trees = {name: make_tree(work, name) for name in ORDER}
    build = ("from repro_torch.kernels import _build; _build.library(); "
             "print(_build.build_log)")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", build], stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(src)})
        for name, src in trees.items()}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            fn = m.group(1) if m else fn
            if fn and "d256_kernel" in fn and re.search(
                    r"registers|spill|C75\d\d", line):
                print(f"{name}: {fn[:48]}: {line.strip()}")
    for name in ORDER + ORDER[::-1]:
        subprocess.run([sys.executable, __file__, "--measure", name],
                       env={**os.environ, "PYTHONPATH": str(trees[name])},
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
