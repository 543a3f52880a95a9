"""Run provenance for BENCH artifacts + host-side phase timers.

Every benchmark JSON the repo emits carries a ``manifest`` block —
git sha, config hash, seed, torch and CUDA versions, the device's name
and power limit, host — so a BENCH file found in CI artifacts months
later is self-describing, and ``repro_torch.obs.report`` can say WHAT
two runs being diffed actually were.  The payload's other keys are the
reference's, so ``diff_benches`` reads the port's files and the
reference's alike.

``PhaseTimers`` is the shared host-side stopwatch for the compile
pipeline's phases (build / partition / compile / first-tick-jit /
steady-tick): benchmarks wrap each phase in ``with tm.phase("build")``
and the per-phase seconds ride the JSON next to the rows.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import platform
import socket
import subprocess
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

import torch


def _git(args: list, cwd: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(["git", *args], cwd=cwd, capture_output=True,
                             text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def config_hash(obj) -> str:
    """Stable short hash of any JSON-serializable config (dataclasses
    and numpy scalars/arrays coerced via ``str``)."""
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def device_info(device=None) -> dict:
    """Name and power limit of the device a run used: the CUDA card's
    (``torch.cuda.get_device_name`` and ``nvidia-smi``'s power limit),
    or ``"cpu"`` for both when the run was on the CPU (``device`` None
    means the CUDA card when there is one)."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": "cpu"}
    power = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=10)
        lines = out.stdout.strip().splitlines()
        idx = dev.index or 0
        if out.returncode == 0 and idx < len(lines):
            power = lines[idx].split(",")[-1].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"device": torch.cuda.get_device_name(dev), "power_limit": power}


def run_manifest(seed: Optional[int] = None, config=None,
                 extra: Optional[dict] = None, device=None) -> dict:
    """The provenance block attached to every BENCH json."""
    root = str(Path(__file__).resolve().parents[3])
    sha = _git(["rev-parse", "HEAD"], cwd=root)
    dirty = _git(["status", "--porcelain"], cwd=root)
    man = {
        "git_sha": sha,
        "git_dirty": bool(dirty) if dirty is not None else None,
        "seed": seed,
        "config_hash": config_hash(config) if config is not None else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        **device_info(device),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "host": socket.gethostname(),
        "timestamp_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
    }
    if extra:
        man.update(extra)
    return man


class PhaseTimers:
    """Named host-side stopwatches for the compile/run pipeline.

    >>> tm = PhaseTimers()
    >>> with tm.phase("build"): graph = build()        # doctest: +SKIP
    >>> tm["build"]                                    # doctest: +SKIP
    0.123

    ``record`` stores an externally-measured duration (e.g. the steady
    per-tick time from ``time_call``); ``asdict`` rounds for JSON.
    """

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.seconds[name] = float(seconds)

    def __getitem__(self, name: str) -> float:
        return self.seconds[name]

    def get(self, name: str, default: float = 0.0) -> float:
        return self.seconds.get(name, default)

    def asdict(self, ndigits: int = 6) -> dict:
        return {k: round(v, ndigits) for k, v in self.seconds.items()}


def bench_payload(rows: list, *, link_profiles: Optional[dict] = None,
                  timers: Optional[dict] = None, seed: Optional[int] = None,
                  config=None, device=None, **extra) -> dict:
    """The standard BENCH json payload: rows + manifest (+ optional
    per-link profiles / phase timers / extra sections).

    Top-level ``torch_version``/``python``/``platform`` keys stand where
    the reference keeps ``jax_version`` for pre-manifest BENCH
    consumers."""
    man = run_manifest(seed=seed, config=config, device=device)
    payload = {
        "rows": rows,
        "manifest": man,
        # flat keys, as the reference's legacy ones
        "torch_version": man["torch_version"],
        "python": man["python"],
        "platform": man["platform"],
    }
    if link_profiles is not None:
        payload["link_profiles"] = link_profiles
    if timers is not None:
        payload["phase_timers"] = (timers.asdict()
                                   if isinstance(timers, PhaseTimers)
                                   else timers)
    payload.update(extra)
    return payload


def write_bench_json(path, rows: list, **kw) -> Path:
    """Write ``bench_payload`` to ``path`` (parents created) and return
    the path — the one JSON writer all benchmarks share."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(bench_payload(rows, **kw), indent=1))
    print(f"# wrote {len(rows)} rows to {path}")
    return path
