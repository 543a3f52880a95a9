"""Checkpointing with atomic publish and async save, on one device.

Layout per step:
    <dir>/step_000123/
        manifest.json       tree structure, shapes, dtypes, step, meta
        <leafpath>.npy      one file per leaf
    <dir>/LATEST            text file with the newest published step

Atomicity: a checkpoint is written into step_XXXX.tmp and os.replace'd
into place, then LATEST is swapped, so a crash mid-save never corrupts
the previous checkpoint.

A tree is nested dicts, lists and tuples whose leaves are tensors or
numpy arrays; leaf paths join dict keys with "." and list indices as
"[i]", so the layout is the reference's and either package reads the
other's checkpoints.  ``restore`` loads the leaves host-side (mmap) and
returns them as tensors on one device, the CUDA device unless the
caller asks for the CPU.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device


def _flatten(tree, prefix=""):
    """{leaf path: leaf} of ``tree``, dict keys in sorted order."""
    out = {}
    if isinstance(tree, dict):
        for k2 in sorted(tree):
            out.update(_flatten(tree[k2],
                                f"{prefix}.{k2}" if prefix else str(k2)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(struct, flat):
    """Rebuild values for a template tree `struct` from {path: leaf}."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
        return flat[prefix]
    return walk(struct, "")


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\[\]-]", "_", path)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, meta: dict | None = None):
        """Snapshot to host memory synchronously, write to disk (async)."""
        flat = _flatten(tree)
        host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in flat.items()}
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta or {})

    def _write(self, step: int, host: dict, meta: dict):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "meta": meta, "leaves": {}}
        for k, v in host.items():
            fn = _sanitize(k) + ".npy"
            np.save(tmp / fn, v)
            manifest["leaves"][k] = {
                "file": fn, "shape": list(v.shape), "dtype": str(v.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if p.is_dir() and not p.name.endswith(".tmp")]

    def latest_step(self):
        f = self.dir / "LATEST"
        if f.exists():
            s = int(f.read_text().strip())
            if (self.dir / f"step_{s:08d}").exists():
                return s
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, template, step: int | None = None, *, device=None):
        """``template``: a tree with the target structure (values
        ignored).  Returns (tree of tensors on ``device``, manifest), or
        (None, None) when the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        device = resolve_device(device)
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {k: torch.as_tensor(np.array(np.load(d / info["file"],
                                                    mmap_mode="r")),
                                   device=device)
                for k, info in manifest["leaves"].items()}
        return _unflatten_into(template, flat), manifest
