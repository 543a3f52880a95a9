"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` exposes ``extern "C"`` launchers that take raw device
pointers, sizes and a ``cudaStream_t`` and return ``cudaGetLastError()``.
At first use, ``library()`` compiles each source with its own ``nvcc``
process (all started together) for ``sm_90a``, links the objects into one
shared library and loads it.  The library lands in ``.build/<hash>/``
beside this package, keyed by a hash of the sources and flags, so an
unchanged tree builds once.  No PyTorch headers are compiled: the
launchers have a plain C interface.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / ".build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib = None
build_seconds: float | None = None     # wall time of this process's build
build_log: str = ""                    # nvcc output (ptxas register counts)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with their output on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "\n".join(outs)


def build() -> Path:
    """Compile and link the kernels unless this tree's library exists."""
    global build_seconds, build_log
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        compiler = nvcc()
        log = _run_all([[compiler, *NVCC_FLAGS, "-c", str(src), "-o",
                         str(obj)] for src, obj in zip(sources(), objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        log += _run_all([[compiler, ARCH, "-shared", "-o", str(tmp_lib),
                          *map(str, objs)]])
        (out_dir / "nvcc.log").write_text(log)
        os.replace(tmp_lib, lib_path)        # atomic across processes
    build_seconds = time.perf_counter() - t0
    build_log = log
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


@functools.cache
def launcher(name: str, argtypes: tuple):
    """The C launcher ``name`` with its argument types declared: every
    pointer and the stream as ``c_void_p`` so none is cut to 32 bits."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
