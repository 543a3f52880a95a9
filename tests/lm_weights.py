"""The reference's ``init_params`` weights, the same in every process.

The reference seeds each parameter leaf with ``hash(path)``
(``repro.models.layers._path_seed``), and Python randomises ``hash`` of a
string per process (``PYTHONHASHSEED``): every run of a test built on
``init_params`` would hold the port against other weights.  The LM
parity tests patch ``_path_seed`` for their module with ``crc32_seed``, a
stable function of the path (``stable_weights``).  ``hash_seeds`` gives
the seeds that ``hash(path)`` takes in a process started with a given
``PYTHONHASHSEED``, computed in such a process, so that the weights of a
run that failed can be rebuilt in any run.  Nothing under ``src/repro/``
changes: the patch holds for the tests alone.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import zlib

import pytest
from repro.models import layers as JL

_HASHES = ("import json, sys; print(json.dumps({p: hash(p) & 0xFFFFFFFF "
           "for p in json.load(sys.stdin)}))")


def crc32_seed(path: str) -> int:
    return zlib.crc32(path.encode())


@contextlib.contextmanager
def path_seeds(seed_of):
    """The reference's ``init_params`` seeding leaf ``path`` with
    ``seed_of(path)`` inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "_path_seed", seed_of)
        yield


def stable_weights():
    """A module-scoped autouse fixture's body: crc32 seeds for the module
    (module scope, so that module-scoped fixtures and cached builders see
    them too)."""
    with path_seeds(crc32_seed):
        yield


def hash_seeds(paths, hashseed: int) -> dict:
    """{path: the reference's ``_path_seed(path)``} as a Python process
    started with ``PYTHONHASHSEED=hashseed`` computes it."""
    out = subprocess.run(
        [sys.executable, "-c", _HASHES], input=json.dumps(sorted(paths)),
        capture_output=True, text=True, check=True, timeout=120,
        env={**os.environ, "PYTHONHASHSEED": str(hashseed)}).stdout
    return json.loads(out)
