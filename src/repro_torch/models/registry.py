"""Input specifications per (arch x shape) cell (the reference's
``models/registry.py``).

``batch_specs`` and ``input_specs`` give the shape and dtype of every
input of the step a cell runs, as tensors on the ``meta`` device (no
storage; the reference's ``ShapeDtypeStruct`` stand-ins).
``make_dummy_batch`` makes small concrete batches for smoke tests and
examples, from the same numpy draws as the reference's, so its arrays
equal the reference's bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Abstract batch for one cell (tokens or the stubbed frontend's
    frames)."""
    B, S = shape.global_batch, shape.seq_len
    frames = cfg.frontend == "encodec"
    if shape.kind == "train":
        if frames:
            return {"frames": _spec((B, S, cfg.d_model), torch.bfloat16),
                    "labels": _spec((B, S, cfg.num_codebooks), torch.int32)}
        return {"tokens": _spec((B, S + 1), torch.int32)}
    n = S if shape.kind == "prefill" else 1    # decode: one new position
    if frames:
        return {"frames": _spec((B, n, cfg.d_model), torch.bfloat16)}
    return {"tokens": _spec((B, n), torch.int32)}


def abstract_params(cfg: ArchConfig, dtype=None) -> dict:
    """The parameter tree's shapes (the port's layout: one block a
    layer) as meta tensors, in the specs' float32 or in ``dtype``."""
    def walk(node):
        if isinstance(node, L.PSpec):
            return _spec(node.shape, dtype or getattr(torch, node.dtype))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]
    return walk(T.model_pspecs(cfg))


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16) -> list:
    """One {"k", "v"} a layer, a local layer's at its ring length."""
    return [{name: _spec((batch, L.cache_len(cfg, max_seq, kind),
                          cfg.num_kv_heads, cfg.head_dim), dtype)
             for name in ("k", "v")} for kind in T.layer_kinds(cfg)]


def input_specs(cfg: ArchConfig, shape: ShapeSpec, *, param_dtype=None):
    """Argument specs of the step this cell runs.

    train  -> (params float32, opt_state, batch, step)
    prefill-> (params bf16, batch)
    decode -> (params bf16, caches, pos, batch)
    """
    batch = batch_specs(cfg, shape)
    if shape.kind == "train":
        params = abstract_params(cfg)
        opt = {"mu": params, "nu": params,
               "count": _spec((), torch.int32)}
        return {"params": params, "opt_state": opt, "batch": batch,
                "step": _spec((), torch.int32)}
    params = abstract_params(cfg, param_dtype or torch.bfloat16)
    if shape.kind == "prefill":
        return {"params": params, "batch": batch}
    return {"params": params,
            "caches": cache_specs(cfg, shape.global_batch, shape.seq_len),
            "pos": _spec((), torch.int32), "batch": batch}


def _bf16(a: np.ndarray) -> torch.Tensor:
    """float64 draws rounded to bfloat16 (to nearest even), as
    ``jnp.asarray(a, jnp.bfloat16)`` rounds them."""
    return torch.from_numpy(a).to(torch.bfloat16)


def _int32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32))


def make_dummy_batch(cfg: ArchConfig, shape_kind: str, batch: int, seq: int,
                     rng: np.random.Generator | None = None) -> dict:
    """Concrete random batch for smoke tests (small sizes only), on the
    CPU: the reference's draws, in its order."""
    rng = rng or np.random.default_rng(0)
    V = cfg.vocab_size
    frames = cfg.frontend == "encodec"
    if shape_kind == "train":
        if frames:
            return {"frames": _bf16(rng.standard_normal(
                        (batch, seq, cfg.d_model))),
                    "labels": _int32(rng.integers(
                        0, V, (batch, seq, cfg.num_codebooks)))}
        return {"tokens": _int32(rng.integers(0, V, (batch, seq + 1)))}
    n = seq if shape_kind == "prefill" else 1
    if frames:
        return {"frames": _bf16(rng.standard_normal(
            (batch, n, cfg.d_model)))}
    return {"tokens": _int32(rng.integers(0, V, (batch, n)))}
