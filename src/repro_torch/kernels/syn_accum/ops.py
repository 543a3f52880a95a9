"""``syn_accum`` wrapper (CPU: plain version, CUDA: ``csrc/syn_accum.cu``).

The event-driven int32 synaptic accumulation of the synfire tick: each
PE adds the weight rows of the spikes that arrive this tick.  The
reference runs it as a dense einsum outside any Pallas kernel; PyTorch's
CUDA matmul has no int32 path, and the event-driven form reads only the
rows of set bits, as the paper's PE does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import expect_dtype, on_cpu
from repro_torch.kernels.syn_accum.ref import spike_words, syn_accum_ref

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int32,) * 5 + (ctypes.c_void_p,)


def syn_accum(exc_words, inh_words, w_ff, w_inh, pes=None,
              fits=None) -> torch.Tensor:
    """See ``syn_accum_ref``; shapes exc_words (P, WE), inh_words
    (P, WI), w_ff (P, NE, N), w_inh (P, NI, NE), all int32.  Event mode
    passes ``pes`` (n_lanes,) int32, the compacted input set (sentinel P
    on unused lanes), and ``fits``, a 0-d bool tensor on the same device
    that says whether the set fit: rows of unlisted PEs are zero unless
    ``fits`` is false, when every PE is computed (the dense result)."""
    expect_dtype("syn_accum", torch.int32, exc_words=exc_words,
                 inh_words=inh_words, w_ff=w_ff, w_inh=w_inh)
    if (pes is None) != (fits is None):
        raise ValueError("syn_accum: pass pes and fits together")
    listed = () if pes is None else (pes, fits)
    if listed:
        expect_dtype("syn_accum", torch.int32, pes=pes)
        expect_dtype("syn_accum", torch.bool, fits=fits)
        if pes.dim() != 1 or fits.dim() != 0:
            raise ValueError("syn_accum: pes must be 1-D and fits 0-d")
    if w_ff.dim() != 3 or w_inh.dim() != 3:
        raise ValueError("syn_accum: w_ff and w_inh must be 3-D")
    P, NE, N = w_ff.shape
    NI = w_inh.shape[1]
    if (tuple(exc_words.shape) != (P, spike_words(NE))
            or tuple(inh_words.shape) != (P, spike_words(NI))
            or tuple(w_inh.shape) != (P, NI, NE) or NE > N):
        raise ValueError(
            f"syn_accum: inconsistent shapes exc_words "
            f"{tuple(exc_words.shape)}, inh_words {tuple(inh_words.shape)},"
            f" w_ff {tuple(w_ff.shape)}, w_inh {tuple(w_inh.shape)}")
    if on_cpu("syn_accum", exc_words, inh_words, w_ff, w_inh, *listed):
        return syn_accum_ref(exc_words, inh_words, w_ff, w_inh, pes, fits)
    out = torch.empty((P, N), dtype=torch.int32, device=w_ff.device)
    if out.numel():
        rc = _build.launcher("repro_syn_accum", _ARGS)(
            exc_words.data_ptr(), inh_words.data_ptr(), w_ff.data_ptr(),
            w_inh.data_ptr(), out.data_ptr(),
            *((pes.data_ptr(), fits.data_ptr()) if listed else (None, None)),
            0 if pes is None else pes.numel(), P, NE, NI, N,
            _build.stream_ptr(w_ff.device))
        _build.check(rc, "syn_accum")
        syn_accum.launches += 1
    return out


syn_accum.launches = 0
