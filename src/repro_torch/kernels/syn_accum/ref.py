"""Plain PyTorch version of the synfire synaptic accumulation, and the
bit-packed spike words it reads.

Spike delay lines hold one 32-bit word per 32 neurons.  The words keep
the reference's uint32 bit patterns in int32 tensors (PyTorch has no
uint32 shifts on the CPU), so every shift here masks what an arithmetic
shift would smear.

``syn_accum_ref`` is the reference's two int32 einsums
(``repro/core/snn.py``: ``i_ff = arr_exc . w_ff``, ``i_in = arr_inh .
w_inh`` added into the first ``NE`` columns) written with integer
elementwise ops, chunked over PEs to bound the temporary.  Sums are taken
in int64 and wrapped to int32, which equals the reference's wrapping
int32 accumulation.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.explog.ref import wrap32

CHUNK_PES = 256


def spike_words(n: int) -> int:
    """Number of 32-bit words that hold ``n`` spike bits."""
    return (n + 31) // 32


@functools.lru_cache(maxsize=None)
def _bit_shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_spikes(spk: torch.Tensor, n: int) -> torch.Tensor:
    """Pack 0/1 spikes ``(..., n)`` into int32 words ``(..., words(n))``
    holding the bit patterns of the reference's uint32 words."""
    w = spike_words(n)
    bits = torch.nn.functional.pad(spk.to(torch.int64), (0, w * 32 - n))
    bits = bits.reshape(spk.shape[:-1] + (w, 32))
    words = (bits << _bit_shifts(spk.device)).sum(-1)   # < 2**32, exact
    return wrap32(words).to(torch.int32)


def unpack_spikes(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_spikes``: int32 words -> 0/1 int32 ``(..., n)``."""
    bits = (words.to(torch.int64)[..., None] >> _bit_shifts(words.device)) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return flat[..., :n].to(torch.int32)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Spike count per row: SWAR popcount over the trailing word axis."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(-1).to(torch.int32)


def syn_accum_ref(exc_words, inh_words, w_ff, w_inh, pes=None,
                  fits=None) -> torch.Tensor:
    """exc_words (P, WE), inh_words (P, WI) int32 spike words; w_ff
    (P, NE, N), w_inh (P, NI, NE) int32 s16.15.  Returns i_syn (P, N)
    int32: the exc rows of w_ff summed over the set exc bits, plus the
    inh rows of w_inh over the set inh bits in columns [:NE].

    With ``pes`` (listed PE ids, sentinel P) and the 0-d bool ``fits``,
    rows of unlisted PEs are zero unless ``fits`` is false."""
    P, NE, N = w_ff.shape
    NI = w_inh.shape[1]
    arr_e = unpack_spikes(exc_words, NE)
    arr_i = unpack_spikes(inh_words, NI)
    out = torch.empty((P, N), dtype=torch.int32, device=w_ff.device)
    for a in range(0, P, CHUNK_PES):
        b = min(P, a + CHUNK_PES)
        i_syn = (arr_e[a:b, :, None] * w_ff[a:b]).sum(1, dtype=torch.int64)
        i_syn[:, :NE] += (arr_i[a:b, :, None] * w_inh[a:b]).sum(
            1, dtype=torch.int64)
        out[a:b] = wrap32(i_syn).to(torch.int32)
    if pes is None:
        return out
    keep = torch.zeros(P + 1, dtype=torch.bool, device=out.device)
    keep[pes.long().clamp(0, P)] = True
    return torch.where((keep[:P] | ~fits)[:, None], out, 0)
