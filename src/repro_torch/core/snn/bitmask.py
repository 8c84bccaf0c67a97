"""GeNN's 32x spike bitmasks for storage.

Counterpart of ``repro/core/snn/bitmask.py``.  A bool spike vector costs a
byte per neuron; packing 32 neurons into a word shrinks the spike-probe
rings 8x (byte -> bit).  Packing is exact, so a packed ring unpacks to the
raster bit for bit.

Word w holds neurons [32w, 32w+32); neuron n is bit n % 32 of word n // 32
(least significant first), and the trailing bits of the last word are zero.
The port stores words as int32 holding uint32's bit pattern (PyTorch has no
uint32 arithmetic on the card).  Packing runs the hand-written kernel
(``repro_torch.kernels.spike_bitmask``; its plain version on the CPU);
unpacking is plain tensor ops, off the step's path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

__all__ = ["words_for", "pack_spikes", "unpack_spikes", "pack_rows",
           "unpack_rows", "unpack_segments"]

_BITS = 32


def words_for(n: int) -> int:
    """Words needed for n spike bits (>= 1)."""
    return max(1, -(-int(n) // _BITS))


def pack_spikes(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> int32 [..., words_for(n)] (each row packed on its
    own, least significant bit first)."""
    if bits.dtype != torch.bool:
        bits = bits != 0
    lead, n = bits.shape[:-1], bits.shape[-1]
    rows = bits.reshape(-1, n).contiguous()
    return kops.pack_spikes(rows).reshape(lead + (words_for(n),))


def unpack_spikes(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [..., W] -> bool [..., n] (the inverse of pack_spikes).  The
    shift is arithmetic, so bit 31 is masked with ``& 1`` after it."""
    shifts = torch.arange(_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., :, None] >> shifts) & 1
    flat = bits.reshape(bits.shape[:-2] + (-1,))
    return flat[..., :n].to(torch.bool)


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> int32 [..., words_for(n)] (rows packed on their
    own)."""
    return pack_spikes(bits)


def unpack_rows(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [..., W] -> bool [..., n]."""
    return unpack_spikes(words, n)


def unpack_segments(words: torch.Tensor, n_per_seg: int) -> torch.Tensor:
    """int32 [D, W] (one packed segment per shard) -> bool [D * n_per_seg]:
    rows unpacked on their own and concatenated, as an all-gather of
    per-shard bool segments would hold them."""
    return unpack_spikes(words, n_per_seg).reshape(-1)
