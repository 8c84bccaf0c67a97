"""The digest of a synapse graph that ``chip_smoke.py``'s phase 12 and
``experiments/device_init_digests.py`` compute: numpy and hashlib only, so
that the card's side imports nothing of the JAX package.

For each synapse group in build order, a SHA-256 of each of its arrays'
C-order bytes (post_ind int32, g float32, valid as one byte a slot, delay
int32 when present), then a SHA-256 over the lines
``group:array:hexdigest``.  Row chunks of an array concatenate to its
bytes, so any chunking gives the same digest.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import numpy as np

FIELDS = ("post_ind", "g", "valid", "delay")


class GraphDigest:
    """Running SHA-256s of each (group, array), fed row chunks in order."""

    def __init__(self) -> None:
        self._h: Dict[Tuple[str, str], "hashlib._Hash"] = {}

    def update(self, group: str, field: str, chunk: np.ndarray) -> None:
        if field == "valid":
            chunk = chunk.astype(np.uint8)
        key = (group, field)
        if key not in self._h:
            self._h[key] = hashlib.sha256()
        self._h[key].update(np.ascontiguousarray(chunk).tobytes())

    def hexdigest(self) -> str:
        lines = "".join(f"{g}:{f}:{h.hexdigest()}\n"
                        for (g, f), h in self._h.items())
        return hashlib.sha256(lines.encode()).hexdigest()


def graph_digest(groups: Iterable[Tuple[str, Dict[str, object]]],
                 chunk: int = 8192) -> str:
    """The digest of (group name, {array name: array}) pairs in order; the
    arrays are numpy arrays or tensors (read ``chunk`` rows at a time, so a
    card's tensor crosses to the host a chunk at a time)."""
    d = GraphDigest()
    for name, arrays in groups:
        for field in FIELDS:
            a = arrays.get(field)
            if a is None:
                continue
            for lo in range(0, a.shape[0], chunk):
                part = a[lo:lo + chunk]
                if hasattr(part, "cpu"):
                    part = part.cpu().numpy()
                d.update(name, field, np.asarray(part))
    return d.hexdigest()
