"""Deterministic, shard-aware, resumable token pipeline, the counterpart of
``repro/data/pipeline.py``.

Every row is drawn from numpy's ``SeedSequence([seed, step, global_row])``
exactly as the JAX package draws it, so the two packages give the same
batches bit for bit, any (step, shard) pair is reproducible from (seed,
step) alone, and a restart or an elastic reshard resumes exactly.  The
synthetic stream stands in for a tokenized corpus reader: documents of
Zipf-ish token draws with BOS/EOS segmenting and local repeats, so losses
are not degenerate-uniform.  ``state()``/``restore()`` carry the cursor.

``next_batch`` returns ``{"tokens": int32 [local_batch, seq_len + 1]}`` on
the pipeline's device (``cuda`` unless the caller passes another).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bos_id: int = 1
    eos_id: int = 2
    mean_doc_len: int = 512
    zipf_a: float = 1.2


class TokenPipeline:
    """Iterator of {'tokens': [local_batch, seq_len+1]} batches."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1, start_step: int = 0,
                 device: DeviceLike = None):
        if cfg.global_batch % num_shards:
            raise ValueError(
                f"global_batch {cfg.global_batch} % shards {num_shards}")
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.step = start_step
        self.device = resolve_device(device)
        self._local = cfg.global_batch // num_shards
        # Zipf-ish unigram distribution over the vocab (stable across runs)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        p[cfg.bos_id] = 0.0
        p[cfg.eos_id] = 0.0
        self._probs = (p / p.sum()).astype(np.float64)

    # -- resumability -------------------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"step": self.step, "shard_index": self.shard_index,
                "num_shards": self.num_shards, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: Dict[str, int],
                shard_index: Optional[int] = None,
                num_shards: Optional[int] = None,
                device: DeviceLike = None) -> "TokenPipeline":
        """Re-create at a checkpointed cursor; the shard layout may change
        (elastic rescale) because draws key on (seed, step, global row)."""
        return cls(cfg,
                   shard_index=(state["shard_index"] if shard_index is None
                                else shard_index),
                   num_shards=(state["num_shards"] if num_shards is None
                               else num_shards),
                   start_step=state["step"], device=device)

    # -- generation ---------------------------------------------------------
    def _row(self, step: int, global_row: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, global_row]))
        out = np.empty(cfg.seq_len + 1, np.int64)
        i = 0
        while i < out.size:
            doc_len = max(8, int(rng.exponential(cfg.mean_doc_len)))
            n = min(doc_len, out.size - i)
            out[i] = cfg.bos_id
            if n > 1:
                body = rng.choice(cfg.vocab, size=n - 1, p=self._probs)
                # inject local structure: repeat previous token sometimes
                rep = rng.random(n - 1) < 0.15
                body[1:][rep[1:]] = body[:-1][rep[1:]]
                out[i + 1: i + n] = body
            i += n
            if i < out.size:
                out[i - 1] = cfg.eos_id
        return out.astype(np.int32)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        base = self.shard_index * self._local
        rows = [self._row(self.step, base + r) for r in range(self._local)]
        self.step += 1
        return {"tokens": torch.from_numpy(np.stack(rows)).to(self.device)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()
