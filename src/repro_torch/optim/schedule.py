"""LR schedules (warmup + cosine / rsqrt), the counterpart of
``repro/optim/schedule.py``.  Each returns a function of the step that
gives the rate as a float32 0-d tensor on the CPU, computed in float32 as
the JAX package computes it."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_rsqrt", "constant"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return fn


def warmup_rsqrt(peak: float, warmup: int):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(1, warmup)
        decay = peak * torch.sqrt(warmup / torch.clamp(step, min=warmup))
        return torch.where(step < warmup, warm, decay)
    return fn
