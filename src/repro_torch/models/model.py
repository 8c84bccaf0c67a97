"""Model facade: an ArchConfig bound to the step functions, the counterpart
of ``repro/models/model.py``.

``Model.init`` and ``Model.init_caches`` run on ``cuda`` unless the caller
passes ``device="cpu"``, and raise when no card is present; the other
methods run where the params lie.

``input_specs(cfg, shape)``, ``cache_specs`` and ``param_specs`` are the
dry run's stand-ins (``launch/dryrun.py``): fake tensors
(``FakeTensorMode``) with the shapes and dtypes of the JAX package's
``ShapeDtypeStruct``s, on ``device`` (``cuda`` unless the caller passes
another), for every input of the step a shape cell runs (train_step /
prefill_step / serve_step).  Nothing is allocated: a full-width mixtral's
float32 parameters would be 563 GB.  They join the fake mode that is
active where they are called (so that their tensors mix), else make one
of their own.  Modality front ends are stubs: audio enters as frame
embeddings, images as patch embeddings.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as T

__all__ = ["Model", "build", "input_specs", "cache_specs"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, seed: int = 0, device: DeviceLike = None):
        """Random weights from a ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return T.init_params(self.cfg, gen)

    # ``extra``: the inputs beside the tokens (an encdec model's
    # ``{"audio": [B, enc_seq, d_model]}``, a vlm model's ``{"img": [B,
    # img_tokens, img_embed_dim]}``), passed through as given
    def forward(self, params, tokens, extra=None):
        return T.forward(params, self.cfg, tokens, extra)

    def loss(self, params, batch):
        """(loss, metrics) of a batch ``{"tokens": [B, T+1]}`` (and an
        encdec model's ``"audio"``, a vlm model's ``"img"``)."""
        return T.loss_fn(params, self.cfg, batch)

    def prefill(self, params, tokens, extra=None, max_seq=None):
        return T.prefill(params, self.cfg, tokens, extra, max_seq=max_seq)

    def decode_step(self, params, caches, token):
        return T.decode_step(params, self.cfg, caches, token)

    def init_caches(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                    device: DeviceLike = None):
        return T.init_caches(self.cfg, batch, max_seq, dtype,
                             resolve_device(device))

    def count_params(self, params) -> int:
        return T.count_params(params)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)


def _fake():
    """The active ``FakeTensorMode``'s context (already entered: a no-op),
    or a new mode's."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def _sds(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Fake tensors for the batch of the step this cell runs: train
    ``{"batch": {"tokens": int32 [B, T + 1], ...}}``, prefill ``{"tokens":
    int32 [B, T], ...}``, decode / long ``{"token": int32 [B], "caches":
    cache_specs(cfg, B, T)}``; an encdec model adds ``audio`` float32 [B,
    enc_seq, d], a vlm model ``img`` float32 [B, img_tokens,
    img_embed_dim], its image taking img_tokens of the sequence's T."""
    dev = resolve_device(device)
    b, t = shape.global_batch, shape.seq_len
    with _fake():
        if shape.kind in ("train", "prefill"):
            extra = int(shape.kind == "train")     # the labels' shift
            out: Dict[str, Any] = {
                "tokens": _sds((b, t + extra), torch.int32, dev)}
            if cfg.family == "encdec":
                out["audio"] = _sds((b, cfg.enc_seq, cfg.d_model),
                                    torch.float32, dev)
            if cfg.family == "vlm":
                out["tokens"] = _sds((b, t - cfg.img_tokens + extra),
                                     torch.int32, dev)
                out["img"] = _sds((b, cfg.img_tokens, cfg.img_embed_dim),
                                  torch.float32, dev)
            return {"batch": out} if shape.kind == "train" else out
        # decode / long: one new token against a seq_len cache
        return {"token": _sds((b,), torch.int32, dev),
                "caches": cache_specs(cfg, b, t, device=dev)}


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device: DeviceLike = None):
    """Fake tensors in ``init_caches``' tree (its ``index`` and each
    attention cache's ``ring`` stay Python values, as there)."""
    dev = resolve_device(device)
    with _fake():
        return T.init_caches(cfg, batch, max_seq, dtype, dev)


def param_specs(cfg: ArchConfig, device: DeviceLike = None):
    """Fake tensors in ``init_params``' tree, in its dtypes."""
    dev = resolve_device(device)
    with _fake():
        return T.init_params(cfg, torch.Generator(device=dev))
