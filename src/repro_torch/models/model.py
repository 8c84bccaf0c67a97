"""Model facade: an ArchConfig bound to the step functions, the counterpart
of ``repro/models/model.py``.

``Model.init`` and ``Model.init_caches`` run on ``cuda`` unless the caller
passes ``device="cpu"``, and raise when no card is present; the other
methods run where the params lie.  The JAX dry-run helpers
(``input_specs``, ``cache_specs``, ``param_specs``) wait for the dry-run's
port (ROADMAP Queue 1 item 8.7).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

__all__ = ["Model", "build"]


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
