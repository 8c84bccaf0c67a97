"""Neuron-axis sharding of SNN state: the SNN half of
``repro/launch/sharding.py``.

Every population is split along its neuron dimension over the mesh's
ranks: a population of n neurons pads to ``neuron_pad(n, D)`` and rank d
holds lanes [d * S, (d + 1) * S), S = padded / D.  These helpers own that
layout so the engine, ``convert``'s shard / gather and the tests agree on
it.  The LM half (``activate``, ``param_specs``, ``batch_specs``,
``cache_shardings``) is not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["neuron_pad", "pad_neuron_axis", "snn_shardings"]


def neuron_pad(n: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= n (per-population padded size)."""
    return -(-int(n) // int(n_shards)) * int(n_shards)


def pad_neuron_axis(x: torch.Tensor, n_pad: int, axis: int = -1
                    ) -> torch.Tensor:
    """Pad a per-neuron tensor to the sharded size along ``axis``,
    edge-replicating so the padded lanes carry benign (bounded-dynamics)
    values."""
    axis = axis % x.dim()
    n = x.shape[axis]
    if n == n_pad:
        return x
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = n_pad - n
    return torch.cat([x, last.repeat(reps)], dim=axis)


def snn_shardings(axis: str) -> Dict[str, tuple]:
    """How each kind of engine state splits, as the JAX package's
    PartitionSpecs spell it (None: that axis is whole on every rank; the
    leading batch axis is never split):

    - "neuron": per-neuron state [B, n] split on its neuron axis
      (neurons, spikes, postsynaptic and trace state, pre traces on the
      pre population's axis);
    - "replicated": t, keys, ring cursors, the NaN guard's flag;
    - "block": connectivity [n_pre, K] and per-synapse state
      [B, n_pre, K], one post-shard block a rank (slots of the rank's
      post neurons, re-indexed locally; ``k_local`` the same on every
      rank);
    - "ring": dendritic rings [B, slots, n_post] split on their post
      axis;
    - "probe": unreduced probe rings [cap, B, n] split on their neuron
      axis (reduced probes are one value a sample, replicated)."""
    return {
        "neuron": (None, axis),
        "replicated": (None,),
        "block": (axis, None, None),
        "ring": (None, None, axis),
        "probe": (None, None, axis),
    }
