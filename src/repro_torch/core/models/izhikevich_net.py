"""The Izhikevich (2003) cortical network, as used in the paper §5.1.

Counterpart of ``repro/core/models/izhikevich_net.py``: `n_total` spiking
cortical neurons (4:1 excitatory:inhibitory), each pre neuron connected to
`n_conn` random post neurons over the whole population (a multi-post
synapse population split per post group at build time).  Weights:
excitatory 0.5*U(0,1), inhibitory -1.0*U(0,1); thalamic input 5*N(0,1)
(exc) / 2*N(0,1) (inh) per ms.  dt = 1 ms with two half-steps on V.

The graph comes from the host numpy generator and equals the JAX package's
for the same seed.  The per-neuron parameters come from the threefry key
``PRNGKey(seed)`` (``repro_torch.random``) as in the JAX package, bit for
bit, and the thalamic noise from each step's subkeys (JAX's draws, within
a few float32 ulp: ``repro_torch.random.normal``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.core.snn import neurons as N
from repro_torch.core.snn.spec import CompiledModel, ModelSpec
from repro_torch.sparse.formats import FixedFanout, UniformWeight

__all__ = ["IzhikevichNetConfig", "spec", "compile_model"]


@dataclasses.dataclass(frozen=True)
class IzhikevichNetConfig:
    n_total: int = 1000
    exc_frac: float = 0.8
    n_conn: int = 1000
    representation: str = "auto"   # 'auto' | 'sparse' | 'dense'
    dt: float = 1.0                # 1 ms, two half-steps on V (as Izhikevich)
    seed: int = 1234
    input_scale: float = 1.0
    # an excitatory membrane-voltage probe sampled every `probe_v_every`
    # steps (0: none)
    probe_v_every: int = 0


def spec(cfg: IzhikevichNetConfig) -> ModelSpec:
    """Declarative description of the cortical net."""
    n_exc = int(round(cfg.n_total * cfg.exc_frac))
    n_inh = cfg.n_total - n_exc
    pkey, _ = R.split(R.PRNGKey(cfg.seed))
    params = N.izhikevich_population_params(pkey, n_exc, n_inh)
    exc_params = {k: v[:n_exc] for k, v in params.items()}
    inh_params = {k: v[n_exc:] for k, v in params.items()}

    s_in = cfg.input_scale

    # the thalamic drive: each member's [n] normal draw from the step's
    # subkey (keys [B, 2] on the model's device), the scale fused into the
    # draw kernel as JAX rounds 5.0 * s_in * normal(k, (n,))
    def thalamic_exc(keys: torch.Tensor, t, n: int) -> torch.Tensor:
        return R.normal(keys, (n,), scale=5.0 * s_in)

    def thalamic_inh(keys: torch.Tensor, t, n: int) -> torch.Tensor:
        return R.normal(keys, (n,), scale=2.0 * s_in)

    ms = ModelSpec(name=f"izhikevich_{cfg.n_total}_{cfg.n_conn}")
    ms.add_neuron_population("exc", n_exc, N.IZHIKEVICH, exc_params,
                             thalamic_exc)
    ms.add_neuron_population("inh", n_inh, N.IZHIKEVICH, inh_params,
                             thalamic_inh)
    ms.add_synapse_population(
        "exc", "exc", ["exc", "inh"], connect=FixedFanout(cfg.n_conn),
        weight=UniformWeight(0.0, 0.5),
        representation=cfg.representation)
    ms.add_synapse_population(
        "inh", "inh", ["exc", "inh"], connect=FixedFanout(cfg.n_conn),
        weight=UniformWeight(0.0, -1.0),
        representation=cfg.representation)
    if cfg.probe_v_every:
        ms.probe("exc_v", "exc", "V", every=cfg.probe_v_every)
    return ms


def compile_model(cfg: IzhikevichNetConfig, device=None,
                  monitor=None, init: str = "host",
                  mesh=None) -> CompiledModel:
    """Build the net on ``device`` ("cuda" unless the caller asks), with
    the health monitor ``monitor`` (a HealthConfig) if given; ``init``
    ("host" or "device") and ``mesh`` (a ``launch.mesh.Mesh``: the
    sharded engine on the mesh's device) are ``ModelSpec.build``'s."""
    return spec(cfg).build(dt=cfg.dt, seed=cfg.seed, device=device,
                           monitor=monitor, init=init, mesh=mesh)
