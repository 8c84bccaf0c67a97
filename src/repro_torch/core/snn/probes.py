"""Probes: recording of simulation state on the device.

Counterpart of ``repro/core/snn/probes.py``.  A probe declares that one
state variable (a neuron, postsynaptic or weight-update state variable, a
state-resident conductance matrix, or spike events) is sampled after each
step into a ring on the device, GeNN's spike/variable recording:

    spec.probe("kc_v", "KC", "V", every=5)            # strided
    spec.probe("kc_last", "KC", "V", window=100)      # last 100 samples
    spec.probe("kc_peak", "KC", "V", reduce="max")    # scalar per sample
    spec.probe("raster", "KC", "spikes")              # the raster

``run`` and ``sweep_gscale`` return ``Recordings`` keyed by probe name.
Samples follow the global step counter ``round(t/dt)`` (a sample is taken
after a step when it is a multiple of ``every``), so a resumed run samples
the steps one long run would.

Ring contract: a probe's ring holds ``capacity`` rows (``window`` when
set, else ``ceil(n_steps/every)``), written round-robin; ``finalize``
returns them in chronological order with the number of valid rows
(``Recordings.counts``).  Unfilled tail rows are zeros.  Unreduced spike
probes keep GeNN's 32x bitmask words (``bitmask``) in the ring and unpack
them at the end.

What differs from the JAX package: every state tensor carries the batch
axis, so a ring is [cap, B, ...] while it fills and a recording
[B, cap, ...] (a single-member ``run`` reports the JAX package's
[cap, ...]; a sweep [n_candidates, cap, ...]).  The schedule is the same
for every member (they share ``t``), so ``sample_slot`` and ``finalize``
work on host integers: a run reads ``t`` once, before its first step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.snn.errors import SpecError

__all__ = ["ProbeSpec", "ResolvedProbe", "Recordings", "REDUCE_OPS",
           "resolve_probes", "validate_probe_scalars", "capacity",
           "probe_base", "sample_slot", "write_sample", "finalize",
           "vector_reduce", "masked_reduce", "reduce_neutral", "host_sample",
           "is_packed"]

REDUCE_OPS = ("sum", "mean", "max", "min")

# per-synapse shaped variables: a probe on them must declare a reduction
_MATRIX_KINDS = ("g", "syn")


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """A probe as declared on the ModelSpec (unresolved)."""

    name: str
    target: str
    var: str
    every: int = 1
    window: Optional[int] = None
    reduce: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ResolvedProbe:
    """A probe bound to a built Network.

    kind:    "population" | "group"
    varkind: "neuron" | "spikes" | "psm" | "wu_pre" | "wu_post" | "g" | "syn"
    n:       sample length of vector-shaped probes (None for matrix ones)
    denom:   the mean's denominator (population size / valid synapses)
    """

    name: str
    kind: str
    target: str
    var: str
    varkind: str
    every: int
    window: Optional[int]
    reduce: Optional[str]
    n: Optional[int]
    denom: float

    @property
    def dtype(self) -> torch.dtype:
        """The recording's type (a packed ring unpacks to bool)."""
        if self.reduce is None and self.varkind == "spikes":
            return torch.bool
        return torch.float32

    def sample_shape(self) -> Tuple[int, ...]:
        """Shape of one member's sample row."""
        return () if self.reduce is not None else (self.n,)

    def elements_per_sample(self) -> int:
        return 1 if self.reduce is not None else int(self.n)


def _group_vars(group) -> Dict[str, str]:
    """var name -> varkind for everything a probe can read on a group."""
    out = {k: "psm" for k in group.psm.state}
    out.update({k: "wu_pre" for k in group.wum.pre_state})
    out.update({k: "wu_post" for k in group.wum.post_state})
    out.update({k: "syn" for k in group.wum.syn_state})
    out["g"] = "g"
    return out


def validate_probe_scalars(name: str, every, window, reduce) -> None:
    """The name/every/window/reduce checks, shared by ``ModelSpec.probe``
    and ``resolve_probes``."""
    if not name or not isinstance(name, str):
        raise SpecError(
            f"probe name must be a non-empty string, got {name!r}")
    where = f"probe {name!r}"
    if not isinstance(every, int) or isinstance(every, bool) or every <= 0:
        raise SpecError(f"{where}: every must be a positive int, got "
                        f"{every!r}")
    if window is not None and (not isinstance(window, int)
                               or isinstance(window, bool) or window <= 0):
        raise SpecError(f"{where}: window must be a positive int or "
                        f"None, got {window!r}")
    if reduce is not None and reduce not in REDUCE_OPS:
        raise SpecError(f"{where}: unknown reduce {reduce!r}; valid "
                        f"reductions: {list(REDUCE_OPS)}")


def resolve_probes(specs, net) -> Tuple[ResolvedProbe, ...]:
    """Validate probe declarations against a built Network (SpecError)."""
    groups = {g.name: g for g in net.synapses}
    seen = set()
    out = []
    for p in specs:
        validate_probe_scalars(p.name, p.every, p.window, p.reduce)
        if p.name in seen:
            raise SpecError(f"duplicate probe name {p.name!r}")
        seen.add(p.name)
        where = f"probe {p.name!r}"
        if p.target in net.populations:
            pop = net.populations[p.target]
            valid = sorted(pop.model.state) + ["spikes"]
            if p.var == "spikes":
                varkind = "spikes"
            elif p.var in pop.model.state:
                varkind = "neuron"
            else:
                raise SpecError(
                    f"{where}: population {p.target!r} (model "
                    f"{pop.model.name!r}) has no state variable {p.var!r}; "
                    f"valid variables: {valid}")
            out.append(ResolvedProbe(
                name=p.name, kind="population", target=p.target, var=p.var,
                varkind=varkind, every=p.every, window=p.window,
                reduce=p.reduce, n=pop.n, denom=float(pop.n)))
            continue
        if p.target in groups:
            g = groups[p.target]
            gvars = _group_vars(g)
            if p.var not in gvars:
                raise SpecError(
                    f"{where}: synapse group {p.target!r} has no state "
                    f"variable {p.var!r}; valid variables: "
                    f"{sorted(gvars)}")
            varkind = gvars[p.var]
            if varkind == "g" and not g.plastic:
                raise SpecError(
                    f"{where}: 'g' on synapse group {p.target!r} is "
                    "constant (no learn_code and no custom update writes "
                    "it); probe a plastic group or declare a custom "
                    "update first")
            if varkind in _MATRIX_KINDS:
                if p.reduce is None:
                    raise SpecError(
                        f"{where}: {p.var!r} is per-synapse shaped "
                        f"[n_pre, max_conn]; synapse-matrix probes must "
                        f"declare reduce= one of {list(REDUCE_OPS)}")
                n = None
                denom = float(int(g.ell.valid.sum()))
            else:
                n = (g.ell.n_pre if varkind == "wu_pre" else g.ell.n_post)
                denom = float(n)
            out.append(ResolvedProbe(
                name=p.name, kind="group", target=p.target, var=p.var,
                varkind=varkind, every=p.every, window=p.window,
                reduce=p.reduce, n=n, denom=denom))
            continue
        raise SpecError(
            f"{where}: unknown target {p.target!r}; valid targets: "
            f"populations {sorted(net.populations)}, synapse groups "
            f"{sorted(groups)}")
    return tuple(out)


def is_packed(probe: ResolvedProbe) -> bool:
    """True when the probe's ring rows are GeNN's 32x spike bitmask words
    (unreduced ``spikes`` probes).  Packing is storage only: the rows are
    unpacked to bool at ``finalize``."""
    return probe.reduce is None and probe.varkind == "spikes"


def ring_dtype(probe: ResolvedProbe) -> torch.dtype:
    """The ring's element type: int32 words when packed, else float32."""
    return torch.int32 if is_packed(probe) else torch.float32


def ring_row_shape(probe: ResolvedProbe, batch: int) -> Tuple[int, ...]:
    """One ring row: [B, W] words when packed, else [B, *sample_shape]."""
    if is_packed(probe):
        return (batch, max(1, -(-int(probe.n) // 32)))
    return (batch,) + probe.sample_shape()


# ---------------------------------------------------------------------------
# schedule and ring arithmetic (host integers)
# ---------------------------------------------------------------------------

def capacity(probe: ResolvedProbe, n_steps: int) -> int:
    """Ring rows for an n_steps run: ``window`` when set, else every
    sample the run can take."""
    cap = int(math.ceil(n_steps / probe.every))
    if probe.window is not None:
        cap = probe.window
    return max(cap, 1)


def probe_base(probe: ResolvedProbe, start: int) -> int:
    """Samples taken before a run that starts at global step ``start``."""
    return start // probe.every


def sample_slot(probe: ResolvedProbe, start: int, base: int, i: int,
                cap: int) -> Tuple[bool, int]:
    """(active, slot) of the run's step i (0-based) on the global
    schedule."""
    elapsed = start + i + 1
    active = elapsed % probe.every == 0
    idx = elapsed // probe.every - 1 - base
    return active, idx % cap


def write_sample(ring: torch.Tensor, slot: int, val: torch.Tensor) -> None:
    """Write one sample row [B, ...] at ``slot`` of ring [cap, B, ...]."""
    ring[slot].copy_(val)


def finalize(ring: torch.Tensor, start: int, n_steps: int,
             probe: ResolvedProbe, cap: int) -> Tuple[torch.Tensor, int]:
    """(the ring in chronological order [cap, B, ...], valid row count)
    after a run of n_steps from global step ``start``."""
    total = (start + n_steps) // probe.every - probe_base(probe, start)
    count = min(total, cap)
    if probe.window is None or total < cap or total % cap == 0:
        return ring, count
    idx = (torch.arange(cap, device=ring.device) + total % cap) % cap
    return ring.index_select(0, idx), count


# ---------------------------------------------------------------------------
# reductions (over the neuron axis; the batch axis stays)
# ---------------------------------------------------------------------------

def vector_reduce(val: torch.Tensor, op: str, denom: float) -> torch.Tensor:
    """[B, n] -> [B]."""
    val = val.to(torch.float32)
    if op == "sum":
        return val.sum(dim=-1)
    if op == "mean":
        return val.sum(dim=-1) / denom
    if op == "max":
        return val.amax(dim=-1)
    return val.amin(dim=-1)


def reduce_neutral(op: str) -> float:
    return {"sum": 0.0, "mean": 0.0, "max": -math.inf, "min": math.inf}[op]


def masked_reduce(val: torch.Tensor, mask: torch.Tensor, op: str,
                  denom: float) -> torch.Tensor:
    """A synapse matrix [B, n_pre, K] (or [n_pre, K]) reduced over its
    valid slots to [B] (invalid slots neutral)."""
    val = torch.where(mask, val.to(torch.float32), reduce_neutral(op))
    if op == "sum":
        return val.sum(dim=(-2, -1))
    if op == "mean":
        return val.sum(dim=(-2, -1)) / denom
    if op == "max":
        return val.amax(dim=(-2, -1))
    return val.amin(dim=(-2, -1))


def host_sample(probe: ResolvedProbe, groups, state,
                spikes) -> torch.Tensor:
    """One (possibly reduced) sample [B, ...] from a post-step SimState."""
    if probe.varkind == "neuron":
        val = state.neurons[probe.target][probe.var]
    elif probe.varkind == "spikes":
        val = spikes[probe.target]
    elif probe.varkind == "psm":
        val = state.syn[probe.target].psm[probe.var]
    elif probe.varkind == "wu_pre":
        val = state.syn[probe.target].wu_pre[probe.var]
    elif probe.varkind == "wu_post":
        val = state.syn[probe.target].wu_post[probe.var]
    elif probe.varkind == "g":
        val = state.syn[probe.target].g
    else:  # syn
        val = state.syn[probe.target].syn[probe.var]
    if probe.reduce is None:
        return val
    if probe.varkind in _MATRIX_KINDS:
        return masked_reduce(val, groups[probe.target].ell.valid,
                             probe.reduce, probe.denom)
    return vector_reduce(val, probe.reduce, probe.denom)


# ---------------------------------------------------------------------------
# the result container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Recordings:
    """Probe outputs, keyed by probe name.

    data[name]:   [cap, ...sample shape] for a single-member run,
                  [B, cap, ...] batched ([n_candidates, cap, ...] for a
                  sweep); chronological
    counts[name]: int32 valid-row count (0-dim, or [B])
    """

    data: Dict[str, torch.Tensor]
    counts: Dict[str, torch.Tensor]

    def __getitem__(self, name):
        return self.data[name]

    def __contains__(self, name):
        return name in self.data

    def __bool__(self):
        return bool(self.data)

    def keys(self):
        return self.data.keys()

    def items(self):
        return self.data.items()

    def count(self, name):
        return self.counts[name]
