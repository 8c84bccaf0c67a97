"""Synapse groups: connectivity + representation + generated dynamics.

Counterpart of ``repro/core/snn/synapses.py``.  A SynapseGroup connects a pre
to a post population.  Representation is chosen per the paper's memory
model (eqs. (1)/(2)) unless forced.  Dynamics come from a GeNN-style
WeightUpdateModel (what a presynaptic spike contributes, plus optional
learning) and PostsynapticModel (how arriving input decays and is applied),
compiled by ``repro_torch.core.codegen``.

`gscale` is the paper's synaptic-conductance scaling factor: it multiplies
the stored conductances at propagation time, so one build serves a whole
gScale sweep.

Every state tensor carries a leading batch axis ``[B]`` (the JAX package
vmaps instead).  Sparse propagation runs the hand-written ELL kernel
(``repro_torch.kernels.ops``), which skips silent presynaptic rows itself,
so "dense" and "event" propagation run the same kernel and give the same
result; the mode the crossover model picks (``kernels.autotune.
choose_propagation``) is reported, as the JAX package reports it.

Dendritic delays (GeNN's per-synapse delay model): a group may carry an
integer delay per synapse (``ELLSynapses.delay``) or a homogeneous
``delay_steps``; both land weighted currents in a post-side ring
``[B, max_delay+1, n_post]`` (``SynapseState.dendritic``) read at each
member's cursor, an int32 [B] tensor on the device as the JAX package keeps
it a stream (no step reads it on the host, so a CUDA graph of the step reads
each replay's cursors; a served stream's ring sits where its own steps left
it).
Per-synapse delays take two kernels a step: the delay scatter adds into a
float64 scratch that the group owns (one, for the last step's batch size,
device and post width, zero between steps), and the ring fold scales it,
rolls it into a new ring, reads and clears the cursor's row and zeroes the
scratch.

The sharded engine (``core/snn/engine.py``) steps a group on its rank's
post-shard block through ``step(conn=LocalConnectivity(...))``, with the
pre traces it keeps sharded passed in as ``pre_traces``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.codegen import (CompiledWeightUpdate, PostsynapticModel,
                                      WeightUpdateModel, compile_postsynaptic,
                                      compile_weight_update)
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ops as kops
from repro_torch.sparse import formats as F
from repro_torch.sparse import ops as sparse_ops

__all__ = [
    "SynapseGroup", "SynapseState", "LocalConnectivity",
    "Pulse", "ExpDecay", "ExpCond", "Alpha",
    "StaticPulse", "STDP", "PROPAGATIONS",
]

PROPAGATIONS = ("auto", "dense", "event")

Scale = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# Built-in postsynaptic models.
# ---------------------------------------------------------------------------

def Pulse() -> PostsynapticModel:
    """Instantaneous current injection (the Izhikevich cortical net)."""
    return PostsynapticModel(name="pulse")


def ExpDecay(tau_ms: float) -> PostsynapticModel:
    """Exponentially decaying current, time constant tau_ms."""
    return PostsynapticModel(
        name="exp_decay",
        state={"in_syn": 0.0},
        params={"tau": float(tau_ms)},
        decay_code="in_syn = in_syn * exp(-dt / tau) + inj",
        apply_code="in_syn",
    )


def ExpCond(tau_ms: float, e_rev: float) -> PostsynapticModel:
    """Exponentially decaying conductance with reversal potential e_rev."""
    return PostsynapticModel(
        name="exp_cond",
        state={"in_syn": 0.0},
        params={"tau": float(tau_ms), "e_rev": float(e_rev)},
        decay_code="in_syn = in_syn * exp(-dt / tau) + inj",
        apply_code="in_syn * (e_rev - V)",
    )


def Alpha(tau_ms: float) -> PostsynapticModel:
    """Alpha-function synapse x(t) ~ (t/tau) exp(-t/tau): a two-stage
    exponential cascade."""
    return PostsynapticModel(
        name="alpha",
        state={"x": 0.0, "y": 0.0},
        params={"tau": float(tau_ms)},
        decay_code=(
            "x = (x + (dt / tau) * y) * exp(-dt / tau)\n"
            "y = y * exp(-dt / tau) + inj"
        ),
        apply_code="x",
    )


# ---------------------------------------------------------------------------
# Built-in weight-update models.
# ---------------------------------------------------------------------------

def StaticPulse() -> WeightUpdateModel:
    """A spike contributes the stored conductance g; no learning."""
    return WeightUpdateModel(name="static_pulse")


def STDP(lr: float = 0.005, tau_pre: float = 20.0, tau_post: float = 20.0,
         g_min: float = 0.0, g_max: float = 1.0) -> WeightUpdateModel:
    """Trace-based pair STDP updating ``g`` online from pre/post spike
    coincidence."""
    return WeightUpdateModel(
        name="stdp",
        params={"lr": float(lr), "tau_pre": float(tau_pre),
                "tau_post": float(tau_post), "g_min": float(g_min),
                "g_max": float(g_max)},
        pre_state={"x_pre": 0.0},
        post_state={"x_post": 0.0},
        pre_code="x_pre = x_pre * exp(-dt / tau_pre) + pre_spike",
        post_code="x_post = x_post * exp(-dt / tau_post) + post_spike",
        learn_code=("g = clip(g + lr * x_pre * post_spike"
                    " - lr * x_post * pre_spike, g_min, g_max)"),
    )


@dataclasses.dataclass
class SynapseState:
    """Per-group dynamic state; every tensor has a leading batch axis [B].

    ``dendritic`` is the post-side dendritic-delay ring
    [B, max_delay+1, n_post]; ``cursor`` is each member's read position,
    an int32 [B] tensor on the ring's device (equal for every member of a
    run or a sweep, a stream's own when served).
    """

    psm: Dict[str, torch.Tensor]          # postsynaptic state    [B, n_post]
    wu_pre: Dict[str, torch.Tensor]       # presynaptic traces    [B, n_pre]
    wu_post: Dict[str, torch.Tensor]      # postsynaptic traces   [B, n_post]
    g: Optional[torch.Tensor]             # plastic weights [B, n_pre, K]
    syn: Dict[str, torch.Tensor]          # per-synapse vars [B, n_pre, K]
    dendritic: Optional[torch.Tensor]     # delay ring [B, S, n_post]
    cursor: Optional[torch.Tensor]        # ring cursors, int32 [B]


def _scale(sign: float, gscale: Scale, out: torch.Tensor) -> torch.Tensor:
    """sign * gscale * out, with a per-batch-member gscale [B] broadcast over
    the trailing axes of ``out`` (sign 1 is left out of a [B] gscale: the
    same bits, one device op less a step)."""
    if isinstance(gscale, torch.Tensor) and gscale.dim() == 1:
        gscale = gscale.reshape((-1,) + (1,) * (out.dim() - 1))
        if sign == 1.0:
            return gscale * out
    return sign * gscale * out


class LocalConnectivity:
    """A step-time connectivity override: the sharded engine passes each
    rank's post-shard block of a group's connectivity through
    ``SynapseGroup.step(conn=...)`` and reuses the group's compiled
    snippets on it unchanged.  ``ell``'s ``n_post`` is the rank's post
    shard and its ``post_ind`` shard-local; ``dense`` is the column block
    of a dense mirror.  What the step derives from the connectivity (the
    snippets' float32 ``delay``, the learn rule's post gather) is made
    here, once, on the block's device."""

    def __init__(self, ell: F.ELLSynapses,
                 dense: Optional[torch.Tensor] = None):
        self.ell = ell
        self.dense = dense
        self.delay_f = (None if ell.delay is None
                        else ell.delay.to(torch.float32))
        self.gather = ell.post_ind.long()


@dataclasses.dataclass
class SynapseGroup:
    name: str
    pre: str
    post: str
    ell: F.ELLSynapses                          # canonical storage
    dense: Optional[torch.Tensor] = None        # dense mirror when chosen
    representation: str = "auto"                # 'auto' | 'sparse' | 'dense'
    propagation: str = "auto"                   # 'auto' | 'dense' | 'event'
    wum: Optional[WeightUpdateModel] = None     # default StaticPulse()
    psm: Optional[PostsynapticModel] = None     # default Pulse()
    delay_steps: int = 0                        # homogeneous dendritic delay
    max_delay: Optional[int] = None             # static ring bound
    sign: float = 1.0                           # +1 excitatory / -1 inhibitory
    # a custom update writes g: the conductances become state, [B, n_pre,
    # K] per member as a learning rule keeps them, and take the ELL path
    mutable_g: bool = False

    def __post_init__(self) -> None:
        if self.psm is None:
            self.psm = Pulse()
        if self.wum is None:
            self.wum = StaticPulse()

        if self.propagation not in PROPAGATIONS:
            raise ValueError(
                f"synapse group {self.name!r}: propagation "
                f"{self.propagation!r} not in {PROPAGATIONS}")
        if self.propagation == "event":
            if self.representation == "dense":
                raise ValueError(
                    f"synapse group {self.name!r}: propagation='event' is "
                    "incompatible with representation='dense' (event-driven "
                    "delivery reads the spiking pre-neurons' ELL rows); "
                    "use representation 'sparse' or 'auto'")
            self.representation = "sparse"

        # --- dendritic delays ------------------------------------------
        if not isinstance(self.delay_steps, int) or self.delay_steps < 0:
            raise ValueError(
                f"{self.name}: delay_steps must be a non-negative int, got "
                f"{self.delay_steps!r}")
        if self.ell.delay is not None:
            if self.delay_steps:
                raise ValueError(
                    f"{self.name}: delay_steps={self.delay_steps} and a "
                    "per-synapse delay slot are mutually exclusive; declare "
                    "one of them")
            if tuple(self.ell.delay.shape) != tuple(self.ell.post_ind.shape):
                raise ValueError(
                    f"{self.name}: delay slot shape "
                    f"{tuple(self.ell.delay.shape)} != synapse shape "
                    f"{tuple(self.ell.post_ind.shape)}")
            if self.representation == "dense":
                raise ValueError(
                    f"synapse group {self.name!r}: representation='dense' "
                    "is incompatible with per-synapse delays (the dense "
                    "mirror has no delay slot; currents route through the "
                    "ELL path); use 'sparse' or 'auto'")
            self.representation = "sparse"
            dvals = self.ell.delay
            dmax = int(dvals.max()) if dvals.numel() else 0
            if dvals.numel() and int(dvals.min()) < 0:
                raise ValueError(
                    f"{self.name}: negative per-synapse delay "
                    f"{int(dvals.min())}")
            if self.max_delay is None:
                self.max_delay = dmax
            elif dmax > self.max_delay:
                raise ValueError(
                    f"{self.name}: per-synapse delay {dmax} exceeds the "
                    f"declared ring bound max_delay={self.max_delay}")
        else:
            self.max_delay = self.delay_steps

        # A non-default weight-update model, or a custom update writing g,
        # propagates through the ELL effective-weight path (the weights
        # live in state), so a dense mirror would go stale: 'dense' is a
        # conflict, 'auto' -> sparse.
        if not self.wum.is_static_pulse or self.mutable_g:
            if self.representation == "dense":
                what = ("a custom update writing g"
                        if self.mutable_g and self.wum.is_static_pulse
                        else f"weight-update model {self.wum.name!r}")
                raise ValueError(
                    f"synapse group {self.name!r}: representation='dense' "
                    f"is incompatible with {what} (dynamic weights "
                    "propagate via the ELL path); use 'sparse' or 'auto'")
            self.representation = "sparse"
        elif self.representation == "auto":
            nnz = self.ell.n_pre * self.ell.max_conn
            self.representation = F.choose_representation(
                self.ell.n_pre, self.ell.n_post, nnz)
        if self.representation == "dense" and self.dense is None:
            self.dense = F.ell_to_dense(self.ell)

        # --- propagation mode (declared -> effective), as the JAX package
        # reports it: 'auto' asks the occupancy/activity crossover model
        # whether event-driven delivery beats the full pass for this
        # group's shape; an explicit 'event' keeps the modelled capacity.
        # Both modes run the one live-row kernel here (it skips silent
        # rows itself), so the mode is what a planner reads, not a path.
        # The feasibility term is the card's: with a card the model reads
        # the built kernel's registers, without one the shape alone.
        self.propagation_declared = self.propagation
        if self.representation == "dense" or self.propagation == "dense":
            self.propagation_mode = "dense"
            self.event_capacity = None
        else:
            cfg = AT.choose_propagation(
                self.ell.n_pre, self.ell.max_conn, self.ell.n_post,
                n_slots=(self.ring_slots if self.ell.delay is not None
                         else 1),
                tag=self.name)
            self.propagation_mode = ("event" if self.propagation == "event"
                                     else cfg["mode"])
            self.event_capacity = (int(cfg["capacity"])
                                   if self.propagation_mode == "event"
                                   else None)

        # --- code generation: compile the synapse models once per group ---
        self._psm_step = compile_postsynaptic(self.psm)
        self._wu: CompiledWeightUpdate = compile_weight_update(self.wum)
        dev = self.ell.device
        # snippets read `delay` as float32: the per-synapse slot, or the
        # scalar delay_steps (0.0 on delay-free groups)
        self._delay_f = (self.ell.delay.to(torch.float32)
                         if self.ell.delay is not None
                         else torch.tensor(float(self.delay_steps),
                                           dtype=torch.float32, device=dev))
        self._t0 = torch.zeros((), dtype=torch.float32, device=dev)
        self._gather = (self.ell.post_ind.long()
                        if self._wu.learn is not None else None)
        self._device = dev
        # the delay scatter's float64 scratch [S, n_post, B] for the last
        # step's (B, device, n_post), zero between steps (the fold zeroes
        # what the scatter added)
        self._acc: Optional[torch.Tensor] = None
        self._acc_key: Optional[Tuple[int, torch.device, int]] = None
        # each member's first ring row in the flattened ring [B * S, n_post]
        # (the homogeneous delay's index ops), by (B, device)
        self._row0: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def swap_scratch(self, acc: Optional[torch.Tensor]
                     ) -> Optional[torch.Tensor]:
        """Make ``acc`` (a zeroed [S, n_post, B] float64 tensor, or None
        for one made at the next step) the delay scatter's scratch; returns
        the one it replaces.  A compiled run keeps its own this way, since
        its graphs write one scratch at every replay."""
        old = self._acc
        self._acc = acc
        self._acc_key = (None if acc is None
                         else (acc.shape[2], acc.device, acc.shape[1]))
        return old

    def _ring_row0(self, batch: int, n_slots: int,
                   device: torch.device) -> torch.Tensor:
        """[B] int64: member b's first row b * S in the flattened ring
        (made at a group's first eager step, before any capture)."""
        row0 = self._row0.get((batch, device))
        if row0 is None:
            row0 = self._row0[(batch, device)] = (
                torch.arange(batch, device=device) * n_slots)
        return row0

    @property
    def plastic(self) -> bool:
        """True when g is state-resident: a learn_code rewrites it during
        the simulation, or a custom update may rewrite it."""
        return bool(self.wum.learn_code) or self.mutable_g

    @property
    def needs_ring(self) -> bool:
        """True when this group carries a dendritic-delay ring (homogeneous
        delay_steps > 0 or a per-synapse delay slot, even an all-zero one)."""
        return self.max_delay > 0 or self.ell.delay is not None

    @property
    def ring_slots(self) -> int:
        return self.max_delay + 1

    # -- state ------------------------------------------------------------
    def init_state(self, batch: int = 1) -> SynapseState:
        n_pre, n_post, k = self.ell.n_pre, self.ell.n_post, self.ell.max_conn
        dev = self._device

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.float32, device=dev)

        psm = {n: full((batch, n_post), v) for n, v in self.psm.state.items()}
        wu_pre = {n: full((batch, n_pre), v)
                  for n, v in self.wum.pre_state.items()}
        wu_post = {n: full((batch, n_post), v)
                   for n, v in self.wum.post_state.items()}
        syn = {n: full((batch, n_pre, k), v)
               for n, v in self.wum.syn_state.items()}
        g = (self.ell.g.expand(batch, n_pre, k).clone()
             if self.plastic else None)
        if self.needs_ring:
            buf = full((batch, self.ring_slots, n_post), 0.0)
            cur = torch.zeros(batch, dtype=torch.int32, device=dev)
        else:
            buf, cur = None, None
        return SynapseState(psm=psm, wu_pre=wu_pre, wu_post=wu_post, g=g,
                            syn=syn, dendritic=buf, cursor=cur)

    # -- propagation -------------------------------------------------------
    def _effective_ell(self, g: Optional[torch.Tensor],
                       syn: Dict[str, torch.Tensor],
                       externals: Dict[str, object],
                       ell: F.ELLSynapses) -> F.ELLSynapses:
        """The ELL to propagate this step: ``ell`` (the stored one, or a
        rank's block) for static groups, or one carrying this step's
        effective weights (computed once per step)."""
        if self.wum.is_static_pulse:
            if g is None:
                return ell
            # state-resident static weights (mutable_g): the kernel reads
            # only valid slots, and custom updates write only those
            return F.ELLSynapses(g=g, post_ind=ell.post_ind, valid=ell.valid,
                                 n_post=ell.n_post, delay=ell.delay)
        g_cur = ell.g if g is None else g
        w_eff = self._wu.effective_weight(g_cur, syn, self.wum.params,
                                          externals)
        w_eff = torch.where(ell.valid, w_eff, 0.0).contiguous()
        return F.ELLSynapses(g=w_eff, post_ind=ell.post_ind, valid=ell.valid,
                             n_post=ell.n_post, delay=ell.delay)

    def _raw_current(self, spikes: torch.Tensor, gscale: Scale,
                     g: Optional[torch.Tensor], syn: Dict[str, torch.Tensor],
                     externals: Dict[str, object], ell: F.ELLSynapses,
                     dense: Optional[torch.Tensor]) -> torch.Tensor:
        """sign * gscale * sum_i spike_i * w_eff_ij for this step's arriving
        spikes [B, n_pre] -> [B, n_post]."""
        if (self.wum.is_static_pulse and g is None
                and self.representation == "dense"):
            out = sparse_ops.accumulate_dense(dense, spikes)
        else:
            out = kops.ell_spmv_batched(
                self._effective_ell(g, syn, externals, ell), spikes)
        return _scale(self.sign, gscale, out)

    def _delay_fold(self, ring: torch.Tensor, cursor: torch.Tensor,
                    spikes: torch.Tensor, gscale: Scale,
                    g: Optional[torch.Tensor], syn: Dict[str, torch.Tensor],
                    externals: Dict[str, object], ell: F.ELLSynapses
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Heterogeneous delays: this step's spikes scattered into the
        scratch (slot d = currents due d steps from now), then folded into
        a new ring at row (cursor + d) % S, scaled by sign * gscale, with
        the cursor's row read out and cleared.  Returns (new_ring, inj,
        new_cursor)."""
        key = (spikes.shape[0], spikes.device, ell.n_post)
        if key != self._acc_key:
            # one scratch at a time: the old one goes before the new one
            self._acc = self._acc_key = None
            self._acc = torch.zeros((self.ring_slots, ell.n_post, key[0]),
                                    dtype=torch.float64,
                                    device=spikes.device)
            self._acc_key = key
        try:
            kops.ell_spmv_delay_into(
                self._effective_ell(g, syn, externals, ell), spikes,
                self._acc)
            return kops.delay_ring_fold(ring, self._acc, cursor, self.sign,
                                        gscale)
        except BaseException:
            # a scratch that may hold this step's adds is not reused
            self._acc = self._acc_key = None
            raise

    def step(
        self, state: SynapseState, spikes: torch.Tensor, gscale: Scale,
        dt: float, v_post: Optional[torch.Tensor] = None,
        post_spikes: Optional[torch.Tensor] = None,
        t: Optional[torch.Tensor] = None,
        conn: Optional[LocalConnectivity] = None,
        pre_traces: Optional[Dict[str, torch.Tensor]] = None,
    ) -> tuple[SynapseState, torch.Tensor]:
        """Advance one step; returns (new_state, current into post neurons
        [B, n_post]).

        spikes/post_spikes: last step's bool spikes [B, n_pre] / [B, n_post];
        gscale: a scalar or a per-batch-member [B] tensor; t: the members'
        times [B] (code reads it as [B, 1], a synapse matrix's as
        [B, 1, 1]).

        ``conn`` overrides the stored connectivity (the sharded engine's
        post-shard block); every post-side shape then follows it, and a
        delayed group's scatter takes the block's delays into the same
        float64 scratch and fold.  ``pre_traces``: when not None the caller
        owns the pre traces (the engine advances its pre-sharded copy):
        the pre step is skipped, ``state.wu_pre`` passes through, and the
        learn rule reads these full-size [B, n_pre] traces.

        Weights (and gscale) are applied at *spike* time, GeNN's dendritic-
        delay semantics; the delay ring buffers the weighted current.
        """
        if conn is None:
            ell, dense = self.ell, self.dense
            delay_f, gather = self._delay_f, self._gather
        else:
            ell, dense = conn.ell, conn.dense
            delay_f = (conn.delay_f if conn.delay_f is not None
                       else self._delay_f)
            gather = conn.gather
        t = self._t0 if t is None else t[:, None]
        wu_ext = {"dt": dt, "t": t, "delay": delay_f}
        syn_ext = {**wu_ext, "t": t[..., None]}

        if not self.needs_ring:
            inj = self._raw_current(spikes, gscale, state.g, state.syn,
                                    syn_ext, ell, dense)
            new_buf, new_cur = state.dendritic, state.cursor
        else:
            S = self.ring_slots
            cur = state.cursor
            if ell.delay is None:
                # homogeneous: one full accumulation, one slot a member
                # written, the rows picked by index ops on the device
                # cursors, in the ring flattened to [B * S, n_post]
                contrib = self._raw_current(spikes, gscale, state.g,
                                            state.syn, syn_ext, ell, dense)
                ring = state.dendritic.clone()
                flat = ring.view(-1, ring.shape[-1])
                row0 = self._ring_row0(ring.shape[0], S, ring.device)
                row = cur.long()
                flat.index_add_(0, row0 + torch.remainder(
                    row + self.delay_steps, S), contrib)
                at = row0 + row
                inj = flat.index_select(0, at)
                flat.index_fill_(0, at, 0.0)  # a fresh tensor: in place
                new_cur = torch.remainder(cur + 1, S).to(torch.int32)
            else:
                # delay scatter + ring fold; the new ring is a fresh tensor
                ring, inj, new_cur = self._delay_fold(
                    state.dendritic, cur, spikes, gscale, state.g,
                    state.syn, syn_ext, ell)
            new_buf = ring

        # -- learning (generated weight-update code) -----------------------
        # pre traces and learning fire at spike (emission) time
        new_pre, new_post = state.wu_pre, state.wu_post
        new_g, new_syn = state.g, state.syn
        if self.wum.has_learning:
            pre_spk = spikes.to(torch.float32)
            post_spk = (post_spikes.to(torch.float32)
                        if post_spikes is not None
                        else torch.zeros((spikes.shape[0], ell.n_post),
                                         dtype=torch.float32,
                                         device=spikes.device))
            if pre_traces is None and self._wu.pre_step is not None:
                new_pre = self._wu.pre_step(
                    state.wu_pre, self.wum.params,
                    {**wu_ext, "pre_spike": pre_spk})
            if self._wu.post_step is not None:
                new_post = self._wu.post_step(
                    state.wu_post, self.wum.params,
                    {**wu_ext, "post_spike": post_spk})
            if self._wu.learn is not None:
                traces = {"pre_spike": pre_spk[:, :, None],
                          "post_spike": post_spk[:, gather]}
                pre_read = new_pre if pre_traces is None else pre_traces
                traces.update({k: v[:, :, None] for k, v in pre_read.items()})
                traces.update({k: v[:, gather] for k, v in new_post.items()})
                g_learn, new_syn = self._wu.learn(
                    state.g, state.syn, traces, self.wum.params, syn_ext)
                new_g = torch.where(ell.valid, g_learn, state.g)

        # -- postsynaptic dynamics (generated decay/apply code) ------------
        psm_ext = {"inj": inj, "dt": dt, "t": wu_ext["t"]}
        if self.psm.needs_v:
            if v_post is None:
                raise ValueError(
                    f"synapse group {self.name!r}: postsynaptic model "
                    f"{self.psm.name!r} references V but the post population "
                    "has no membrane state 'V'")
            psm_ext["V"] = v_post
        new_psm, current = self._psm_step(state.psm, self.psm.params, psm_ext)

        new_state = SynapseState(psm=new_psm, wu_pre=new_pre,
                                 wu_post=new_post, g=new_g, syn=new_syn,
                                 dendritic=new_buf, cursor=new_cur)
        return new_state, current

    # -- memory accounting (paper eqs (1)/(2)) -------------------------------
    def state_elements(self) -> int:
        """Dynamic state one simulation (one batch member) of this group
        carries: postsynaptic, trace and per-synapse vars, state-resident
        g, and the dendritic ring with its cursor."""
        n_pre, n_post = self.ell.n_pre, self.ell.n_post
        nnz = n_pre * self.ell.max_conn
        total = (len(self.psm.state) * n_post
                 + len(self.wum.pre_state) * n_pre
                 + len(self.wum.post_state) * n_post
                 + len(self.wum.syn_state) * nnz)
        if self.plastic:
            total += nnz
        if self.needs_ring:
            total += self.ring_slots * n_post + 1
        return total

    def memory_report(self) -> dict:
        """The JAX package's per-group report, ``propagation_mode`` and
        ``event_capacity`` from the crossover model (``__post_init__``)."""
        nnz = self.ell.n_pre * self.ell.max_conn
        return {
            "name": self.name,
            "representation": self.representation,
            "propagation": self.propagation_declared,
            "propagation_mode": self.propagation_mode,
            "event_capacity": self.event_capacity,
            "sparse_elements": F.sparse_memory_elements(
                nnz, self.ell.n_pre, self.ell.n_post),
            "dense_elements": F.dense_memory_elements(
                self.ell.n_pre, self.ell.n_post),
            "max_delay": self.max_delay,
            "dendritic_ring_elements": (
                self.ring_slots * self.ell.n_post if self.needs_ring else 0),
            "state_elements": self.state_elements(),
        }
