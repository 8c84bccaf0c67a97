"""GeNN-style code generation, lowered to PyTorch.

Counterpart of ``repro/core/codegen.py``.  Users declare models as code
snippets (`sim_code`, `threshold_code`, `reset_code`, ...) plus parameter
lists; "code generation" is the pipeline

    equation strings --ast-validate/rewrite--> python code objects
                     --exec over torch tensors--> the update, op by op

The whitelist, the rewriting and the reserved-name checks are the JAX
package's own; only the whitelisted functions are lowered to ``torch.*``.

Security note: equation strings are compiled only after a strict AST
whitelist pass (arithmetic, comparisons, boolean ops rewritten to
``logical_*``, ternaries rewritten to ``where``, calls restricted to a math
whitelist, no attributes/subscripts/imports), and executed with empty
builtins.

Scalars: snippet arithmetic may mix Python floats, 0-dim float32 tensors
(``dt``, ``t``) and per-neuron tensors.  The whitelisted functions accept
all three, as ``jnp`` does, and compute in float32.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

# The first comparison of a tensor with a Python number in a process makes
# torch import a module from C, through the calling frame's builtins.
# Snippets run with empty builtins, where that import fails (KeyError:
# '__import__'), so make it here, once, with the builtins intact.
torch.zeros(()) > 0.0

__all__ = [
    "NeuronModel",
    "PostsynapticModel",
    "WeightUpdateModel",
    "CodegenError",
    "compile_sim",
    "compile_postsynaptic",
    "compile_weight_update",
    "compile_expr",
    "compile_custom_update",
    "assigned_names",
    "generated_source",
]


class CodegenError(ValueError):
    """Raised when a model code snippet fails validation."""


def _tensor(x, like=None) -> torch.Tensor:
    """``x`` as a tensor: tensors pass through; Python numbers become
    float32 (bools: bool) tensors on ``like``'s device, filled there (no
    copy from the host, which a CUDA graph capture would refuse)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    dt = torch.bool if isinstance(x, bool) else torch.float32
    return torch.full((), x, dtype=dt, device=dev)


def _unary(fn):
    return lambda x: fn(_tensor(x))


def _minimum(a, b):
    if not isinstance(b, torch.Tensor):
        return torch.clamp(_tensor(a), max=b)
    if not isinstance(a, torch.Tensor):
        return torch.clamp(b, max=a)
    return torch.minimum(a, b)


def _maximum(a, b):
    if not isinstance(b, torch.Tensor):
        return torch.clamp(_tensor(a), min=b)
    if not isinstance(a, torch.Tensor):
        return torch.clamp(b, min=a)
    return torch.maximum(a, b)


def _clip(x, lo, hi):
    # jnp.clip's definition: minimum(maximum(x, lo), hi)
    return _minimum(_maximum(x, lo), hi)


def _where(cond, x, y):
    return torch.where(_tensor(cond).to(torch.bool), x, y)


def _power(a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = _tensor(a)
    return torch.pow(a, b)


def _logical(fn):
    def op(a, b):
        like = a if isinstance(a, torch.Tensor) else b
        return fn(_tensor(a, like), _tensor(b, like))
    return op


# Functions user code may call, lowered to torch.
_FUNC_WHITELIST: Dict[str, Callable[..., Any]] = {
    "exp": _unary(torch.exp),
    "expm1": _unary(torch.expm1),
    "log": _unary(torch.log),
    "log1p": _unary(torch.log1p),
    "sqrt": _unary(torch.sqrt),
    "tanh": _unary(torch.tanh),
    "sin": _unary(torch.sin),
    "cos": _unary(torch.cos),
    "abs": _unary(torch.abs),
    "minimum": _minimum,
    "maximum": _maximum,
    "clip": _clip,
    "where": _where,
    "power": _power,
    "floor": _unary(torch.floor),
    "sign": _unary(torch.sign),
    "isfinite": _unary(torch.isfinite),
}

_ALLOWED_NODES = (
    ast.Module, ast.Expression, ast.Expr, ast.Assign, ast.AugAssign,
    ast.Name, ast.Load,
    ast.Store, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.Call,
    ast.Constant, ast.IfExp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow,
    ast.Mod, ast.USub, ast.UAdd, ast.Not, ast.And, ast.Or, ast.Lt, ast.Gt,
    ast.LtE, ast.GtE, ast.Eq, ast.NotEq, ast.keyword, ast.Tuple,
)


@dataclasses.dataclass(frozen=True)
class NeuronModel:
    """A GeNN-style declarative neuron model.

    state:          state variable name -> default initial value
    params:         parameter name -> default value (scalars; instances may
                    override with per-neuron arrays)
    sim_code:       statements advancing the state by one step ``dt``.
                    May reference state vars, params, and the externals
                    ``Isyn`` (summed synaptic input), ``dt``, ``t`` and
                    ``rand`` (per-neuron U(0,1) draw, fresh each step).
    threshold_code: boolean expression; True => the neuron emits a spike.
    reset_code:     statements applied (masked) to neurons that spiked.
    """

    name: str
    state: Mapping[str, float]
    params: Mapping[str, float]
    sim_code: str
    threshold_code: str = ""
    reset_code: str = ""

    def __post_init__(self) -> None:
        _check_reserved(self.name, _EXTERNALS,
                        state=self.state, params=self.params)

    # cached: the simulator asks every step, and a parse costs more than
    # the population's update (the frozen dataclass's fields are unchanged)
    @functools.cached_property
    def needs_rand(self) -> bool:
        return any(
            "rand" in _names(code)
            for code in (self.sim_code, self.threshold_code, self.reset_code)
            if code
        )


def _check_reserved(model_name: str, reserved, **groups) -> None:
    """Eager name validation: a state/param var shadowing a reserved
    external (or another var group) would silently replace the real value
    in the generated environment instead of erroring."""
    seen: Dict[str, str] = {}
    for gname, keys in groups.items():
        for k in keys:
            if k in reserved:
                raise CodegenError(
                    f"{model_name}: {gname} name {k!r} collides with the "
                    f"reserved names {sorted(reserved)}")
            if k in seen:
                raise CodegenError(
                    f"{model_name}: name {k!r} declared in both "
                    f"{seen[k]} and {gname}")
            seen[k] = gname


def _names(code: str) -> set:
    try:
        tree = ast.parse(code or "0", mode="exec")
    except SyntaxError:
        return set()
    return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}


class _Rewriter(ast.NodeTransformer):
    """Rewrite python boolean semantics into array semantics."""

    def visit_BoolOp(self, node: ast.BoolOp) -> ast.AST:
        self.generic_visit(node)
        fn = "logical_and" if isinstance(node.op, ast.And) else "logical_or"
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.Call(
                func=ast.Name(id=f"__{fn}", ctx=ast.Load()), args=[out, v],
                keywords=[])
        return out

    def visit_UnaryOp(self, node: ast.UnaryOp) -> ast.AST:
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(
                func=ast.Name(id="__logical_not", ctx=ast.Load()),
                args=[node.operand], keywords=[])
        return node

    def visit_IfExp(self, node: ast.IfExp) -> ast.AST:
        self.generic_visit(node)
        return ast.Call(
            func=ast.Name(id="__where", ctx=ast.Load()),
            args=[node.test, node.body, node.orelse], keywords=[])


_REWRITE_FUNCS = {
    "__logical_and": _logical(torch.logical_and),
    "__logical_or": _logical(torch.logical_or),
    "__logical_not": _unary(torch.logical_not),
    "__where": _where,
}


def _validate(tree: ast.AST, allowed_names: set, what: str) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise CodegenError(
                f"{what}: disallowed syntax {type(node).__name__!r}")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name):
                raise CodegenError(f"{what}: only plain function calls allowed")
            if node.func.id not in _FUNC_WHITELIST:
                raise CodegenError(
                    f"{what}: call to non-whitelisted function "
                    f"{node.func.id!r}")
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if (node.id not in allowed_names
                    and node.id not in _FUNC_WHITELIST
                    and not node.id.startswith("__")):
                raise CodegenError(f"{what}: unknown name {node.id!r}")


def _compile_block(code: str, allowed_names: set, what: str):
    tree = ast.parse(code, mode="exec")
    _validate(tree, allowed_names, what)
    tree = _Rewriter().visit(tree)
    ast.fix_missing_locations(tree)
    return compile(tree, filename=f"<genn:{what}>", mode="exec")


def compile_expr(code: str, allowed_names: set, what: str = "expr"):
    """Compile a single boolean/scalar expression to a code object."""
    tree = ast.parse(code, mode="eval")
    _validate(tree, allowed_names, what)
    tree = _Rewriter().visit(tree)
    ast.fix_missing_locations(tree)
    return compile(tree, filename=f"<genn:{what}>", mode="eval")


def _assigned_names(code: str) -> set:
    out = set()
    tree = ast.parse(code or "", mode="exec")
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return out


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """A snippet result as a tensor of ``ref``'s shape (a scalar assigned
    to a state var broadcasts over the population, and the batch axis)."""
    return _tensor(x, ref).broadcast_to(ref.shape)


_EXTERNALS = ("Isyn", "dt", "t", "rand")


def compile_sim(model: NeuronModel) -> Callable[..., Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Generate the per-step update function for a neuron model.

    Returns ``update(state, params, externals) -> (new_state, spiked)`` where
    - state:     dict of per-neuron tensors, keys == model.state
    - params:    dict of scalars or per-neuron tensors, keys == model.params
    - externals: dict with any of Isyn/dt/t/rand
    - spiked:    bool tensor of the state's shape (all-False when the model
                 has no threshold).
    """
    state_keys = tuple(model.state)
    param_keys = tuple(model.params)
    allowed = set(state_keys) | set(param_keys) | set(_EXTERNALS)

    sim_assigned = _assigned_names(model.sim_code)
    reset_assigned = _assigned_names(model.reset_code)
    for n in (sim_assigned | reset_assigned) - set(state_keys):
        # Temporaries are fine in sim_code; reset may only touch state.
        if n in reset_assigned and n not in state_keys:
            raise CodegenError(
                f"reset_code assigns non-state variable {n!r}")
    allowed |= sim_assigned  # temporaries become readable after assignment

    sim_code = _compile_block(model.sim_code, allowed, f"{model.name}.sim")
    thr_code = (compile_expr(model.threshold_code, allowed,
                             f"{model.name}.threshold")
                if model.threshold_code else None)
    reset_code = (_compile_block(model.reset_code, allowed,
                                 f"{model.name}.reset")
                  if model.reset_code else None)

    def update(state: Dict[str, torch.Tensor],
               params: Mapping[str, Any],
               externals: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        ref = next(iter(state.values()))
        env = _env_base()
        env.update({k: params[k] for k in param_keys})
        env.update({k: externals[k] for k in _EXTERNALS if k in externals})
        env.update({k: state[k] for k in state_keys})

        exec(sim_code, env)  # noqa: S102 - validated, builtins-stripped

        if thr_code is not None:
            spiked = _like(eval(thr_code, env), ref).to(torch.bool)  # noqa: S307
        else:
            spiked = torch.zeros(ref.shape, dtype=torch.bool,
                                 device=ref.device)

        if reset_code is not None:
            pre_reset = {k: env[k] for k in state_keys}
            exec(reset_code, env)  # noqa: S102
            for k in state_keys:
                env[k] = torch.where(spiked, env[k], pre_reset[k])

        new_state = {k: _like(env[k], state[k]) for k in state_keys}
        return new_state, spiked

    update.__name__ = f"update_{model.name}"
    return update


# ---------------------------------------------------------------------------
# Synapse-side models.  GeNN splits synapse behaviour into a *weight update*
# model (what a spike event does, plus optional learning) and a *postsynaptic*
# model (how arriving input decays and is applied to the neuron).
# ---------------------------------------------------------------------------


def _env_base() -> Dict[str, Any]:
    env: Dict[str, Any] = {"__builtins__": {}}
    env.update(_FUNC_WHITELIST)
    env.update(_REWRITE_FUNCS)
    return env


@dataclasses.dataclass(frozen=True)
class PostsynapticModel:
    """A GeNN-style postsynaptic model: per-post-neuron input dynamics.

    state:      per-post-neuron state var -> initial value
    params:     parameter name -> default value
    decay_code: statements advancing the state by one step.  May reference
                state vars, params, ``dt``, ``t`` and ``inj`` (this step's
                arriving spikes weighted by the synapse matrix, summed per
                post neuron, already scaled by sign*gscale).
    apply_code: expression for the current injected into the post neuron.
                May reference state vars, params, ``inj``, ``dt``, ``t`` and
                ``V`` (the post population's membrane potential).
    """

    name: str
    state: Mapping[str, float] = dataclasses.field(default_factory=dict)
    params: Mapping[str, float] = dataclasses.field(default_factory=dict)
    decay_code: str = ""
    apply_code: str = "inj"

    def __post_init__(self) -> None:
        _check_reserved(self.name, _PSM_EXTERNALS,
                        state=self.state, params=self.params)

    @functools.cached_property
    def needs_v(self) -> bool:
        return "V" in _names(self.apply_code) | _names(self.decay_code)


_PSM_EXTERNALS = ("inj", "dt", "t", "V")


def compile_postsynaptic(model: PostsynapticModel) -> Callable[..., Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Generate the per-step input-dynamics function for a synapse group.

    Returns ``step(state, params, externals) -> (new_state, current)`` where
    externals provides any of ``inj``/``dt``/``t``/``V``.
    """
    state_keys = tuple(model.state)
    param_keys = tuple(model.params)
    allowed = set(state_keys) | set(param_keys) | set(_PSM_EXTERNALS)
    allowed |= _assigned_names(model.decay_code)

    decay = (_compile_block(model.decay_code, allowed, f"{model.name}.decay")
             if model.decay_code else None)
    apply_ = compile_expr(model.apply_code, allowed, f"{model.name}.apply")

    def step(state: Dict[str, torch.Tensor], params: Mapping[str, Any],
             externals: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        env = _env_base()
        env.update({k: params[k] for k in param_keys})
        env.update({k: externals[k] for k in _PSM_EXTERNALS
                    if k in externals})
        env.update({k: state[k] for k in state_keys})
        if decay is not None:
            exec(decay, env)  # noqa: S102 - validated, builtins-stripped
        current = _tensor(eval(apply_, env), externals.get("inj"))  # noqa: S307
        return {k: _like(env[k], state[k]) for k in state_keys}, current

    step.__name__ = f"psm_{model.name}"
    return step


@dataclasses.dataclass(frozen=True)
class WeightUpdateModel:
    """A GeNN-style weight-update model: spike events + optional learning.

    spike_code: per-synapse *expression* for the contribution a presynaptic
                spike adds to the post neuron's input (GeNN's addToInSyn).
                May reference ``g``, syn_state vars, params and ``delay``
                (the per-synapse dendritic delay in dt steps, as float32;
                the scalar delay_steps on homogeneous groups, 0.0 on
                delay-free ones).
    syn_state:  extra per-synapse variables (same shape as ``g``).
    pre_state / post_state:
                per-pre- / per-post-neuron trace variables -> initial value.
    pre_code / post_code:
                statements advancing the traces each step.  May reference the
                trace vars, params, ``dt``, ``t`` and ``pre_spike`` /
                ``post_spike`` (0/1 float tensors over the population).
    learn_code: statements updating per-synapse variables (``g`` and
                syn_state) each step.  Pre-side names (pre traces,
                ``pre_spike``) broadcast as [.., n_pre, 1]; post-side names
                are gathered to synapse shape [.., n_pre, max_conn].  May also
                read ``delay`` (per-synapse dendritic delay, float32).
    """

    name: str
    params: Mapping[str, float] = dataclasses.field(default_factory=dict)
    syn_state: Mapping[str, float] = dataclasses.field(default_factory=dict)
    pre_state: Mapping[str, float] = dataclasses.field(default_factory=dict)
    post_state: Mapping[str, float] = dataclasses.field(default_factory=dict)
    spike_code: str = "g"
    pre_code: str = ""
    post_code: str = ""
    learn_code: str = ""

    def __post_init__(self) -> None:
        _check_reserved(self.name,
                        {"g", "pre_spike", "post_spike", "delay"}
                        | set(_WU_EXTERNALS),
                        params=self.params, syn_state=self.syn_state,
                        pre_state=self.pre_state, post_state=self.post_state)

    @property
    def has_learning(self) -> bool:
        return bool(self.learn_code or self.pre_code or self.post_code)

    @property
    def is_static_pulse(self) -> bool:
        """True when propagation can use the stored matrix unmodified."""
        return (self.spike_code.strip() == "g" and not self.has_learning
                and not self.syn_state)


_WU_EXTERNALS = ("dt", "t")
# per-synapse-shaped externals visible to spike_code / learn_code only
_WU_SYN_EXTERNALS = ("dt", "t", "delay")


@dataclasses.dataclass(frozen=True)
class CompiledWeightUpdate:
    """Executable pieces of a WeightUpdateModel (see compile_weight_update)."""

    effective_weight: Callable[..., torch.Tensor]
    pre_step: Optional[Callable[..., Dict[str, torch.Tensor]]] = None
    post_step: Optional[Callable[..., Dict[str, torch.Tensor]]] = None
    learn: Optional[Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]] = None


def compile_weight_update(model: WeightUpdateModel) -> "CompiledWeightUpdate":
    """Generate the executable pieces of a weight-update model.

    - effective_weight(g, syn_state, params): eval of spike_code, per-synapse
    - pre_step(pre_state, params, externals{pre_spike,dt,t}) -> new state
    - post_step(post_state, params, externals{post_spike,dt,t}) -> new state
    - learn(g, syn_state, traces, params, externals) -> (new_g, new_syn_state)
      where ``traces`` maps every pre/post trace var (and pre_spike /
      post_spike) to a tensor already broadcast/gathered to synapse shape.
    """
    param_keys = tuple(model.params)
    syn_keys = tuple(model.syn_state)
    pre_keys = tuple(model.pre_state)
    post_keys = tuple(model.post_state)

    w_allowed = ({"g"} | set(syn_keys) | set(param_keys)
                 | set(_WU_SYN_EXTERNALS))
    w_code = compile_expr(model.spike_code, w_allowed,
                          f"{model.name}.spike")

    def effective_weight(g, syn_state, params, externals=None):
        env = _env_base()
        env.update({k: params[k] for k in param_keys})
        env.update({k: (externals or {})[k] for k in _WU_SYN_EXTERNALS
                    if k in (externals or {})})
        env["g"] = g
        env.update({k: syn_state[k] for k in syn_keys})
        return _tensor(eval(w_code, env), g)  # noqa: S307

    def _trace_step(code_str, keys, spike_name, what):
        allowed = (set(keys) | set(param_keys) | {spike_name}
                   | set(_WU_EXTERNALS))
        allowed |= _assigned_names(code_str)
        code = _compile_block(code_str, allowed, what)

        def step(state, params, externals):
            env = _env_base()
            env.update({k: params[k] for k in param_keys})
            env.update({k: externals[k] for k in (spike_name,) + _WU_EXTERNALS
                        if k in externals})
            env.update({k: state[k] for k in keys})
            exec(code, env)  # noqa: S102
            return {k: _like(env[k], state[k]) for k in keys}

        return step

    pre_step = (_trace_step(model.pre_code, pre_keys, "pre_spike",
                            f"{model.name}.pre")
                if model.pre_code else None)
    post_step = (_trace_step(model.post_code, post_keys, "post_spike",
                             f"{model.name}.post")
                 if model.post_code else None)

    learn = None
    if model.learn_code:
        allowed = ({"g", "pre_spike", "post_spike"} | set(syn_keys)
                   | set(pre_keys) | set(post_keys) | set(param_keys)
                   | set(_WU_SYN_EXTERNALS))
        allowed |= _assigned_names(model.learn_code)
        l_code = _compile_block(model.learn_code, allowed,
                                f"{model.name}.learn")

        def learn(g, syn_state, traces, params, externals):
            env = _env_base()
            env.update({k: params[k] for k in param_keys})
            env.update({k: externals[k] for k in _WU_SYN_EXTERNALS
                        if k in externals})
            env.update(traces)
            env["g"] = g
            env.update({k: syn_state[k] for k in syn_keys})
            exec(l_code, env)  # noqa: S102
            return (_tensor(env["g"], g),
                    {k: _like(env[k], syn_state[k]) for k in syn_keys})

    return CompiledWeightUpdate(effective_weight=effective_weight,
                                pre_step=pre_step, post_step=post_step,
                                learn=learn)


def assigned_names(code: str) -> set:
    """Public view of the assignment-target scan (custom-update validation
    uses it to find the state variables an update writes)."""
    return _assigned_names(code)


# ---------------------------------------------------------------------------
# Custom updates (GeNN 4's CustomUpdate): on-demand / scheduled snippets that
# rewrite model state outside the per-step dynamics (weight normalization,
# homeostatic scaling, state resets).  The same AST whitelist and rewriting
# as every other snippet; the reductions enter the environment as plain
# names, computed by the simulator before the code runs.
# ---------------------------------------------------------------------------

_CU_EXTERNALS = ("dt", "t")


def compile_custom_update(name: str, update_code: str, var_keys, param_keys,
                          reduce_keys):
    """Generate the executable body of a custom update.

    Returns ``apply(vars, params, reductions, externals) -> new_vars``:
    - vars:       the target's state tensors (every one returned, assigned
                  or not, in its own shape; temporaries are discarded)
    - params:     update (and, for populations, model) parameters
    - reductions: reduction name -> precomputed tensor, shaped to broadcast
                  against the vars
    - externals:  any of dt / t
    """
    var_keys = tuple(var_keys)
    param_keys = tuple(param_keys)
    reduce_keys = tuple(reduce_keys)
    allowed = (set(var_keys) | set(param_keys) | set(reduce_keys)
               | set(_CU_EXTERNALS))
    allowed |= _assigned_names(update_code)
    code = _compile_block(update_code, allowed, f"{name}.update")

    def apply(vars: Mapping[str, Any], params: Mapping[str, Any],
              reductions: Mapping[str, Any],
              externals: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        env = _env_base()
        env.update({k: params[k] for k in param_keys})
        env.update({k: externals[k] for k in _CU_EXTERNALS
                    if k in externals})
        env.update({k: reductions[k] for k in reduce_keys})
        env.update({k: vars[k] for k in var_keys})
        exec(code, env)  # noqa: S102 - validated, builtins-stripped
        return {k: _tensor(env[k], vars[k]) for k in var_keys}

    apply.__name__ = f"custom_update_{name}"
    return apply


def generated_source(model: NeuronModel) -> str:
    """Human-readable view of what was generated (for docs/debugging)."""
    lines = [
        f"# generated update for neuron model {model.name!r}",
        f"def update_{model.name}(state, params, externals):",
    ]
    for k in model.state:
        lines.append(f"    {k} = state[{k!r}]")
    for k in model.params:
        lines.append(f"    {k} = params[{k!r}]")
    lines.append("    Isyn, dt, t, rand = externals[...]  # as referenced")
    for ln in model.sim_code.strip().splitlines():
        lines.append(f"    {ln.strip()}")
    if model.threshold_code:
        lines.append(f"    spiked = ({model.threshold_code})")
    if model.reset_code:
        lines.append("    # applied where spiked:")
        for ln in model.reset_code.strip().splitlines():
            lines.append(f"    {ln.strip()}")
    lines.append(
        f"    return {{{', '.join(repr(k) + ': ' + k for k in model.state)}}}, spiked")
    return "\n".join(lines)
