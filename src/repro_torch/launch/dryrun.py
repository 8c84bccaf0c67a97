"""The dry run: every (arch x shape x mesh) cell's step traced at full
width on fake tensors, the counterpart of ``repro/launch/dryrun.py``.

One process is rank 0 of a fake process group (``launch.mesh.
init_fake_distributed``: 256 ranks, 512 with ``--multi-pod``) over which
``make_production_mesh`` builds the 16 x 16 ("data", "model") or 2 x 16
x 16 ("pod", "data", "model") mesh.  For each cell the step of the
shape's kind (train: loss, backward and AdamW with ``cfg.microbatches``;
prefill; serve: one decode against a full-length cache) runs once on
fake tensors (``FakeTensorMode``: shapes and dtypes, nothing allocated,
nothing computed), its state placed as the mesh path places it
(``launch/sharding.py``: params and AdamW's state by ``param_specs``,
the batch by ``batch_specs``, the caches by ``cache_shardings``; the
weights replicated for prefill and decode under
``cfg.serve_replicate_weights``).  The trace counts, for this rank:

  * FLOPs (``FlopCounterMode``; the flash-attention and SSD kernels are
    custom ops whose formulas count the kernels' own products, and whose
    fake implementations run the kernels' ``launch_plan``, so a cell a
    kernel cannot launch fails here as it would on the card);
  * bytes: every op that is not a view reads its tensor arguments and
    writes its outputs once (true of the eager ops, a floor for the
    kernels); collectives are counted apart, and neither copies between
    the host and the device nor scalars at all (``StepCounter``);
  * the FLOPs and bytes of the four LM kernels' custom ops apart
    (``core``: flash forward and backward, ``ssd_scan``,
    ``ssd_scan_state``), within the totals;
  * collective operand bytes and counts by kind (all-gather: the operand
    is the result over the group's size; all-reduce, reduce-scatter,
    all-to-all), from the ``c10d`` ops the model code issues
    (``models/layers.py``) and the ``_c10d_functional`` ops of DTensor;
  * the peak of the live bytes on the device: the inputs' blocks, and
    every storage an op makes there until it is freed.

Only the step is counted: placing the inputs is not part of it, as XLA's
``in_shardings`` are not part of the compiled step.  The trace runs at
full depth and counts every op, so the JAX package's depth-1/2 roofline
lowerings (``_roofline_lowering``, ``roofline_terms``: XLA counts a loop
body once) and its HLO parser (``collective_bytes``) have no counterpart
here.  A cell the config does not apply to (``cfg.applicable``) is a SKIP
with its reason; a cell that raises (a data-dependent op, a kernel's
launch plan, a mesh that does not divide) is a FAIL with its error.

Records land in ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``;
``launch/roofline.py`` reads them.  The trace runs on ``cuda`` fake
tensors unless ``--device cpu``; the two count the same (phase 20 of
``chip_smoke.py`` holds them equal on the card).

  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.autotune import H100_RATES
from repro_torch.launch import mesh as MESH
from repro_torch.launch import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "analytic_param_bytes_per_device", "StepCounter", "count_step",
           "prepare_cell", "trace_cell", "fake_group", "run_cell", "main",
           "ART_DIR", "COLLECTIVES", "CORE_OPS"]

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

# collective ops by name -> (kind, the argument that is the operand): the
# c10d ops take their output first (all-reduce works in place), the
# functional ones return it
_COLLECTIVE_OPS = {
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", 0),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
}
# the LM kernels' custom ops, whose FLOPs and bytes the counter also keeps
# apart (``core``): the attention and SSD cores that hillclimb's
# ``no_core`` variant leaves out, as the JAX dry run's
# ``ROOFLINE_NO_ATTN`` / ``_NO_SSD`` flags do
CORE_OPS = ("flash_attention_fwd", "flash_attention_bwd", "ssd_scan",
            "ssd_scan_state")
# ops that touch no tensor memory: allocation alone, and waits
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor"}

# the dry run's optimizer: the JAX dry run's AdamWConfig(lr=3e-4)
OCFG = adamw.AdamWConfig(lr=3e-4)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _local(t):
    """A placed tensor's block on this rank, else the tensor itself."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and isinstance(t, dt.DTensor):
        return t._local_tensor
    return t


def _tensors(tree):
    return [_local(t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Bytes, collectives and the peak of live bytes of the ops it sees,
    on this rank (placed tensors counted by their blocks); on fake and on
    real tensors alike.  Only arrays in ``device``'s memory count: not a
    tensor on another device, nor an op whose tensors lie on more than
    one (a copy from the host), nor a scalar (a 0-dim tensor: the
    optimizer's step arithmetic, which runs on the host beside a card and
    on the device beside the CPU).  ``track(tree)`` adds tensors that are
    alive before the step (its inputs) to the live bytes."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = torch.device(device)
        self.bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.core_bytes = {k: 0 for k in CORE_OPS}
        self._live: Dict[int, int] = {}
        self._refs = []
        self.live = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _register(self, t: torch.Tensor) -> None:
        if t.device != self.device or t.dim() == 0:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = _nbytes(t)
        self._live[key] = nbytes
        self.live += nbytes
        self._refs.append(weakref.ref(st, lambda _, k=key: self._free(k)))

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._register(t)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = (func.namespace, packet.__name__)
        if name in _COLLECTIVE_OPS:
            kind, which = _COLLECTIVE_OPS[name]
            self.coll_bytes[kind] += sum(
                _nbytes(t) for t in _tensors(args[which]))
            self.coll_counts[kind] += 1
        elif not func.is_view and packet.__name__ not in _NO_BYTES \
                and func.namespace != "prim":
            ts = _tensors((args, kwargs)) + _tensors(out)
            if all(t.device == self.device for t in ts):
                n = sum(_nbytes(t) for t in ts if t.dim())
                self.bytes += n
                if func.namespace == "repro_torch" \
                        and packet.__name__ in self.core_bytes:
                    self.core_bytes[packet.__name__] += n
        for t in _tensors(out):
            self._register(t)
        self.peak = max(self.peak, self.live)
        return out

    def result(self) -> dict:
        return {"bytes": self.bytes, "peak_bytes": self.peak,
                "core": {k: {"bytes": v} for k, v in self.core_bytes.items()},
                "collectives": {
                    "bytes": dict(self.coll_bytes),
                    "counts": dict(self.coll_counts),
                    "total_bytes": sum(self.coll_bytes.values())}}


def count_step(step, args, ctx=None) -> dict:
    """Run ``step(*args)`` once under ``FlopCounterMode`` and a
    ``StepCounter`` on the device of ``args``' tensors (``args`` tracked
    as live; ``ctx``: a context the step runs in, such as
    ``sharding.activate``): its FLOPs, bytes, collectives and peak live
    bytes on this rank, and the seconds it took."""
    counter = StepCounter(next(t.device for t in _tensors(args)))
    counter.track(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with ctx or contextlib.nullcontext(), flops, counter:
        out = step(*args)
    secs = time.perf_counter() - t0
    del out
    rec = {"flops": int(flops.get_total_flops()), **counter.result(),
           "trace_s": secs}
    by_op = {getattr(op, "__name__", str(op)): n for op, n in
             flops.get_flop_counts().get("Global", {}).items()}
    for name, core in rec["core"].items():
        core["flops"] = int(by_op.get(name, 0))
    return rec


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _effective_mb(n_mb_cfg: int, global_batch: int) -> int:
    """The JAX dry run's microbatch count: at most ``n_mb_cfg``, dividing
    the global batch, each microbatch divisible by the batch axes' extent
    (or the batch dim stops sharding and activations replicate)."""
    shards = max(1, L._AXIS_ENV.get("batch_size", 1)) \
        if L._AXIS_ENV["active"] else 1
    mb = min(n_mb_cfg, global_batch)
    while mb > 1 and ((global_batch % mb) or (global_batch // mb) % shards):
        mb -= 1
    return mb


def make_train_step(cfg: ArchConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with gradient accumulation over ``cfg.microbatches`` (the
    JAX dry run's): big-model train cells do not fit their activations at
    the full batch, and accumulation bounds them to one microbatch at the
    cost of gathering the FSDP weights again each microbatch.  Microbatch
    i is rows [i r, (i + 1) r) of the batch; the gradients sum in float32
    and are divided by the count, then AdamW (``OCFG``) updates in place.
    Under ``sharding.activate`` the batch is this rank's rows (the count
    is chosen from the global batch, as in the JAX package)."""
    n_mb_cfg = max(1, getattr(cfg, "microbatches", 1))

    def grads_of(params, leaves, batch):
        loss, metrics = T.loss_fn(params, cfg, batch)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        leaves, spec = tree_flatten(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        rows = batch["tokens"].shape[0]
        n_mb = _effective_mb(n_mb_cfg, rows * (
            L._AXIS_ENV["batch_size"] if L.batch_sharded() else 1))
        if n_mb == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
        else:
            r = rows // n_mb
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = None
            for i in range(n_mb):
                mb = {k: v[i * r:(i + 1) * r] for k, v in batch.items()}
                mloss, metrics, g = grads_of(params, leaves, mb)
                for a, b in zip(gsum, g):
                    a.add_(b)
                mloss = mloss.detach()
                loss = mloss if loss is None else loss + mloss
                del g
            grads = [g / n_mb for g in gsum]
            del gsum
            loss = loss / n_mb
        grads = tree_unflatten(list(grads), spec)
        new_params, new_opt, om = adamw.update(OCFG, grads, opt_state,
                                               params)
        return new_params, new_opt, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, tokens, extra):
        return T.prefill(params, cfg, tokens, extra)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, caches, token):
        return T.decode_step(params, cfg, caches, token)
    return serve_step


def analytic_param_bytes_per_device(params_struct, specs, mesh) -> int:
    """Sum over leaves of their bytes over the shards their spec splits
    them into (``mesh.shape``'s sizes)."""
    total = 0
    for leaf, spec in zip(tree_flatten(params_struct)[0],
                          tree_flatten(specs, is_leaf=_is_spec)[0]):
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                shards *= mesh.shape[a]
        total += leaf.numel() * leaf.element_size() // shards
    return int(total)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def _replicated(params, mesh):
    """Params placed whole on every rank (``serve_replicate_weights``)."""
    def place(p):
        if isinstance(p, dict):
            return {k: place(v) for k, v in p.items()}
        if isinstance(p, list):
            return [place(v) for v in p]
        return SH.NamedSharding(mesh, (None,) * p.dim()).distribute(
            p.detach())
    return place(params)


def _owned(tree):
    """Every tensor of ``tree`` in storage of its own (a block taken from
    a whole tensor is a view of it)."""
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree


def prepare_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, params, inputs):
    """(step, args, ctx): the step of ``shape``'s kind, its inputs placed
    on ``mesh`` (None: one device, unplaced) and the context it runs in.
    ``params``: the whole parameter tree; ``inputs``: the whole inputs in
    ``input_specs``' tree (fake or real tensors, made by the caller).
    Prefill and decode on a mesh run as the server runs them: this rank's
    rows where the batch axes divide the batch, the logits joined over
    them, the caches stored in ``cache_shardings``' layout (a decode
    attends over this rank's block of a split sequence, and joins only
    the conv history's channels)."""
    if mesh is None:
        if shape.kind == "train":
            return (make_train_step(cfg),
                    (params, adamw.init(OCFG, params), inputs["batch"]),
                    None)
        if shape.kind == "prefill":
            extra = {k: v for k, v in inputs.items() if k != "tokens"}
            return make_prefill_step(cfg), (params, inputs["tokens"],
                                            extra), None
        return make_serve_step(cfg), (params, inputs["caches"],
                                      inputs["token"]), None
    serve = shape.kind != "train"
    placed = (_replicated(params, mesh)
              if serve and cfg.serve_replicate_weights
              else SH.place_params(params, mesh))
    if shape.kind == "train":
        batch = inputs["batch"]
        split = any(SH.batch_specs(batch["tokens"], mesh))
        local = _owned({k: SH.local_rows(v, mesh, split)
                        for k, v in batch.items()})
        return (make_train_step(cfg), (placed, adamw.init(OCFG, placed),
                                       local),
                SH.activate(mesh, batch_sharded=split))
    from repro_torch.launch.serve import _CacheLayout
    b, t = shape.global_batch, shape.seq_len
    split = b % mesh.size("batch") == 0
    ctx = SH.activate(mesh, batch_sharded=split)
    if shape.kind == "prefill":
        # the caches hold the image's positions and the text's: t
        layout = _CacheLayout(cfg, mesh, b, t, torch.bfloat16)
        prefill = make_prefill_step(cfg)

        def prefill_step(params, tokens, extra):
            logits, caches = prefill(params, tokens, extra)
            if split:
                logits = L.batch_gather(logits, 0)
            return logits, layout.store(caches, joined=True)
        local = _owned({k: SH.local_rows(v, mesh, split)
                        for k, v in inputs.items()})
        tokens = local.pop("tokens")
        return prefill_step, (placed, tokens, local), ctx
    layout = _CacheLayout(cfg, mesh, b, t, torch.bfloat16)
    serve = make_serve_step(cfg)

    def serve_step(params, caches, token):
        logits, caches = serve(params, layout.load(caches), token)
        if split:
            logits = L.batch_gather(logits, 0)
        return logits, layout.store(caches)
    # the caches in the layout the modules compute in (this rank's rows
    # and heads), then stored as the server stores them
    rows = b // mesh.size("batch") if split else b
    with SH.activate(mesh, batch_sharded=split):
        caches = layout.store(T.init_caches(cfg, rows, t, torch.bfloat16,
                                            mesh.device), joined=True)
    token = _owned(SH.local_rows(inputs["token"], mesh, split))
    return serve_step, (placed, caches, token), ctx


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
               device: DeviceLike = None) -> dict:
    """The counts of one cell's step on fake tensors (``count_step``),
    with this rank's analytic parameter bytes; on ``mesh``'s device (None:
    one device, ``device``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = mesh.device if mesh is not None else resolve_device(device)
    with FakeTensorMode():
        params = M.param_specs(cfg, dev)
        if mesh is not None:
            analytic = analytic_param_bytes_per_device(
                params, SH.param_specs(params, mesh), mesh)
        else:
            analytic = sum(t.numel() * t.element_size()
                           for t in tree_flatten(params)[0])
        inputs = M.input_specs(cfg, shape, dev)
        step, args, ctx = prepare_cell(cfg, shape, mesh, params, inputs)
        del params, inputs
        rec = count_step(step, args, ctx)
    rec["analytic_param_bytes_per_device"] = analytic
    rec["fits"] = rec["peak_bytes"] <= H100_RATES.hbm_bytes
    return rec


def _step_name(kind: str) -> str:
    return {"train": "train_step", "prefill": "prefill_step"}.get(
        kind, "serve_step")


@contextlib.contextmanager
def fake_group(world_size: int):
    """The fake process group of ``world_size`` ranks this process is rank
    0 of: the one already up (of that size), else one made here and ended
    at exit."""
    if dist.is_initialized():
        if dist.get_backend() != MESH.FAKE_BACKEND \
                or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks is up; the dry run needs a fake one of {world_size}")
        yield
        return
    MESH.init_fake_distributed(world_size)
    try:
        yield
    finally:
        MESH.shutdown_distributed()


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = True,
             device: DeviceLike = None) -> dict:
    """One production cell on a fake group of 256 (512 with ``multi_pod``)
    ranks: its record (SKIP, OK with the counts, or FAIL with the error),
    saved under ``ART_DIR`` with ``save``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = cfg.applicable(shape)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "timestamp": time.time()}
    if not ok:
        rec.update(status="SKIP", reason=why)
        _save(rec, save)
        return rec
    dev = resolve_device(device)
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = MESH.make_production_mesh(multi_pod=multi_pod,
                                             device=dev)
            counts = trace_cell(cfg, shape, mesh)
        rec.update(status="OK", n_devices=512 if multi_pod else 256,
                   step=_step_name(shape.kind), device=dev.type, **counts)
        print(f"[OK] {arch} x {shape_name} x {mesh_tag}: "
              f"{counts['trace_s']:.1f} s flops={counts['flops']:.3e} "
              f"bytes={counts['bytes']:.3e} "
              f"coll={counts['collectives']['total_bytes']:.3e}B "
              f"peak={counts['peak_bytes'] / 1e9:.2f} GB", flush=True)
    except Exception as e:  # noqa: BLE001 - recorded as the cell's FAIL
        rec.update(status="FAIL", step=_step_name(shape.kind),
                   error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {arch} x {shape_name} x {mesh_tag}: "
              f"{rec['error'][:300]}", flush=True)
    _save(rec, save)
    return rec


def _save(rec: dict, save: bool) -> None:
    if not save:
        return
    d = ART_DIR / rec["mesh"]
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{rec['arch']}__{rec['shape']}.json").write_text(
        json.dumps(rec, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in SHAPES] if (args.all or not args.shape)
              else [args.shape])
    failures = 0
    for mp in meshes:
        tag = "pod2x16x16" if mp else "pod16x16"
        with fake_group(512 if mp else 256):
            for a in archs:
                for s in shapes:
                    path = ART_DIR / tag / f"{a}__{s}.json"
                    if args.skip_existing and path.exists():
                        try:
                            prev = json.loads(path.read_text())
                        except json.JSONDecodeError:
                            prev = {}
                        if prev.get("status") in ("OK", "SKIP"):
                            print(f"[skip-existing] {a} x {s} x {tag}")
                            continue
                    rec = run_cell(a, s, mp, device=args.device)
                    failures += rec["status"] == "FAIL"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
