"""Meshes over ``torch.distributed``: one rank a device, the counterpart of
``repro/launch/mesh.py``.

The JAX package runs the sharded engine, and the LM stack, as one program
over a device mesh (``shard_map``, GSPMD); the port runs them SPMD in
PyTorch's idiom: each rank is one process holding one
device, joined by a process group (NCCL for CUDA tensors, gloo for CPU
ones), and every rank calls the same entry points.

A ``Mesh`` holds the process group, the rank, the world size and the
device, and exposes the engine's collectives under the JAX names
(``all_gather``, ``psum``, ``pmax``, ``pmin``, ``all_to_all``;
``axis_index`` is the rank).  They are issued at world size 1 too, never
short-circuited, so a one-rank mesh on the card runs NCCL for real.

    # one rank, no launcher (a HashStore group of size 1)
    mesh = make_snn_mesh(device="cpu")
    ...
    shutdown_distributed()                  # at the end, on every rank
    # N ranks: torchrun --nproc-per-node N ... (rank and world size from
    # the environment), then in every rank
    mesh = make_snn_mesh(device="cpu")      # gloo
    mesh = make_snn_mesh()                  # NCCL on cuda:{LOCAL_RANK}

The backend follows the device and a mismatch raises: there is no
fallback from NCCL to gloo, or from the card to the CPU.

The LM half: ``make_mesh(shape, axes)`` lays the default group's ranks
out row-major on named axes (``("data", "model")``, or ``("pod", "data",
"model")``) as a ``NamedMesh``: a ``DeviceMesh`` (which carries the
DTensors of placed params) and a process group for "model" and for the
batch axes together (every axis but "model", rank-major in their order),
which carry the model code's collectives (``models/layers.py``).

    init_distributed()                      # or torchrun
    mesh = make_local_mesh(2)               # (world // 2, 2)
    with sharding.activate(mesh): ...
    shutdown_distributed()
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

__all__ = ["SNN_AXIS", "Mesh", "NamedMesh", "init_distributed",
           "init_fake_distributed", "shutdown_distributed", "make_mesh", "make_production_mesh",
           "make_local_mesh", "make_snn_mesh", "sub_mesh", "snn_axis",
           "batch_axes", "MeshPlan", "backend_for", "join_launcher"]

#: the axis the SNN engine partitions neuron populations over
SNN_AXIS = "neuron"

# the dry run's process-group backend: it stands in for NCCL and gloo
FAKE_BACKEND = "fake"

# seconds a collective may wait for its peers before the group raises (a
# rank that dies must bring the others down, not hang them)
DEFAULT_TIMEOUT_S = 300.0

# whether init_distributed started the default process group (and so
# shutdown_distributed ends it); a group someone else started is theirs
_started = False

# make_mesh's meshes of the current default group, by (shape, axes,
# device): a second call reuses the first's process groups
_MESHES: dict = {}


def backend_for(device: torch.device) -> str:
    """The process-group backend that carries tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: str = "gloo",
                     init_method: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S
                     ) -> Tuple[int, int]:
    """Join this process to the default process group and return (rank,
    world_size).  Idempotent: with a group already up it returns that
    group's, after checking that any rank, world size or backend asked for
    agrees with it.

    rank / world_size default to the environment (``RANK`` /
    ``WORLD_SIZE``, as ``torchrun`` sets them), init_method to
    ``env://`` when the environment names a rendezvous.  With neither, a
    world of one rank forms over an in-process ``HashStore`` (no launcher,
    no port); asking for more ranks without a rendezvous raises."""
    if dist.is_initialized():
        have = (dist.get_rank(), dist.get_world_size())
        want = (have[0] if rank is None else int(rank),
                have[1] if world_size is None else int(world_size))
        if want != have:
            raise RuntimeError(f"the process group is up as rank {have[0]} "
                               f"of {have[1]}; asked for rank {want[0]} of "
                               f"{want[1]}")
        if dist.get_backend() not in (backend, FAKE_BACKEND):
            raise RuntimeError(f"the process group's backend is "
                               f"{dist.get_backend()!r}, asked for "
                               f"{backend!r}")
        return have
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    rank = 0 if rank is None else int(rank)
    world_size = 1 if world_size is None else int(world_size)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        raise RuntimeError(
            f"a world of {world_size} ranks needs a rendezvous: launch with "
            "torchrun (MASTER_ADDR/RANK/WORLD_SIZE) or pass init_method "
            "('file://...' or 'tcp://host:port')")
    global _started
    _started = True
    return dist.get_rank(), dist.get_world_size()


def init_fake_distributed(world_size: int) -> None:
    """Join this process to a fake process group as rank 0 of
    ``world_size`` (PyTorch's ``"fake"`` backend: every collective returns
    at once and moves nothing), on which ``make_mesh`` builds any mesh of
    that many ranks in one process: the dry run's (``launch/dryrun.py``).
    ``shutdown_distributed`` ends it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=int(world_size))
    global _started
    _started = True


def shutdown_distributed() -> bool:
    """End the default process group (and every group made from it, such
    as ``sub_mesh``'s) if ``init_distributed`` started it: one
    ``destroy_process_group()``, so that NCCL's communicators are freed
    before the program exits.  A group this module did not start is left
    up.  Returns whether it ended one; a second call does nothing."""
    global _started
    _MESHES.clear()
    if not _started:
        return False
    _started = False
    if not dist.is_initialized():
        return False
    dist.destroy_process_group()
    return True


def _as_wire(x: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (the same bytes; NCCL reduces no bool)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


class Mesh:
    """A 1-D mesh of ranks along ``SNN_AXIS``: this rank's
    place in the process group, its device, and the collectives the engine
    issues, under the JAX names.  Every collective must be called by every
    rank in the same order."""

    def __init__(self, group, rank: int, world_size: int,
                 device: torch.device):
        self.group = group
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        if self.backend != backend_for(self.device):
            raise RuntimeError(
                f"a {self.backend} group cannot carry tensors on "
                f"{self.device} (it takes {backend_for(self.device)})")

    # -- the JAX names ----------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (SNN_AXIS,)

    @property
    def shape(self) -> dict:
        return {SNN_AXIS: self.world_size}

    def axis_index(self) -> int:
        return self.rank

    def _check(self, x: torch.Tensor) -> None:
        if x.device != self.device:
            raise ValueError(f"a collective of the mesh on {self.device} "
                             f"got a tensor on {x.device}")

    def all_gather(self, x: torch.Tensor, tiled: bool = True
                   ) -> torch.Tensor:
        """Every rank's ``x`` along a new leading axis [D, ...]
        (``tiled``: concatenated along axis 0, [D * x.shape[0], ...])."""
        self._check(x)
        shape = tuple(x.shape)
        x = x.contiguous().reshape((-1,) + shape[1:])
        # the concatenated form: gloo takes no other
        out = torch.empty((self.world_size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _all_gather_into(_as_wire(out), _as_wire(x), self.group)
        if tiled:
            return out
        return out.reshape((self.world_size,) + shape)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self._check(x)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(_as_wire(out), op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (a new tensor)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ranks (bool: any)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum over ranks (bool: all)."""
        return self._reduce(x, dist.ReduceOp.MIN)

    def all_to_all(self, x: torch.Tensor, split_axis: int = 0,
                   concat_axis: int = 0) -> torch.Tensor:
        """``x``'s axis ``split_axis`` (of size D) scattered over the
        ranks: chunk s goes to rank s, and the chunks received, one from
        every rank in rank order, stack along ``concat_axis`` (JAX's
        untiled ``all_to_all``)."""
        self._check(x)
        if x.shape[split_axis] != self.world_size:
            raise ValueError(f"all_to_all splits an axis of size "
                             f"{self.world_size}, got {tuple(x.shape)}")
        send = x.movedim(split_axis, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(_as_wire(recv), _as_wire(send),
                               group=self.group)
        return recv.movedim(0, concat_axis)

    def barrier(self) -> None:
        # a collective on the mesh's device (a gloo or NCCL barrier of its
        # own would pick a device for itself)
        self.psum(torch.zeros(1, dtype=torch.int32, device=self.device))

    def __repr__(self) -> str:
        return (f"Mesh({SNN_AXIS}={self.world_size}, rank={self.rank}, "
                f"device={str(self.device)!r}, backend={self.backend!r})")


def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # torch >= 2.9 names it all_gather_single (all_gather_into_tensor warns)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def make_snn_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D mesh the sharded SNN engine partitions populations over:
    every rank of the default process group (joined here through
    ``init_distributed`` if it is not up yet), one device a rank.

    device: None or "cuda" -> ``cuda:{LOCAL_RANK}`` over NCCL (raises
    without a card); "cpu" -> gloo.  n_devices: the world size the caller
    expects (None: whatever the group has); a different one raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank, world = init_distributed(
        world_size=None if dist.is_initialized() else n_devices,
        backend=backend)
    if n_devices is not None and int(n_devices) != world:
        raise RuntimeError(f"asked for a mesh of {n_devices} devices; the "
                           f"process group has {world} ranks")
    mesh = Mesh(dist.group.WORLD, rank, world, dev)
    # the first collective creates the communicator (NCCL's lazily):
    # here, outside any CUDA graph capture
    mesh.barrier()
    return mesh


def sub_mesh(mesh: Mesh, n: int) -> Optional[Mesh]:
    """The mesh of ``mesh``'s first ``n`` ranks (a new process group;
    every rank of ``mesh`` must call this, in the same order), or None on
    the ranks outside it: a weak-scaling series runs at D = 1, 2, 4, ...
    within one launch."""
    if not 1 <= n <= mesh.world_size:
        raise ValueError(f"a sub-mesh of {n} ranks in a world of "
                         f"{mesh.world_size}")
    group = dist.new_group(list(range(n)), backend=mesh.backend)
    if mesh.rank >= n:
        return None
    sub = Mesh(group, mesh.rank, n, mesh.device)
    sub.barrier()
    return sub


def snn_axis(mesh) -> str:
    """The neuron-partition axis of a mesh: ``SNN_AXIS`` when present, else
    a single-axis mesh's only axis."""
    names = tuple(mesh.axis_names)
    if SNN_AXIS in names:
        return SNN_AXIS
    if len(names) == 1:
        return names[0]
    raise ValueError(
        f"mesh axes {names} have no {SNN_AXIS!r} axis; build the mesh "
        "with make_snn_mesh or name one axis 'neuron'")


# ---------------------------------------------------------------------------
# the LM half: named meshes of the default group's ranks
# ---------------------------------------------------------------------------

class NamedMesh:
    """The default group's ranks laid out row-major on named axes, with
    this rank's device.  ``shape`` maps each axis to its size (JAX's
    ``mesh.shape``); ``devices`` is the rank grid (``devices.size`` the
    world); ``device_mesh`` the ``torch.distributed`` DeviceMesh of the
    same layout.  ``group(name)`` / ``size(name)`` / ``coord(name)`` give
    the process group, size and this rank's index along "model" or along
    the batch axes together ("batch": its index runs rank-major over the
    axes in their order); ``coord`` also takes any axis's name."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: torch.device):
        from torch.distributed.device_mesh import init_device_mesh
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                               (int(n) for n in shape)))
        self.devices = np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.device_mesh = init_device_mesh(
            self.device.type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        self._coord = dict(zip(self.axis_names, (
            int(c) for c in np.argwhere(self.devices == self.rank)[0])))
        # one group along "model" and one over the batch axes together;
        # every rank makes every group, in the same order
        self._groups = {}
        for name, along in (("model", ("model",)),
                            ("batch", batch_axes(self))):
            along = tuple(a for a in along if a in self.shape)
            for ranks in _lines(self.devices, self.axis_names, along):
                g = dist.new_group(ranks, backend=dist.get_backend())
                if self.rank in ranks:
                    mine = (g, len(ranks), ranks.index(self.rank))
            self._groups[name] = mine

    def group(self, name: str):
        return self._groups[name][0]

    def size(self, name: str) -> int:
        return self._groups[name][1]

    def coord(self, name: str) -> int:
        if name in self._groups:
            return self._groups[name][2]
        return self._coord[name]

    def barrier(self) -> None:
        """A collective on every group of the mesh (the first creates each
        group's communicator: NCCL's are made lazily)."""
        t = torch.zeros(1, dtype=torch.int32, device=self.device)
        dist.all_reduce(t)
        for group, _, _ in self._groups.values():
            dist.all_reduce(t, group=group)

    def __repr__(self) -> str:
        return (f"NamedMesh({self.shape}, rank={self.rank}, "
                f"device={str(self.device)!r})")


def _lines(devices: np.ndarray, names: Tuple[str, ...],
           along: Tuple[str, ...]):
    """The rank lists of every sub-grid spanning the axes ``along`` (the
    others fixed), each rank-major in the order of ``along``."""
    keep = [names.index(a) for a in along]
    rest = [i for i in range(len(names)) if i not in keep]
    grid = devices.transpose(rest + keep).reshape(
        -1, math.prod(devices.shape[i] for i in keep) if keep else 1)
    return [[int(r) for r in row] for row in grid]


def _mesh_device(device=None) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def join_launcher(device=None) -> bool:
    """Join the process group a launcher describes (``WORLD_SIZE`` in the
    environment, as ``torchrun`` sets it), with the backend of
    ``device``; returns whether it started one (then the caller ends it
    with ``shutdown_distributed``)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    init_distributed(backend=backend_for(_mesh_device(device)))
    return True


def make_mesh(shape, axes, device=None) -> NamedMesh:
    """The default group's ranks on the named axes ``axes`` of ``shape``
    (joined through ``init_distributed`` when no group is up; the world
    must be the product of ``shape``); the same mesh again for the same
    arguments while the group is up.  device: None or "cuda" ->
    ``cuda:{LOCAL_RANK}`` over NCCL; "cpu" -> gloo."""
    dev = _mesh_device(device)
    key = (tuple(shape), tuple(axes), str(dev))
    if dist.is_initialized() and key in _MESHES \
            and _MESHES[key][0] is dist.group.WORLD:
        return _MESHES[key][1]
    _, world = init_distributed(
        world_size=None if dist.is_initialized() else math.prod(shape),
        backend=backend_for(dev))
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    if dist.get_backend() not in (backend_for(dev), FAKE_BACKEND):
        raise RuntimeError(f"a {dist.get_backend()} group cannot carry "
                           f"tensors on {dev}")
    mesh = NamedMesh(shape, axes, dev)
    # the first collective creates the communicator (NCCL's lazily)
    mesh.barrier()
    _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> NamedMesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")
    with ``multi_pod``: needs a process group of 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return make_mesh(shape, axes, device)


def make_local_mesh(model_parallel: int = 1, device=None) -> NamedMesh:
    """("data", "model") over the default group's world n (one rank when
    no group is up): model_parallel clamped to [1, n], shape (n // mp,
    mp), as the JAX package builds it over its devices."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    mp = max(1, min(int(model_parallel), n))
    return make_mesh((n // mp, mp), ("data", "model"), device)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch (and FSDP shards) ride on."""
    return tuple(a for a in mesh.axis_names if a != "model")


class MeshPlan:
    """Mesh + axis bookkeeping passed through launch entry points."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.batch = batch_axes(mesh)
        self.model = "model" if "model" in mesh.axis_names else None

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    def __repr__(self) -> str:
        axes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return f"MeshPlan({axes})"
