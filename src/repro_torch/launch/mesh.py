"""The SNN engine's mesh: one rank a device, over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``'s SNN half.  The JAX package runs
the sharded engine as one program over a device mesh (``shard_map``); the
port runs it SPMD in PyTorch's idiom: each rank is one process holding one
device, joined by a process group (NCCL for CUDA tensors, gloo for CPU
ones), and every rank calls the same entry points.

A ``Mesh`` holds the process group, the rank, the world size and the
device, and exposes the engine's collectives under the JAX names
(``all_gather``, ``psum``, ``pmax``, ``pmin``, ``all_to_all``;
``axis_index`` is the rank).  They are issued at world size 1 too, never
short-circuited, so a one-rank mesh on the card runs NCCL for real.

    # one rank, no launcher (a HashStore group of size 1)
    mesh = make_snn_mesh(device="cpu")
    # N ranks: torchrun --nproc-per-node N ... (rank and world size from
    # the environment), then in every rank
    mesh = make_snn_mesh(device="cpu")      # gloo
    mesh = make_snn_mesh()                  # NCCL on cuda:{LOCAL_RANK}

The backend follows the device and a mismatch raises: there is no
fallback from NCCL to gloo, or from the card to the CPU.  ``MeshPlan``,
``make_local_mesh``, ``make_production_mesh`` and ``batch_axes`` (the LM
half's meshes) are not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

__all__ = ["SNN_AXIS", "Mesh", "init_distributed", "make_snn_mesh",
           "sub_mesh", "snn_axis", "backend_for"]

#: the axis the SNN engine partitions neuron populations over
SNN_AXIS = "neuron"

# seconds a collective may wait for its peers before the group raises (a
# rank that dies must bring the others down, not hang them)
DEFAULT_TIMEOUT_S = 300.0


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
        if dist.get_backend() != backend:
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
    return dist.get_rank(), dist.get_world_size()


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
