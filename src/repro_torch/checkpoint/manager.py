"""Step-atomic checkpointing with retention, async writes and manifests,
the counterpart of ``repro/checkpoint/manager.py``: a checkpoint that
either package writes restores in the other, bit for bit.

Layout per step:
  <dir>/step_<N:09d>/
    manifest.json      -- step, status=COMPLETE, time, process_count, keys
    shard_<p>.npz      -- this process's leaves, one array a leaf

Leaf keys are the JAX package's: the path's dict keys (sorted, as JAX
flattens a dict) and list indices joined by "/", a NamedTuple's field as
".name" (``params/segments/0/attn/wq``, ``opt/.step``, ``opt/.mu/embed``,
``opt/.master/img_proj``); None holds no leaf.  bfloat16 leaves are
stored as their uint16 bits (npz has no bfloat16), Python ints as int32
(the JAX optimizer's step).

Atomicity: leaves are written first, the manifest last (write to a
temporary name, then rename); a step directory without a COMPLETE
manifest is ignored by ``steps``/``latest_step`` and, once older than
60 s, removed — a crash mid-write is never restored from.  Each process
(the ``torch.distributed`` rank when a group is up, else 0) writes its
own shard.

A tree of placed leaves (DTensors, ``launch/sharding.py``) is saved whole:
every rank joins each leaf's blocks (``full_tensor``, a collective), and
rank 0 alone writes them, in the same keys and layout, so a checkpoint
written on a mesh restores on one device and in the JAX package.
``restore(shardings=)`` places each leaf by a tree of
``sharding.NamedSharding`` (this rank's block of it, as a DTensor), and a
placed leaf of ``like`` by its own placements (with ``in_place``, its
block is overwritten).  ``wait()`` then also waits, on every rank, for
rank 0's writer.

``save`` copies every leaf to host memory before it returns: the port's
AdamW updates params, moments and master copies in place, so a writer
holding the device tensors would write a later step's values under this
step's name.  The disk write then runs on a thread (``wait()`` joins it
and re-raises its error); ``restore`` reads each shard through one memory
map and puts each leaf on the device and dtype of the matching leaf of
``like``, or into that leaf with ``in_place``.
"""

from __future__ import annotations

import json
import math
import shutil
import struct
import sys
import threading
import time
import warnings
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["CheckpointManager"]


def _group() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's leaf order and names."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _rebuild(like, fn: Callable[[str, Any], Any],
             path: Tuple[str, ...] = ()):
    """``like``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), fn, path + (f".{n}",))
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fn, path + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return fn("/".join(path), like)


def _to_host(v) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy, never a view of a
    tensor that may change)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy() \
                .view(np.uint16)
        return t.to("cpu", copy=True).numpy()
    if isinstance(v, int) and not isinstance(v, bool):
        return np.asarray(v, np.int32)
    a = np.array(v, copy=True)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _read_shard(path: Path) -> Dict[str, np.ndarray]:
    """A shard's arrays, as read-only views of one memory map of the file
    (numpy's zip reader copies each member through its CRC pass, ~0.5
    GB/s).  ``np.savez``, which both packages write with, stores every
    member uncompressed; a compressed member, or a header that is not an
    npy 1.0/2.0 header of a plain dtype, raises ValueError."""
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    out = {}
    mm = np.memmap(path, mode="r") if infos else None
    with open(path, "rb") as f:
        for info in infos:
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{path}: member {info.filename!r} is compressed; "
                    "checkpoints are written uncompressed (np.savez)")
            # the member's data follows its local header (30 bytes, then
            # the name and the extra field)
            f.seek(info.header_offset + 26)
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            major, _ = np.lib.format.read_magic(f)
            if major not in (1, 2):
                raise ValueError(f"{path}: member {info.filename!r} has an "
                                 f"npy header of version {major}")
            read = (np.lib.format.read_array_header_1_0 if major == 1
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if dtype.hasobject:
                raise ValueError(f"{path}: member {info.filename!r} holds "
                                 "Python objects")
            start = f.tell()
            arr = mm[start:start + math.prod(shape) * dtype.itemsize]
            out[info.filename[:-len(".npy")]] = arr.view(dtype).reshape(
                shape, order="F" if fortran else "C")
    return out


def _placed(x) -> bool:
    # no DTensor exists before its module is imported (importing it costs
    # seconds, which an unmeshed save need not pay)
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


def _place(arr: np.ndarray, ref, sharding, in_place: bool):
    """``arr`` (the whole leaf) placed as ``sharding`` says, or as the
    placed ``ref`` is: this rank's block, on ``ref``'s device and dtype
    (with ``in_place``, copied into ``ref``'s block)."""
    from torch.distributed.tensor import distribute_tensor
    local_ref = ref.to_local() if _placed(ref) else ref
    full = _from_host(arr, local_ref.new_empty(0) if in_place else
                      local_ref, False)
    if sharding is not None:
        t = sharding.distribute(full)
    else:   # every rank holds ``full``: its block, no communication
        t = distribute_tensor(full, ref.device_mesh, ref.placements,
                              src_data_rank=None)
    if in_place:
        with torch.no_grad():
            local_ref.copy_(t.to_local())
        return ref
    return t


def _from_host(arr: np.ndarray, ref, in_place: bool = False):
    """``arr`` (which may be a read-only view of a file) as a leaf like
    ``ref``, copied: a tensor on its device and dtype (with ``in_place``,
    ``ref`` itself with ``arr`` copied into it), or a Python scalar or
    numpy array of its type."""
    if isinstance(ref, torch.Tensor):
        bf16 = ref.dtype == torch.bfloat16 and arr.dtype == np.uint16
        with warnings.catch_warnings():
            # torch warns of a read-only array; the tensor is copied below
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
        if bf16:
            t = t.view(torch.bfloat16)
        if in_place:
            with torch.no_grad():
                return ref.copy_(t)
        return t.to(ref.device, ref.dtype, copy=True)
    if isinstance(ref, (bool, int, float)):
        return type(ref)(arr)
    ref_dtype = np.asarray(ref).dtype
    if ref_dtype.name == "bfloat16" and arr.dtype == np.uint16:
        return arr.view(ref_dtype).copy()
    return arr.astype(ref_dtype)


def _flat_device(flat) -> torch.device:
    """The device of the first placed leaf's blocks."""
    return next(v.to_local().device for _, v in flat if _placed(v))


def _shape(ref) -> tuple:
    return tuple(ref.shape) if hasattr(ref, "shape") else ()


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 3,
                 process_index: Optional[int] = None,
                 async_writes: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.process_index = (_group()[0] if process_index is None
                              else process_index)
        self.async_writes = async_writes
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the device a placed save's ranks meet on (None: no placed save)
        self._one_writer: Optional[torch.device] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Dict[str, Any],
             blocking: bool = False) -> None:
        """Snapshot now (every leaf copied to host memory before this
        returns); the disk write runs on the writer thread."""
        flat = list(_flatten(tree))
        if any(_placed(v) for _, v in flat):
            # every rank joins the blocks; rank 0 writes the whole leaves
            self._one_writer = _flat_device(flat)
            host_leaves = [(k, _to_host(v.full_tensor() if _placed(v)
                                        else v)) for k, v in flat]
            if _group()[0] != 0:
                self.wait()
                return
        else:
            host_leaves = [(k, _to_host(v)) for k, v in flat]
        self.wait()

        def _write():
            try:
                self._write(step, host_leaves)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        if self.async_writes and not blocking:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _write(self, step: int, host_leaves) -> None:
        d = self.dir / f"step_{step:09d}"
        d.mkdir(parents=True, exist_ok=True)
        shard = d / f"shard_{self.process_index}.npz"
        tmp = shard.with_suffix(".tmp.npz")
        np.savez(tmp, **{k: v for k, v in host_leaves})
        tmp.rename(shard)
        manifest = {
            "step": step,
            "status": "COMPLETE",
            "time": time.time(),
            "process_count": 1 if self._one_writer else _group()[1],
            "keys": [k for k, _ in host_leaves],
        }
        mtmp = d / "manifest.tmp.json"
        mtmp.write_text(json.dumps(manifest))
        mtmp.rename(d / "manifest.json")

    # ------------------------------------------------------------------
    def wait(self) -> None:
        """Join the writer; raise its error, if it had one.  After a placed
        save every rank calls this, and it returns on each once rank 0's
        writer has finished."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._one_writer is not None:
            ok = torch.tensor([self._error is None], dtype=torch.int32,
                              device=self._one_writer)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            if not bool(ok.item()) and self._error is None:
                raise RuntimeError("async checkpoint write failed on "
                                   "rank 0")
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}")

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for d in sorted(self.dir.glob("step_*")):
            if (d / "manifest.json").exists():
                try:
                    m = json.loads((d / "manifest.json").read_text())
                    if m.get("status") == "COMPLETE":
                        out.append(int(m["step"]))
                except (json.JSONDecodeError, KeyError):
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def restore(self, step: int, like: Dict[str, Any],
                in_place: bool = False, shardings=None) -> Dict[str, Any]:
        """Step ``step``'s leaves in the structure of ``like``; every
        leaf's key and shape checked, each put on the device and dtype of
        its ``like`` leaf.  With ``in_place``, each tensor leaf of ``like``
        is overwritten and returned (its other leaves are made anew), so
        the device never holds two copies of the state.  ``shardings``: a
        tree of ``NamedSharding`` in ``like``'s structure (None leaves:
        as ``like``'s), by which each leaf is placed; a placed leaf of
        ``like`` places its leaf as it is placed."""
        d = self.dir / f"step_{step:09d}"
        if not (d / "manifest.json").exists():
            raise FileNotFoundError(f"no COMPLETE checkpoint at {d}")
        data: Dict[str, np.ndarray] = {}
        for shard in sorted(d.glob("shard_*.npz")):
            data.update(_read_shard(shard))

        where = dict(_flatten(shardings)) if shardings is not None else {}

        def leaf(key, ref):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != _shape(ref):
                raise ValueError(
                    f"leaf {key!r} shape {arr.shape} != {_shape(ref)}")
            if key in where or _placed(ref):
                return _place(arr, ref, where.get(key), in_place)
            return _from_host(arr, ref, in_place)

        return _rebuild(like, leaf)

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        # incomplete directories: removed once they are a minute old
        for d in self.dir.glob("step_*"):
            if not (d / "manifest.json").exists():
                if time.time() - d.stat().st_mtime > 60:
                    shutil.rmtree(d, ignore_errors=True)
        if self.max_to_keep and len(steps) > self.max_to_keep:
            for s in steps[: -self.max_to_keep]:
                shutil.rmtree(self.dir / f"step_{s:09d}",
                              ignore_errors=True)
