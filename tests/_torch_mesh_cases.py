"""The mesh's collectives at D gloo ranks -- not a test module.

Each case returns what this rank saw ("local"); ``test_torch_mesh.py``
works out what every rank should have seen.  No JAX here.
"""

import torch

from repro_torch.core.snn import bitmask as BM
from repro_torch.launch import mesh as M


def _x(rank, dtype=torch.int32):
    """This rank's [2, 3] operand: 100 * rank + 0..5."""
    return (100 * rank + torch.arange(6).reshape(2, 3)).to(dtype)


def case_collectives(mesh):
    r = mesh.rank
    x = _x(r)
    f = _x(r, torch.float32) / 7.0
    b = torch.tensor([r % 2 == 0, r == 0, True])
    a2a = (10 * r + torch.arange(mesh.world_size)).reshape(-1, 1) \
        .expand(-1, 2).contiguous()
    return {"local": {
        "axis_index": mesh.axis_index(), "shape": mesh.shape,
        "axis_names": mesh.axis_names,
        "tiled": mesh.all_gather(x), "stacked": mesh.all_gather(x,
                                                                tiled=False),
        "gather_bool": mesh.all_gather(b, tiled=False),
        "psum": mesh.psum(x), "pmax": mesh.pmax(x), "pmin": mesh.pmin(x),
        "psum_f": mesh.psum(f), "pmax_f": mesh.pmax(f),
        "any": mesh.pmax(b), "all": mesh.pmin(b),
        "a2a": mesh.all_to_all(a2a),
        "a2a_cols": mesh.all_to_all(a2a.t().contiguous(), split_axis=1,
                                    concat_axis=1),
        "x_after": x,                                   # operands untouched
    }}


def case_spike_exchange(mesh):
    """Packed words all-gathered [D, B, W] and unpacked equal the
    all-gather of the bool segments, member by member (B = 3, a segment
    of 45 lanes: two words, the second part-filled)."""
    g = torch.Generator().manual_seed(1 + mesh.rank)
    bits = torch.rand((3, 45), generator=g) < 0.3
    words = BM.pack_spikes(bits)
    full = BM.unpack_segments(mesh.all_gather(words, tiled=False), 45)
    plain = mesh.all_gather(bits, tiled=False)       # [D, B, 45]
    want = torch.cat(list(plain), dim=-1)
    return {"local": {"full": full, "want": want}}


def case_errors(mesh):
    """What a rank must refuse: another world size or rank, another
    backend, a device the group cannot carry, a tensor on another device,
    an all_to_all over an axis that is not the world's."""
    out = {}
    for name, fn in {
        "world": lambda: M.init_distributed(world_size=mesh.world_size + 1),
        "rank": lambda: M.init_distributed(rank=mesh.world_size),
        "backend": lambda: M.init_distributed(backend="nccl"),
        "cuda_mesh": lambda: M.Mesh(mesh.group, mesh.rank, mesh.world_size,
                                    "cuda:0"),
        "resize": lambda: M.make_snn_mesh(mesh.world_size + 1, device="cpu"),
        "a2a_axis": lambda: mesh.all_to_all(
            torch.zeros(mesh.world_size + 1, 2)),
    }.items():
        try:
            fn()
            out[name] = None
        except (RuntimeError, ValueError) as e:
            out[name] = type(e).__name__ + ": " + str(e)
    out["again"] = M.init_distributed()
    out["mesh_again"] = repr(M.make_snn_mesh(device="cpu"))
    return {"local": out}
