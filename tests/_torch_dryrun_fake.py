"""The fake-group cells of ``tests/test_torch_dryrun.py`` -- not a test
module.

    python tests/_torch_dryrun_fake.py OUT.json

runs, in this one process, one reduced cell per family and step kind
(train with two microbatches, prefill, decode) on a fake group of 4 ranks
(a 2 x 2 ("data", "model") mesh), then ``COMPARED``'s cell on fake groups
of 2 (meshes 2 x 1 and 1 x 2), then ``MEMORY``'s cells on a fake group of
16 (a 4 x 4 mesh) as the port runs them and with the join it made before
(the MoE's input gathered over the batch axes, a decode's k/v sequence
joined), each group made and ended here (``dryrun.fake_group``), then
``REMAT``'s cell on one device under each remat policy, then
``REPLICATED``'s cells on the group of 16 with their weights placed whole
and sharded; and, on the
group of 4, ``benchmarks/hillclimb_torch.py``'s three cells at the
reduced size (``HILLCLIMB``) beside the dry run's record of each cell's
baseline.  It writes every record to OUT.json."""

import dataclasses
import json
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH

FAMILIES = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-2.7b",
            "zamba2-7b", "whisper-tiny", "paligemma-3b")
CELLS = (ShapeConfig("train", 16, 8, "train"),
         ShapeConfig("prefill", 16, 4, "prefill"),
         ShapeConfig("decode", 16, 4, "decode"))
# the cell traced both on a fake group of 2 and on 2 real gloo ranks
COMPARED = (dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                                n_layers=2, microbatches=2), CELLS[0])


# the per-rank peaks that the port's mesh layouts shrink: the MoE prefill
# (each rank routes its own groups; before, the batch was joined on every
# rank) and the decode over a split cache sequence (before, each k/v
# sequence was joined for the step); 2 layers of the reduced configs
MEMORY = {"granite-moe-1b-a400m/prefill": ShapeConfig("p", 256, 16,
                                                      "prefill"),
          "mixtral-8x22b/prefill": ShapeConfig("p", 256, 16, "prefill"),
          "qwen2-0.5b/decode": ShapeConfig("d", 1024, 16, "decode")}
# the reduced qwen2's training step under each remat policy, one device
REMAT = ShapeConfig("train", 64, 4, "train")
# served with its weights placed whole (``serve_replicate_weights``): the
# reduced qwen2 at 2 layers with 8 query heads, which the "model" axis of
# a 2 x 8 mesh on the fake group of 16 divides, over 2 KV heads (whole on
# every rank: each local query head picks its group's) or 8 (split)
REPLICATED = {"prefill": ShapeConfig("prefill", 64, 4, "prefill"),
              "decode": ShapeConfig("decode", 64, 4, "decode")}
REPLICATED_KV = (2, 8)


def replicated_config(n_kv: int, replicate: bool):
    return dataclasses.replace(reduced(get_config("qwen2-0.5b")), n_layers=2,
                               n_heads=8, n_kv=n_kv,
                               serve_replicate_weights=replicate)


# hillclimb's cells at the reduced size, 2 layers, remat on (so "dots"
# differs from the baseline); the cells with a replicated-weights variant
# take heads that the 2-wide "model" axis does not divide, as qwen2-0.5b's
# 14 and whisper-tiny's 6 are on the production 16
HILLCLIMB = {"mixtral_train": ({}, ShapeConfig("train", 64, 8, "train")),
             "qwen2_prefill": ({"n_heads": 3, "n_kv": 1},
                               ShapeConfig("prefill", 64, 4, "prefill")),
             "whisper_decode": ({"n_heads": 3, "n_kv": 3},
                                ShapeConfig("decode", 64, 4, "decode"))}


def hillclimb_config(cell: str):
    from benchmarks import hillclimb_torch as H
    return dataclasses.replace(reduced(get_config(H.CELLS[cell][0])),
                               n_layers=2, remat=True,
                               **HILLCLIMB[cell][0])


def hillclimb() -> dict:
    """Each cell's variants (on the fake group of 4 that is up) and the dry
    run's record of its baseline on the same mesh."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import hillclimb_torch as H
    res = {}
    with tempfile.TemporaryDirectory() as out:
        for cell, (_, shape) in HILLCLIMB.items():
            cfg = hillclimb_config(cell)
            run = H.run(cell, "cpu", out, cfg, shape, (2, 2))
            res[cell] = {"run": run, "written": json.loads(
                (Path(out) / f"{cell}.json").read_text()),
                "record": _trace(cfg, shape, (2, 2))}
    return res


def config(arch: str):
    """The reduced config at 2 layers (zamba2: one group of two mamba
    layers and the shared block, and a mamba tail), two microbatches."""
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, microbatches=2, n_layers=(
        4 if cfg.family == "hybrid" else 2))


def real_inputs(cfg, cell):
    """Real inputs in ``input_specs``' tree (tokens from a seeded
    generator)."""
    from repro_torch.models import model as M
    gen = torch.Generator().manual_seed(1)

    def real(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen,
                                 dtype=torch.int32)
        return torch.randn(tuple(t.shape), generator=gen).to(t.dtype)
    specs = M.input_specs(cfg, cell, "cpu")
    return {k: ({n: real(v) for n, v in specs[k].items()}
                if isinstance(specs[k], dict) else real(specs[k]))
            for k in specs if k != "caches"}


def _trace(cfg, cell, shape):
    mesh = MESH.make_mesh(shape, ("data", "model"), device="cpu")
    rec = D.trace_cell(cfg, cell, mesh)
    return {k: rec[k] for k in ("flops", "bytes", "peak_bytes",
                                "collectives", "core")}


def _joined():
    """The layouts the port used before: the MoE's gather route taken
    always, a decode's caches loaded with each k/v sequence whole."""
    from repro_torch.launch import serve as S
    from repro_torch.models import moe as MO
    real = S._CacheLayout.load
    return (mock.patch.object(MO, "_own_groups", lambda *_: False),
            mock.patch.object(S._CacheLayout, "load",
                              lambda self, c: real(self, c, joined=True)))


def memory() -> dict:
    """``MEMORY``'s cells on a fake group of 16, as run and joined."""
    res = {}
    with D.fake_group(16):
        for name, cell in MEMORY.items():
            cfg = dataclasses.replace(reduced(get_config(
                name.split("/")[0])), n_layers=2)
            res[name] = {"split": _trace(cfg, cell, (4, 4))}
            moe, cache = _joined()
            with moe, cache:
                res[name]["joined"] = _trace(cfg, cell, (4, 4))
    return res


def _weights_and_attention():
    """Patches that count, beside the step's own counts, the collective
    bytes of the weights' joins (``layers.from_placed``) and the FLOPs of
    the attention modules, into the dict they return."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    seen = {"weight_collective_bytes": 0, "attention_flops": 0}
    real_placed = L.from_placed

    def from_placed(t, *args, **kw):
        with D.StepCounter(D._local(t).device) as c:
            out = real_placed(t, *args, **kw)
        seen["weight_collective_bytes"] += sum(c.coll_bytes.values())
        return out

    def counted(fn):
        def run(*args, **kw):
            with FlopCounterMode(display=False) as f:
                out = fn(*args, **kw)
            seen["attention_flops"] += int(f.get_total_flops())
            return out
        return run
    patches = (mock.patch.object(L, "from_placed", from_placed),
               mock.patch.object(A, "attention_forward",
                                 counted(A.attention_forward)),
               mock.patch.object(A, "attention_decode",
                                 counted(A.attention_decode)))
    return seen, patches


def replicated() -> dict:
    """``REPLICATED``'s cells on a 2 x 8 mesh of the fake group of 16 that
    is up, with the weights placed whole and sharded: each trace's counts,
    its weights' collective bytes and its attention FLOPs."""
    res = {}
    for n_kv in REPLICATED_KV:
        for kind, cell in REPLICATED.items():
            for rep in (True, False):
                seen, patches = _weights_and_attention()
                with patches[0], patches[1], patches[2]:
                    rec = _trace(replicated_config(n_kv, rep), cell, (2, 8))
                res[f"kv{n_kv}/{kind}/{'whole' if rep else 'sharded'}"] = {
                    **rec, **seen}
    return res


def remat() -> dict:
    """``REMAT``'s cell (the reduced qwen2, remat on) on one device."""
    base = dataclasses.replace(reduced(get_config("qwen2-0.5b")), remat=True)
    return {pol: {k: v for k, v in D.trace_cell(
        dataclasses.replace(base, remat_policy=pol), REMAT, None,
        "cpu").items() if k in ("flops", "bytes", "peak_bytes")}
        for pol in ("full", "dots", "none")}


def main(out: str) -> None:
    res = {"families": {}, "compared": {}, "memory": memory(),
           "remat": remat()}
    with D.fake_group(16):
        res["replicated"] = replicated()
    with D.fake_group(4):
        for arch in FAMILIES:
            for cell in CELLS:
                res["families"][f"{arch}/{cell.kind}"] = _trace(
                    config(arch), cell, (2, 2))
        res["hillclimb"] = hillclimb()
    for shape in ((2, 1), (1, 2)):
        with D.fake_group(2):
            res["compared"][f"{shape[0]}x{shape[1]}"] = _trace(
                *COMPARED, shape)
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
