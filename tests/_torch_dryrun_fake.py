"""The fake-group cells of ``tests/test_torch_dryrun.py`` -- not a test
module.

    python tests/_torch_dryrun_fake.py OUT.json

runs, in this one process, one reduced cell per family and step kind
(train with two microbatches, prefill, decode) on a fake group of 4 ranks
(a 2 x 2 ("data", "model") mesh), then ``COMPARED``'s cell on fake groups
of 2 (meshes 2 x 1 and 1 x 2), each group made and ended here
(``dryrun.fake_group``), and writes every record to OUT.json."""

import dataclasses
import json
import sys

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
                                "collectives")}


def main(out: str) -> None:
    res = {"families": {}, "compared": {}}
    with D.fake_group(4):
        for arch in FAMILIES:
            for cell in CELLS:
                res["families"][f"{arch}/{cell.kind}"] = _trace(
                    config(arch), cell, (2, 2))
    for shape in ((2, 1), (1, 2)):
        with D.fake_group(2):
            res["compared"][f"{shape[0]}x{shape[1]}"] = _trace(
                *COMPARED, shape)
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
