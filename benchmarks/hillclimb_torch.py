"""The hillclimb measurement driver on the port, the counterpart of
``benchmarks/hillclimb.py``.

For a cell it traces a sequence of named variants (the JAX script's
names: the baseline, the step without its attention and SSD cores, the
``"dots"`` remat policy, bfloat16 logits, weights replicated for
serving), each a config tweak traced through ``launch/dryrun.py``'s
``trace_cell`` as rank 0 of a fake group of 256 on the production 16 x 16
mesh, and writes ``experiments/perf_torch/<cell>.json`` (git-ignored).
Each row gives this rank's FLOPs, bytes, collective operand bytes and
peak live bytes.

``no_core``: the JAX script takes the attention and SSD cores out of
XLA's count (``flags.ROOFLINE_NO_ATTN`` / ``_NO_SSD``).  Here the four LM
kernels are custom ops whose FLOPs and bytes the dry run's counter keeps
apart (``dryrun.CORE_OPS``), so a ``*no_core`` row is its variant's trace
less those terms (the peak and the collectives are the trace's).

The traces run on fake cuda tensors where a card is present, else on
fake CPU tensors (the two count the same: ``chip_smoke.py`` phase 20c);
``--device`` picks one.

  PYTHONPATH=src python -m benchmarks.hillclimb_torch --cell mixtral_train
  PYTHONPATH=src python -m benchmarks.hillclimb_torch --cell whisper_decode \\
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH

OUT = Path(__file__).resolve().parents[1] / "experiments" / "perf_torch"


def row(rec: dict, no_core: bool = False) -> dict:
    """A variant's row from its trace's record: FLOPs, bytes, collective
    bytes and peak bytes; with ``no_core`` the custom ops' FLOPs and bytes
    taken out (their terms beside)."""
    out = {"flops": rec["flops"], "bytes": rec["bytes"],
           "collective_bytes": rec["collectives"]["total_bytes"],
           "peak_bytes": rec["peak_bytes"]}
    if no_core:
        core = rec["core"]
        out["flops"] -= sum(c["flops"] for c in core.values())
        out["bytes"] -= sum(c["bytes"] for c in core.values())
        out["core"] = core
    return out


def mixtral_train(cfg, shape, mesh) -> dict:
    base = D.trace_cell(cfg, shape, mesh)
    # iter 1: remat policy "dots": save the batch-free products' outputs
    cfg1 = dataclasses.replace(cfg, remat_policy="dots")
    dots = D.trace_cell(cfg1, shape, mesh)
    # iter 2: + bfloat16 logits
    cfg2 = dataclasses.replace(cfg1, logits_dtype="bfloat16")
    bf16 = D.trace_cell(cfg2, shape, mesh)
    return {"baseline_naive": row(base), "no_core": row(base, True),
            "remat_dots": row(dots), "remat_dots_no_core": row(dots, True),
            "remat_dots_bf16logits_no_core": row(bf16, True)}


def qwen2_prefill(cfg, shape, mesh) -> dict:
    base = D.trace_cell(cfg, shape, mesh)
    # bfloat16 logits: prefill's head emits [B, 1, V], so little moves
    bf16 = D.trace_cell(dataclasses.replace(cfg, logits_dtype="bfloat16"),
                        shape, mesh)
    # weights replicated for serving: no FSDP all-gathers a layer
    rep = D.trace_cell(dataclasses.replace(cfg, serve_replicate_weights=True),
                       shape, mesh)
    return {"baseline_naive": row(base), "no_core": row(base, True),
            "bf16_logits_no_core": row(bf16, True),
            "replicated_no_core": row(rep, True)}


def whisper_decode(cfg, shape, mesh) -> dict:
    base = D.trace_cell(cfg, shape, mesh)
    rep = D.trace_cell(dataclasses.replace(cfg, serve_replicate_weights=True),
                       shape, mesh)
    return {"baseline": row(base), "replicated_weights": row(rep)}


# cell -> (arch, shape, its variants)
CELLS = {
    "mixtral_train": ("mixtral-8x22b", "train_4k", mixtral_train),
    "qwen2_prefill": ("qwen2-0.5b", "prefill_32k", qwen2_prefill),
    "whisper_decode": ("whisper-tiny", "decode_32k", whisper_decode),
}


def run(cell: str, device=None, out: Path = OUT, cfg=None, shape=None,
        mesh_shape=(16, 16)) -> dict:
    """One cell's variants on a fake group of ``mesh_shape``'s ranks (the
    one already up, or one made here), written to ``out/<cell>.json``.
    ``cfg`` / ``shape``: another config and shape than the cell's own (a
    test's reduced ones)."""
    arch, shape_name, variants = CELLS[cell]
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    dev = torch.device(device or ("cuda" if torch.cuda.is_available()
                                  else "cpu"))
    world = mesh_shape[0] * mesh_shape[1]
    with D.fake_group(world):
        mesh = MESH.make_mesh(mesh_shape, ("data", "model"), device=dev)
        steps = variants(cfg, shape, mesh)
    tag = f"pod{mesh_shape[0]}x{mesh_shape[1]}"
    res = {"cell": f"{cfg.name} x {shape.name} x {tag}", "steps": steps,
           "n_devices": world, "device": dev.type}
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{cell}.json").write_text(json.dumps(res, indent=1))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device: cuda where a card is "
                         "present (default), else cpu")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    res = run(args.cell, args.device, Path(args.out))
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
