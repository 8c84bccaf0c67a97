"""The H100 roofline of the dry run's records, the counterpart of
``benchmarks/roofline.py``.

Three terms per (arch x shape x mesh) cell, in seconds a step on one card,
from the records of ``launch/dryrun.py`` (``experiments/dryrun_torch/``):

  compute    = FLOPs a card / the bf16 dense peak (989 TFLOP/s)
  memory     = bytes a card / the HBM3 rate (3.35 TB/s)
  collective = collective operand bytes a card / the link rate

The rates are the data sheet's (``kernels.autotune.H100_RATES``), none
measured.  The link rate is the one between nodes, one 400 Gb/s NDR port a
card (50 GB/s a direction): a node holds 8 cards, so a ring over the
production mesh's "model" axis (16 cards) crosses nodes, and so does one
over its batch axes (16 or 32 cards, 8 or 16 nodes apart); NVLink's 450
GB/s a direction (``H100_RATES.nvlink_bytes_per_s``) would bound only a
collective that stays inside a node, and no axis of these meshes does.

The trace counts every op of the step at full depth, and the flash and SSD
kernels' formulas count their own products (``kernels.flash_attention.
attention_flops``, ``kernels.ssd_scan.scan_flops``), so the JAX roofline's
``attention_correction`` (which swaps a naive attention's counts for the
flash kernel's) is not needed.  ``_attn_layers``, ``_visibility``,
``_param_counts`` and ``model_flops`` are the JAX module's, which the
tests hold equal; ``model_flops`` (6 N D for training, 2 N D to prefill, 2
N a decoded token, N the active parameters) gives the useful share of the
counted FLOPs.

  python -m repro_torch.launch.roofline      # both meshes' tables
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.autotune import H100_RATES
from repro_torch.launch.dryrun import ART_DIR

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "model_flops", "load_cell",
           "cell_terms", "build_table", "format_table", "format_both"]

PEAK_FLOPS = H100_RATES.bf16_flops          # a card, bf16 dense
HBM_BW = H100_RATES.hbm_bytes_per_s         # a card
LINK_BW = H100_RATES.internode_bytes_per_s  # a card, a direction


def _attn_layers(cfg: ArchConfig) -> List[Dict]:
    """(count, window) per attention layer class."""
    prog = cfg.program()
    out = []
    for rep in (prog.repeats,):
        for seg in prog.segments:
            if seg.kind in ("attn", "attn_local", "attn_global",
                            "shared_attn", "moe"):
                window = cfg.window
                if seg.kind == "attn_local":
                    window = cfg.local_window
                elif seg.kind == "attn_global":
                    window = None
                out.append({"n": seg.n * rep, "window": window})
    for seg in prog.tail:
        if seg.kind != "mamba":
            window = cfg.local_window if seg.kind == "attn_local" \
                else cfg.window
            out.append({"n": seg.n, "window": window})
    return out


def _visibility(tq: int, tk: int, window: Optional[int],
                causal: bool = True) -> float:
    """Average fraction of the Tq x Tk rectangle a flash kernel computes
    (``kernels.flash_attention.visible_pairs`` over Tq Tk)."""
    causal_vis = 0.5 * (1 + 1 / tq) if causal and tq == tk else 1.0
    if window is not None:
        return min(causal_vis, min(window, tk) / tk)
    return causal_vis


def _param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Analytic total + active params (embedding included once)."""
    d = cfg.d_model
    v = cfg.vocab
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_attn = d * (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d if cfg.n_heads else 0
    per_mlp = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    di = cfg.ssm_expand * d
    g = cfg.ssm_groups
    per_mamba = d * (2 * di + 2 * g * cfg.ssm_state
                     + (di // max(cfg.ssm_head, 1))) + di * d if \
        cfg.ssm_state else 0

    total = emb
    active = emb
    prog = cfg.program()
    for rep, segs in ((prog.repeats, prog.segments), (1, prog.tail)):
        for seg in segs:
            n = seg.n * rep
            if seg.kind == "mamba":
                total += n * per_mamba
                active += n * per_mamba
            elif seg.kind == "moe":
                moe_total = cfg.n_experts * 3 * d * cfg.d_ff
                moe_active = cfg.top_k * 3 * d * cfg.d_ff
                total += n * (per_attn + moe_total + d * cfg.n_experts)
                active += n * (per_attn + moe_active + d * cfg.n_experts)
            elif seg.kind == "shared_attn":
                total += per_attn + per_mlp
                active += n * (per_attn + per_mlp)  # applied n*rep times
            else:
                total += n * (per_attn + per_mlp)
                active += n * (per_attn + per_mlp)
    if cfg.n_enc_layers:
        total += cfg.n_enc_layers * (per_attn + per_mlp)
        active += cfg.n_enc_layers * (per_attn + per_mlp)
    return {"total": float(total), "active": float(active)}


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    n = _param_counts(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def load_cell(mesh_tag: str, arch: str, shape: str) -> Optional[dict]:
    p = ART_DIR / mesh_tag / f"{arch}__{shape}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def cell_terms(rec: dict) -> Optional[dict]:
    """The three terms of an OK record, its bottleneck and the useful
    share of its FLOPs; None for a SKIP or a FAIL."""
    if rec.get("status") != "OK":
        return None
    cfg = get_config(rec["arch"])
    shape = get_shape(rec["shape"])
    flops, hbm = float(rec["flops"]), float(rec["bytes"])
    coll = float(rec["collectives"]["total_bytes"])
    t_c, t_m, t_n = flops / PEAK_FLOPS, hbm / HBM_BW, coll / LINK_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_n, "collective"))
    mf = model_flops(cfg, shape) / rec["n_devices"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "peak_gb": rec["peak_bytes"] / 1e9, "fits": rec["fits"],
        "flops_per_dev": flops, "hbm_bytes_per_dev": hbm,
        "coll_bytes_per_dev": coll,
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_n,
        "bottleneck": dom[1],
        "model_flops_per_dev": mf,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": t_c / dom[0] if dom[0] else 0.0,
        "step_time_bound_s": dom[0],
    }


def build_table(mesh_tag: str = "pod16x16") -> List[dict]:
    """A row a cell that has a record: its terms, or its SKIP reason or
    FAIL error."""
    rows = []
    for arch in ARCHS:
        for shape in SHAPES:
            rec = load_cell(mesh_tag, arch, shape.name)
            if rec is None:
                continue
            t = cell_terms(rec)
            if t:
                rows.append(t)
            else:
                rows.append({"arch": arch, "shape": shape.name,
                             "mesh": mesh_tag, "status": rec["status"],
                             "why": rec.get("reason") or rec.get("error")})
    return rows


def format_table(rows: List[dict]) -> str:
    hdr = ("| arch | shape | peak GB (fits 80) | TFLOP | GB moved | "
           "coll GB | compute s | memory s | collective s | bottleneck | "
           "MODEL/counted |")
    lines = [hdr, "|" + "---|" * 11]
    for r in rows:
        if "why" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} | "
                         f"| | | | | | | {str(r['why'])[:60]} |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['peak_gb']:.2f} "
            f"({'yes' if r['fits'] else 'NO'}) | "
            f"{r['flops_per_dev'] / 1e12:.4g} | "
            f"{r['hbm_bytes_per_dev'] / 1e9:.4g} | "
            f"{r['coll_bytes_per_dev'] / 1e9:.4g} | "
            f"{r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | "
            f"{r['t_collective_s']:.3e} | {r['bottleneck']} | "
            f"{r['useful_ratio']:.2f} |")
    return "\n".join(lines)


def _pair(a: dict, b: Optional[dict], fmt) -> str:
    return fmt(a) if b is None or "why" in b else f"{fmt(a)} / {fmt(b)}"


def format_both(rows: List[dict], rows2: List[dict]) -> str:
    """One row a cell of two meshes' tables (16 x 16 / 2 x 16 x 16 in
    each column)."""
    other = {(r["arch"], r["shape"]): r for r in rows2}
    hdr = ("| arch | shape | peak GB a card (fits 80) | TFLOP a card | GB "
           "moved | collective GB | compute s | memory s | collective s | "
           "bottleneck |")
    lines = [hdr, "|" + "---|" * 10]
    cols = (
        lambda r: f"{r['peak_gb']:.2f}" + ("" if r["fits"] else " (NO)"),
        lambda r: f"{r['flops_per_dev'] / 1e12:.4g}",
        lambda r: f"{r['hbm_bytes_per_dev'] / 1e9:.4g}",
        lambda r: f"{r['coll_bytes_per_dev'] / 1e9:.4g}",
        lambda r: f"{r['t_compute_s']:.3g}",
        lambda r: f"{r['t_memory_s']:.3g}",
        lambda r: f"{r['t_collective_s']:.3g}",
        lambda r: r["bottleneck"])
    for r in rows:
        b = other.get((r["arch"], r["shape"]))
        if "why" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']}: "
                         f"{str(r['why'])[:48]} |" + " |" * 7)
            continue
        lines.append(f"| {r['arch']} | {r['shape']} | "
                     + " | ".join(_pair(r, b, c) for c in cols) + " |")
    return "\n".join(lines)


def main() -> None:
    """Both meshes' tables, and the two in one (16 x 16 / 2 x 16 x 16)."""
    tables = {tag: build_table(tag) for tag in ("pod16x16", "pod2x16x16")}
    for tag, rows in tables.items():
        if rows:
            print(f"\n== {tag} ==")
            print(format_table(rows))
    if all(tables.values()):
        print("\n== pod16x16 / pod2x16x16 ==")
        print(format_both(tables["pod16x16"], tables["pod2x16x16"]))


if __name__ == "__main__":
    main()
