"""The port's report from its artifacts, the counterpart of
``benchmarks/report.py``.

  PYTHONPATH=src python -m benchmarks.report_torch [--out FILE]

Four sections, each rendered from what the port's runs left under
``experiments/`` (a section whose artifacts are missing says so):

  Paper validation  ``benchmarks/run_torch.py``'s ``table1``, ``table2``,
                    ``fig2`` and ``eq12`` rows (``experiments/bench/
                    *_torch.json``)
  Dry run           ``launch/dryrun.py``'s records (``experiments/
                    dryrun_torch/<mesh>/``): status, peak GB a card
                    against the card's 80 GB, parameter GB a card,
                    collective counts by kind
  Roofline          ``launch/roofline.py``'s three terms at the H100's
                    data-sheet rates
  Perf log          ``benchmarks/hillclimb_torch.py``'s variants
                    (``experiments/perf_torch/*.json``)

It writes its own file (``experiments/report_torch.md`` by default,
git-ignored), never ``EXPERIMENTS.md``, which is the JAX script's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.kernels.autotune import H100_RATES
from repro_torch.launch import roofline as RL

ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "experiments"
OUT = ART / "report_torch.md"
MESHES = (("pod16x16", "16 x 16 = 256 cards"),
          ("pod2x16x16", "2 x 16 x 16 = 512 cards"))


def _load(p: Path):
    try:
        return json.loads(p.read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def paper_validation(art: Path = ART) -> str:
    out = ["## Paper validation (the paper's own claims, on the port)", ""]
    bench = art / "bench"
    t1 = _load(bench / "table1_izhikevich_torch.json")
    if t1:
        out += [
            "### Table 1: Izhikevich net, conductance-scaling fit", "",
            f"nConn in {t1['n_conns']}, target rate "
            f"{t1['target_rate']:.1f} Hz.", "",
            "| | k1 | k2 | k3 | MAPE % |", "|---|---|---|---|---|",
            "| paper (1000 neurons) | 1.318e3 | 1.099e2 | -0.28 | 3.95 |",
            f"| the port | {t1['k1']:.4g} | {t1['k2']:.4g} | "
            f"{t1['k3']:.4g} | {t1['mape_pct']:.2f} |", "",
            "gScale per nConn: " + ", ".join(
                f"{n}->{g:.3g}" for n, g in zip(t1["n_conns"],
                                                t1["gscales"])), ""]
    for lhi in (5, 10):
        t2 = _load(bench / f"table2_mushroom_lhi{lhi}_torch.json")
        if not t2:
            continue
        out += [f"### Table 2: mushroom body, {lhi} LHIs", "",
                f"PN->KC fit: k1={t2['k1']:.4g} k2={t2['k2']:.4g} "
                f"k3={t2['k3']:.4g}, MAPE {t2['mape_pct']:.2f}% (paper "
                "PN-KC: 16.1%).", ""]
        if "k1_lhi" in t2:
            out += [f"PN->LHI fit: k1={t2['k1_lhi']:.4g} "
                    f"k2={t2['k2_lhi']:.4g} k3={t2['k3_lhi']:.4g}, MAPE "
                    f"{t2['mape_lhi_pct']:.2f}% (paper PN-LHI: 71.4%).", ""]
    f2 = _load(bench / "fig2_agreement_torch.json")
    if f2:
        out += ["### Fig. 2: sparse against dense representation", "",
                "gScale(nConn) searched under each representation: MAPE "
                f"between them {f2['mape_pct']:.2f}% (paper: 3.95%).", ""]
    eq = _load(bench / "eq12_memory_torch.json")
    if eq:
        n, sparse, dense = eq["rows"][0]
        cross = next((r[0] for r in eq["rows"] if r[1] >= r[2]), None)
        out += ["### Eq. (1)/(2): the memory model", "",
                f"1000 x 1000 neurons at nConn={n}: sparse {sparse:,} "
                f"elements against dense {dense:,}; sparse stops winning "
                f"at nConn={cross}.", ""]
    if len(out) == 2:
        out += ["(no record: `PYTHONPATH=src:. python -m benchmarks.run_torch "
                "table1 table2 fig2 eq12`)", ""]
    return "\n".join(out)


def _dryrun_row(r: dict) -> str:
    if r["status"] != "OK":
        why = r.get("reason") or r.get("error") or ""
        return f"| {r['arch']} | {r['shape']} | {r['status']} | | | | " \
               f"{why[:60]} |"
    peak = r["peak_bytes"] / 1e9
    fits = "yes" if r["peak_bytes"] <= H100_RATES.hbm_bytes else "NO"
    pb = r.get("analytic_param_bytes_per_device", 0) / 1e9
    c = r["collectives"]["counts"]
    cs = "/".join(str(c.get(k, 0)) for k in
                  ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all"))
    return (f"| {r['arch']} | {r['shape']} | OK | {peak:.2f} ({fits}) | "
            f"{pb:.2f} | {r.get('trace_s', 0):.1f} | {cs} |")


def dryrun_section(art: Path = ART) -> str:
    card = H100_RATES.hbm_bytes / 1e9
    out = ["## Dry run (every cell's step traced on a fake group)", "",
           "Each (arch x shape x mesh) step traced at full width on fake "
           "tensors as rank 0 of a fake group (`launch/dryrun.py`): this "
           f"rank's peak of live bytes against the card's {card:.0f} GB, "
           "its parameter bytes, and the collectives the step issues.", ""]
    seen = False
    for tag, label in MESHES:
        files = sorted((art / "dryrun_torch" / tag).glob("*.json"))
        recs = [r for r in (_load(f) for f in files) if r]
        if not recs:
            continue
        seen = True
        out += [f"### {label}", "",
                "| arch | shape | status | peak GB a card (fits) | param GB "
                "a card | trace s | collectives (ag/ar/rs/a2a) |",
                "|---|---|---|---|---|---|---|"]
        out += [_dryrun_row(r) for r in recs] + [""]
    if not seen:
        out += ["(no record: `PYTHONPATH=src python -m "
                "repro_torch.launch.dryrun --all --both-meshes --device "
                "cpu`)", ""]
    return "\n".join(out)


def roofline_section(art: Path = ART) -> str:
    out = ["## Roofline (one H100)", "",
           f"Terms in seconds a step on one card: compute = FLOPs / "
           f"{RL.PEAK_FLOPS:.3g} (bf16 dense), memory = bytes / "
           f"{RL.HBM_BW:.3g} B/s (HBM3), collective = operand bytes / "
           f"{RL.LINK_BW:.3g} B/s (a card's link between nodes); the "
           "data sheet's rates, none measured.  `MODEL/counted` is the "
           "useful share of the counted FLOPs.", ""]
    seen = False
    for tag, _ in MESHES:
        rows = RL.build_table(tag, art / "dryrun_torch")
        if rows:
            seen = True
            out += [f"### {tag}", "", RL.format_table(rows), ""]
    if not seen:
        out += ["(no dry-run record)", ""]
    return "\n".join(out)


def perf_section(art: Path = ART) -> str:
    out = ["## Perf log (hillclimb variants)", "",
           "Each variant a config tweak traced on the fake group "
           "(`benchmarks/hillclimb_torch.py`); `*no_core` rows leave out "
           "the LM kernels' custom ops (flash attention, the SSD scan).",
           ""]
    files = sorted((art / "perf_torch").glob("*.json"))
    runs = [r for r in (_load(f) for f in files) if r]
    for r in runs:
        out += [f"### {r['cell']}", "",
                "| variant | TFLOP a card | GB moved | collective GB | "
                "peak GB |", "|---|---|---|---|---|"]
        for name, s in r["steps"].items():
            out.append(f"| {name} | {s['flops'] / 1e12:.4g} | "
                       f"{s['bytes'] / 1e9:.4g} | "
                       f"{s['collective_bytes'] / 1e9:.4g} | "
                       f"{s['peak_bytes'] / 1e9:.2f} |")
        out.append("")
    if not runs:
        out += ["(no run: `PYTHONPATH=src python -m "
                "benchmarks.hillclimb_torch --cell CELL`)", ""]
    return "\n".join(out)


def render(art: Path = ART) -> str:
    return "\n".join([
        "# The port's report",
        "",
        "Generated by `python -m benchmarks.report_torch` from the port's "
        "artifacts under `experiments/`.",
        "",
        paper_validation(art), dryrun_section(art), roofline_section(art),
        perf_section(art)])


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--art", default=str(ART),
                    help="the artifacts' folder (default: experiments/)")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    out = Path(args.out)
    if out.name == "EXPERIMENTS.md":
        ap.error("EXPERIMENTS.md is the JAX report's; write another file")
    doc = render(Path(args.art))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(doc)
    print(f"wrote {out} ({len(doc)} chars)")
    return out


if __name__ == "__main__":
    main()
