"""The paper's benchmark harness on the port: ``benchmarks/run.py``'s rows,
one function per paper table or figure, on ``repro_torch`` (one card, or
the CPU with ``--device cpu``).  Prints ``name,us_per_call,derived`` CSV
rows, as ``run.py`` does.

  PYTHONPATH=src:. python -m benchmarks.run_torch            # every row
  PYTHONPATH=src:. python -m benchmarks.run_torch table1 eq12 --device cpu

Rows (``run.py``'s names and sizes):
- ``table1``, ``table2``: the gScale(nConn) regressions, through
  ``benchmarks/gscale_experiments_torch.py`` at its defaults (Table 2 at 5
  and 10 LHIs);
- ``fig2``: sparse against dense representation at 300 neurons, nConn 60,
  150 and 300, 200 steps;
- ``eq12``: the paper's memory model (``repro_torch.sparse.formats``);
- ``speed``: a step of the sparse and the dense representation at (500,
  50) and (1000, 100), timed over ``CompiledModel.run`` of 100 steps (CUDA
  graphs on the card; ``run.py`` builds through ``izhikevich_net.build``,
  which the port leaves out, so both build through ``compile_model``);
- ``kernels``: ``izhikevich_step``, ``hh_step`` and ``ell_spmv`` through
  the port's wrappers at ``run.py``'s shapes (the hand-written kernels on
  the card, their plain versions on the CPU), beside a dense ``s @ w``
  (a yardstick: a cuBLAS matrix product on the card);
- ``occupancy``: ``kernels/autotune.py``'s H100 occupancy table (on the
  CPU the plan of the shapes alone: no registers are read without a card);
- ``lm_scaling``: ``repro_torch.core.scaling.probe_and_fit`` at
  ``run.py``'s fan-ins (64-2048), its fitted hyperbola and the ratio
  scale(256) / scale(1024) (ideal 2.0), as ``run.py``'s two rows;
- ``roofline``: the H100 roofline of the dry run's records
  (``repro_torch.launch.roofline`` over ``experiments/dryrun_torch/``), a
  row a cell, or one row saying that no record exists yet.

Every timed row synchronises the card before it reads the clock.  The
results go to ``*_torch.json`` files under ``--out`` (default
``experiments/bench``); the JAX harness's files are never written.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

RESULTS = Path(__file__).resolve().parents[1] / "experiments" / "bench"


class _Run:
    """What every row needs: the device, the output folder, the CSV."""

    def __init__(self, device: torch.device, out: Path):
        self.device = device
        self.out = out
        self.rows = []

    def row(self, name: str, us: float, derived: str) -> str:
        line = f"{name},{us:.1f},{derived}"
        print(line, flush=True)
        self.rows.append(line)
        return line

    def save(self, name: str, payload: dict) -> None:
        self.out.mkdir(parents=True, exist_ok=True)
        (self.out / f"{name}_torch.json").write_text(
            json.dumps(payload, indent=1, default=float))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_fn(self, fn, *args, warmup: int = 2, iters: int = 5) -> float:
        """Median wall time of a call, in microseconds (``bench_util.
        time_fn``'s, the card synchronised after each call)."""
        for _ in range(warmup):
            fn(*args)
        self.sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            self.sync()
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2] * 1e6


# ---------------------------------------------------------------------------
# Table 1: Izhikevich conductance-scaling regression
# ---------------------------------------------------------------------------

def bench_table1_izhikevich_gscale(r: _Run) -> None:
    from benchmarks.gscale_experiments_torch import izhikevich_gscale_sweep
    t0 = time.perf_counter()
    res = izhikevich_gscale_sweep(device=r.device)
    us = (time.perf_counter() - t0) * 1e6
    r.save("table1_izhikevich", res)
    r.row("table1_izhikevich_k1", us / len(res["n_conns"]),
          f"k1={res['k1']:.4g}")
    r.row("table1_izhikevich_k2", 0.0, f"k2={res['k2']:.4g}")
    r.row("table1_izhikevich_k3", 0.0, f"k3={res['k3']:.4g}")
    r.row("table1_izhikevich_mape", 0.0,
          f"mape_pct={res['mape_pct']:.2f} (paper: 3.95)")


# ---------------------------------------------------------------------------
# Table 2 / Fig 3: mushroom-body regression at two LHI counts
# ---------------------------------------------------------------------------

def bench_table2_mushroom_gscale(r: _Run) -> None:
    from benchmarks.gscale_experiments_torch import mushroom_gscale_sweep
    for n_lhi in (5, 10):     # run.py's reduced stand-ins for the paper's
        t0 = time.perf_counter()
        res = mushroom_gscale_sweep(n_lhi=n_lhi, device=r.device)
        us = (time.perf_counter() - t0) * 1e6
        r.save(f"table2_mushroom_lhi{n_lhi}", res)
        r.row(f"table2_pn_kc_lhi{n_lhi}_k1", us / len(res["n_pns"]),
              f"k1={res['k1']:.4g}")
        r.row(f"table2_pn_kc_lhi{n_lhi}_mape", 0.0,
              f"mape_pct={res['mape_pct']:.2f} (paper PN-KC: 16.1)")
        r.row(f"table2_pn_lhi_lhi{n_lhi}_k1", 0.0,
              f"k1={res['k1_lhi']:.4g}")
        r.row(f"table2_pn_lhi_lhi{n_lhi}_mape", 0.0,
              f"mape_pct={res['mape_lhi_pct']:.2f} (paper PN-LHI: 71.4)")


# ---------------------------------------------------------------------------
# Fig 2: representation (sparse vs dense) must not change the scaling
# ---------------------------------------------------------------------------

FIG2 = dict(n_total=300, n_conns=(60, 150, 300), n_steps=200)


def fig2_sweeps(device, **size) -> dict:
    """``izhikevich_gscale_sweep`` at Fig. 2's size (``size`` overrides it)
    for each representation, with each sweep's seconds."""
    from benchmarks.gscale_experiments_torch import izhikevich_gscale_sweep
    out = {}
    for rep in ("sparse", "dense"):
        t0 = time.perf_counter()
        out[rep] = izhikevich_gscale_sweep(
            **{**FIG2, **size}, representation=rep, device=device)
        out[rep]["seconds"] = time.perf_counter() - t0
    return out


def bench_fig2_representation_agreement(r: _Run) -> None:
    res = fig2_sweeps(r.device)
    for rep in ("sparse", "dense"):
        r.row(f"fig2_gscale_{rep}", res[rep]["seconds"] * 1e6 / 4,
              "gscales=" + "/".join(f"{g:.3g}" for g in
                                    res[rep]["gscales"]))
    a = np.asarray(res["sparse"]["gscales"])
    b = np.asarray(res["dense"]["gscales"])
    mape = float(np.mean(np.abs(a - b) / np.maximum(np.abs(b), 1e-9))) * 100
    r.save("fig2_agreement", {"sparse": res["sparse"],
                              "dense": res["dense"], "mape_pct": mape})
    r.row("fig2_sparse_vs_dense_mape", 0.0,
          f"mape_pct={mape:.2f} (paper: 3.95, 'negligible')")


# ---------------------------------------------------------------------------
# Eq (1)/(2): memory model
# ---------------------------------------------------------------------------

def eq12_rows() -> list:
    """(nConn, sparse elements, dense elements) at 1000 x 1000 neurons."""
    from repro_torch.sparse import formats as F
    return [(n_conn, F.sparse_memory_elements(1000 * n_conn, 1000, 1000),
             F.dense_memory_elements(1000, 1000))
            for n_conn in range(100, 1001, 100)]


def bench_eq12_memory_model(r: _Run) -> None:
    rows = eq12_rows()
    r.save("eq12_memory", {"rows": rows})
    crossover = next((n for n, s, d in rows if s >= d), None)
    r.row("eq12_memory_sparse_at_100", 0.0,
          f"sparse={rows[0][1]}el dense={rows[0][2]}el")
    r.row("eq12_memory_crossover_nconn", 0.0,
          f"crossover={crossover} (sparse wins below)")


# ---------------------------------------------------------------------------
# Sparse vs dense step timing
# ---------------------------------------------------------------------------

def bench_sparse_vs_dense_step(r: _Run) -> None:
    from repro_torch.core.models import izhikevich_net
    out = {}
    for n_total, n_conn in ((500, 50), (1000, 100)):
        for rep in ("sparse", "dense"):
            cfg = izhikevich_net.IzhikevichNetConfig(
                n_total=n_total, n_conn=n_conn, representation=rep)
            model = izhikevich_net.compile_model(cfg, device=r.device)
            st = model.init_state()
            gs = {n: 1.0 for n in model.group_names}
            us = r.time_fn(lambda: model.run(100, gs, state=st), warmup=1,
                           iters=3) / 100
            out[f"{n_total}_{n_conn}_{rep}"] = us
            r.row(f"speed_step_n{n_total}_c{n_conn}_{rep}", us,
                  f"density={n_conn / n_total:.2f}")
    for key in ("500_50", "1000_100"):
        sp, dn = out[f"{key}_sparse"], out[f"{key}_dense"]
        r.row(f"speed_ratio_{key}", 0.0, f"dense/sparse={dn / sp:.2f}x")
    r.save("sparse_vs_dense_step", out)


# ---------------------------------------------------------------------------
# Kernel microbenchmarks: the port's wrappers
# ---------------------------------------------------------------------------

def bench_kernel_latencies(r: _Run) -> None:
    from repro_torch.kernels import ell_spmv as ELL
    from repro_torch.kernels import hh_step as HH
    from repro_torch.kernels import izhikevich_step as IZ
    rng = np.random.default_rng(0)
    dev = r.device

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    n = 1 << 14
    v = t(rng.uniform(-70, -50, n))
    u = t(rng.uniform(-15, -5, n))
    isyn = t(rng.standard_normal(n) * 3)
    a, b = torch.full((n,), 0.02, device=dev), torch.full((n,), 0.2,
                                                          device=dev)
    c, d = torch.full((n,), -65.0, device=dev), torch.full((n,), 8.0,
                                                           device=dev)
    us = r.time_fn(IZ.izhikevich_step, v, u, isyn, a, b, c, d, 1.0)
    r.row("kernel_izhikevich_step_16k", us, f"neurons_per_us={n / us:.0f}")

    m = t(rng.random(n))
    us = r.time_fn(HH.hh_step, v, m, m, m, isyn, 0.1)
    r.row("kernel_hh_step_16k", us, f"neurons_per_us={n / us:.0f}")

    npre, k, npost, bsz = 1024, 128, 1024, 8
    g = t(rng.standard_normal((npre, k)))
    idx = t(rng.integers(0, npost, (npre, k)), torch.int32)
    valid = torch.ones((npre, k), dtype=torch.bool, device=dev)
    spk = t(rng.random((bsz, npre)) < 0.1)
    us = r.time_fn(ELL.ell_spmv, g, idx, valid, spk, npost)
    r.row("kernel_ell_spmv_1kx128x8", us,
          f"synapses_per_us={bsz * npre * k / us:.0f}")
    w = torch.zeros((npre, npost), device=dev)
    usd = r.time_fn(torch.matmul, spk, w)
    r.row("kernel_dense_spmv_1kx1k", usd, f"ell_speedup={usd / us:.2f}x")


# ---------------------------------------------------------------------------
# Occupancy table (paper §3, the CUDA form)
# ---------------------------------------------------------------------------

def bench_occupancy_blocksize(r: _Run) -> None:
    from repro_torch.kernels.autotune import occupancy_report
    # without a card the plan of the shapes alone (no registers read)
    attrs = None if r.device.type == "cuda" else {}
    for line in occupancy_report(attrs=attrs).splitlines()[1:]:
        # names and grids hold commas: "flash_attention<float,1>",
        # "(625, 1, 1)"; the CSV row gets them without
        left, ctas, occ, limiter = line.rsplit(",", 3)
        cut = left.rindex("(") - 1 if left.endswith(")") else \
            left.rindex(",")
        name, block = left[:cut].rsplit(",", 1)
        grid = "x".join(left[cut + 1:].strip("()").split(", "))
        name = name.replace(", ", "x").replace(",", "_").replace(" ", "_")
        r.row(f"occupancy_{name}", 0.0,
              f"block={block} grid={grid} resident_ctas={ctas} occ={occ} "
              f"limiter={limiter}")


# ---------------------------------------------------------------------------
# LM-side rows
# ---------------------------------------------------------------------------

def bench_lm_scaling_probe(r: _Run) -> None:
    from repro_torch import random as RND
    from repro_torch.core.scaling import probe_and_fit
    t0 = time.perf_counter()
    pol = probe_and_fit(RND.PRNGKey(0),
                        fanins=(64, 128, 256, 512, 1024, 2048),
                        device=r.device)
    us = (time.perf_counter() - t0) * 1e6
    r.save("lm_scaling_policy", {"k1": pol.k1, "k2": pol.k2, "k3": pol.k3})
    r.row("lm_scaling_fit", us / 6,
          f"k1={pol.k1:.4g} k2={pol.k2:.4g} k3={pol.k3:.4g}")
    # the fitted law should track 1/fan_in on the variance
    s256, s1024 = pol.scale(256), pol.scale(1024)
    r.row("lm_scaling_ratio_256_1024", 0.0,
          f"scale_ratio={s256 / s1024:.2f} (ideal 2.0)")


def bench_roofline(r: _Run) -> None:
    from repro_torch.launch import roofline as RL
    seen = False
    for tag in ("pod16x16", "pod2x16x16"):
        ok = [x for x in RL.build_table(tag) if "why" not in x]
        for x in ok:
            r.row(f"roofline_{tag}_{x['arch']}_{x['shape']}",
                  x["step_time_bound_s"] * 1e6,
                  f"bottleneck={x['bottleneck']} "
                  f"frac={x['roofline_fraction']:.2f} "
                  f"useful={x['useful_ratio']:.2f}")
        if ok:
            seen = True
            r.save(f"roofline_{tag}", {"rows": ok})
    if not seen:
        r.row("roofline_no_records", 0.0,
              f"no dry-run record under {RL.ART_DIR} (python -m "
              "repro_torch.launch.dryrun --all --both-meshes)")


BENCHES = {
    "table1": bench_table1_izhikevich_gscale,
    "table2": bench_table2_mushroom_gscale,
    "fig2": bench_fig2_representation_agreement,
    "eq12": bench_eq12_memory_model,
    "speed": bench_sparse_vs_dense_step,
    "kernels": bench_kernel_latencies,
    "occupancy": bench_occupancy_blocksize,
    "lm_scaling": bench_lm_scaling_probe,
    "roofline": bench_roofline,
}


def main(argv=None) -> list:
    """Run the named rows (default: all); returns the CSV lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="ROW",
                    help=f"rows: {', '.join(BENCHES)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown rows {unknown}; rows: {', '.join(BENCHES)}")
    from repro_torch._device import resolve_device
    r = _Run(resolve_device(args.device), Path(args.out))
    print("name,us_per_call,derived", flush=True)
    for n in args.names or list(BENCHES):
        BENCHES[n](r)
    return r.rows


if __name__ == "__main__":
    main()
