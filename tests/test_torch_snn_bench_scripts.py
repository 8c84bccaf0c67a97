"""The port's SNN benchmark scripts on the CPU at the JAX scripts' CI knobs
(.github/workflows/ci.yml), each into a temporary directory: every key of
the JAX script's committed JSON (experiments/bench/BENCH_<name>.json) is
in the port's, and the rows are the JAX script's rows (the port adds the
dense representation's "gemv" row to snn_event)."""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parents[1] / "experiments" / "bench"

# the JAX scripts' CI knobs
CI_ENV = {
    "snn_scaling": {"SNN_BENCH_PER_DEV": "256", "SNN_BENCH_NCONN": "32",
                    "SNN_BENCH_STEPS": "10"},
    "snn_probes": {"SNN_PROBE_BENCH_N": "200", "SNN_PROBE_BENCH_NCONN": "32",
                   "SNN_PROBE_BENCH_STEPS": "50"},
    "snn_health": {"SNN_HEALTH_BENCH_N": "200",
                   "SNN_HEALTH_BENCH_NCONN": "32",
                   "SNN_HEALTH_BENCH_STEPS": "50"},
    "snn_event": {"SNN_EVENT_BENCH_N": "2048", "SNN_EVENT_BENCH_NCONN": "32",
                  "SNN_EVENT_BENCH_STEPS": "100"},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, monkeypatch, tmp_path):
    import importlib
    for k, v in CI_ENV[name].items():
        monkeypatch.setenv(k, v)
    mod = importlib.import_module(f"benchmarks.{name}_torch")
    payload = mod.main(["--device", "cpu", "--out", str(tmp_path)])
    written = json.loads((tmp_path / f"BENCH_{name}_torch.json").read_text())
    assert written.keys() == payload.keys()
    jax_keys = json.loads((BENCH / f"BENCH_{name}.json").read_text()).keys()
    assert set(jax_keys) <= set(written), set(jax_keys) - set(written)
    assert written["backend"] == "cpu"
    return written


def test_snn_scaling_torch(monkeypatch, tmp_path):
    """One rank without a launcher (a world of one, torn down after; the
    D > 1 rows: tests/test_torch_engine.py's gloo ranks)."""
    up = torch.distributed.is_initialized()
    try:
        out = _run("snn_scaling", monkeypatch, tmp_path)
    finally:
        if not up and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert [r["n"] for r in out["construction"]] == [256, 512, 1024]
    for r in out["construction"]:
        assert r["host_s"] > 0 and r["device_s"] > 0 and r["n_conn"] == 32
    assert [r["devices"] for r in out["weak_scaling"]] == [1]
    assert out["weak_scaling"][0]["us_per_step"] > 0
    assert [(r["path"], r["devices"]) for r in out["construction_memory"]] \
        == [("fused_local", 1), ("generate_partition", 1)]
    assert out["construction_memory"][0]["k_local"] == 32
    assert out["devices"] == 1 and "gloo" in out["left_out"]


def test_snn_probes_torch(monkeypatch, tmp_path):
    out = _run("snn_probes", monkeypatch, tmp_path)
    assert [r["probes"] for r in out["probe_overhead"]] == [0, 1, 4]
    assert out["probe_overhead"][0]["overhead_vs_unprobed"] == 1.0
    assert (out["n_total"], out["n_conn"], out["n_steps"]) == (200, 32, 50)


def test_snn_health_torch(monkeypatch, tmp_path):
    out = _run("snn_health", monkeypatch, tmp_path)
    assert [r["monitor"] for r in out["monitor_overhead"]] == [0, 1]
    assert all(r["us_per_step"] > 0 for r in out["monitor_overhead"])


def test_snn_event_torch(monkeypatch, tmp_path):
    monkeypatch.setenv("SNN_EVENT_BENCH_REPS", "1")
    out = _run("snn_event", monkeypatch, tmp_path)
    jax_out = json.loads((BENCH / "BENCH_snn_event.json").read_text())
    rates = [r["rate_pct"] for r in jax_out["speedups"]]
    assert [r["rate_pct"] for r in out["speedups"]] == rates
    assert {(r["mode"], r["rate_pct"]) for r in out["modes"]} == {
        (m, r) for m in ("dense", "event", "gemv") for r in rates}
    assert "same live-row ELL kernel" in out["propagation"]
    for r in out["speedups"]:
        assert set(jax_out["speedups"][0]) - {"event_speedup",
                                              "event_speedup_ungated"} \
            <= set(r)
