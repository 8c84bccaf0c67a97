"""The paper's benchmark harness on the port (``benchmarks/run_torch.py``)
and the seeded-determinism smoke (``benchmarks/determinism_smoke_torch.py``)
on the CPU.

- ``eq12``'s rows equal ``benchmarks/run.py``'s exactly;
- ``fig2``'s sparse and dense gScales against the JAX harness's under
  ``tests/test_torch_gscale_experiment.py``'s rule, on a reduced grid:
  ``run.py``'s 300 neurons at nConn 60 and 300 (of 60, 150, 300), 100
  steps (of 200) and 6 candidates a search (of 20).  The full grid takes
  ~45 s alone and 466 s of a worker under the whole suite's load; this
  one ~16 s alone;
- ``occupancy``, ``speed``, ``kernels``, ``lm_scaling`` and ``roofline``
  print well-formed rows on the CPU (``table1`` and ``table2`` are
  ``tests/test_torch_gscale_experiment.py``'s experiment, not re-run);
- the determinism smoke passes at 1, 2 and 8 gloo ranks (one group of
  each size, under the script's wall-clock limit) and leaves no process
  group up.
Every file goes to ``tmp_path``, never into the tree.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import determinism_smoke_torch as DS  # noqa: E402
from benchmarks import gscale_experiments as JEXP  # noqa: E402
from benchmarks import run as JRUN  # noqa: E402
from benchmarks import run_torch as RT  # noqa: E402

DT_S = 1e-3                       # the Izhikevich net's dt, 1 ms
ALLOW_HZ = 0.002 / DT_S           # 0.2% of a spike a neuron-step
SAME = 1e-5                       # grids built in float32 by either package
# fig2's grid, cut (the module docstring says why)
FIG2_CUT = dict(n_conns=(60, 300), n_steps=100, candidates=6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and small
    CPU ops under several spinning thread pools ran ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(text):
    """The CSV rows of a harness's output (its header dropped)."""
    lines = [ln for ln in text.splitlines() if ln.count(",") >= 2]
    assert lines and lines[0] == "name,us_per_call,derived"
    return lines[1:]


def test_eq12_rows_equal_the_jax_harness(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(JRUN, "RESULTS", tmp_path / "jax")
    print("name,us_per_call,derived")
    JRUN.bench_eq12_memory_model()
    want = _rows(capsys.readouterr().out)
    got = RT.main(["eq12", "--device", "cpu", "--out", str(tmp_path)])
    assert got == want and len(got) == 2
    saved = json.loads((tmp_path / "eq12_memory_torch.json").read_text())
    jax_saved = json.loads((tmp_path / "jax" / "eq12_memory.json")
                           .read_text())
    assert saved == jax_saved


def test_fig2_gscales_agree_with_the_jax_harness():
    size = dict(RT.FIG2, **FIG2_CUT)
    port = RT.fig2_sweeps("cpu", **FIG2_CUT)
    for rep in ("sparse", "dense"):
        ref = JEXP.izhikevich_gscale_sweep(**size, representation=rep)
        p = port[rep]
        assert p["n_conns"] == list(size["n_conns"])
        assert p["representation"] == rep and all(p["finite"])
        assert abs(p["target_rate"] - float(ref["target_rate"])) <= ALLOW_HZ
        for i, n in enumerate(size["n_conns"]):
            a, j = p["gscales"][i], float(ref["gscales"][i])
            if abs(a - j) <= SAME * abs(j):
                continue
            dp = p["rates"][i] - p["target_rate"]
            dj = float(ref["rates"][i]) - float(ref["target_rate"])
            assert dp * dj <= 0, (rep, n, a, j, dp, dj)
            assert max(abs(dp), abs(dj)) <= ALLOW_HZ, (rep, n, a, j, dp, dj)


def test_the_other_rows_are_well_formed(tmp_path, capsys):
    names = ["occupancy", "speed", "kernels", "lm_scaling", "roofline"]
    rows = RT.main(names + ["--device", "cpu", "--out", str(tmp_path)])
    assert rows == _rows(capsys.readouterr().out)
    by_name = {}
    for line in rows:
        name, us, derived = line.split(",", 2)
        assert name and derived and "," not in name, line
        assert float(us) >= 0.0, line
        by_name[name] = (float(us), derived)
    for key in ("500_50", "1000_100"):
        for rep in ("sparse", "dense"):
            n, c = key.split("_")
            assert by_name[f"speed_step_n{n}_c{c}_{rep}"][0] > 0
        assert by_name[f"speed_ratio_{key}"][1].startswith("dense/sparse=")
    for k in ("izhikevich_step_16k", "hh_step_16k", "ell_spmv_1kx128x8",
              "dense_spmv_1kx1k"):
        assert by_name[f"kernel_{k}"][0] > 0
    occ = [n for n in by_name if n.startswith("occupancy_")]
    assert "occupancy_izhikevich_step_exc" in occ and len(occ) > 10
    assert all("block=" in by_name[n][1] and "occ=" in by_name[n][1]
               for n in occ)
    for name in ("lm_scaling", "roofline"):
        assert "8.7" in by_name[f"{name}_not_ported"][1]
    assert json.loads((tmp_path / "sparse_vs_dense_step_torch.json")
                      .read_text())
    assert all(p.name.endswith("_torch.json") for p in tmp_path.iterdir())


def test_an_unknown_row_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        RT.main(["table3", "--device", "cpu", "--out", str(tmp_path)])


@pytest.mark.parametrize("devices", [1, 2, 8])
def test_determinism_smoke(devices, tmp_path):
    payload = DS.main(["--device", "cpu", "--devices", str(devices),
                       "--out", str(tmp_path)])
    assert payload["devices_compared"] == [1, devices]
    assert payload["checks"] and all(payload["checks"].values()), payload
    saved = json.loads((tmp_path / DS.OUT_NAME).read_text())
    assert saved["checks"] == payload["checks"]
    assert not torch.distributed.is_initialized()


def test_the_determinism_model_spikes_and_delays():
    """The smoke compares something: both populations spike and the delay
    slots span 0..3."""
    res = DS.simulate(0, 40, "cpu")
    assert res["finite"]
    assert all(sum(v) > 0 for v in res["counts"].values())
    slots = np.asarray(res["delay_slots"])
    assert slots.min() == 0 and slots.max() == 3
