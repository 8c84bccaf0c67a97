"""The port's examples (``examples/*_torch.py``) run on the CPU at a
reduced length (``--device cpu --steps N``) and print what the JAX
examples print: the generated code, the representation choice, the
probes' recordings, the sweep table with the NaN guard, and the KC->DN
normalisation reaching its target."""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu", *args], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_quickstart_torch_runs_on_the_cpu():
    out = _run("quickstart_torch.py", "--steps", "100")
    assert "def update_izhi(state, params, externals):" in out
    assert "probe exc_raster:" in out and "packed spike words" in out
    assert "exc mean V over the last 5 samples" in out
    table = out.split("gscale | exc Hz | finite")[1].strip().splitlines()
    assert len(table) == 8 and all(ln.endswith("True") for ln in table)


def test_mushroom_body_torch_runs_on_the_cpu():
    out = _run("mushroom_body_torch.py", "--steps", "300")
    assert "KC_DN: sparse" in out           # normalisation makes g state
    rows = out.split("finite (NaN guard)")[1].strip().splitlines()[:5]
    finite = [r.rsplit("|", 1)[1].strip() for r in rows]
    assert finite[:2] == ["True", "True"] and finite[-1] == "False"
    assert "12 samples x 150 KCs per candidate" in out
    after = out.split("after: ")[1].split(" uS")[0]
    lo, hi = (float(x) for x in after.split(".."))
    assert abs(lo - 1.5) < 1e-3 and abs(hi - 1.5) < 1e-3
