"""The port's examples (``examples/*_torch.py``) run on the CPU at a
reduced length (``--device cpu --steps N``) and print what the JAX
examples print: the generated code, the representation choice, the
probes' recordings, the sweep table with the NaN guard, the KC->DN
normalisation reaching its target; the LM examples serve and train a
dense, an MoE and an SSM or hybrid arch."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script: str, *args: str) -> str:
    # one intra-op thread: the suite runs one worker a core
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
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


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m",
                                  "zamba2-7b"])
def test_serve_lm_torch_runs_on_the_cpu(arch):
    out = _run("serve_lm_torch.py", "--arch", arch, "--requests", "4",
               "--max-new", "5")
    family = {"qwen2-0.5b": "dense", "granite-moe-1b-a400m": "moe",
              "zamba2-7b": "hybrid"}[arch]
    assert f"arch={arch} ({family}) on cpu: 4 requests, 20 tokens" in out
    reqs = [ln for ln in out.splitlines() if ln.strip().startswith("req")]
    assert len(reqs) == 4
    assert all(len(ln.split("-> ")[1].strip("[]").split(",")) == 5
               for ln in reqs)


@pytest.mark.parametrize("args", [
    ("--steps", "10", "--batch", "2", "--seq", "64"),
    ("--arch", "mixtral-8x22b", "--steps", "10", "--batch", "2", "--seq",
     "32"),
    ("--arch", "mamba2-2.7b", "--steps", "10", "--batch", "2", "--seq",
     "32")], ids=["dense_example", "moe", "ssm"])
def test_train_lm_torch_runs_on_the_cpu(args):
    out = _run("train_lm_torch.py", *args)
    step = [ln for ln in out.splitlines() if "[train] step    10" in ln]
    assert len(step) == 1 and "(ce " in step[0]
    aux = float(step[0].split("aux ")[1].split(")")[0])
    assert (aux > 0) == ("mixtral-8x22b" in args)
    first, last = (float(x) for x in out.split("mean loss ")[1]
                   .split(" -> last-10 mean "))
    assert np.isfinite(first) and np.isfinite(last)
