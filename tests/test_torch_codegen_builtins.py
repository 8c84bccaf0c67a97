"""Codegen'd snippets run with empty builtins.  The first comparison of a
tensor with a Python number in a process makes torch import a module
through the calling frame's builtins, which failed there (KeyError:
'__import__') until ``repro_torch.core.codegen`` made that import itself.
Each case runs in a fresh interpreter, where the lazy import has not
happened yet."""

import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

SNIPPET = """
import torch
from repro_torch.core import codegen as C
model = C.NeuronModel(name="t", state={{"V": 0.0}}, params={{}},
                      sim_code="V = V + Isyn", threshold_code={thr!r},
                      reset_code="")
upd = C.compile_sim(model)
_, spk = upd({{"V": torch.tensor([[0.0, 1.5, 4.0]])}}, {{}},
             {{"Isyn": torch.zeros(1, 3), "dt": torch.tensor(1.0),
              "t": torch.tensor(0.0)}})
print(spk.tolist())
"""


@pytest.mark.parametrize("thr,want", [
    ("V > 1.0", [[False, True, True]]),
    ("V >= 4.0", [[False, False, True]]),
    ("1.0 < V", [[False, True, True]]),
    ("V == 1.5", [[False, True, False]]),
])
def test_scalar_comparison_in_a_fresh_process(thr, want):
    out = subprocess.run([sys.executable, "-c", SNIPPET.format(thr=thr)],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(want)
