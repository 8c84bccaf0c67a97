"""repro_torch stands alone: no module of the port, no part of
chip_smoke.py, no example and no benchmark script of the port imports jax
or the JAX package; importing the port leaves jax
unloaded; tensors on the CPU take the plain versions without counting a
launch (ELL and neuron kernels alike); an entry point that needs a card
raises when there is none."""

import ast
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.models import mushroom_body as TMB  # noqa: E402
from repro_torch.kernels import ell_spmv as K  # noqa: E402
from repro_torch.kernels import hh_step as HH  # noqa: E402
from repro_torch.kernels import izhikevich_step as IZ  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py")) \
    + sorted((ROOT / "benchmarks").glob("*_torch.py"))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_covers_the_checkpoint_package():
    port = ROOT / "src" / "repro_torch"
    assert {port / "checkpoint" / "__init__.py",
            port / "checkpoint" / "manager.py"} <= set(PORT_FILES)


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cpu_tensors_take_the_plain_path_without_counting():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.random((8, 3)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, 5, (8, 3)), dtype=torch.int32)
    valid = torch.ones(8, 3, dtype=torch.bool)
    dly = torch.zeros(8, 3, dtype=torch.int32)
    spk = torch.ones(2, 8)
    K.reset_launches()
    IZ.reset_launches()
    HH.reset_launches()
    K.ell_spmv(g, idx, valid, spk, 5)
    K.ell_spmv_delay(g, idx, valid, dly, spk, 5, 2)
    TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=50, n_conn=5),
                      device="cpu").run(3)
    TMB.compile_model(TMB.MushroomBodyConfig(n_pn=4, n_lhi=2, n_kc=10,
                                             n_dn=2), device="cpu").run(3)
    assert K.launches == {"ell_spmv": 0, "ell_spmv_delay": 0}
    assert IZ.launches == {"izhikevich_step": 0, "izhikevich_step.drive": 0}
    assert HH.launches == {"hh_step": 0}


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TIZ.IzhikevichNetConfig(n_total=50, n_conn=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        TIZ.compile_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TIZ.spec(cfg).build(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TMB.compile_model(TMB.MushroomBodyConfig(n_kc=10))


def test_chip_smoke_refuses_without_the_repo_or_a_card(tmp_path):
    """Alone in a directory (and, here, without a card) the smoke script
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cpu_server_launches_no_kernel():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import Request, Server
    srv = Server("qwen2-0.5b", max_batch=2, max_seq=32, device="cpu")
    for i in range(3):
        srv.submit(Request(rid=i, prompt=[5 + i, 7, 9], max_new=3))
    FA.reset_launches()
    K.reset_launches()
    IZ.reset_launches()
    HH.reset_launches()
    done = srv.run()
    assert sorted(len(r.out) for r in done) == [3, 3, 3]
    assert FA.launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert not any({**K.launches, **IZ.launches, **HH.launches}.values())


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import load_lm_params
    from repro_torch.launch.serve import Server
    from repro_torch.models.model import build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Server("qwen2-0.5b", device="cuda")
    model = build(reduced(get_config("qwen2-0.5b")))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_caches(1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_lm_params(model.cfg, {"embed": np.zeros((4, 2), np.float32)})
    params = model.init(device="cpu")           # the CPU on request
    logits, caches = model.prefill(params, torch.tensor([[3, 4, 5]]))
    assert logits.shape == (1, 512) and caches["index"] == 3
