"""The port exports what the JAX package exports: for every module of
``repro`` that declares ``__all__``, its ``repro_torch`` counterpart exists
and its ``__all__`` holds the JAX names, less a named allowlist.

The allowlist has two parts: names (and modules) left out by design, each
with its reason, and names waiting for a numbered ROADMAP item.  An entry
that the port does export after all fails the test too, so that the list
stays true."""

import importlib
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src" / "repro"

# module (relative to the package) -> {name: reason}; "*" is the module
BY_DESIGN = {
    "kernels.autotune": {
        "TPULimits": "TPU constants: the port models the H100 (H100Limits)",
        "V5E": "TPU constants: the port models the H100 (H100)",
        "choose_block_matmul": "the TPU's MXU tiling; no counterpart on "
                               "the card",
        "spmv_block_bytes": "the TPU's VMEM model of a Pallas tile"},
    "kernels.ell_spmv": {
        "default_blocks": "Pallas tile sizes; the CUDA kernels plan their "
                          "own launches (launch_plan)",
        "ell_spmv_pallas": "a Pallas entry point; the port's is ell_spmv",
        "ell_spmv_delay_pallas": "a Pallas entry point; the port's is "
                                 "ell_spmv_delay"},
    "kernels.flash_attention": {
        "default_blocks": "Pallas tile sizes; the port's launch_plan",
        "flash_attention_pallas": "a Pallas entry point; the port's is "
                                  "flash_attention"},
    "kernels.hh_step": {"hh_step_pallas": "a Pallas entry point; the "
                                          "port's is hh_step"},
    "kernels.izhikevich_step": {
        "izhikevich_step_pallas": "a Pallas entry point; the port's is "
                                  "izhikevich_step"},
    "kernels.ssd_scan": {"ssd_scan_pallas": "a Pallas entry point; the "
                                            "port's is ssd_scan"},
    "kernels.ops": {
        "backend": "no backend switch: dispatch follows the tensor's device",
        "use_pallas": "no backend switch: dispatch follows the tensor's "
                      "device"},
    "obs.profile": {"jax_profiler_trace": "JAX's profiler; the port has "
                                          "torch_profiler_trace"},
    "kernels.flash_xla": {"*": "XLA's custom VJP; the port's backward "
                               "lives in kernels/flash_attention.py"},
    "flags": {"*": "REPRO_USE_PALLAS: no backend switch in the port"},
}
# module -> {name: its item of ROADMAP's rule-3 queue (the JAX package's
# public functions that the port still lacks, in the queue's order)}
WAITING = {
    "sparse.formats": {
        name: "rule-3 queue, item 1: CSR, the paper's own sparse format"
        for name in ("CSRSynapses", "csr_to_dense", "dense_to_csr",
                     "dense_to_ell")},
    "sparse.ops": {
        "accumulate_csr": "rule-3 queue, item 2",
        "accumulate_ell_compacted": "rule-3 queue, item 2 (its top-k "
                                    "overflow drops the smallest indices)",
        "accumulate_auto": "rule-3 queue, item 2"},
    "core.snn.synapses": {"make_group": "rule-3 queue, item 3"},
    "core.models.izhikevich_net": {"build": "rule-3 queue, item 3"},
}


def _modules():
    """Every module of the JAX package whose source declares __all__."""
    out = []
    for path in sorted(SRC.rglob("*.py")):
        if "__all__" not in path.read_text():
            continue
        rel = path.relative_to(SRC).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        out.append(".".join(parts))
    return out


def test_the_allowlists_name_modules_of_the_jax_package():
    for mod in {**BY_DESIGN, **WAITING}:
        assert (SRC / (mod.replace(".", "/") + ".py")).exists(), mod


@pytest.mark.parametrize("mod", _modules())
def test_port_exports_the_jax_names(mod):
    jm = importlib.import_module(f"repro.{mod}" if mod else "repro")
    allowed = {**BY_DESIGN.get(mod, {}), **WAITING.get(mod, {})}
    try:
        tm = importlib.import_module(f"repro_torch.{mod}" if mod
                                     else "repro_torch")
    except ModuleNotFoundError:
        assert "*" in allowed, f"repro_torch.{mod} is missing"
        return
    assert "*" not in allowed, f"repro_torch.{mod} exists: drop its entry"
    want = set(getattr(jm, "__all__", ()))
    have = set(getattr(tm, "__all__", ()))
    missing = want - have
    assert missing <= set(allowed), \
        f"repro_torch.{mod} lacks {sorted(missing - set(allowed))}"
    assert not (set(allowed) & have), \
        f"repro_torch.{mod} exports {sorted(set(allowed) & have)}: drop " \
        "their entries"
    for name in want - set(allowed):
        assert hasattr(tm, name), f"repro_torch.{mod}.{name}"
