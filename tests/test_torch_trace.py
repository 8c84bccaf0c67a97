"""``repro_torch.obs.trace`` and ``repro_torch.obs.profile`` against the JAX
package's ``repro.obs``: the same event schema, exports that both
packages' validators accept, and a CPU build and run of one small spec
emitting the JAX package's span and instant names (``build``,
``validate``, ``host_init``, ``codegen``, ``run``, ``choose_block_spmv``,
``choose_propagation``)."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.obs import profile as JPROF  # noqa: E402
from repro.obs import trace as JTR  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.obs import profile as TPROF  # noqa: E402
from repro_torch.obs import trace as TTR  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402


def _record(mod):
    c = mod.TraceCollector()
    with c.span("outer", group="g", rows=4):
        c.instant("mark", bp=8, ok=True)
    return c.events()


def test_collectors_emit_the_same_event_keys():
    port, ref = _record(TTR), _record(JTR)
    assert [e["name"] for e in port] == [e["name"] for e in ref]
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        assert set(p["args"]) == set(r["args"])
        assert p["ph"] == r["ph"]


def test_both_validators_accept_the_ports_export(tmp_path):
    c = TTR.TraceCollector()
    with c.span("build", model="m", n=torch.tensor(3)):
        c.instant("choose_block_spmv", occupancy=torch.tensor(0.5),
                  grid=(625, 1, 1))
    path = tmp_path / "t.json"
    assert c.export(str(path)) == 2
    doc = json.loads(path.read_text())
    assert TTR.validate_chrome_trace(doc) is None
    assert JTR.validate_chrome_trace(doc) is None
    args = {e["name"]: e["args"] for e in doc["traceEvents"]}
    # 0-d tensors on the CPU are their values
    assert args["build"]["n"] == 3 and args["choose_block_spmv"][
        "occupancy"] == 0.5
    assert TTR.validate_chrome_trace({"traceEvents": [{"name": "x"}]})


def test_a_span_adds_what_its_block_learns_and_disabled_records_nothing():
    c = TTR.TraceCollector()
    with c.span("run", n_steps=5) as args:
        args["compile"] = True
    assert c.events()[0]["args"] == {"n_steps": 5, "compile": True}
    c.enabled = False
    with c.span("run") as args:
        args["compile"] = False
    c.instant("x")
    assert len(c.events()) == 1


def test_phase_timer_and_export_cli(tmp_path, capsys):
    c = TTR.TraceCollector()
    t = TPROF.PhaseTimer(c)
    with t.phase("load", n=1):
        pass
    assert [n for n, _ in t.phases] == ["load"] and "total" in t.render()
    assert c.events()[0]["name"] == "load"
    assert TPROF.export_trace_cli("", "x", c) == 0
    assert TPROF.export_trace_cli(str(tmp_path / "a.json"), "x", c) == 0
    assert TPROF.export_trace_cli(str(tmp_path / "no" / "a.json"), "x",
                                  c) == 1
    assert "cannot write trace file" in capsys.readouterr().err
    # the JAX package's CLI tail, for comparison, behaves the same
    assert JPROF.export_trace_cli(str(tmp_path / "no" / "b.json"), "x") == 1


def test_torch_profiler_trace_raises_instead_of_skipping(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ran = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        with TPROF.torch_profiler_trace(str(tmp_path)):
            ran.append(True)
    assert not ran and not (tmp_path / "trace.json").exists()


def _spec(S, F):
    s = S.ModelSpec("traced")
    s.add_neuron_population("a", 64, "izhikevich")
    s.add_neuron_population("b", 32, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=F.FixedFanout(8),
                             weight=0.5)
    s.add_synapse_population("ba", "b", "a", connect=F.FixedFanout(4),
                             weight=0.5, representation="sparse")
    return s


def _names(mod, build):
    mod.clear()
    build()
    return [e["name"] for e in mod.events()]


def test_cpu_build_and_run_emit_the_jax_packages_names():
    def port():
        m = _spec(TSPEC, TF).build(dt=1.0, seed=3, device="cpu")
        m.run(5)
        m.sweep_gscale("ab", [0.5, 1.0], 5)

    def ref():
        m = _spec(JSPEC, JF).build(dt=1.0, seed=3)
        m.run(5)

    got, want = _names(TTR, port), _names(JTR, ref)
    need = {"build", "validate", "host_init", "codegen", "run",
            "choose_block_spmv", "choose_propagation"}
    assert need <= set(got) and need <= set(want)
    assert set(want) <= set(got)
    assert got.count("host_init") == want.count("host_init") == 2
    assert got.count("choose_block_spmv") >= want.count("choose_block_spmv")
    runs = [e for e in TTR.events() if e["name"] == "run"]
    assert [r["args"]["batch"] for r in runs] == [1, 2]
    assert all({"n_steps", "compile", "model", "sharded"} <= set(r["args"])
               for r in runs)
    builds = [e for e in TTR.events() if e["name"] == "build"]
    assert builds[0]["args"] == {"model": "traced", "init": "host",
                                 "sharded": False}
    assert TTR.validate_chrome_trace(TTR.chrome_trace()) is None
    assert JTR.validate_chrome_trace(TTR.chrome_trace()) is None


def test_build_audit_plans_a_delayed_group_over_its_ring():
    """The build's choose_block_spmv audit (JAX's, at B = 1) plans a group
    with per-synapse delays as the delay scatter that runs it."""
    s = _spec(TSPEC, TF)
    s.add_synapse_population("aa", "a", "a", connect=TF.FixedFanout(6),
                             weight=0.5, delay=TF.UniformIntDelay(0, 5))
    TTR.clear()
    m = s.build(dt=1.0, seed=3, device="cpu")
    audit = {e["args"]["tag"].split(":")[0]: e["args"]
             for e in TTR.events() if e["name"] == "choose_block_spmv"
             and not e["args"]["tag"].endswith((":dense", ":event"))}
    slots = {g.name: g.ring_slots for g in m.network.synapses}
    assert audit["aa"]["n_slots"] == slots["aa"] > 1
    assert audit["ab"]["n_slots"] is None and audit["ab"]["b"] == 1
