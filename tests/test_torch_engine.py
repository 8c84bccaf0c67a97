"""The port's sharded SNN engine at 1, 2 and 8 gloo ranks on the CPU.

One group of ranks a world size runs every case of
``_torch_engine_cases.py`` (``_torch_dist.py``: a worker process a rank,
a ``file://`` store, a wall-clock limit); each test here reads one case's
gathered results, which every rank must have computed alike.  The engine
is held to:

- the port's single-device ``Simulator`` on the same spec and seed, bit
  for bit: counts, rasters, rates, the NaN guard's flag, every state tensor
  (``gather_state``), probes, health, custom updates, at B = 1 and B > 1,
  host- and device-built, with delays, STDP and a dense group; sums a
  reduction combines over ranks (a matrix probe's, an "all" reduction's)
  within the contract's 1e-5;
- the JAX package's single-device run of the same spec and seed under
  ROADMAP's parity contract: rasters agree on >= 99.8% of neuron-steps,
  state probes within 2e-4 on >= 99.8% of entries (the contract's
  threshold allowance: XLA and PyTorch round the Izhikevich update
  differently);
- the JAX engine's ``memory_report`` at the same device count (the JAX
  side in one subprocess at 8 forced host devices).
"""

import functools
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_engine_cases as C  # noqa: E402
from _torch_dist import _equal, run_ranks  # noqa: E402
from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro.core.snn import neurons as JN  # noqa: E402
from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.core.snn import synapses as JSYN  # noqa: E402
from repro.obs import health as JHE  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402

JAXPKG = dict(spec=JSPEC, syn=JSYN, formats=JF, neurons=JN, iz=JIZ, he=JHE)
PORT = C.PORT
CASES = Path(C.__file__).resolve()
SRC = str(Path(__file__).resolve().parents[1] / "src")
AGREEMENT = 0.998
STATE_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", params=[1, 2, 8], ids=lambda d: f"D{d}")
def ranks(request, tmp_path_factory):
    return run_ranks(CASES, request.param,
                     tmp_path_factory.mktemp(f"engine_D{request.param}"))


def _bits(got, want, where=""):
    """Bit-equality of two result trees (the engine's, the Simulator's)."""
    _equal(got, want, where)


def _sim_out(res):
    return {"counts": res.spike_counts, "raster": res.raster,
            "finite": res.finite, "rates": res.rates_hz,
            "state": C.leaves(res.state)}


# ---------------------------------------------------------------------------
# the single-device references (the port's Simulator), once a module
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sim(case: str):
    cpu = dict(device="cpu")
    if case == "izh_run":
        m = TIZ.compile_model(C.izh_cfg(PORT), **cpu)
        return _sim_out(m.run(C.T, gscales={"exc": 1.7},
                              record_raster=True))
    if case == "izh_batch":
        m = TIZ.compile_model(C.izh_cfg(PORT), **cpu)
        keys = torch.tensor([[0, 1], [0, 7], [3, 5]], dtype=torch.int32)
        whole = m.simulator.run(m.init_state(C.B, key=keys), 45,
                                record_raster=True)
        half = m.simulator.run(m.init_state(C.B, key=keys), 20)
        rest = m.simulator.run(half.state, 25)
        return {"whole": _sim_out(whole), "rest": _sim_out(rest)}
    if case == "izh_step":
        m = TIZ.compile_model(C.izh_cfg(PORT), **cpu)
        st = m.init_state(2)
        drive = C.stim(4, {"exc": 96}, batch=2, seed=1)
        spikes = []
        for i in range(4):
            st, spk = m.step(st, stim={"exc": drive["exc"][i]})
            spikes.append(spk)
        return {"spikes": spikes, "state": C.leaves(st)}
    if case == "izh_sweep":
        m = TIZ.compile_model(C.izh_cfg(PORT), **cpu)
        sw = m.sweep_gscale("exc", [0.5, 1.0, 2.0], 25)
        return {"counts": sw.spike_counts, "finite": sw.finite,
                "rates": sw.rates_hz}
    if case == "izh_device":
        m = TIZ.compile_model(C.izh_cfg(PORT), init="device", **cpu)
        return _sim_out(m.run(30, record_raster=True))
    if case == "delays":
        m = C.delay_spec(PORT).build(dt=1.0, seed=0, **cpu)
        return _sim_out(m.run(C.T, state=m.init_state(2), record_raster=True,
                              stim=C.stim(C.T, C.DELAY_SIZES, batch=2,
                                          seed=2)))
    if case in ("stdp", "dense"):
        m = C.stdp_spec(PORT, dense=case == "dense").build(dt=1.0, seed=5,
                                                           **cpu)
        res = m.run(C.T, state=m.init_state(2), record_raster=True,
                    stim=C.stim(C.T, C.STDP_SIZES, batch=2, seed=3))
        out = _sim_out(res)
        if case == "stdp":
            out["tr"] = res.recordings["tr"]
        return out
    if case == "stdp_device":
        m = C.stdp_spec(PORT).build(dt=1.0, seed=9, init="device", **cpu)
        res = m.run(30, record_raster=True,
                    stim=C.stim(30, C.STDP_SIZES, seed=4))
        out = _sim_out(res)
        out["tr"] = res.recordings["tr"]
        return out
    if case == "observed":
        m = C.observed_spec(PORT).build(dt=1.0, seed=4, monitor=C.monitor(
            PORT), **cpu)
        res = m.run(C.T, state=m.init_state(2), record_raster=True,
                    stim=C.stim(C.T, C.OBS_SIZES, batch=2, seed=5))
        out = _sim_out(res)
        out["rec"] = dict(res.recordings.data)
        out["rec_counts"] = dict(res.recordings.counts)
        out["health"] = C.leaves(res.health)
        st = m.custom_update("rowscale", res.state)
        st = m.custom_update("norm", st)
        out["updated"] = C.leaves(st)
        return out
    if case == "nan_guard":
        m = C.observed_spec(PORT).build(dt=1.0, seed=4, monitor=C.monitor(
            PORT), **cpu)
        res = m.run(20, gscales={"ab": 1e38},
                    stim=C.stim(20, C.OBS_SIZES, seed=5, scale=10.0))
        return {"finite": res.finite, "health": C.leaves(res.health),
                "counts": res.spike_counts}
    if case == "state_round_trip":
        m = C.stdp_spec(PORT).build(dt=1.0, seed=5, **cpu)
        drive = C.stim(30, C.STDP_SIZES, batch=2, seed=6)
        first = m.run(15, state=m.init_state(2),
                      stim={k: v[:15] for k, v in drive.items()})
        return {"first": C.leaves(first.state),
                "whole": _sim_out(m.run(30, state=m.init_state(2),
                                        stim=drive))}
    raise KeyError(case)


# ---------------------------------------------------------------------------
# the JAX package's single-device runs, once a module
# ---------------------------------------------------------------------------

def _jax_probed(spec):
    for name in spec.populations:
        spec.probe(f"spk_{name}", name, "spikes")
    return spec


@functools.lru_cache(maxsize=None)
def _jax_run(case: str, member: int = 0):
    """{population: raster [T, n]} (and the run's result) of the JAX
    package's run of a case's spec and seed (member ``member``'s stim)."""
    if case in ("izh_run", "izh_device"):
        s = _jax_probed(JIZ.spec(C.izh_cfg(JAXPKG)))
        init = "device" if case == "izh_device" else "host"
        m = s.build(dt=1.0, seed=C.izh_cfg(JAXPKG).seed, init=init)
        res = (m.run(C.T, gscales={"exc": 1.7}) if case == "izh_run"
               else m.run(30))
    else:
        make, seed, sizes, n, drive_seed = {
            "delays": (C.delay_spec, 0, C.DELAY_SIZES, C.T, 2),
            "stdp": (C.stdp_spec, 5, C.STDP_SIZES, C.T, 3),
            "observed": (C.observed_spec, 4, C.OBS_SIZES, C.T, 5),
        }[case]
        kw = {}
        if case == "observed":
            kw["monitor"] = C.monitor(JAXPKG)
        m = _jax_probed(make(JAXPKG)).build(dt=1.0, seed=seed, **kw)
        drive = C.stim(n, sizes, batch=2, seed=drive_seed)
        res = m.run(n, stim={k: v[:, member] for k, v in drive.items()})
    rasters = {name[4:]: np.asarray(v) for name, v in
               res.recordings.data.items() if name.startswith("spk_")}
    return rasters, res


def _assert_rasters_agree(engine_raster, case, member=None):
    rasters, _ = _jax_run(case, 0 if member is None else member)
    n_spikes = 0
    for pop, want in rasters.items():
        got = engine_raster[pop].numpy()
        if member is not None:
            got = got[:, member]
        assert got.shape == want.shape, pop
        assert (got == want).mean() >= AGREEMENT, (case, pop)
        n_spikes += int(want.sum())
    assert n_spikes > 0


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_run_equals_simulator(ranks):
    got = ranks.case("izh_run")["global"]
    _bits(got, _sim("izh_run"))
    assert bool(got["finite"]) and int(got["counts"]["exc"].sum()) > 0


def test_run_meets_jax(ranks):
    _assert_rasters_agree(ranks.case("izh_run")["global"]["raster"],
                          "izh_run")


def test_batch_compiled_eager_and_resumed_equal_simulator(ranks):
    got = ranks.case("izh_batch")["global"]
    want = _sim("izh_batch")
    _bits(got["compiled"], want["whole"], "compiled")
    _bits(got["eager"], want["whole"], "eager")
    _bits(got["resumed"], want["rest"], "resumed")
    # the members drew from their own keys
    r = got["compiled"]["raster"]["exc"]
    assert not torch.equal(r[:, 0], r[:, 1])


def test_public_step_equals_simulator(ranks):
    _bits(ranks.case("izh_step")["global"], _sim("izh_step"))


def test_sweep_equals_simulator_and_meets_jax(ranks):
    got = ranks.case("izh_sweep")["global"]
    _bits(got, _sim("izh_sweep"))
    jm = JIZ.compile_model(C.izh_cfg(JAXPKG))
    js = jm.sweep_gscale("exc", [0.5, 1.0, 2.0], 25)
    np.testing.assert_array_equal(got["finite"].numpy(),
                                  np.asarray(js.finite))
    for pop in ("exc", "inh"):
        np.testing.assert_allclose(got["rates"][pop].numpy(),
                                   np.asarray(js.rates_hz[pop]),
                                   atol=(1.0 - AGREEMENT) * 1e3)


def test_device_built_equals_simulator_and_meets_jax(ranks):
    got = ranks.case("izh_device")["global"]
    _bits(got, _sim("izh_device"))
    _jax = _jax_run("izh_device")[0]
    for pop, want in _jax.items():
        assert (got["raster"][pop].numpy() == want).mean() >= AGREEMENT


def test_delays_equal_simulator_and_meet_jax(ranks):
    got = ranks.case("delays")["global"]
    _bits(got, _sim("delays"))
    for b in range(2):
        _assert_rasters_agree(got["raster"], "delays", member=b)


def test_stdp_equals_simulator_and_meets_jax(ranks):
    got = ranks.case("stdp")["global"]
    _bits(got, _sim("stdp"))
    for b in range(2):
        _assert_rasters_agree(got["raster"], "stdp", member=b)
        jtr = np.asarray(_jax_run("stdp", b)[1].recordings["tr"])
        close = np.isclose(got["tr"][b].numpy(), jtr, **STATE_TOL)
        assert close.mean() >= AGREEMENT


def test_stdp_device_built_equals_simulator(ranks):
    _bits(ranks.case("stdp_device")["global"], _sim("stdp_device"))


def test_dense_group_equals_simulator(ranks):
    got = ranks.case("dense")["global"]
    _bits(got, _sim("dense"))
    assert int(got["counts"]["b"].sum()) > 0


def test_observed_equals_simulator(ranks):
    got = dict(ranks.case("observed")["global"])
    want = dict(_sim("observed"))
    # a matrix probe's sum adds the ranks' partial sums: the contract's 1e-5
    for name in ("rec",):
        gs, ws = dict(got.pop(name)), dict(want.pop(name))
        np.testing.assert_allclose(gs.pop("g_sum").numpy(),
                                   ws.pop("g_sum").numpy(), rtol=1e-5,
                                   atol=1e-5)
        _bits(gs, ws, name)
    # the "all" sum of the on-demand update, likewise
    gu, wu = got.pop("updated"), want.pop("updated")
    assert set(gu) == set(wu)
    for k in gu:
        if gu[k].dtype.is_floating_point:
            np.testing.assert_allclose(gu[k].numpy(), wu[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            _bits(gu[k], wu[k], k)
    _bits(got, want)
    assert int(got["health"]["/spike_total/a"].sum()) > 0


def test_observed_meets_jax(ranks):
    got = ranks.case("observed")["global"]
    for b in range(2):
        _assert_rasters_agree(got["raster"], "observed", member=b)
        jres = _jax_run("observed", b)[1]
        # unreduced state probes (a max over neurons picks the one on a
        # spike's upstroke, where the packages' rounding drifts most; the
        # reductions are held to the Simulator's bit for bit above)
        for name in ("v", "v_win", "insyn"):
            close = np.isclose(got["rec"][name][b].numpy(),
                               np.asarray(jres.recordings[name]),
                               **STATE_TOL)
            assert close.mean() >= AGREEMENT, name
        spk = got["rec"]["spk"][b].numpy()
        assert (spk == np.asarray(jres.recordings["spk"])).mean() \
            >= AGREEMENT
        for name in ("g_sum", "g_min"):
            np.testing.assert_allclose(got["rec"][name][b].numpy(),
                                       np.asarray(jres.recordings[name]),
                                       rtol=1e-5, atol=1e-5)
        for k, v in got["rec_counts"].items():
            assert int(v[b]) == int(jres.recordings.counts[k]), k
        jh = jres.health
        assert int(got["health"]["/steps"][b]) == int(jh.steps)
        assert bool(got["health"]["/nonfinite"][b]) == bool(jh.nonfinite)


def test_nan_guard_merged_over_ranks(ranks):
    got = ranks.case("nan_guard")["global"]
    _bits(got, _sim("nan_guard"))
    assert not bool(got["finite"])
    assert int(got["health"]["/first_bad_step"]) >= 0


def test_state_round_trip_and_resume(ranks):
    got = ranks.case("state_round_trip")["global"]
    want = _sim("state_round_trip")
    _bits(got["full"], want["first"], "gathered")
    _bits(got["rest"]["state"], got["whole"]["state"],
          "resumed vs uninterrupted")
    _bits(got["whole"], want["whole"], "uninterrupted vs simulator")
    # sharding the gathered state gives back every rank's real lanes
    _bits(got["regathered"], got["full"], "sharded and gathered again")


_JAX_MEMORY = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.core.snn import neurons as JN, spec as JSPEC
    from repro.core.snn import synapses as JSYN
    from repro.obs import health as JHE
    from repro.sparse import formats as JF
    import _torch_engine_cases as C
    P = dict(spec=JSPEC, syn=JSYN, formats=JF, neurons=JN, he=JHE)
    out = {{}}
    for d in (1, 2, 8):
        mesh = Mesh(np.array(jax.devices()[:d]), ("neuron",))
        eng = C.stdp_spec(P, dense=True).build(dt=1.0, seed=5,
                                               mesh=mesh).engine
        out[d] = eng.memory_report()
    print(json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def _jax_memory_reports():
    code = _JAX_MEMORY.format(src=SRC, tests=str(CASES.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {int(k): v for k, v in
            json.loads(out.stdout.strip().splitlines()[-1]).items()}


def test_memory_report_equals_jax(ranks):
    got = ranks.case("memory_report")["global"]
    assert got["bad"] is not None and "unknown gscale" in got["bad"]
    want = _jax_memory_reports()[ranks.world]
    assert [r["name"] for r in got["report"]] == [r["name"] for r in want]
    for g, w in zip(got["report"], want):
        for k, v in w.items():
            assert g[k] == v, (g["name"], k, g[k], v)
        assert g["n_shards"] == ranks.world


def test_snn_scaling_bench_rows(ranks):
    """benchmarks/snn_scaling_torch.py over D ranks: rank 0 holds every
    row of D = 1, 2, 4, ... (the fused construction's bytes a device fall
    as D doubles, generate-then-partition's do not; k_local the partition
    of the graph's), and a weak-scaling row a D."""
    from repro_torch import random as R
    from repro_torch.sparse import device_init as DI
    from repro_torch.sparse import formats as TF
    got = ranks.local("snn_scaling_bench")[0]["local"]
    D = ranks.world
    series = [d for d in (1, 2, 4, 8) if d <= D]
    assert got["devices"] == D
    assert [r["devices"] for r in got["weak_scaling"]] == series
    assert all(r["us_per_step"] > 0 for r in got["weak_scaling"])
    mem = got["construction_memory"]
    assert [(r["path"], r["devices"]) for r in mem] == [
        (p, d) for d in series for p in ("fused_local", "generate_partition")]
    n = 256 * D
    post, g, valid = DI.device_resolve(TF.FixedFanout(32), R.PRNGKey(0), n,
                                       n, TF.UniformWeight(0, 0.5))
    ell = TF.ELLSynapses(g=g, post_ind=post, valid=valid, n_post=n)
    for r in mem:
        assert r["k_local"] == DI.partition_ell_by_post(ell,
                                                        r["devices"])[5]
        want = DI.construction_peak_model(n, 32, r["devices"], r["k_local"])
        key = ("fused_local_bytes" if r["path"] == "fused_local"
               else "generate_partition_bytes")
        assert r["peak_bytes_per_device"] == want[key]
    fused = [r["peak_bytes_per_device"] for r in mem
             if r["path"] == "fused_local"]
    assert all(b < a for a, b in zip(fused, fused[1:]))
