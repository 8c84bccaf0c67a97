"""The sharded engine's multi-rank cases -- not a test module.

Every ``case_*`` runs in each gloo rank of a group (``_torch_dist.py``)
and returns what the engine gave, gathered ("global": the same on every
rank); ``test_torch_engine.py`` holds it to the port's single-device
``Simulator`` (bit for bit) and to the JAX package.  The spec functions take
a dict of the package's modules (``PORT`` here, the JAX package's in the
test), so both packages build the same nets; this module imports no JAX.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.core.models import izhikevich_net as TIZ
from repro_torch.core.snn import neurons as TN
from repro_torch.core.snn import spec as TSPEC
from repro_torch.core.snn import synapses as TSYN
from repro_torch.obs import health as THE
from repro_torch.sparse import formats as TF

PORT = dict(spec=TSPEC, syn=TSYN, formats=TF, neurons=TN, iz=TIZ, he=THE)

T = 40
B = 3


def izh_cfg(P):
    return P["iz"].IzhikevichNetConfig(n_total=120, n_conn=24, seed=3)


def leaves(x, path=""):
    """A state (or any tree of dicts / dataclasses) as {path: tensor}."""
    if x is None:
        return {}
    if isinstance(x, torch.Tensor):
        return {path: x}
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(leaves(v, f"{path}/{k}"))
        return out
    out = {}
    for f in dataclasses.fields(x):
        out.update(leaves(getattr(x, f.name), f"{path}/{f.name}"))
    return out


def stim(n_steps, sizes, batch=None, seed=0, scale=6.0):
    """numpy drive {population: [n_steps, (batch,) n]} float32."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n in sizes.items():
        shape = (n_steps, n) if batch is None else (n_steps, batch, n)
        out[name] = (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def delay_spec(P):
    """tests/test_engine_sharded.py's ring net: heterogeneous per-synapse
    delays and a homogeneous delay, conductance synapses."""
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("ring")
    s.add_neuron_population("a", 48, "izhikevich")
    s.add_neuron_population("b", 23, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=F.FixedFanout(6),
                             weight=F.UniformWeight(0, 0.8),
                             psm=S.ExpDecay(4.0),
                             delay=F.UniformIntDelay(0, 3))
    s.add_synapse_population("bb", "b", "b", connect=F.OneToOne(),
                             weight=0.2, delay_steps=2)
    s.add_synapse_population("ba", "b", "a", connect=F.FixedFanout(5),
                             weight=F.UniformWeight(0, 0.5),
                             psm=S.ExpCond(5.0, 0.0))
    return s


DELAY_SIZES = {"a": 48, "b": 23}


def stdp_spec(P, dense=False):
    """tests/test_engine_sharded.py's plastic net (STDP with a homogeneous
    delay, STDP on a FixedProbability group) with its x_pre probe; with
    ``dense`` a dense one-to-one group too."""
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("plastic")
    s.add_neuron_population("a", 48, "izhikevich")
    s.add_neuron_population("b", 21, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=F.FixedFanout(6),
                             weight=F.UniformWeight(0, 0.8),
                             psm=S.ExpDecay(4.0), wum=S.STDP(0.01),
                             delay_steps=2)
    s.add_synapse_population("aa", "a", "a",
                             connect=F.FixedProbability(0.15),
                             weight=F.UniformWeight(0, 0.4),
                             wum=S.STDP(0.01))
    if dense:
        s.add_synapse_population("bb", "b", "b", connect=F.OneToOne(),
                                 weight=0.3, representation="dense")
    s.probe("tr", "ab", "x_pre", every=5)
    return s


STDP_SIZES = {"a": 48, "b": 21}


def observed_spec(P):
    """Probes of every kind, a scheduled group normalisation ("post"), a
    per-row and a whole-matrix reduction, a population update, on integer
    weights (the reductions' sums exact in any order)."""
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("observed")
    s.add_neuron_population("a", 37, "izhikevich")
    s.add_neuron_population("b", 19, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=F.FixedFanout(5),
                             weight=2.0, psm=S.ExpDecay(4.0))
    s.add_synapse_population("aa", "a", "a", connect=F.FixedFanout(4),
                             weight=1.0)
    s.probe("v", "b", "V", every=3)
    s.probe("v_win", "a", "V", every=2, window=4)
    s.probe("spk", "a", "spikes")
    s.probe("v_mean", "a", "V", reduce="mean")
    s.probe("v_max", "b", "V", reduce="max")
    s.probe("insyn", "ab", "in_syn", every=4)
    s.probe("g_sum", "ab", "g", reduce="sum", every=5)
    s.probe("g_min", "ab", "g", reduce="min", every=5)
    s.add_custom_update(
        "norm", "ab", "g = g * 2.0 / maximum(w_sum, 1.0)",
        reduce={"w_sum": ("sum", "g", "post")}, every=10)
    s.add_custom_update(
        "rowscale", "ab", "g = g + w_row - w_row + w_all - w_all",
        reduce={"w_row": ("max", "g", "pre"), "w_all": ("sum", "g", "all")})
    s.add_custom_update("reset_u", "a", "U = U * 0.5 + v_bar * 0.0",
                        reduce={"v_bar": ("mean", "V")}, every=7)
    return s


OBS_SIZES = {"a": 37, "b": 19}


def monitor(P):
    return P["he"].HealthConfig(bands_hz={"a": (0.5, 200.0)})


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _run_out(res, model):
    return {"counts": res.spike_counts, "raster": res.raster,
            "finite": res.finite, "rates": res.rates_hz,
            "state": leaves(model.engine.gather_state(res.state))}


def case_izh_run(mesh):
    """The cortical net from its config and seed, B = 1, a gScale."""
    m = TIZ.compile_model(izh_cfg(PORT), mesh=mesh)
    res = m.run(T, gscales={"exc": 1.7}, record_raster=True)
    return {"global": _run_out(res, m)}


def case_izh_batch(mesh):
    """B = 3 members of their own keys: the compiled chunks and the eager
    loop, and 45 steps (a chunk and a remainder) resumed after 20."""
    m = TIZ.compile_model(izh_cfg(PORT), mesh=mesh)
    keys = torch.tensor([[0, 1], [0, 7], [3, 5]], dtype=torch.int32)
    st = m.init_state(B, key=keys)
    comp = m.run(45, state=st, record_raster=True)
    eager = m.engine.run(m.init_state(B, key=keys), 45, record_raster=True)
    half = m.run(20, state=m.init_state(B, key=keys))
    rest = m.run(25, state=half.state)
    return {"global": {"compiled": _run_out(comp, m),
                       "eager": _run_out(eager, m),
                       "resumed": _run_out(rest, m)}}


def case_izh_step(mesh):
    """The public step with full-size stim [B, n], four times."""
    m = TIZ.compile_model(izh_cfg(PORT), mesh=mesh)
    st = m.init_state(2)
    drive = stim(4, {"exc": 96}, batch=2, seed=1)
    spikes = []
    for i in range(4):
        st, spk = m.step(st, stim={"exc": drive["exc"][i]})
        spikes.append(spk)
    return {"global": {"spikes": spikes,
                       "state": leaves(m.engine.gather_state(st))}}


def case_izh_sweep(mesh):
    m = TIZ.compile_model(izh_cfg(PORT), mesh=mesh)
    sw = m.sweep_gscale("exc", [0.5, 1.0, 2.0], 25)
    return {"global": {"counts": sw.spike_counts, "finite": sw.finite,
                       "rates": sw.rates_hz}}


def case_izh_device(mesh):
    """init="device" over the mesh: every rank draws its own rows
    (device_init_local)."""
    m = TIZ.compile_model(izh_cfg(PORT), mesh=mesh, init="device")
    res = m.run(30, record_raster=True)
    return {"global": _run_out(res, m)}


def case_delays(mesh):
    m = delay_spec(PORT).build(dt=1.0, seed=0, mesh=mesh)
    drive = stim(T, DELAY_SIZES, batch=2, seed=2)
    res = m.run(T, state=m.init_state(2), record_raster=True, stim=drive)
    return {"global": _run_out(res, m)}


def case_stdp(mesh):
    m = stdp_spec(PORT).build(dt=1.0, seed=5, mesh=mesh)
    drive = stim(T, STDP_SIZES, batch=2, seed=3)
    res = m.run(T, state=m.init_state(2), record_raster=True, stim=drive)
    out = _run_out(res, m)
    out["tr"] = res.recordings["tr"]
    return {"global": out}


def case_stdp_device(mesh):
    """The plastic net built on the device over the mesh (its
    FixedProbability group's rows drawn per rank)."""
    m = stdp_spec(PORT).build(dt=1.0, seed=9, init="device", mesh=mesh)
    drive = stim(30, STDP_SIZES, seed=4)
    res = m.run(30, record_raster=True, stim=drive)
    out = _run_out(res, m)
    out["tr"] = res.recordings["tr"]
    return {"global": out}


def case_dense(mesh):
    m = stdp_spec(PORT, dense=True).build(dt=1.0, seed=5, mesh=mesh)
    drive = stim(T, STDP_SIZES, batch=2, seed=3)
    res = m.run(T, state=m.init_state(2), record_raster=True, stim=drive)
    return {"global": _run_out(res, m)}


def case_observed(mesh):
    """Probes, scheduled custom updates and the monitor, B = 2; then the
    on-demand updates on the final state."""
    m = observed_spec(PORT).build(dt=1.0, seed=4, mesh=mesh,
                                  monitor=monitor(PORT))
    drive = stim(T, OBS_SIZES, batch=2, seed=5)
    res = m.run(T, state=m.init_state(2), stim=drive, record_raster=True)
    out = _run_out(res, m)
    out["rec"] = dict(res.recordings.data)
    out["rec_counts"] = dict(res.recordings.counts)
    out["health"] = leaves(res.health)
    st = m.custom_update("rowscale", res.state)
    st = m.custom_update("norm", st)
    out["updated"] = leaves(m.engine.gather_state(st))
    return {"global": out}


def case_nan_guard(mesh):
    """An over-scaled conductance trips the NaN guard on the ranks that
    hold the blown-up neurons; the flag and the monitor's first bad step
    are merged over the ranks."""
    m = observed_spec(PORT).build(dt=1.0, seed=4, mesh=mesh,
                                  monitor=monitor(PORT))
    drive = stim(20, OBS_SIZES, seed=5, scale=10.0)
    res = m.run(20, gscales={"ab": 1e38}, stim=drive)
    return {"global": {"finite": res.finite,
                       "health": leaves(res.health),
                       "counts": res.spike_counts}}


def case_state_round_trip(mesh):
    """gather_state then shard_state gives back each rank's real lanes,
    and a run resumed from it goes on as the uninterrupted one."""
    m = stdp_spec(PORT).build(dt=1.0, seed=5, mesh=mesh)
    drive = stim(30, STDP_SIZES, batch=2, seed=6)
    first = m.run(15, state=m.init_state(2),
                  stim={k: v[:15] for k, v in drive.items()})
    full = m.engine.gather_state(first.state)
    back = m.engine.shard_state(full)
    rest = m.run(15, state=back, stim={k: v[15:] for k, v in drive.items()})
    whole = m.run(30, state=m.init_state(2), stim=drive)
    return {"global": {"rest": _run_out(rest, m), "whole": _run_out(whole, m),
                       "full": leaves(full),
                       "regathered": leaves(m.engine.gather_state(back))}}


def case_memory_report(mesh):
    m = stdp_spec(PORT, dense=True).build(dt=1.0, seed=5, mesh=mesh)
    bad = None
    try:
        m.engine.run(m.engine.init_state(), 5, gscales={"typo": 1.0})
    except ValueError as e:
        bad = str(e)
    return {"global": {"report": m.engine.memory_report(), "bad": bad,
                       "k_local": dict(m.engine._k_local)}}


def case_snn_scaling_bench(mesh):
    """benchmarks/snn_scaling_torch.py at the JAX script's CI knobs over
    every rank: construction memory and weak scaling at D = 1, 2, 4, ..."""
    import os
    import tempfile

    from benchmarks import snn_scaling_torch as B
    os.environ.update({"SNN_BENCH_PER_DEV": "256", "SNN_BENCH_NCONN": "32",
                       "SNN_BENCH_STEPS": "10"})
    out = B.main(["--device", "cpu", "--devices", str(mesh.world_size),
                  "--out", tempfile.mkdtemp()])
    keep = ("devices", "construction_memory", "weak_scaling")
    return {"local": {k: out[k] for k in keep}}
