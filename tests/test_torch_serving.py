"""SNN serving in the port (``repro_torch.launch.snn_serve`` over
``CompiledModel.serve_chunk``) on the CPU, against the JAX package:
tests/test_serving.py's single-device cases (exact streams, delays and
STDP, idle slots as exact no-ops, ``pop_finished``, validation, the
``serve`` handle), and the fold of the dendritic ring with a cursor a
member against the JAX package's ring update.

Contract: a served stream equals the port's offline ``CompiledModel.run``
from ``init_state(key=PRNGKey(seed))`` with the same stimulus bit for bit
(spike counts, rasters, every probe's recordings), and equals the JAX
package's served stream on the same spec, seed and numpy stimulus: spike
counts and rasters bit for bit, state recordings within the parity
contract's rtol=atol=2e-4 on >= 99.8% of entries, health totals exact.
An idle slot leaves every state tensor bit-identical.  The nets driven by
numpy stimulus (no random input function) are the ones held to the JAX
package; the Izhikevich net's thalamic normals agree within a few ulp
between the packages, so it is held to the port's own offline run.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.core.snn import synapses as JSYN  # noqa: E402
from repro.launch import snn_serve as JSRV  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn import synapses as TSYN  # noqa: E402
from repro_torch.core.snn.errors import SpecError  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.launch import snn_serve as TSRV  # noqa: E402
from repro_torch.obs.health import HealthConfig as THC  # noqa: E402
from repro.obs.health import HealthConfig as JHC  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

JAXPKG = dict(spec=JSPEC, syn=JSYN, formats=JF, serve=JSRV, health=JHC)
PORT = dict(spec=TSPEC, syn=TSYN, formats=TF, serve=TSRV, health=THC)
STATE_TOL = dict(rtol=2e-4, atol=2e-4)
AGREEMENT = 0.998
N_A, N_B = 30, 14


def _net(P, delay="homogeneous", probes=(), monitor=False, weight=None):
    """tests/test_serving.py's cover net (delay ring, STDP traces and
    plastic g), driven by numpy stim on "a": a -> b with a homogeneous
    delay of 2 steps or per-synapse delays 0..3, a -> a under STDP."""
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("serve_cover")
    s.add_neuron_population("a", N_A, "izhikevich")
    s.add_neuron_population("b", N_B, "izhikevich")
    kw = ({"delay_steps": 2} if delay == "homogeneous"
          else {"delay": F.UniformIntDelay(0, 3)})
    s.add_synapse_population(
        "ab", "a", "b", connect=F.FixedFanout(4),
        weight=F.UniformWeight(0, 0.8) if weight is None else weight,
        psm=S.ExpDecay(4.0), **kw)
    s.add_synapse_population("aa", "a", "a", connect=F.FixedFanout(5),
                             weight=F.UniformWeight(0, 0.4),
                             wum=S.STDP(0.01))
    for args, kwargs in probes:
        s.probe(*args, **kwargs)
    mon = P["health"]() if monitor else None
    if P is PORT:
        return s.build(dt=1.0, seed=11, device="cpu", monitor=mon)
    return s.build(dt=1.0, seed=11, monitor=mon)


def _stims(lengths, n=N_A, scale=6.0, seed=0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=(T, n))).astype(np.float32)
            for T in lengths]


def _serve(P, model, lengths, S, chunk, pops=("a", "b"),
           record_raster=True, seed0=100, stims=None):
    """Serve one request a length (numpy stim on ``pops``, scale 6, the
    same draws for both packages); returns (server, finished)."""
    srv = P["serve"].SNNServer(model, max_streams=S, chunk=chunk,
                               stim_pops=pops, record_raster=record_raster)
    if stims is None:
        per_pop = {p: _stims(lengths, model.network.populations[p].n,
                             seed=j) for j, p in enumerate(pops)}
        stims = [{p: per_pop[p][i] for p in pops}
                 for i in range(len(lengths))]
    for i, (T, st) in enumerate(zip(lengths, stims)):
        srv.submit(P["serve"].StreamRequest(rid=i, n_steps=T, stim=st,
                                            seed=seed0 + i))
    return srv, srv.run()


def _offline(model, req, raster=True):
    return model.run(req.n_steps, stim=req.stim, record_raster=raster,
                     state=model.init_state(key=R.PRNGKey(req.seed)))


def _assert_port_exact(model, finished, raster=True):
    """Every served stream == the port's offline run, bit for bit."""
    for req in finished:
        res = _offline(model, req, raster)
        for k, v in res.spike_counts.items():
            assert np.array_equal(v.numpy(), req.spike_counts[k]), (
                req.rid, k, "counts")
            if raster:
                assert np.array_equal(res.raster[k].numpy(),
                                      req.raster[k]), (req.rid, k)
        for k, v in req.recordings.items():
            off = res.recordings[k].numpy()[: int(res.recordings.count(k))]
            assert off.shape == v.shape and np.array_equal(off, v), (
                req.rid, k, "recording")


def _assert_same_streams(port, jax_, raster=True):
    """The port's served streams == the JAX package's: counts and rasters
    bit for bit; spike recordings bit for bit, state ones within 2e-4 on
    >= 99.8% of the entries that the streams' state probes recorded (XLA
    and PyTorch round the Izhikevich update differently, and a V on a
    spike's upstroke amplifies that: the contract's threshold
    allowance)."""
    assert [r.rid for r in port] == [r.rid for r in jax_]
    close = {}
    for tr, jr in zip(port, jax_):
        for k, v in jr.spike_counts.items():
            assert np.array_equal(np.asarray(v), tr.spike_counts[k]), (
                tr.rid, k)
        if raster:
            for k, v in jr.raster.items():
                assert np.array_equal(np.asarray(v), tr.raster[k]), (
                    tr.rid, k)
        for k, v in jr.recordings.items():
            a, b = np.asarray(v), tr.recordings[k]
            assert a.shape == b.shape, (tr.rid, k)
            if a.dtype == bool:
                assert np.array_equal(a, b), (tr.rid, k)
            else:
                close[(tr.rid, k)] = np.isclose(b, a, **STATE_TOL).ravel()
    if close:
        assert np.concatenate(list(close.values())).mean() >= AGREEMENT, {
            k: float(c.mean()) for k, c in close.items()}


# ---------------------------------------------------------------------------
# stim plumbing (the offline oracle the serving path is exact against)
# ---------------------------------------------------------------------------

def test_run_with_zero_stim_is_noop():
    model = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=50, n_conn=8,
                                                      seed=2), device="cpu")
    n_exc = model.network.populations["exc"].n
    r1 = model.run(15)
    r2 = model.run(15, stim={"exc": np.zeros((15, n_exc), np.float32)})
    for k in r1.spike_counts:
        assert torch.equal(r1.spike_counts[k], r2.spike_counts[k]), k


def test_run_rejects_unknown_stim_population():
    model = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=50, n_conn=8),
                              device="cpu")
    with pytest.raises(SpecError, match="nope"):
        model.run(5, stim={"nope": np.zeros((5, 50), np.float32)})


# ---------------------------------------------------------------------------
# SNNServer: served streams exact against offline runs and the JAX package
# ---------------------------------------------------------------------------

def test_served_streams_exact_izhikevich():
    """tests/test_serving.py's host case: 3 slots, 5 requests of varied
    lengths (partial trailing chunks, slot reuse), counts and rasters bit
    for bit against the port's offline runs."""
    model = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=60, n_conn=10,
                                                      seed=5), device="cpu")
    n = model.network.populations["exc"].n
    lengths = [20, 13, 25, 9, 17]
    srv, finished = _serve(PORT, model, lengths, 3, 7, pops=("exc",),
                           stims=[{"exc": x}
                                  for x in _stims(lengths, n, 3.0)])
    assert len(finished) == 5 and all(r.done for r in finished)
    _assert_port_exact(model, finished)
    stats = srv.stats()
    assert stats["slot_steps"] == sum(lengths)
    assert stats["latency"]["finished"] == 5
    assert sum(int(r.spike_counts["exc"].sum()) for r in finished) > 0


@pytest.mark.parametrize("delay", ["homogeneous", "per_synapse"])
def test_served_streams_exact_delays_and_stdp(delay):
    """Every state kind (the delay ring and its cursor, STDP traces,
    plastic g) is restored bit for bit in masked lanes: the port's served
    streams equal its offline runs and the JAX package's served streams."""
    lengths = [12, 9, 11, 7]
    tm, jm = _net(PORT, delay), _net(JAXPKG, delay)
    _, port = _serve(PORT, tm, lengths, 2, 5)
    _, jx = _serve(JAXPKG, jm, lengths, 2, 5)
    assert len(port) == 4
    assert sum(int(r.spike_counts["b"].sum()) for r in port) > 0
    _assert_port_exact(tm, port)
    _assert_same_streams(port, jx)


def test_served_probes_and_health_match_offline_and_jax():
    """Probes sample on each slot's own step count (streams admitted at
    other steps, chunks that straddle every sampling stride) and the
    monitor accumulates only active steps: the stitched recordings equal
    the offline run's bit for bit and the JAX package's served ones within
    the parity contract; health totals equal the JAX package's."""
    probes = [(("spk_a", "a", "spikes"), {}),
              (("v_b", "b", "V"), {"every": 3}),
              (("va_mean", "a", "V"), {"every": 2, "reduce": "mean"}),
              (("vw", "b", "V"), {"every": 4, "window": 2}),
              (("x_pre", "aa", "x_pre"), {"every": 5})]
    lengths = [14, 9, 17, 6, 11]
    tm = _net(PORT, probes=probes, monitor=True)
    jm = _net(JAXPKG, probes=probes, monitor=True)
    _, port = _serve(PORT, tm, lengths, 2, 4, record_raster=False)
    _, jx = _serve(JAXPKG, jm, lengths, 2, 4, record_raster=False)
    for r in port:
        assert r.recordings["v_b"].shape == (r.n_steps // 3, N_B)
        assert r.recordings["spk_a"].shape == (r.n_steps, N_A)
        # window probes stream every sample (clients window)
        assert r.recordings["vw"].shape == (r.n_steps // 4, N_B)
    # offline: the window probe keeps its window, the rest every sample;
    # the spike probe is the offline raster
    for r in port:
        res = _offline(tm, r)
        for k, v in r.recordings.items():
            off = res.recordings[k].numpy()[: int(res.recordings.count(k))]
            if k == "vw":
                assert np.array_equal(off, v[-2:]), (r.rid, k)
            else:
                assert np.array_equal(off, v), (r.rid, k)
        assert np.array_equal(r.recordings["spk_a"],
                              res.raster["a"].numpy())
    _assert_same_streams(port, jx, raster=False)
    for tr, jr in zip(port, jx):
        th, jh = tr.health, jr.health
        assert th["steps"] == jh["steps"] == tr.n_steps
        assert th["nonfinite"] == jh["nonfinite"]
        assert th["first_bad_step"] == jh["first_bad_step"]
        for p in jh["populations"]:
            a, b = jh["populations"][p], th["populations"][p]
            assert a["spikes"] == b["spikes"], (tr.rid, p)
            assert a["silent"] == b["silent"] and (
                a["saturated"] == b["saturated"])
            assert b["rate_ema_hz"] == pytest.approx(a["rate_ema_hz"],
                                                     rel=1e-5, abs=1e-6)


def test_idle_slots_are_exact_noops():
    """Slots without an admitted stream keep every state tensor (key, t,
    cursor and ring, traces, g, finite) bit-identical across chunks."""
    model = _net(PORT, "per_synapse")
    srv = TSRV.SNNServer(model, max_streams=3, chunk=4, stim_pops=("a",))
    before = [(n, t[1:].clone()) for n, t in _leaves(srv.states)]
    srv.submit(TSRV.StreamRequest(rid=0, n_steps=8,
                                  stim={"a": _stims([8])[0]}, seed=3))
    srv.run()                                       # slot 0 only
    after = dict(_leaves(srv.states))
    assert before and len(before) == len(after)
    for name, b in before:
        a = after[name][1:]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    # the served slot did move
    assert srv.states.t.tolist() == [8.0, 0.0, 0.0]
    assert srv.states.syn["ab"].cursor.tolist() == [8 % 4, 0, 0]


def _leaves(x, prefix=""):
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{prefix}.{k}")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{prefix}.{f.name}")


def test_pop_finished_bounds_memory_and_recycles_rids():
    model = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=40, n_conn=6),
                              device="cpu")
    n = model.network.populations["exc"].n
    srv = TSRV.SNNServer(model, max_streams=2, chunk=4, stim_pops=("exc",))

    def req():
        return TSRV.StreamRequest(rid=0, n_steps=6,
                                  stim={"exc": _stims([6], n)[0]}, seed=1)
    srv.submit(req())
    with pytest.raises(ValueError, match="duplicate request rid"):
        srv.submit(req())                             # rid=0 again
    srv.run()
    done = srv.pop_finished()
    assert [r.rid for r in done] == [0] and done[0].done
    assert not srv.requests and 0 not in srv.sched.timings
    srv.submit(req())                                 # rid recycled
    assert srv.run()[0].done


def test_server_validates_requests():
    model = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=40, n_conn=6),
                              device="cpu")
    srv = TSRV.SNNServer(model, max_streams=2, chunk=4, stim_pops=("exc",))
    n_exc = model.network.populations["exc"].n
    with pytest.raises(ValueError, match="not served"):
        srv.submit(TSRV.StreamRequest(
            rid=0, n_steps=4, stim={"inh": np.zeros((4, 8), np.float32)}))
    with pytest.raises(ValueError, match="shape"):
        srv.submit(TSRV.StreamRequest(
            rid=1, n_steps=4,
            stim={"exc": np.zeros((3, n_exc), np.float32)}))
    with pytest.raises(ValueError, match="unknown stim population"):
        TSRV.SNNServer(model, stim_pops=("bogus",))
    with pytest.raises(ValueError, match="chunk must be positive"):
        TSRV.SNNServer(model, chunk=0)
    # serve_chunk's own checks
    st = model.init_stream_state(torch.stack([R.PRNGKey(0)] * 2))
    with pytest.raises(ValueError, match="expected"):
        model.serve_chunk(st, {"exc": np.zeros((2, 3, n_exc), np.float32)},
                          np.ones(2, np.int32), 4)
    with pytest.raises(ValueError, match="steps_left"):
        model.serve_chunk(st, {}, np.ones(3, np.int32), 4)
    with pytest.raises(SpecError, match="unknown stim"):
        model.serve_chunk(st, {"nope": np.zeros((2, 4, 1), np.float32)},
                          np.ones(2, np.int32), 4)


def test_compiled_model_serve_handle():
    model = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=40, n_conn=6),
                              device="cpu")
    srv = model.serve(max_streams=2, chunk=8, stim_pops=("exc",))
    assert isinstance(srv, TSRV.SNNServer)
    assert srv.model is model and srv.max_streams == 2 and srv.chunk == 8


def test_serve_chunk_reuses_its_runner_and_masks_lanes():
    """One runner per (S, chunk, keys, raster): new stim and steps_left
    values reuse it; a lane's counts cover only its first steps_left
    steps, and its t and cursor advance by exactly that many."""
    model = _net(PORT, "per_synapse")
    sim = model.simulator
    st = model.init_stream_state(torch.stack([R.PRNGKey(i)
                                              for i in range(3)]))
    stim = {"a": np.stack(_stims([6, 6, 6]))}
    left = np.array([6, 2, 0], np.int32)
    st2, counts, raster, rec = model.serve_chunk(st, stim, left, 6,
                                                 record_raster=True)
    assert st2.t.tolist() == [6.0, 2.0, 0.0]
    assert st2.syn["ab"].cursor.tolist() == [6 % 4, 2, 0]
    assert raster["a"].shape == (3, 6, N_A)
    assert not raster["a"][1, 2:].any() and not raster["a"][2].any()
    assert torch.equal(counts["a"], raster["a"].sum(dim=1,
                                                    dtype=torch.int32))
    n_runners = len(sim._compiled)
    st3 = model.serve_chunk(st2, stim, np.array([1, 1, 1], np.int32), 6,
                            record_raster=True)[0]
    assert len(sim._compiled) == n_runners
    # lane 1, resumed in a second chunk, equals a lone stream of its 3
    # steps (rows 0, 1 of its first chunk, row 0 of its second)
    rows = stim["a"][1, [0, 1, 0]][None]
    one = model.serve_chunk(model.init_stream_state(R.PRNGKey(1)[None]),
                            {"a": rows}, np.array([3], np.int32), 3)[0]
    for (name, x), (_, y) in zip(_leaves(st3), _leaves(one)):
        assert torch.equal(x[1:2], y), name


# ---------------------------------------------------------------------------
# the ring fold with a cursor a member, against the JAX ring update
# ---------------------------------------------------------------------------

def test_fold_with_unequal_cursors_matches_jax_ring():
    """Members at different ring positions (served streams admitted at
    other steps): the port's delayed group step on the CPU (the fold's
    plain version, ``kernels.ref.delay_ring_fold_ref``) equals the JAX
    package's ring update for each member at its own cursor, bit for bit
    (weights 0.5, so every sum is exact in both packages)."""
    tm = _net(PORT, "per_synapse", weight=0.5)
    jm = _net(JAXPKG, "per_synapse", weight=0.5)
    tg = next(g for g in tm.network.synapses if g.name == "ab")
    jg = next(g for g in jm.network.synapses if g.name == "ab")
    assert np.array_equal(np.asarray(jg.ell.post_ind), tg.ell.post_ind)
    assert np.array_equal(np.asarray(jg.ell.delay), tg.ell.delay)
    B, S = 4, tg.ring_slots
    cursors = [0, 3, 1, 2]
    rng = np.random.default_rng(7)
    rings = rng.standard_normal((B, S, N_B)).astype(np.float32)
    spikes = rng.random((B, N_A)) < 0.5
    st = tg.init_state(B)
    st.dendritic = torch.tensor(rings)
    st.cursor = torch.tensor(cursors, dtype=torch.int32)
    new, cur = tg.step(st, torch.tensor(spikes), 1.0, 1.0,
                       v_post=torch.zeros(B, N_B))
    assert new.cursor.tolist() == [(c + 1) % S for c in cursors]
    for b in range(B):
        js = jg.init_state()
        js = dataclasses.replace(js, dendritic=jax.numpy.asarray(rings[b]),
                                 cursor=jax.numpy.int32(cursors[b]))
        jn, jcur = jg.step(js, jax.numpy.asarray(spikes[b]),
                           jax.numpy.float32(1.0), 1.0,
                           v_post=jax.numpy.zeros(N_B))
        assert int(jn.cursor) == int(new.cursor[b])
        np.testing.assert_array_equal(np.asarray(jn.dendritic),
                                      new.dendritic[b].numpy())
        np.testing.assert_array_equal(np.asarray(jcur), cur[b].numpy())
    # the same through the plain fold directly, against the per-member
    # single-cursor folds
    acc = torch.tensor(rng.standard_normal((S, N_B, B)))
    whole = TR.delay_ring_fold_ref(torch.tensor(rings), acc.clone(),
                                   torch.tensor(cursors, dtype=torch.int32),
                                   -1.0, torch.tensor([0.5, 1.0, 2.0, 3.0]))
    for b in range(B):
        one = TR.delay_ring_fold_ref(
            torch.tensor(rings[b:b + 1]), acc[:, :, b:b + 1].clone(),
            torch.tensor([cursors[b]], dtype=torch.int32), -1.0,
            torch.tensor([[0.5, 1.0, 2.0, 3.0][b]]))
        for x, y in zip(whole, one):
            assert torch.equal(x[b:b + 1], y), b


# ---------------------------------------------------------------------------
# entry points: the card unless asked; a mesh of several ranks needs a
# launcher (tests/test_torch_engine_serving.py serves on the mesh)
# ---------------------------------------------------------------------------

def test_serving_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.launch import gateway as TGW
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--model", "izhikevich", "--requests", "1", "--steps", "4"]
    with pytest.raises(RuntimeError, match="CUDA"):
        TSRV.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        TGW.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TSRV.main(argv + ["--devices", "1"])
    # a group left up by an earlier test would answer for the launcher
    assert not torch.distributed.is_initialized(), "a process group leaked"
    with pytest.raises(RuntimeError, match="rendezvous"):
        TSRV.main(argv + ["--devices", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="rendezvous"):
        TGW.main(["--devices", "2", "--device", "cpu"])
    with pytest.raises(SpecError, match="Mesh"):
        TIZ.spec(TIZ.IzhikevichNetConfig(n_total=20, n_conn=4)).build(
            device="cpu", mesh=object())
