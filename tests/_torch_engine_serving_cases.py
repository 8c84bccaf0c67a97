"""Served streams on the sharded engine -- not a test module.

Each case serves a stream workload (``SNNServer``, the gateway) on a model
built over the mesh and returns every stream's outputs beside the engine's
offline run of it; ``test_torch_engine_serving.py`` holds them to each
other, to the port's single-device serving, and to the JAX package's.  No
JAX here.
"""

import numpy as np

from repro_torch import random as R
from repro_torch.core.models import izhikevich_net as TIZ
from repro_torch.core.snn import spec as TSPEC
from repro_torch.core.snn import synapses as TSYN
from repro_torch.launch import gateway as TGW
from repro_torch.launch import snn_serve as TSRV
from repro_torch.obs.health import HealthConfig as THC
from repro_torch.sparse import formats as TF

PORT = dict(spec=TSPEC, syn=TSYN, formats=TF, serve=TSRV, health=THC,
            iz=TIZ, gw=TGW)
N_A, N_B = 30, 14

COVER_PROBES = [(("spk_a", "a", "spikes"), {}),
                (("v_b", "b", "V"), {"every": 3}),
                (("va_mean", "a", "V"), {"every": 2, "reduce": "mean"}),
                (("vw", "b", "V"), {"every": 4, "window": 2}),
                (("x_pre", "aa", "x_pre"), {"every": 5})]


def cover_net(P, mesh=None, device=None):
    """tests/test_serving.py's cover net: per-synapse delays 0..3 a -> b,
    STDP a -> a, numpy stim on "a" and "b", probes and the monitor."""
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("serve_cover")
    s.add_neuron_population("a", N_A, "izhikevich")
    s.add_neuron_population("b", N_B, "izhikevich")
    s.add_synapse_population("ab", "a", "b", connect=F.FixedFanout(4),
                             weight=F.UniformWeight(0, 0.8),
                             psm=S.ExpDecay(4.0),
                             delay=F.UniformIntDelay(0, 3))
    s.add_synapse_population("aa", "a", "a", connect=F.FixedFanout(5),
                             weight=F.UniformWeight(0, 0.4),
                             wum=S.STDP(0.01))
    for args, kwargs in COVER_PROBES:
        s.probe(*args, **kwargs)
    kw = {} if mesh is None else {"mesh": mesh}
    if device is not None:
        kw["device"] = device
    return s.build(dt=1.0, seed=11, monitor=P["health"](), **kw)


def izh_cfg(P):
    return P["iz"].IzhikevichNetConfig(n_total=60, n_conn=10, seed=5)


def gw_cfg(P):
    """tests/test_gateway.py's net without its random drive."""
    return P["iz"].IzhikevichNetConfig(n_total=40, n_conn=6,
                                       input_scale=0.0)


def stims(lengths, n, scale=6.0, seed=0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=(T, n))).astype(np.float32)
            for T in lengths]


def serve(P, model, lengths, S, chunk, pops, stim_list, record_raster=True,
          seed0=100):
    """(server, finished) of one request a length."""
    srv = P["serve"].SNNServer(model, max_streams=S, chunk=chunk,
                               stim_pops=pops, record_raster=record_raster)
    for i, (T, st) in enumerate(zip(lengths, stim_list)):
        srv.submit(P["serve"].StreamRequest(rid=i, n_steps=T, stim=st,
                                            seed=seed0 + i))
    return srv, srv.run()


IZH_LENGTHS = [20, 13, 25, 9, 17]
COVER_LENGTHS = [14, 9, 17, 6, 11]


def izh_stims(n):
    return [{"exc": x} for x in stims(IZH_LENGTHS, n, 3.0)]


def cover_stims():
    a = stims(COVER_LENGTHS, N_A, seed=0)
    b = stims(COVER_LENGTHS, N_B, seed=1)
    return [{"a": x, "b": y} for x, y in zip(a, b)]


def stream(req):
    """A served stream's outputs (an SNNServer's request or a gateway's)."""
    try:
        raster = {k: np.asarray(v) for k, v in req.raster.items()}
    except ValueError:              # a server without rasters
        raster = {}
    steps = getattr(req, "steps_served", None)
    if steps is None:
        steps = sum(c.n_steps for c in req.chunks)
    return {"rid": req.rid,
            "status": getattr(req, "status", "done" if req.done else ""),
            "steps_served": steps,
            "counts": {k: np.asarray(v) for k, v in req.spike_counts.items()},
            "raster": raster,
            "rec": {k: np.asarray(v) for k, v in req.recordings.items()},
            "health": req.health}


def offline(model, req, n_steps=None, raster=True):
    n = req.n_steps if n_steps is None else n_steps
    res = model.run(n, stim={k: v[:n] for k, v in req.stim.items()},
                    record_raster=raster,
                    state=model.init_state(key=R.PRNGKey(req.seed)))
    return {"counts": {k: v.numpy() for k, v in res.spike_counts.items()},
            "raster": ({k: v.numpy() for k, v in res.raster.items()}
                       if raster else {}),
            "rec": {k: res.recordings[k].numpy()[
                : int(res.recordings.count(k))]
                for k in res.recordings.keys()}}


def mid_flight(gw_mod, model, clk):
    """tests/test_gateway.py's mid-flight eviction."""
    gw = gw_mod.Gateway(chunk=5, buckets=(2,), clock=clk, warm=False)
    gw.register("izh", model, stim_pops=("exc",))
    n = model.network.populations["exc"].n
    x = stims([20, 20, 10], n, seed=0)
    doomed = gw.submit("izh", {"exc": x[0]}, 20, seed=11, deadline_ms=100.0)
    survivor = gw.submit("izh", {"exc": x[1]}, 20, seed=12)
    gw.tick()
    clk.advance(1.0)                # past doomed's deadline
    gw.tick()                       # the boundary sweep evicts it
    third = gw.submit("izh", {"exc": x[2]}, 10, seed=13)
    gw.run_until_drained()
    return gw, [doomed, survivor, third]


def grow_shrink(gw_mod, model):
    """tests/test_gateway.py's burst: grow to 4 slots, shrink back to 2."""
    gw = gw_mod.Gateway(chunk=5, buckets=(2, 4), shrink_patience=1,
                        warm=False)
    gw.register("izh", model, stim_pops=("exc",))
    n = model.network.populations["exc"].n
    x = stims([5, 5, 5, 40], n, seed=3)
    reqs = [gw.submit("izh", {"exc": x[i]}, 5, seed=40 + i)
            for i in range(3)]
    reqs.append(gw.submit("izh", {"exc": x[3]}, 40, seed=49))
    gw.run_until_drained()
    return gw.workers["izh"], reqs


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def case_served_izhikevich(mesh):
    """3 slots, 5 requests of varied lengths (partial trailing chunks,
    slot reuse), the cortical net's thalamic drive on."""
    m = TIZ.compile_model(izh_cfg(PORT), mesh=mesh)
    n = m.network.populations["exc"].n
    srv, fin = serve(PORT, m, IZH_LENGTHS, 3, 7, ("exc",), izh_stims(n))
    return {"global": {"streams": [stream(r) for r in fin],
                       "offline": [offline(m, r) for r in fin],
                       "slot_steps": srv.stats()["slot_steps"]}}


def case_served_cover(mesh):
    """Delays, STDP, probes on each slot's own schedule and the monitor,
    2 slots, chunks of 4."""
    m = cover_net(PORT, mesh=mesh)
    _, fin = serve(PORT, m, COVER_LENGTHS, 2, 4, ("a", "b"), cover_stims(),
                   record_raster=False)
    return {"global": {"streams": [stream(r) for r in fin],
                       "offline": [offline(m, r) for r in fin]}}


def case_gateway_eviction(mesh):
    m = TIZ.compile_model(gw_cfg(PORT), mesh=mesh)
    gw, reqs = mid_flight(TGW, m, Clock())
    doomed = reqs[0]
    return {"global": {"streams": [stream(r) for r in reqs],
                       "offline": [offline(m, r, raster=False)
                                   for r in reqs[1:]],
                       "doomed_prefix": offline(m, doomed, 5, raster=False),
                       "counters": dict(gw.workers["izh"].counters)}}


def case_gateway_grow_shrink(mesh):
    m = TIZ.compile_model(gw_cfg(PORT), mesh=mesh)
    w, reqs = grow_shrink(TGW, m)
    return {"global": {"streams": [stream(r) for r in reqs],
                       "offline": [offline(m, r, raster=False)
                                   for r in reqs],
                       "counters": dict(w.counters),
                       "max_streams": w.max_streams}}
