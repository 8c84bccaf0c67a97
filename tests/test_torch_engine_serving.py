"""SNN serving on the port's sharded engine at 1, 2 and 8 gloo ranks.

tests/test_serving.py's and tests/test_gateway.py's sharded cases on the
port: ``SNNServer`` and the gateway over a model built with a mesh, each
rank serving the same traffic (``_torch_engine_serving_cases.py``).  Every
served stream must equal the engine's offline run of it bit for bit
(counts, rasters, the stitched probe recordings; evictions, partial
chunks, the slot table's growing and shrinking included), the port's
single-device serving of the same traffic bit for bit, and the JAX
package's served streams under the parity contract (counts and rasters
bit for bit on these nets, state recordings within 2e-4 on >= 99.8% of
entries, health totals exact).
"""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_engine_serving_cases as C  # noqa: E402
from _torch_dist import Groups  # noqa: E402
from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.core.snn import synapses as JSYN  # noqa: E402
from repro.launch import gateway as JGW  # noqa: E402
from repro.launch import snn_serve as JSRV  # noqa: E402
from repro.obs.health import HealthConfig as JHC  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402

JAXPKG = dict(spec=JSPEC, syn=JSYN, formats=JF, serve=JSRV, health=JHC,
              iz=JIZ, gw=JGW)
PORT = C.PORT
CASES = Path(C.__file__).resolve()
STATE_TOL = dict(rtol=2e-4, atol=2e-4)
AGREEMENT = 0.998


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _groups(tmp_path_factory):
    """The groups of 1, 2 and 8 ranks, started together with the module's
    first test."""
    groups = Groups(CASES, (1, 2, 8), tmp_path_factory, "serve")
    yield groups
    groups.wait_all()


@pytest.fixture(scope="module", params=[1, 2, 8], ids=lambda d: f"D{d}")
def ranks(request, _groups):
    return _groups.get(request.param)


def _same(a, b, where):
    assert set(a) == set(b), where
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and np.array_equal(x, y), (where, k)


def _assert_offline_exact(streams, offline):
    for s, off in zip(streams, offline):
        _same(s["counts"], off["counts"], (s["rid"], "counts"))
        if off["raster"]:
            _same(s["raster"], off["raster"], (s["rid"], "raster"))


def _assert_same_streams(streams, ref):
    """Served streams equal: statuses, steps, counts, rasters,
    recordings and health, bit for bit."""
    assert [s["rid"] for s in streams] == [r["rid"] for r in ref]
    for s, r in zip(streams, ref):
        assert (s["status"], s["steps_served"]) == (r["status"],
                                                    r["steps_served"])
        for part in ("counts", "raster", "rec"):
            _same(s[part], r[part], (s["rid"], part))
        assert s["health"] == r["health"], s["rid"]


def _assert_meets_jax(streams, jax_reqs, raster=True):
    close = []
    for s, j in zip(streams, jax_reqs):
        assert s["rid"] == j.rid
        for k, v in j.spike_counts.items():
            assert np.array_equal(np.asarray(v), s["counts"][k]), (j.rid, k)
        if raster:
            for k, v in j.raster.items():
                assert np.array_equal(np.asarray(v), s["raster"][k])
        for k, v in j.recordings.items():
            a, b = np.asarray(v), s["rec"][k]
            assert a.shape == b.shape, (j.rid, k)
            if a.dtype == bool:
                assert np.array_equal(a, b), (j.rid, k)
            else:
                close.append(np.isclose(b, a, **STATE_TOL).ravel())
        if j.health is not None:
            th, jh = s["health"], j.health
            assert th["steps"] == jh["steps"]
            assert th["first_bad_step"] == jh["first_bad_step"]
            for p in jh["populations"]:
                assert (th["populations"][p]["spikes"]
                        == jh["populations"][p]["spikes"]), (j.rid, p)
    if close:
        assert np.concatenate(close).mean() >= AGREEMENT


# -- the single-device references, once a module ---------------------------

@functools.lru_cache(maxsize=None)
def _port_single(case: str):
    if case == "served_izhikevich":
        m = TIZ.compile_model(C.izh_cfg(PORT), device="cpu")
        n = m.network.populations["exc"].n
        _, fin = C.serve(PORT, m, C.IZH_LENGTHS, 3, 7, ("exc",),
                         C.izh_stims(n))
    elif case == "served_cover":
        m = C.cover_net(PORT, device="cpu")
        _, fin = C.serve(PORT, m, C.COVER_LENGTHS, 2, 4, ("a", "b"),
                         C.cover_stims(), record_raster=False)
    elif case == "gateway_eviction":
        m = TIZ.compile_model(C.gw_cfg(PORT), device="cpu")
        _, fin = C.mid_flight(C.TGW, m, C.Clock())
    else:
        m = TIZ.compile_model(C.gw_cfg(PORT), device="cpu")
        _, fin = C.grow_shrink(C.TGW, m)
    return [C.stream(r) for r in fin]


@functools.lru_cache(maxsize=None)
def _jax(case: str):
    if case == "served_cover":
        m = C.cover_net(JAXPKG)
        return C.serve(JAXPKG, m, C.COVER_LENGTHS, 2, 4, ("a", "b"),
                       C.cover_stims(), record_raster=False)[1]
    m = JIZ.compile_model(C.gw_cfg(JAXPKG))
    if case == "gateway_eviction":
        return C.mid_flight(JGW, m, C.Clock())[1]
    return C.grow_shrink(JGW, m)[1]


# -- tests -------------------------------------------------------------------

def test_served_izhikevich_exact(ranks):
    got = ranks.case("served_izhikevich")["global"]
    assert len(got["streams"]) == 5
    assert all(s["status"] == "done" for s in got["streams"])
    assert got["slot_steps"] == sum(C.IZH_LENGTHS)
    _assert_offline_exact(got["streams"], got["offline"])
    _assert_same_streams(got["streams"], _port_single("served_izhikevich"))
    assert sum(int(s["counts"]["exc"].sum()) for s in got["streams"]) > 0


def test_served_delays_stdp_probes_health(ranks):
    got = ranks.case("served_cover")["global"]
    for s, off in zip(got["streams"], got["offline"]):
        _same(s["counts"], off["counts"], s["rid"])
        for k, v in s["rec"].items():
            want = off["rec"][k]
            if k == "vw":               # a served window streams every
                v = v[-want.shape[0]:]  # sample; offline keeps its window
            assert np.array_equal(v, want), (s["rid"], k)
    _assert_same_streams(got["streams"], _port_single("served_cover"))
    _assert_meets_jax(got["streams"], _jax("served_cover"), raster=False)


def test_gateway_mid_flight_eviction(ranks):
    got = ranks.case("gateway_eviction")["global"]
    doomed, survivor, third = got["streams"]
    assert doomed["status"] == "evicted" and doomed["steps_served"] == 5
    assert survivor["status"] == third["status"] == "done"
    assert got["counters"]["evicted_active"] == 1
    _assert_offline_exact([survivor, third], got["offline"])
    _same(doomed["counts"], got["doomed_prefix"]["counts"], "prefix")
    _assert_same_streams(got["streams"], _port_single("gateway_eviction"))
    _assert_meets_jax(got["streams"], _jax("gateway_eviction"),
                      raster=False)


def test_gateway_grow_and_shrink(ranks):
    got = ranks.case("gateway_grow_shrink")["global"]
    assert got["counters"]["grows"] == 1 and got["counters"]["shrinks"] >= 1
    assert got["max_streams"] == 2
    assert all(s["status"] == "done" for s in got["streams"])
    _assert_offline_exact(got["streams"], got["offline"])
    _assert_same_streams(got["streams"], _port_single("gateway_grow_shrink"))
    _assert_meets_jax(got["streams"], _jax("gateway_grow_shrink"),
                      raster=False)
    assert int(got["streams"][-1]["counts"]["exc"].sum()) > 0
