"""The port's ``device_init_local`` at 1, 2 and 8 gloo ranks, and
``ModelSpec.plan``, against the JAX package.

Each rank's post-shard block of a declaration drawn rank by rank
(``device_init_local``: its own rows, a ``pmax``'d slot width, one
``all_to_all``) must equal, bit for bit, both the port's generate-then-
partition block and the JAX package's ``partition_ell_by_post`` of its
``device_resolve`` graph (the JAX package's own oracle), for every
connectivity kind, delays and a post window included (normal weights
within the contract's 4 ulp of the JAX package's).  ``plan`` is host
arithmetic and must give the JAX package's numbers for the same spec and
device count.
"""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_device_init_local_cases as C  # noqa: E402
from _torch_dist import run_ranks  # noqa: E402
from repro.core.models import izhikevich_net as JIZ  # noqa: E402
from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.core.snn import synapses as JSYN  # noqa: E402
from repro.sparse import device_init as JDI  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn import synapses as TSYN  # noqa: E402
from repro_torch.core.snn.errors import SpecError  # noqa: E402
from repro_torch.sparse import device_init as DI  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

CASES = Path(C.__file__).resolve()


@pytest.fixture(scope="module", params=[1, 2, 8], ids=lambda d: f"D{d}")
def ranks(request, tmp_path_factory):
    return run_ranks(CASES, request.param,
                     tmp_path_factory.mktemp(f"dil_D{request.param}"))


@functools.lru_cache(maxsize=None)
def _jax_blocks(name: str, n_shards: int):
    """The JAX package's generate-then-partition blocks [D, n_pre, k]."""
    connect, weight, delay, window, n_pre, n_post = C.DECLS[name](JF)
    key = jax.random.PRNGKey(C.KEY_SEED)
    post, g, valid = JDI.device_resolve(connect, key, n_pre, n_post, weight)
    dd = (None if delay is None
          else JDI.device_delays(key, n_pre, post.shape[1], delay))
    if dd is not None:
        dd = jnp.where(valid, dd, 0).astype(jnp.int32)
    n_local = n_post
    if window is not None:
        lo, hi = window
        mask = (post >= lo) & (post < hi) & valid
        post = jnp.where(mask, post - lo, 0).astype(jnp.int32)
        g = jnp.where(mask, g, 0.0).astype(jnp.float32)
        dd = None if dd is None else jnp.where(mask, dd, 0).astype(jnp.int32)
        valid, n_local = mask, hi - lo
    ell = JF.ELLSynapses(g=g, post_ind=post, valid=valid, n_post=n_local,
                         delay=dd)
    out = JDI.partition_ell_by_post(ell, n_shards)
    return tuple(None if a is None else np.asarray(a) for a in out[:4]) \
        + out[4:]


def _as_bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("name", list(C.DECLS))
def test_local_blocks_equal_partition_and_jax(ranks, name):
    jax_blocks = _jax_blocks(name, ranks.world)
    for d, res in enumerate(ranks.local(name)):
        got, ref = res["local"]["got"], res["local"]["ref"]
        assert got[4:] == ref[4:] == jax_blocks[4:], (name, d)
        for what, a, b, j in zip(("g", "post", "valid", "delay"), got[:4],
                                 ref[:4], jax_blocks[:4]):
            if j is None:
                assert a is None and b is None, (name, what)
                continue
            assert a.shape == (j.shape[1], j.shape[2]), (name, what)
            np.testing.assert_array_equal(_as_bits(a.numpy()),
                                          _as_bits(b.numpy()),
                                          err_msg=f"{name} {what} rank {d}")
            weight = C.DECLS[name](JF)[1]
            if what == "g" and isinstance(weight, JF.NormalWeight):
                # the contract's normal draws: 4 ulp of the larger of the
                # weight and its std * z term
                x, y = j[d], a.numpy()
                z = (x.astype(np.float64) - weight.mean) / weight.std
                mag = np.maximum(np.abs(x), np.abs(weight.std * z))
                assert (np.abs(x - y) <= 4 * np.spacing(
                    mag.astype(np.float32))).all(), (name, d)
                continue
            np.testing.assert_array_equal(_as_bits(a.numpy()),
                                          _as_bits(j[d]),
                                          err_msg=f"{name} {what} rank {d}")


def test_overflow_reported_once_from_the_summed_count(ranks):
    assert ranks.case("overflow_trace")["global"]["overflow_events"] == 0


def test_fp_row_overflow_equals_jax():
    """The overflow flags of FixedProbability rows (the count pass's key
    schedule) against the JAX package's, at a padding the draws pass."""
    rows = np.arange(64, dtype=np.int32)
    for n_post, p in ((100, 0.5), (40, 0.97), (7, 0.3)):
        got = DI._fp_row_overflow(R.PRNGKey(3), torch.as_tensor(rows),
                                  n_post, p)
        want = JDI._fp_row_overflow(jax.random.PRNGKey(3), jnp.asarray(rows),
                                    n_post, p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# plan(): host arithmetic, the JAX package's numbers
# ---------------------------------------------------------------------------

def _plan_spec(P, stdp=True):
    F, S = P["formats"], P["syn"]
    s = P["spec"].ModelSpec("small")
    s.add_neuron_population("a", 200, "izhikevich")
    s.add_neuron_population("b", 100, "izhikevich")
    s.add_synapse_population("ab", "a", ["a", "b"],
                             connect=F.FixedFanout(8),
                             weight=F.UniformWeight(0, 0.5),
                             wum=S.STDP(0.01) if stdp else None,
                             delay=F.UniformIntDelay(0, 3))
    s.add_synapse_population("ba", "b", "a",
                             connect=F.FixedProbability(0.1),
                             weight=0.2, delay_ms=1.0)
    s.probe("raster", "a", "spikes")
    s.probe("vm", "b", "V", every=2, window=7)
    s.probe("vmax", "a", "V", reduce="max")
    return s


JAXPKG = dict(spec=JSPEC, syn=JSYN, formats=JF)
PORT = dict(spec=TSPEC, syn=TSYN, formats=TF)


@pytest.mark.parametrize("devices", [1, 2, 8, 3])
@pytest.mark.parametrize("kw", [dict(), dict(n_steps=100, max_streams=4),
                                dict(host_gib=1e-4, n_steps=50)],
                         ids=["default", "streams", "over"])
def test_plan_equals_jax(devices, kw):
    want = _plan_spec(JAXPKG).plan(mesh_shape=devices, dt=0.5, **kw)
    got = _plan_spec(PORT).plan(mesh_shape=devices, dt=0.5, **kw)
    assert got == want


def test_plan_of_the_cortical_net_equals_jax():
    for d in (1, 4, 64):
        want = JIZ.spec(JIZ.IzhikevichNetConfig()).plan(d, n_steps=1000)
        got = TIZ.spec(TIZ.IzhikevichNetConfig()).plan(d, n_steps=1000)
        assert got == want


def test_plan_validates_mesh_shape():
    with pytest.raises(SpecError, match="mesh_shape"):
        _plan_spec(PORT).plan(mesh_shape=0)
