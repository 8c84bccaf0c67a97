"""On-device construction in the port (``repro_torch.sparse.device_init``,
``ModelSpec.build(init="device")``) on the CPU: the plain versions of the
threefry kernels.

Two halves.  The first mirrors every single-device case of
tests/test_device_init.py on the port (distribution, determinism, row
chunking, the partition, the overflow clamp, the peak model, the spec's
errors).  The second holds the port to the JAX package under the parity
contract (ROADMAP): ``FixedFanout`` (both sampler regimes and k ==
n_post), ``OneToOne``, ``Dense``, ``device_delays`` and constant or
uniform weights bit for bit, under any ``rows=`` chunking; ``NormalWeight``
within the normal's 4 ulp; ``FixedProbability``'s targets bit for bit and
its degrees equal on every row here; a device-built net's run against
JAX's run of its own device-built net (rasters and rates).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.sparse import device_init as JDI  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.sparse import device_init as DI  # noqa: E402
from repro_torch.sparse import formats as F  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed=0):
    return R.PRNGKey(seed)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# fixed fanout
# ---------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(n_pre=st.integers(1, 40), n_post=st.integers(2, 120),
       seed=st.integers(0, 3))
def test_fixed_fanout_degrees_and_distinctness(n_pre, n_post, seed):
    n_conn = max(1, min(n_post, n_post // 3))
    post, g, valid = DI.device_fixed_fanout(_key(seed), n_pre, n_post,
                                            n_conn)
    post = _np(post)
    assert post.shape == (n_pre, n_conn)
    assert bool(_np(valid).all())
    for row in post:
        assert len(set(row.tolist())) == n_conn
        assert row.min() >= 0 and row.max() < n_post


def test_fixed_fanout_bit_deterministic():
    a = DI.device_fixed_fanout(_key(7), 30, 200, 12,
                               F.UniformWeight(0.0, 0.5))
    b = DI.device_fixed_fanout(_key(7), 30, 200, 12,
                               F.UniformWeight(0.0, 0.5))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = DI.device_fixed_fanout(_key(8), 30, 200, 12,
                               F.UniformWeight(0.0, 0.5))
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_fixed_fanout_partition_invariance(splits):
    n_pre, n_post, k = 40, 150, 9
    w = F.NormalWeight(0.0, 0.3)
    full = DI.device_fixed_fanout(_key(3), n_pre, n_post, k, w)
    bounds = np.linspace(0, n_pre, splits + 1).astype(int)
    parts = [DI.device_fixed_fanout(_key(3), n_pre, n_post, k, w,
                                    rows=torch.arange(lo, hi))
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts]), full[i])


def test_fixed_fanout_matches_host_degree_distribution():
    rng = np.random.default_rng(0)
    n_pre, n_post, k = 400, 300, 20
    host_post, _ = F.fixed_fanout_connectivity(rng, n_pre, n_post, k)
    dev_post, _, _ = DI.device_fixed_fanout(_key(0), n_pre, n_post, k)
    host_in = np.bincount(host_post.reshape(-1), minlength=n_post)
    dev_in = np.bincount(_np(dev_post).reshape(-1), minlength=n_post)
    assert host_in.sum() == dev_in.sum() == n_pre * k
    assert abs(host_in.mean() - dev_in.mean()) < 1e-9
    assert abs(host_in.std() - dev_in.std()) / host_in.std() < 0.25


def test_fixed_fanout_dense_regime_uses_topk_path():
    post, _, _ = DI.device_fixed_fanout(_key(1), 8, 16, 12)
    for row in _np(post):
        assert len(set(row.tolist())) == 12
    post, _, _ = DI.device_fixed_fanout(_key(1), 4, 8, 8)
    assert (_np(post) == np.arange(8)).all()


# ---------------------------------------------------------------------------
# fixed probability
# ---------------------------------------------------------------------------

def test_fixed_probability_matches_host_degree_distribution():
    n_pre, n_post, p = 600, 400, 0.05
    rng = np.random.default_rng(0)
    _, _, host_valid = F.FixedProbability(p).resolve(rng, n_pre, n_post)
    dev_post, dev_g, dev_valid = DI.device_fixed_probability(
        _key(0), n_pre, n_post, p)
    host_deg = host_valid.sum(axis=1)
    dev_deg = _np(dev_valid).sum(axis=1)
    mean = n_post * p
    std = np.sqrt(n_post * p * (1 - p))
    assert abs(host_deg.mean() - mean) < 4 * std / np.sqrt(n_pre)
    assert abs(dev_deg.mean() - mean) < 4 * std / np.sqrt(n_pre)
    assert 0.7 < dev_deg.std() / std < 1.3
    dev_post, dev_valid = _np(dev_post), _np(dev_valid)
    for i in range(n_pre):
        vs = dev_post[i, dev_valid[i]]
        assert len(set(vs.tolist())) == len(vs)
    assert (_np(dev_g)[~dev_valid] == 0).all()


def test_fixed_probability_target_uniformity():
    post, _, valid = DI.device_fixed_probability(_key(2), 2000, 50, 0.1)
    counts = np.bincount(_np(post)[_np(valid)], minlength=50)
    frac_low = counts[:25].sum() / counts.sum()
    assert 0.45 < frac_low < 0.55


def test_fixed_probability_determinism_and_chunking():
    a = DI.device_fixed_probability(_key(5), 60, 300, 0.04, 2.0)
    b = DI.device_fixed_probability(_key(5), 60, 300, 0.04, 2.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    lo = DI.device_fixed_probability(_key(5), 60, 300, 0.04, 2.0,
                                     rows=torch.arange(0, 25))
    hi = DI.device_fixed_probability(_key(5), 60, 300, 0.04, 2.0,
                                     rows=torch.arange(25, 60))
    for i in range(3):
        assert torch.equal(torch.cat([lo[i], hi[i]]), a[i])


def test_fixed_probability_rejects_bad_p():
    with pytest.raises(ValueError, match="outside"):
        DI.device_fixed_probability(_key(0), 4, 4, 1.5)


# ---------------------------------------------------------------------------
# one-to-one / dispatch / weights
# ---------------------------------------------------------------------------

def test_one_to_one_device():
    post, g, valid = DI.device_one_to_one(_key(0), 9, 9, 0.25)
    assert (_np(post)[:, 0] == np.arange(9)).all()
    assert np.allclose(_np(g), 0.25)
    with pytest.raises(ValueError, match="n_pre == n_post"):
        DI.device_one_to_one(_key(0), 4, 5)


def test_device_resolve_dispatch_matches_kernels():
    for init in (F.FixedFanout(4), F.FixedProbability(0.2), F.OneToOne(),
                 F.DenseInit()):
        post, g, valid = DI.device_resolve(init, _key(1), 12, 12, 0.5)
        assert post.shape == g.shape == valid.shape


def test_device_resolve_rejects_unknown_init():
    class Weird(F.ConnectivityInit):
        pass

    with pytest.raises(NotImplementedError, match="device-side"):
        DI.device_resolve(Weird(), _key(0), 4, 4)


def test_as_device_weight_rejects_numpy_callables():
    with pytest.raises(TypeError, match="dual-backend"):
        DI.as_device_weight(lambda rng, shape: rng.random(shape))
    with pytest.raises(TypeError, match="dual-backend"):
        DI.as_device_delay(lambda rng, shape: rng.integers(0, 3, shape))


def test_weight_snippets_dual_backend():
    rng = np.random.default_rng(0)
    for w in (F.ConstantWeight(0.3), F.UniformWeight(-1.0, 1.0),
              F.NormalWeight(0.0, 2.0)):
        h = w(rng, (50, 8))
        d = _np(w.device(_key(0), (50, 8)))
        assert h.shape == d.shape and h.dtype == d.dtype == np.float32
        assert abs(h.mean() - d.mean()) < 0.3
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    assert (F.UniformWeight(0.0, 0.5)(r1, (20, 3))
            == (0.5 * r2.random((20, 3))).astype(np.float32)).all()


# ---------------------------------------------------------------------------
# post-sharding partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4, 7])
def test_partition_ell_by_post_reconstructs(n_shards):
    post, g, valid = DI.device_fixed_probability(_key(4), 30, 53, 0.2,
                                                 F.UniformWeight(0, 1))
    ell = F.ELLSynapses(g=torch.where(valid, g, torch.zeros(())),
                        post_ind=post, valid=valid, n_post=53)
    G, PL, V, DL, S, KL = DI.partition_ell_by_post(ell, n_shards)
    assert DL is None
    assert G.shape == (n_shards, 30, KL)
    assert int(V.sum()) == int(valid.sum())
    dense = _np(F.ell_to_dense(ell))
    rec = np.zeros((30, S * n_shards), np.float32)
    for d in range(n_shards):
        sub = F.ELLSynapses(g=G[d], post_ind=PL[d], valid=V[d], n_post=S)
        rec[:, d * S:(d + 1) * S] = _np(F.ell_to_dense(sub))
    assert np.array_equal(rec[:, :53], dense)
    assert _np(PL)[_np(V)].max() < S


def test_partition_preserves_slot_order():
    post = torch.tensor([[5, 0, 9, 2, 7]], dtype=torch.int32)
    g = torch.tensor([[1., 2., 3., 4., 5.]])
    valid = torch.ones((1, 5), dtype=torch.bool)
    ell = F.ELLSynapses(g=g, post_ind=post, valid=valid, n_post=10)
    G, PL, V, _, S, KL = DI.partition_ell_by_post(ell, 2)
    assert G[0][0][V[0][0]].tolist() == [2.0, 4.0]
    assert G[1][0][V[1][0]].tolist() == [1.0, 3.0, 5.0]


# ---------------------------------------------------------------------------
# ModelSpec device build
# ---------------------------------------------------------------------------

def test_spec_device_build_runs_and_is_device_count_free():
    from repro_torch.core.models.izhikevich_net import (IzhikevichNetConfig,
                                                        compile_model)
    cfg = IzhikevichNetConfig(n_total=80, n_conn=16, seed=5)
    m1 = compile_model(cfg, device="cpu", init="device")
    m2 = compile_model(cfg, device="cpu", init="device")
    for g1, g2 in zip(m1.network.synapses, m2.network.synapses):
        assert torch.equal(g1.ell.post_ind, g2.ell.post_ind)
        assert torch.equal(g1.ell.g, g2.ell.g)
    res = m1.run(20)
    assert bool(res.finite)


def test_spec_device_build_rejects_numpy_weight():
    from repro_torch.core.snn.spec import ModelSpec, SpecError
    s = ModelSpec("bad")
    s.add_neuron_population("a", 8, "izhikevich")
    s.add_synapse_population("aa", "a", "a", connect=F.FixedFanout(2),
                             weight=lambda r, shape: r.random(shape))
    with pytest.raises(SpecError, match="dual-backend"):
        s.build(dt=1.0, seed=0, init="device", device="cpu")
    s.build(dt=1.0, seed=0, init="host", device="cpu")


def test_spec_build_rejects_bad_init():
    from repro_torch.core.snn.spec import ModelSpec, SpecError
    s = ModelSpec("bad")
    s.add_neuron_population("a", 8, "izhikevich")
    with pytest.raises(SpecError, match="init"):
        s.build(init="gpu", device="cpu")


def test_device_init_local_peak_model_scales_per_device():
    n_pre, k = 4096, 64
    fused, gen = [], []
    for D in (1, 2, 4, 8):
        m = DI.construction_peak_model(n_pre, k, D, k_local=max(1, k // D),
                                       has_delay=True)
        fused.append(m["fused_local_bytes"])
        gen.append(m["generate_partition_bytes"])
        assert m == JDI.construction_peak_model(n_pre, k, D, max(1, k // D),
                                                has_delay=True)
    assert fused[1] < 0.75 * fused[0]
    assert fused[3] < 0.25 * fused[0]
    assert gen[3] > 0.5 * gen[0]
    assert fused[3] < gen[3]


# ---------------------------------------------------------------------------
# FixedProbability max_k overflow clamp
# ---------------------------------------------------------------------------

def test_fixed_probability_overflow_clamps_and_flags():
    key = _key(0)
    post, counts, over = DI._fixed_probability_rows(
        key, torch.arange(16), 100, 0.5, 10)
    assert int(counts.max()) <= 10
    assert bool(over.any())
    ckey = R.fold_in(key, 0xDE)
    raw = torch.stack([
        R.binomial(R.fold_in(R.fold_in(ckey, r), 1), 100, 0.5)
        for r in range(16)]).to(torch.int32)
    assert torch.equal(over, raw > 10)


def test_fixed_probability_overflow_trace_instant():
    from repro_torch.obs import trace
    trace.clear()
    DI._report_overflow(torch.tensor(3), n_pre=8, n_post=100, p=0.9, k=4)
    ev = [e for e in trace.events()
          if e.get("name") == "device_init.overflow"]
    assert len(ev) == 1
    args = ev[0]["args"]
    assert args["rows_clamped"] == 3 and args["max_k"] == 4
    trace.clear()
    DI._report_overflow(torch.tensor(0), n_pre=8, n_post=100, p=0.9, k=4)
    assert not [e for e in trace.events()
                if e.get("name") == "device_init.overflow"]


@pytest.mark.parametrize("p", [0.97, 1.0])
def test_fixed_probability_p_to_one_boundary(p):
    n_pre, n_post = 20, 40
    post, g, valid = DI.device_fixed_probability(_key(3), n_pre, n_post, p)
    post, valid = _np(post), _np(valid)
    assert post.shape[1] <= n_post
    deg = valid.sum(axis=1)
    if p == 1.0:
        assert (deg == n_post).all()
    else:
        assert deg.max() <= n_post and deg.min() >= 1
    for i in range(n_pre):
        vs = post[i, valid[i]]
        assert len(set(vs.tolist())) == len(vs)
        assert vs.min() >= 0 and vs.max() < n_post


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _tk(jk) -> torch.Tensor:
    a = np.asarray(jax.random.key_data(jk)).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy())


def _port(decl):
    """The port's declaration for a JAX formats dataclass (or a scalar)."""
    if decl is None or isinstance(decl, (int, float)):
        return decl
    cls = getattr(F, type(decl).__name__)
    return cls(*[getattr(decl, f) for f in decl.__dataclass_fields__])


def _bits(x) -> np.ndarray:
    a = _np(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_triples(j, t, weight=None):
    np.testing.assert_array_equal(_bits(t[0]), _bits(j[0]))
    np.testing.assert_array_equal(_bits(t[2]), _bits(j[2]))
    if isinstance(weight, JF.NormalWeight):
        # 4 ulp of the larger of the weight and its std * z term (mean +
        # std * z cancels near zero), as tests/test_torch_random.py holds
        a, b = _np(j[1]), _np(t[1])
        z = (a.astype(np.float64) - weight.mean) / weight.std
        mag = np.maximum(np.abs(a), np.abs(weight.std * z))
        assert (np.abs(a - b) <= 4 * np.spacing(
            mag.astype(np.float32))).all()
    else:
        np.testing.assert_array_equal(_bits(t[1]), _bits(j[1]))


PARITY_CASES = [
    # redraw sampler (k <= n_post / 2), weights with lo != 0 and lo = 0
    ("fanout_redraw", JF.FixedFanout(9), 40, 150, JF.UniformWeight(0.1, 0.7)),
    ("fanout_negative", JF.FixedFanout(40), 300, 2000,
     JF.UniformWeight(0.0, -1.0)),
    # top-k sampler (k > n_post / 2) and k == n_post
    ("fanout_topk", JF.FixedFanout(12), 30, 16, JF.UniformWeight(-1.3, 2.9)),
    ("fanout_all", JF.FixedFanout(8), 5, 8, 0.5),
    ("fanout_normal", JF.FixedFanout(9), 40, 150, JF.NormalWeight(0.1, 0.3)),
    # binomial: inversion (n q <= 10), BTRS, p >= 0.5, top-k targets
    ("prob_inversion", JF.FixedProbability(0.04), 60, 300, 2.0),
    ("prob_btrs", JF.FixedProbability(0.2), 41, 64, JF.UniformWeight(0, 1)),
    ("prob_half", JF.FixedProbability(0.5), 30, 100,
     JF.UniformWeight(0.0, -1.0)),
    ("prob_topk", JF.FixedProbability(0.97), 20, 40, None),
    ("one_to_one", JF.OneToOne(), 9, 9, 0.25),
    ("dense", JF.DenseInit(), 7, 13, JF.UniformWeight(-1.0, 1.0)),
]


@pytest.mark.parametrize("name,connect,n_pre,n_post,weight", PARITY_CASES,
                         ids=[c[0] for c in PARITY_CASES])
@pytest.mark.parametrize("chunks", [1, 3])
def test_device_resolve_equals_jax(name, connect, n_pre, n_post, weight,
                                   chunks):
    key = jax.random.PRNGKey(11)
    bounds = np.linspace(0, n_pre, chunks + 1).astype(int)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows = None if chunks == 1 else (lo, hi)
        j = JDI.device_resolve(connect, key, n_pre, n_post, weight,
                               rows=None if rows is None
                               else jnp.arange(lo, hi))
        t = DI.device_resolve(_port(connect), _tk(key), n_pre, n_post,
                              _port(weight),
                              rows=None if rows is None
                              else torch.arange(lo, hi))
        _assert_triples(j, t, weight)


@pytest.mark.parametrize("delay", [JF.UniformIntDelay(0, 20),
                                   JF.UniformIntDelay(2, 5),
                                   JF.ConstantDelay(2), 3])
def test_device_delays_equal_jax(delay):
    key = jax.random.PRNGKey(4)
    j = JDI.device_delays(key, 30, 17, delay)
    t = DI.device_delays(_tk(key), 30, 17, _port(delay))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(_np(t), np.asarray(j))
    j = JDI.device_delays(key, 30, 17, delay, rows=jnp.asarray([29, 3, 4]))
    t = DI.device_delays(_tk(key), 30, 17, _port(delay),
                         rows=torch.tensor([29, 3, 4]))
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_binomial_degrees_equal_jax_over_many_rows():
    """FixedProbability's degrees and targets over 20000 rows of each
    regime: every row equal here (the contract's floor is 99.9%)."""
    key = jax.random.PRNGKey(21)
    for n_post, p in ((300, 0.02), (200, 0.3)):
        k = JDI._binomial_slots(n_post, p)
        rows = jnp.arange(20_000)
        jp, jc, jo = JDI._fixed_probability_rows(key, rows, n_post, p, k)
        tp, tc, to = DI._fixed_probability_rows(_tk(key),
                                                torch.arange(20_000),
                                                n_post, p, k)
        share = float((_np(tc) == np.asarray(jc)).mean())
        print(f"FixedProbability({p}) at {n_post}: degrees equal on "
              f"{share:.6f} of 20000 rows")
        assert share == 1.0
        np.testing.assert_array_equal(_np(tp), np.asarray(jp))
        np.testing.assert_array_equal(_np(to), np.asarray(jo))


def _net(port: bool, cfg_kw: dict, max_delay=None):
    """The Izhikevich net of ``cfg_kw`` in the port or the JAX package,
    built with init="device"; with ``max_delay`` UniformIntDelay(0,
    max_delay) on the excitatory synapse population (chip_smoke's phase 5
    net)."""
    if port:
        from repro_torch.core.models import izhikevich_net as IZ
        from repro_torch.core.snn.spec import ModelSpec
        fm, kw = F, {"device": "cpu"}
    else:
        from repro.core.models import izhikevich_net as IZ
        from repro.core.snn.spec import ModelSpec
        fm, kw = JF, {}
    cfg = IZ.IzhikevichNetConfig(**cfg_kw)
    ms = IZ.spec(cfg)
    if max_delay is not None:
        base, ms = ms, ModelSpec(f"{ms.name}_delayed")
        for pop in base.populations.values():
            ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                     pop.input_fn)
        for sp in base.synapses:
            ms.add_synapse_population(
                sp.name, sp.pre, list(sp.post), sp.connect, sp.weight,
                representation="sparse",
                delay=(fm.UniformIntDelay(0, max_delay) if sp.name == "exc"
                       else None))
    return ms.build(dt=cfg.dt, seed=cfg.seed, init="device", **kw)


@pytest.mark.parametrize("delayed", [False, True])
def test_spec_device_build_equals_jax(delayed):
    """Every group's post_ind, g bits, valid and delay equal the JAX
    package's ``build(init="device")`` (split by post population), and the
    net's run equals JAX's run of its own device-built net under
    tests/test_torch_slice.py's tolerances (rasters agree on >= 99.8% of
    neuron-steps, rates within the 0.2% allowance)."""
    cfg_kw = dict(n_total=200, n_conn=30, seed=5)
    max_delay = 7 if delayed else None
    jm, tm = _net(False, cfg_kw, max_delay), _net(True, cfg_kw, max_delay)
    assert [g.name for g in jm.network.synapses] == \
        [g.name for g in tm.network.synapses]
    for a, b in zip(jm.network.synapses, tm.network.synapses):
        assert a.representation == b.representation
        for f in ("post_ind", "g", "valid", "delay"):
            x, y = getattr(a.ell, f), getattr(b.ell, f)
            if x is None:
                assert y is None
                continue
            np.testing.assert_array_equal(_bits(y), _bits(np.asarray(x)))
    jr = jm.run(200, record_raster=True)
    tr = tm.run(200, record_raster=True)
    for k in jr.spike_counts:
        agree = float((np.asarray(jr.raster[k]) == _np(tr.raster[k])).mean())
        assert agree >= 0.998, (k, agree)
    for pop in ("exc", "inh"):
        assert abs(float(jr.rates_hz[pop]) - float(tr.rates_hz[pop])) <= \
            (1.0 - 0.998) * 1e3


def test_device_build_digest_is_chunking_free():
    """experiments/device_init_digests.py: the JAX package's chunked digest
    equals its whole build's and the port's build's (the check
    chip_smoke's phase 12 makes at full width)."""
    from experiments import device_init_digests as DG
    from experiments import graph_digest as GD
    cfg_kw = dict(n_total=300, n_conn=40, representation="sparse",
                  seed=DG.SEED)
    for max_delay in (None, DG.DELAY_MAX):
        delayed = max_delay is not None
        whole = DG.whole_digest(300, 40, delayed)
        assert DG.chunked_digest(300, 40, delayed, chunk=70) == whole
        tm = _net(True, cfg_kw, max_delay)
        assert GD.graph_digest(
            (g.name, {f: getattr(g.ell, f) for f in GD.FIELDS})
            for g in tm.network.synapses) == whole


def test_mushroom_body_device_build_raises_as_jax():
    """KC_DN's weight is a numpy lambda: both packages refuse a device
    build with the same SpecError."""
    from repro.core.models import mushroom_body as JMB
    from repro.core.snn.spec import SpecError as JSpecError
    from repro_torch.core.models import mushroom_body as TMB
    from repro_torch.core.snn.spec import SpecError
    with pytest.raises(JSpecError) as je:
        JMB.compile_model(JMB.MushroomBodyConfig(), init="device")
    with pytest.raises(SpecError) as te:
        TMB.compile_model(TMB.MushroomBodyConfig(), device="cpu",
                          init="device")
    jmsg, tmsg = str(je.value), str(te.value)
    assert tmsg.split(", got ")[0] == jmsg.split(", got ")[0]
    assert "KC_DN" in tmsg and "dual-backend" in tmsg


def test_redraw_rounds_are_traced():
    from repro_torch.obs import trace
    trace.clear()
    DI.device_fixed_fanout(_key(0), 50, 400, 100)
    ev = [e["args"] for e in trace.events()
          if e.get("name") == "device_init.redraw"]
    assert len(ev) == 1 and ev[0]["rows"] == 50 and ev[0]["k"] == 100
    assert 1 <= ev[0]["rounds"] < 64


def test_triple_to_ell_keeps_tensors_and_checks_them():
    post, g, valid = DI.device_fixed_fanout(_key(2), 6, 10, 3)
    ell = F.triple_to_ell(post, g, valid, 10)
    assert ell.post_ind is post and ell.g is g and ell.valid is valid
    with pytest.raises(ValueError, match="outside"):
        F.triple_to_ell(post, g, valid, 5)
    with pytest.raises(ValueError, match="negative"):
        F.triple_to_ell(post, g, valid, 10,
                        delay=torch.full(post.shape, -1, dtype=torch.int32))
