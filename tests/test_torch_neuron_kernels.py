"""repro_torch's fused neuron updates on the CPU: the plain versions against
the JAX package's Pallas kernels (interpret mode) and jnp references, and
against the port's own codegen'd models; the simulator's routing of
populations to the fused kernels (the CUDA kernels against the plain
versions on a card: tests/test_torch_cuda.py).

Tolerances: rtol=atol=2e-4 against the JAX package, and spike decisions may
differ on under 0.2% of neurons (tests/test_kernels.py: XLA contracts
multiply-adds and its ``n ** 4`` rounds otherwise).  Against the port's
codegen the plain versions are exact: they run the same PyTorch ops in the
same order."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.hh_step import hh_step_pallas  # noqa: E402
from repro.kernels.izhikevich_step import izhikevich_step_pallas  # noqa: E402
from repro_torch.core import codegen  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.snn import neurons as TN  # noqa: E402
from repro_torch.core.snn.network import Network  # noqa: E402
from repro_torch.core.snn.simulator import Simulator  # noqa: E402
from repro_torch.core.snn.spec import ModelSpec  # noqa: E402
from repro_torch.kernels import hh_step as HH  # noqa: E402
from repro_torch.kernels import izhikevich_step as IZ  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.sparse.formats import FixedFanout  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SPIKE_DISAGREEMENT = 0.002
HH_PARAMS = dict(TN.TRAUBMILES_HH.params)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _izh_inputs(shape, seed, per_neuron):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    v = rng.uniform(-80, 25, shape).astype(np.float32)
    u = rng.uniform(-20, 5, shape).astype(np.float32)
    isyn = (rng.standard_normal(shape) * 5).astype(np.float32)
    if per_neuron:
        r = rng.random(n).astype(np.float32)
        params = [(0.02 + 0.08 * r).astype(np.float32),
                  (0.25 - 0.05 * r).astype(np.float32),
                  (-65.0 + 15.0 * r * r).astype(np.float32),
                  (8.0 - 6.0 * r * r).astype(np.float32)]
    else:
        params = [np.full(n, x, np.float32) for x in (0.02, 0.2, -65.0, 8.0)]
    return v, u, isyn, params


def _hh_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-80, 30, shape).astype(np.float32)
    m, h, n = (rng.random(shape).astype(np.float32) for _ in range(3))
    isyn = (rng.standard_normal(shape) * 2).astype(np.float32)
    return v, m, h, n, isyn


def _t(*arrs):
    return [torch.tensor(a) for a in arrs]


# -- plain versions against the JAX package ----------------------------------

@pytest.mark.parametrize("n,dt", [(100, 1.0), (1000, 0.5), (4096, 1.0)])
def test_izhikevich_plain_matches_pallas_and_ref(n, dt):
    v, u, isyn, params = _izh_inputs((n,), seed=n, per_neuron=False)
    args = tuple(map(jnp.asarray, (v, u, isyn, *params)))
    pallas = izhikevich_step_pallas(*args, dt=dt, interpret=True)
    jref = JR.izhikevich_step_ref(*args, dt)
    out = IZ.izhikevich_step(*_t(v, u, isyn, *params), dt)
    for j in (pallas, jref):
        for a, b in zip(out[:2], j[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert (out[2].numpy() != np.asarray(j[2])).mean() < SPIKE_DISAGREEMENT


@pytest.mark.parametrize("n,substeps", [(128, 1), (1000, 5)])
def test_hh_plain_matches_pallas_and_ref(n, substeps):
    ins = _hh_inputs((n,), seed=n + substeps)
    args = tuple(map(jnp.asarray, ins))
    pallas = hh_step_pallas(*args, dt=0.1, substeps=substeps, interpret=True)
    jref = JR.hh_step_ref(*args, 0.1, substeps=substeps)
    out = HH.hh_step(*_t(*ins), 0.1, substeps=substeps)
    for j in (pallas, jref):
        for a, b in zip(out, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_batched_state_with_per_neuron_params_matches_jax_per_member():
    """[B, n] state with [n] params is B independent [n] updates."""
    b, n = 3, 700
    v, u, isyn, params = _izh_inputs((b, n), seed=5, per_neuron=True)
    out = IZ.izhikevich_step(*_t(v, u, isyn, *params), 1.0)
    hins = _hh_inputs((b, n), seed=6)
    hout = HH.hh_step(*_t(*hins), 0.1, substeps=5)
    for i in range(b):
        jv, ju, js = JR.izhikevich_step_ref(
            *map(jnp.asarray, (v[i], u[i], isyn[i], *params)), 1.0)
        np.testing.assert_allclose(out[0][i].numpy(), np.asarray(jv), **TOL)
        np.testing.assert_allclose(out[1][i].numpy(), np.asarray(ju), **TOL)
        assert (out[2][i].numpy() != np.asarray(js)).mean() < \
            SPIKE_DISAGREEMENT
        jh = JR.hh_step_ref(*(jnp.asarray(x[i]) for x in hins), 0.1)
        for a, j in zip(hout, jh):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(j), **TOL)


# -- plain versions against the port's codegen --------------------------------

@pytest.mark.parametrize("per_neuron", [False, True])
@pytest.mark.parametrize("dt", [1.0, 0.1])
def test_izhikevich_plain_equals_codegen(per_neuron, dt):
    v, u, isyn, params = _izh_inputs((4, 900), seed=11, per_neuron=per_neuron)
    tv, tu, ti, *tp = _t(v, u, isyn, *params)
    # scalar params as codegen reads a population's scalars: Python floats
    cg_params = dict(zip("abcd", tp if per_neuron
                         else [float(p[0]) for p in params]))
    state, spiked = codegen.compile_sim(TN.IZHIKEVICH)(
        {"V": tv, "U": tu}, cg_params,
        {"Isyn": ti, "dt": torch.tensor(dt, dtype=torch.float32)})
    out = kops.izhikevich_step(tv, tu, ti, *(cg_params[k] for k in "abcd"),
                               dt)
    assert torch.equal(out[0], state["V"])
    assert torch.equal(out[1], state["U"])
    assert torch.equal(out[2], spiked)
    assert 0 < int(spiked.sum()) < spiked.numel()


@pytest.mark.parametrize("substeps", [1, 5])
def test_hh_plain_equals_codegen(substeps):
    model = TN.make_traubmiles(substeps)
    v, m, h, n, isyn = _t(*_hh_inputs((3, 800), seed=substeps))
    state, above = codegen.compile_sim(model)(
        {"V": v, "m": m, "h": h, "n": n}, dict(model.params),
        {"Isyn": isyn, "dt": torch.tensor(0.1, dtype=torch.float32)})
    out = kops.hh_step(v, m, h, n, isyn, 0.1, substeps=substeps,
                       **model.params)
    for a, k in zip(out, "Vmhn"):
        assert torch.equal(a, state[k]), k
    assert torch.equal(out[0] >= 0.0, above)


# -- the simulator's routing ------------------------------------------------

def test_fused_kernel_table_matches_declarations_not_names():
    assert TN.fused_kernel(TN.IZHIKEVICH) == ("izhikevich_step", {})
    for k in (1, 3, 5):
        assert TN.fused_kernel(TN.make_traubmiles(k)) == (
            "hh_step", {"substeps": k})
    for model in (TN.POISSON, TN.LIF, TN.RULKOV_MAP):
        assert TN.fused_kernel(model) is None
    impostor = codegen.NeuronModel(
        name="izhikevich", state=dict(TN.IZHIKEVICH.state),
        params=dict(TN.IZHIKEVICH.params),
        sim_code="V = V + dt*(0.04*V*V + 5.0*V + 140.0 - U + Isyn)",
        threshold_code="V >= 29.99", reset_code="V = c\nU = U + d")
    assert TN.fused_kernel(impostor) is None
    renamed = codegen.NeuronModel(
        name="my_izhikevich", state=dict(TN.IZHIKEVICH.state),
        params=dict(TN.IZHIKEVICH.params), sim_code=TN.IZHIKEVICH.sim_code,
        threshold_code=TN.IZHIKEVICH.threshold_code,
        reset_code=TN.IZHIKEVICH.reset_code)
    assert TN.fused_kernel(renamed) == ("izhikevich_step", {})


def _mixed_net():
    ms = ModelSpec("mixed")
    ms.add_neuron_population("izh", 60, "izhikevich",
                             {"c": np.linspace(-65, -50, 60)})
    ms.add_neuron_population("hh", 40, TN.make_traubmiles(3))
    ms.add_neuron_population("hh_pn", 30, "traubmiles_hh",
                             {"gK": np.full(30, 1.43, np.float32)})
    ms.add_neuron_population("pois", 20, "poisson", {"rate_hz": 200.0})
    ms.add_neuron_population("lif", 25, "lif")
    ms.add_synapse_population("p_h", "pois", "hh", FixedFanout(10),
                              weight=0.5)
    ms.add_synapse_population("p_i", "pois", "izh", FixedFanout(20),
                              weight=5.0)
    ms.add_synapse_population("i_l", "izh", "lif", FixedFanout(10),
                              weight=3.0)
    return ms.build(dt=0.5, seed=3, device="cpu")


def test_populations_take_the_fused_route_or_codegen():
    model = _mixed_net()
    assert model.simulator.routes == {
        "izh": "izhikevich_step", "hh": "hh_step",
        "hh_pn": "codegen",          # per-neuron gK: not the kernel's function
        "pois": "codegen", "lif": "codegen"}
    assert TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=50, n_conn=5),
                             device="cpu").simulator.routes == {
        "exc": "izhikevich_step+drive", "inh": "izhikevich_step+drive"}


def test_fused_route_runs_what_codegen_ran():
    """The same net with every population forced onto codegen gives the
    same spikes and state bit for bit, on a batched run."""
    model = _mixed_net()
    codegen_sim = Simulator(model.network, dt=model.dt, seed=3, device="cpu")
    codegen_sim._updates = {name: codegen.compile_sim(pop.model)
                            for name, pop in model.network.populations.items()}
    rng = np.random.default_rng(0)
    stim = {"hh": torch.tensor(rng.uniform(0, 2, (80, 2, 40)),
                               dtype=torch.float32),
            "izh": torch.tensor(5 * rng.standard_normal((80, 60)),
                                dtype=torch.float32)}
    IZ.reset_launches()
    HH.reset_launches()
    runs = [sim.run(sim.init_state(2), 80, record_raster=True, stim=stim)
            for sim in (model.simulator, codegen_sim)]
    assert IZ.launches["izhikevich_step"] == HH.launches["hh_step"] == 0
    fused, plain = runs
    for pop in model.network.populations:
        assert torch.equal(fused.raster[pop], plain.raster[pop]), pop
        for var, x in fused.state.neurons[pop].items():
            assert torch.equal(x, plain.state.neurons[pop][var]), (pop, var)
    assert int(fused.raster["izh"].sum()) > 0
    assert int(fused.raster["hh"].sum()) > 0
    assert bool(fused.finite.all())


def test_ops_entry_points_take_the_jax_signatures():
    v, u, isyn, _ = _izh_inputs((500,), seed=2, per_neuron=False)
    out = kops.izhikevich_step(*_t(v, u, isyn), 0.02, 0.2, -65.0, 8.0, 1.0)
    ref = JR.izhikevich_step_ref(*map(jnp.asarray, (v, u, isyn)), 0.02, 0.2,
                                 -65.0, 8.0, 1.0)
    assert out[0].shape == out[2].shape == (500,)
    assert out[2].dtype == torch.bool
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
    ins = _hh_inputs((300,), seed=4)
    hout = kops.hh_step(*_t(*ins), 0.1, substeps=2, gK=2.0)
    href = JR.hh_step_ref(*map(jnp.asarray, ins), 0.1, substeps=2, gK=2.0)
    for a, b in zip(hout, href):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
