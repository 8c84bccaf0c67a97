"""An Izhikevich population's whole step as one kernel, on the CPU.

``kernels.izhikevich_step`` takes a population's synapse-group
``currents``, its thalamic ``drive`` (``neurons.NormalInput``: the
normals of the member's input key, hashed in the kernel on the card) and
its ``stim``; the simulator hands them over in place of the summed input
it used to build op by op.  On the CPU the kernel's plain version runs
that same sequence of ops, so the fused route is the unfused one bit for
bit.  Held here:

- the plain fused step against the unfused sequence (zeros plus each
  current, the full-size draw sliced to the lanes' window, the stim, then
  the update), bit for bit: B = 1 and 3, one to three currents, with and
  without a stim ([B, n] and [n]), a whole and a padded lane window;
- ``Simulator.routes``: ``NormalInput`` Izhikevich populations on
  ``"izhikevich_step+drive"``, lambda-input and input-free ones on
  ``"izhikevich_step"``, HH and codegen'd ones as before, and a net of
  each kind equal to its lambda-input twin;
- 200 steps of a small Izhikevich net declared with ``NormalInput`` equal
  to the same net with lambda inputs (counts, rasters, every state tensor,
  key, ``finite``), eagerly and through ``run_compiled``'s chunks, and a
  population with more currents than a launch sums;
- the sharded engine with ``NormalInput`` drives at 1, 2 and 8 gloo ranks
  (populations that neither divides, so windows end in padded lanes)
  equal to the ``Simulator`` bit for bit (``_torch_izhikevich_drive_
  cases.py``: a group a world size, started with the module's first test,
  a worker process a rank, as ``_torch_dist.py`` runs them).
"""

import copy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_izhikevich_drive_cases as C  # noqa: E402
from _torch_dist import Groups, _equal  # noqa: E402
from _torch_engine_cases import leaves  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.snn import neurons as TN  # noqa: E402
from repro_torch.core.snn.spec import ModelSpec  # noqa: E402
from repro_torch.kernels import izhikevich_step as IZ  # noqa: E402
from repro_torch.sparse.formats import (FixedFanout,  # noqa: E402
                                        UniformWeight)

CASES = Path(C.__file__).resolve()
WORLDS = (1, 2, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory):
    """The engine's groups of 1, 2 and 8 ranks, started together with the
    module's first test (they run beside the tests before theirs)."""
    groups = Groups(CASES, WORLDS, tmp_path_factory, "drive")
    yield groups
    groups.wait_all()


def _bits(a, b, where=""):
    _equal(a, b, where)


# ---------------------------------------------------------------------------
# the plain fused step against the unfused sequence
# ---------------------------------------------------------------------------

N_POP = 70                    # the population; a window takes some lanes


def _inputs(batch, n_cur, seed):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))
    v = t(rng.uniform(-80.0, 25.0, (batch, N_POP)))
    u = t(rng.uniform(-20.0, 5.0, (batch, N_POP)))
    currents = [t(rng.normal(0.0, 4.0, (batch, N_POP)))
                for _ in range(n_cur)]
    r = rng.random(N_POP)
    params = [t(x) for x in (0.02 + 0.08 * r, 0.25 - 0.05 * r,
                             -65.0 + 15.0 * r * r, 8.0 - 6.0 * r * r)]
    return v, u, currents, params


@pytest.mark.parametrize("window", ["whole", "padded"])
@pytest.mark.parametrize("stim", ["none", "rows", "row"])
@pytest.mark.parametrize("n_cur", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 3])
def test_plain_fused_step_equals_the_unfused_sequence(batch, n_cur, stim,
                                                      window):
    seed = batch * 100 + n_cur * 10 + len(stim) + len(window)
    v, u, currents, params = _inputs(batch, n_cur, seed)
    rng = np.random.default_rng(seed + 1)
    if stim == "none":
        st = None
    else:
        st = torch.tensor(rng.normal(0.0, 6.0, (batch, N_POP) if stim ==
                                     "rows" else (N_POP,)).astype(np.float32))
    # a step's input keys: a strided column of its split, as the simulator
    # takes them; the window: all lanes, or a rank's lanes [13, 44) of a
    # population of 100 in a shard of N_POP lanes (the rest padded)
    keys = R.split(R.split(R.PRNGKey(seed), batch), 5)[:, 1]
    first, n_real, n_total = ((0, N_POP, N_POP) if window == "whole"
                              else (13, 31, 100))
    scale = 5.0
    if batch == 3:
        currents[0][1, 7] = float("nan")      # member 1's flag clears

    isyn = torch.zeros((batch, N_POP))
    for cur in currents:
        isyn = isyn + cur
    noise = R.normal(keys, (n_total,), scale=scale)[:, first:first + n_real]
    isyn = isyn + torch.nn.functional.pad(noise, (0, N_POP - n_real))
    if st is not None:
        isyn = isyn + st
    flag_a = torch.ones(batch, dtype=torch.bool)
    want = IZ.izhikevich_step(v, u, isyn, *params, 1.0, finite=flag_a)
    flag_b = torch.ones(batch, dtype=torch.bool)
    got = IZ.izhikevich_step(v, u, None, *params, 1.0, finite=flag_b,
                             currents=currents,
                             drive=(keys, scale, first, n_real), stim=st)
    for g, w, name in zip(got, want, ("v", "u", "spiked")):
        _bits(g, w, name)
    _bits(flag_b, flag_a, "finite")
    assert flag_b.tolist() == [b != 1 for b in range(batch)] \
        if batch == 3 else flag_b.tolist() == [True]
    assert 0 < int(got[2].sum()) < got[2].numel()


def test_fused_step_takes_isyn_or_currents():
    v, u, currents, params = _inputs(1, 1, 0)
    with pytest.raises(ValueError, match="isyn or currents"):
        IZ.izhikevich_step(v, u, currents[0], *params, 1.0,
                           currents=currents)
    with pytest.raises(ValueError, match="isyn or currents"):
        IZ.izhikevich_step(v, u, None, *params, 1.0)


# ---------------------------------------------------------------------------
# routes, and nets against their lambda-input twins
# ---------------------------------------------------------------------------

def _lambda(scale):
    return lambda keys, t, n: R.normal(keys, (n,), scale=scale)


def _twin(spec: ModelSpec) -> ModelSpec:
    """The same spec with each ``NormalInput`` a lambda of the same
    draw (the route that sums the input op by op)."""
    out = copy.deepcopy(spec)
    for p in out.populations.values():
        if isinstance(p.input_fn, TN.NormalInput):
            p.input_fn = _lambda(p.input_fn.scale)
    return out


def _mixed_spec():
    ms = ModelSpec("routes")
    ms.add_neuron_population("drive", 30, "izhikevich",
                             input_fn=TN.NormalInput(6.0))
    ms.add_neuron_population("lam", 20, "izhikevich",
                             input_fn=_lambda(6.0))
    ms.add_neuron_population("none", 10, "izhikevich")
    ms.add_neuron_population("hh", 12, TN.make_traubmiles(3),
                             input_fn=TN.NormalInput(2.0))
    ms.add_neuron_population("lif", 15, "lif", input_fn=TN.NormalInput(3.0))
    ms.add_synapse_population("d", "drive", ["lam", "none", "hh", "lif"],
                              FixedFanout(6), weight=UniformWeight(0, 2.0))
    ms.add_synapse_population("l", "lam", ["drive", "none"], FixedFanout(5),
                              weight=UniformWeight(0, -1.0))
    return ms


def _outcome(res):
    return {"counts": res.spike_counts, "raster": res.raster,
            "finite": res.finite, "state": leaves(res.state)}


def test_routes_send_normal_input_populations_to_the_fused_kernel():
    spec = _mixed_spec()
    sim = spec.build(dt=0.5, seed=1, device="cpu").simulator
    assert sim.routes == {"drive": "izhikevich_step+drive",
                          "lam": "izhikevich_step", "none": "izhikevich_step",
                          "hh": "hh_step", "lif": "codegen"}
    assert sim._takes_currents() == {"drive", "none"}
    twin = _twin(spec).build(dt=0.5, seed=1, device="cpu").simulator
    assert twin.routes["drive"] == "izhikevich_step"
    assert twin._takes_currents() == {"none"}
    got = sim.run(sim.init_state(2), 60, record_raster=True)
    want = twin.run(twin.init_state(2), 60, record_raster=True)
    _bits(_outcome(got), _outcome(want))
    assert int(got.spike_counts["drive"].sum()) > 0


NET = TIZ.IzhikevichNetConfig(n_total=150, n_conn=20, seed=11)
NET_STEPS = 200


@pytest.mark.parametrize("how", ["eager", "compiled"])
def test_normal_input_net_equals_its_lambda_twin(how):
    spec = TIZ.spec(NET)
    models = [s.build(dt=NET.dt, seed=NET.seed, device="cpu")
              for s in (spec, _twin(spec))]
    assert models[0].simulator.routes == {
        "exc": "izhikevich_step+drive", "inh": "izhikevich_step+drive"}
    keys = torch.tensor([[0, 3], [5, 1]], dtype=torch.int32)
    rng = np.random.default_rng(2)
    drive = torch.tensor(rng.normal(0.0, 3.0, (NET_STEPS, 2, 120)),
                         dtype=torch.float32)
    outs = []
    for m in models:
        st = m.init_state(2, key=keys)
        if how == "eager":
            res = m.simulator.run(st, NET_STEPS, record_raster=True,
                                  stim={"exc": drive})
        else:
            res = m.run(NET_STEPS, state=st, record_raster=True,
                        stim={"exc": drive})
        outs.append(_outcome(res))
    _bits(outs[0], outs[1])
    assert int(outs[0]["counts"]["exc"].sum()) > 0
    assert outs[0]["finite"].tolist() == [True, True]


def test_more_currents_than_a_launch_sums():
    """A population with 10 incoming groups: the first three are summed
    before the launch, in order, and the step equals the lambda twin's."""
    ms = ModelSpec("many")
    ms.add_neuron_population("src", 40, "izhikevich",
                             input_fn=TN.NormalInput(8.0))
    ms.add_neuron_population("dst", 25, "izhikevich",
                             input_fn=TN.NormalInput(3.0))
    for k in range(10):
        ms.add_synapse_population(f"g{k}", "src", "dst", FixedFanout(3),
                                  weight=UniformWeight(0, 1.5 + 0.1 * k))
    assert IZ.MAX_CURRENTS == 8
    outs = []
    for spec in (ms, _twin(ms)):
        m = spec.build(dt=1.0, seed=4, device="cpu")
        outs.append(_outcome(m.simulator.run(m.init_state(1), 40,
                                             record_raster=True)))
    _bits(outs[0], outs[1])
    assert int(outs[0]["counts"]["dst"].sum()) > 0


# ---------------------------------------------------------------------------
# the sharded engine at 1, 2 and 8 gloo ranks
# ---------------------------------------------------------------------------

_SIM = {}


def _simulator_run():
    if not _SIM:
        m = C.build()
        _SIM["out"] = C.run_case(m, lambda st: st)
    return _SIM["out"]


@pytest.mark.parametrize("world", WORLDS, ids=lambda d: f"D{d}")
def test_engine_with_a_drive_equals_the_simulator(groups, world):
    got = groups.get(world).case("drive")["global"]
    want = _simulator_run()
    assert got["routes"] == want["routes"] == {
        "exc": "izhikevich_step+drive", "inh": "izhikevich_step+drive"}
    _bits(got, want)
    assert int(got["counts"]["exc"].sum()) > 0
    assert int(got["counts"]["inh"].sum()) > 0
