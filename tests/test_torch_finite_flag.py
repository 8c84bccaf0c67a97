"""The NaN guard's ``finite`` flag in repro_torch, on the CPU: a NaN or an
Inf put into one batch member's Isyn trips that member's flag and no
other, whether its population advances through a fused kernel's route (the
kernel writes the flag in its epilogue; its plain version here folds
``isfinite`` over the same outputs) or through codegen (the simulator's
fold), and the flags equal the JAX package's ``finite`` for each member
run alone on the same input.  The flag is a boolean: no tolerance.  (The
kernels' own flags against that fold on a card: tests/test_torch_cuda.py.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.snn.spec import ModelSpec as JaxSpec  # noqa: E402
from repro_torch.core import codegen  # noqa: E402
from repro_torch.core.snn import simulator as S  # noqa: E402
from repro_torch.core.snn.spec import ModelSpec  # noqa: E402
from repro_torch.kernels import hh_step as HH  # noqa: E402
from repro_torch.kernels import izhikevich_step as IZ  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

STEPS, BATCH, BAD = 20, 3, 1         # the member that gets the bad value
SIZES = {"izh": 30, "hh": 20}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(cls):
    ms = cls("flags")
    ms.add_neuron_population("izh", SIZES["izh"], "izhikevich")
    ms.add_neuron_population("hh", SIZES["hh"], "traubmiles_hh")
    return ms


def _stim(pop, value):
    rng = np.random.default_rng(0)
    stim = {"izh": 5 * rng.standard_normal((STEPS, BATCH, SIZES["izh"])),
            "hh": rng.uniform(0, 2, (STEPS, BATCH, SIZES["hh"]))}
    stim = {k: v.astype(np.float32) for k, v in stim.items()}
    if pop is not None:
        stim[pop][5, BAD, 3] = value
    return stim


def _codegen_twin(sim):
    """The same simulator with every population on codegen."""
    twin = S.Simulator(sim.net, dt=sim.dt, seed=sim.seed, device="cpu")
    twin._updates = {name: codegen.compile_sim(pop.model)
                     for name, pop in sim.net.populations.items()}
    return twin


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("pop", ["izh", "hh", None])
def test_one_members_bad_isyn_trips_only_its_flag(pop, value):
    stim = _stim(pop, value)
    model = _spec(ModelSpec).build(dt=0.5, seed=0, device="cpu")
    assert model.simulator.routes == {"izh": "izhikevich_step",
                                      "hh": "hh_step"}
    tstim = {k: torch.tensor(v) for k, v in stim.items()}
    flags = []
    for sim in (model.simulator, _codegen_twin(model.simulator)):
        res = sim.run(sim.init_state(BATCH), STEPS, stim=tstim)
        flags.append(res.finite.tolist())
    jm = _spec(JaxSpec).build(dt=0.5, seed=0)
    jax_flags = [bool(jm.run(STEPS, stim={k: v[:, b]
                                          for k, v in stim.items()}).finite)
                 for b in range(BATCH)]
    want = [pop is None or b != BAD for b in range(BATCH)]
    assert flags[0] == flags[1] == jax_flags == want


def test_step_does_not_write_the_previous_states_flag():
    """The fused routes clear a copy of the carried flag, never the flag
    of the state they were given."""
    model = _spec(ModelSpec).build(dt=0.5, seed=0, device="cpu")
    sim = model.simulator
    st = sim.init_state(BATCH)
    stim = {k: torch.tensor(v[5]) for k, v in _stim("hh", np.nan).items()}
    new, _ = sim.step(st, stim=stim)
    assert st.finite.tolist() == [True] * BATCH
    assert new.finite.tolist() == [b != BAD for b in range(BATCH)]


@pytest.mark.parametrize("kernel", ["izhikevich_step", "hh_step"])
def test_plain_versions_clear_the_flag_as_the_fold(kernel):
    rng = np.random.default_rng(1)
    shape = (4, 50)
    isyn = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    isyn[2, 7] = float("nan")
    isyn[3, 0] = float("inf")
    finite = torch.ones(4, dtype=torch.bool)
    if kernel == "hh_step":
        v = torch.full(shape, -60.0)
        m, h, n = (torch.full(shape, x) for x in (0.05, 0.6, 0.3))
        out = HH.hh_step(v, m, h, n, isyn, 0.1, finite=finite)
        state = out[:4]
        assert torch.equal(out[4], out[0] >= 0.0)
        assert torch.equal(out[4], TR.hh_step_ref(v, m, h, n, isyn, 0.1)[4])
    else:
        v, u = torch.full(shape, -65.0), torch.full(shape, -13.0)
        p = [torch.full((50,), x) for x in (0.02, 0.2, -65.0, 8.0)]
        state = IZ.izhikevich_step(v, u, isyn, *p, 1.0, finite=finite)[:2]
    fold = torch.ones(4, dtype=torch.bool)
    for x in state:
        fold &= torch.isfinite(x).all(dim=-1)
    assert torch.equal(finite, fold)
    assert finite.tolist() == [True, True, False, False]
