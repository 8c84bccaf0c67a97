"""The paper's gScale(nConn) experiment (``benchmarks/
gscale_experiments_torch.py``) against the JAX package's
(``benchmarks/gscale_experiments.py``) on the CPU, at a reduced size of
the example's net (300 neurons, 4 nConns, 8 candidates, 150 steps) and the
same seeds.

Allowance: the packages' rasters may disagree on 0.2% of neuron-steps (the
parity contract), so a pick may differ only where the two packages' picks
straddle their targets (one rate at or below, the other at or above) and
both lie within that allowance, 0.2% of a spike a neuron-step, of it.
Where every pick agrees (to float32 rounding of the grids), so must the
fit; where one differs, the port's fitted hyperbola must explain the JAX
package's picks within the JAX fit's MAPE plus the largest relative
difference between the packages' picks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import gscale_experiments as JEXP  # noqa: E402
from benchmarks import gscale_experiments_torch as TEXP  # noqa: E402
from repro_torch.core.conductance import hyperbola, mape  # noqa: E402

SIZE = dict(n_total=300, n_conns=(30, 90, 220, 300), n_steps=150,
            candidates=8)
DT_S = 1e-3                       # the Izhikevich net's dt, 1 ms
ALLOW_HZ = 0.002 / DT_S           # 0.2% of a spike a neuron-step
SAME = 1e-5                       # grids built in float32 by either package


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    port = TEXP.izhikevich_gscale_sweep(device="cpu", **SIZE)
    ref = JEXP.izhikevich_gscale_sweep(**SIZE)
    return port, ref


def test_picks_equal_the_jax_packages(both):
    port, ref = both
    assert port["n_conns"] == list(SIZE["n_conns"])
    assert abs(port["target_rate"] - float(ref["target_rate"])) <= ALLOW_HZ
    assert all(port["finite"])
    for i, n in enumerate(SIZE["n_conns"]):
        p, j = port["gscales"][i], float(ref["gscales"][i])
        if abs(p - j) <= SAME * abs(j):
            continue
        dp = port["rates"][i] - port["target_rate"]
        dj = float(ref["rates"][i]) - float(ref["target_rate"])
        assert dp * dj <= 0, (n, p, j, dp, dj)
        assert max(abs(dp), abs(dj)) <= ALLOW_HZ, (n, p, j, dp, dj)


def test_fits_agree_as_the_picks_imply(both):
    port, ref = both
    n = np.asarray(SIZE["n_conns"], float)
    jp = np.asarray(ref["gscales"], float)
    rel = float(np.max(np.abs(np.asarray(port["gscales"]) - jp) / jp))
    if rel <= SAME:
        for k in ("k1", "k2", "k3"):
            assert port[k] == pytest.approx(float(ref[k]), rel=1e-4,
                                            abs=1e-6), k
        assert port["mape_pct"] == pytest.approx(float(ref["mape_pct"]),
                                                 abs=1e-3)
    else:
        fit = hyperbola(n, port["k1"], port["k2"], port["k3"])
        assert mape(fit, jp) <= float(ref["mape_pct"]) + 100.0 * rel


def test_result_carries_the_runs_cost(both):
    port, _ = both
    k = len(SIZE["n_conns"])
    assert len(port["host_init_s"]) == len(port["candidates_per_s"]) == k
    assert all(s >= 0.0 for s in port["host_init_s"])
    assert all(c > 0.0 for c in port["candidates_per_s"])
    # the reference nConn reuses the reference build
    assert port["host_init_s"][-1] == port["ref_host_init_s"]
