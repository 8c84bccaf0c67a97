"""The port's LM scaling law (``repro_torch.core.scaling``) against the JAX
package's on the CPU: ``probe_and_fit`` at fan-ins 64, 256 and 1024 (the
guarded probe's scale at each, and the fitted hyperbola: k1, k2, k3
within rtol 1e-6), the JAX tests' properties of both
(``tests/test_substrate.py``), ``ScalingPolicy``'s arithmetic, and the
probe's device rule (``cuda`` unless the caller asks for the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import scaling as JS  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import scaling as TS  # noqa: E402

FANINS = (64, 256, 1024)


def _probe_and_fit(module, key, **kw):
    """``module.probe_and_fit(key, FANINS)`` and the scale of each fan-in
    it probed (recorded from its calls of ``probe_scale_for_fanin``)."""
    probe, seen = module.probe_scale_for_fanin, []

    def recorded(*args, **kwargs):
        seen.append(probe(*args, **kwargs))
        return seen[-1]
    module.probe_scale_for_fanin = recorded
    try:
        return module.probe_and_fit(key, fanins=FANINS, **kw), seen
    finally:
        module.probe_scale_for_fanin = probe


@pytest.fixture(scope="module")
def probes():
    """Both packages' probe_and_fit at FANINS under key 1: (policy, the
    scale of each fan-in) for "jax" and "port"."""
    return {"jax": _probe_and_fit(JS, jax.random.PRNGKey(1)),
            "port": _probe_and_fit(TS, R.PRNGKey(1), device="cpu")}


def test_probe_scale_equals_jax(probes):
    # the i-th fan-in probed with fold_in(key, i) in both packages
    scales = probes["port"][1]
    assert len(scales) == len(FANINS)
    assert scales == probes["jax"][1]
    # dense Gaussian: scale ~ 1/sqrt(fan_in), so 64 -> 1024 is ~4
    assert 2.5 < scales[0] / scales[-1] < 6.0


def test_probe_and_fit_equals_jax(probes):
    jp, tp = probes["jax"][0], probes["port"][0]
    np.testing.assert_allclose([tp.k1, tp.k2, tp.k3],
                               [jp.k1, jp.k2, jp.k3], rtol=1e-6, atol=1e-12)
    s = tp.init_std(512)
    assert 0.0 < s < 1.0
    assert tp.residual_std(512, n_layers=10) < s


@pytest.mark.parametrize("k", [(1.0, 0.0, 0.0), (0.91, -5.3, 7.9e-5),
                               (2.5, 40.0, 1e-3)])
def test_policy_arithmetic_equals_jax(k):
    jp, tp = JS.ScalingPolicy(*k), TS.ScalingPolicy(*k)
    for f in (1, 64, 896, 4096):
        assert tp.scale(f) == jp.scale(f)
        assert tp.init_std(f) == jp.init_std(f)
        assert tp.residual_std(f, 24) == jp.residual_std(f, 24)
    assert TS.DEFAULT_POLICY == TS.ScalingPolicy(
        JS.DEFAULT_POLICY.k1, JS.DEFAULT_POLICY.k2, JS.DEFAULT_POLICY.k3)


def test_probe_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.probe_scale_for_fanin(R.PRNGKey(0), 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.probe_and_fit(R.PRNGKey(0), fanins=(64,))
