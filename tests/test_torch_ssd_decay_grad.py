"""The chunked SSD's gradient where a chunk decays past float32's exp range.

Within a chunk, ``ssd_chunked`` weighs pairs (i, j) by exp(cum_i - cum_j),
which only the lower triangle (i >= j) keeps.  Above it cum_i - cum_j is
the chunk's decay, positive; past ~88 its exp overflows.  The JAX package
exponentiates before it masks (``jnp.where(mask, jnp.exp(diff), 0.0)``), so
its forward is right but reverse mode multiplies inf by 0: the dt gradient
turns NaN.  Mamba2 at full width reaches that within three AdamW steps
(``experiments/mamba2_loss_parity.py``: the JAX trainer's third loss is
NaN, the port's finite, the first two equal).  The port masks first
(``repro_torch.models.ssm.ssd_chunked``), so its gradients stay finite.

Held here: forwards equal; the port's gradients finite and equal to
autograd through the naive recurrence (``kernels.ref.ssd_scan_ref``), within
tests/test_torch_ssd_scan.py's gradient tolerance (rtol=5e-4 plus 2e-6 of
the largest entry); and equal to ``jax.grad`` of the JAX package's wherever
that is finite (all of it below the overflow; the reference's NaN past it
is ROADMAP Queue 3's, not held here)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as jssd_chunked  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

B, T, H, DH, DS = 1, 32, 2, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dt_value):
    rng = np.random.default_rng(4)
    return [rng.standard_normal((B, T, H, DH)).astype(np.float32),
            np.full((B, T, H), dt_value, np.float32),
            -np.ones(H, np.float32),
            rng.standard_normal((B, T, 1, DS)).astype(np.float32),
            rng.standard_normal((B, T, 1, DS)).astype(np.float32)]


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=5e-4,
                               atol=2e-6 * float(np.abs(b).max()))


def _port_grads(fn, arrs):
    ts = [torch.tensor(a, requires_grad=i < 2) for i, a in enumerate(arrs)]
    y = fn(*ts)
    y.sum().backward()
    return y.detach().numpy(), ts[0].grad.numpy(), ts[1].grad.numpy()


@pytest.mark.parametrize("dt_value", [0.5, 4.0],
                         ids=["decay_16", "decay_128"])
def test_chunked_ssd_gradient_past_the_exp_range(dt_value):
    arrs = _inputs(dt_value)
    ja = [jnp.asarray(a) for a in arrs]
    jy = np.asarray(jssd_chunked(*ja))
    jgx, jgdt = (np.asarray(g) for g in jax.grad(
        lambda x, dt: jssd_chunked(x, dt, *ja[2:]).sum(),
        argnums=(0, 1))(ja[0], ja[1]))
    y, gx, gdt = _port_grads(TS.ssd_chunked, arrs)
    _, nx, ndt = _port_grads(TR.ssd_scan_ref, arrs)
    np.testing.assert_allclose(y, jy, rtol=2e-4, atol=2e-4)
    assert np.isfinite(gx).all() and np.isfinite(gdt).all()
    _close(gx, nx)
    _close(gdt, ndt)
    for got, ref in ((gx, jgx), (gdt, jgdt)):
        ok = np.isfinite(ref)
        if dt_value * T < 88:            # every exp in range
            assert ok.all()
        if ok.any():
            _close(got[ok], ref[ok])
