"""repro_torch's Mamba2 SSD on the CPU against the JAX package: the port's
plain ``ssd_chunked`` and ``kernels.ops.ssd_scan`` (which takes the plain
version for CPU tensors) against JAX's naive ``ssd_scan_ref``, its
``ssd_chunked`` and its Pallas kernel in interpret mode, over the shapes of
tests/test_kernels.py plus t = 96 (one chunk of 96) and t = 1000 (chunks of
8 by the halving rule); and the ``SSDScan`` gradients against ``jax.grad``
of JAX's ``ssd_chunked``.  The CUDA kernel itself is held to the plain
version on a card in tests/test_torch_cuda.py.

Tolerances: outputs within rtol=atol=2e-4, as tests/test_kernels.py holds
the chunked forms to the recurrence; gradients within rtol=5e-4 plus an
absolute 2e-6 of the largest gradient entry (float32 sums in another
order: the dt gradient reaches ~1e2 at these shapes, and A's gradient is
one sum over b * t * dh terms of both signs, whose cancellation leaves
~1e-4 of relative rounding)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models.ssm import ssd_chunked as jssd_chunked  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [
    # b, t, h, dh, ds, chunk
    (2, 128, 4, 16, 16, 32), (1, 256, 8, 32, 32, 64), (2, 64, 2, 8, 64, 64),
    (1, 96, 2, 16, 16, 256), (1, 1000, 2, 8, 16, 256),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, h, dh, ds, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32),
            (0.001 + 0.1 * rng.random((b, t, h))).astype(np.float32),
            (-np.exp(rng.uniform(0, 2, h))).astype(np.float32),
            rng.standard_normal((b, t, 1, ds)).astype(np.float32),
            rng.standard_normal((b, t, 1, ds)).astype(np.float32),
            rng.standard_normal(h).astype(np.float32)]


def test_chunk_rule_halves_until_it_divides():
    assert TS.chunk_size(96, 256) == 96
    assert TS.chunk_size(1000, 256) == 8
    assert TS.chunk_size(4096, 256) == 256
    assert TS.chunk_size(100, 32) == 4


@pytest.mark.parametrize("b,t,h,dh,ds,chunk", SHAPES)
def test_ssd_matches_jax_ref_chunked_and_pallas(b, t, h, dh, ds, chunk):
    arrs = _inputs(b, t, h, dh, ds, seed=t + h)
    j = [jnp.asarray(a) for a in arrs]
    ref = np.asarray(JR.ssd_scan_ref(*j))
    jchk = np.asarray(jssd_chunked(*j, chunk=chunk))
    pls = np.asarray(ssd_scan_pallas(*j, chunk=chunk, interpret=True))
    ts = [torch.tensor(a) for a in arrs]
    SSD.reset_launches()
    outs = {"ssd_chunked": TS.ssd_chunked(*ts, chunk=chunk),
            "ops.ssd_scan": kops.ssd_scan(*ts),
            "ssd_scan_ref": TR.ssd_scan_ref(*ts)}
    assert SSD.launches == {"ssd_scan": 0, "ssd_scan.state": 0}
    for name, y in outs.items():
        assert y.shape == (b, t, h, dh) and y.dtype == torch.float32, name
        for want in (ref, jchk, pls):
            np.testing.assert_allclose(y.numpy(), want, **TOL, err_msg=name)


@pytest.mark.parametrize("b,t,h,dh,ds,chunk", [SHAPES[0], SHAPES[3],
                                               SHAPES[4]])
def test_ssd_scan_gradients_match_jax(b, t, h, dh, ds, chunk):
    arrs = _inputs(b, t, h, dh, ds, seed=7 + t)
    gy = np.random.default_rng(8).standard_normal((b, t, h, dh)) \
        .astype(np.float32)

    def f(*a):
        return jnp.sum(jssd_chunked(*a) * gy)

    jg = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, arrs))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    y = kops.ssd_scan(*ts)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    tg = torch.autograd.grad(y, ts, torch.tensor(gy))
    for name, a, g in zip(("x", "dt", "A", "B", "C", "D"), jg, tg):
        a = np.asarray(a)
        np.testing.assert_allclose(g.numpy(), a, rtol=5e-4,
                                   atol=2e-6 * np.abs(a).max(), err_msg=name)


def test_ssd_scan_gradient_skips_inputs_that_need_none():
    x, dt, A, B, C, D = map(torch.tensor, _inputs(1, 32, 2, 8, 8, seed=9))
    x.requires_grad_(True)
    y = kops.ssd_scan(x, dt, A, B, C, None)
    (gx,) = torch.autograd.grad(y.sum(), [x])
    want = torch.autograd.grad(TS.ssd_chunked(x, dt, A, B, C).sum(), [x])[0]
    torch.testing.assert_close(gx, want)


def test_fast_decay_never_exponentiates_the_upper_triangle():
    """dt * |A| large enough that exp(cum_i - cum_j) for j > i overflows:
    the chunked form and its gradient stay finite and equal the
    recurrence."""
    arrs = _inputs(1, 64, 2, 8, 8, seed=11)
    arrs[1][:] = 1.0
    arrs[2][:] = -50.0                          # cum spans -3200 a chunk
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    y = TS.ssd_chunked(*ts, chunk=64)
    grads = torch.autograd.grad(y.sum(), ts)
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(g).all() for g in grads)
    ref = TR.ssd_scan_ref(*[t.detach() for t in ts])
    torch.testing.assert_close(y.detach(), ref, **TOL)


def test_ssm_block_serving_waits_for_8_3():
    """The block's serving forms, which waited for ROADMAP item 8.3, run:
    the prompt with its state, the float32 caches and a decode step, whose
    output is the full-sequence block's at the next row."""
    cfg = TS.SSMConfig(d_model=32, d_state=8, d_head=8)
    p = TS.ssm_init(torch.Generator().manual_seed(0), cfg)
    u = torch.randn(1, 9, 32, generator=torch.Generator().manual_seed(1))
    full = TS.ssm_apply(p, cfg, u)
    assert full.shape == (1, 9, 32)
    y, (conv, ssd) = TS.ssm_apply(p, cfg, u[:, :8], return_state=True)
    torch.testing.assert_close(y, full[:, :8])
    cache = TS.ssm_init_cache(cfg, 1)
    assert cache["conv"].shape == conv.shape == (1, 3, 64 + 16)
    assert cache["ssd"].shape == ssd.shape == (1, 8, 8, 8)
    assert cache["conv"].dtype == cache["ssd"].dtype == torch.float32
    out, new = TS.ssm_decode_step(p, cfg, u[:, 8:9],
                                  {"conv": conv, "ssd": ssd})
    torch.testing.assert_close(out[:, 0], full[:, 8], rtol=1e-4, atol=1e-4)
    assert new["conv"].shape == conv.shape and new["ssd"].shape == ssd.shape
