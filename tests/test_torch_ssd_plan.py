"""The tensor-core SSD scan of repro_torch on the CPU: its host-side launch
plan (``kernels.ssd_scan.launch_plan``) held to the H100's limits, and an
emulation of the kernel's arithmetic (``csrc/ssd_scan.cu``) in plain torch
held to JAX's naive recurrence ``repro.kernels.ref.ssd_scan_ref``.

The kernel runs the scan's four products (C B^T, the scaled G times x,
C S and the state update B^T (w x)) on the tensor cores as 3xTF32: each
operand is split into hi = tf32(a) and lo = tf32(a - hi), both rounded to
nearest (ties away from zero), and a product sums lo.hi + hi.lo + hi.hi
in float32.  The emulation rounds by bit mask and follows the kernel's
chunk (32 rows) and its order of operations.  It holds to rtol = atol =
2e-4 (tests/test_kernels.py's SSD tolerance) at Mamba2's widths (dh 64,
ds 128) and t = 1024; one TF32 pass does not, so the split cannot be
dropped unnoticed.  The kernel itself is held to the plain version on a
card in tests/test_torch_cuda.py and chip_smoke.py (phase 2d)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

SMEM_MAX = 232_448            # dynamic shared memory one CTA may use (H100)
SM_BYTES = 233_472            # shared memory of one H100 SM
RESERVED = 1_024              # the runtime's share of every resident CTA
SMS = 132                     # SMs of an H100 SXM
INT_MAX = 2 ** 31 - 1
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dh", range(4, SSD.MAX_HEAD_DIM + 1, 4))
def test_plan_within_the_card_limits(dh):
    """For every (dh, ds) the wrapper takes: two passes of 256 threads;
    the scan's shared memory within a CTA's 227 KB and three CTAs an SM
    (its __launch_bounds__), C B^T's static tiles within 48 KB; grids
    within axis x (2^31 - 1) and y (65535), and dh's blocks of 32 columns
    covering it (the tiles pad dh and ds with zeros to 32 and 128 columns,
    multiples of the mma's 8, whatever dh and ds are)."""
    for ds in range(4, SSD.MAX_STATE_DIM + 1, 4):
        p = SSD.launch_plan(2, 2048, 80, dh, ds)
        scan, cb = p["scan"], p["cb"]
        assert p["passes"] == 2 and p["threads"] == 256
        assert scan["smem"] <= SMEM_MAX and cb["smem"] <= 48 * 1024
        assert scan["ctas_per_sm"] == 3
        assert scan["ctas_per_sm"] * (scan["smem"] + RESERVED) <= SM_BYTES
        assert SSD.COLS % 8 == 0 and SSD.MAX_STATE_DIM % 8 == 0
        assert 1 <= scan["grid"][0] <= INT_MAX
        assert 1 <= scan["grid"][1] <= 65535
        assert 1 <= cb["grid"][0] <= INT_MAX
        cols = scan["grid"][1] * SSD.COLS
        assert dh <= cols < dh + SSD.COLS


def test_plan_fills_the_card_in_one_wave_at_the_training_shape():
    """Mamba2-2.7B's training shape (x [2, 2048, 80, 64], ds 128): C B^T
    for 2 x 64 chunks, then 320 scan CTAs of one (batch, head, 32
    columns) each, all resident at once (132 SMs x 3)."""
    p = SSD.launch_plan(2, 2048, 80, 64, 128)
    assert p["chunk"] == SSD.CHUNK == 32 and p["chunks"] == 64
    assert p["cb"]["grid"] == (128,)
    assert p["scan"]["grid"] == (160, 2)
    ctas = p["scan"]["grid"][0] * p["scan"]["grid"][1]
    assert -(-ctas // (SMS * p["scan"]["ctas_per_sm"])) == 1
    # every SM holds two or three: no SM runs a CTA alone
    assert 2 * SMS <= ctas <= 3 * SMS
    # the Smem struct of csrc/ssd_scan.cu: x [32][36], B [32][132], C
    # [32][136], S [128][36], G [32][40], C S's second half [32][36] in
    # float32, w x [32][34] in pairs
    assert p["scan"]["smem"] == 4 * (32 * 36 + 32 * 132 + 32 * 136
                                     + 128 * 36 + 32 * 40 + 32 * 36) \
        + 8 * 32 * 34
    assert p["cb"]["smem"] == 2 * 4 * 32 * 136
    assert p["scratch_bytes"] == 4 * 2 * 64 * 32 * 32
    # a t the chunk does not divide: the last chunk masked by index; dh
    # within one block of columns: one CTA a head
    small = SSD.launch_plan(1, 1000, 3, 16, 16)
    assert small["chunks"] == 32 and small["scan"]["grid"] == (3, 1)


def test_chip_smoke_counts_work_at_the_kernels_chunk():
    assert chip_smoke.SSD_Q == SSD.CHUNK


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated

def _tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (add half of the dropped unit to the magnitude's bits,
    then clear the 13 dropped bits)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b with tf32 operands: 3xTF32 (lo.hi + hi.lo, then hi.hi, in
    float32) or one pass (hi.hi)."""
    ahi, bhi = _tf32(a), _tf32(b)
    if not split:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def _emulate(x, dt, A, B, C, D, split: bool, q: int = SSD.CHUNK):
    """The kernel's chunked scan: chunks of q rows in turn (a t that q does
    not divide padded with zero rows), the products by ``_mm``, the rest
    in float32 as the kernel computes it."""
    b, t, h, dh = x.shape
    ds = B.shape[3]
    pad = -t % q
    if pad:
        x, dt, B, C = (torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], 1)
                       for v in (x, dt, B, C))
    S = x.new_zeros(b, h, ds, dh)
    tri = torch.ones(q, q, dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, t + pad, q):
        xc = x[:, c0:c0 + q].permute(0, 2, 1, 3)          # [b, h, q, dh]
        dtc = dt[:, c0:c0 + q].permute(0, 2, 1)           # [b, h, q]
        Bc, Cc = B[:, c0:c0 + q, 0], C[:, c0:c0 + q, 0]   # [b, q, ds]
        cum = torch.cumsum(dtc * A[None, :, None], dim=2)
        total = cum[:, :, -1:]
        G = _mm(Cc, Bc.transpose(1, 2), split)[:, None]   # [b, 1, q, q]
        diff = cum[:, :, :, None] - cum[:, :, None, :]
        dec = torch.exp(torch.where(tri, diff, torch.zeros(())))
        Gs = torch.where(tri, G * dec * dtc[:, :, None, :], torch.zeros(()))
        # C's rows carry y_inter's decay exp(cum_i) into C S
        Ce = torch.exp(cum)[..., None] * Cc[:, None]      # [b, h, q, ds]
        y = (xc * D[None, :, None, None] + _mm(Gs, xc, split)) \
            + _mm(Ce, S, split)
        ys.append(y.permute(0, 2, 1, 3))
        w = torch.exp(total - cum) * dtc
        S = S * torch.exp(total)[..., None] \
            + _mm(Bc.transpose(1, 2)[:, None], w[..., None] * xc, split)
    return torch.cat(ys, 1)[:, :t]


def _inputs(b, t, h, dh, ds, seed):
    """Seeded as chip_smoke.py's phase 2d seeds the kernel's inputs."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32),
            (0.001 + 0.1 * rng.random((b, t, h))).astype(np.float32),
            (-np.exp(2.0 * rng.random(h))).astype(np.float32),
            rng.standard_normal((b, t, 1, ds)).astype(np.float32),
            rng.standard_normal((b, t, 1, ds)).astype(np.float32),
            rng.standard_normal(h).astype(np.float32)]


def _share_of_tolerance(y: np.ndarray, ref: np.ndarray) -> float:
    """Largest |y - ref| / (atol + rtol |ref|): <= 1 is within 2e-4."""
    return float(np.max(np.abs(y - ref) / (TOL + TOL * np.abs(ref))))


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                  # a tf32 value: kept
    half = 2.0 ** -11                       # half a tf32 unit at 1
    a = torch.tensor([one, 1.0 + half, 1.0 + half * 0.99, -(1.0 + half),
                      0.0, 3.0], dtype=torch.float32)
    got = _tf32(a).tolist()
    assert got == [one, one, 1.0, -one, 0.0, 3.0]
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(v)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((v - hi).abs() <= hi.abs() * 2.0 ** -11)


@pytest.mark.parametrize("b,t,h,dh,ds", [(1, 1024, 4, 64, 128),
                                         (1, 520, 3, 64, 128)])
def test_3xtf32_emulation_holds_the_ssd_tolerance(b, t, h, dh, ds):
    """The kernel's 3xTF32 arithmetic against JAX's recurrence on the same
    numpy inputs, within rtol = atol = 2e-4 (t = 520: a last chunk of 8
    rows); one TF32 pass misses it."""
    arrs = _inputs(b, t, h, dh, ds, seed=3 + t)
    ref = np.asarray(JR.ssd_scan_ref(*map(jnp.asarray, arrs)))
    ts = [torch.tensor(a) for a in arrs]
    y3 = _emulate(*ts, split=True).numpy()
    assert y3.shape == ref.shape
    share3 = _share_of_tolerance(y3, ref)
    assert share3 <= 1.0, share3
    np.testing.assert_allclose(y3, ref, rtol=TOL, atol=TOL)
    share1 = _share_of_tolerance(_emulate(*ts, split=False).numpy(), ref)
    assert share1 > 1.0, share1
    # the emulated split is float32's equal: far inside the tolerance
    assert share3 < 0.2 < share1 / 10, (share3, share1)
