"""The tensor-core SSD scan of repro_torch on the CPU: its host-side launch
plan (``kernels.ssd_scan.launch_plan``) held to the H100's limits, the
work count that its bound and the dry run's FLOPs read, and an emulation
of the kernel's arithmetic (``csrc/ssd_scan.cu``) in plain torch held to
JAX's naive recurrence ``repro.kernels.ref.ssd_scan_ref``.

The kernel carries each head's state transposed, S^T [dh, ds], in the
registers of its four warps, and runs the scan's four products (C B^T;
y^T = S^T C^T, its columns scaled by exp(cum); y^T += x^T (G o decay o
dt)^T; the state update (w x)^T B) on the tensor cores as 3xTF32: each
operand is split into hi = tf32(a) and lo = tf32(a - hi), both rounded to
nearest (ties away from zero), and a product sums lo.hi + hi.lo + hi.hi
in float32.  The emulation rounds by bit mask and follows the kernel's
chunk (``CHUNK`` rows) and its order of operations.  It holds to rtol =
atol = 2e-4 (tests/test_kernels.py's SSD tolerance) at Mamba2's widths (dh
64, ds 128) and t = 1024; one TF32 pass does not, so the split cannot be
dropped unnoticed.  The kernel itself is held to the plain version on a
card in tests/test_torch_cuda.py and chip_smoke.py (phase 2d)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

SMEM_MAX = 232_448            # dynamic shared memory one CTA may use (H100)
SM_BYTES = 233_472            # shared memory of one H100 SM
RESERVED = 1_024              # the runtime's share of every resident CTA
REGS_SM = 65_536              # registers of one SM
SMS = 132                     # SMs of an H100 SXM
INT_MAX = 2 ** 31 - 1
TOL = 2e-4
# 2d's shapes (training, t96, t1000, h4, h3_small; the prefills of mamba2
# and zamba2, t1037) and the families' head counts: mamba2's 80, zamba2's
# 112 (ds 64), 3
PLAN_SHAPES = ([s for _, s in chip_smoke.SSD_CASES]
               + [s for _, s in chip_smoke.SSD_STATE_CASES]
               + [(1, 512, 80, 64, 128), (4, 2048, 112, 64, 64),
                  (1, 64, 3, 64, 128), (2, 300, 3, 16, 64)])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _within_the_card(p, b, h):
    """A plan's two passes within one H100's limits."""
    scan, cb = p["scan"], p["cb"]
    assert p["passes"] == 2 and cb["threads"] == 256
    assert cb["smem"] <= 48 * 1024 and 1 <= cb["grid"][0] <= INT_MAX
    hg, ns = scan["heads"], scan["state_cols"]
    assert 1 <= hg <= SSD.MAX_HEADS[ns]
    # a head's warpgroup: 16 dh rows a warp
    assert scan["threads"] == SSD.HEAD_THREADS * hg <= 1024
    assert scan["grid"] == (b * -(-h // hg),) and scan["grid"][0] <= INT_MAX
    assert scan["cluster"] == (1, 1, 1) and scan["stages"] == 2
    assert scan["smem"] <= SMEM_MAX
    # one CTA an SM at the most heads fits the registers of the
    # __launch_bounds__; the CTAs an SM the plan counts fit both
    assert scan["max_regs"] <= 255 and scan["max_regs"] % 8 == 0
    assert SSD.HEAD_THREADS * SSD.MAX_HEADS[ns] * scan["max_regs"] \
        <= REGS_SM
    n = scan["ctas_per_sm"]
    assert n >= 1 and n * (scan["smem"] + RESERVED) <= SM_BYTES
    assert n * scan["threads"] * scan["max_regs"] <= REGS_SM


@pytest.mark.parametrize("dh", range(4, SSD.MAX_HEAD_DIM + 1, 4))
def test_plan_within_the_card_limits(dh):
    """For every (dh, ds) the wrapper takes, at the training shape's batch
    and heads: two passes, C B^T's 256 threads and static tiles within 48
    KB; the scan's warpgroup a head, its shared memory within a CTA's
    227 KB and the CTAs an SM it counts within the SM's shared memory and
    registers; grids within axis x (2^31 - 1), no cluster; the state's
    columns 64 where ds <= 64, else 128 (the tiles pad dh and ds with
    zeros to 64 rows and those columns, multiples of the mma's 8)."""
    for ds in range(4, SSD.MAX_STATE_DIM + 1, 4):
        p = SSD.launch_plan(2, 2048, 80, dh, ds)
        _within_the_card(p, 2, 80)
        assert p["scan"]["state_cols"] == (64 if ds <= 64 else 128)
        assert ds <= p["scan"]["state_cols"] and SSD.MAX_HEAD_DIM % 16 == 0


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("heads", [None, 1, 2, 3, 4, 6])
def test_plan_within_the_card_at_2ds_shapes(monkeypatch, shape, heads):
    """2d's shapes and the families' head counts, at the plan's own heads a
    CTA and at each one forced (``_choose_heads`` patched); a count past
    the state columns' ``MAX_HEADS`` is a CTA that no SM holds (0 resident
    by the occupancy model: its registers at the __launch_bounds__' count
    exceed the SM's), which the kernel refuses."""
    b, t, h, dh, ds = shape
    cols = 64 if ds <= 64 else 128
    if heads is not None:
        monkeypatch.setattr(SSD, "_choose_heads", lambda *_: heads)
    p = SSD.launch_plan(b, t, h, dh, ds)
    if heads is not None and heads > SSD.MAX_HEADS[cols]:
        assert p["scan"]["heads"] == heads and p["scan"]["ctas_per_sm"] == 0
        assert p["scan"]["threads"] * p["scan"]["max_regs"] > REGS_SM
        return
    _within_the_card(p, b, h)
    assert heads is not None or p["scan"]["heads"] <= h
    assert p["chunks"] == -(-t // SSD.CHUNK)
    assert p["scratch_bytes"] == 4 * b * p["chunks"] * SSD.CHUNK ** 2


def test_plan_fills_the_card_in_one_wave_at_the_training_shape():
    """Mamba2-2.7B's training shape (x [2, 2048, 80, 64], ds 128): C B^T
    for 2 x 64 chunks, then 80 scan CTAs of two heads each, all resident
    at once (one CTA an SM on 132 SMs); the serving prefills take two
    rounds of the card (an SM holds the state of three heads at ds 128,
    and two CTAs of two at ds 64); a t the chunk does not divide is masked
    by index."""
    p = SSD.launch_plan(2, 2048, 80, 64, 128)
    assert p["chunk"] == SSD.CHUNK and p["chunks"] == 2048 // SSD.CHUNK
    assert p["cb"]["grid"] == (2 * p["chunks"],)
    assert p["scan"]["heads"] == 2 and p["scan"]["grid"] == (80,)
    assert p["scan"]["ctas_per_sm"] == 1
    assert -(-p["scan"]["grid"][0] // (SMS * p["scan"]["ctas_per_sm"])) == 1
    # the Layout<128> of csrc/ssd_scan.cu: raw B and C [32][132] and G
    # [32][32] in float32; C and B^T split into hi and lo tiles of 32 x
    # 128 words; a head: G o decay o dt's hi and lo tiles of 32 x 32, dt
    # [32] and x [2][32][68] in float32
    assert p["scan"]["smem"] == 4 * (2 * 32 * 132 + 32 * 32) \
        + 4 * 4 * 32 * 128 + 2 * 4 * (2 * 32 * 32 + 32 + 2 * 32 * 68)
    assert p["scan"]["threads"] == 256
    assert p["cb"]["smem"] == 2 * 4 * 32 * 136
    assert p["scratch_bytes"] == 4 * 2 * 64 * 32 * 32
    for shape, heads, ctas, per_sm in (((8, 2048, 80, 64, 128), 3, 216, 3),
                                       ((8, 2048, 112, 64, 64), 2, 448, 4)):
        q = SSD.launch_plan(*shape)
        assert (q["scan"]["heads"], q["scan"]["grid"]) == (heads, (ctas,))
        assert q["scan"]["ctas_per_sm"] * heads == per_sm
        assert -(-ctas // (SMS * q["scan"]["ctas_per_sm"])) == 2
    small = SSD.launch_plan(1, 1000, 3, 16, 16)
    assert small["chunks"] == 32 and small["scan"]["state_cols"] == 64
    assert small["scan"]["grid"] == (-(-3 // small["scan"]["heads"]),)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chip_smoke_counts_work_at_the_kernels_chunk(monkeypatch, chunk):
    """The bound's count of work (chip_smoke._ssd_work: bytes, and the
    lower triangles of C B^T) and the dry run's FLOP formula (scan_flops:
    C B^T whole) count at a fixed chunk of 32 rows, whatever chunk the
    kernel takes, so that rows 6's bounds and the dry run's records stay as
    they were: both equal their values at PR 16's 32-row kernel at the
    training and prefill shapes."""
    monkeypatch.setattr(SSD, "CHUNK", chunk)
    assert SSD.WORK_CHUNK == 32
    want = {(2, 2048, 80, 64, 128): (11463032832, 173277824, 11446779904),
            (8, 2048, 80, 64, 128): (45852131328, 693109376, 45787119616),
            (8, 2048, 112, 64, 64): (34007416832, 955253632, 33974910976),
            (1, 1037, 80, 64, 128): (2900812032, 43869888, 2896728832)}
    for (b, t, h, dh, ds), (flops, nbytes, ops) in want.items():
        assert SSD.scan_flops((b, t, h, dh), (b, t, 1, ds)) == flops
        assert chip_smoke._ssd_work(b, t, h, dh, ds) == (nbytes, ops)


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


def _emulate(x, dt, A, B, C, D, split: bool, q: int = SSD.CHUNK,
             final_state: bool = False):
    """The kernel's chunked scan: chunks of q rows in turn (a t that q does
    not divide padded with zero rows), the state carried transposed (S^T
    [dh, ds]), the products by ``_mm`` in the kernel's orientation and
    order (y^T = (S^T C^T times exp(cum_i) on column i, plus x^T (G o decay
    o dt)^T, each product its own sum), plus D x; S^T = exp(total) S^T + (w
    x)^T B), the rest in float32 as the kernel computes it.  Returns y, and
    the final state [b, h, ds, dh] with ``final_state``."""
    b, t, h, dh = x.shape
    ds = B.shape[3]
    pad = -t % q
    if pad:
        x, dt, B, C = (torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], 1)
                       for v in (x, dt, B, C))
    St = x.new_zeros(b, h, dh, ds)
    tri = torch.ones(q, q, dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, t + pad, q):
        xt = x[:, c0:c0 + q].permute(0, 2, 3, 1)          # [b, h, dh, q]
        dtc = dt[:, c0:c0 + q].permute(0, 2, 1)           # [b, h, q]
        Bc, Cc = B[:, c0:c0 + q, 0], C[:, c0:c0 + q, 0]   # [b, q, ds]
        cum = torch.cumsum(dtc * A[None, :, None], dim=2)
        total = cum[:, :, -1:]
        G = _mm(Cc, Bc.transpose(1, 2), split)[:, None]   # [b, 1, q, q]
        diff = cum[:, :, :, None] - cum[:, :, None, :]
        dec = torch.exp(torch.where(tri, diff, torch.zeros(())))
        Gs = torch.where(tri, G * dec * dtc[:, :, None, :], torch.zeros(()))
        yt = _mm(St, Cc.transpose(1, 2)[:, None], split) \
            * torch.exp(cum)[:, :, None, :]
        yt = (yt + _mm(xt, Gs.transpose(-1, -2), split)) \
            + D[None, :, None, None] * xt
        ys.append(yt.permute(0, 3, 1, 2))                 # [b, q, h, dh]
        w = torch.exp(total - cum) * dtc
        St = St * torch.exp(total)[..., None] \
            + _mm(xt * w[:, :, None, :], Bc[:, None], split)
    y = torch.cat(ys, 1)[:, :t]
    return (y, St.transpose(-1, -2)) if final_state else y


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


@pytest.mark.parametrize("b,t,h,dh,ds", [(2, 333, 3, 64, 128),
                                         (1, 130, 5, 16, 64)])
def test_3xtf32_emulation_final_state_matches_the_jax_package(b, t, h, dh,
                                                              ds):
    """The prefill form: the emulated state after the last chunk (t = 333
    and 130 leave a last chunk of 13 and 2 rows, whose padded rows must
    leave the state as it was) and y against JAX's ``ssd_chunked(...,
    return_final_state=True)`` on the same numpy inputs, within 2e-4."""
    arrs = _inputs(b, t, h, dh, ds, seed=11 + t)
    ref_y, ref_s = (np.asarray(a) for a in JS.ssd_chunked(
        *map(jnp.asarray, arrs), return_final_state=True))
    y, state = _emulate(*[torch.tensor(a) for a in arrs], split=True,
                        final_state=True)
    assert state.shape == ref_s.shape == (b, h, ds, dh)
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state.numpy(), ref_s, rtol=TOL, atol=TOL)
