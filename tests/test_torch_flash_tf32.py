"""The float32 flash-attention route's arithmetic (``csrc/flash_attention.cu``:
every product on the tensor cores as 3xTF32), emulated in torch on the CPU.

The kernels split each operand a into hi = tf32(a) and lo = tf32(a - hi),
rounded to nearest with ties away from zero, and sum each product 8 of
the contraction at a time (one m16n8k8 mma) as lo.hi, then hi.lo, then
hi.hi, each step added to the running float32 sum; everything else
(scale, softcap, masks, exp, the online softmax, lse, delta, dS) stays
float32.  The forward walks key tiles
of the plan's width with the online softmax; the backward computes S and
dP once per pair of tiles, accumulates dV/dK over the queries and dQ over
the keys in steps of 8, and adds a KV head's query-head partials in order.
Here that arithmetic is held to the route's fixed tolerances (forward
rtol = atol = 2e-5; backward rtol = 5e-4, atol = 5e-5, chip_smoke.py's
FLASH_BWD_TOL) against float64 and against the plain versions
(``ref.flash_attention_fwd_ref`` / ``_bwd_ref``), on scaled-down versions
of chip_smoke.py's float32 flash cases; and one TF32 pass (hi.hi alone) is
shown to miss them.  No jax: the arithmetic has no counterpart in the JAX
package (tests/test_torch_flash_attention.py holds the port to it)."""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

FWD_TOL = 2e-5
BWD_RTOL, BWD_ATOL = 5e-4, 5e-5
NEG_INF = -1e30               # the kernels' finite start of the row max


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (add half of the dropped unit to the magnitude's bits,
    then clear the 13 dropped bits)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, split: bool,
        acc: torch.Tensor = None) -> torch.Tensor:
    """acc + a @ b as the kernels' mma steps: the contraction 8 at a time,
    each step's lo.hi, hi.lo, then hi.hi (3xTF32), or hi.hi alone (one
    TF32 pass), summed in a fresh accumulator that is added to acc in
    float32."""
    if acc is None:
        acc = a.new_zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ahi, bhi = _tf32(ak), _tf32(bk)
        step = ahi @ bhi
        if split:
            step = (_tf32(ak - ahi) @ bhi + ahi @ _tf32(bk - bhi)) + step
        acc = acc + step
    return acc


def _mask(tq, tk, causal, window=None, prefix=None, q_offset=0, **_):
    qpos = torch.arange(tq)[:, None] + q_offset
    kpos = torch.arange(tk)[None, :]
    ok = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        cm = kpos <= qpos
        if prefix is not None:
            cm = cm | ((kpos < prefix) & (qpos < prefix))
        ok &= cm
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def _logits(s, scale, softcap):
    """(capped logits, tanh) of the raw products, in float32 as the
    kernels compute them."""
    raw = s * scale
    if softcap is None:
        return raw, None
    th = torch.tanh(raw / softcap)
    return softcap * th, th


def emulate_fwd(q, k, v, *, causal=True, window=None, q_offset=0,
                softcap=None, prefix=None, split=True):
    """(out, lse): the forward kernel's online softmax over the plan's key
    tiles, its products by ``_mm``."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    bk = FA.launch_plan(torch.float32, b, hq, hkv, tq, tk, d)["fwd"]["bk"]
    kx, vx = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    mask = _mask(tq, tk, causal, window, prefix, q_offset)
    m = torch.full((b, hq, tq), NEG_INF)
    l = torch.zeros(b, hq, tq)
    o = torch.zeros(b, hq, tq, d)
    for k0 in range(0, tk, bk):
        kt, vt = kx[:, :, k0:k0 + bk], vx[:, :, k0:k0 + bk]
        x, _ = _logits(_mm(q, kt.transpose(-1, -2), split), scale, softcap)
        x = torch.where(mask[:, k0:k0 + bk], x, -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = _mm(p, vt, split, acc=o * alpha[..., None])
        m = m_new
    lse = torch.where(l > 0, m + torch.log(l), torch.tensor(-math.inf))
    return o / l.clamp_min(1e-37)[..., None], lse


def gqa_sum(part: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Hq, Tk, D] partials -> [B, Hkv, Tk, D]: each KV head's query
    heads added in order h = 0, 1, .. (the sum kernel's fixed order)."""
    b, hq = part.shape[:2]
    g = part.reshape(b, hkv, hq // hkv, *part.shape[2:])
    return functools.reduce(torch.add, g.unbind(2))


def emulate_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                q_offset=0, softcap=None, prefix=None, split=True):
    """(dq, dk, dv) as the backward kernels compute them: delta = rowsum(dO
    O); S = K Q^T and dP^T = V dO^T over D, P and dS in float32; dV = P^T
    dO and dK = dS^T Q over the queries, dQ = dS K over the keys (all by
    ``_mm``); the GQA partials summed in order."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kx, vx = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    delta = (do * o).sum(-1)
    mask = _mask(tq, tk, causal, window, prefix, q_offset)
    live = mask & (lse > -math.inf)[..., None]
    st = _mm(kx, q.transpose(-1, -2), split).transpose(-1, -2)
    dpt = _mm(vx, do.transpose(-1, -2), split).transpose(-1, -2)
    capped, th = _logits(st, scale, softcap)
    p = torch.where(live, torch.exp(capped - lse[..., None]),
                    torch.zeros(()))
    ds = p * (dpt - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    ds = ds * scale
    dv = _mm(p.transpose(-1, -2), do, split)
    dk = _mm(ds.transpose(-1, -2), q, split)
    dq = _mm(ds, kx, split)
    if rep > 1:
        dk, dv = gqa_sum(dk, hkv), gqa_sum(dv, hkv)
    return dq, dk, dv


def _f64_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                   softcap=None, prefix=None):
    """Dense softmax attention in float64 (rows that see no key give 0)."""
    b, hq, tq, d = q.shape
    rep = hq // k.shape[1]
    kx, vx = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    x = q @ kx.transpose(-1, -2) / math.sqrt(d)
    if softcap is not None:
        x = softcap * torch.tanh(x / softcap)
    mask = _mask(tq, k.shape[2], causal, window, prefix, q_offset)
    x = torch.where(mask, x, -math.inf)
    w = torch.softmax(x, -1)
    w = torch.where(mask.any(-1, keepdim=True), w, torch.zeros((),
                                                                 dtype=w.dtype))
    return w @ vx


# name, (B, Hq, Hkv, Tq, Tk, D), options: chip_smoke.py's float32 flash
# cases scaled down (the causal GQA prefill/training shape, softcap 30,
# prefix 100, non-causal ragged T = 200, q_offset, whisper's cross-attention
# with Tq != Tk, and paligemma's D = 256 with a prefix of 200 at 2 query
# heads over 1)
CASES = [
    ("causal_gqa", (1, 4, 2, 256, 256, 64), {"causal": True}),
    ("softcap", (1, 4, 2, 256, 256, 64), {"causal": True, "softcap": 30.0}),
    ("prefix", (1, 4, 2, 256, 256, 64), {"causal": True, "prefix": 100}),
    ("noncausal_ragged", (2, 4, 4, 200, 200, 64), {"causal": False}),
    ("q_offset", (1, 4, 2, 256, 256, 64), {"causal": True, "q_offset": 100}),
    ("cross", (2, 2, 2, 37, 300, 64), {"causal": False}),
    ("d256_prefix200", (1, 2, 1, 456, 456, 256),
     {"causal": True, "prefix": 200}),
]


def _inputs(shape, seed):
    b, hq, hkv, tq, tk, d = shape
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
                      (b, hq, tq, d))]


def _share(got, want, rtol, atol) -> float:
    """Largest |got - want| / (atol + rtol |want|): <= 1 is within."""
    return float(((got.double() - want.double()).abs()
                  / (atol + rtol * want.double().abs())).max())


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                  # a tf32 value: kept
    half = 2.0 ** -11                       # half a tf32 unit at 1
    a = torch.tensor([one, 1.0 + half, 1.0 + half * 0.99, -(1.0 + half),
                      0.0, 3.0], dtype=torch.float32)
    assert _tf32(a).tolist() == [one, one, 1.0, -one, 0.0, 3.0]
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(v)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((v - hi).abs() <= hi.abs() * 2.0 ** -11)
    # the remainder is a tf32 value too: hi + lo holds 22 of 24 bits
    lo = _tf32(v - hi)
    assert torch.all((v - hi - lo).abs() <= v.abs() * 2.0 ** -21)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_forward_holds_the_float32_tolerance(name, shape, kw):
    """The emulated forward (out and lse) within rtol = atol = 2e-5 of
    float64 and of the plain float32 version."""
    q, k, v, _ = _inputs(shape, seed=len(name))
    out, lse = emulate_fwd(q, k, v, **kw)
    want64 = _f64_attention(q.double(), k.double(), v.double(), **kw)
    ref, ref_lse = R.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(out.double(), want64, rtol=FWD_TOL,
                               atol=FWD_TOL)
    torch.testing.assert_close(out, ref, rtol=FWD_TOL, atol=FWD_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_backward_holds_the_float32_tolerance(name, shape, kw):
    """The emulated gradients within (rtol 5e-4, atol 5e-5) of autograd
    through the float64 attention and of the plain float32 backward on the
    same saved (out, lse)."""
    q, k, v, g = _inputs(shape, seed=10 + len(name))
    out, lse = R.flash_attention_fwd_ref(q, k, v, **kw)
    got = emulate_bwd(q, k, v, out, lse, g, **kw)
    ins = [x.double().requires_grad_(True) for x in (q, k, v)]
    want64 = torch.autograd.grad(_f64_attention(*ins, **kw), ins, g.double())
    want = R.flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    for gname, a, w64, w in zip("qkv", got, want64, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        torch.testing.assert_close(a.double(), w64, rtol=BWD_RTOL,
                                   atol=BWD_ATOL, msg=lambda m: f"d{gname}: "
                                   f"{m}")
        torch.testing.assert_close(a, w, rtol=BWD_RTOL, atol=BWD_ATOL,
                                   msg=lambda m: f"d{gname}: {m}")


@pytest.mark.parametrize("name", ["causal_gqa", "d256_prefix200"])
def test_one_tf32_pass_misses_the_tolerance(name):
    """hi.hi alone (one TF32 pass) leaves the forward and the backward
    outside the fixed tolerances, where 3xTF32 is far inside them: the
    split is needed."""
    shape, kw = next((s, k) for n, s, k in CASES if n == name)
    q, k, v, g = _inputs(shape, seed=len(name))
    want = _f64_attention(q.double(), k.double(), v.double(), **kw)
    share = {split: _share(emulate_fwd(q, k, v, split=split, **kw)[0], want,
                           FWD_TOL, FWD_TOL) for split in (True, False)}
    assert share[False] > 1.0 > 10 * share[True], share
    out, lse = R.flash_attention_fwd_ref(q, k, v, **kw)
    ins = [x.double().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(_f64_attention(*ins, **kw), ins, g.double())
    bshare = {split: max(_share(a, w, BWD_RTOL, BWD_ATOL) for a, w in zip(
        emulate_bwd(q, k, v, out, lse, g, split=split, **kw), want))
        for split in (True, False)}
    assert bshare[False] > 1.0 > 10 * bshare[True], bshare


def test_gqa_sum_is_in_a_fixed_order():
    """The KV head's gradient is its query heads' partials added in order
    h = 0, 1, ..: repeatable bit for bit, and not the same bits as another
    order (so the order is the kernels' to fix, not the hardware's)."""
    g = torch.Generator().manual_seed(1)
    part = torch.randn(2, 14, 256, 64, generator=g)
    got = gqa_sum(part, 2)
    assert torch.equal(got, gqa_sum(part.clone(), 2))
    for h in range(2):
        want = part[:, 7 * h]
        for r in range(1, 7):
            want = want + part[:, 7 * h + r]
        assert torch.equal(got[:, h], want)
    backwards = gqa_sum(part.flip(1), 2).flip(1)
    assert not torch.equal(got, backwards)
    torch.testing.assert_close(got, backwards, rtol=1e-6, atol=1e-6)
