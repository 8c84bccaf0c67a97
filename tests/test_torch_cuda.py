"""repro_torch's CUDA kernels against their plain PyTorch versions, on a
card.  Marked ``gpu``: they skip where there is none (a CUDA kernel has no
CPU mode).  This file imports no jax, so it runs on a machine with only
PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: rtol=atol=1e-5 for the spmv kernels (atomics sum in another
order than index_add_), exact with integer-valued weights, and exact for
``ell_spmv`` and ``ell_spmv_delay`` (kernel and plain version sum in
float64); the dendritic ring's fold bit-equal to its plain version (sign
bits of zeros included); rtol=atol=2e-4
for the neuron updates, whose spike decisions may differ on under 0.2% of
neurons (the parity contract of tests/test_kernels.py); flash attention
within rtol=atol=2e-5 of its plain version in float32 (the sums run in
another order) and within 1e-2 in bfloat16, against the plain version on
the same bf16 inputs upcast to float32 (the kernel's output is rounded to
bf16).  The flash-attention backward: in float32 within rtol=5e-4,
atol=5e-5 of autograd through the plain attention (tests/test_kernels.py's
gradient tolerance); in bfloat16 within rtol=1e-2 plus 1e-2 of each
gradient's largest entry of the plain backward on the same saved bf16
tensors (each gradient is rounded to bf16 once: 2^-8 relative).  The SSD
scan within rtol=atol=2e-4 of ``ssd_chunked`` (tests/test_kernels.py's
tolerance), with TF32 off."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import delay_ring as DR  # noqa: E402
from repro_torch.kernels import ell_spmv as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import hh_step as HH  # noqa: E402
from repro_torch.kernels import izhikevich_step as IZ  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NEURON_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("spike_dtype", [torch.float32, torch.bool],
                         ids=["float", "bool"])
@pytest.mark.parametrize("b,p", [(1, 0.01), (4, 1.0), (8, 0.01)])
def test_cuda_kernels_match_plain(cuda_device, b, p, spike_dtype):
    rng = np.random.default_rng(0)
    n_pre, k, n_post, n_slots = 2000, 100, 3000, 7
    g = torch.tensor(0.5 * rng.random((n_pre, k)), dtype=torch.float32,
                     device=cuda_device)
    idx = torch.tensor(rng.integers(0, n_post, (n_pre, k)),
                       dtype=torch.int32, device=cuda_device)
    valid = torch.tensor(rng.random((n_pre, k)) < 0.8, device=cuda_device)
    dly = torch.tensor(rng.integers(0, n_slots, (n_pre, k)),
                       dtype=torch.int32, device=cuda_device)
    spk = torch.tensor(rng.random((b, n_pre)) < p, dtype=torch.float32,
                       device=cuda_device)
    s_in = spk.to(spike_dtype)
    K.reset_launches()
    out = K.ell_spmv(g, idx, valid, s_in, n_post)
    out_d = K.ell_spmv_delay(g, idx, valid, dly, spk, n_post, n_slots)
    torch.cuda.synchronize()
    assert K.launches == {"ell_spmv": 1, "ell_spmv_delay": 1}
    torch.testing.assert_close(out, TR.ell_spmv_ref(g, idx, valid, spk,
                                                    n_post), **TOL)
    torch.testing.assert_close(
        out_d, TR.ell_spmv_delay_ref(g, idx, valid, dly, spk, n_post,
                                     n_slots), **TOL)
    gi = torch.floor(8 * g)
    assert torch.equal(K.ell_spmv(gi, idx, valid, s_in, n_post),
                       TR.ell_spmv_ref(gi, idx, valid, spk, n_post))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["valid_not_first", "per_member_g",
                                  "silent", "k_not_multiple_of_4",
                                  "misaligned"])
def test_cuda_ell_spmv_cases_match_plain(cuda_device, case):
    """The redesigned kernel's other paths: a mask with each row's valid
    slots last, per-member weights (read per member), every member silent
    (no live row), and the one-slot walk (K % 4 != 0, or operands that are
    not 16-byte aligned); n_pre no multiple of 256, B no multiple of 8."""
    rng = np.random.default_rng(5)
    n_pre, k, n_post, b = 700, 30 if case == "k_not_multiple_of_4" else 32, \
        500, 11

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    g = t(rng.standard_normal((n_pre, k)))
    idx = t(rng.integers(0, n_post, (n_pre, k)), torch.int32)
    valid = t(rng.random((n_pre, k)) < 0.7, torch.bool)
    spk = t(rng.random((b, n_pre)) < (0.0 if case == "silent" else 0.05),
            torch.bool)
    if case == "valid_not_first":
        valid[:, : k // 2] = False
    if case == "per_member_g":
        g = (t(rng.standard_normal((b, 1, 1))) * g).contiguous()
    if case == "misaligned":
        # a view one element into its storage: 4-byte aligned, not 16
        g = torch.empty(n_pre * k + 1, device=cuda_device)[1:].view(n_pre, k)
        g.copy_(t(rng.standard_normal((n_pre, k))))
    aligned = (g.data_ptr() | idx.data_ptr()) % 16 == 0
    assert K.launch_plan(b, n_pre, k, n_post, aligned)["vec"] == (
        4 if case in ("valid_not_first", "per_member_g", "silent") else 1)
    out = K.ell_spmv(g, idx, valid, spk, n_post)
    torch.testing.assert_close(out, TR.ell_spmv_ref(g, idx, valid, spk,
                                                    n_post), **TOL)
    if case == "silent":
        assert not out.any()


@pytest.mark.gpu
def test_cuda_ell_spmv_refuses_a_plan_unlike_its_layout(cuda_device):
    g = torch.ones(4, 8, device=cuda_device)
    idx = torch.zeros(4, 8, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, 8, dtype=torch.bool, device=cuda_device)
    spk = torch.ones(1, 4, device=cuda_device)
    out = torch.zeros(1, 5, dtype=torch.float64, device=cuda_device)
    lib = K._lib()
    assert lib.ell_spmv_smem_bytes() == K.launch_plan(1, 4, 8, 5)[
        "smem_bytes"]
    args = (g.data_ptr(), 0, idx.data_ptr(), valid.data_ptr(),
            spk.data_ptr(), 0, out.data_ptr(), 1, 4, 8, 5)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.ell_spmv_f32(*args, 4, lib.ell_spmv_smem_bytes() + 4,
                            stream) != 0
    assert lib.ell_spmv_f32(*args, 2, lib.ell_spmv_smem_bytes(),
                            stream) != 0
    assert lib.ell_spmv_f32(*args, 4, lib.ell_spmv_smem_bytes(),
                            stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((1, 5), 0.0, dtype=torch.float64,
                                       device=cuda_device)
                       .index_fill_(1, torch.tensor([0], device=cuda_device),
                                    32.0))


@pytest.mark.gpu
@pytest.mark.parametrize("spike_dtype", [torch.float32, torch.bool],
                         ids=["float", "bool"])
@pytest.mark.parametrize("b,p", [(1, 0.05), (8, 0.05), (3, 1.0)])
def test_cuda_ell_spmv_equals_plain_bit_for_bit(cuda_device, b, p,
                                                spike_dtype):
    """Kernel and plain version both sum in float64 and round once, so
    with weights that are no integers they agree exactly, and two calls
    of the kernel agree with each other, whatever order the atomics land
    in (many slots share few targets, so every target sums many terms)."""
    rng = np.random.default_rng(11)
    n_pre, k, n_post = 3000, 64, 40

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    g = t(rng.standard_normal((n_pre, k)))
    idx = t(rng.integers(0, n_post, (n_pre, k)), torch.int32)
    valid = t(rng.random((n_pre, k)) < 0.8, torch.bool)
    spk = t(rng.random((b, n_pre)) < p)
    first = K.ell_spmv(g, idx, valid, spk.to(spike_dtype), n_post)
    again = K.ell_spmv(g, idx, valid, spk.to(spike_dtype), n_post)
    assert torch.equal(first, again)
    assert torch.equal(first, TR.ell_spmv_ref(g, idx, valid, spk, n_post))


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_operands(cuda_device):
    g = torch.ones(4, 3, device=cuda_device)
    idx = torch.zeros(4, 3, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, 3, dtype=torch.bool, device=cuda_device)
    spk = torch.ones(1, 4, device=cuda_device)
    with pytest.raises(TypeError):
        K.ell_spmv(g, idx.long(), valid, spk, 5)
    with pytest.raises(ValueError):
        K.ell_spmv(g.t(), idx, valid, spk, 5)
    with pytest.raises(ValueError):
        K.ell_spmv(g.cpu(), idx, valid, spk, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("spike_dtype", [torch.float32, torch.bool],
                         ids=["float", "bool"])
@pytest.mark.parametrize("per_member_g", [False, True],
                         ids=["shared_g", "per_member_g"])
@pytest.mark.parametrize("b,p,k", [(1, 0.05, 64), (8, 0.05, 64),
                                   (3, 1.0, 64), (8, 0.3, 30)])
def test_cuda_delay_scatter_equals_plain_bit_for_bit(cuda_device, b, p, k,
                                                     per_member_g,
                                                     spike_dtype):
    """The delay scatter sums in float64 like its plain version, so the
    two agree exactly (many slots share few (slot, target) cells); bool
    spikes equal float ones; K % 4 != 0 takes the one-slot walk; adding
    into a scratch that holds (float32-exact) values adds to them."""
    rng = np.random.default_rng(13)
    n_pre, n_post, n_slots = 3000, 40, 21
    assert K.launch_plan(b, n_pre, k, n_post, n_slots=n_slots)["grid"] == (
        -(-n_pre // 256), -(-b // 8), 1)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    g = t(rng.standard_normal((b, n_pre, k) if per_member_g
                              else (n_pre, k)))
    idx = t(rng.integers(0, n_post, (n_pre, k)), torch.int32)
    valid = t(rng.random((n_pre, k)) < 0.8, torch.bool)
    dly = t(rng.integers(0, n_slots, (n_pre, k)), torch.int32)
    spk = t(rng.random((b, n_pre)) < p)
    assert K.launch_plan(b, n_pre, k, n_post, n_slots=n_slots)["vec"] == (
        4 if k % 4 == 0 else 1)
    K.reset_launches()
    first = K.ell_spmv_delay(g, idx, valid, dly, spk.to(spike_dtype),
                             n_post, n_slots)
    again = K.ell_spmv_delay(g, idx, valid, dly, spk, n_post, n_slots)
    assert K.launches == {"ell_spmv": 0, "ell_spmv_delay": 2}
    ref = TR.ell_spmv_delay_ref(g, idx, valid, dly, spk, n_post, n_slots)
    assert torch.equal(first, again)
    assert torch.equal(first, ref)
    # a scratch holding float32 values: float64 sums onto them stay exact
    acc = t(rng.standard_normal((n_slots, n_post, b)).astype(np.float32),
            torch.float64)
    want = acc.clone()
    TR.ell_spmv_delay_into_ref(g, idx, valid, dly, spk, want)
    K.ell_spmv_delay_into(g, idx, valid, dly, spk.to(spike_dtype), acc)
    assert torch.equal(acc, want)


@pytest.mark.gpu
@pytest.mark.parametrize("gscale_kind", ["python", "scalar", "per_member"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("b,n_post", [(1, 80_000), (8, 2000), (4, 37)])
def test_cuda_ring_fold_equals_plain_bit_for_bit(cuda_device, b, n_post,
                                                 sign, gscale_kind):
    """At every cursor: the new ring and inj equal the plain version's bit
    for bit (zeros' sign bits too), the input ring is untouched and the
    scratch is left zeroed; n_post = 37 takes the one-element form."""
    rng = np.random.default_rng(b + n_post)
    n_slots = 21

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    ring = t(rng.standard_normal((b, n_slots, n_post)))
    ring[:, :, :3] = 0.0
    acc0 = t(rng.standard_normal((n_slots, n_post, b)), torch.float64)
    acc0[:, 2:6] = 0.0
    gscale = {"python": 1.0, "scalar": torch.tensor(0.7),
              "per_member": t(rng.uniform(0.1, 3.0, b))}[gscale_kind]
    assert DR.launch_plan(b, n_slots, n_post)["vec"] == (
        4 if n_post % 4 == 0 else 1)
    before = ring.clone()
    for cursor in (0, 7, n_slots - 1):
        acc, acc_ref = acc0.clone(), acc0.clone()
        DR.reset_launches()
        new_ring, inj = DR.delay_ring_fold(ring, acc, cursor, sign, gscale)
        assert DR.launches == {"delay_ring_fold": 1}
        want_ring, want_inj = TR.delay_ring_fold_ref(ring, acc_ref, cursor,
                                                     sign, gscale)
        for got, want in ((new_ring, want_ring), (inj, want_inj)):
            assert torch.equal(got, want)
            assert torch.equal(torch.signbit(got), torch.signbit(want))
        assert not acc.any() and torch.equal(ring, before)


@pytest.mark.gpu
def test_cuda_ring_fold_rejects_bad_operands(cuda_device):
    ring = torch.zeros(2, 5, 8, device=cuda_device)
    acc = torch.zeros(5, 8, 2, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        DR.delay_ring_fold(ring, acc.float(), 0, 1.0, 1.0)
    with pytest.raises(ValueError):
        DR.delay_ring_fold(ring, acc, 5, 1.0, 1.0)
    with pytest.raises(ValueError):
        DR.delay_ring_fold(ring, acc, 0, 1.0, torch.ones(3,
                                                          device=cuda_device))
    with pytest.raises(ValueError):
        DR.delay_ring_fold(ring, acc[:4], 0, 1.0, 1.0)
    with pytest.raises(ValueError):
        DR.delay_ring_fold(ring, acc.permute(2, 0, 1).contiguous(), 0, 1.0,
                           1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_neuron_kernels_match_plain(cuda_device, b):
    rng = np.random.default_rng(1)
    n = 5000

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=cuda_device)

    v, u = t(rng.uniform(-80, 25, (b, n))), t(rng.uniform(-20, 5, (b, n)))
    isyn = t(5 * rng.standard_normal((b, n)))
    r = rng.random(n)
    params = [t(0.02 + 0.08 * r), t(0.25 - 0.05 * r), t(-65 + 15 * r * r),
              t(8 - 6 * r * r)]
    hh_in = [t(rng.uniform(-80, 30, (b, n)))] + [
        t(rng.random((b, n))) for _ in range(3)] + [
        t(2 * rng.standard_normal((b, n)))]
    IZ.reset_launches()
    HH.reset_launches()
    out = IZ.izhikevich_step(v, u, isyn, *params, 1.0)
    hout = HH.hh_step(*hh_in, 0.1, substeps=5)
    torch.cuda.synchronize()
    assert IZ.launches == {"izhikevich_step": 1}
    assert HH.launches == {"hh_step": 1}
    ref = TR.izhikevich_step_ref(v, u, isyn, *params, 1.0)
    agree = out[2] == ref[2]
    assert (~agree).float().mean().item() < 0.002
    for a, e in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a[agree], e[agree], **NEURON_TOL)
    href = TR.hh_step_ref(*hh_in, 0.1, substeps=5)
    for a, e in zip(hout[:4], href[:4]):
        torch.testing.assert_close(a, e, **NEURON_TOL)
    assert torch.equal(hout[4], hout[0] >= 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("plant", [None, "nan", "inf"])
@pytest.mark.parametrize("kernel", ["izhikevich_step", "hh_step"])
def test_cuda_finite_flag_equals_the_fold(cuda_device, kernel, plant):
    """The flag a kernel writes in its epilogue equals isfinite over its
    own outputs, member by member (3 members of 70000 neurons: several
    blocks each; the planted value sits in member 1's last block)."""
    rng = np.random.default_rng(2)
    b, n = 3, 70_000

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=cuda_device)

    isyn = t(2 * rng.standard_normal((b, n)))
    if plant is not None:
        isyn[1, n - 5] = float(plant)
    finite = torch.ones(b, dtype=torch.bool, device=cuda_device)
    finite[2] = False                      # an earlier step's verdict stays
    if kernel == "hh_step":
        state = [t(rng.uniform(-80, 30, (b, n)))] + [
            t(rng.random((b, n))) for _ in range(3)]
        out = HH.hh_step(*state, isyn, 0.1, finite=finite)[:4]
    else:
        r = rng.random(n)
        params = [t(0.02 + 0.08 * r), t(0.25 - 0.05 * r),
                  t(-65 + 15 * r * r), t(8 - 6 * r * r)]
        out = IZ.izhikevich_step(t(rng.uniform(-80, 25, (b, n))),
                                 t(rng.uniform(-20, 5, (b, n))), isyn,
                                 *params, 1.0, finite=finite)[:2]
    torch.cuda.synchronize()
    fold = torch.tensor([True, True, False], device=cuda_device)
    for x in out:
        fold &= torch.isfinite(x).all(dim=-1)
    assert torch.equal(finite, fold)
    assert finite.tolist() == [True, plant is None, False]


@pytest.mark.gpu
def test_cuda_neuron_wrappers_reject_bad_operands(cuda_device):
    v = torch.zeros(2, 8, device=cuda_device)
    p = torch.ones(8, device=cuda_device)
    with pytest.raises(TypeError):
        IZ.izhikevich_step(v.double(), v, v, p, p, p, p, 1.0)
    with pytest.raises(ValueError):           # scalar param on the card
        IZ.izhikevich_step(v, v, v, 0.02, p, p, p, 1.0)
    with pytest.raises(ValueError):
        IZ.izhikevich_step(v, v, v[:1], p, p, p, p, 1.0)
    with pytest.raises(ValueError):
        HH.hh_step(v.t(), v.t(), v.t(), v.t(), v.t(), 0.1)
    with pytest.raises(ValueError):
        HH.hh_step(v, v, v, v.cpu(), v, 0.1)
    with pytest.raises(TypeError):            # per-neuron params
        HH.hh_step(v, v, v, v, v, 0.1, gK=p)


# b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, q_offset
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, None, None, 0),
    (1, 4, 2, 130, 300, 32, True, 64, None, None, 170),
    (1, 2, 2, 256, 256, 64, True, None, 30.0, 100, 0),
    (2, 4, 4, 200, 200, 64, False, None, None, None, 0),
    (1, 4, 2, 300, 300, 256, True, 128, None, None, 0),
    (1, 2, 1, 96, 96, 112, True, None, None, None, 0),
    # D = 40: the tensor-core kernels pad the contraction with zeros
    (1, 2, 1, 200, 200, 40, True, None, None, None, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, off = case
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device).to(dt)

    # q as the model hands it over: a [B, T, H, D] projection, transposed
    q = t((b, tq, hq, d)).transpose(1, 2)
    k, v = t((b, hkv, tk, d)), t((b, hkv, tk, d))
    kw = dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
              q_offset=off)
    FA.reset_launches()
    out = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 1, "flash_attention_bwd": 0}
    assert out.dtype == dt and out.shape == (b, hq, tq, d)
    ref = TR.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_bad_operands(cuda_device):
    q = torch.zeros(1, 4, 8, 64, device=cuda_device)
    k = torch.zeros(1, 2, 8, 64, device=cuda_device)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):           # head dim not a multiple of 8
        FA.flash_attention(q[..., :60], k[..., :60], k[..., :60])
    with pytest.raises(ValueError):           # Hq not a multiple of Hkv
        FA.flash_attention(q[:, :3], k, k)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k.cpu(), k)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_grads_match_plain(cuda_device, case):
    """q, k and v get the gradients of autograd through the plain version
    (the repaired fault: the kernel's output had no grad_fn)."""
    b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, off = case
    rng = np.random.default_rng(3)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device)

    kw = dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
              q_offset=off)
    q, k, v, g = (t((b, hq, tq, d)), t((b, hkv, tk, d)), t((b, hkv, tk, d)),
                  t((b, hq, tq, d)))
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    FA.reset_launches()
    out = kops.flash_attention(*ins, **kw)
    grads = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 1, "flash_attention_bwd": 1}
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(TR.flash_attention_ref(*refs, **kw), refs, g)
    for name, a, w in zip("qkv", grads, want):
        assert a.abs().sum() > 0, name
        torch.testing.assert_close(a, w, rtol=5e-4, atol=5e-5,
                                   msg=lambda m: f"d{name}: {m}")
    _, lse = TR.flash_attention_fwd_ref(q, k, v, **kw)
    _, lse_k = FA.flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(lse_k, lse, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_bwd_bf16_matches_plain(cuda_device, case):
    b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, off = case
    rng = np.random.default_rng(4)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device).to(torch.bfloat16)

    kw = dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
              q_offset=off)
    q, k, v, g = (t((b, hq, tq, d)), t((b, hkv, tk, d)), t((b, hkv, tk, d)),
                  t((b, hq, tq, d)))
    out, lse = FA.flash_attention_fwd(q, k, v, **kw)
    got = FA.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    want = TR.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      out.float(), lse, g.float(), **kw)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w, rtol=1e-2,
                                   atol=1e-2 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_route_by_dtype(cuda_device, dtype):
    """A bf16 call runs the tensor-core kernels and a float32 call the
    CUDA-core ones, by kernel name in a torch.profiler trace; neither runs
    a kernel of the other route."""
    from torch.profiler import ProfilerActivity, profile
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, dout = (torch.randn(shape, device=cuda_device, generator=g
                                 ).to(dt)
                     for shape in ((1, 4, 128, 64), (1, 2, 128, 64),
                                   (1, 2, 128, 64), (1, 4, 128, 64)))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True)      # built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = FA.flash_attention_fwd(q, k, v, causal=True)
        FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    mine, other = (FA.ROUTES[dt], FA.ROUTES[torch.float32 if dt ==
                                           torch.bfloat16 else torch.bfloat16])
    for kern in mine["fwd"] + mine["bwd"]:
        assert any(kern in n for n in names), (kern, names)
    for kern in other["fwd"] + other["bwd"]:
        assert not any(kern in n for n in names), (kern, names)


@pytest.mark.gpu
def test_cuda_flash_attention_bf16_batch_heads_past_grid_axis_y(cuda_device):
    """b·Hq = 65,552 > 65535: the bf16 kernels (b·Hq on grid axis x) run
    forward and backward and match the plain versions at the bf16
    tolerances; the float32 route (b·Hq on axis y) refuses the shape."""
    b, hq, hkv, t, d = 4097, 16, 4, 16, 64
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, dout = (torch.randn(shape, device=cuda_device, generator=g
                                 ).bfloat16()
                     for shape in ((b, hq, t, d), (b, hkv, t, d),
                                   (b, hkv, t, d), (b, hq, t, d)))
    FA.reset_launches()
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 1, "flash_attention_bwd": 1}
    ref = TR.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=True)
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)
    want = TR.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(),
                                      causal=True)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w, rtol=1e-2,
                                   atol=1e-2 * float(w.abs().max()))
    with pytest.raises(ValueError, match="axis y"):
        FA.flash_attention(q.float(), k.float(), v.float())


# b, t, h, dh, ds (the last: dh and ds multiples of 4 but not of 8, padded
# with zeros to the tensor cores' mma width)
SSD_CASES = [(2, 256, 8, 64, 128), (1, 96, 4, 64, 128), (1, 1000, 3, 16, 16),
             (2, 300, 5, 32, 64), (1, 200, 3, 20, 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("case", SSD_CASES)
def test_cuda_ssd_scan_matches_plain(cuda_device, case, with_d):
    b, t, h, dh, ds = case
    rng = np.random.default_rng(5)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda_device)

    x = f(rng.standard_normal((b, t, h, dh)))
    dt = f(0.001 + 0.1 * rng.random((b, t, h)))
    A = f(-np.exp(rng.uniform(0, 2, h)))
    B = f(rng.standard_normal((b, t, 1, ds)))
    C = f(rng.standard_normal((b, t, 1, ds)))
    D = f(rng.standard_normal(h)) if with_d else None
    torch.backends.cuda.matmul.allow_tf32 = False
    SSD.reset_launches()
    y = SSD.ssd_scan(x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert SSD.launches == {"ssd_scan": 1}
    ref = TS.ssd_chunked(x, dt, A, B, C, D)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y, TR.ssd_scan_ref(x, dt, A, B, C, D),
                               rtol=2e-4, atol=2e-4)
    # the Function: kernel forward, gradients of ssd_chunked
    xs = x.clone().requires_grad_(True)
    y2 = kops.ssd_scan(xs, dt, A, B, C, D)
    (gx,) = torch.autograd.grad(y2.sum(), [xs])
    xr = x.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(TS.ssd_chunked(xr, dt, A, B, C, D).sum(),
                                [xr])
    torch.testing.assert_close(gx, gr)


@pytest.mark.gpu
def test_cuda_ssd_scan_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 2, 16, device=cuda_device)
    dt = torch.zeros(1, 8, 2, device=cuda_device)
    A = torch.zeros(2, device=cuda_device)
    B = torch.zeros(1, 8, 1, 16, device=cuda_device)
    with pytest.raises(NotImplementedError):        # n_groups 2
        SSD.ssd_scan(x, dt, A, B.expand(1, 8, 2, 16), B.expand(1, 8, 2, 16))
    with pytest.raises(ValueError):                 # dh > 64
        SSD.ssd_scan(x.expand(1, 8, 2, 16).repeat(1, 1, 1, 5), dt, A, B, B)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt.cpu(), A, B, B)
