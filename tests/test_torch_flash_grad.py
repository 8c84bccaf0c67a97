"""The gradient of repro_torch's flash attention on the CPU: the
``FlashAttention`` Function (forward ``flash_attention_fwd_ref``, backward
``flash_attention_bwd_ref``, the plain versions the CUDA kernels are held
to) against autograd through the plain ``flash_attention_ref`` and against
``jax.grad`` of the JAX package's ``flash_attention_xla`` (its custom VJP),
over the cases of tests/test_kernels.py; the saved lse against
``flash_xla._fwd_impl``'s; and gradients reaching the attention weights
through ``models/attention.py``.  The backward kernels themselves are held
to the plain versions on a card in tests/test_torch_cuda.py.

Tolerance rtol=5e-4, atol=5e-5, as tests/test_kernels.py holds
``flash_attention_xla``'s gradients to autodiff of the reference (float32
sums in another order and chunking)."""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_xla import _bwd, _fwd_impl  # noqa: E402
from repro.kernels.flash_xla import flash_attention_xla  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

GTOL = dict(rtol=5e-4, atol=5e-5)
ATTN_CASES = [
    # b, hq, hkv, tq, tk, d, causal, window, softcap, prefix
    (1, 4, 2, 256, 256, 64, True, None, None, None),
    (2, 2, 1, 128, 256, 32, True, 64, None, None),
    (1, 2, 2, 256, 256, 64, True, None, 30.0, None),
    (1, 2, 2, 256, 256, 64, True, None, None, 100),
    (2, 4, 4, 200, 200, 64, False, None, None, None),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed):
    b, hq, hkv, tq, tk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
                      (b, hq, tq, d))]


def _opts(case):
    causal, window, softcap, prefix = case[6:]
    return dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
                q_offset=case[4] - case[3])


@pytest.mark.parametrize("case", ATTN_CASES)
def test_function_grads_match_autograd_and_jax(case):
    q, k, v, g = _inputs(case, seed=sum(case[:6]))
    kw = _opts(case)

    def f(q, k, v):
        return jnp.sum(flash_attention_xla(
            q, k, v, kw["causal"], kw["window"], None, kw["q_offset"],
            kw["softcap"], kw["prefix"], 32, 32) * g)

    jg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    FA.reset_launches()
    out = kops.flash_attention(*ts, **kw)
    assert "FlashAttention" in type(out.grad_fn).__name__
    fg = torch.autograd.grad(out, ts, torch.tensor(g))
    assert FA.launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    rs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    rg = torch.autograd.grad(TR.flash_attention_ref(*rs, **kw), rs,
                             torch.tensor(g))
    for name, a, b, c in zip("qkv", fg, rg, jg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GTOL,
                                   err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **GTOL,
                                   err_msg=f"d{name} vs jax.grad")


@pytest.mark.parametrize("case", ATTN_CASES)
def test_lse_and_bwd_ref_match_flash_xla(case):
    """The saved lse equals ``_fwd_impl``'s, and the plain backward equals
    ``_bwd`` fed the same residuals and output gradient."""
    q, k, v, g = _inputs(case, seed=3 + sum(case[:6]))
    kw = _opts(case)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = _fwd_impl(jq, jk, jv, kw["causal"], kw["window"], None,
                           kw["q_offset"], kw["softcap"], kw["prefix"], 32,
                           32)
    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g))
    out, lse = FA.flash_attention_fwd(tq, tk, tv, **kw)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    want = _bwd(kw["causal"], kw["window"], None, kw["q_offset"],
                kw["softcap"], kw["prefix"], 32, 32,
                (jq, jk, jv, jout, jlse), jg)
    got = FA.flash_attention_bwd(tq, tk, tv, out, lse, tg, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_ref_takes_chunks_that_do_not_divide_t(causal):
    """Chunks of 16 queries and 64 keys at Tq = 37, Tk = 150 (a shorter
    last chunk each way, as at whisper's 1500 frames): the gradients of
    one whole block and of autograd through the plain forward."""
    q, k, v, g = _inputs((2, 4, 2, 37, 150, 32), seed=11)
    kw = dict(causal=causal, q_offset=113 if causal else 0)
    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g))
    out, lse = TR.flash_attention_fwd_ref(tq, tk, tv, **kw)
    got = TR.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, q_chunk=16,
                                     k_chunk=64, **kw)
    whole = TR.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, **kw)
    rs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    rg = torch.autograd.grad(TR.flash_attention_ref(*rs, **kw), rs, tg)
    for name, a, w, r in zip("qkv", got, whole, rg):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name} vs whole")
        np.testing.assert_allclose(a.numpy(), r.numpy(), **GTOL,
                                   err_msg=f"d{name} vs autograd")


def test_rows_that_see_no_key_have_lse_minus_inf_and_no_gradient():
    q, k, v, g = map(torch.tensor, _inputs((1, 2, 1, 16, 16, 8), seed=5))
    out, lse = FA.flash_attention_fwd(q, k, v, q_offset=-4)
    assert torch.isneginf(lse[:, :, :4]).all()
    assert torch.isfinite(lse[:, :, 4:]).all()
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, out, lse, g, q_offset=-4)
    assert torch.equal(dq[:, :, :4], torch.zeros_like(dq[:, :, :4]))
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


def test_attention_weights_get_gradients():
    """The repaired fault: a loss through attention_forward reaches wq, wk,
    wv and their biases (through the Function), equal to autograd through
    the plain attention."""
    cfg = TA.AttnConfig(d_model=32, n_heads=4, n_kv=2, head_dim=8,
                        qkv_bias=True)
    p = TA.attn_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(1))
    leaves = list(p.values())
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(TA.attention_forward(p, cfg, x).square()
                                .sum(), leaves)
    with mock.patch.object(TA.kops, "flash_attention",
                           TR.flash_attention_ref):
        want = torch.autograd.grad(TA.attention_forward(p, cfg, x).square()
                                   .sum(), leaves)
    for name, a, b in zip(p, grads, want):
        assert a.abs().sum() > 0, name
        torch.testing.assert_close(a, b, **GTOL)
