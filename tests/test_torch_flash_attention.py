"""repro_torch's flash attention on the CPU (its plain version) against the
JAX package's Pallas kernel in interpret mode and its jnp reference, on the
cases of tests/test_kernels.py; the CUDA kernel itself is held to the plain
version on a card in tests/test_torch_cuda.py.

Tolerance rtol=atol=2e-5 in float32, as tests/test_kernels.py holds the
Pallas kernel to its reference (the sums run in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
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
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_plain_matches_pallas_and_ref(case):
    causal, window, softcap, prefix = case[6:]
    q, k, v = _inputs(case, seed=sum(case[:6]))
    kw = dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
              q_offset=k.shape[2] - q.shape[2])
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, q_block=128, k_block=128,
                                    interpret=True, **kw)
    jref = JR.flash_attention_ref(jq, jk, jv, **kw)
    FA.reset_launches()
    out = kops.flash_attention(*map(torch.tensor, (q, k, v)), **kw)
    assert FA.launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **TOL)


def test_fully_masked_rows_give_zero():
    """A query that sees no key (window 0; or a negative offset that puts
    it before every key under causal) gives 0, not NaN."""
    q, k, v = map(torch.tensor, _inputs((1, 2, 1, 16, 16, 8), seed=3))
    out = kops.flash_attention(q, k, v, window=0)
    assert torch.equal(out, torch.zeros_like(q))
    out = kops.flash_attention(q, k, v, q_offset=-4)
    assert torch.equal(out[:, :, :4], torch.zeros_like(q[:, :, :4]))
    assert torch.isfinite(out).all() and out[:, :, 4:].abs().sum() > 0


def test_bf16_follows_the_kernel_casts():
    """bf16 inputs: the plain version computes in float32 and rounds only
    its output (the Pallas kernel's casts), so it equals the float32 result
    rounded to bf16."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _inputs((1, 4, 2, 64, 64, 32), seed=4))
    out = TR.flash_attention_ref(q, k, v, window=16)
    want = TR.flash_attention_ref(q.float(), k.float(), v.float(),
                                  window=16).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)


def test_gqa_maps_query_heads_to_their_kv_head():
    """Query head h reads kv head h // (Hq / Hkv), as jnp.repeat does."""
    q, k, v = map(torch.tensor, _inputs((1, 6, 2, 32, 32, 16), seed=5))
    out = kops.flash_attention(q, k, v)
    for h in range(6):
        one = kops.flash_attention(q[:, h:h + 1], k[:, h // 3:h // 3 + 1],
                                   v[:, h // 3:h // 3 + 1])
        torch.testing.assert_close(out[:, h:h + 1], one, **TOL)
