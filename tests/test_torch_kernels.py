"""repro_torch kernels: the plain versions against the JAX package's Pallas
kernels (interpret mode) and jnp references (the CUDA kernels against the
plain versions on a card: tests/test_torch_cuda.py).

Tolerances follow the parity contract: rtol=atol=1e-5 for scatter sums
(the summation order differs between XLA, index_add_ and atomics), exact
equality with integer-valued weights (their sums do not depend on the
order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.ell_spmv import (ell_spmv_delay_pallas,  # noqa: E402
                                    ell_spmv_pallas)
from repro_torch.kernels import ell_spmv as K  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.sparse import formats as F  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(16, 4, 32, 1), (64, 16, 100, 4), (200, 50, 333, 2),
          (128, 128, 512, 8)]


def _inputs(n_pre, k, n_post, b, seed, integer=False, n_slots=None):
    rng = np.random.default_rng(seed)
    if integer:
        g = rng.integers(-3, 4, (n_pre, k)).astype(np.float32)
    else:
        g = rng.standard_normal((n_pre, k)).astype(np.float32)
    idx = rng.integers(0, n_post, (n_pre, k)).astype(np.int32)
    valid = rng.random((n_pre, k)) < 0.8
    spk = (rng.random((b, n_pre)) < 0.2).astype(np.float32)
    dly = (None if n_slots is None
           else rng.integers(0, n_slots, (n_pre, k)).astype(np.int32))
    return g, idx, valid, spk, dly


def _t(*arrs):
    return [None if a is None else torch.tensor(a) for a in arrs]


@pytest.mark.parametrize("n_pre,k,n_post,b", SHAPES)
def test_ell_spmv_plain_matches_pallas_and_ref(n_pre, k, n_post, b):
    g, idx, valid, spk, _ = _inputs(n_pre, k, n_post, b, seed=n_pre + k)
    pallas = ell_spmv_pallas(jnp.asarray(g), jnp.asarray(idx),
                             jnp.asarray(valid), jnp.asarray(spk),
                             n_post=n_post, interpret=True)
    jref = JR.ell_spmv_ref(jnp.asarray(g), jnp.asarray(idx),
                           jnp.asarray(valid), jnp.asarray(spk), n_post)
    out = K.ell_spmv(*_t(g, idx, valid, spk), n_post).numpy()
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(jref), **TOL)


@pytest.mark.parametrize("n_pre,k,n_post,b", SHAPES)
def test_ell_spmv_delay_plain_matches_pallas_and_ref(n_pre, k, n_post, b):
    n_slots = 5
    g, idx, valid, spk, dly = _inputs(n_pre, k, n_post, b, seed=7 * n_pre,
                                      n_slots=n_slots)
    args = tuple(map(jnp.asarray, (g, idx, valid, dly, spk)))
    pallas = ell_spmv_delay_pallas(*args, n_post=n_post, n_slots=n_slots,
                                   interpret=True)
    jref = JR.ell_spmv_delay_ref(*args, n_post, n_slots)
    gt, it, vt, st, dt = _t(g, idx, valid, spk, dly)
    out = K.ell_spmv_delay(gt, it, vt, dt, st, n_post, n_slots).numpy()
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(jref), **TOL)


@pytest.mark.parametrize("n_pre,k,n_post,b", SHAPES)
def test_integer_weights_exact(n_pre, k, n_post, b):
    g, idx, valid, spk, dly = _inputs(n_pre, k, n_post, b, seed=3,
                                      integer=True, n_slots=4)
    jref = JR.ell_spmv_ref(jnp.asarray(g), jnp.asarray(idx),
                           jnp.asarray(valid), jnp.asarray(spk), n_post)
    gt, it, vt, st, dt = _t(g, idx, valid, spk, dly)
    np.testing.assert_array_equal(K.ell_spmv(gt, it, vt, st, n_post).numpy(),
                                  np.asarray(jref))
    jd = JR.ell_spmv_delay_ref(*map(jnp.asarray, (g, idx, valid, dly, spk)),
                               n_post, 4)
    np.testing.assert_array_equal(
        K.ell_spmv_delay(gt, it, vt, dt, st, n_post, 4).numpy(),
        np.asarray(jd))


def test_per_member_weights_equal_separate_calls():
    """g [B, n_pre, K] (plastic groups in a batched run) is B independent
    products."""
    g, idx, valid, spk, _ = _inputs(40, 8, 50, 3, seed=11)
    gb = np.stack([g, 2 * g, -g]).astype(np.float32)
    out = K.ell_spmv(*_t(gb, idx, valid, spk), 50).numpy()
    for b in range(3):
        one = K.ell_spmv(*_t(gb[b], idx, valid, spk[b:b + 1]), 50).numpy()
        np.testing.assert_array_equal(out[b:b + 1], one)


def test_ops_route_containers_and_event_variants():
    g, idx, valid, spk, dly = _inputs(30, 6, 40, 1, seed=5, n_slots=3)
    ell = F.triple_to_ell(idx, g, valid, 40, delay=dly)
    s = torch.tensor(spk[0]) > 0
    dense = kops.ell_spmv(ell, s)
    np.testing.assert_array_equal(kops.ell_spmv_event(ell, s, 8).numpy(),
                                  dense.numpy())
    np.testing.assert_array_equal(
        kops.ell_spmv_event_delay(ell, s, 3, 8).numpy(),
        kops.ell_spmv_delay(ell, s, 3).numpy())
    np.testing.assert_allclose(dense.sum().item(),
                               kops.ell_spmv_delay(ell, s, 3).sum().item(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        kops.ell_spmv_event(ell, s, 0)


def _case_inputs(case):
    """The ELL cases the redesigned kernel must keep: bool spikes, rows
    whose valid slots are not first, per-member weights, every member
    silent (n_pre 300 is no multiple of the kernel's 256 rows a CTA, and
    B 10 none of its 8 members)."""
    n_pre, k, n_post, b = 300, 12, 200, 10
    g, idx, valid, spk, _ = _inputs(n_pre, k, n_post, b, seed=21)
    if case == "valid_not_first":
        # each row's valid slots last, in a row whose first slots are not
        valid = np.zeros((n_pre, k), bool)
        valid[:, k // 2:] = True
        valid[::3, 0] = True
    if case == "silent":
        spk = np.zeros_like(spk)
    return g, idx, valid, spk, n_post


@pytest.mark.parametrize("case", ["bool_spikes", "valid_not_first",
                                  "per_member_g", "silent"])
def test_ell_spmv_cases_match_jax(case):
    g, idx, valid, spk, n_post = _case_inputs(case)
    gt, it, vt, st = _t(g, idx, valid, spk)
    if case == "per_member_g":
        scale = np.linspace(-1, 2, spk.shape[0], dtype=np.float32)
        gb = (scale[:, None, None] * g).astype(np.float32)
        out = K.ell_spmv(torch.tensor(gb), it, vt, st, n_post).numpy()
        for b in range(spk.shape[0]):
            jref = JR.ell_spmv_ref(*map(jnp.asarray, (gb[b], idx, valid,
                                                      spk[b:b + 1])), n_post)
            np.testing.assert_allclose(out[b:b + 1], np.asarray(jref), **TOL)
        return
    if case == "bool_spikes":
        out = K.ell_spmv(gt, it, vt, st > 0, n_post)
        assert torch.equal(out, K.ell_spmv(gt, it, vt, st, n_post))
        assert torch.equal(kops.ell_spmv_batched(
            F.ELLSynapses(g=gt, post_ind=it, valid=vt, n_post=n_post),
            st > 0), out)
    else:
        out = K.ell_spmv(gt, it, vt, st, n_post)
    args = tuple(map(jnp.asarray, (g, idx, valid, spk)))
    pallas = ell_spmv_pallas(*args, n_post=n_post, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(JR.ell_spmv_ref(*args, n_post)),
                               **TOL)
    if case == "silent":
        assert not out.any()
