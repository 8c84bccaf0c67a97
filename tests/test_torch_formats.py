"""repro_torch sparse formats: host initializers and snippets bit-identical
to the JAX package's for the same seed, the same eq. (1)/(2) representation
decisions, and the containers' conversions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sparse import formats as JF  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.sparse import ops as TO  # noqa: E402

N_PRE, N_POST = 37, 53


def _pair(name, *args):
    return getattr(JF, name)(*args), getattr(TF, name)(*args)


@pytest.mark.parametrize("make", [
    lambda M: M.FixedFanout(9),
    lambda M: M.FixedProbability(0.2),
    lambda M: M.FixedProbability(0.0),
    lambda M: M.DenseInit(),
])
@pytest.mark.parametrize("weight", [
    None,
    lambda M: M.UniformWeight(0.0, 0.5),
    lambda M: M.UniformWeight(-1.0, 2.0),
    lambda M: M.NormalWeight(0.3, 2.0),
    lambda M: M.ConstantWeight(0.7),
])
def test_connectivity_bit_identical(make, weight):
    outs = []
    for M in (JF, TF):
        rng = np.random.default_rng(1234)
        wfn = None if weight is None else weight(M)
        outs.append(make(M).resolve(rng, N_PRE, N_POST, wfn))
        # the generator is left in the same state too
        outs[-1] = outs[-1] + (rng.random(),)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_one_to_one_and_fanout_helper_bit_identical():
    for n in (5, 17):
        a = JF.OneToOne().resolve(np.random.default_rng(n), n, n)
        b = TF.OneToOne().resolve(np.random.default_rng(n), n, n)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    a = JF.fixed_fanout_connectivity(np.random.default_rng(2), 20, 30, 7)
    b = TF.fixed_fanout_connectivity(np.random.default_rng(2), 20, 30, 7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for M in (JF, TF):
        with pytest.raises(ValueError):
            M.OneToOne().resolve(np.random.default_rng(0), 3, 4)
        with pytest.raises(ValueError):
            M.FixedProbability(1.5).resolve(np.random.default_rng(0), 3, 4)
        with pytest.raises(ValueError):
            M.fixed_fanout_connectivity(np.random.default_rng(0), 3, 4, 5)


@pytest.mark.parametrize("snip", [
    ("ConstantDelay", (0,)), ("ConstantDelay", (4,)),
    ("UniformIntDelay", (0, 20)), ("UniformIntDelay", (3, 3)),
])
def test_delay_snippets_bit_identical(snip):
    name, args = snip
    j, t = getattr(JF, name)(*args), getattr(TF, name)(*args)
    assert j.max_steps == t.max_steps
    a = j(np.random.default_rng(9), (11, 13))
    b = t(np.random.default_rng(9), (11, 13))
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


def test_delay_snippet_validation_matches():
    for M in (JF, TF):
        for bad in (lambda: M.ConstantDelay(-1),
                    lambda: M.UniformIntDelay(3, 2),
                    lambda: M.UniformIntDelay(-1, 2)):
            with pytest.raises(ValueError):
                bad()


@pytest.mark.parametrize("n_pre,n_post,nnz", [
    (100, 100, 10), (100, 100, 5000), (100, 100, 4999), (1000, 1000, 1000),
    (80000, 100000, 80_000_000), (1, 1, 1), (200, 160, 3200),
])
def test_choose_representation_same_decisions(n_pre, n_post, nnz):
    assert (TF.choose_representation(n_pre, n_post, nnz)
            == JF.choose_representation(n_pre, n_post, nnz))
    assert (TF.sparse_memory_elements(nnz, n_pre, n_post)
            == JF.sparse_memory_elements(nnz, n_pre, n_post))
    assert (TF.dense_memory_elements(n_pre, n_post)
            == JF.dense_memory_elements(n_pre, n_post))
    for d in (False, True):
        assert (TF.ell_memory_bytes(n_pre, 7, d)
                == JF.ell_memory_bytes(n_pre, 7, d))
    assert TF.memory_bytes(10) == JF.memory_bytes(10) == 40


def test_ell_to_dense_matches_jax():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, N_POST, (N_PRE, 6)).astype(np.int32)
    g = rng.integers(-4, 5, (N_PRE, 6)).astype(np.float32)
    valid = rng.random((N_PRE, 6)) < 0.7
    jd = JF.ell_to_dense(JF.triple_to_ell(idx, g, valid, N_POST))
    te = TF.triple_to_ell(idx, g, valid, N_POST)
    td = TF.ell_to_dense(te)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    spk = torch.tensor(rng.random(N_PRE) < 0.5)
    np.testing.assert_array_equal(TO.accumulate_ell(te, spk).numpy(),
                                  TO.accumulate_dense(td, spk).numpy())
    assert te.n_pre == N_PRE and te.max_conn == 6 and te.n_post == N_POST


def test_triple_to_ell_rejects_out_of_range():
    idx = np.array([[0, 5]], np.int32)
    g = np.ones((1, 2), np.float32)
    with pytest.raises(ValueError):
        TF.triple_to_ell(idx, g, np.ones((1, 2), bool), 5)
    with pytest.raises(ValueError):
        TF.triple_to_ell(idx[:, :1], g, np.ones((1, 2), bool), 5)
    with pytest.raises(ValueError):
        TF.triple_to_ell(idx[:, :1], g[:, :1], np.ones((1, 1), bool), 5,
                         delay=np.array([[-1]]))
