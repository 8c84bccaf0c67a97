"""``repro_torch.random``'s construction draws against ``jax.random`` on the
CPU: ``fold_in`` by a tensor of words, ``randint`` (int32), the affine
weight draw, the top-k route and ``binomial``.

Contract (ROADMAP parity contract): ``fold_in``, ``randint``, the top-k
route and uniform affine weights bit for bit; ``binomial`` equal on every
row of these cases (its ``log`` rounds as float64's, XLA's CPU polynomial
differs in the last bit on ~20% of inputs, which moves a degree only
where a value lies within an ulp of its acceptance bound; the rule is
>= 99.9% of rows).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.sparse import formats as JF  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import threefry as TF  # noqa: E402
from repro_torch.sparse import formats as TSF  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tk(jk) -> torch.Tensor:
    """A JAX key (or keys) as the port's int32 [..., 2] tensor."""
    a = np.asarray(jax.random.key_data(jk)).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy())


# fold_in(PRNGKey(0), _ZERO_ROW)'s first uniform is exactly 0.0 (found by
# a search over the rows with jax.random.bits)
_ZERO_ROW = 15_405_709


def _row_keys(seed, n):
    k = jax.random.PRNGKey(seed)
    return jax.vmap(lambda r: jax.random.fold_in(k, r))(jnp.arange(n))


@pytest.mark.parametrize("rows", [[0], [3, 1, 2], list(range(0, 900, 7)),
                                  [2 ** 31 - 1, 5]])
def test_fold_in_by_tensor_is_vmapped_fold_in(rows):
    k = jax.random.PRNGKey(7)
    want = jax.vmap(lambda r: jax.random.fold_in(k, r))(
        jnp.asarray(rows, jnp.int32))
    got = R.fold_in(_tk(k), torch.tensor(rows))
    np.testing.assert_array_equal(got.numpy(), _tk(want).numpy())
    # many keys, one word each: fold_in(row key, i)
    keys = _row_keys(2, 50)
    want = jax.vmap(lambda kk: jax.random.fold_in(kk, 63))(keys)
    np.testing.assert_array_equal(R.fold_in(_tk(keys), 63).numpy(),
                                  _tk(want).numpy())


@pytest.mark.parametrize("word", [0, 0x5EED, 2 ** 32 - 1])
def test_fold_in_by_word_is_jax_fold_in(word):
    """One key folded with a word (every int fold_in takes the fold_in
    kernel's route), and a [2, 3] batch of keys keeps its shape."""
    k = jax.random.PRNGKey(19)
    want = jax.random.fold_in(k, word)
    got = R.fold_in(_tk(k), word)
    assert got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), _tk(want).numpy())
    keys = _row_keys(8, 6).reshape(2, 3, 2)
    want = jax.vmap(jax.vmap(lambda kk: jax.random.fold_in(kk, word)))(keys)
    got = R.fold_in(_tk(keys), word)
    assert got.shape == (2, 3, 2)
    np.testing.assert_array_equal(got.numpy(), _tk(want).numpy())


@pytest.mark.parametrize("lo,hi", [(0, 100_000), (0, 21), (5, 6), (3, 3),
                                   (0, 2 ** 31 - 1), (-7, 13),
                                   (-2 ** 31, 2 ** 31 - 1), (9, 2)])
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_randint_is_bit_equal(lo, hi, n):
    keys = _row_keys(11, 40)
    want = jax.vmap(lambda kk: jax.random.randint(kk, (n,), lo, hi,
                                                  jnp.int32))(keys)
    got = R.randint(_tk(keys), (n,), lo, hi)
    assert got.dtype == torch.int32 and got.shape == (40, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_span_of_the_whole_word():
    """maxval past int32's top widens the span by one; 2^32 wraps to 0,
    whose remainders are the identity (XLA's), as in jax's randint."""
    assert TF.randint_span(0, 2 ** 31) == (0, 2 ** 31)
    assert TF.randint_span(-2 ** 31, 2 ** 31) == (-2 ** 31, 0)
    keys = R.split(R.PRNGKey(1), 3)
    bits = TR.threefry_split_ref(keys, 2)[:, 1]
    want = TR.threefry_draw_ref(bits, 9, "bits")
    got = TR.threefry_draw_ref(keys, 9, "randint", lo=0, span=0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("lo,hi", [(0.1, 0.7), (-1.3, 2.9), (0.25, -1.0),
                                   (0.0, -1.0), (0.0, 0.5), (3.3, 3.9)])
def test_uniform_weight_draw_rounds_as_xla(lo, hi):
    """lo + (hi - lo) * u: one fused multiply-add where lo != 0 (XLA's CPU
    backend contracts it), the add dropped where lo == 0."""
    keys = _row_keys(3, 64)
    want = np.asarray(jax.vmap(
        lambda kk: JF.UniformWeight(lo, hi).device(kk, (500,)))(keys))
    got = TSF.UniformWeight(lo, hi).device(_tk(keys), (500,)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_weight_keeps_the_sign_of_zero():
    """u = 0 (bits >> 9 == 0) with lo = 0 and hi < 0: XLA drops the add of
    0.0, so JAX's weight is -0.0; the port's too.  The row (found by search
    over fold_in(PRNGKey(0), r)) draws u = 0 first."""
    k = jax.random.fold_in(jax.random.PRNGKey(0), _ZERO_ROW)
    assert float(jax.random.uniform(k, (1,))[0]) == 0.0
    want = np.asarray(JF.UniformWeight(0.0, -1.0).device(k, (3,)))
    got = TSF.UniformWeight(0.0, -1.0).device(_tk(k), (3,)).numpy()
    assert np.signbit(want[0]) and np.signbit(got[0])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_weight_is_within_four_ulp():
    keys = _row_keys(5, 64)
    for mean, std in ((0.0, 1.0), (0.1, 0.4), (-2.0, 3.0)):
        want = np.asarray(jax.vmap(
            lambda kk: JF.NormalWeight(mean, std).device(kk, (300,)))(keys))
        got = TSF.NormalWeight(mean, std).device(_tk(keys), (300,)).numpy()
        # 4 ulp of the larger of the result and its std * z term (mean +
        # std * z cancels near zero)
        z = (want.astype(np.float64) - mean) / std
        mag = np.maximum(np.abs(want), np.abs(std * z)).astype(np.float32)
        assert (np.abs(got - want) <= 4 * np.spacing(mag)).all()


@pytest.mark.parametrize("skew", [0.0, 3e-4, -3e-4])
def test_sqrt_f32_is_correctly_rounded_whatever_the_library_root(
        monkeypatch, skew):
    """The normal draw's plain version takes its sqrt from
    ``ref.sqrt_f32``: float32 roots correctly rounded even where torch's
    sqrt returns a root ~1e-4 off (as a worker thread's first MKL call
    has on the CPU), exact squares included."""
    rng = np.random.default_rng(3)
    w = np.concatenate([rng.random(20_000) * 40.0,
                        rng.random(2000) * 1e-30,
                        np.arange(1, 3000, dtype=np.float64) ** 2,
                        [0.0, np.inf]]).astype(np.float32)
    want = np.sqrt(w.astype(np.float64)).astype(np.float32)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda t: sqrt(t) * (1.0 + skew))
    got = TR.sqrt_f32(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,k", [(16, 12), (40, 39), (9, 5)])
def test_smallest_k_is_top_k_of_minus_u(n, k):
    """lax.top_k(-u, k): the k smallest, the lower index first among equal
    values (ties forced by rounding u to a few values)."""
    rng = np.random.default_rng(n)
    u = np.floor(rng.random((30, n)) * 6).astype(np.float32) / 6
    _, want = jax.lax.top_k(-jnp.asarray(u), k)
    got = R.smallest_k(torch.from_numpy(u), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,p", [(100, 0.05), (1000, 0.2), (53, 0.2),
                                 (40, 0.97), (300, 0.04), (64, 0.15),
                                 (100, 0.5), (10_000, 0.3), (20, 0.6),
                                 (100, 1.0), (100, 0.0)])
def test_binomial_degrees_equal_jax(n, p):
    """Both regimes (inversion: n q <= 10; BTRS above), p >= 0.5 mirrored,
    the edges p = 0 and 1; a row's loop runs until its own condition
    fails."""
    keys = _row_keys(17, 2000)
    want = np.asarray(jax.vmap(lambda kk: jax.random.binomial(kk, n, p))(
        keys))
    got = R.binomial(_tk(keys), n, p).numpy()
    assert got.dtype == np.float32
    share = float((got == want).mean())
    print(f"binomial({n}, {p}): {share:.6f} of 2000 rows equal")
    assert share == 1.0


def test_binomial_runs_each_row_to_its_own_end():
    """A row accepted in an early round keeps its sample while others loop
    on: the result does not depend on the rows batched with it."""
    keys = R.split(R.PRNGKey(4), 300)
    whole = R.binomial(keys, 1000, 0.2)
    parts = torch.cat([R.binomial(keys[i:i + 7], 1000, 0.2)
                       for i in range(0, 300, 7)])
    assert torch.equal(whole, parts)
