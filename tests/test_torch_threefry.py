"""``repro_torch.random`` (threefry2x32) against ``jax.random`` on the CPU.

The port draws through ``kernels/threefry.py``, whose CPU side is the plain
version in ``kernels/ref.py``; the CUDA kernel is held to that plain
version on a card in tests/test_torch_cuda.py.

Contract (ROADMAP parity contract): keys (``PRNGKey``, ``split``,
``fold_in``), ``random_bits`` and ``uniform`` bit for bit; ``normal``
within 4 float32 ulp (XLA's ``erf_inv`` polynomial over ``log1p``, whose
last bits differ between libraries).  Measured here: the largest gap 3 ulp
and ~99% of draws bit-equal over 10^6 draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.snn import neurons as JN  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.snn import neurons as TN  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import threefry as TF  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SIZES = [1, 7, 128, 4097]
NORMAL_ULP = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(x) -> np.ndarray:
    """uint32 bits of a port key/bits tensor or a JAX array."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype != np.uint32 else a


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps (a and b of one sign, as here)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS + [-7, 2 ** 32 + 5])
def test_prng_key_is_jax_key_data(seed):
    k = R.PRNGKey(seed)
    assert k.dtype == torch.int32 and k.shape == (2,)
    np.testing.assert_array_equal(_u32(k), _u32(jax.random.key_data(
        _jkey(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 5, 1 + 2 * 4])
def test_split_is_bit_equal(seed, num):
    got = R.split(R.PRNGKey(seed), num)
    assert got.shape == (num, 2)
    np.testing.assert_array_equal(_u32(got),
                                  _u32(jax.random.split(_jkey(seed), num)))
    # a batch of keys splits each, as vmap does; then split again
    jk = jax.random.split(_jkey(seed), 3)
    want = jax.vmap(lambda k: jax.random.split(k, num))(jk)
    np.testing.assert_array_equal(
        _u32(R.split(R.split(R.PRNGKey(seed), 3), num)), _u32(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 12345, 2 ** 32 - 1])
def test_fold_in_is_bit_equal(seed, data):
    np.testing.assert_array_equal(
        _u32(R.fold_in(R.PRNGKey(seed), data)),
        _u32(jax.random.fold_in(_jkey(seed), data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_bits_and_uniform_are_bit_equal(seed, n):
    k, jk = R.PRNGKey(seed), _jkey(seed)
    np.testing.assert_array_equal(_u32(R.random_bits(k, n)),
                                  _u32(jax.random.bits(jk, (n,))))
    u = R.uniform(k, (n,))
    assert u.dtype == torch.float32 and u.shape == (n,)
    np.testing.assert_array_equal(_u32(u),
                                  _u32(jax.random.uniform(jk, (n,))))
    # [B, n] keys: each member's own draw, as vmap over keys
    jks = jax.random.split(jk, 3)
    ks = torch.from_numpy(np.asarray(jks).view(np.int32).copy())
    np.testing.assert_array_equal(
        _u32(R.uniform(ks, (n,))),
        _u32(jax.vmap(lambda kk: jax.random.uniform(kk, (n,)))(jks)))
    np.testing.assert_array_equal(
        _u32(R.random_bits(ks, (n,))),
        _u32(jax.vmap(lambda kk: jax.random.bits(kk, (n,)))(jks)))


def test_multidimensional_shapes_count_row_major():
    k, jk = R.PRNGKey(3), _jkey(3)
    np.testing.assert_array_equal(_u32(R.uniform(k, (3, 5, 7))),
                                  _u32(jax.random.uniform(jk, (3, 5, 7))))
    assert R.normal(k, ()).shape == ()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_normal_is_within_four_ulp(seed, n):
    a = np.asarray(jax.random.normal(_jkey(seed), (n,)))
    b = R.normal(R.PRNGKey(seed), (n,)).numpy()
    assert b.dtype == np.float32 and b.shape == (n,)
    assert int(_ulp(a, b).max()) <= NORMAL_ULP


def test_normal_gap_and_bit_equal_share_over_a_million_draws():
    """The largest gap and the share of bit-equal draws, reported (-s)."""
    a = np.asarray(jax.random.normal(_jkey(5), (1_000_000,)))
    b = R.normal(R.PRNGKey(5), 1_000_000).numpy()
    d = _ulp(a, b)
    share = float((d == 0).mean())
    print(f"normal vs jax.random.normal over 1e6 draws: largest gap "
          f"{int(d.max())} ulp, bit-equal share {share:.6f}")
    assert int(d.max()) <= NORMAL_ULP
    assert share > 0.95
    assert abs(float(b.mean())) < 5e-3 and abs(float(b.std()) - 1.0) < 5e-3


@pytest.mark.parametrize("s_in", [1.0, 0.7])
def test_scaled_normal_rounds_as_jax(s_in):
    """``5.0 * s_in * normal(k, (n,))`` in JAX rounds 5.0 * s_in to float32
    and multiplies once; the draw kernel's scale does the same."""
    a = np.asarray(5.0 * s_in * jax.random.normal(_jkey(9), (2000,)))
    b = R.normal(R.PRNGKey(9), (2000,), scale=5.0 * s_in).numpy()
    assert int(_ulp(a, b).max()) <= NORMAL_ULP
    plain = R.normal(R.PRNGKey(9), (2000,)).numpy()
    np.testing.assert_array_equal(b, np.float32(5.0 * s_in) * plain)


def test_erf_inv_is_xla_erf_inv():
    x = np.linspace(-0.999999, 0.999999, 20001, dtype=np.float32)
    a = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    b = TR.erf_inv_ref(torch.from_numpy(x)).numpy()
    assert int(_ulp(a, b).max()) <= NORMAL_ULP
    edge = TR.erf_inv_ref(torch.tensor([-1.0, 1.0]))
    assert edge.tolist() == [-np.inf, np.inf]


def test_izhikevich_params_are_jax_params_bit_for_bit():
    pkey, _ = jax.random.split(_jkey(1234))
    j = JN.izhikevich_population_params(pkey, 800, 200)
    t = TN.izhikevich_population_params(R.split(R.PRNGKey(1234))[0], 800,
                                        200)
    for k in "abcd":
        assert t[k].dtype == torch.float32
        np.testing.assert_array_equal(_u32(t[k]), _u32(j[k]))


def test_wrappers_take_the_plain_version_on_the_cpu_and_check_arguments():
    TF.reset_launches()
    keys = R.split(R.PRNGKey(0), 4)
    col = R.split(keys, 5)[:, 2]                 # strided rows, as a step's
    assert not col.is_contiguous()
    assert torch.equal(TF.threefry_draw(col, 9, "uniform"),
                       TF.threefry_draw(col.contiguous(), 9, "uniform"))
    assert TF.launches == {"threefry_split": 0, "threefry_draw": 0,
                           "threefry_draw.randint": 0,
                           "threefry_fold_in": 0}
    with pytest.raises(ValueError):
        TF.threefry_draw(keys, 4, "gamma")
    with pytest.raises(ValueError):
        R.split(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        R.fold_in(R.PRNGKey(0), 2 ** 32)
