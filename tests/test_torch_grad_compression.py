"""``repro_torch.optim.grad_compression`` against the JAX package's, bit for
bit: the int8 codes, the float32 block scales and the new error of
``compress_leaf``, ``decompress_leaf``'s values, and the tree versions
``ef_compress`` / ``ef_decompress_apply`` (the JAX leaf order: dict keys
sorted), on leaves that are not a multiple of the 2048-entry block, a
zero leaf (scales floored at 1e-30, codes 0), a bfloat16 gradient, and
values at exact halves of a scale step (rounding half to even).  Also the
error-feedback property of ``tests/test_substrate.py`` (deq + new error
== g + error) and the 4x ratio.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.optim import grad_compression as JGC  # noqa: E402
from repro_torch.optim import grad_compression as GC  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(n, seed, scale=1.0):
    r = np.random.default_rng(seed)
    return (r.standard_normal(n) * scale).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


def _same(port, jx):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    jx = np.asarray(jx)
    assert port.shape == jx.shape and port.dtype == jx.dtype
    np.testing.assert_array_equal(_bits(port), _bits(jx))


def _halves():
    """A block whose max is 127 (scale 1.0): every x.5 rounds to even."""
    g = np.zeros(2048, np.float32)
    g[0] = 127.0
    g[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return g


CASES = {
    "ragged": (_leaf(5000, 1, 3.0), _leaf(5000, 2, 0.01)),
    "short": (_leaf(37, 3), np.zeros(37, np.float32)),
    "zero": (np.zeros((3, 700), np.float32), np.zeros((3, 700), np.float32)),
    "matrix": (_leaf(64 * 96, 4, 0.1).reshape(64, 96),
               _leaf(64 * 96, 5, 1e-3).reshape(64, 96)),
    "halves": (_halves(), np.zeros(2048, np.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_leaf_matches_jax_bit_for_bit(case):
    g, e = CASES[case]
    q, s, ne = GC.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    jq, js, jne = JGC.compress_leaf(jnp.asarray(g), jnp.asarray(e))
    _same(q, jq)
    _same(s, js)
    _same(ne, jne)
    _same(GC.decompress_leaf(q, s, g.shape),
          JGC.decompress_leaf(jq, js, g.shape))
    if case == "zero":
        assert np.all(s.numpy() == np.float32(1e-30))
        assert not q.any()
    if case == "halves":
        assert q[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


def test_bfloat16_gradient_matches_jax():
    g = _leaf(3000, 6)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    e = torch.from_numpy(_leaf(3000, 7, 0.01))
    q, s, ne = GC.compress_leaf(gb, e)
    jq, js, jne = JGC.compress_leaf(
        jnp.asarray(g).astype(jnp.bfloat16), jnp.asarray(e.numpy()))
    _same(q, jq)
    _same(s, js)
    _same(ne, jne)


def test_tree_versions_match_jax():
    names = ("b", "a", "c")
    grads = {"b": _leaf(2100, 8), "a": [_leaf(10, 9), _leaf(4096, 10)],
             "c": np.zeros(5, np.float32)}
    tg = {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
              else torch.from_numpy(v)) for k, v in grads.items()}
    jg = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
              else jnp.asarray(v)) for k, v in grads.items()}
    errs = GC.init_error(tg)
    jerrs = JGC.init_error(jg)
    for _ in range(2):                      # a second step carries the error
        qt, st_, errs = GC.ef_compress(tg, errs)
        jqt, jst, jerrs = JGC.ef_compress(jg, jerrs)
        for k in names:
            a, b = qt[k], jqt[k]
            pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
            for x, y in pairs:
                _same(x, y)
        out = GC.ef_decompress_apply(qt, st_, tg)
        jout = JGC.ef_decompress_apply(jqt, jst, jg)
        _same(out["b"], jout["b"])
        _same(out["a"][1], jout["a"][1])
        _same(errs["a"][0], jerrs["a"][0])
        _same(errs["c"], jerrs["c"])
    assert list(out) == list(tg)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(10, 5000))
def test_property_error_feedback_unbiased(seed, n):
    """deq + new_err == g + err (the JAX package's property)."""
    r = np.random.default_rng(seed)
    g = torch.from_numpy((r.standard_normal(n) * r.uniform(0.1, 10))
                         .astype(np.float32))
    e = torch.from_numpy((r.standard_normal(n) * 0.01).astype(np.float32))
    q, s, ne = GC.compress_leaf(g, e)
    deq = GC.decompress_leaf(q, s, tuple(g.shape))
    np.testing.assert_allclose((deq + ne).numpy(), (g + e).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_compression_ratio_int8():
    g = torch.ones(4096)
    q, s, _ = GC.compress_leaf(g, torch.zeros_like(g))
    assert q.dtype == torch.int8
    ratio = g.nbytes / (q.nbytes + s.nbytes)
    assert ratio > 3.5
