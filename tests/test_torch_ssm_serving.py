"""repro_torch's Mamba2 serving forms (``models/ssm.py``) against the JAX
package's on the CPU: ``ssd_chunked`` with an initial and a final state,
``ssm_apply(return_state=True)`` (the conv history and the SSD state after
the prompt, through ``kernels.ops.ssd_scan_state``), ``ssm_init_cache``
and ``ssm_decode_step``, and decode held to the full-sequence forward over
the same tokens (the JAX package's ``test_decode_matches_forward``), in
the block and in the ssm and hybrid models.

Tolerances, and why: the SSD and its states within 2e-4 (the parity
contract's SSD tolerance: float32 chunked sums in another order); block
outputs and decode steps within rtol=atol=1e-4 (float32 through a
projection, a conv and a gated RMSNorm); decode against the forward as
the JAX test holds it: 2e-4 for the prefill's last logits, 2e-3 for the
decoded ones.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(b, t, h, dh, g, ds, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, t, h, dh)).astype(np.float32),
            (0.001 + 0.1 * r.random((b, t, h))).astype(np.float32),
            (-np.exp(2.0 * r.random(h))).astype(np.float32),
            r.standard_normal((b, t, g, ds)).astype(np.float32),
            r.standard_normal((b, t, g, ds)).astype(np.float32),
            r.standard_normal(h).astype(np.float32)]


@pytest.mark.parametrize("shape", [(2, 64, 4, 8, 1, 16), (1, 96, 3, 16, 1, 8),
                                   (2, 37, 4, 8, 2, 8)],
                         ids=["t64", "t96_chunk32", "t37_groups2"])
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_final_state_matches_jax(shape, initial):
    arrs = _ssd_inputs(*shape, seed=1)
    b, _, h, dh, _, ds = shape
    s0 = (np.random.default_rng(2).standard_normal((b, h, ds, dh))
          .astype(np.float32) if initial else None)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, arrs), chunk=32,
                            initial_state=None if s0 is None
                            else jnp.asarray(s0), return_final_state=True)
    ty, ts = TS.ssd_chunked(*map(torch.tensor, arrs), chunk=32,
                            initial_state=None if s0 is None
                            else torch.tensor(s0), return_final_state=True)
    assert ts.shape == (b, h, ds, dh) and ts.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SSD_TOL)
    # the state wrapper's plain route is the same function, uncounted
    SSD.reset_launches()
    wy, ws = SSD.ssd_scan_state(*map(torch.tensor, arrs),
                                initial_state=None if s0 is None
                                else torch.tensor(s0))
    assert SSD.launches == {"ssd_scan": 0, "ssd_scan.state": 0}
    np.testing.assert_allclose(ws.numpy(), np.asarray(js), **SSD_TOL)
    np.testing.assert_allclose(wy.numpy(), np.asarray(jy), **SSD_TOL)


def test_final_state_continues_the_scan():
    """The state after t rows, carried into the next t' rows, gives the
    scan over t + t' rows (the split the chunk does not see)."""
    arrs = [torch.tensor(a) for a in _ssd_inputs(2, 70, 3, 8, 1, 16, seed=3)]
    y, s = TS.ssd_chunked(*arrs, return_final_state=True)

    def rows(sl):             # A and D have no time axis
        return [a[:, sl] if a.dim() > 1 else a for a in arrs]

    head, tail = rows(slice(0, 45)), rows(slice(45, None))
    y1, s1 = TS.ssd_chunked(*head, return_final_state=True)
    y2, s2 = TS.ssd_chunked(*tail, initial_state=s1, return_final_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SSD_TOL)
    torch.testing.assert_close(s2, s, **SSD_TOL)


def _block(d_model=32, d_state=16, d_head=8, n_groups=1, seed=0):
    jc = JS.SSMConfig(d_model=d_model, d_state=d_state, d_head=d_head,
                      n_groups=n_groups)
    tc = TS.SSMConfig(**dataclasses.asdict(jc))
    jp = JS.ssm_init(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, {k: torch.tensor(np.asarray(v)) for k, v in
                        jp.items()}


@pytest.mark.parametrize("t", [1, 2, 12])
def test_ssm_apply_with_state_matches_jax(t):
    """t = 1 and 2 are shorter than the conv history (3 rows): its state
    then holds zero rows of the padding."""
    jc, tc, jp, tp = _block()
    u = np.random.default_rng(4).standard_normal((2, t, 32)) \
        .astype(np.float32)
    jy, (jconv, jssd) = JS.ssm_apply(jp, jc, jnp.asarray(u),
                                     return_state=True)
    ty, (tconv, tssd) = TS.ssm_apply(tp, tc, torch.tensor(u),
                                     return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BLOCK_TOL)
    assert tconv.shape == jconv.shape and tssd.shape == jssd.shape
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **BLOCK_TOL)
    np.testing.assert_allclose(tssd.numpy(), np.asarray(jssd), **SSD_TOL)
    # the state form's output is the stateless one's
    np.testing.assert_allclose(ty.numpy(), TS.ssm_apply(
        tp, tc, torch.tensor(u)).numpy(), rtol=1e-6, atol=1e-6)


def test_ssm_apply_from_a_state_matches_jax():
    """A conv history and an SSD state handed in (the plain route)."""
    jc, tc, jp, tp = _block()
    r = np.random.default_rng(5)
    u = r.standard_normal((2, 9, 32)).astype(np.float32)
    conv = r.standard_normal((2, 3, 64 + 32)).astype(np.float32)
    ssd = r.standard_normal((2, 8, 16, 8)).astype(np.float32)
    jy, (jconv, jssd) = JS.ssm_apply(jp, jc, jnp.asarray(u),
                                     conv_state=jnp.asarray(conv),
                                     ssd_state=jnp.asarray(ssd),
                                     return_state=True)
    ty, (tconv, tssd) = TS.ssm_apply(tp, tc, torch.tensor(u),
                                     conv_state=torch.tensor(conv),
                                     ssd_state=torch.tensor(ssd),
                                     return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BLOCK_TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **BLOCK_TOL)
    np.testing.assert_allclose(tssd.numpy(), np.asarray(jssd), **SSD_TOL)
    with pytest.raises(ValueError, match="return_state"):
        TS.ssm_apply(tp, tc, torch.tensor(u), ssd_state=torch.tensor(ssd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_cache_matches_jax(dtype):
    jc, tc, _, _ = _block()
    jcache = JS.ssm_init_cache(jc, 3, getattr(jnp, dtype))
    tcache = TS.ssm_init_cache(tc, 3, getattr(torch, dtype))
    assert sorted(tcache) == sorted(jcache) == ["conv", "ssd"]
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        assert str(tcache[k].dtype).split(".")[1] == str(jcache[k].dtype), k
        assert not tcache[k].any()
    assert tcache["ssd"].dtype == torch.float32
    assert TS.ssm_init_cache(tc, 1)["conv"].dtype == torch.float32


@pytest.mark.parametrize("n_groups", [1, 2])
def test_decode_steps_match_jax_and_the_forward(n_groups):
    """Prefill 10 rows with their state, then six decode steps: each step
    against JAX's (outputs and both caches), and against the full-sequence
    block over the same 16 rows."""
    jc, tc, jp, tp = _block(n_groups=n_groups)
    u = np.random.default_rng(6).standard_normal((2, 16, 32)) \
        .astype(np.float32)
    full = TS.ssm_apply(tp, tc, torch.tensor(u))
    _, (jconv, jssd) = JS.ssm_apply(jp, jc, jnp.asarray(u[:, :10]),
                                    return_state=True)
    _, (tconv, tssd) = TS.ssm_apply(tp, tc, torch.tensor(u[:, :10]),
                                    return_state=True)
    jcache = {"conv": jconv.astype(jnp.float32), "ssd": jssd}
    tcache = {"conv": tconv.float(), "ssd": tssd}
    for i in range(10, 16):
        jy, jcache = JS.ssm_decode_step(jp, jc, jnp.asarray(u[:, i:i + 1]),
                                        jcache)
        ty, tcache = TS.ssm_decode_step(tp, tc, torch.tensor(u[:, i:i + 1]),
                                        tcache)
        assert ty.shape == (2, 1, 32)
        assert tcache["conv"].dtype == tcache["ssd"].dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BLOCK_TOL)
        np.testing.assert_allclose(tcache["conv"].numpy(),
                                   np.asarray(jcache["conv"]), **BLOCK_TOL)
        np.testing.assert_allclose(tcache["ssd"].numpy(),
                                   np.asarray(jcache["ssd"]), **SSD_TOL)
        np.testing.assert_allclose(ty[:, 0].numpy(), full[:, i].numpy(),
                                   **BLOCK_TOL)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b",
                                  "granite-moe-1b-a400m"])
def test_model_decode_matches_forward(arch):
    """The JAX package's test_decode_matches_forward on the port (reduced,
    JAX's weights): prefill 12 tokens, decode 2, against ``forward`` over
    the 14, in the JAX test's tolerances; and the port's steps against
    JAX's."""
    jc = jreduced(jget_config(arch))
    tc = reduced(get_config(arch))
    jp = JT.init_params(jc, jax.random.PRNGKey(1))
    tp = load_lm_params(tc, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(7).integers(0, tc.vocab, (2, 15))
    tt = torch.tensor(toks)
    full, _ = TT.forward(tp, tc, tt[:, :14])
    lg, caches = TT.prefill(tp, tc, tt[:, :12], cache_dtype=torch.float32,
                            max_seq=20)
    l1, caches = TT.decode_step(tp, tc, caches, tt[:, 12])
    l2, caches = TT.decode_step(tp, tc, caches, tt[:, 13])
    v = tc.vocab
    np.testing.assert_allclose(lg[:, :v].numpy(), full[:, 11, :v].detach()
                               .numpy(), rtol=2e-4, atol=2e-4)
    for got, i in ((l1, 12), (l2, 13)):
        np.testing.assert_allclose(got[:, :v].numpy(),
                                   full[:, i, :v].detach().numpy(),
                                   rtol=2e-3, atol=2e-3)
    jl, jcaches = JT.prefill(jp, jc, jnp.asarray(toks[:, :12], jnp.int32),
                             cache_dtype=jnp.float32, max_seq=20)
    jl1, _ = JT.decode_step(jp, jc, jcaches,
                            jnp.asarray(toks[:, 12], jnp.int32))
    np.testing.assert_allclose(l1[:, :v].numpy(), np.asarray(jl1)[:, :v],
                               rtol=1e-4, atol=1e-4)
