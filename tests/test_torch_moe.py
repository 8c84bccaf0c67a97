"""repro_torch's MoE FFN (``models/moe.py``) against the JAX package's
``repro/models/moe.py`` on the CPU, and the invariants of
``tests/test_moe.py`` ported case for case.

The routing is compared exactly: each token's k experts and each pair's
keep flag.  Where the two packages choose another expert, the test asserts
a near tie: JAX's two competing probabilities within 1e-6 (the softmax's
last bit differs between XLA and torch; the rule is the greedy-token
margin rule of the serving tests).  Inputs are float32 from numpy seeds,
the weights JAX's, carried over.

Tolerances, and why: y within rtol=atol=1e-5 (float32; the k gated
expert outputs are summed in another order: JAX's one-hot contraction
sums them by expert, the port by slot); aux within 1e-6 relative (float32
means over the same values).
"""

import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

Y_TOL = dict(rtol=1e-5, atol=1e-5)
TIE = 1e-6

# name -> (MoEConfig fields, x shape, zero router): dropless and with
# drops, all ties, a decode wave of 8 tokens at mixtral's e=8, k=2 (cap 2),
# and a group size that halves (3 * 20 = 60 tokens: 64 -> 32 -> 16 -> 8 ->
# 4, groups of 4)
CASES = {
    "dropless": (dict(n_experts=4, top_k=2, capacity_factor=8.0,
                      group_size=64), (2, 32, 32), False),
    "drops": (dict(n_experts=4, top_k=2, capacity_factor=0.9,
                   group_size=32), (2, 48, 32), False),
    "zero_router": (dict(n_experts=4, top_k=2, capacity_factor=0.9,
                         group_size=32), (2, 48, 32), True),
    "decode_wave": (dict(n_experts=8, top_k=2, capacity_factor=1.25,
                         group_size=1024), (8, 1, 32), False),
    "halving_group": (dict(n_experts=4, top_k=2, capacity_factor=1.0,
                           group_size=64), (3, 20, 32), False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(fields, dispatch):
    jc = JM.MoEConfig(d_model=32, d_ff=64, dispatch=dispatch, **fields)
    return jc, TM.MoEConfig(**dataclasses.asdict(jc))


def _params(jc, zero_router, seed=0):
    jp = JM.moe_init(jax.random.PRNGKey(seed), jc)
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _jax_route(jp, jc, x):
    """The JAX function's routing (``repro/models/moe.py`` lines 96-116):
    (probs, expert_idx, keep) of its groups."""
    b, t, d = x.shape
    n = b * t
    gs = min(jc.group_size, n)
    while n % gs:
        gs //= 2
    cap = min(max(jc.top_k, int(jc.capacity_factor * gs * jc.top_k
                                / jc.n_experts)), gs)
    xg = jnp.asarray(x).reshape(n // gs, gs, d)
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, jc.top_k)
    oh = jax.nn.one_hot(idx, jc.n_experts, dtype=jnp.float32)
    flat = oh.reshape(n // gs, gs * jc.top_k, jc.n_experts)
    pos = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    keep = pos.reshape(idx.shape) < cap
    return np.asarray(probs), np.asarray(idx), np.asarray(keep), gs, cap


def _assert_same_routing(jp, jc, tp, tc, x):
    probs, jidx, jkeep, gs, cap = _jax_route(jp, jc, x)
    assert TM.group_and_capacity(tc, x.shape[0] * x.shape[1]) == (gs, cap)
    xg = torch.tensor(x).reshape(-1, gs, x.shape[-1])
    tidx, _, tkeep, _, _ = TM.moe_route(tp, tc, xg, cap)
    tidx, tkeep = tidx.numpy(), tkeep.numpy()
    diff = np.argwhere((tidx != jidx).any(-1))
    for gi, ti in diff:         # a near tie in JAX: the choices may differ
        p = np.sort(probs[gi, ti])[::-1]
        k = jc.top_k
        assert p[k - 1] - p[k] <= TIE, (gi, ti, p)
    same = np.ones(jidx.shape[:2], bool)
    same[tuple(diff.T)] = False
    # the queues of a group depend on every earlier pair: compare the keep
    # mask on groups where every choice agrees
    whole = same.all(-1)
    np.testing.assert_array_equal(tkeep[whole], jkeep[whole])
    return len(diff), int((~jkeep).sum())


@pytest.mark.parametrize("dispatch", ["onehot", "gather"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case, dispatch):
    fields, shape, zero = CASES[case]
    jc, tc = _configs(fields, dispatch)
    jp, tp = _params(jc, zero)
    x = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    ties, dropped = _assert_same_routing(jp, jc, tp, tc, x)
    assert ties == 0, f"{ties} near ties at this seed"
    if case in ("drops", "zero_router", "decode_wave"):
        assert dropped > 0, "the case drops no pair"
    if case == "dropless":
        assert dropped == 0
    jy, ja = JM.moe_apply(jp, jc, jnp.asarray(x))
    ty, ta = TM.moe_apply(tp, tc, torch.tensor(x))
    assert ty.shape == shape and ta.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_zero_router_takes_the_lowest_experts():
    """All probabilities tie: both packages take experts 0..k-1, gates 1/k,
    and the queues fill token by token."""
    fields, shape, _ = CASES["zero_router"]
    jc, tc = _configs(fields, "onehot")
    _, tp = _params(jc, True)
    x = torch.tensor(np.random.default_rng(11).standard_normal(shape),
                     dtype=torch.float32)
    gs, cap = TM.group_and_capacity(tc, shape[0] * shape[1])
    idx, place, keep, gate, aux = TM.moe_route(
        tp, tc, x.reshape(-1, gs, shape[-1]), cap)
    assert (idx == torch.arange(tc.top_k)).all()
    assert (place == torch.arange(gs)[None, :, None]).all()
    assert torch.equal(keep, place < cap)
    assert torch.allclose(gate[keep], torch.full_like(gate[keep], 0.5))
    assert (gate[~keep] == 0).all()


def test_decode_wave_capacity_is_two_of_eight():
    """mixtral's e=8, k=2 on a decode wave of 8 tokens: one group of 8 and
    a capacity of 2, whatever the tokens are."""
    jc, tc = _configs(CASES["decode_wave"][0], "onehot")
    assert TM.group_and_capacity(tc, 8) == (8, 2)
    granite = TM.MoEConfig(d_model=32, d_ff=64, n_experts=32, top_k=8)
    assert TM.group_and_capacity(granite, 8) == (8, 8)
    assert TM.group_and_capacity(granite, 8 * 1017) == (8, 8)
    assert TM.group_and_capacity(granite, 8 * 1024) == (1024, 320)


def test_moe_gradients_match_jax():
    """d(sum y + aux) by x, the router and the experts, with drops."""
    fields, shape, _ = CASES["drops"]
    jc, tc = _configs(fields, "onehot")
    jp, tp = _params(jc, False)
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JM.moe_apply(p, jc, x)
        return jnp.sum(y * jnp.cos(y)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    for v in tp.values():
        v.requires_grad_(True)
    y, aux = TM.moe_apply(tp, tc, tx)
    grads = torch.autograd.grad((y * torch.cos(y)).sum() + aux,
                                [tx] + list(tp.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    for k, g in zip(tp, grads[1:]):
        a = np.asarray(jgp[k])
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(), err_msg=k)


def test_moe_init_matches_jax_shapes_and_dtypes():
    jc, tc = _configs(CASES["dropless"][0], "onehot")
    jp = JM.moe_init(jax.random.PRNGKey(0), jc, jnp.bfloat16)
    tp = TM.moe_init(torch.Generator().manual_seed(0), tc, torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[1] == str(jp[k].dtype), k
    assert tp["router"].dtype == torch.float32


def test_unknown_dispatch_raises():
    jc, tc = _configs(CASES["dropless"][0], "onehot")
    _, tp = _params(jc, False)
    with pytest.raises(ValueError, match="dispatch"):
        TM.moe_apply(tp, dataclasses.replace(tc, dispatch="dense"),
                     torch.zeros(1, 4, 32))


# ---------------------------------------------------------------------------
# tests/test_moe.py, case for case, on the port
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(2)


def _setup(e=4, k=2, d=32, f=64, cf=8.0, gs=64):
    cfg = TM.MoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k,
                       capacity_factor=cf, group_size=gs)
    return cfg, TM.moe_init(torch.Generator().manual_seed(0), cfg)


def test_output_shape_and_finite():
    cfg, p = _setup()
    x = torch.tensor(RNG.standard_normal((2, 16, 32)), dtype=torch.float32)
    y, aux = TM.moe_apply(p, cfg, x)
    assert y.shape == x.shape
    assert torch.isfinite(aux) and torch.isfinite(y).all()


def test_aux_loss_uniform_router_near_one():
    """Balanced routing drives the Switch aux loss to ~ aux_weight * 1.0."""
    cfg, p = _setup(e=8, k=1)
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = torch.tensor(RNG.standard_normal((4, 64, 32)), dtype=torch.float32)
    _, aux = TM.moe_apply(p, cfg, x)
    np.testing.assert_allclose(float(aux) / cfg.aux_loss_weight, 1.0,
                               rtol=0.15)


def test_dropless_equals_dense_computation():
    """With top_k == n_experts and a large capacity, the MoE is the
    probability-weighted sum of every expert."""
    cfg, p = _setup(e=2, k=2, cf=16.0)
    x = torch.tensor(RNG.standard_normal((1, 8, 32)), dtype=torch.float32)
    y, _ = TM.moe_apply(p, cfg, x)
    xf = x.reshape(-1, 32)
    probs = torch.softmax(xf @ p["router"], -1)
    outs = [(torch.nn.functional.silu(xf @ p["w_gate"][e])
             * (xf @ p["w_up"][e])) @ p["w_out"][e] for e in range(2)]
    dense = sum(probs[:, e:e + 1] * outs[e] for e in range(2))
    np.testing.assert_allclose(y.reshape(-1, 32).numpy(), dense.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_capacity_drops_tokens_deterministically():
    cfg, p = _setup(e=2, k=1, cf=0.51, gs=8)   # cap 2 per expert
    router = torch.zeros_like(p["router"])
    router[:, 0] = 10.0                        # everyone to expert 0
    p = dict(p, router=router)
    x = torch.tensor(RNG.standard_normal((1, 8, 32)), dtype=torch.float32)
    y, _ = TM.moe_apply(p, cfg, x)
    norms = torch.linalg.norm(y[0], dim=-1)
    assert (norms[:2] > 1e-6).all()
    assert (norms[4:] < 1e-6).all()


@settings(max_examples=10, deadline=None)
@given(e=st.sampled_from([2, 4, 8]), k=st.sampled_from([1, 2]),
       seed=st.integers(0, 1000))
def test_property_gate_conservation(e, k, seed):
    """Kept tokens' outputs are convex combinations: the gates of a token
    sum to at most 1, and aux is non-negative."""
    cfg = TM.MoEConfig(d_model=16, d_ff=32, n_experts=e, top_k=k,
                       capacity_factor=8.0, group_size=32)
    p = TM.moe_init(torch.Generator().manual_seed(seed), cfg)
    x = torch.tensor(np.random.default_rng(seed).standard_normal(
        (1, 16, 16)), dtype=torch.float32)
    y, aux = TM.moe_apply(p, cfg, x)
    assert torch.isfinite(y).all() and float(aux) >= 0.0
    _, _, _, gate, _ = TM.moe_route(p, cfg, x.reshape(1, 16, 16), 16)
    assert (gate.sum(-1) <= 1.0 + 1e-6).all()


def test_gather_dispatch_equals_onehot():
    """Both dispatches give the same function, capacity drops included."""
    for cf in (8.0, 0.9):
        cfg_o = TM.MoEConfig(d_model=32, d_ff=64, n_experts=4, top_k=2,
                             capacity_factor=cf, group_size=32,
                             dispatch="onehot")
        cfg_g = dataclasses.replace(cfg_o, dispatch="gather")
        p = TM.moe_init(torch.Generator().manual_seed(0), cfg_o)
        x = torch.tensor(RNG.standard_normal((2, 48, 32)),
                         dtype=torch.float32)
        yo, ao = TM.moe_apply(p, cfg_o, x)
        yg, ag = TM.moe_apply(p, cfg_g, x)
        np.testing.assert_allclose(yg.numpy(), yo.numpy(), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(float(ag), float(ao), rtol=1e-6)
