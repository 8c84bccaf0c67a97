"""The MoE, SSM and hybrid families through the port's token server and
training loss, against the JAX package on the CPU at the reduced sizes,
the JAX weights carried over (``convert.load_lm_params``).

- ``Server`` against ``repro.launch.serve.Server`` for granite-moe,
  mixtral, mamba2 and zamba2: the port's greedy tokens equal JAX's wherever
  JAX's top-2 margin exceeds 1e-3 (``test_server_matches_jax_server``'s
  rule: bf16 caches drift decode logits by ~1e-3 between the packages).
- granite-moe at capacity factor 1.0, where prefill drops (token, slot)
  pairs (``reduced`` is dropless at 8.0): prefill logits and caches, six
  decode steps, ``loss_fn``'s ce and aux and every gradient, and the
  remat gradients equal to the ones without, at
  ``tests/test_torch_lm_serve.py``'s and ``tests/test_torch_train.py``'s
  tolerances.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ACT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b",
                                  "mamba2-2.7b", "zamba2-7b"])
def test_server_matches_jax_server(arch):
    """3 requests, max_batch 2: two admission waves, bf16 caches."""
    jsrv = JS.Server(arch, use_reduced=True, max_batch=2, max_seq=64)
    tsrv = TS.Server(arch, use_reduced=True, max_batch=2, max_seq=64,
                     device="cpu")
    tsrv.params = load_lm_params(tsrv.cfg,
                                 jax.tree.map(np.asarray, jsrv.params), "cpu")
    margins = {}

    def recording(logits, req, _sample=jsrv._sample):
        top2 = np.sort(np.asarray(logits, np.float32))[-2:]
        margins.setdefault(req.rid, []).append(float(top2[1] - top2[0]))
        return _sample(logits, req)

    jsrv._sample = recording
    rng = np.random.default_rng(1)
    pairs = []
    for i, n in enumerate((5, 7, 6)):
        prompt = rng.integers(3, tsrv.cfg.vocab, size=n).tolist()
        pairs.append((JS.Request(rid=i, prompt=prompt, max_new=6),
                      TS.Request(rid=i, prompt=prompt, max_new=6)))
        jsrv.submit(pairs[-1][0])
        tsrv.submit(pairs[-1][1])
    jsrv.run()
    FA.reset_launches()
    SSD.reset_launches()
    finished = tsrv.run()
    assert not any({**FA.launches, **SSD.launches}.values())
    compared = 0
    for jr, tr in pairs:
        assert tr.done and len(tr.out) == 6
        for j, (a, b) in enumerate(zip(jr.out, tr.out)):
            if a != b:        # a near tie in JAX: later tokens diverge
                assert margins[jr.rid][j] <= 1e-3, (jr.rid, j, jr.out,
                                                    tr.out)
                break
            compared += 1
    assert compared >= 12, f"only {compared} of 18 tokens compared"
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert [w["size"] for w in tsrv.waves] == [2, 1]
    assert [w["decode_steps"] for w in tsrv.waves] == [5, 5]


CF = 1.0                   # granite-moe's capacity factor with drops


def _granite(**overrides):
    kw = dict(moe_capacity_factor=CF, **overrides)
    jc = jreduced(jget_config("granite-moe-1b-a400m"), **kw)
    tc = reduced(get_config("granite-moe-1b-a400m"), **kw)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = load_lm_params(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def granite():
    """``_granite()``, drawn once for the module's tests."""
    return _granite()


def _counting_drops():
    """Patch ``moe_route`` to count the pairs each call drops."""
    seen = []
    real = TM.moe_route

    def route(p, cfg, xg, cap, n_ranks=1):
        out = real(p, cfg, xg, cap, n_ranks)
        seen.append(int((~out[2]).sum()))
        return out

    return seen, mock.patch.object(TM, "moe_route", route)


def test_granite_with_drops_prefill_and_decode_match_jax(granite):
    jc, tc, jp, tp = granite
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (2, 40)).astype(np.int32)
    jl, jcache = JT.prefill(jp, jc, jnp.asarray(toks), max_seq=64,
                            cache_dtype=jnp.float32)
    seen, patch = _counting_drops()
    with patch:
        tl, tcache = TT.prefill(tp, tc, torch.tensor(toks).long(),
                                max_seq=64, cache_dtype=torch.float32)
    assert len(seen) == jc.n_layers and sum(seen) > 0, seen
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    for step in range(6):
        tok = rng.integers(0, jc.vocab, (2,)).astype(np.int32)
        jl, jcache = JT.decode_step(jp, jc, jcache, jnp.asarray(tok))
        tl, tcache = TT.decode_step(tp, tc, tcache, torch.tensor(tok).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    for a, b in zip(jcache["segments"], tcache["segments"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(b[key].numpy(), _np(a[key]),
                                       **ACT_TOL)


def test_granite_with_drops_loss_and_gradients_match_jax(granite):
    jc, tc, jp, tp = granite
    tp = tree_map(torch.clone, tp)    # the gradient's leaves are its own
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 33)) \
        .astype(np.int32)
    (jl, jm), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    paths, leaves = zip(*_leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    seen, patch = _counting_drops()
    with patch:
        tl, tm = TT.loss_fn(tp, tc, {"tokens": torch.tensor(toks)})
    assert sum(seen) > 0, seen
    grads = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    for got, want in ((tl, jl), (tm["ce"], jm["ce"]), (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    jleaves = dict(_leaves(jgrads))
    assert sorted(jleaves) == sorted(grads)
    for path, g in grads.items():
        a = np.asarray(jleaves[path])
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=2e-5 * np.abs(a).max(), err_msg=path)
    # remat recomputes the same routing: the same gradients, bit for bit
    rc = dataclasses.replace(tc, remat=True, remat_policy="full")
    tl2, _ = TT.loss_fn(tp, rc, {"tokens": torch.tensor(toks)})
    grads2 = torch.autograd.grad(tl2, leaves)
    assert torch.equal(tl.detach(), tl2.detach())
    for path, g2 in zip(paths, grads2):
        assert torch.equal(grads[path], g2), path
