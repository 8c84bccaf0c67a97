"""The encdec family (whisper-tiny) on the port against the JAX package, on
the CPU at ``reduced()`` size (4 decoder and 2 encoder layers, d 128,
``enc_seq`` 16, float32), the JAX weights carried over by
``convert.load_lm_params``: cross-attention (``attention_forward(kv=)``,
``attention_decode(cross=True)``), the encoder, the decoder's
cross-attention and its ``{"self", "cross"}`` caches, teacher-forced
decode, the loss and every gradient (the encoder's included); the server
and the trainer are ``tests/test_torch_encdec_serving.py``'s.  The JAX
package runs its plain jnp attention (as ``tests/test_models_smoke.py``
runs it on the CPU); the port its plain versions.

Tolerances (ROADMAP's parity contract), and why:
- logits (forward, prefill, decode with float32 caches): rtol=atol=1e-4;
  activations and float32 caches 1e-5 (XLA's and torch's CPU rsqrt, sin
  and cos differ in the last bit);
- teacher-forced decode against the port's own full forward: JAX's
  ``test_decode_matches_forward`` bounds (2e-4 for the prefill's last
  logits, 2e-3 for decoded ones);
- the loss within rtol=1e-5; every gradient within rtol=1e-4 plus 2e-5 of
  the leaf's largest entry (``tests/test_torch_train.py``'s).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "whisper-tiny"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ACT_TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and small
    CPU ops under several spinning thread pools ran ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.tensor(np.asarray(a))


def _leaves(tree, path=""):
    """(path, leaf) pairs, dict keys sorted (the JAX package's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def whisper():
    """The reduced configs, the JAX weights in both packages, a token
    batch [B, T + 3] and audio frames [B, enc_seq, d]."""
    jc, tc = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = load_lm_params(tc, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab, (B, T + 3)).astype(np.int32)
    audio = rng.standard_normal((B, jc.enc_seq, jc.d_model)) \
        .astype(np.float32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks, audio=audio)


@pytest.fixture(scope="module")
def jax_prefill(whisper):
    """The JAX package's prefill of the first T tokens (float32 caches) and
    3 decode steps: (logits, caches) after each."""
    w = whisper
    extra = {"audio": jnp.asarray(w["audio"])}
    lg, caches = JT.prefill(w["jp"], w["jc"], jnp.asarray(w["toks"][:, :T]),
                            extra, cache_dtype=jnp.float32, max_seq=T + 8)
    out = [(lg, caches)]
    for j in range(3):
        lg, caches = JT.decode_step(w["jp"], w["jc"], caches,
                                    jnp.asarray(w["toks"][:, T + j]))
        out.append((lg, caches))
    return out


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [dict(), dict(qk_norm=True, qkv_bias=True)],
                         ids=["plain", "qk_norm_bias"])
def test_cross_attention_matches_jax(opts):
    """``kv=`` (no rope on the query, non-causal, Tq 5 != Tk 9) and the
    cross decode step (no insert, every slot with pos >= 0)."""
    jcfg = JA.AttnConfig(d_model=32, n_heads=4, n_kv=2, head_dim=16,
                         causal=False, **opts)
    tcfg = TA.AttnConfig(**dataclasses.asdict(jcfg))
    jp = JA.attn_init(jax.random.PRNGKey(3), jcfg)
    if "bq" in jp:
        jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    tp = jax.tree.map(_t, jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    jy = JA.attention_forward(jp, jcfg, jnp.asarray(x),
                              kv=(jnp.asarray(k), jnp.asarray(v)))
    ty = TA.attention_forward(tp, tcfg, _t(x), kv=(_t(k), _t(v)))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **ACT_TOL)

    jc = JA.fill_cache(JA.init_cache(jcfg, 2, 9, jnp.float32),
                       jnp.asarray(k), jnp.asarray(v))
    tc = TA.fill_cache(TA.init_cache(tcfg, 2, 9, torch.float32), _t(k),
                       _t(v))
    before = {n: tc[n].clone() for n in ("k", "v", "pos")}
    for i in (5, 6, 40):
        x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, _ = JA.attention_decode(jp, jcfg, jnp.asarray(x1), jc, i,
                                    cross=True)
        ty, tc = TA.attention_decode(tp, tcfg, _t(x1), tc, i, cross=True)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **ACT_TOL)
    assert all(torch.equal(tc[n], before[n]) for n in before)


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------

def test_init_params_has_the_jax_tree(whisper):
    """The port's own draw: the JAX package's tree, shapes and dtypes (the
    encoder, each decoder layer's ln_x and xattn), pos_embed N(0, 0.02^2)."""
    w = whisper
    tp = TT.init_params(w["tc"], torch.Generator().manual_seed(0))
    mine = {p: tuple(x.shape) for p, x in _leaves(tp)}
    theirs = {p: tuple(x.shape) for p, x in _leaves(w["jp"])}
    assert mine == theirs
    assert {"/enc/pos_embed", "/segments/0/ln_x/scale",
            "/segments/0/xattn/wq", "/enc/layers/attn/wk"} <= set(mine)
    assert TT.count_params(tp) == JT.count_params(w["jp"])
    std = float(tp["enc"]["pos_embed"].std())
    assert 0.018 < std < 0.022


def test_forward_logits_match_jax(whisper):
    w = whisper
    toks = w["toks"][:, :T]
    jl, jaux = JT.forward(w["jp"], w["jc"], jnp.asarray(toks),
                          {"audio": jnp.asarray(w["audio"])})
    FA.reset_launches()
    tl, taux = build(w["tc"]).forward(w["tp"], _t(toks).long(),
                                      {"audio": _t(w["audio"])})
    assert not any(FA.launches.values())
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.detach().numpy(), _np(jl), **LOGIT_TOL)
    assert float(taux) == float(jaux) == 0.0
    with pytest.raises(ValueError, match="audio"):
        TT.forward(w["tp"], w["tc"], _t(toks).long())


def test_prefill_caches_and_decode_match_jax(whisper, jax_prefill):
    """float32 caches: the self caches at T + 8 slots, the cross caches at
    enc_seq (filled once, left as they are by decode)."""
    w = whisper
    tl, tcache = TT.prefill(w["tp"], w["tc"], _t(w["toks"][:, :T]).long(),
                            {"audio": _t(w["audio"])},
                            cache_dtype=torch.float32, max_seq=T + 8)
    jl, jcache = jax_prefill[0]
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    seg, jseg = tcache["segments"][0], jcache["segments"][0]
    assert sorted(seg) == sorted(jseg) == ["cross", "self"]
    assert tuple(seg["cross"]["k"].shape) == jseg["cross"]["k"].shape \
        == (4, B, w["jc"].enc_seq, w["jc"].n_kv, w["jc"].head_dim)
    assert seg["cross"]["ring"] is False
    for part in ("self", "cross"):
        np.testing.assert_array_equal(seg[part]["pos"].numpy(),
                                      np.asarray(jseg[part]["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(seg[part][key].numpy(),
                                       _np(jseg[part][key]), **ACT_TOL)
    cross = {k: seg["cross"][k].clone() for k in ("k", "v", "pos")}
    for j in range(3):
        tl, tcache = TT.decode_step(w["tp"], w["tc"], tcache,
                                    _t(w["toks"][:, T + j]).long())
        jl, jcache = jax_prefill[j + 1]
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    assert tcache["index"] == int(jcache["index"]) == T + 3
    seg, jseg = tcache["segments"][0], jcache["segments"][0]
    for key in ("k", "v"):
        np.testing.assert_allclose(seg["self"][key].numpy(),
                                   _np(jseg["self"][key]), **ACT_TOL)
    assert all(torch.equal(seg["cross"][k], cross[k]) for k in cross)


def test_teacher_forced_decode_matches_forward(whisper):
    """The port's own cache correctness, as JAX's
    ``test_decode_matches_forward`` holds its package."""
    w = whisper
    tp, tc, extra = w["tp"], w["tc"], {"audio": _t(w["audio"])}
    toks = _t(w["toks"]).long()
    full, _ = TT.forward(tp, tc, toks[:, :T + 2], extra)
    lg, caches = TT.prefill(tp, tc, toks[:, :T], extra,
                            cache_dtype=torch.float32, max_seq=T + 8)
    l1, caches = TT.decode_step(tp, tc, caches, toks[:, T])
    l2, caches = TT.decode_step(tp, tc, caches, toks[:, T + 1])
    v = tc.vocab
    full = full.detach()
    np.testing.assert_allclose(lg[:, :v].numpy(), full[:, T - 1, :v].numpy(),
                               rtol=2e-4, atol=2e-4)
    for got, pos in ((l1, T), (l2, T + 1)):
        np.testing.assert_allclose(got[:, :v].numpy(),
                                   full[:, pos, :v].numpy(), rtol=2e-3,
                                   atol=2e-3)


def _grads(tc, tp, batch):
    paths, leaves = zip(*_leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = TT.loss_fn(tp, tc, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), dict(zip(paths, grads))


def test_loss_and_every_gradient_match_jax(whisper):
    w = whisper
    jc, tc = w["jc"], w["tc"]
    toks, audio = w["toks"], w["audio"]
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {"tokens": jnp.asarray(toks),
                                     "audio": jnp.asarray(audio)}),
        has_aux=True)(w["jp"])
    tp = jax.tree.map(lambda a: a.clone(), w["tp"])
    FA.reset_launches()
    tl, tg = _grads(tc, tp, {"tokens": _t(toks).long(), "audio": _t(audio)})
    assert not any(FA.launches.values())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = dict(_leaves(jgrads))
    assert sorted(jleaves) == sorted(tg)
    for path, g in tg.items():
        a = np.asarray(jleaves[path])
        assert g.shape == a.shape, path
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=2e-5 * np.abs(a).max(), err_msg=path)
    # the encoder and the cross-attention learn
    for path in ("/enc/pos_embed", "/enc/layers/attn/wq",
                 "/segments/0/xattn/wk", "/segments/0/xattn/wq"):
        assert tg[path].abs().sum() > 0, path

    # remat recomputes each decoder and encoder layer: the same gradients
    tl2, tg2 = _grads(dataclasses.replace(tc, remat=True), tp,
                      {"tokens": _t(toks).long(), "audio": _t(audio)})
    assert torch.equal(tl, tl2)
    assert all(torch.equal(tg[p], tg2[p]) for p in tg)
