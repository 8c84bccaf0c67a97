"""The vlm family (paligemma-3b) on the port against the JAX package, on
the CPU at ``reduced()`` size (4 layers, d 128, 4 query heads over 1 kv
head of 32, an image of 8 positions of 64, float32), the JAX weights
carried over by ``convert.load_lm_params``: the image prefix (its
projection, unscaled, before the sqrt(d)-scaled token embeddings), the
prefix-LM mask in every attention layer, the loss over the text positions
alone and every gradient, prefill's caches over image and text, decode,
the server's zero image and the trainer's image draw.  The JAX package
runs its plain jnp attention (as ``tests/test_models_smoke.py`` runs it
on the CPU); the port its plain versions.

Tolerances (ROADMAP's parity contract), and why:
- logits (forward, prefill, decode with float32 caches): rtol=atol=1e-4;
  float32 caches 1e-5 (XLA's and torch's CPU rsqrt, sin and cos differ in
  the last bit);
- the loss within rtol=1e-5; every gradient within rtol=1e-4 plus 2e-5 of
  the leaf's largest entry (``tests/test_torch_train.py``'s);
- the server's greedy tokens equal until JAX's top-2 margin falls to 1e-3
  (bf16 caches carry the last-bit differences into the decode's logits);
- the trainer's image within 4 float32 ulp (threefry's normal), its
  losses over 3 steps within rtol=1e-5.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "paligemma-3b"
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
def pali():
    """The reduced configs, the JAX weights that ``JS.Server(seed=0)`` and
    ``JTR.run(seed=0)`` draw (``init_params(cfg, PRNGKey(0))``) as numpy
    leaves and in both packages, a token batch [B, T + 3] and an image
    [B, img_tokens, img_embed_dim]."""
    jc, tc = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    arrays = jax.tree.map(np.asarray, JT.init_params(
        jc, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, arrays)
    tp = load_lm_params(tc, arrays, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab, (B, T + 3)).astype(np.int32)
    img = rng.standard_normal((B, jc.img_tokens, jc.img_embed_dim)) \
        .astype(np.float32)
    return dict(jc=jc, tc=tc, arrays=arrays, jp=jp, tp=tp, toks=toks,
                img=img)


@pytest.fixture(scope="module")
def jax_prefill(pali):
    """The JAX package's prefill of the first T tokens after the image
    (float32 caches) and 3 decode steps: (logits, caches) after each."""
    w = pali
    lg, caches = JT.prefill(w["jp"], w["jc"], jnp.asarray(w["toks"][:, :T]),
                            {"img": jnp.asarray(w["img"])},
                            cache_dtype=jnp.float32, max_seq=40)
    out = [(lg, caches)]
    for j in range(3):
        lg, caches = JT.decode_step(w["jp"], w["jc"], caches,
                                    jnp.asarray(w["toks"][:, T + j]))
        out.append((lg, caches))
    return out


def test_init_params_and_load_carry_img_proj(pali):
    """The port's own draw has the JAX tree (``img_proj`` [img_embed_dim,
    d] N(0, 1/img_embed_dim) among it); ``load_lm_params`` carries the JAX
    ``img_proj`` across bit for bit."""
    w = pali
    tp = TT.init_params(w["tc"], torch.Generator().manual_seed(0))
    mine = {p: tuple(x.shape) for p, x in _leaves(tp)}
    theirs = {p: tuple(x.shape) for p, x in _leaves(w["arrays"])}
    assert mine == theirs
    assert mine["/img_proj"] == (w["jc"].img_embed_dim, w["jc"].d_model)
    assert TT.count_params(tp) == JT.count_params(w["jp"])
    std = float(tp["img_proj"].std()) * np.sqrt(w["jc"].img_embed_dim)
    assert 0.9 < std < 1.1
    np.testing.assert_array_equal(w["tp"]["img_proj"].numpy(),
                                  w["arrays"]["img_proj"])


def test_forward_logits_match_jax(pali):
    w = pali
    toks = w["toks"][:, :T]
    jl, _ = JT.forward(w["jp"], w["jc"], jnp.asarray(toks),
                       {"img": jnp.asarray(w["img"])})
    FA.reset_launches()
    tl, taux = build(w["tc"]).forward(w["tp"], _t(toks).long(),
                                      {"img": _t(w["img"])})
    assert not any(FA.launches.values())
    assert tuple(tl.shape) == jl.shape == (B, w["jc"].img_tokens + T, 512)
    np.testing.assert_allclose(tl.detach().numpy(), _np(jl), **LOGIT_TOL)
    assert float(taux) == 0.0
    with pytest.raises(ValueError, match="img"):
        TT.forward(w["tp"], w["tc"], _t(toks).long())


def test_prefix_mask_in_the_model(pali):
    """Through the model's layers: an image position sees a later image
    position (a change to the last image patch moves the first position's
    logits), no image position sees a text token (a change to every token
    leaves the image positions' logits bit for bit), and text stays
    causal."""
    w = pali
    n = w["jc"].img_tokens
    toks = _t(w["toks"][:, :T]).long()
    img = _t(w["img"])
    base, _ = TT.forward(w["tp"], w["tc"], toks, {"img": img})
    img2 = img.clone()
    img2[:, -1] += 1.0
    moved, _ = TT.forward(w["tp"], w["tc"], toks, {"img": img2})
    assert (moved[:, 0] - base[:, 0]).abs().max() > 1e-3
    toks2 = (toks + 1) % w["jc"].vocab
    other, _ = TT.forward(w["tp"], w["tc"], toks2, {"img": img})
    assert torch.equal(other[:, :n], base[:, :n])
    toks3 = toks.clone()
    toks3[:, -1] = (toks3[:, -1] + 1) % w["jc"].vocab
    last, _ = TT.forward(w["tp"], w["tc"], toks3, {"img": img})
    assert torch.equal(last[:, :-1], base[:, :-1])


def test_prefill_caches_and_decode_match_jax(pali, jax_prefill):
    """float32 caches over image and text (``index`` = img_tokens + T),
    then 3 decode steps."""
    w = pali
    tl, tcache = TT.prefill(w["tp"], w["tc"], _t(w["toks"][:, :T]).long(),
                            {"img": _t(w["img"])},
                            cache_dtype=torch.float32, max_seq=40)
    jl, jcache = jax_prefill[0]
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    n = w["jc"].img_tokens + T
    assert tcache["index"] == int(jcache["index"]) == n
    seg, jseg = tcache["segments"][0], jcache["segments"][0]
    np.testing.assert_array_equal(seg["pos"].numpy(),
                                  np.asarray(jseg["pos"]))
    assert int(seg["pos"][0, n - 1]) == n - 1 and int(seg["pos"][0, n]) == -1
    for key in ("k", "v"):
        np.testing.assert_allclose(seg[key].numpy(), _np(jseg[key]),
                                   **ACT_TOL)
    for j in range(3):
        tl, tcache = TT.decode_step(w["tp"], w["tc"], tcache,
                                    _t(w["toks"][:, T + j]).long())
        jl, jcache = jax_prefill[j + 1]
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    assert tcache["index"] == int(jcache["index"]) == n + 3
    seg, jseg = tcache["segments"][0], jcache["segments"][0]
    for key in ("k", "v"):
        np.testing.assert_allclose(seg[key].numpy(), _np(jseg[key]),
                                   **ACT_TOL)


def _grads(tc, tp, batch):
    paths, leaves = zip(*_leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TT.loss_fn(tp, tc, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), dict(zip(paths, grads))


def test_loss_and_every_gradient_match_jax(pali):
    """The loss over the text positions alone and every gradient, the
    image projection's and the attention's among them; remat gives the
    same bits."""
    w = pali
    jc, tc = w["jc"], w["tc"]
    toks, img = w["toks"], w["img"]
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {"tokens": jnp.asarray(toks),
                                     "img": jnp.asarray(img)}),
        has_aux=True)(w["jp"])
    tp = jax.tree.map(lambda a: a.clone(), w["tp"])
    batch = {"tokens": _t(toks).long(), "img": _t(img)}
    tl, tg = _grads(tc, tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = dict(_leaves(jgrads))
    assert sorted(jleaves) == sorted(tg)
    for path, g in tg.items():
        a = np.asarray(jleaves[path])
        assert g.shape == a.shape, path
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=2e-5 * np.abs(a).max(), err_msg=path)
    for path in ("/img_proj", "/segments/0/attn/wq", "/segments/0/attn/wk",
                 "/segments/0/attn/wv"):
        assert tg[path].abs().sum() > 0, path
    tl2, tg2 = _grads(dataclasses.replace(tc, remat=True), tp, batch)
    assert torch.equal(tl, tl2)
    assert all(torch.equal(tg[p], tg2[p]) for p in tg)


def test_server_matches_jax_server(pali):
    """2 requests in one wave after the server's zero image, bf16 caches."""
    w = pali
    arrays, key0 = w["arrays"], np.asarray(jax.random.PRNGKey(0))

    def jinit(cfg, key):
        assert cfg == w["jc"] and np.array_equal(np.asarray(key), key0)
        return jax.tree.map(jnp.asarray, arrays)

    with mock.patch.object(JT, "init_params", jinit):
        jsrv = JS.Server(ARCH, use_reduced=True, max_batch=2, max_seq=64)
    with mock.patch.object(TT, "init_params", lambda cfg, gen:
                           load_lm_params(cfg, arrays, "cpu")):
        tsrv = TS.Server(ARCH, use_reduced=True, max_batch=2, max_seq=64,
                         device="cpu")
    extra = tsrv._extra(2)["img"]
    assert extra.dtype == torch.float32 and not extra.any() and tuple(
        extra.shape) == (2, tsrv.cfg.img_tokens, tsrv.cfg.img_embed_dim)
    margins = {}

    def recording(logits, req, _sample=jsrv._sample):
        top2 = np.sort(np.asarray(logits, np.float32))[-2:]
        margins.setdefault(req.rid, []).append(float(top2[1] - top2[0]))
        return _sample(logits, req)

    jsrv._sample = recording
    rng = np.random.default_rng(1)
    pairs = []
    for i, n in enumerate((5, 7)):
        prompt = rng.integers(3, tsrv.cfg.vocab, size=n).tolist()
        pairs.append((JS.Request(rid=i, prompt=prompt, max_new=6),
                      TS.Request(rid=i, prompt=prompt, max_new=6)))
        jsrv.submit(pairs[-1][0])
        tsrv.submit(pairs[-1][1])
    jsrv.run()
    finished = tsrv.run()
    compared = 0
    for jr, tr in pairs:
        assert tr.done and len(tr.out) == 6
        for j, (a, b) in enumerate(zip(jr.out, tr.out)):
            if a != b:        # a near tie in JAX: later tokens diverge
                assert margins[jr.rid][j] <= 1e-3, (jr.rid, j, jr.out,
                                                    tr.out)
                break
            compared += 1
    assert compared >= 8, f"only {compared} of 12 tokens compared"
    assert sorted(r.rid for r in finished) == [0, 1]


def test_trainer_image_and_losses_match_jax(pali, capsys):
    """Each step's image is the JAX trainer's draw within 4 ulp; 3 steps
    from the JAX run's own weights give its losses."""
    w = pali
    jc, tc = w["jc"], w["tc"]
    for i in range(3):
        want = np.asarray(0.1 * jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(0), i),
            (2, jc.img_tokens, jc.img_embed_dim)))
        got = TTR.extra_inputs(tc, 2, i, 0, "cpu")["img"].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        assert int(ulp.max()) <= 4, i
    # fresh arrays: the JAX train step donates its params
    with mock.patch.object(JT, "init_params", lambda cfg, key: jax.tree.map(
            jnp.asarray, w["arrays"])):
        jlosses = JTR.run(ARCH, steps=3, batch=2, seq=32, log_every=1)
    with mock.patch.object(TT, "init_params", lambda cfg, gen:
                           load_lm_params(cfg, w["arrays"], "cpu")):
        tlosses = TTR.run(ARCH, steps=3, batch=2, seq=32, log_every=1,
                          device="cpu")
    assert len(tlosses) == 3 and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert "[train] step     3" in capsys.readouterr().out
