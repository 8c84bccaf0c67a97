"""repro_torch's LM serving path against the JAX package's, on the CPU at
the reduced sizes, with the JAX weights carried over
(``repro_torch.convert.load_lm_params``): the dense family, the MoE
(granite-moe, mixtral; reduced() makes them dropless, capacity 8.0), the
SSM (mamba2: conv and SSD caches) and the hybrid (zamba2: its shared
block's ``[R, ...]`` caches).  The JAX package runs its default (plain
jnp) attention and ``ssd_chunked``; the port its plain versions.

Tolerances, and why:
- layers, attention and logits with float32 caches: rtol=atol=1e-4 on
  logits, 1e-5 on activations and cached keys/values (float32 rounding:
  XLA's and torch's CPU rsqrt, sin and cos differ in the last bit);
- bfloat16 caches (the serving default): those last-bit differences move a
  few float32 keys across a bfloat16 rounding boundary, so the caches agree
  bit for bit on >= 99.5% of entries and elsewhere within one bfloat16
  step (2^-7 relative) plus the float32 tolerance,
  and each package's bf16 cache is its float32 cache rounded to nearest
  even; decode logits then drift by up to ~1e-3, which is why the served
  tokens are compared where JAX's top-2 margin exceeds 1e-3.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ACT_TOL = dict(rtol=1e-5, atol=1e-5)
# arch -> reduced() overrides; gemma3 at 7 layers runs 2 local:global
# groups (repeats > 1) and a local tail, as zamba2's 7 run 2 groups of (2
# mamba + the shared block) and a mamba tail
ARCHS = {"qwen2-0.5b": {}, "qwen3-8b": {}, "starcoder2-15b": {},
         "gemma3-12b": {"n_layers": 7}, "granite-moe-1b-a400m": {},
         "mixtral-8x22b": {}, "mamba2-2.7b": {}, "zamba2-7b": {}}
# the state caches (mamba blocks), float32 in both packages
SSM_TOL = dict(rtol=1e-4, atol=1e-5)


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


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    g = (0.1 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm(_t(x), _t(g)).numpy(),
                               _np(JL.rmsnorm(jnp.asarray(x), g)), **ACT_TOL)
    np.testing.assert_allclose(TL.layernorm(_t(x), _t(g), _t(b)).numpy(),
                               _np(JL.layernorm(jnp.asarray(x), g, b)),
                               **ACT_TOL)
    for pos in (np.arange(9), rng.integers(0, 5000, (2, 9))):
        out = TL.apply_rope(_t(x), _t(pos), 1e6).numpy()
        np.testing.assert_allclose(
            out, _np(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
            **ACT_TOL)
    # half-split, not interleaved: position 0 is the identity, and dims i
    # and i + D/2 rotate together
    np.testing.assert_array_equal(
        TL.apply_rope(_t(x), torch.zeros(9, dtype=torch.long)).numpy(), x)


@pytest.mark.parametrize("activation", ["silu", "gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_activations_match_jax(activation, gated):
    """jax.nn.gelu is the tanh approximation, so is the port's "gelu"."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jp = JL.mlp_init(jax.random.PRNGKey(0), 16, 48, gated)
    tp = {k: _t(v) for k, v in jp.items()}
    np.testing.assert_allclose(
        TL.mlp_apply(tp, _t(x), activation).numpy(),
        _np(JL.mlp_apply(jp, jnp.asarray(x), activation)), **ACT_TOL)


# ---------------------------------------------------------------------------
# attention and caches
# ---------------------------------------------------------------------------

ATTN = [dict(), dict(qk_norm=True), dict(qkv_bias=True, window=8)]


@pytest.mark.parametrize("opts", ATTN, ids=["plain", "qk_norm",
                                            "bias_window"])
def test_attention_forward_and_decode_match_jax(opts):
    """Prefill 5 positions, then 10 decode steps: with a window of 8 the
    ring cache (8 slots) wraps."""
    jcfg = JA.AttnConfig(d_model=32, n_heads=4, n_kv=2, head_dim=16,
                         rope_theta=1e4, **opts)
    tcfg = TA.AttnConfig(**dataclasses.asdict(jcfg))
    jp = JA.attn_init(jax.random.PRNGKey(2), jcfg)
    if "bq" in jp:           # non-zero biases, so that they are exercised
        jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    tp = jax.tree.map(lambda a: _t(a), jp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jy, (jk, jv) = JA.attention_forward(jp, jcfg, jnp.asarray(x),
                                        return_kv=True)
    ty, (tk, tv) = TA.attention_forward(tp, tcfg, _t(x), return_kv=True)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **ACT_TOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), **ACT_TOL)

    jc = JA.fill_cache(JA.init_cache(jcfg, 2, 64, jnp.float32), jk, jv)
    tc = TA.fill_cache(TA.init_cache(tcfg, 2, 64, torch.float32), tk, tv)
    assert tc["ring"] == bool(jc["ring"]) == ("window" in opts)
    assert tc["k"].shape == jc["k"].shape
    for i in range(5, 15):
        x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jc = JA.attention_decode(jp, jcfg, jnp.asarray(x1), jc, i)
        ty, tc = TA.attention_decode(tp, tcfg, _t(x1), tc, i)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **ACT_TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(tc["k"].numpy(), _np(jc["k"]), **ACT_TOL)
        np.testing.assert_allclose(tc["v"].numpy(), _np(jc["v"]), **ACT_TOL)


@pytest.mark.parametrize("window,max_seq,ring", [(8, 64, True), (8, 8, False),
                                                 (None, 64, False)])
def test_ring_or_dense_by_the_memory_model(window, max_seq, ring):
    jcfg = JA.AttnConfig(d_model=32, n_heads=4, n_kv=2, head_dim=16,
                         window=window)
    tc = TA.init_cache(TA.AttnConfig(**dataclasses.asdict(jcfg)), 3, max_seq)
    jc = JA.init_cache(jcfg, 3, max_seq)
    assert tc["ring"] is ring and bool(jc["ring"]) is ring
    assert tuple(tc["k"].shape) == jc["k"].shape
    assert tc["k"].dtype == torch.bfloat16 and tc["pos"].tolist() == \
        np.asarray(jc["pos"]).tolist()


# ---------------------------------------------------------------------------
# the dense family: prefill + teacher-forced decode
# ---------------------------------------------------------------------------

def _models(arch):
    jc = jreduced(jget_config(arch), **ARCHS[arch])
    tc = reduced(get_config(arch), **ARCHS[arch])
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = load_lm_params(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def models():
    """``_models(arch)``, drawn once an arch for the module's tests (none
    of them writes into the weights)."""
    drawn = {}

    def get(arch):
        if arch not in drawn:
            drawn[arch] = _models(arch)
        return drawn[arch]
    return get


def _cache_pairs(jcache, tcache, keys=("k", "v")):
    """(JAX leaf, port leaf) of every attention cache (``keys``: ``k`` and
    ``v``) or, with ``keys=("conv", "ssd")``, every mamba cache."""
    for where in ("segments", "tail"):
        assert len(jcache[where]) == len(tcache[where])
        for a, b in zip(jcache[where], tcache[where]):
            assert sorted(a) == sorted(b)
            if "pos" in a and "k" in keys:
                np.testing.assert_array_equal(b["pos"].numpy(),
                                              np.asarray(a["pos"]))
                assert np.all(np.asarray(a["ring"]) == b["ring"])
            for key in keys:
                if key in a:
                    assert tuple(b[key].shape) == a[key].shape, key
                    yield _np(a[key]), b[key]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax(arch, models):
    """Prompts of 40 tokens into 64-slot caches (gemma3's local layers: a
    32-slot ring, which 6 decode steps wrap), float32 caches."""
    jc, tc, jp, tp = models(arch)
    assert TT.count_params(tp) == JT.count_params(jp)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (2, 40)).astype(np.int32)
    jl, jcache = JT.prefill(jp, jc, jnp.asarray(toks), max_seq=64,
                            cache_dtype=jnp.float32)
    FA.reset_launches()
    tl, tcache = TT.prefill(tp, tc, _t(toks).long(), max_seq=64,
                            cache_dtype=torch.float32)
    assert FA.launches == {"flash_attention": 0,
                           "flash_attention_bwd": 0}
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    assert tcache["index"] == int(jcache["index"]) == 40
    for step in range(6):
        tok = rng.integers(0, jc.vocab, (2,)).astype(np.int32)
        jl, jcache = JT.decode_step(jp, jc, jcache, jnp.asarray(tok))
        tl, tcache = TT.decode_step(tp, tc, tcache, _t(tok).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
        assert np.isneginf(tl[:, jc.vocab:].numpy()).all()
    assert tcache["index"] == int(jcache["index"]) == 46
    for a, b in _cache_pairs(jcache, tcache):
        np.testing.assert_allclose(b.numpy(), a, **ACT_TOL)
    for a, b in _cache_pairs(jcache, tcache, ("conv", "ssd")):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a, **SSM_TOL)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-12b"])
def test_bf16_caches_round_as_jax(arch, models):
    jc, tc, jp, tp = models(arch)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 40))
    jl, jcache = JT.prefill(jp, jc, jnp.asarray(toks, jnp.int32), max_seq=64)
    tl, tcache = TT.prefill(tp, tc, _t(toks).long(), max_seq=64)
    _, tcache32 = TT.prefill(tp, tc, _t(toks).long(), max_seq=64,
                             cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    same = total = 0
    for (a, b), (_, b32) in zip(_cache_pairs(jcache, tcache),
                                _cache_pairs(jcache, tcache32)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(b, b32.to(torch.bfloat16))
        # one bfloat16 step (2^-7 relative) on top of the float32 tolerance
        a = torch.tensor(a)
        torch.testing.assert_close(b.float(), a, rtol=2.0 ** -7, atol=1e-5)
        same += int((b.float() == a).sum())
        total += a.numel()
    assert same >= 0.995 * total


def test_other_families_name_their_roadmap_item():
    """Every family runs every entry point, and none names a ROADMAP item
    any more: moe, ssm, hybrid, encdec (over its audio frames) and vlm
    (after its image)."""
    toks = torch.zeros(1, 4, dtype=torch.long)
    for arch in ("granite-moe-1b-a400m", "mamba2-2.7b", "zamba2-7b",
                 "whisper-tiny", "paligemma-3b"):
        cfg = reduced(get_config(arch))
        extra = ({"audio": torch.zeros(1, cfg.enc_seq, cfg.d_model)}
                 if cfg.family == "encdec" else
                 {"img": torch.zeros(1, cfg.img_tokens, cfg.img_embed_dim)}
                 if cfg.family == "vlm" else {})
        params = TT.init_params(cfg, torch.Generator().manual_seed(0))
        TT.init_caches(cfg, 1, 8)
        logits, caches = TT.prefill(params, cfg, toks, extra, max_seq=16)
        assert logits.shape == (1, TT.padded_vocab(cfg.vocab))
        assert caches["index"] == 4 + cfg.img_tokens
        logits, caches = TT.decode_step(params, cfg, caches, toks[:, 0])
        assert logits.shape == (1, TT.padded_vocab(cfg.vocab))
        loss, metrics = TT.loss_fn(params, cfg, {"tokens": toks, **extra})
        assert torch.isfinite(loss) and set(metrics) == {"ce", "aux"}
        assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")


# ---------------------------------------------------------------------------
# the token server
# ---------------------------------------------------------------------------

def test_server_matches_jax_server():
    """Reduced qwen2, 3 requests, max_batch 2: two admission waves; the
    port serves the JAX server's weights and gives its greedy tokens
    wherever JAX's top-2 margin exceeds 1e-3."""
    jsrv = JS.Server("qwen2-0.5b", use_reduced=True, max_batch=2, max_seq=64)
    tsrv = TS.Server("qwen2-0.5b", use_reduced=True, max_batch=2, max_seq=64,
                     device="cpu")
    tsrv.params = load_lm_params(tsrv.cfg,
                                 jax.tree.map(np.asarray, jsrv.params), "cpu")
    margins = {}

    def recording(logits, req, _sample=jsrv._sample):
        top2 = np.sort(np.asarray(logits, np.float32))[-2:]
        margins.setdefault(req.rid, []).append(float(top2[1] - top2[0]))
        return _sample(logits, req)

    jsrv._sample = recording
    rng = np.random.default_rng(0)
    pairs = []
    for i, n in enumerate((5, 7, 6)):
        prompt = rng.integers(3, tsrv.cfg.vocab, size=n).tolist()
        pairs.append((JS.Request(rid=i, prompt=prompt, max_new=6),
                      TS.Request(rid=i, prompt=prompt, max_new=6)))
        jsrv.submit(pairs[-1][0])
        tsrv.submit(pairs[-1][1])
    jsrv.run()
    FA.reset_launches()
    finished = tsrv.run()
    assert FA.launches == {"flash_attention": 0,
                           "flash_attention_bwd": 0}
    for jr, tr in pairs:
        assert tr.done and len(tr.out) == 6
        for j, (a, b) in enumerate(zip(jr.out, tr.out)):
            if a != b:        # a near tie in JAX: later tokens diverge
                assert margins[jr.rid][j] <= 1e-3, (jr.rid, j, jr.out,
                                                    tr.out)
                break
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert [w["size"] for w in tsrv.waves] == [2, 1]
    assert [w["prompt_len"] for w in tsrv.waves] == [7, 6]
    assert [w["decode_steps"] for w in tsrv.waves] == [5, 5]
    # the scheduler behaviour tests/test_serving.py pins for the JAX server
    assert tsrv.sched.latency_summary()["finished"] == 3
    t0, t2 = tsrv.sched.timings[0], tsrv.sched.timings[2]
    assert t2.admitted_at >= t0.admitted_at
    assert not tsrv.sched.has_work()
    assert len(tsrv.pop_finished()) == 3
    assert not tsrv.finished and not tsrv.sched.timings
