"""repro_torch's training path on the CPU against the JAX package's: the
token pipeline, the LR schedules, AdamW, cross entropy, ``loss_fn`` with
every parameter's gradient (reduced mamba2-2.7b, qwen2-0.5b,
granite-moe-1b-a400m and mixtral-8x22b (ce plus the MoE aux) and
zamba2-7b (the shared block's gradient summed over its two
applications), the JAX weights carried over by
``convert.load_lm_params``), remat (the ``"dots"`` policy against the
JAX package's too), and the ``launch.train.run`` loop.  On the CPU the
port takes the kernels' plain versions: attention's forward and backward
(``flash_attention_fwd_ref`` / ``_bwd_ref``) and the SSD's
``ssd_chunked``.

Tolerances, and why:
- pipeline batches: bit for bit (both draw from the same numpy
  SeedSequence);
- schedules: within two float32 ulps, rtol=2.5e-7 (both compute in
  float32; XLA's and torch's cos, sqrt and division may differ in the
  last bit);
- AdamW params, mu, nu: within 1e-6 (float32, the same statements);
- cross entropy, loss_fn and its aux: within rtol=1e-5; gradients within rtol=1e-4
  plus an absolute 2e-5 of each leaf's largest entry (float32 sums in
  another order through 4 layers; the largest differences seen are ~3e-6
  of the leaf's scale);
- the run's losses over 3 AdamW steps: within rtol=1e-5.
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
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JAW  # noqa: E402
from repro.optim import schedule as JSC  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.optim import adamw as TAW  # noqa: E402
from repro_torch.optim import schedule as TSC  # noqa: E402

ARCHS = ("mamba2-2.7b", "qwen2-0.5b", "granite-moe-1b-a400m",
         "mixtral-8x22b", "zamba2-7b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict/list tree, dict keys sorted (the
    JAX package's leaf order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _models(arch, **overrides):
    jc = jreduced(jget_config(arch), **overrides)
    tc = reduced(get_config(arch), **overrides)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = load_lm_params(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


# ---------------------------------------------------------------------------
# data, schedules, optimizer, loss
# ---------------------------------------------------------------------------

def test_pipeline_batches_equal_jax_and_resume():
    jcfg = JDataConfig(vocab=1000, seq_len=64, global_batch=4, seed=3)
    tcfg = DataConfig(vocab=1000, seq_len=64, global_batch=4, seed=3)
    jp, tp = JTokenPipeline(jcfg), TokenPipeline(tcfg, device="cpu")
    for _ in range(3):
        t = tp.next_batch()["tokens"]
        assert t.dtype == torch.int32 and t.shape == (4, 65)
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(jp.next_batch()["tokens"]))
    state = tp.state()
    assert state == jp.state()
    jr = JTokenPipeline.restore(jcfg, state, shard_index=1, num_shards=2)
    tr = TokenPipeline.restore(tcfg, state, shard_index=1, num_shards=2,
                               device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(tr.next_batch()["tokens"].numpy(),
                                      np.asarray(jr.next_batch()["tokens"]))


def test_pipeline_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPipeline(cfg)


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-3, 5, 40, 1e-4)), ("warmup_cosine", (1.0, 1, 3)),
    ("warmup_rsqrt", (3e-3, 7)), ("constant", (2e-4,))])
def test_schedules_equal_jax(name, args):
    jf, tf = getattr(JSC, name)(*args), getattr(TSC, name)(*args)
    for step in range(0, 50):
        t = tf(step)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), float(jf(step)), rtol=2.5e-7,
                                   atol=0)


@pytest.mark.parametrize("dtype,master", [("float32", True),
                                          ("bfloat16", True),
                                          ("float32", False)])
def test_adamw_updates_equal_jax(dtype, master):
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 40), "b": [(7,), (2, 5, 6)]}
    params_np = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
                 "b": [rng.standard_normal(s).astype(np.float32)
                       for s in shapes["b"]]}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
    tparams = {"a": torch.tensor(params_np["a"]).to(tdt),
               "b": [torch.tensor(a).to(tdt) for a in params_np["b"]]}
    sched_args = (1e-2, 2, 10)
    jcfg = JAW.AdamWConfig(lr=JSC.warmup_cosine(*sched_args), grad_clip=0.5,
                           master_fp32=master)
    tcfg = TAW.AdamWConfig(lr=TSC.warmup_cosine(*sched_args), grad_clip=0.5,
                           master_fp32=master)
    jst, tst = JAW.init(jcfg, jparams), TAW.init(tcfg, tparams)
    for _ in range(3):
        grads_np = jax.tree.map(
            lambda a: (3.0 * rng.standard_normal(a.shape)).astype(np.float32),
            params_np)
        jparams, jst, jm = JAW.update(
            jcfg, jax.tree.map(jnp.asarray, grads_np), jst, jparams)
        tgrads = {"a": torch.tensor(grads_np["a"]),
                  "b": [torch.tensor(a) for a in grads_np["b"]]}
        tparams, tst, tm = TAW.update(tcfg, tgrads, tst, tparams)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=2.5e-7)
        for jt, tt in ((jparams, tparams), (jst.mu, tst.mu),
                       (jst.nu, tst.nu)):
            for (pj, a), (pt, b) in zip(_leaves(jt), _leaves(tt)):
                assert pj == pt and b.dtype == (tdt if jt is jparams
                                                else torch.float32)
                np.testing.assert_allclose(
                    b.float().numpy(), np.asarray(a).astype(np.float32),
                    rtol=1e-6, atol=1e-6, err_msg=pj)
    assert tst.step == int(jst.step) == 3


def test_adamw_slices_large_leaves_as_a_whole_update():
    """A leaf above the slicing threshold updates as it would whole."""
    rng = np.random.default_rng(6)
    p = torch.tensor(rng.standard_normal((4, 8, 8)).astype(np.float32))
    g = torch.tensor(rng.standard_normal((4, 8, 8)).astype(np.float32))
    cfg = TAW.AdamWConfig(lr=1e-2)
    whole, sliced = {"w": p.clone()}, {"w": p.clone()}
    sw, ss = TAW.init(cfg, whole), TAW.init(cfg, sliced)
    TAW.update(cfg, {"w": g}, sw, whole)
    with mock.patch.object(TAW, "_SLICE_ELEMENTS", 10):
        assert len(TAW._slices(p)) == 4
        TAW.update(cfg, {"w": g}, ss, sliced)
    with mock.patch.object(TAW, "_SLICE_ELEMENTS", 100):
        # a tall leaf (an embedding) is cut into row blocks, not rows
        assert [x.shape[0] for x in TAW._slices(torch.zeros(100, 8))] \
            == [12] * 8 + [4]
    assert torch.equal(whole["w"], sliced["w"])
    assert torch.equal(sw.nu["w"], ss.nu["w"])


def test_cross_entropy_with_padded_vocab_equals_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 9, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, :3] = -1                                    # ignored
    jl, jg = jax.value_and_grad(
        lambda x: JL.cross_entropy(x, jnp.asarray(labels), true_vocab=50))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tl = TL.cross_entropy(x, torch.tensor(labels), true_vocab=50)
    (tg,) = torch.autograd.grad(tl, [x])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    assert torch.equal(tg[..., 50:], torch.zeros_like(tg[..., 50:]))


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------

def _grads(tc, tp, toks):
    paths, leaves = zip(*_leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = TT.loss_fn(tp, tc, {"tokens": torch.tensor(toks)})
    return loss, metrics, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jc, tc, jp, tp = _models(arch)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 33)) \
        .astype(np.int32)
    (jl, jm), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    FA.reset_launches()
    SSD.reset_launches()
    tl, tm, tg = _grads(tc, tp, toks)
    assert not any({**FA.launches, **SSD.launches}.values())
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]),
                               rtol=1e-5)
    assert (float(jm["aux"]) > 0) == (jc.family == "moe")
    jleaves = dict(_leaves(jgrads))
    assert sorted(jleaves) == sorted(tg)
    for path, g in tg.items():
        a = np.asarray(jleaves[path])
        assert g.shape == a.shape, path
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=2e-5 * np.abs(a).max(), err_msg=path)
    if arch == "qwen2-0.5b":         # the repaired fault: attention learns
        for k in ("wq", "wk", "wv", "bq", "bk", "bv"):
            assert tg[f"/segments/0/attn/{k}"].abs().sum() > 0, k
    if jc.family == "moe":           # the router learns through gates and aux
        assert tg["/segments/0/moe/router"].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    _, tc, _, tp = _models(arch)
    toks = np.random.default_rng(2).integers(0, tc.vocab, (2, 17)) \
        .astype(np.int32)
    l0, _, g0 = _grads(tc, tp, toks)
    for policy in ("full", "dots"):
        l1, _, g1 = _grads(dataclasses.replace(tc, remat=True,
                                               remat_policy=policy), tp, toks)
        assert torch.equal(l0, l1)
        for path in g0:
            assert torch.equal(g0[path], g1[path]), (policy, path)


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "granite-moe-1b-a400m"))
def test_dots_remat_step_matches_jax_dots(arch):
    """``remat_policy="dots"`` against the JAX package's (its
    ``dots_with_no_batch_dims_saveable``): the loss and every gradient."""
    jc, tc, jp, tp = _models(arch, remat=True, remat_policy="dots")
    toks = np.random.default_rng(5).integers(0, jc.vocab, (2, 17)) \
        .astype(np.int32)
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    tl, _, tg = _grads(tc, tp, toks)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jleaves = dict(_leaves(jgrads))
    assert sorted(jleaves) == sorted(tg)
    for path, g in tg.items():
        a = np.asarray(jleaves[path])
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=2e-5 * np.abs(a).max(), err_msg=path)


def test_model_loss_is_loss_fn():
    _, tc, _, tp = _models("mamba2-2.7b")
    toks = torch.tensor(np.random.default_rng(3).integers(0, tc.vocab,
                                                          (1, 9)))
    a, _ = build(tc).loss(tp, {"tokens": toks})
    b, _ = TT.loss_fn(tp, tc, {"tokens": toks})
    assert torch.equal(a, b)
    assert TT.model_flops_per_token(tc, 1000) == 6000.0
    assert TT.model_flops_per_token(tc, 1000, n_active=10) == 60.0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_run_losses_equal_jax(arch, capsys):
    """3 steps from the JAX run's own weights (its PRNGKey(seed) draw,
    carried over): the same batches, loss, gradients and AdamW."""
    jc = jreduced(jget_config(arch))
    tc = reduced(get_config(arch))
    jlosses = JTR.run(arch, steps=3, batch=2, seq=32, log_every=1)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = load_lm_params(tc, jax.tree.map(np.asarray, jp), "cpu")
    with mock.patch.object(TT, "init_params", lambda cfg, gen: tp):
        tlosses = TTR.run(arch, steps=3, batch=2, seq=32, log_every=1,
                          device="cpu")
    assert len(tlosses) == 3 and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert "[train] step     3" in capsys.readouterr().out


def test_non_finite_loss_raises_without_a_checkpoint():
    def nan_loss(params, cfg, batch):
        return torch.tensor(float("nan"), requires_grad=True) * sum(
            p.sum() for _, p in _leaves(params)), {}
    with mock.patch.object(TT, "loss_fn", nan_loss):
        with pytest.raises(FloatingPointError, match="step 0"):
            TTR.run("qwen2-0.5b", steps=2, batch=1, seq=8, device="cpu")


def test_trainer_defaults_to_cuda_and_names_what_waits(monkeypatch,
                                                       tmp_path, capsys):
    """Checkpoints no longer wait (``ckpt_dir`` saves the last step, and a
    second call on that directory says so and trains nothing); model
    parallelism without a process group runs on the one device, as the
    JAX package's ``make_local_mesh`` clamps it to the devices there
    are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTR.main(["--arch", "qwen2-0.5b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TTR.run("qwen2-0.5b", steps=1)
    TTR.main(["--arch", "qwen2-0.5b", "--steps", "1", "--batch", "1",
              "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert (tmp_path / "step_000000001" / "manifest.json").exists()
    capsys.readouterr()
    TTR.main(["--arch", "qwen2-0.5b", "--steps", "1", "--batch", "1",
              "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored step 1" in out and "already holds step 1" in out
    assert not torch.distributed.is_initialized()
    assert TTR.run("qwen2-0.5b", steps=1, batch=1, seq=8, device="cpu",
                   model_parallel=2) == \
        TTR.run("qwen2-0.5b", steps=1, batch=1, seq=8, device="cpu")


def test_trainer_cli_on_the_cpu(capsys):
    TTR.main(["--arch", "mamba2-2.7b", "--steps", "2", "--batch", "1",
              "--seq", "16", "--device", "cpu"])
    assert "first loss" in capsys.readouterr().out


def test_forward_and_grads_on_a_grouped_program_match_jax():
    """gemma3's local:global groups (params stacked [R, n, ...]): the
    per-layer split of the stacks gives JAX's loss and gradients."""
    jc, tc, jp, tp = _models("gemma3-12b", n_layers=7)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (1, 41)) \
        .astype(np.int32)
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    tl, _, tg = _grads(tc, tp, toks)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jleaves = dict(_leaves(jgrads))
    for path, g in tg.items():
        a = np.asarray(jleaves[path])
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=2e-5 * np.abs(a).max(), err_msg=path)
