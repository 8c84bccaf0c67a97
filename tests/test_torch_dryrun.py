"""The port's dry run (``repro_torch.launch.dryrun``), its specs
(``models/model.py``), its roofline (``launch/roofline.py``) and the LM
kernels' custom ops, against the JAX package on the CPU:

- ``input_specs``, ``cache_specs`` and ``param_specs`` equal to JAX's
  ``input_specs``, ``cache_specs`` and ``jax.eval_shape(init_params)``
  leaf for leaf (by the JAX tree's leaf paths), in shape and dtype, for
  every arch at full width and every shape its config applies to;
- ``analytic_param_bytes_per_device`` equal to JAX's for every arch on
  both production meshes (a mesh stub: both need only its sizes);
- the microbatched train step (1 and 4 microbatches, the reduced qwen2 of
  ``tests/test_grad_accum.py``) equal to JAX's ``make_train_step``;
- the kernels' fake ops: the real CPU route's output shapes and dtypes,
  a shape the launch plan refuses raising under ``FakeTensorMode``, the
  flash formula per product equal to JAX's ``attention_correction`` flash
  term per pass for every arch x shape, the SSD formula by hand;
  ``_param_counts`` and ``model_flops`` equal to JAX's;
- one reduced cell per family and step kind on a fake group of 4 (2 x 2),
  OK with FLOPs and collectives; at a fake group of 2 (meshes 2 x 1 and 1
  x 2), the collectives of the reduced qwen2 step equal to a real 2-rank
  gloo run's (the fake groups in one subprocess, ``_torch_dryrun_fake.
  py``; the gloo ranks through ``_torch_dist.py``; both started together);
- a real CPU step's counts equal to the dry run's of the same cell;
- on a fake group of 16 (4 x 4), the per-rank peak of a reduced MoE
  prefill and of a decode over a split cache against the joins the port
  made before (the MoE's input over the batch axes, a decode's k/v
  sequence): the MoE's tensors shrink by the 4 batch ranks and the caches
  by the 4 "model" ranks, the step's peak by more than 2.5x (its weights
  and residual stream do not shrink), the decode's by at least 3/4 of
  its layers' whole k/v;
- the ``"dots"`` remat policy's peak between ``"full"``'s and
  ``"none"``'s;
- with the weights placed whole (``serve_replicate_weights``) and heads
  that "model" divides, a reduced prefill and decode on a 2 x 8 mesh of
  the fake group of 16: no weight collective, attention's FLOPs a card
  those of the sharded weights; the decode at 2 gloo ranks equal to one
  device's (tokens equal, logits within 1e-4 in float32);
- ``benchmarks/hillclimb_torch.py``'s three cells at the reduced size on
  the fake group of 4: every variant of the JAX script, the file it
  writes, each baseline's counts equal to the dry run's record of the
  same cell, ``*no_core`` less by exactly the custom ops' terms, and
  ``"dots"`` changing the counts; ``benchmarks/report_torch.py`` rendered
  from a tree with records and from one without, with no TPU constant.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import roofline as JR  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_shape, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from _torch_dist import start_ranks  # noqa: E402
from _torch_dryrun_fake import CELLS, FAMILIES  # noqa: E402

ROOT = TESTS.parent
# the ten archs (other test modules of a worker may register more)
NAMES = list(ARCHS)
PRODUCTION = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model"))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dryrun():
    """The JAX dry-run module, imported with JAX's backend already up (its
    import sets XLA_FLAGS for 512 host devices; that must reach neither
    this process's JAX nor the subprocesses)."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return JD


# ---------------------------------------------------------------------------
# the fake groups and the gloo ranks, started once for the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory):
    """The fake-group subprocess and the 2 gloo ranks, started together
    with the module's first test (they run beside the tests before
    theirs); ``get()`` waits for both once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)] + ([os.environ["PYTHONPATH"]]
                                           if "PYTHONPATH" in os.environ
                                           else [])),
           "OMP_NUM_THREADS": "1"}
    out = tmp / "fake.json"
    fake = subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_dryrun_fake.py"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    (tmp / "gloo").mkdir()
    real = start_ranks(TESTS / "_torch_dryrun_cases.py", 2, tmp / "gloo",
                       timeout_s=240)
    box = {}

    def get():
        if not box:
            log = fake.communicate(timeout=240)[0]
            assert fake.returncode == 0, log[-4000:]
            box["fake"] = json.loads(out.read_text())
            box["real"] = real.wait()
        return box
    yield SimpleNamespace(get=get)
    if fake.poll() is None:
        fake.kill()


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _jax_leaves(tree) -> dict:
    return {JSH._leaf_path(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, path="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    elif isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), str(tree.dtype).split(".")[1])}
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{path}/{k}" if path else str(k)))
    return out


def _same_leaves(port, jx, what, python_leaves=()):
    """Leaf for leaf; the JAX leaves that the port keeps as Python values
    (a cache's ``ring`` flags and ``index``) named by ``python_leaves``."""
    p, j = _port_leaves(port), _jax_leaves(jx)
    extra = {k for k in set(j) - set(p)
             if k.rsplit("/", 1)[-1] in python_leaves}
    assert set(p) == set(j) - extra, (what, sorted(set(p) ^ (set(j) - extra)))
    for k in p:
        assert p[k] == j[k], (what, k, p[k], j[k])
    assert all(isinstance(v, torch._subclasses.fake_tensor.FakeTensor)
               for v in _tensor_leaves(port)), what


def _tensor_leaves(tree):
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch", NAMES)
def test_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), JARCHS[arch]
    _same_leaves(M.param_specs(cfg, "cpu"),
                 jax.eval_shape(lambda: JT.init_params(
                     jcfg, jax.random.PRNGKey(0))), f"{arch} params")
    for shape in JSHAPES:
        if not jcfg.applicable(shape)[0]:
            continue
        _same_leaves(M.input_specs(cfg, get_shape(shape.name), "cpu"),
                     JM.input_specs(jcfg, shape), f"{arch} {shape.name}",
                     python_leaves=("ring", "index"))
    _same_leaves(M.cache_specs(cfg, 2, 64, device="cpu"),
                 JM.cache_specs(jcfg, 2, 64), f"{arch} caches",
                 python_leaves=("ring", "index"))


def test_specs_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    cfg = get_config("qwen2-0.5b")
    for fn in (lambda: M.param_specs(cfg),
               lambda: M.input_specs(cfg, get_shape("train_4k")),
               lambda: M.cache_specs(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


@pytest.mark.parametrize("arch", NAMES)
def test_analytic_param_bytes_equal_jax(arch):
    from jax.sharding import AbstractMesh
    JD = _jax_dryrun()
    params = M.param_specs(get_config(arch), "cpu")
    jparams = jax.eval_shape(lambda: JT.init_params(JARCHS[arch],
                                                    jax.random.PRNGKey(0)))
    for shape, axes in PRODUCTION:
        stub = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
        jmesh = AbstractMesh(shape, axes)
        got = D.analytic_param_bytes_per_device(
            params, SH.param_specs(params, stub), stub)
        want = JD.analytic_param_bytes_per_device(
            jparams, JSH.param_specs(jparams, jmesh), jmesh)
        assert got == want, (arch, shape)


# ---------------------------------------------------------------------------
# the microbatched train step
# ---------------------------------------------------------------------------

def test_microbatched_train_step_equals_jax():
    JD = _jax_dryrun()
    jcfg1 = dataclasses.replace(jreduced(JARCHS["qwen2-0.5b"]),
                                microbatches=1)
    cfg1 = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                               microbatches=1)
    jparams = JT.init_params(jcfg1, jax.random.PRNGKey(0))
    jopt = JA.init(JA.AdamWConfig(lr=1e-3), jparams)
    tokens = np.random.default_rng(0).integers(0, jcfg1.vocab, (8, 33))
    arrays = jax.tree.map(np.asarray, jparams)
    for mb in (1, 4):
        jcfg = dataclasses.replace(jcfg1, microbatches=mb)
        p_j, _, m_j = jax.jit(JD.make_train_step(jcfg))(
            jparams, jopt, {"tokens": jnp.asarray(tokens, jnp.int32)})
        cfg = dataclasses.replace(cfg1, microbatches=mb)
        params = convert.load_lm_params(cfg, arrays, device="cpu")
        opt = D.adamw.init(D.OCFG, params)
        p_t, _, m_t = D.make_train_step(cfg)(
            params, opt, {"tokens": torch.tensor(tokens, dtype=torch.int32)})
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
        want = _jax_arrays(p_j)
        got = {k: v.detach().numpy() for k, v in _named(p_t).items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-4,
                                       atol=5e-5, err_msg=f"{mb}: {k}")


def _jax_arrays(tree) -> dict:
    return {JSH._leaf_path(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _named(tree, path="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{path}/{k}" if path else str(k)))
    return out


# ---------------------------------------------------------------------------
# the kernels' fake ops and FLOP formulas
# ---------------------------------------------------------------------------

def _flash_inputs(dtype=torch.float32, d=32, b=1, hq=4, hkv=2, t=48):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, hq, t, d, generator=g).to(dtype)
    k = torch.randn(b, hkv, t, d, generator=g).to(dtype)
    v = torch.randn(b, hkv, t, d, generator=g).to(dtype)
    return q, k, v


def _ssd_inputs(b=2, t=40, h=3, dh=8, ds=12, g=1):
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(b, t, h, dh, generator=gen),
            torch.rand(b, t, h, generator=gen),
            -torch.rand(h, generator=gen),
            torch.randn(b, t, g, ds, generator=gen),
            torch.randn(b, t, g, ds, generator=gen),
            torch.randn(h, generator=gen))


def _meta(outs):
    return [(tuple(o.shape), o.dtype) for o in outs]


def _faked(fn, *tensors, **kw):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = [None if t is None else mode.from_tensor(t) for t in tensors]
        kw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
        out = fn(*fake, **kw)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_ops_give_the_cpu_route_shapes(dtype):
    q, k, v = _flash_inputs(dtype)
    kw = dict(causal=True, window=16, prefix=8)
    out, lse = FA.flash_attention_fwd(q, k, v, **kw)
    assert _meta(_faked(FA.flash_attention_fwd, q, k, v, **kw)) == \
        _meta((out, lse))
    dout = torch.randn_like(out)
    grads = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert _meta(_faked(FA.flash_attention_bwd, q, k, v, out, lse, dout,
                        **kw)) == _meta(grads)
    ins = _ssd_inputs()
    assert _meta(_faked(SSD.ssd_scan, *ins)) == _meta((SSD.ssd_scan(*ins),))
    assert _meta(_faked(SSD.ssd_scan_state, *ins)) == \
        _meta(SSD.ssd_scan_state(*ins))


def test_fake_ops_refuse_what_the_kernels_refuse():
    # the plain versions take these; the kernels' plans do not
    q, k, v = _flash_inputs(d=12)
    FA.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        _faked(FA.flash_attention_fwd, q, k, v)
    q, k, v = _flash_inputs(b=16385, hq=4, hkv=4, t=1, d=8)
    with pytest.raises(ValueError, match="grid axis y"):
        _faked(FA.flash_attention_fwd, q, k, v)
    ins = _ssd_inputs(h=4, g=2)
    SSD.ssd_scan(*ins)
    with pytest.raises(NotImplementedError, match="n_groups"):
        _faked(SSD.ssd_scan, *ins)
    ins = _ssd_inputs()
    state = torch.zeros(2, 3, 12, 8)
    SSD.ssd_scan_state(*ins, initial_state=state)
    with pytest.raises(ValueError, match="initial_state"):
        _faked(SSD.ssd_scan_state, *ins, initial_state=state)


def _attn_shapes(cfg, shape):
    """(q shape, k shape, causal, window, layers) of every self-attention
    the JAX roofline's flash term counts: the layer classes of
    ``_attn_layers`` over the shape's sequence (a vlm model's image and
    text together), and an encdec model's encoder over its frames."""
    b, t = shape.global_batch, shape.seq_len
    hq, hkv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    out = [((b, hq, t, d), (b, hkv, t, d), True, g["window"], g["n"])
           for g in RL._attn_layers(cfg)]
    if cfg.n_enc_layers:
        ta = cfg.enc_seq
        out.append(((b, hq, ta, d), (b, hkv, ta, d), False, None,
                    cfg.n_enc_layers))
    return out


@pytest.mark.parametrize("arch", NAMES)
def test_flash_flops_per_product_equal_jax_flash_term(arch):
    cfg, jcfg = get_config(arch), JARCHS[arch]
    for shape in JSHAPES:
        if shape.kind not in ("train", "prefill") or not cfg.n_heads:
            continue
        passes = 2 if shape.kind == "prefill" else 8
        got = sum(FA.attention_flops(qs, ks, causal, window, 1) * n
                  for qs, ks, causal, window, n in
                  _attn_shapes(cfg, get_shape(shape.name)))
        naive = sum(2.0 * qs[0] * qs[1] * qs[2] * ks[2] * qs[3] * passes * n
                    for qs, ks, _, _, n in
                    _attn_shapes(cfg, get_shape(shape.name)))
        flash = naive - JR.attention_correction(jcfg, shape, 1)[
            "flops_delta"]
        np.testing.assert_allclose(got, flash / passes, rtol=1e-12,
                                   err_msg=f"{arch} {shape.name}")
        for qs, ks, causal, window, _ in _attn_shapes(
                cfg, get_shape(shape.name)):
            assert FA.visible_pairs(qs[2], ks[2], window, causal) / (
                qs[2] * ks[2]) == pytest.approx(
                JR._visibility(qs[2], ks[2], window, causal), rel=1e-12)


def test_flop_counter_counts_the_kernels_products():
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = [t.requires_grad_() for t in _flash_inputs()]
    with FlopCounterMode(display=False) as fc:
        out = FA.FlashAttention.apply(q, k, v, True, 16)
        out.sum().backward()
    pairs = FA.visible_pairs(48, 48, 16, True)
    assert fc.get_total_flops() == (FA.FWD_PRODUCTS + FA.BWD_PRODUCTS) * \
        2 * 1 * 4 * 32 * pairs
    # the SSD's four products by hand at t = 40: chunks of 32 and 8
    ins = _ssd_inputs()
    with FlopCounterMode(display=False) as fc:
        SSD.ssd_scan(*ins)
    b, h, dh, ds = 2, 3, 8, 12
    want = (2 * b * (32 * 32 + 8 * 8) * ds
            + b * h * ((32 * 33 + 8 * 9) * dh + 4 * 40 * ds * dh))
    assert fc.get_total_flops() == SSD.scan_flops((b, 40, h, dh),
                                                  (b, 40, 1, ds)) == want


def test_param_counts_and_model_flops_equal_jax():
    for arch in NAMES:
        assert RL._param_counts(get_config(arch)) == JR._param_counts(
            JARCHS[arch])
        assert RL._attn_layers(get_config(arch)) == JR._attn_layers(
            JARCHS[arch])
        for shape in JSHAPES:
            assert RL.model_flops(get_config(arch), get_shape(shape.name)) \
                == JR.model_flops(JARCHS[arch], shape)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", [f"{a}/{c.kind}" for a in FAMILIES
                                  for c in CELLS])
def test_reduced_cell_on_a_fake_group_of_4(groups, cell):
    rec = groups.get()["fake"]["families"][cell]
    assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["peak_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert sum(rec["collectives"]["counts"].values()) > 0


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_fake_collectives_equal_a_real_gloo_run(groups, mesh):
    res = groups.get()
    fake = res["fake"]["compared"][mesh]
    real = res["real"].case({"2x1": "data", "1x2": "model"}[mesh])
    assert fake["collectives"] == real["global"]
    assert fake["flops"] == real["flops"]
    assert fake["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("cell", ["granite-moe-1b-a400m/prefill",
                                  "mixtral-8x22b/prefill",
                                  "qwen2-0.5b/decode"])
def test_mesh_layouts_shrink_the_peak_against_the_joins(groups, cell):
    from _torch_dryrun_fake import MEMORY
    rec = groups.get()["fake"]["memory"][cell]
    split, joined = rec["split"]["peak_bytes"], rec["joined"]["peak_bytes"]
    assert joined > 2.5 * split, (split, joined)
    if cell.endswith("decode"):
        # the joined load held every layer's whole k and v (bf16) at once
        cfg = reduced(get_config("qwen2-0.5b"))
        shape = MEMORY[cell]
        whole = 2 * 2 * 2 * (shape.global_batch // 4) * shape.seq_len \
            * cfg.n_kv * cfg.head_dim
        assert joined - split >= 0.75 * whole, (split, joined, whole)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("n_kv", [2, 8])
def test_replicated_weights_split_heads_the_model_axis_divides(groups, n_kv,
                                                               kind):
    """With the weights placed whole and "model" dividing the heads, each
    rank takes its heads' blocks locally: the step traces, its weights
    cost no collective bytes (sharded, their joins over the batch axis
    do), and its attention's FLOPs a card are the sharded step's."""
    res = groups.get()["fake"]["replicated"]
    whole = res[f"kv{n_kv}/{kind}/whole"]
    sharded = res[f"kv{n_kv}/{kind}/sharded"]
    assert whole["flops"] > 0 and whole["peak_bytes"] > 0
    assert whole["weight_collective_bytes"] == 0
    assert sharded["weight_collective_bytes"] > 0
    assert whole["attention_flops"] == sharded["attention_flops"] > 0
    assert whole["collectives"]["total_bytes"] \
        < sharded["collectives"]["total_bytes"]


def test_replicated_weights_decode_on_two_ranks_equals_one_device(groups):
    from _torch_dryrun_cases import replicated_decode_logits
    got = groups.get()["real"].case("replicated_decode")["global"]
    want = replicated_decode_logits(None)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert float((got - want).abs().max()) <= 1e-4


def test_dots_remat_peak_lies_between_full_and_none(groups):
    rec = groups.get()["fake"]["remat"]
    assert rec["full"]["peak_bytes"] < rec["dots"]["peak_bytes"] \
        < rec["none"]["peak_bytes"]
    # "dots" recomputes less than "full", more than "none" (no recompute)
    assert rec["full"]["flops"] > rec["dots"]["flops"] \
        > rec["none"]["flops"]


HILLCLIMB_VARIANTS = {
    "mixtral_train": ["baseline_naive", "no_core", "remat_dots",
                      "remat_dots_no_core", "remat_dots_bf16logits_no_core"],
    "qwen2_prefill": ["baseline_naive", "no_core", "bf16_logits_no_core",
                      "replicated_no_core"],
    "whisper_decode": ["baseline", "replicated_weights"]}


@pytest.mark.parametrize("cell", list(HILLCLIMB_VARIANTS))
def test_hillclimb_cells_against_the_dry_run(groups, cell):
    res = groups.get()["fake"]["hillclimb"][cell]
    run, rec = res["run"], res["record"]
    assert res["written"] == run
    steps = run["steps"]
    assert list(steps) == HILLCLIMB_VARIANTS[cell]
    base = steps[HILLCLIMB_VARIANTS[cell][0]]
    assert base == {"flops": rec["flops"], "bytes": rec["bytes"],
                    "collective_bytes": rec["collectives"]["total_bytes"],
                    "peak_bytes": rec["peak_bytes"]}
    for name, s in steps.items():
        assert s["flops"] > 0 and s["bytes"] > 0 and s["peak_bytes"] > 0
        if not name.endswith("no_core"):
            assert "core" not in s
            continue
        # its own trace less exactly the custom ops' terms
        core = s["core"]
        assert set(core) == set(D.CORE_OPS)
        full = steps.get(name[:-len("_no_core")] if name != "no_core"
                         else HILLCLIMB_VARIANTS[cell][0])
        if full is not None:
            assert s["flops"] == full["flops"] - sum(
                c["flops"] for c in core.values())
            assert s["bytes"] == full["bytes"] - sum(
                c["bytes"] for c in core.values())
            assert s["peak_bytes"] == full["peak_bytes"]
            assert s["collective_bytes"] == full["collective_bytes"]
    if "no_core" in steps:
        assert steps["no_core"]["flops"] < base["flops"]
    if "remat_dots" in steps:
        # "dots" recomputes less of each layer than "full"
        assert steps["remat_dots"]["flops"] < base["flops"]


def _write_records(art: Path) -> None:
    """A few small records of each kind, as the port's runs write them."""
    from _torch_dryrun_fake import HILLCLIMB
    bench = art / "bench"
    bench.mkdir(parents=True)
    (bench / "table1_izhikevich_torch.json").write_text(json.dumps(
        {"n_conns": [40, 80], "gscales": [1.5, 0.75], "target_rate": 5.0,
         "k1": 12.5, "k2": 3.0, "k3": 0.01, "mape_pct": 1.25}))
    (bench / "table2_mushroom_lhi10_torch.json").write_text(json.dumps(
        {"k1": 2.5, "k2": 1.0, "k3": 0.5, "mape_pct": 7.5, "k1_lhi": 1.0,
         "k2_lhi": 2.0, "k3_lhi": 3.0, "mape_lhi_pct": 9.0}))
    (bench / "fig2_agreement_torch.json").write_text(json.dumps(
        {"mape_pct": 0.0}))
    (bench / "eq12_memory_torch.json").write_text(json.dumps(
        {"rows": [[100, 201001, 1000000], [500, 1001001, 1000000]]}))
    cfg = reduced(get_config("qwen2-0.5b"))
    cell = HILLCLIMB["qwen2_prefill"][1]
    rec = D.trace_cell(cfg, cell, None, "cpu")
    for tag in ("pod16x16", "pod2x16x16"):
        d = art / "dryrun_torch" / tag
        d.mkdir(parents=True)
        (d / "qwen2-0.5b__prefill_32k.json").write_text(json.dumps(
            {**rec, "arch": "qwen2-0.5b", "shape": "prefill_32k",
             "mesh": tag, "status": "OK", "n_devices": 256}))
        (d / "qwen2-0.5b__long_500k.json").write_text(json.dumps(
            {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": tag,
             "status": "SKIP", "reason": "full-attention arch"}))
    perf = art / "perf_torch"
    perf.mkdir()
    row = {"flops": 2e12, "bytes": 3e9, "collective_bytes": 4e8,
           "peak_bytes": 5e9}
    (perf / "qwen2_prefill.json").write_text(json.dumps(
        {"cell": "qwen2-0.5b x prefill_32k x pod16x16", "steps":
         {"baseline_naive": row, "no_core": row}, "n_devices": 256}))


def test_report_renders_with_and_without_records(tmp_path):
    from benchmarks import report_torch as R
    empty = tmp_path / "empty"
    empty.mkdir()
    out = R.main(["--art", str(empty), "--out", str(tmp_path / "a.md")])
    doc = out.read_text()
    for section in ("## Paper validation", "## Dry run", "## Roofline",
                    "## Perf log"):
        assert section in doc
    assert doc.count("(no ") == 4
    art = tmp_path / "art"
    _write_records(art)
    doc = R.main(["--art", str(art), "--out", str(tmp_path / "b.md")]
                 ).read_text()
    assert "(no " not in doc
    assert "| the port | 12.5 | 3 | 0.01 | 1.25 |" in doc
    assert "10 LHIs" in doc and "PN->LHI fit" in doc
    assert "| qwen2-0.5b | prefill_32k | OK |" in doc
    assert "| qwen2-0.5b | long_500k | SKIP |" in doc
    assert "### pod2x16x16" in doc and "| baseline_naive | 2 | 3 | 0.4 |" \
        in doc
    # the H100's rates, none of the TPU's (v5e: 16 GB, 197e12, 819e9)
    assert "9.89e+14" in doc and "3.35e+12" in doc
    for tpu in ("197e12", "819e9", "1.97e+14", "8.19e+11", "v5e", "16 GB"):
        assert tpu not in doc
    with pytest.raises(SystemExit):
        R.main(["--art", str(art), "--out", str(tmp_path / "EXPERIMENTS.md")])


def test_real_cpu_step_counts_equal_the_dry_run():
    from repro_torch.models import transformer as T
    from _torch_dryrun_fake import COMPARED, real_inputs
    cfg, cell = COMPARED
    fake = D.trace_cell(cfg, cell, None, "cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    step, args, ctx = D.prepare_cell(cfg, cell, None, params,
                                     real_inputs(cfg, cell))
    real = D.count_step(step, args, ctx)
    assert real["flops"] == fake["flops"] > 0
    assert real["bytes"] == fake["bytes"]
    assert real["peak_bytes"] == fake["peak_bytes"]
    assert real["collectives"] == fake["collectives"]


def test_a_cell_the_config_skips_is_a_skip():
    rec = D.run_cell("qwen2-0.5b", "long_500k", False, save=False,
                     device="cpu")
    assert rec["status"] == "SKIP" and "full-attention" in rec["reason"]
    assert RL.cell_terms(rec) is None
