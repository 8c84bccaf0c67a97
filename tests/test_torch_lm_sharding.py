"""The LM half of the port's mesh and sharding rules, in one process.

- ``_alloc`` on every case of ``tests/test_sharding_small.py::
  test_param_spec_rules_unit``, against the JAX package's;
- ``param_specs``, ``batch_specs`` and ``cache_shardings`` equal to the JAX
  package's PartitionSpecs, leaf for leaf, for every arch's reduced config
  on ("data", "model") meshes of (1, 2), (2, 2) and (2, 4) and a ("pod",
  "data", "model") mesh of (2, 2, 2); the JAX side from its own functions
  on ``jax.sharding.AbstractMesh`` (no devices), the port's on a mesh of
  the same names and sizes.  The full-size qwen2-0.5b (14 heads, 2 KV
  heads), granite-moe (32 experts) and mixtral (8 experts: the ffn dim
  takes "model") are also held on the production meshes, from the JAX
  package's parameter shapes;
- ``make_local_mesh``, ``batch_axes`` and ``MeshPlan`` on a one-rank
  group, and ``make_production_mesh`` refusing a world of one.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
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


def _meshes(shape, axes):
    port = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    return port, AbstractMesh(shape, axes)


def _jax_specs(tree):
    """{path: spec tuple} of a JAX tree of PartitionSpecs or
    NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(
            x, (jax.sharding.PartitionSpec, jax.sharding.NamedSharding)))[0]
    out = {}
    for path, leaf in leaves:
        spec = getattr(leaf, "spec", leaf)
        out[JSH._leaf_path(path)] = tuple(spec)
    return out


def _port_specs(tree, path=""):
    """{path: spec tuple} of the port's spec tree (dicts and lists of
    tuples)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_port_specs(v, f"{path}/{k}" if path else str(k)))
    return out


def _equal_specs(port, jx, what):
    port, jx = _port_specs(port), _jax_specs(jx)
    assert port, what
    for path, spec in port.items():
        if path.endswith("/ring"):
            continue    # a Python bool in the port's cache, an array in JAX's
        assert path in jx, f"{what}: {path} has no JAX leaf"
        assert spec == jx[path], f"{what}: {path} {spec} != {jx[path]}"


def test_alloc_matches_the_jax_unit_cases():
    port, jx = _meshes((4, 4), ("data", "model"))
    for shape, cands in [((8, 16, 32), ["model", "fsdp", "model"]),
                         ((6, 16, 32), ["model", "fsdp", "model"]),
                         ((5, 16, 32), ["fsdp", "model"]),
                         ((7, 9), ["fsdp", "model"])]:
        assert SH._alloc(shape, cands, port) == \
            tuple(JSH._alloc(shape, cands, jx)), (shape, cands)
    assert SH._alloc((8, 16, 32), ["model", "fsdp", "model"], port) == \
        ("model", "data", None)
    assert SH._alloc((6, 16, 32), ["model", "fsdp", "model"], port) == \
        (None, "data", "model")


@pytest.fixture(scope="module")
def trees():
    """Every arch's reduced config: the port's params and caches, the JAX
    package's parameter and cache shapes."""
    out = {}
    for name in sorted(JARCHS):
        cfg, jcfg = reduced(get_config(name)), jreduced(JARCHS[name])
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        jparams = jax.eval_shape(
            lambda c=jcfg: JT.init_params(c, jax.random.PRNGKey(0)))
        caches = {b: T.init_caches(cfg, b, 32, device="meta")
                  for b in (1, 4)}
        jcaches = {b: jax.eval_shape(lambda c=jcfg, b=b:
                                     JT.init_caches(c, b, 32))
                   for b in (1, 4)}
        out[name] = (cfg, params, jparams, caches, jcaches)
    return out


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_specs_match_jax(trees, arch, shape, axes):
    _, params, jparams, _, _ = trees[arch]
    port, jx = _meshes(shape, axes)
    _equal_specs(SH.param_specs(params, port),
                 JSH.param_specs(jparams, jx), f"{arch} {shape}")


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_batch_and_cache_specs_match_jax(trees, arch, shape, axes):
    cfg, _, _, caches, jcaches = trees[arch]
    port, jx = _meshes(shape, axes)
    for b in (1, 4, 6):
        batch = {"tokens": torch.zeros((b, 17), dtype=torch.int64)}
        spec = T.extra_input(cfg)
        if spec is not None:
            batch[spec[0]] = torch.zeros((b,) + spec[1])
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
                  for k, v in batch.items()}
        _equal_specs(SH.batch_specs(batch, port),
                     JSH.batch_specs(jbatch, jx), f"{arch} batch {b}")
    for b in (1, 4):
        _equal_specs(SH.cache_shardings(caches[b], port),
                     JSH.cache_shardings(jcaches[b], jx),
                     f"{arch} caches {b}")


@pytest.mark.parametrize("shape,axes", PRODUCTION,
                         ids=["x".join(map(str, s)) for s, _ in PRODUCTION])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m",
                                  "mixtral-8x22b"])
def test_full_size_specs_match_jax(arch, shape, axes):
    """The degraded shardings at full size: qwen2's 14 heads and 2 KV
    heads leave q and the KV projections whole on a 16-wide "model" axis
    (their columns still split where the axis divides them), and a batch
    of one puts the cache's sequence dim on the batch axes; mixtral's 8
    experts leave "model" to the ffn dim."""
    jcfg = JARCHS[arch]
    jparams = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    port, jx = _meshes(shape, axes)
    want = JSH.param_specs(jparams, jx)
    _equal_specs(SH.param_specs(jparams, port), want, f"{arch} {shape}")
    jcaches = jax.eval_shape(lambda: JT.init_caches(jcfg, 1, 4096))
    _equal_specs(SH.cache_shardings(jcaches, port),
                 JSH.cache_shardings(jcaches, jx), f"{arch} caches")
    if arch == "mixtral-8x22b":
        spec = SH.param_specs(jparams, port)["segments"][0]["moe"]
        assert spec["w_gate"][-3:] == (None, axes[-2] if len(axes) == 2
                                       else ("pod", "data"), "model")


@pytest.fixture
def one_rank():
    """A one-rank gloo group for the test, ended after it."""
    assert not torch.distributed.is_initialized()
    M.init_distributed()
    try:
        yield
    finally:
        M.shutdown_distributed()


def test_local_mesh_and_plan_on_one_rank(one_rank):
    mesh = M.make_local_mesh(4, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert M.batch_axes(mesh) == ("data",)
    plan = M.MeshPlan(mesh)
    assert (plan.batch, plan.model, plan.n_devices) == (("data",), "model",
                                                        1)
    assert repr(plan) == "MeshPlan({'data': 1, 'model': 1})"
    assert repr(JM.MeshPlan(JM.make_local_mesh(4))) == repr(plan)
    assert (mesh.size("model"), mesh.coord("model"), mesh.size("batch"),
            mesh.coord("batch")) == (1, 0, 1, 0)
    # a placed tensor's blocks are the tensor itself at one rank
    x = torch.arange(12.0).reshape(3, 4)
    d = SH.NamedSharding(mesh, ("data", "model")).distribute(x)
    assert torch.equal(d.to_local(), x) and torch.equal(d.full_tensor(), x)
    with pytest.raises(ValueError, match="world has 1"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="world has 1"):
        M.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        M.make_mesh((2, 2), ("data", "model"), device="cpu")


def test_batch_axes_and_plan_without_ranks():
    port, jx = _meshes((2, 2, 4), ("pod", "data", "model"))
    assert M.batch_axes(port) == JM.batch_axes(jx) == ("pod", "data")
    fake = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 4},
                           devices=torch.zeros(2, 4).numpy())
    plan = M.MeshPlan(fake)
    assert (plan.batch, plan.model, plan.n_devices) == (("data",), "model",
                                                        8)
