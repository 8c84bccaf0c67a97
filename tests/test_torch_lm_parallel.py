"""The LM stack's model parallelism (``Server(model_parallel=)``,
``run(model_parallel=)``, the MoE's expert sharding, placed checkpoints)
at 2 and 8 gloo ranks on the CPU, against the single-device port.

One group of ranks a world size runs every case of
``_torch_lm_parallel_cases.py`` (``_torch_dist.py``): D = 2 is a 1 x 2
("data", "model") mesh and runs every family, and a qwen2 of 3 heads,
which run whole on every rank (as qwen2-0.5b's 14 do on a 4-wide axis),
and qwen2 on a 2 x 1 mesh (FSDP alone); D = 8 a 2 x 4 mesh (the
batch split over "data", qwen2's cache split on its sequence, the reduced
mixtral's 3 experts on their ffn dim) for qwen2, granite-moe and the
reduced mixtral.  The single-device port, which the other tests hold to
the JAX package, runs here in this process on the same seeds, and the
mesh is held to it:

- forward logits within 1e-4, the MoE aux within 1e-6;
- the loss within rtol 1e-5; every gathered gradient within rtol 1e-4
  plus 2e-5 of the leaf's largest entry;
- a float32 prefill's and two decode steps' logits within 1e-4, their
  caches within 1e-5;
- a short ``Server`` run's greedy tokens equal;
- three trainer steps' losses, and a restart from the mesh's own
  checkpoint to a fourth, within rtol 1e-5;
- a placed save (rank 0 writes the joined leaves) restored at D = 1 by
  the port and by the JAX package, bit for bit, and on the mesh into
  every rank's blocks.

At D = 2 qwen2's forward from the JAX package's weights is also held to
the JAX package's unsharded forward (1e-4).

The MoE block alone, with drops (capacity factor 1.25), on a 2 x 1 mesh
(D = 2) and a 2 x 4 one (D = 8), "expert" (granite) and "ffn" (mixtral)
sharding: where each rank's rows are whole groups it routes them itself,
and its routing and drops joined over the batch ranks equal one device's
exactly; y, aux and every gradient within the tolerances above; where
the groups do not divide the rank's rows the gather route agrees too.
The decode over a split cache sequence (a KV-head count that does not
divide "model", a ring cache, a batch-1 wave whose sequence lies on the
batch axes, a first step at which most blocks are empty): every step's
float32 logits within 1e-4 and the caches within 1e-5 of one device's,
each rank's cache a block of the sequence during the step, and a server
run's greedy tokens equal.
"""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

import _torch_lm_parallel_cases as C  # noqa: E402
from _torch_dist import start_ranks  # noqa: E402
from repro.checkpoint import manager as JCK  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCM  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import manager as TCK  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CASES = Path(C.__file__).resolve()
FAMILIES = {2: ["qwen2", "granite", "mixtral", "mamba2", "zamba2",
                "whisper", "paligemma", "qwen2_data", "qwen2_h3"],
            8: ["qwen2", "granite", "mixtral"]}
ARCH = {"qwen2": "qwen2-0.5b", "granite": "granite-moe-1b-a400m",
        "mixtral": C.MIXTRAL_FFN, "mamba2": "mamba2-2.7b",
        "zamba2": "zamba2-7b", "whisper": "whisper-tiny",
        "paligemma": "paligemma-3b", "qwen2_h3": C.QWEN2_WHOLE_HEADS,
        "qwen2_data": "qwen2-0.5b"}
CASE_IDS = [(d, f) for d in (2, 8) for f in FAMILIES[d]]


def _jax_qwen2():
    cfg = jreduced(jget_config("qwen2-0.5b"))
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups started side by side, the single-device references
    computed here meanwhile: ({D: RankResults}, {family: reference})."""
    tmp = {d: tmp_path_factory.mktemp(f"lm_D{d}") for d in FAMILIES}
    torch.save(jax.tree.map(np.asarray, _jax_qwen2()[1]),
               tmp[2] / "jax_qwen2.pt")
    started = {d: start_ranks(CASES, d, tmp[d], timeout_s=600)
               for d in FAMILIES}
    # one thread here: the ranks have the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        singles = {a: _single(a, tmp_path_factory.mktemp("single"))
                   for a in sorted(set(ARCH.values()))}
    finally:
        torch.set_num_threads(threads)
        groups = {d: s.wait() for d, s in started.items()}
    return groups, singles


def _single(arch: str, tmp: Path) -> dict:
    """The single-device port on the cases' seeds and inputs."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks, extra = C.inputs(cfg)
    out = {"params": params, "cfg": cfg}
    leaves, _ = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    logits, aux = T.forward(params, cfg, toks[:, :-1], extra)
    out["logits"], out["aux"] = logits.detach().numpy(), float(aux)
    loss, metrics = T.loss_fn(params, cfg, {"tokens": toks, **extra})
    out["loss"] = float(loss.detach())
    out["ce"] = float(metrics["ce"].detach())
    out["grads"] = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    for p in leaves:
        p.requires_grad_(False)
    with torch.no_grad():
        plog, caches = T.prefill(params, cfg, toks[:, :8], extra,
                                 cache_dtype=torch.float32,
                                 max_seq=C.MAX_SEQ)
        steps = [plog.numpy()]
        for i in range(2):
            dlog, caches = T.decode_step(params, cfg, caches,
                                         toks[:, 8 + i])
            steps.append(dlog.numpy())
    out["decode_logits"] = steps
    out["caches"] = [x.float().numpy() for x in tree_flatten(
        {"segments": caches["segments"], "tail": caches["tail"]})[0]
        if isinstance(x, torch.Tensor)]
    srv = S.Server(arch, max_batch=4, max_seq=32, device="cpu")
    for i, p in enumerate(C.PROMPTS):
        srv.submit(S.Request(rid=i, prompt=p, max_new=C.MAX_NEW))
    out["tokens"] = {r.rid: r.out for r in srv.run()}
    ck = str(tmp / "ck")
    out["losses"] = TR.run(arch, steps=C.STEPS, batch=C.B, seq=C.T_LEN,
                           ckpt_dir=ck, ckpt_every=2, log_every=100,
                           device="cpu")
    out["restart_losses"] = TR.run(arch, steps=C.STEPS + 1, batch=C.B,
                                   seq=C.T_LEN, ckpt_dir=ck, ckpt_every=2,
                                   log_every=100, device="cpu")
    return out


@functools.lru_cache(maxsize=None)
def _moe_single(arch: str, route: str) -> dict:
    """The MoE block on one device on the case's inputs (the routing
    recorded)."""
    from unittest import mock
    from repro_torch.models import moe as MO
    mcfg = C.moe_config(arch, C.MOE_GROUPS[route])
    params, x, c = C.moe_inputs(mcfg)
    leaves = [params[k] for k in params]
    for p in leaves:
        p.requires_grad_(True)
    x.requires_grad_(True)
    record, seen = C.moe_routes()
    with mock.patch.object(MO, "moe_route", record):
        y, aux = MO.moe_apply(params, mcfg, x)
    grads = torch.autograd.grad((y * c).sum() + aux, [x] + leaves)
    idx, place, keep = seen[0]
    return {"y": y.detach().numpy(), "aux": float(aux.detach()),
            "expert_idx": idx.numpy(), "place": place.numpy(),
            "keep": keep.numpy(), "grad_x": grads[0].numpy(),
            "grads": [g.numpy() for g in grads[1:]],
            "groups": idx.shape[0]}


MOE_IDS = [(d, a, r) for d in (2, 8) for a in C.MOE_ARCHS
           for r in C.MOE_GROUPS]


@pytest.mark.parametrize("d,arch,route", MOE_IDS,
                         ids=[f"D{d}-{a}-{r}" for d, a, r in MOE_IDS])
def test_moe_routes_each_ranks_groups(runs, d, arch, route):
    got = runs[0][d].case("moe_routing")["global"][f"{arch}/{route}"]
    want = _moe_single(arch, route)
    # both meshes split the batch over 2 ranks
    assert got["groups_routed"] == (want["groups"] // 2 if route == "local"
                                    else want["groups"])
    for k in ("expert_idx", "place", "keep"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if route == "local":
        assert not want["keep"].all()         # the case drops pairs
    np.testing.assert_allclose(got["y"], want["y"], atol=1e-4, rtol=0)
    assert abs(got["aux"] - want["aux"]) <= 1e-6
    for i, (g, w) in enumerate(zip([got["grad_x"]] + got["grads"],
                                   [want["grad_x"]] + want["grads"])):
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=2e-5 * float(np.abs(w).max()),
            err_msg=f"gradient {i}")


@functools.lru_cache(maxsize=None)
def _decode_single(d: int, name: str) -> dict:
    arch, _, b, prompt, max_seq, n = C.SPLIT_DECODE[d][name]
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = C.split_decode_tokens(arch, prompt, b)
    with torch.no_grad():
        plog, caches = T.prefill(params, cfg, toks[:, :prompt],
                                 cache_dtype=torch.float32, max_seq=max_seq)
        logits = [plog.numpy()]
        for i in range(n):
            dlog, caches = T.decode_step(params, cfg, caches,
                                         toks[:, prompt + i])
            logits.append(dlog.numpy())
    srv = S.Server(arch, max_batch=4, max_seq=max_seq, device="cpu")
    prompts = (C.RING_PROMPTS if name == "ring" else
               [toks[r, :prompt].tolist() for r in range(b)])
    for i, p in enumerate(prompts):
        srv.submit(S.Request(rid=i, prompt=p, max_new=6))
    return {"logits": logits, "caches": [
        x.float().numpy() for x in tree_flatten(
            {"segments": caches["segments"], "tail": caches["tail"]})[0]
        if isinstance(x, torch.Tensor)],
        "tokens": {r.rid: r.out for r in srv.run()}}


DECODE_IDS = [(d, n) for d in (2, 8) for n in C.SPLIT_DECODE[d]]


@pytest.mark.parametrize("d,name", DECODE_IDS,
                         ids=[f"D{d}-{n}" for d, n in DECODE_IDS])
def test_decode_attends_each_ranks_cache_block(runs, d, name):
    got = runs[0][d].case("split_decode")["global"][name]
    want = _decode_single(d, name)
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
    have = [x for x in tree_flatten(got["caches"])[0]
            if isinstance(x, np.ndarray)]
    assert len(have) == len(want["caches"])
    for i, (g, w) in enumerate(zip(have, want["caches"])):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=f"cache leaf {i}")
    # during the step each k/v cache is this rank's block of its sequence
    shape = C.SPLIT_DECODE[d][name][1]
    blocks = shape[0] if name == "batch1" else shape[1]
    kv = [w.shape for w in want["caches"] if w.ndim == 5]
    step = [s for s in got["blocks"] if len(s) == 5]
    assert len(step) == len(kv) > 0
    for s, w in zip(step, kv):
        assert s[2] * blocks == w[2], (s, w)
    assert got["tokens"] == want["tokens"]


def _mesh_case(runs, d, family):
    return runs[0][d].case(family)["global"], runs[1][ARCH[family]]


@pytest.mark.parametrize("d,family", CASE_IDS,
                         ids=[f"D{d}-{f}" for d, f in CASE_IDS])
def test_forward_loss_and_gradients(runs, d, family):
    got, want = _mesh_case(runs, d, family)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4,
                               rtol=0)
    assert abs(got["aux"] - want["aux"]) <= 1e-6
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["ce"], want["ce"], rtol=1e-5)
    assert len(got["grads"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=2e-5 * float(np.abs(w).max()),
            err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("d,family", CASE_IDS,
                         ids=[f"D{d}-{f}" for d, f in CASE_IDS])
def test_prefill_decode_and_caches(runs, d, family):
    got, want = _mesh_case(runs, d, family)
    for i, (g, w) in enumerate(zip(got["decode_logits"],
                                   want["decode_logits"])):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
    have = [x for x in tree_flatten(got["caches"])[0]
            if isinstance(x, np.ndarray)]
    assert len(have) == len(want["caches"])
    for i, (g, w) in enumerate(zip(have, want["caches"])):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=f"cache leaf {i}")


@pytest.mark.parametrize("d,family", CASE_IDS,
                         ids=[f"D{d}-{f}" for d, f in CASE_IDS])
def test_server_and_trainer(runs, d, family):
    got, want = _mesh_case(runs, d, family)
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert len(got["restart_losses"]) == 1
    np.testing.assert_allclose(got["restart_losses"],
                               want["restart_losses"], rtol=1e-5)


@pytest.mark.parametrize("d,family", CASE_IDS,
                         ids=[f"D{d}-{f}" for d, f in CASE_IDS])
def test_placed_checkpoint_restores_whole(runs, d, family):
    got, want = _mesh_case(runs, d, family)
    assert got["restored_equal"]
    like = {"params": want["params"]}
    saved = dict(TCK._flatten({"params": got["saved"]}))
    port = dict(TCK._flatten(CheckpointManager(got["save_dir"]).restore(
        1, like)))
    assert set(port) == set(saved)
    for k, s in saved.items():
        np.testing.assert_array_equal(port[k].float().numpy(), s,
                                      err_msg=k)
    jax_like = {"params": jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                       like["params"])}
    jback = dict(JCK._flatten(JCM(got["save_dir"]).restore(1, jax_like))[0])
    assert set(jback) == set(saved)
    for k, s in saved.items():
        np.testing.assert_array_equal(np.asarray(jback[k], np.float32), s,
                                      err_msg=k)


def test_nan_rollback_on_the_mesh(runs, tmp_path):
    """A non-finite loss at step 3 rolls the mesh back to step 2 with the
    LR halved, as it does on one device: the same losses, the repeated
    step's included, within rtol 1e-5."""
    got = runs[0][2].case("qwen2_rollback")["global"]["losses"]
    want = C.rollback_run(tmp_path / "ck")
    assert len(got) == len(want) == 4 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_qwen2_mesh_forward_matches_jax(runs):
    got = runs[0][2].case("qwen2_jax_weights")["global"]["logits"]
    cfg, params = _jax_qwen2()
    toks, _ = C.inputs(cfg)
    want, _ = JT.forward(params, cfg, jnp.asarray(toks[:, :-1].numpy()))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
