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
the JAX package's unsharded forward (1e-4).  The MoE routing is the same
on the mesh as on one device: the router runs whole on the whole batch
on every rank, so no near tie can flip between them.
"""

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
