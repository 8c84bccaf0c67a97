"""The port's checkpoints (``repro_torch.checkpoint.manager``) and what the
trainer does with them, on the CPU, against the JAX package's
``CheckpointManager`` and trainer:

- the JAX package's own checks mirrored (``tests/test_substrate.py``): a
  round trip with bf16, retention, a manifest-less directory never seen,
  a shape mismatch that raises;
- ``save`` copies to host memory before it returns (an in-place update
  after it does not reach the file), and the async writer's error
  surfaces at ``wait()``; a shard is read through a memory map, and
  ``restore(in_place=True)`` writes into the ``like`` tensors;
- the leaf keys are the JAX package's, and a checkpoint that either
  package writes restores in the other bit for bit;
- the trainer: a restarted run equals the uninterrupted one bit for bit
  (losses and the last step's params and optimizer state); a JAX run's
  checkpoint continued by the port gives the JAX run's later losses; a
  non-finite loss rolls back to the latest checkpoint with the LR halved,
  as the JAX trainer does, or raises when there is none.

Tolerances: restores and restarts bit for bit; losses that cross
packages within rtol=1e-5 (``tests/test_torch_train.py``'s).
"""

import functools
import json
import os
import shutil
import time
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as JM  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JAW  # noqa: E402
from repro_torch.checkpoint import manager as TM  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TAW  # noqa: E402

ARCH = "qwen2-0.5b"
RUN = dict(batch=2, seq=16, log_every=1)
# the JAX trainer's manager writing synchronously: its rollback reads
# latest_step() without waiting for the writer
JAX_SYNC_WRITES = mock.patch.object(
    JTR, "CheckpointManager",
    functools.partial(JM.CheckpointManager, async_writes=False))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_roundtrip_with_bf16(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=2, async_writes=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.randn(4).to(torch.bfloat16)},
            "n": 7}
    mgr.save(10, tree, blocking=True)
    assert mgr.latest_step() == 10
    stored = _npz(tmp_path / "step_000000010" / "shard_0.npz")
    assert stored["b/c"].dtype == np.uint16 and stored["n"].dtype == np.int32
    like = {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}, "n": 0}
    out = mgr.restore(10, like)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["n"] == 7 and isinstance(out["n"], int)


def test_a_shard_is_mapped_and_a_compressed_one_raises(tmp_path):
    """A shard written by ``np.savez`` is read through a memory map of the
    file; one with compressed members (which neither package writes) is
    refused by name, not read another way."""
    mgr = CheckpointManager(tmp_path, async_writes=False)
    tree = {"w": torch.randn(3, 5), "h": torch.randn(7).to(torch.bfloat16),
            "n": 2}
    mgr.save(1, tree)
    shard = tmp_path / "step_000000001" / "shard_0.npz"
    mapped = TM._read_shard(shard)
    assert all(isinstance(a, np.memmap) for a in mapped.values())
    like = {"w": torch.zeros(3, 5), "h": torch.zeros(7, dtype=torch.bfloat16),
            "n": 0}
    out = mgr.restore(1, like)
    assert torch.equal(out["w"], tree["w"])
    assert torch.equal(out["h"], tree["h"]) and out["n"] == 2
    np.savez_compressed(shard, **_npz(shard))
    with pytest.raises(ValueError, match="compressed"):
        mgr.restore(1, like)


def test_restore_in_place_overwrites_the_like_tensors(tmp_path):
    """``in_place`` copies each leaf into its ``like`` tensor (a leaf that
    requires grad too) and returns it; the int leaf is made anew."""
    mgr = CheckpointManager(tmp_path, async_writes=False)
    tree = {"w": torch.randn(3, 5), "h": torch.randn(7).to(torch.bfloat16),
            "n": 2}
    mgr.save(1, tree)
    like = {"w": torch.zeros(3, 5, requires_grad=True),
            "h": torch.zeros(7, dtype=torch.bfloat16), "n": 0}
    out = mgr.restore(1, like, in_place=True)
    assert out["w"] is like["w"] and out["h"] is like["h"]
    assert torch.equal(like["w"], tree["w"])
    assert torch.equal(like["h"], tree["h"]) and out["n"] == 2
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": torch.zeros(5, 3), "h": like["h"], "n": 0},
                    in_place=True)


def test_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=2, async_writes=False)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.ones(3) * s}, blocking=True)
    assert mgr.steps() == [2, 3]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000002", "step_000000003"]
    # a partial (manifest-less) directory is invisible and never restored
    (tmp_path / "step_000000099").mkdir()
    (tmp_path / "step_000000098").mkdir()
    (tmp_path / "step_000000098" / "manifest.json").write_text(
        json.dumps({"step": 98, "status": "WRITING"}))
    assert mgr.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(99, {"x": torch.zeros(3)})
    # the writer's cleanup removes an incomplete directory a minute old
    old = time.time() - 120
    os.utime(tmp_path / "step_000000099", (old, old))
    mgr.save(4, {"x": torch.ones(3)}, blocking=True)
    assert not (tmp_path / "step_000000099").exists()
    assert mgr.steps() == [3, 4]


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    mgr = CheckpointManager(tmp_path, async_writes=False)
    mgr.save(1, {"x": torch.ones(2, 2)}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(1, {"x": torch.ones(3, 3)})
    with pytest.raises(KeyError, match="y"):
        mgr.restore(1, {"x": torch.ones(2, 2), "y": torch.ones(1)})


def test_save_copies_before_an_in_place_update(tmp_path):
    """The writer is slowed down; the tensors are updated in place as soon
    as ``save`` returns (AdamW's next step): the file holds the saved
    values."""
    mgr = CheckpointManager(tmp_path)
    x = torch.arange(5, dtype=torch.float32)
    h = torch.ones(3, dtype=torch.bfloat16)
    real = np.savez

    def slow(*a, **k):
        time.sleep(0.3)
        return real(*a, **k)

    with mock.patch.object(np, "savez", slow):
        mgr.save(1, {"x": x, "h": h})
        x.add_(100.0)
        h.mul_(3.0)
        mgr.wait()
    out = mgr.restore(1, {"x": x, "h": h})
    assert torch.equal(out["x"], torch.arange(5, dtype=torch.float32))
    assert torch.equal(out["h"], torch.ones(3, dtype=torch.bfloat16))


def test_async_error_surfaces_at_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with mock.patch.object(CheckpointManager, "_write",
                           side_effect=OSError("disk full")):
        mgr.save(1, {"x": torch.ones(2)})
        with pytest.raises(RuntimeError, match="disk full"):
            mgr.wait()
    mgr.wait()                       # the error is raised once
    assert mgr.latest_step() is None


def test_process_index_is_the_rank(tmp_path):
    assert CheckpointManager(tmp_path).process_index == 0
    with mock.patch.object(TM.dist, "is_initialized", lambda: True), \
            mock.patch.object(TM.dist, "get_rank", lambda: 3), \
            mock.patch.object(TM.dist, "get_world_size", lambda: 4):
        mgr = CheckpointManager(tmp_path, async_writes=False)
        assert mgr.process_index == 3
        mgr.save(1, {"x": torch.ones(2)})
    m = json.loads((tmp_path / "step_000000001" / "manifest.json")
                   .read_text())
    assert m["process_count"] == 4
    assert (tmp_path / "step_000000001" / "shard_3.npz").exists()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _trees():
    """The same params and AdamW state in both packages: bf16 and float32
    leaves, nested dicts and lists, the optimizer's NamedTuple and step."""
    rng = np.random.default_rng(3)
    arrays = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
              "segments": [{"attn": {"wq": rng.standard_normal((2, 4, 4))
                                     .astype(np.float32)}}],
              "img_proj": rng.standard_normal((3, 4)).astype(np.float32)}
    grads = jax.tree.map(lambda a: (0.1 * a).astype(np.float32), arrays)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), arrays)
    jp["img_proj"] = jnp.asarray(arrays["img_proj"])
    jcfg, tcfg = JAW.AdamWConfig(lr=1e-2), TAW.AdamWConfig(lr=1e-2)
    jp, jopt, _ = JAW.update(jcfg, jax.tree.map(jnp.asarray, grads),
                             JAW.init(jcfg, jp), jp)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32), jp)
    topt = TAW.init(tcfg, tp)
    return {"params": jp, "opt": jopt}, {"params": tp, "opt": topt}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_keys_are_the_jax_packages(tmp_path):
    jtree, ttree = _trees()
    JM.CheckpointManager(tmp_path / "j", async_writes=False).save(1, jtree)
    CheckpointManager(tmp_path / "t", async_writes=False).save(1, ttree)
    jkeys = json.loads((tmp_path / "j" / "step_000000001" / "manifest.json")
                       .read_text())["keys"]
    tkeys = json.loads((tmp_path / "t" / "step_000000001" / "manifest.json")
                       .read_text())["keys"]
    assert tkeys == jkeys
    assert {"params/segments/0/attn/wq", "opt/.step", "opt/.mu/embed",
            "opt/.master/img_proj"} <= set(tkeys)


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _trees()
    JM.CheckpointManager(tmp_path, async_writes=False).save(5, jtree)
    out = CheckpointManager(tmp_path).restore(5, ttree)
    assert isinstance(out["opt"], TAW.AdamWState) and out["opt"].step == 1
    jleaves = dict(JM._flatten(jtree)[0])
    tleaves = dict(TM._flatten(out))
    assert sorted(jleaves) == sorted(tleaves)
    for k, a in jleaves.items():
        b = tleaves[k]
        assert np.array_equal(_as_np(b), _as_np(a)), k
        if isinstance(b, torch.Tensor):
            assert b.dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32}[a.dtype.name], k


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    jtree, ttree = _trees()
    ttree["opt"] = ttree["opt"]._replace(step=1)
    CheckpointManager(tmp_path, async_writes=False).save(5, ttree)
    like = jax.tree.map(jnp.zeros_like, jtree)
    out = JM.CheckpointManager(tmp_path, async_writes=False).restore(5, like)
    jleaves = dict(JM._flatten(out)[0])
    like_leaves = dict(JM._flatten(like)[0])
    for k, b in TM._flatten(ttree):
        a = jleaves[k]
        assert np.array_equal(_as_np(a), _as_np(b)), k
        assert a.dtype == like_leaves[k].dtype, k


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_restart_equals_the_uninterrupted_run(tmp_path, capsys):
    """6 steps, a checkpoint every 3: a second run whose step-6 manifest is
    removed restarts from step 3 and gives steps 4-6 and the step-6 state
    bit for bit."""
    a, b = tmp_path / "a", tmp_path / "b"
    full = TTR.run(ARCH, steps=6, ckpt_every=3, ckpt_dir=str(a), device="cpu",
                   **RUN)
    TTR.run(ARCH, steps=6, ckpt_every=3, ckpt_dir=str(b), device="cpu",
            **RUN)
    (b / "step_000000006" / "manifest.json").unlink()
    capsys.readouterr()
    resumed = TTR.run(ARCH, steps=6, ckpt_every=3, ckpt_dir=str(b),
                      device="cpu", **RUN)
    assert "[train] restored step 3" in capsys.readouterr().out
    assert len(full) == 6 and resumed == full[3:]
    want = _npz(a / "step_000000006" / "shard_0.npz")
    got = _npz(b / "step_000000006" / "shard_0.npz")
    assert sorted(got) == sorted(want) and "opt/.step" in got
    assert int(got["opt/.step"]) == 6
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # a finished run restarts at its last step and trains nothing
    assert TTR.run(ARCH, steps=6, ckpt_every=3, ckpt_dir=str(b),
                   device="cpu", **RUN) == []


def test_the_port_continues_a_jax_run(tmp_path):
    """A JAX trainer run checkpointed at step 5, continued by the port to
    step 8: the JAX uninterrupted run's losses 6-8."""
    with JAX_SYNC_WRITES:
        jlosses = JTR.run(ARCH, steps=8, ckpt_every=5,
                          ckpt_dir=str(tmp_path / "j"), **RUN)
    mine = tmp_path / "t"
    mine.mkdir()
    shutil.copytree(tmp_path / "j" / "step_000000005",
                    mine / "step_000000005")
    tlosses = TTR.run(ARCH, steps=8, ckpt_every=5, ckpt_dir=str(mine),
                      device="cpu", **RUN)
    assert len(jlosses) == 8 and len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses[5:], rtol=1e-5)


def _bad_tokens(step):
    """The trainer's batch at ``step`` (the pipeline's draw)."""
    cfg = reduced(get_config(ARCH))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=RUN["seq"],
                      global_batch=RUN["batch"], seed=0)
    return TokenPipeline(dcfg, start_step=step, device="cpu").next_batch()[
        "tokens"].numpy()


def test_rollback_halves_the_lr_as_the_jax_trainer(tmp_path, capsys):
    """A non-finite loss injected at step 5 (its first time only) rolls
    back to step 3 with lr_scale 0.5: the port's losses equal the JAX
    trainer's under the same injection, and step 4 after the rollback
    repeats step 4's loss bit for bit."""
    jc = reduced(get_config(ARCH))
    arrays = jax.tree.map(np.asarray, JT.init_params(
        jreduced(jget_config(ARCH)), jax.random.PRNGKey(0)))
    bad = jnp.asarray(_bad_tokens(4))
    # the JAX step function traces its loss more than once; the injection
    # is in every trace of the first step function, and in none of the
    # one the rollback makes
    real_j, real_make, inject = JT.loss_fn, JTR.make_train_step, []

    def jloss(p, cfg, batch):
        loss, m = real_j(p, cfg, batch)
        if len(inject) == 1:
            loss = jnp.where(jnp.all(batch["tokens"] == bad), jnp.nan, loss)
        return loss, m

    def jmake(cfg, ocfg):
        inject.append(1)
        return real_make(cfg, ocfg)

    with mock.patch.object(JT, "loss_fn", jloss), \
            mock.patch.object(JTR, "make_train_step", jmake), JAX_SYNC_WRITES:
        jlosses = JTR.run(ARCH, steps=6, ckpt_every=3,
                          ckpt_dir=str(tmp_path / "j"), **RUN)
    assert len(inject) == 2
    assert "rollback to 3, lr_scale=0.5" in capsys.readouterr().out

    real_t, calls = TT.loss_fn, []

    def tloss(p, cfg, batch):
        loss, m = real_t(p, cfg, batch)
        calls.append(1)
        return (loss + float("nan") if len(calls) == 5 else loss), m

    with mock.patch.object(TT, "init_params", lambda cfg, gen:
                           load_lm_params(jc, arrays, "cpu")), \
            mock.patch.object(TT, "loss_fn", tloss):
        tlosses = TTR.run(ARCH, steps=6, ckpt_every=3,
                          ckpt_dir=str(tmp_path / "t"), device="cpu", **RUN)
    assert "NaN at step 4; rollback to 3, lr_scale=0.5" in \
        capsys.readouterr().out
    assert len(calls) == 8 and len(tlosses) == 7
    assert tlosses[4] == tlosses[3]   # step 4 again, from the checkpoint
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    # the halved LR moved steps 5 and 6 off the uninterrupted run
    with mock.patch.object(TT, "init_params", lambda cfg, gen:
                           load_lm_params(jc, arrays, "cpu")):
        plain = TTR.run(ARCH, steps=6, device="cpu", **RUN)
    assert plain[:4] == tlosses[:4] and plain[4] != tlosses[5]


def test_non_finite_loss_before_a_checkpoint_raises(tmp_path):
    real_t = TT.loss_fn

    def tloss(p, cfg, batch):
        loss, m = real_t(p, cfg, batch)
        return loss + float("nan"), m

    with mock.patch.object(TT, "loss_fn", tloss):
        with pytest.raises(FloatingPointError, match="step 0"):
            TTR.run(ARCH, steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                    device="cpu", **RUN)
    assert CheckpointManager(tmp_path).latest_step() is None
