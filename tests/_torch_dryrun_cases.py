"""Cases of ``tests/test_torch_dryrun.py`` run on real gloo ranks -- not a
test module (``_torch_dist.py`` runs them).

Each case traces the reduced qwen2 training step (two microbatches) on
real tensors with the dry run's counter, on a ("data", "model") mesh of
the group's ranks, and returns what the counter recorded: the collectives
by kind, which the test holds equal to a fake group's trace of the same
cell (``_torch_dryrun_fake.py``).  ``case_replicated_decode`` runs the
reduced qwen2's decode step in float32 with its weights placed whole
(``serve_replicate_weights``) on a 1 x 2 mesh, whose "model" axis divides
its 4 query and 2 KV heads, and returns its logits, which the test holds
to one device's."""

import contextlib
import dataclasses

import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH
from repro_torch.models import transformer as T

from _torch_dryrun_fake import COMPARED, real_inputs


def _counts(shape):
    cfg, cell = COMPARED
    mesh = MESH.make_mesh(shape, ("data", "model"), device="cpu")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    step, args, ctx = D.prepare_cell(cfg, cell, mesh, params,
                                     real_inputs(cfg, cell))
    rec = D.count_step(step, args, ctx)
    return {"global": rec["collectives"], "flops": rec["flops"]}


def case_data(_):
    return _counts((2, 1))


def case_model(_):
    return _counts((1, 2))


# the decode cell of case_replicated_decode, and its config
REPLICATED_DECODE = ShapeConfig("decode", 32, 2, "decode")


def replicated_decode_config():
    return dataclasses.replace(reduced(get_config("qwen2-0.5b")), n_layers=2,
                               dtype="float32", serve_replicate_weights=True)


def replicated_decode_logits(mesh):
    """The decode step's logits [B, 1, V] on ``mesh`` (None: one device),
    from the same seeded weights and inputs."""
    cfg, cell = replicated_decode_config(), REPLICATED_DECODE
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    inputs = real_inputs(cfg, cell)
    if mesh is None:
        # one device takes the caches whole (a mesh's step makes its own)
        inputs["caches"] = T.init_caches(cfg, cell.global_batch,
                                         cell.seq_len, torch.bfloat16, "cpu")
    step, args, ctx = D.prepare_cell(cfg, cell, mesh, params, inputs)
    with ctx or contextlib.nullcontext():
        logits, _ = step(*args)
    return logits


def case_replicated_decode(_):
    mesh = MESH.make_mesh((1, 2), ("data", "model"), device="cpu")
    return {"global": replicated_decode_logits(mesh)}
