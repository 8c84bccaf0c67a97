"""Cases of ``tests/test_torch_dryrun.py`` run on real gloo ranks -- not a
test module (``_torch_dist.py`` runs them).

Each case traces the reduced qwen2 training step (two microbatches) on
real tensors with the dry run's counter, on a ("data", "model") mesh of
the group's ranks, and returns what the counter recorded: the collectives
by kind, which the test holds equal to a fake group's trace of the same
cell (``_torch_dryrun_fake.py``)."""

import torch

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
