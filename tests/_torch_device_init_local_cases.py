"""``device_init_local``'s multi-rank cases -- not a test module.

Each rank draws its own rows of a declaration over the mesh and returns
its post-shard block beside the single-device oracle's (the port's
``device_resolve`` of every row, then ``partition_ell_by_post``);
``test_torch_device_init_local.py`` holds both to the JAX package's
blocks.  No JAX here.
"""

import torch

from repro_torch import random as R
from repro_torch.sparse import device_init as DI
from repro_torch.sparse import formats as F

# (connect, weight, delay, post window, n_pre, n_post) by case name: the
# JAX package's test_device_init_local_bit_exact_vs_partition cases, the
# top-k regime, OneToOne and Dense
DECLS = {
    "fanout_delay": lambda F: (F.FixedFanout(7), F.NormalWeight(0.1, 0.4),
                               F.UniformIntDelay(0, 3), None, 37, 53),
    "prob": lambda F: (F.FixedProbability(0.15), F.UniformWeight(0, 1),
                       None, None, 41, 64),
    "window": lambda F: (F.FixedFanout(5), F.NormalWeight(0.0, 1.0),
                         F.ConstantDelay(2), (16, 40), 29, 48),
    "topk": lambda F: (F.FixedFanout(30), F.UniformWeight(-1.0, 1.0), None,
                       None, 19, 40),
    "one_to_one": lambda F: (F.OneToOne(), 0.5, None, None, 33, 33),
    "dense": lambda F: (F.DenseInit(), F.UniformWeight(0.0, 2.0),
                        F.UniformIntDelay(1, 4), None, 9, 13),
}
KEY_SEED = 11


def reference(mesh, name):
    """The rank's block of generate-then-partition on one device."""
    connect, weight, delay, window, n_pre, n_post = DECLS[name](F)
    key = R.PRNGKey(KEY_SEED)
    post, g, valid = DI.device_resolve(connect, key, n_pre, n_post, weight)
    dd = (None if delay is None
          else DI.device_delays(key, n_pre, post.shape[1], delay))
    if dd is not None:
        dd = torch.where(valid, dd, 0).to(torch.int32)
    n_local = n_post
    if window is not None:
        lo, hi = window
        mask = (post >= lo) & (post < hi) & valid
        post = torch.where(mask, post - lo, 0).to(torch.int32)
        g = torch.where(mask, g, 0.0)
        dd = None if dd is None else torch.where(mask, dd, 0)
        valid, n_local = mask, hi - lo
    ell = F.ELLSynapses(g=g, post_ind=post, valid=valid, n_post=n_local,
                        delay=dd)
    gg, pp, vv, dl, shard, kl = DI.partition_ell_by_post(ell,
                                                         mesh.world_size)
    d = mesh.rank
    return (gg[d], pp[d], vv[d], None if dl is None else dl[d], shard, kl)


def _blocks(mesh, name):
    connect, weight, delay, window, n_pre, n_post = DECLS[name](F)
    got = DI.device_init_local(connect, R.PRNGKey(KEY_SEED), n_pre, n_post,
                               mesh, weight=weight, delay=delay,
                               post_window=window)
    return {"local": {"got": got, "ref": reference(mesh, name)}}


def case_fanout_delay(mesh):
    return _blocks(mesh, "fanout_delay")


def case_prob(mesh):
    return _blocks(mesh, "prob")


def case_window(mesh):
    return _blocks(mesh, "window")


def case_topk(mesh):
    return _blocks(mesh, "topk")


def case_one_to_one(mesh):
    return _blocks(mesh, "one_to_one")


def case_dense(mesh):
    return _blocks(mesh, "dense")


def case_overflow_trace(mesh):
    """A FixedProbability declaration reports its clamped rows once, from
    the ranks' summed count (here: none at the 6-sigma padding)."""
    from repro_torch.obs import trace
    trace.clear()
    DI.device_init_local(F.FixedProbability(0.3), R.PRNGKey(2), 50, 60,
                         mesh)
    names = [e.get("name") for e in trace.events()]
    return {"global": {"overflow_events": names.count(
        "device_init.overflow")}}
