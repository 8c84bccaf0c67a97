"""Digests of the graphs ``build(init="device")`` makes for the main path's
nets, computed from the JAX package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python experiments/device_init_digests.py \
        [--n-total 100000] [--n-conn 1000] [--chunk 5000] [--whole]

The nets are ``chip_smoke.py``'s: phase 3's Izhikevich net
(``IzhikevichNetConfig(n_total, n_conn)``, seed 1234; "main") and phase
5's, the same with ``UniformIntDelay(0, 20)`` on the excitatory synapse
population ("delay").  The JAX package's device initializers
(``repro.sparse.device_init``) generate each synapse population in chunks
of ``--chunk`` rows (``rows=``: the graph does not depend on the chunking),
split by post population as ``ModelSpec.build`` splits it, and hash it; the
memory stays that of a chunk.  ``--whole`` builds each net with
``compile_model(init="device")`` instead (the whole graph in memory; for
small nets).  Prints one JSON object, name -> hex digest; ``chip_smoke.py``
holds the full-size ones as constants and computes the same digest of the
port's card-built nets with ``graph_digest``.

The digest is ``experiments/graph_digest.py``'s.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from experiments.graph_digest import (FIELDS, GraphDigest,  # noqa: E402
                                      graph_digest)

SEED = 1234
DELAY_MAX = 20


def _spec(n_total: int, n_conn: int, delayed: bool):
    from repro.core.models import izhikevich_net as IZ
    from repro.core.snn.spec import ModelSpec
    from repro.sparse.formats import UniformIntDelay
    cfg = IZ.IzhikevichNetConfig(n_total=n_total, n_conn=n_conn,
                                 representation="sparse", seed=SEED)
    base = IZ.spec(cfg)
    if not delayed:
        return cfg, base
    ms = ModelSpec(f"{base.name}_delayed")
    for pop in base.populations.values():
        ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                 pop.input_fn)
    for sp in base.synapses:
        ms.add_synapse_population(
            sp.name, sp.pre, list(sp.post), sp.connect, sp.weight,
            representation="sparse",
            delay=(UniformIntDelay(0, DELAY_MAX) if sp.name == "exc"
                   else None))
    return cfg, ms


def whole_digest(n_total: int, n_conn: int, delayed: bool) -> str:
    """The digest of the JAX package's ``build(init="device")`` net."""
    cfg, ms = _spec(n_total, n_conn, delayed)
    model = ms.build(dt=cfg.dt, seed=cfg.seed, init="device")
    return graph_digest(
        (g.name, {f: (None if getattr(g.ell, f) is None
                      else np.asarray(getattr(g.ell, f))) for f in FIELDS})
        for g in model.network.synapses)


def chunked_digest(n_total: int, n_conn: int, delayed: bool,
                   chunk: int) -> str:
    """The same digest, each synapse population generated ``chunk`` rows
    at a time through ``repro.sparse.device_init`` with the spec build's
    key schedule (fold_in(PRNGKey(seed), population index)) and split."""
    import jax
    import jax.numpy as jnp
    from repro.sparse import device_init as DI
    cfg, ms = _spec(n_total, n_conn, delayed)
    base = jax.random.PRNGKey(cfg.seed)
    d = GraphDigest()
    for sidx, sp in enumerate(ms.synapses):
        n_pre = ms.populations[sp.pre].n
        sizes = [ms.populations[p].n for p in sp.post]
        key = jax.random.fold_in(base, sidx)
        for r0 in range(0, n_pre, chunk):
            rows = jnp.arange(r0, min(n_pre, r0 + chunk), dtype=jnp.int32)
            post, g, valid = DI.device_resolve(sp.connect, key, n_pre,
                                               sum(sizes), sp.weight,
                                               rows=rows)
            dd = (None if sp.delay is None else jnp.where(
                valid, DI.device_delays(key, n_pre, post.shape[1], sp.delay,
                                        rows=rows), 0).astype(jnp.int32))
            lo = 0
            for n_p, gname in zip(sizes, sp.group_names()):
                hi = lo + n_p
                if len(sp.post) == 1:
                    parts = {"post_ind": post, "g": g, "valid": valid,
                             "delay": dd}
                else:
                    mask = (post >= lo) & (post < hi) & valid
                    parts = {
                        "post_ind": jnp.where(mask, post - lo, 0).astype(
                            jnp.int32),
                        "g": jnp.where(mask, g, 0.0).astype(jnp.float32),
                        "valid": mask,
                        "delay": (None if dd is None else jnp.where(
                            mask, dd, 0).astype(jnp.int32))}
                for f in FIELDS:
                    if parts[f] is not None:
                        d.update(gname, f, np.asarray(parts[f]))
                lo = hi
    return d.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-total", type=int, default=100_000)
    ap.add_argument("--n-conn", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=5000)
    ap.add_argument("--whole", action="store_true")
    args = ap.parse_args(argv)
    out = {}
    for name, delayed in (("main", False), ("delay", True)):
        out[name] = (whole_digest(args.n_total, args.n_conn, delayed)
                     if args.whole else
                     chunked_digest(args.n_total, args.n_conn, delayed,
                                    args.chunk))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
