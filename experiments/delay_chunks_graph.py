"""The delayed gScale sweep replayed from CUDA graphs, its batch scattered
and folded in one launch a group (the port's way) or two members a launch.

    python3 experiments/delay_chunks_graph.py [--rounds N] [--repeats M]

chip_smoke.py's phase 5b: phase 4's grid of 8 gScales on phase 5's net
(100k neurons x 1000 synapses, per-synapse delays 0..20 steps on the
excitatory groups) as one batch of 500 steps, through ``sweep_gscale``
(the graph route).  With two members a launch, each delayed group scatters
into four [21, n_post, 2] float64 scratches (26.9 MB for exc->exc, inside
the 50 MB L2, where the batch's one scratch is 107.5 MB) and folds each
into its members' rows of one new ring: 8 launches a group and step where
the port runs 2.  Under a graph the launches cost no host time, so this
measures what PR 18 could not (the host paid for the launches there).

The variants alternate (one launch, chunks, chunks, one launch, ...) for N
rounds (default 2), each captured anew; a variant's turn prints M (default
3) timed sweeps (host clock around a synchronised sweep) and one line from
a torch.profiler trace of 50 replayed steps (device us, device ops and
wall us a step, the busy share).  Both variants must give the same spike
counts.  Needs one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MEMBERS = 2                   # members a launch in the chunked variant


def _chunked_fold(torch):
    """A ``SynapseGroup._delay_fold`` that scatters and folds MEMBERS
    members a launch, into slices of one new ring (the fold kernel called
    through its C interface with pointers into the slices)."""
    from repro_torch.kernels import delay_ring as DR
    from repro_torch.kernels import ell_spmv as K
    from repro_torch.kernels._dispatch import launch, raise_on

    def fold(self, ring, cursor, spikes, gscale, g, syn, externals,
             ell=None):
        batch, n_slots, n_post = ring.shape
        if not (isinstance(gscale, torch.Tensor) and gscale.dim() == 1
                and batch % MEMBERS == 0):
            raise ValueError("the chunked fold takes a [B] gscale, B even")
        chunks = getattr(self, "_chunk_acc", None)
        if chunks is None or chunks[0].device != ring.device:
            chunks = self._chunk_acc = [
                torch.zeros((n_slots, n_post, MEMBERS), dtype=torch.float64,
                            device=ring.device)
                for _ in range(batch // MEMBERS)]
        ell = self._effective_ell(g, syn, externals,
                                  self.ell if ell is None else ell)
        new_ring = torch.empty_like(ring)
        inj = torch.empty((batch, n_post), dtype=torch.float32,
                          device=ring.device)
        new_cursor = torch.empty((), dtype=torch.int32, device=ring.device)
        plan = DR.launch_plan(MEMBERS, n_slots, n_post, True)
        for i, acc in enumerate(chunks):
            b = slice(i * MEMBERS, (i + 1) * MEMBERS)
            K.ell_spmv_delay_into(ell.g, ell.post_ind, ell.valid, ell.delay,
                                  spikes[b], acc)
            rc = launch(ring.device, DR._lib().delay_ring_fold_f32,
                        ring[b].data_ptr(), acc.data_ptr(),
                        new_ring[b].data_ptr(), inj[b].data_ptr(),
                        gscale[b].data_ptr(), 0.0, float(self.sign),
                        MEMBERS, n_slots, n_post, cursor.data_ptr(),
                        new_cursor.data_ptr(), plan["vec"], plan["block"])
            DR.launches["delay_ring_fold"] += 1
            raise_on(rc, DR._lib().ell_spmv_error_string, "delay_ring_fold")
        return new_ring, inj, new_cursor
    return fold


def main(argv) -> int:
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--rounds", "--repeats"}:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("delay_chunks_graph: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.core.snn import synapses as S
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    model, build_s = C.build_delay_model(torch)
    values, steps = list(C.SWEEP["values"]), C.DELAY["sweep_steps"]
    n_prof = C.DELAY["profile_steps"]
    print(json.dumps({"card": card, "build_s": build_s, "values": values,
                      "steps": steps, "members_a_launch": MEMBERS}),
          flush=True)
    variants = {"one_launch": S.SynapseGroup._delay_fold,
                "chunks": _chunked_fold(torch)}
    order = ["one_launch", "chunks", "chunks", "one_launch"] * int(
        opts.get("--rounds", 2))
    counts = {}
    names = model._expand_group("exc")
    gscales = {n: torch.tensor(values, device="cuda") for n in names}
    sim = model.simulator
    for turn, name in enumerate(order):
        S.SynapseGroup._delay_fold = variants[name]
        sim._compiled.clear()              # capture this variant anew
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sweep_gscale("exc", values, steps)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for r in range(int(opts.get("--repeats", 3))):
            C.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = model.sweep_gscale("exc", values, steps)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts.setdefault(name, s.spike_counts)
            print(json.dumps({
                "turn": turn, "variant": name, "repeat": r,
                "seconds": secs, "us_per_step": secs / steps * 1e6,
                "candidates_per_s": len(values) / secs,
                "first_run_s": first_s,
                "launches": C.read_launches()}), flush=True)
        state = model.init_state(len(values))

        def run():
            sim.run_compiled(state, n_prof, gscales)
            torch.cuda.synchronize()

        prof = C._device_profile(torch, run, warm=True)
        print(json.dumps({
            "turn": turn, "variant": name, "profile_steps": n_prof,
            "device_us_per_step": prof["device_busy_us"] / n_prof,
            "device_ops_per_step": prof["device_ops"] / n_prof,
            "wall_us_per_step": prof["wall_us"] / n_prof,
            "busy_share": prof["busy_share"],
            "top": prof["top"][:6]}), flush=True)
    same = all(torch.equal(counts["one_launch"][k], counts["chunks"][k])
               for k in counts["one_launch"])
    print(json.dumps({"same_spike_counts": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
