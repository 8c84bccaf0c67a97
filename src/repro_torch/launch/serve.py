"""Token server: batched prefill + decode loop with continuous batching,
the counterpart of ``repro/launch/serve.py``.

It serves every family through ``models/transformer.py``'s ``prefill``
and ``decode_step``: dense, moe (each decode step routes the wave's
tokens as one MoE group, pad and finished slots included, as the JAX
package does), ssm (float32 conv and SSD states a request), hybrid,
encdec (whisper: the prefill gets zero audio frames [b, enc_seq,
d_model] float32, as the JAX server feeds it, and fills each decoder
layer's cross cache from the encoder's output once a wave) and vlm
(paligemma: a zero image [b, img_tokens, img_embed_dim] float32 before
each left-padded prompt, as the JAX server feeds it).
Requests (prompt token lists) enter a queue; the slot scheduler
(``launch/scheduling.py``) packs up to ``max_batch`` of them into a wave
when no request is active; the wave's prompts are left-padded with token 0
(the pad is attended to, and positions run from 0 over the padded prompt,
as in the JAX server) and prefilled together, with the KV caches allocated
to ``max_seq``; decode steps then run the wave through ``decode_step``
until every request has ``max_new`` tokens.  Sampling (greedy, or
temperature with a numpy generator seeded with ``seed``) happens on the
host.

Model parallelism (``model_parallel``): with a process group up
(``launch.mesh.init_distributed``, or ``torchrun``) the server builds
``make_local_mesh(model_parallel)`` and places its params by
``param_specs`` (DTensors); every rank runs the same requests.  A wave's
prompts are split over the batch axes when they divide it; prefill and
decode run under ``activate`` on the compute view of the params (made
once), the logits are joined on every rank and every rank samples the
same token, so their generators stay in step.  Between steps the caches
are kept in ``cache_shardings``' layout (DTensors); a decode step attends
over each rank's block of a split k/v sequence and joins only the conv
history's channels (``d_conv - 1`` rows a request).  Without a group the
server runs on one device, as before.

``waves`` records each wave's size, padded prompt length, prefill seconds
(up to the first tokens on the host), decode steps and decode seconds.

  python -m repro_torch.launch.serve --arch qwen2-0.5b --full
  python -m repro_torch.launch.serve --arch qwen2-0.5b --device cpu
  python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu
  python -m repro_torch.launch.serve --arch whisper-tiny --full
  python -m repro_torch.launch.serve --arch paligemma-3b --device cpu
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch qwen2-0.5b --device cpu --model-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.launch import mesh as MESH
from repro_torch.launch import sharding as SH
from repro_torch.launch.scheduling import SlotScheduler
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["Server", "Request", "main"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class _CacheLayout:
    """A wave's caches between steps: each leaf that ``cache_shardings``
    splits is a DTensor in that layout, the others plain tensors.  A
    decode step computes in that same layout (``attention_decode`` attends
    over a rank's block of a split sequence), but for the conv history's
    channels, which it takes whole: ``load`` joins those and ``store``
    takes their blocks back.  Prefill writes each k/v sequence whole
    (``fill_cache``): ``store(caches, joined=True)`` splits it."""

    def __init__(self, cfg, mesh, batch: int, max_seq: int, dtype):
        self.mesh = mesh
        like = T.init_caches(cfg, batch, max_seq, dtype, device="meta")
        self.plans = self._plan(like, SH.cache_shardings(like, mesh))

    def _plan(self, like, specs, name=""):
        """Per leaf: None (kept as it is), or (the step's placements,
        prefill's placements, stored placements, whole shape, whole
        stride)."""
        if isinstance(like, dict):
            return {k: self._plan(like[k], specs[k], k) for k in like}
        if isinstance(like, list):
            return [self._plan(a, b, name) for a, b in zip(like, specs)]
        if not isinstance(like, torch.Tensor) or not any(specs):
            return None

        def whole(dim):
            comp = list(specs)
            if dim is not None:
                comp[len(comp) + dim] = None
            return SH.NamedSharding(self.mesh, tuple(comp)).placements
        return (whole(-1 if name == "conv" else None),
                whole({"k": -3, "v": -3, "conv": -1}.get(name)),
                SH.NamedSharding(self.mesh, specs).placements,
                like.shape, like.stride())

    def _walk(self, fn, tree, plans):
        if isinstance(tree, dict):
            return {k: self._walk(fn, tree[k], plans[k]) for k in tree}
        if isinstance(tree, list):
            return [self._walk(fn, a, b) for a, b in zip(tree, plans)]
        return tree if plans is None else fn(tree, *plans)

    def store(self, caches, joined: bool = False):
        """Caches in a decode step's layout (``joined``: prefill's, each
        k/v sequence whole) -> the stored layout."""
        from torch.distributed.tensor import DTensor
        dm = self.mesh.device_mesh

        def fn(x, step, pre, stored, shape, stride):
            comp = pre if joined else step
            t = DTensor.from_local(x, dm, comp, run_check=False,
                                   shape=shape, stride=stride)
            return t if comp == stored else t.redistribute(dm, stored)
        return self._walk(fn, caches, self.plans)

    def load(self, caches, joined: bool = False):
        """Stored caches -> a decode step's layout (``joined``: prefill's),
        as plain local tensors."""
        dm = self.mesh.device_mesh

        def fn(x, step, pre, stored, shape, stride):
            comp = pre if joined else step
            return (x if comp == stored else x.redistribute(dm, comp)
                    ).to_local()
        return self._walk(fn, caches, self.plans)


class Server:
    def __init__(self, arch: str, use_reduced: bool = True,
                 max_batch: int = 4, max_seq: int = 512, seed: int = 0,
                 device: DeviceLike = None, model_parallel: int = 1):
        self.cfg = make_reduced(get_config(arch)) if use_reduced \
            else get_config(arch)
        self.device = resolve_device(device)
        self.mesh = None
        if dist.is_available() and dist.is_initialized():
            self.mesh = MESH.make_local_mesh(model_parallel, self.device)
            self.device = self.mesh.device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self._rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = T.init_params(self.cfg, gen)
        self._view = self.params
        if self.mesh is not None:
            self.params = SH.place_params(self.params, self.mesh)
            with SH.activate(self.mesh), torch.no_grad():
                self._view = T.compute_view(self.params, self.cfg)
        self._layout = None
        self.sched = SlotScheduler(max_batch)
        self.finished: List[Request] = []
        self.waves: List[dict] = []
        self._admit_caches = None

    # -- queue --------------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self.sched.queue

    @property
    def active(self) -> Dict[int, Request]:
        return self.sched.active

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    # -- internals ------------------------------------------------------------
    def _extra(self, b: int) -> dict:
        """The prefill's extra inputs for a wave of ``b``: zero audio
        frames for an encdec model, a zero image for a vlm model."""
        spec = T.extra_input(self.cfg)
        if spec is None:
            return {}
        name, row = spec
        return {name: torch.zeros((b,) + row, dtype=torch.float32,
                                  device=self.device)}

    def _admit(self) -> None:
        """Prefill queued requests into free slots (one wave per admit)."""
        assigned = self.sched.admit()
        if not assigned:
            return
        t0 = time.perf_counter()
        reqs = [r for _, r in assigned]
        maxlen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), maxlen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, maxlen - len(r.prompt):] = r.prompt          # left-pad
        toks_t = torch.from_numpy(toks).to(self.device)
        if self.mesh is None:
            logits, caches = T.prefill(self.params, self.cfg, toks_t,
                                       self._extra(len(reqs)),
                                       max_seq=self.max_seq)
        else:
            split = len(reqs) % self.mesh.size("batch") == 0
            extra = {k: SH.local_rows(v, self.mesh, split)
                     for k, v in self._extra(len(reqs)).items()}
            with SH.activate(self.mesh, batch_sharded=split), \
                    torch.no_grad():
                logits, caches = T.prefill(
                    self._view, self.cfg, SH.local_rows(toks_t, self.mesh,
                                                     split),
                    extra, max_seq=self.max_seq)
                if split:
                    logits = L.batch_gather(logits, 0)
            # the whole wave's caches (prefill's: bfloat16 attention)
            self._layout = _CacheLayout(
                self.cfg, self.mesh, len(reqs),
                max(self.max_seq, caches["index"]), torch.bfloat16)
            self._split = split
            caches = self._layout.store(caches, joined=True)
        logits_np = logits.float().cpu().numpy()
        for i, r in enumerate(reqs):
            r.out.append(self._sample(logits_np[i], r))
        self._admit_caches = caches
        now = time.perf_counter()
        self.waves.append({"size": len(reqs), "prompt_len": maxlen,
                           "prefill_s": now - t0, "first_token_at": now,
                           "decode_steps": 0, "decode_s": 0.0})

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature <= 0:
            return int(np.argmax(logits))
        z = logits / req.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    # -- main loop ------------------------------------------------------------
    def step(self) -> bool:
        """One decode step over the admitted wave; returns True while work
        remains."""
        if not self.active:
            self._admit()
            if not self.active:
                return False
        t0 = time.perf_counter()
        reqs = [self.active[s] for s in sorted(self.active)]
        last = torch.tensor([r.out[-1] if r.out else r.prompt[-1]
                             for r in reqs], dtype=torch.int64,
                            device=self.device)
        if self.mesh is None:
            logits, self._admit_caches = T.decode_step(
                self.params, self.cfg, self._admit_caches, last)
        else:
            with SH.activate(self.mesh, batch_sharded=self._split), \
                    torch.no_grad():
                local = self._layout.load(self._admit_caches)
                logits, local = T.decode_step(
                    self._view, self.cfg, local,
                    SH.local_rows(last, self.mesh, self._split))
                if self._split:
                    logits = L.batch_gather(logits, 0)
                self._admit_caches = self._layout.store(local)
        logits_np = logits.float().cpu().numpy()
        for i, (s, r) in enumerate(sorted(self.active.items())):
            r.out.append(self._sample(logits_np[i], r))
            if len(r.out) >= r.max_new:
                r.done = True
        wave = self.waves[-1]
        wave["decode_steps"] += 1
        wave["decode_s"] += time.perf_counter() - t0
        for s in [s for s, r in self.active.items() if r.done]:
            self.finished.append(self.sched.release(s))
        if not self.active:
            self._admit_caches = None
            return bool(self.queue)
        return True

    def run(self) -> List[Request]:
        while self.step():
            pass
        return list(self.finished)

    def pop_finished(self) -> List[Request]:
        """Collect finished requests, pruning their accounting records so
        a long-lived server stays bounded (and their rids reusable)."""
        done, self.finished = self.finished, []
        for r in done:
            self.sched.forget(r.rid)
        return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="the arch at its published widths (default: the "
                         "reduced config)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a card)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's model axis, under a launcher "
                         "(torchrun) that starts a process group")
    args = ap.parse_args(argv)

    started = MESH.join_launcher(args.device)
    try:
        _serve(args)
    finally:
        if started:
            MESH.shutdown_distributed()


def _serve(args):
    srv = Server(args.arch, use_reduced=not args.full,
                 max_batch=args.max_batch, device=args.device,
                 model_parallel=args.model_parallel)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(3, srv.cfg.vocab,
                              size=rng.integers(4, 12)).tolist()
        r = Request(rid=i, prompt=prompt, max_new=args.max_new,
                    temperature=args.temperature)
        reqs.append(r)
        srv.submit(r)
    t0 = time.time()
    srv.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"[serve] {args.arch} on {srv.device}: {args.requests} requests, "
          f"{total_tokens} tokens in {dt:.2f}s ({total_tokens/dt:.1f} tok/s)")
    print(f"[serve] latency: {srv.sched.latency_summary()}")
    for r in reqs[:4]:
        print(f"  req{r.rid}: prompt[:6]={r.prompt[:6]} -> out[:8]={r.out[:8]}")


if __name__ == "__main__":
    main()
