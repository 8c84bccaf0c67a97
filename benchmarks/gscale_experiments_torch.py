"""Conductance-scaling experiments (paper §5.1, Tables 1-2, Figs 2-3) on
the PyTorch/CUDA port: ``benchmarks/gscale_experiments.py``'s steps, on
``repro_torch``.

  1. run the reference configuration, record its population rate;
  2. for each nConn, search gScale so the rate returns to the reference
     band, under the Fig-1 NaN guard (a batched candidate sweep through
     ``CompiledModel.sweep_gscale``, replayed from CUDA graphs on the card,
     then a refinement);
  3. fit gScale = k1/(k2+nConn)+k3 by the paper's linearized regression.

The signatures, defaults and steps are the JAX package's, plus ``device``
(the card unless asked otherwise).  Each result also carries what the run
cost: every build's ``host_init`` seconds (the trace spans of
``repro_torch.obs.trace``) and each nConn's candidates a second.  The
reference configuration is built once and reused where a searched nConn
equals it (the same config and seed build the same network).

``mushroom_gscale_sweep(fan_in_from=...)`` scales the conductances whose
fan-in grows with the net (LHI->KC, KC->DN, DN->DN) by the given sizes'
fan-in over this one's, so that a net far larger than the example's stays
finite (the swept PN groups are left alone: their nPN dependence is what
the fit measures); None keeps the JAX package's conductances.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import conductance as C
from repro_torch.core.models import izhikevich_net, mushroom_body
from repro_torch.obs import trace

__all__ = ["izhikevich_gscale_sweep", "mushroom_gscale_sweep"]


def _rate_fn(model, names, n_steps, pop, state=None, timing=None):
    """Candidate-batched (rates, finite) via CompiledModel.sweep_gscale;
    ``timing`` (a list) collects (candidates, seconds) of each call."""
    if state is None:
        state = model.init_state()

    def fn(grid):
        t0 = time.perf_counter()
        sw = model.sweep_gscale(names, grid, n_steps, state=state)
        rates, finite = sw.rates_hz[pop].cpu(), sw.finite.cpu()
        if timing is not None:
            timing.append((int(rates.numel()), time.perf_counter() - t0))
        return rates, finite

    return fn


def _build(compile_model, cfg, device):
    """Build ``cfg``; returns (model, seconds in its host_init spans)."""
    mark = len(trace.events())
    model = compile_model(cfg, device=device)
    host = sum(e["dur"] for e in trace.events()[mark:]
               if e["name"] == "host_init") / 1e6
    return model, host


def _per_second(timing) -> float:
    n = sum(c for c, _ in timing)
    s = sum(t for _, t in timing)
    return n / s if s > 0 else float("nan")


def izhikevich_gscale_sweep(
    n_total: int = 400, n_conns: Tuple[int, ...] = (40, 60, 80, 120, 160,
                                                    240, 320, 400),
    n_steps: int = 350, representation: str = "auto", seed: int = 12,
    candidates: int = 20, device=None,
) -> Dict:
    """gScale(nConn) for the Izhikevich cortical net (reduced grid)."""
    # reference: the fully-connected-equivalent config at gScale = 1
    ref_cfg = izhikevich_net.IzhikevichNetConfig(
        n_total=n_total, n_conn=n_conns[-1], seed=seed,
        representation=representation)
    model, ref_host = _build(izhikevich_net.compile_model, ref_cfg, device)
    names = model.group_names
    rate_fn = _rate_fn(model, names, n_steps, "exc")
    r, f = rate_fn(torch.ones((1,), dtype=torch.float32))
    target = float(r[0])

    gscales, rates, finite, host_s, per_s = [], [], [], [], []
    for n_conn in n_conns:
        cfg = dataclasses.replace(ref_cfg, n_conn=n_conn)
        if cfg == ref_cfg:
            model_i, host = model, ref_host
        else:
            model_i, host = _build(izhikevich_net.compile_model, cfg,
                                   device)
        timing = []
        fn = _rate_fn(model_i, model_i.group_names, n_steps, "exc",
                      timing=timing)
        # coarse log-grid sweep (one batched run), then local refine
        grid = torch.logspace(-1.0, 1.8, candidates)
        res = C.search_sweep(fn, grid, target)
        lo = max(res.gscale / 1.8, float(grid[0]))
        hi = min(res.gscale * 1.8, float(grid[-1]))
        fine = torch.linspace(lo, hi, candidates)
        res = C.search_sweep(fn, fine, target)
        gscales.append(res.gscale)
        rates.append(res.rate_hz)
        finite.append(res.finite)
        host_s.append(host)
        per_s.append(_per_second(timing))
        del model_i

    k1, k2, k3, err = C.fit_hyperbola(np.asarray(n_conns, float),
                                      np.asarray(gscales, float))
    return {
        "n_conns": list(n_conns), "gscales": gscales, "rates": rates,
        "target_rate": target, "k1": k1, "k2": k2, "k3": k3,
        "mape_pct": err, "representation": representation,
        "finite": finite, "host_init_s": host_s,
        "ref_host_init_s": ref_host, "candidates_per_s": per_s,
    }


def _fan_in_config(cfg, fan_in_from: Optional[Mapping[str, int]]):
    """``cfg`` with LHI->KC, KC->DN and DN->DN scaled by the fan-in of the
    sizes ``fan_in_from`` (n_lhi, n_kc, n_dn) over ``cfg``'s."""
    if fan_in_from is None:
        return cfg
    return dataclasses.replace(
        cfg, g_lhi_kc=cfg.g_lhi_kc * fan_in_from["n_lhi"] / cfg.n_lhi,
        g_kc_dn=cfg.g_kc_dn * fan_in_from["n_kc"] / cfg.n_kc,
        g_dn_dn=cfg.g_dn_dn * fan_in_from["n_dn"] / cfg.n_dn)


def mushroom_gscale_sweep(
    n_pns: Tuple[int, ...] = (8, 12, 20, 32),
    n_lhi: int = 5, n_kc: int = 100, n_dn: int = 10,
    n_steps: int = 700, seed: int = 9, candidates: int = 12, device=None,
    fan_in_from: Optional[Mapping[str, int]] = None,
) -> Dict:
    """gScale(nPN) for the mushroom-body PN->KC synapse (reduced)."""
    ref = _fan_in_config(mushroom_body.MushroomBodyConfig(
        n_pn=n_pns[-1], n_lhi=n_lhi, n_kc=n_kc, n_dn=n_dn, seed=seed),
        fan_in_from)
    model, ref_host = _build(mushroom_body.compile_model, ref, device)
    fn = _rate_fn(model, ["PN_KC"], n_steps, "KC")
    r, _ = fn(torch.ones((1,), dtype=torch.float32))
    target = float(r[0])
    fn_lhi = _rate_fn(model, ["PN_LHI"], n_steps, "LHI")
    r_lhi, _ = fn_lhi(torch.ones((1,), dtype=torch.float32))
    target_lhi = float(r_lhi[0])

    gscales, rates, finite, host_s, per_s = [], [], [], [], []
    gscales_lhi, finite_lhi = [], []
    for n_pn in n_pns:
        cfg = dataclasses.replace(ref, n_pn=n_pn)
        if cfg == ref:
            model_i, host = model, ref_host
        else:
            model_i, host = _build(mushroom_body.compile_model, cfg, device)
        timing = []
        fn_i = _rate_fn(model_i, ["PN_KC"], n_steps, "KC", timing=timing)
        grid = torch.logspace(-0.7, 1.6, candidates)
        res = C.search_sweep(fn_i, grid, target)
        fine = torch.linspace(max(res.gscale / 2, 1e-2), res.gscale * 2,
                              candidates)
        res = C.search_sweep(fn_i, fine, target)
        gscales.append(res.gscale)
        rates.append(res.rate_hz)
        finite.append(res.finite)
        # PN->LHI (the paper's second fitted synapse; its Table-2 fit is
        # the poor one, MAPE 71.4%)
        fn_l = _rate_fn(model_i, ["PN_LHI"], n_steps, "LHI", timing=timing)
        res_l = C.search_sweep(fn_l, grid, target_lhi)
        fine_l = torch.linspace(max(res_l.gscale / 2, 1e-2),
                                res_l.gscale * 2, candidates)
        res_l = C.search_sweep(fn_l, fine_l, target_lhi)
        gscales_lhi.append(res_l.gscale)
        finite_lhi.append(res_l.finite)
        host_s.append(host)
        per_s.append(_per_second(timing))
        del model_i

    k1, k2, k3, err = C.fit_hyperbola(np.asarray(n_pns, float),
                                      np.asarray(gscales, float))
    kl1, kl2, kl3, errl = C.fit_hyperbola(np.asarray(n_pns, float),
                                          np.asarray(gscales_lhi, float))
    return {
        "n_pns": list(n_pns), "gscales": gscales, "rates": rates,
        "target_rate": target, "k1": k1, "k2": k2, "k3": k3,
        "mape_pct": err, "n_lhi": n_lhi,
        "gscales_lhi": gscales_lhi, "k1_lhi": kl1, "k2_lhi": kl2,
        "k3_lhi": kl3, "mape_lhi_pct": errl,
        "finite": finite, "finite_lhi": finite_lhi, "host_init_s": host_s,
        "ref_host_init_s": ref_host, "candidates_per_s": per_s,
        "fan_in_from": None if fan_in_from is None else dict(fan_in_from),
    }
