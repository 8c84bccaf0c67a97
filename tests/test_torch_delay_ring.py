"""The per-synapse-delay path on the CPU: the delay scatter's plain version
(float64 sums, rounded once), the dendritic ring's fold
(``kernels.ref.delay_ring_fold_ref``, the CPU side of
``kernels.delay_ring.delay_ring_fold``) against the eager sequence it
replaces, the synapse group's scratch, and a batched gScale sweep of a
delayed net against the JAX package's.  The CUDA kernels are held to these
plain versions on a card in tests/test_torch_cuda.py.

Tolerances: the fold equals the eager sequence bit for bit (sign bits of
zeros included); the scatter equals a numpy float64 sum rounded once, and
the JAX Pallas kernel (interpret mode) within rtol=atol=1e-5, the parity
contract's scatter tolerance; the sweep as tests/test_torch_slice.py
holds the port's to JAX's (finite flags equal, rates within 2 Hz, i.e.
0.2% of neuron-steps over 1 s)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.snn import neurons as JN  # noqa: E402
from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.kernels.ell_spmv import ell_spmv_delay_pallas  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.snn import neurons as TN  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn import synapses as TSYN  # noqa: E402
from repro_torch.kernels import delay_ring as DR  # noqa: E402
from repro_torch.kernels import ell_spmv as K  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

RASTER_AGREEMENT = 0.998


def _replaced(ring, acc, cursor, sign, gscale):
    """The eager sequence of the heterogeneous-delay branch before the
    fold kernel: _scale, roll, add, read the cursor's row, clear it."""
    contrib = TSYN._scale(sign, gscale,
                          acc.permute(2, 0, 1).to(torch.float32))
    new = ring + torch.roll(contrib, cursor, dims=1)
    inj = new[:, cursor].clone()
    new[:, cursor] = 0.0
    return new, inj


def _same_bits(a, b):
    assert torch.equal(a, b)
    assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("gscale_kind", ["python", "scalar", "per_member"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_fold_equals_the_sequence_it_replaces(where, sign, gscale_kind,
                                              batch):
    rng = np.random.default_rng(batch + (sign > 0))
    n_slots, n_post = 6, 37
    cursor = {"first": 0, "mid": n_slots // 2, "last": n_slots - 1}[where]
    ring = torch.tensor(rng.standard_normal((batch, n_slots, n_post)),
                        dtype=torch.float32)
    ring[:, :, :5] = 0.0            # zero rows meet +0 and -0 contributions
    acc = torch.tensor(rng.standard_normal((n_slots, n_post, batch)))
    acc[:, 3:8] = 0.0
    gscale = {"python": 1.0,
              "scalar": torch.tensor(0.7, dtype=torch.float32),
              "per_member": torch.tensor(rng.uniform(0.1, 3.0, batch),
                                         dtype=torch.float32)}[gscale_kind]
    ring_before = ring.clone()
    want_ring, want_inj = _replaced(ring, acc, cursor, sign, gscale)
    DR.reset_launches()
    # the cursors are an int32 [B] tensor (read by index ops, never on the
    # host)
    cur = torch.full((batch,), cursor, dtype=torch.int32)
    new_ring, inj, new_cur = DR.delay_ring_fold(ring, acc, cur, sign, gscale)
    assert DR.launches == {"delay_ring_fold": 0}
    assert new_cur.dtype == torch.int32 and new_cur.shape == (batch,)
    assert new_cur.tolist() == [(cursor + 1) % n_slots] * batch
    assert cur.tolist() == [cursor] * batch
    _same_bits(new_ring, want_ring)
    _same_bits(inj, want_inj)
    _same_bits(ring, ring_before)                 # the input is not written
    assert torch.equal(acc, torch.zeros_like(acc))  # the scratch is zeroed
    # a -0 contribution onto a zero row keeps +0, as the sequence does
    assert not torch.signbit(new_ring).logical_and(new_ring == 0).any()


def test_ell_spmv_delay_ref_sums_in_float64_and_rounds_once():
    rng = np.random.default_rng(9)
    n_pre, k, n_post, n_slots, b = 300, 24, 40, 5, 3
    g = rng.standard_normal((n_pre, k)).astype(np.float32)
    idx = rng.integers(0, n_post, (n_pre, k)).astype(np.int32)
    valid = rng.random((n_pre, k)) < 0.8
    dly = rng.integers(0, n_slots, (n_pre, k)).astype(np.int32)
    spk = (rng.random((b, n_pre)) < 0.5).astype(np.float32)
    want = np.zeros((n_slots, n_post, b), np.float64)
    for m in range(b):
        prod = (spk[m][:, None] * np.where(valid, g, 0.0)).astype(np.float32)
        np.add.at(want[..., m], (dly[valid], idx[valid]),
                  prod[valid].astype(np.float64))
    ts = [torch.tensor(a) for a in (g, idx, valid, dly, spk)]
    out = TR.ell_spmv_delay_ref(*ts, n_post, n_slots)
    assert out.shape == (b, n_slots, n_post) and out.is_contiguous()
    np.testing.assert_array_equal(
        out.numpy(), want.astype(np.float32).transpose(2, 0, 1))
    # bool spikes are 1.0, and the scatter into a scratch is the same sum
    assert torch.equal(K.ell_spmv_delay(*ts[:4], ts[4].bool(), n_post,
                                        n_slots), out)
    acc = torch.zeros((n_slots, n_post, b), dtype=torch.float64)
    K.ell_spmv_delay_into(*ts[:4], ts[4].bool(), acc)
    np.testing.assert_array_equal(acc.numpy(), want)
    pallas = ell_spmv_delay_pallas(*map(jnp.asarray, (g, idx, valid, dly,
                                                      spk)),
                                   n_post=n_post, n_slots=n_slots,
                                   interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)


def test_ops_delay_scatter_takes_bool_spikes_as_they_are(monkeypatch):
    rng = np.random.default_rng(2)
    g = rng.standard_normal((30, 6)).astype(np.float32)
    idx = rng.integers(0, 40, (30, 6)).astype(np.int32)
    ell = TF.triple_to_ell(idx, g, np.ones((30, 6), bool), 40,
                           delay=rng.integers(0, 3, (30, 6)).astype(np.int32))
    s = torch.tensor(rng.random((2, 30)) < 0.3)
    seen = []
    real = K.ell_spmv_delay

    def spy(*args):
        seen.append(args[4].dtype)
        return real(*args)
    monkeypatch.setattr(K, "ell_spmv_delay", spy)
    out = kops.ell_spmv_delay_batched(ell, s, 3)
    assert seen == [torch.bool]
    assert torch.equal(out, kops.ell_spmv_delay_batched(ell, s.float(), 3))


# ---------------------------------------------------------------------------
# the synapse group
# ---------------------------------------------------------------------------

N_EXC, N_INH, N_CONN, T, SEED = 160, 40, 20, 100, 7


def _delayed_spec(P, drive=False):
    """A small Izhikevich net with per-synapse delays 0..5 on the
    excitatory synapses (tests/test_torch_slice.py's delay variant), and
    with ``drive`` a numpy-made DC input per neuron."""
    F = P["formats"]
    ms = P["spec"].ModelSpec("delayed")
    ms.add_neuron_population("exc", N_EXC, P["neurons"].IZHIKEVICH)
    ms.add_neuron_population("inh", N_INH, P["neurons"].IZHIKEVICH)
    ms.add_synapse_population("exc", "exc", ["exc", "inh"],
                              connect=F.FixedFanout(N_CONN),
                              weight=F.UniformWeight(0.0, 0.5),
                              delay=F.UniformIntDelay(0, 5))
    ms.add_synapse_population("inh", "inh", ["exc", "inh"],
                              connect=F.FixedFanout(N_CONN),
                              weight=F.UniformWeight(0.0, -1.0))
    if drive:
        rng = np.random.default_rng(1)
        for name, n, hi in (("exc", N_EXC, 12.0), ("inh", N_INH, 6.0)):
            d = rng.uniform(0.0, hi, n).astype(np.float32)
            ms.populations[name].input_fn = (
                (lambda key, t, n, d=d: jnp.asarray(d)) if P is JAXPKG else
                (lambda key, t, n, d=d: torch.tensor(d, device=key.device)))
    return ms


JAXPKG = dict(spec=JSPEC, neurons=JN, formats=JF)
PORT = dict(spec=TSPEC, neurons=TN, formats=TF)


def _export(jm):
    pops = {n: {"params": {k: np.asarray(v) for k, v in p.params.items()},
                "state": {k: np.full(p.n, v, np.float32)
                          for k, v in p.model.state.items()}}
            for n, p in jm.network.populations.items()}
    syn = {g.name: {"g": np.asarray(g.ell.g),
                    "post_ind": np.asarray(g.ell.post_ind),
                    "valid": np.asarray(g.ell.valid),
                    "delay": (None if g.ell.delay is None
                              else np.asarray(g.ell.delay)),
                    "dense": None if g.dense is None else np.asarray(g.dense),
                    "sign": g.sign, "representation": g.representation,
                    "delay_steps": g.delay_steps, "max_delay": g.max_delay}
           for g in jm.network.synapses}
    return {"populations": pops, "synapses": syn}


def _port_model(drive=False):
    return _delayed_spec(PORT, drive).build(dt=1.0, seed=SEED, device="cpu")


def test_step_leaves_its_input_ring_untouched():
    tm = _port_model()
    g = tm.network.synapses[0]
    assert g.ell.delay is not None and g.ring_slots == 6
    st = g.init_state(2)
    st.dendritic.copy_(torch.tensor(
        np.random.default_rng(3).standard_normal(st.dendritic.shape),
        dtype=torch.float32))
    before = st.dendritic.clone()
    spikes = torch.tensor(np.random.default_rng(4).random((2, N_EXC)) < 0.3)
    new, cur = g.step(st, spikes, torch.tensor([1.0, 2.0]), 1.0)
    assert torch.equal(st.dendritic, before) and st.cursor.tolist() == [0, 0]
    assert new.dendritic is not st.dendritic
    assert new.cursor.tolist() == [1, 1]
    assert new.cursor.dtype == torch.int32 and new.cursor.shape == (2,)
    # the scratch is zero again, ready for the next step
    acc = g._acc
    assert acc.dtype == torch.float64 and acc.shape == (6, N_EXC, 2)
    assert not acc.any()
    # a step that fails after the scatter (a gscale of the wrong batch)
    # drops its scratch
    with pytest.raises(RuntimeError):
        g.step(st, spikes, torch.ones(3), 1.0)
    assert g._acc is None
    again, cur2 = g.step(st, spikes, torch.tensor([1.0, 2.0]), 1.0)
    assert torch.equal(again.dendritic, new.dendritic)
    assert torch.equal(cur2, cur)
    # another batch size replaces the scratch: the group keeps one
    g.step(g.init_state(3), torch.zeros((3, N_EXC), dtype=torch.bool),
           1.0, 1.0)
    assert g._acc.shape == (6, N_EXC, 3) and g._acc is not acc


def test_batched_delay_sweep_matches_jax():
    jspec, tspec = _delayed_spec(JAXPKG, True), _delayed_spec(PORT, True)
    jm = jspec.build(dt=1.0, seed=SEED)
    tm = convert.load_arrays(tspec.build(dt=1.0, seed=SEED, device="cpu"),
                             _export(jm))
    values = [0.5, 1.0, 2.0, 4.0]
    js = jm.sweep_gscale("exc", values, T)
    ts = tm.sweep_gscale("exc", values, T)
    np.testing.assert_array_equal(ts.finite.numpy(), np.asarray(js.finite))
    for pop in ("exc", "inh"):
        np.testing.assert_allclose(ts.rates_hz[pop].numpy(),
                                   np.asarray(js.rates_hz[pop]),
                                   atol=(1.0 - RASTER_AGREEMENT) * 1e3)
    assert float(ts.rates_hz["exc"].sum()) > 0
    # each member of the batch (a [B] gscale into the fold) is the single
    # run at its value (a scalar gscale)
    for i, v in enumerate(values):
        r = tm.run(T, gscales={"exc": v})
        assert torch.equal(r.spike_counts["exc"], ts.spike_counts["exc"][i])


# ---------------------------------------------------------------------------
# the fold's launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8, 65536])
def test_fold_plan_fits_the_card(batch):
    """A thread takes 4 posts of a ring row for one member: 20,000 x B
    threads a row, in CTAs of the model's block (off the card, without
    registers, the smallest compiled block: every candidate is bound by
    its threads alike)."""
    plan = DR.launch_plan(batch, 21, 80_000)
    gx = plan["grid"][0]
    block = plan["block"]
    assert {k: plan[k] for k in ("grid", "block", "vec")} == {
        "grid": (gx, 21, 1), "block": block, "vec": 4}
    assert block == 128
    assert gx * block >= 20_000 * batch > (gx - 1) * block
    assert gx == {1: 157, 8: 1250, 65536: 10_240_000}[batch]


@pytest.mark.parametrize("n_post,aligned,vec", [(80_000, True, 4),
                                                (20_000, True, 4),
                                                (37, True, 1),
                                                (80_000, False, 1)])
def test_fold_vector_width(n_post, aligned, vec):
    plan = DR.launch_plan(2, 6, n_post, aligned)
    assert plan["vec"] == vec
    assert plan["grid"][0] == -(-(n_post // vec * 2) // plan["block"])


def test_fold_plan_raises_past_the_grid():
    """Grid axis x takes 2^31 - 1 CTAs: past 2^39 items the model moves to
    the larger blocks the fold is compiled for, and past 1024 x (2^31 - 1)
    items nothing launches."""
    DR.launch_plan(65535, 65535, 8)
    DR.launch_plan(2 ** 10, 2, 2 ** 31 - 4)           # 2^39 items
    assert DR.launch_plan(2 ** 12, 2, 2 ** 31 - 4)["block"] == 1024
    with pytest.raises(ValueError, match="axis x"):
        DR.launch_plan(2 ** 13, 2, 2 ** 31 - 4)
    with pytest.raises(ValueError, match="axis y"):
        DR.launch_plan(1, 65536, 8)
    with pytest.raises(ValueError, match="int32"):
        DR.launch_plan(1, 2, 2 ** 31)
    with pytest.raises(ValueError, match="one slot"):
        DR.launch_plan(1, 0, 8)
