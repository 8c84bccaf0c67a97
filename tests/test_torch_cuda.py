"""repro_torch's CUDA kernels against their plain PyTorch versions, on a
card.  Marked ``gpu``: they skip where there is none (a CUDA kernel has no
CPU mode).  This file imports no jax, so it runs on a machine with only
PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: rtol=atol=1e-5 for the spmv kernels (atomics sum in another
order than index_add_), exact with integer-valued weights, and exact for
``ell_spmv`` and ``ell_spmv_delay`` (kernel and plain version sum in
float64); the dendritic ring's fold bit-equal to its plain version (sign
bits of zeros included); rtol=atol=2e-4
for the neuron updates, whose spike decisions may differ on under 0.2% of
neurons (the parity contract of tests/test_kernels.py); flash attention
within rtol=atol=2e-5 of its plain version in float32 (the sums run in
another order) and within 1e-2 in bfloat16, against the plain version on
the same bf16 inputs upcast to float32 (the kernel's output is rounded to
bf16).  The flash-attention backward: in float32 within rtol=5e-4,
atol=5e-5 of autograd through the plain attention (tests/test_kernels.py's
gradient tolerance); in bfloat16 within rtol=1e-2 plus 1e-2 of each
gradient's largest entry of the plain backward on the same saved bf16
tensors (each gradient is rounded to bf16 once: 2^-8 relative).  The SSD
scan within rtol=atol=2e-4 of ``ssd_chunked`` (tests/test_kernels.py's
tolerance), with TF32 off.  The threefry kernels: keys, bits and uniforms
bit-equal to their plain version, normals within 4 float32 ulp (log1pf's
last bits).  The compiled step loop: a run replayed from CUDA graphs equals
the eager run bit for bit (rasters, counts, every state tensor), with
probes, scheduled custom updates and the health monitor too (recordings,
counts, health report).  The spike bitmask: words bit-equal to the plain
version, the ring variant's device slot and active flag included, also
replayed from a CUDA graph.  The occupancy model
(``kernels.autotune``): its resident CTAs an SM equal
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for every kernel at every
block it is compiled for, every limit it models equals the card's, and
every kernel whose block it chooses gives, at each compiled block, the
result it gives at the chosen one (bit for bit) and its plain version's
(bit for bit)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from repro_torch import random as R  # noqa: E402
from repro_torch.core.models import izhikevich_net as TIZ  # noqa: E402
from repro_torch.core.models import mushroom_body as TMB  # noqa: E402
from repro_torch.core.snn import graphs as GR  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.core.snn import synapses as TSYN  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import delay_ring as DR  # noqa: E402
from repro_torch.kernels import ell_spmv as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import hh_step as HH  # noqa: E402
from repro_torch.kernels import izhikevich_step as IZ  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import spike_bitmask as SBK  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels import threefry as TFK  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NEURON_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("spike_dtype", [torch.float32, torch.bool],
                         ids=["float", "bool"])
@pytest.mark.parametrize("b,p", [(1, 0.01), (4, 1.0), (8, 0.01)])
def test_cuda_kernels_match_plain(cuda_device, b, p, spike_dtype):
    rng = np.random.default_rng(0)
    n_pre, k, n_post, n_slots = 2000, 100, 3000, 7
    g = torch.tensor(0.5 * rng.random((n_pre, k)), dtype=torch.float32,
                     device=cuda_device)
    idx = torch.tensor(rng.integers(0, n_post, (n_pre, k)),
                       dtype=torch.int32, device=cuda_device)
    valid = torch.tensor(rng.random((n_pre, k)) < 0.8, device=cuda_device)
    dly = torch.tensor(rng.integers(0, n_slots, (n_pre, k)),
                       dtype=torch.int32, device=cuda_device)
    spk = torch.tensor(rng.random((b, n_pre)) < p, dtype=torch.float32,
                       device=cuda_device)
    s_in = spk.to(spike_dtype)
    K.reset_launches()
    out = K.ell_spmv(g, idx, valid, s_in, n_post)
    out_d = K.ell_spmv_delay(g, idx, valid, dly, spk, n_post, n_slots)
    torch.cuda.synchronize()
    assert K.launches == {"ell_spmv": 1, "ell_spmv_delay": 1}
    torch.testing.assert_close(out, TR.ell_spmv_ref(g, idx, valid, spk,
                                                    n_post), **TOL)
    torch.testing.assert_close(
        out_d, TR.ell_spmv_delay_ref(g, idx, valid, dly, spk, n_post,
                                     n_slots), **TOL)
    gi = torch.floor(8 * g)
    assert torch.equal(K.ell_spmv(gi, idx, valid, s_in, n_post),
                       TR.ell_spmv_ref(gi, idx, valid, spk, n_post))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["valid_not_first", "per_member_g",
                                  "silent", "k_not_multiple_of_4",
                                  "misaligned"])
def test_cuda_ell_spmv_cases_match_plain(cuda_device, case):
    """The redesigned kernel's other paths: a mask with each row's valid
    slots last, per-member weights (read per member), every member silent
    (no live row), and the one-slot walk (K % 4 != 0, or operands that are
    not 16-byte aligned); n_pre no multiple of 256, B no multiple of 8."""
    rng = np.random.default_rng(5)
    n_pre, k, n_post, b = 700, 30 if case == "k_not_multiple_of_4" else 32, \
        500, 11

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    g = t(rng.standard_normal((n_pre, k)))
    idx = t(rng.integers(0, n_post, (n_pre, k)), torch.int32)
    valid = t(rng.random((n_pre, k)) < 0.7, torch.bool)
    spk = t(rng.random((b, n_pre)) < (0.0 if case == "silent" else 0.05),
            torch.bool)
    if case == "valid_not_first":
        valid[:, : k // 2] = False
    if case == "per_member_g":
        g = (t(rng.standard_normal((b, 1, 1))) * g).contiguous()
    if case == "misaligned":
        # a view one element into its storage: 4-byte aligned, not 16
        g = torch.empty(n_pre * k + 1, device=cuda_device)[1:].view(n_pre, k)
        g.copy_(t(rng.standard_normal((n_pre, k))))
    aligned = (g.data_ptr() | idx.data_ptr()) % 16 == 0
    assert K.launch_plan(b, n_pre, k, n_post, aligned)["vec"] == (
        4 if case in ("valid_not_first", "per_member_g", "silent") else 1)
    out = K.ell_spmv(g, idx, valid, spk, n_post)
    torch.testing.assert_close(out, TR.ell_spmv_ref(g, idx, valid, spk,
                                                    n_post), **TOL)
    if case == "silent":
        assert not out.any()


@pytest.mark.gpu
def test_cuda_ell_spmv_refuses_a_plan_unlike_its_layout(cuda_device):
    g = torch.ones(4, 8, device=cuda_device)
    idx = torch.zeros(4, 8, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, 8, dtype=torch.bool, device=cuda_device)
    spk = torch.ones(1, 4, device=cuda_device)
    out = torch.zeros(1, 5, dtype=torch.float64, device=cuda_device)
    lib = K._lib()
    plan = K.launch_plan(1, 4, 8, 5)
    rows = plan["rows_per_cta"]
    assert lib.ell_spmv_smem_bytes(rows) == plan["smem_bytes"]
    assert lib.ell_spmv_smem_bytes(64) == -1         # not compiled
    args = (g.data_ptr(), 0, idx.data_ptr(), valid.data_ptr(),
            spk.data_ptr(), 0, out.data_ptr(), 1, 4, 8, 5)
    stream = torch.cuda.current_stream().cuda_stream
    smem = lib.ell_spmv_smem_bytes(rows)
    assert lib.ell_spmv_f32(*args, 4, rows, smem + 4, stream) != 0
    assert lib.ell_spmv_f32(*args, 2, rows, smem, stream) != 0
    assert lib.ell_spmv_f32(*args, 4, 64, smem, stream) != 0
    assert lib.ell_spmv_f32(*args, 4, rows, smem, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((1, 5), 0.0, dtype=torch.float64,
                                       device=cuda_device)
                       .index_fill_(1, torch.tensor([0], device=cuda_device),
                                    32.0))


@pytest.mark.gpu
@pytest.mark.parametrize("spike_dtype", [torch.float32, torch.bool],
                         ids=["float", "bool"])
@pytest.mark.parametrize("b,p", [(1, 0.05), (8, 0.05), (3, 1.0)])
def test_cuda_ell_spmv_equals_plain_bit_for_bit(cuda_device, b, p,
                                                spike_dtype):
    """Kernel and plain version both sum in float64 and round once, so
    with weights that are no integers they agree exactly, and two calls
    of the kernel agree with each other, whatever order the atomics land
    in (many slots share few targets, so every target sums many terms)."""
    rng = np.random.default_rng(11)
    n_pre, k, n_post = 3000, 64, 40

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    g = t(rng.standard_normal((n_pre, k)))
    idx = t(rng.integers(0, n_post, (n_pre, k)), torch.int32)
    valid = t(rng.random((n_pre, k)) < 0.8, torch.bool)
    spk = t(rng.random((b, n_pre)) < p)
    first = K.ell_spmv(g, idx, valid, spk.to(spike_dtype), n_post)
    again = K.ell_spmv(g, idx, valid, spk.to(spike_dtype), n_post)
    assert torch.equal(first, again)
    assert torch.equal(first, TR.ell_spmv_ref(g, idx, valid, spk, n_post))


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_operands(cuda_device):
    g = torch.ones(4, 3, device=cuda_device)
    idx = torch.zeros(4, 3, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, 3, dtype=torch.bool, device=cuda_device)
    spk = torch.ones(1, 4, device=cuda_device)
    with pytest.raises(TypeError):
        K.ell_spmv(g, idx.long(), valid, spk, 5)
    with pytest.raises(ValueError):
        K.ell_spmv(g.t(), idx, valid, spk, 5)
    with pytest.raises(ValueError):
        K.ell_spmv(g.cpu(), idx, valid, spk, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("spike_dtype", [torch.float32, torch.bool],
                         ids=["float", "bool"])
@pytest.mark.parametrize("per_member_g", [False, True],
                         ids=["shared_g", "per_member_g"])
@pytest.mark.parametrize("b,p,k", [(1, 0.05, 64), (8, 0.05, 64),
                                   (3, 1.0, 64), (8, 0.3, 30)])
def test_cuda_delay_scatter_equals_plain_bit_for_bit(cuda_device, b, p, k,
                                                     per_member_g,
                                                     spike_dtype):
    """The delay scatter sums in float64 like its plain version, so the
    two agree exactly (many slots share few (slot, target) cells); bool
    spikes equal float ones; K % 4 != 0 takes the one-slot walk; adding
    into a scratch that holds (float32-exact) values adds to them."""
    rng = np.random.default_rng(13)
    n_pre, n_post, n_slots = 3000, 40, 21
    plan = K.launch_plan(b, n_pre, k, n_post, n_slots=n_slots)
    assert plan["grid"] == (-(-n_pre // plan["rows_per_cta"]), -(-b // 8), 1)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    g = t(rng.standard_normal((b, n_pre, k) if per_member_g
                              else (n_pre, k)))
    idx = t(rng.integers(0, n_post, (n_pre, k)), torch.int32)
    valid = t(rng.random((n_pre, k)) < 0.8, torch.bool)
    dly = t(rng.integers(0, n_slots, (n_pre, k)), torch.int32)
    spk = t(rng.random((b, n_pre)) < p)
    assert K.launch_plan(b, n_pre, k, n_post, n_slots=n_slots)["vec"] == (
        4 if k % 4 == 0 else 1)
    K.reset_launches()
    first = K.ell_spmv_delay(g, idx, valid, dly, spk.to(spike_dtype),
                             n_post, n_slots)
    again = K.ell_spmv_delay(g, idx, valid, dly, spk, n_post, n_slots)
    assert K.launches == {"ell_spmv": 0, "ell_spmv_delay": 2}
    ref = TR.ell_spmv_delay_ref(g, idx, valid, dly, spk, n_post, n_slots)
    assert torch.equal(first, again)
    assert torch.equal(first, ref)
    # a scratch holding float32 values: float64 sums onto them stay exact
    acc = t(rng.standard_normal((n_slots, n_post, b)).astype(np.float32),
            torch.float64)
    want = acc.clone()
    TR.ell_spmv_delay_into_ref(g, idx, valid, dly, spk, want)
    K.ell_spmv_delay_into(g, idx, valid, dly, spk.to(spike_dtype), acc)
    assert torch.equal(acc, want)


@pytest.mark.gpu
@pytest.mark.parametrize("gscale_kind", ["python", "scalar", "per_member"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("b,n_post", [(1, 80_000), (8, 2000), (4, 37)])
def test_cuda_ring_fold_equals_plain_bit_for_bit(cuda_device, b, n_post,
                                                 sign, gscale_kind):
    """At every cursor: the new ring and inj equal the plain version's bit
    for bit (zeros' sign bits too), the input ring is untouched and the
    scratch is left zeroed; n_post = 37 takes the one-element form."""
    rng = np.random.default_rng(b + n_post)
    n_slots = 21

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    ring = t(rng.standard_normal((b, n_slots, n_post)))
    ring[:, :, :3] = 0.0
    acc0 = t(rng.standard_normal((n_slots, n_post, b)), torch.float64)
    acc0[:, 2:6] = 0.0
    gscale = {"python": 1.0, "scalar": torch.tensor(0.7),
              "per_member": t(rng.uniform(0.1, 3.0, b))}[gscale_kind]
    assert DR.launch_plan(b, n_slots, n_post)["vec"] == (
        4 if n_post % 4 == 0 else 1)
    before = ring.clone()
    for cursor in (0, 7, n_slots - 1):
        acc, acc_ref = acc0.clone(), acc0.clone()
        cur = torch.full((b,), cursor, dtype=torch.int32,
                         device=cuda_device)
        DR.reset_launches()
        new_ring, inj, new_cur = DR.delay_ring_fold(ring, acc, cur, sign,
                                                    gscale)
        assert DR.launches == {"delay_ring_fold": 1}
        want_ring, want_inj, want_cur = TR.delay_ring_fold_ref(
            ring, acc_ref, cur, sign, gscale)
        for got, want in ((new_ring, want_ring), (inj, want_inj)):
            assert torch.equal(got, want)
            assert torch.equal(torch.signbit(got), torch.signbit(want))
        assert new_cur.tolist() == want_cur.tolist() == [
            (cursor + 1) % n_slots] * b
        assert not acc.any() and torch.equal(ring, before)
        assert cur.tolist() == [cursor] * b


@pytest.mark.gpu
@pytest.mark.parametrize("b", [3, 8])
def test_cuda_ring_fold_with_a_cursor_a_member(cuda_device, b):
    """Members at different ring positions (served streams): at every
    block the fold is compiled for, the new ring, inj and the advanced
    cursors equal the plain version's bit for bit, and the scratch is left
    zeroed."""
    rng = np.random.default_rng(b)
    n_slots, n_post = 21, 2000

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=cuda_device)

    ring = t(rng.standard_normal((b, n_slots, n_post)))
    acc0 = t(rng.standard_normal((n_slots, n_post, b)), torch.float64)
    gscale = t(rng.uniform(0.1, 3.0, b))
    cur = t([(5 * m + 2) % n_slots for m in range(b)], torch.int32)
    assert len(set(cur.tolist())) == b
    want = TR.delay_ring_fold_ref(ring, acc0.clone(), cur, -1.0, gscale)
    assert want[2].tolist() == [(c + 1) % n_slots for c in cur.tolist()]
    for block in AT.ELEMENTWISE_BLOCKS:
        acc = acc0.clone()
        with _forced(DR, block):
            got = DR.delay_ring_fold(ring, acc, cur, -1.0, gscale)
        for x, y in zip(got, want):
            assert torch.equal(x, y), block
            if x.is_floating_point():
                assert torch.equal(torch.signbit(x), torch.signbit(y))
        assert not acc.any()


@pytest.mark.gpu
def test_cuda_served_streams_equal_offline_runs(cuda_device):
    """The served chunk replayed from a CUDA graph: streams of a delayed
    net admitted a chunk apart (their cursors differ) equal their offline
    B=1 runs bit for bit, counts and every state tensor."""
    from repro_torch.launch.snn_serve import SNNServer, StreamRequest
    ms = TSPEC.ModelSpec("served_delay")
    ms.add_neuron_population(
        "a", 400, "izhikevich",
        input_fn=lambda k, t, n: R.normal(k, (n,), scale=5.0))
    ms.add_neuron_population(
        "b", 300, "izhikevich",
        input_fn=lambda k, t, n: R.normal(k, (n,), scale=5.0))
    ms.add_synapse_population("ab", "a", ["a", "b"],
                              connect=TF.FixedFanout(40),
                              weight=TF.UniformWeight(0.0, 0.5),
                              delay=TF.UniformIntDelay(0, 6))
    model = ms.build(dt=1.0, seed=3, device=cuda_device)
    srv = SNNServer(model, max_streams=3, chunk=16, stim_pops=("a",))
    rng = np.random.default_rng(0)
    reqs = []
    for i, T in enumerate((50, 45, 40)):
        stim = {"a": (3.0 * rng.normal(size=(T, 400))).astype(np.float32)}
        reqs.append(srv.submit(StreamRequest(rid=i, n_steps=T, stim=stim,
                                             seed=10 + i)))
        srv.serve_step()
    srv.run()
    assert model.simulator.graph_counts["captures"] >= 1
    final = dict(_state_leaves(srv.states))
    for slot, r in enumerate(reqs):
        assert r.done
        res = model.run(r.n_steps, stim=r.stim,
                        state=model.init_state(key=R.PRNGKey(r.seed)))
        for k, v in res.spike_counts.items():
            assert np.array_equal(v.cpu().numpy(), r.spike_counts[k]), k
        for name, v in _state_leaves(res.state):
            assert torch.equal(final[name][slot], v[0]), (r.rid, name)
    assert int(sum(r.spike_counts["b"].sum() for r in reqs)) > 0


@pytest.mark.gpu
def test_cuda_ring_fold_rejects_bad_operands(cuda_device):
    ring = torch.zeros(2, 5, 8, device=cuda_device)
    acc = torch.zeros(5, 8, 2, dtype=torch.float64, device=cuda_device)
    cur = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        DR.delay_ring_fold(ring, acc.float(), cur, 1.0, 1.0)
    # the cursors are an int32 [B] tensor beside the ring (their values
    # are never read on the host, so they are taken mod S on the card)
    on_cpu = torch.zeros(2, dtype=torch.int32)
    for bad in (cur.long(), cur[:1], cur[0], on_cpu):
        with pytest.raises(ValueError):
            DR.delay_ring_fold(ring, acc, bad, 1.0, 1.0)
    with pytest.raises(ValueError):
        DR.delay_ring_fold(ring, acc, cur, 1.0,
                           torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError):
        DR.delay_ring_fold(ring, acc[:4], cur, 1.0, 1.0)
    with pytest.raises(ValueError):
        DR.delay_ring_fold(ring, acc.permute(2, 0, 1).contiguous(), cur, 1.0,
                           1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_neuron_kernels_match_plain(cuda_device, b):
    rng = np.random.default_rng(1)
    n = 5000

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=cuda_device)

    v, u = t(rng.uniform(-80, 25, (b, n))), t(rng.uniform(-20, 5, (b, n)))
    isyn = t(5 * rng.standard_normal((b, n)))
    r = rng.random(n)
    params = [t(0.02 + 0.08 * r), t(0.25 - 0.05 * r), t(-65 + 15 * r * r),
              t(8 - 6 * r * r)]
    hh_in = [t(rng.uniform(-80, 30, (b, n)))] + [
        t(rng.random((b, n))) for _ in range(3)] + [
        t(2 * rng.standard_normal((b, n)))]
    IZ.reset_launches()
    HH.reset_launches()
    out = IZ.izhikevich_step(v, u, isyn, *params, 1.0)
    hout = HH.hh_step(*hh_in, 0.1, substeps=5)
    torch.cuda.synchronize()
    assert IZ.launches == {"izhikevich_step": 1}
    assert HH.launches == {"hh_step": 1}
    ref = TR.izhikevich_step_ref(v, u, isyn, *params, 1.0)
    agree = out[2] == ref[2]
    assert (~agree).float().mean().item() < 0.002
    for a, e in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a[agree], e[agree], **NEURON_TOL)
    href = TR.hh_step_ref(*hh_in, 0.1, substeps=5)
    for a, e in zip(hout[:4], href[:4]):
        assert torch.equal(a, e)
    assert torch.equal(hout[4], hout[0] >= 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("plant", [None, "nan", "inf"])
@pytest.mark.parametrize("kernel", ["izhikevich_step", "hh_step"])
def test_cuda_finite_flag_equals_the_fold(cuda_device, kernel, plant):
    """The flag a kernel writes in its epilogue equals isfinite over its
    own outputs, member by member (3 members of 70000 neurons: several
    blocks each; the planted value sits in member 1's last block)."""
    rng = np.random.default_rng(2)
    b, n = 3, 70_000

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=cuda_device)

    isyn = t(2 * rng.standard_normal((b, n)))
    if plant is not None:
        isyn[1, n - 5] = float(plant)
    finite = torch.ones(b, dtype=torch.bool, device=cuda_device)
    finite[2] = False                      # an earlier step's verdict stays
    if kernel == "hh_step":
        state = [t(rng.uniform(-80, 30, (b, n)))] + [
            t(rng.random((b, n))) for _ in range(3)]
        out = HH.hh_step(*state, isyn, 0.1, finite=finite)[:4]
    else:
        r = rng.random(n)
        params = [t(0.02 + 0.08 * r), t(0.25 - 0.05 * r),
                  t(-65 + 15 * r * r), t(8 - 6 * r * r)]
        out = IZ.izhikevich_step(t(rng.uniform(-80, 25, (b, n))),
                                 t(rng.uniform(-20, 5, (b, n))), isyn,
                                 *params, 1.0, finite=finite)[:2]
    torch.cuda.synchronize()
    fold = torch.tensor([True, True, False], device=cuda_device)
    for x in out:
        fold &= torch.isfinite(x).all(dim=-1)
    assert torch.equal(finite, fold)
    assert finite.tolist() == [True, plant is None, False]


@pytest.mark.gpu
def test_cuda_neuron_wrappers_reject_bad_operands(cuda_device):
    v = torch.zeros(2, 8, device=cuda_device)
    p = torch.ones(8, device=cuda_device)
    with pytest.raises(TypeError):
        IZ.izhikevich_step(v.double(), v, v, p, p, p, p, 1.0)
    with pytest.raises(ValueError):           # scalar param on the card
        IZ.izhikevich_step(v, v, v, 0.02, p, p, p, 1.0)
    with pytest.raises(ValueError):
        IZ.izhikevich_step(v, v, v[:1], p, p, p, p, 1.0)
    with pytest.raises(ValueError):
        HH.hh_step(v.t(), v.t(), v.t(), v.t(), v.t(), 0.1)
    with pytest.raises(ValueError):
        HH.hh_step(v, v, v, v.cpu(), v, 0.1)
    with pytest.raises(TypeError):            # per-neuron params
        HH.hh_step(v, v, v, v, v, 0.1, gK=p)


# b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, q_offset
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, None, None, 0),
    (1, 4, 2, 130, 300, 32, True, 64, None, None, 170),
    (1, 2, 2, 256, 256, 64, True, None, 30.0, 100, 0),
    (2, 4, 4, 200, 200, 64, False, None, None, None, 0),
    (1, 4, 2, 300, 300, 256, True, 128, None, None, 0),
    (1, 2, 1, 96, 96, 112, True, None, None, None, 0),
    # D = 40: the tensor-core kernels pad the contraction with zeros
    (1, 2, 1, 200, 200, 40, True, None, None, None, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, off = case
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device).to(dt)

    # q as the model hands it over: a [B, T, H, D] projection, transposed
    q = t((b, tq, hq, d)).transpose(1, 2)
    k, v = t((b, hkv, tk, d)), t((b, hkv, tk, d))
    kw = dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
              q_offset=off)
    FA.reset_launches()
    out = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 1, "flash_attention_bwd": 0}
    assert out.dtype == dt and out.shape == (b, hq, tq, d)
    ref = TR.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_bad_operands(cuda_device):
    q = torch.zeros(1, 4, 8, 64, device=cuda_device)
    k = torch.zeros(1, 2, 8, 64, device=cuda_device)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):           # head dim not a multiple of 8
        FA.flash_attention(q[..., :60], k[..., :60], k[..., :60])
    with pytest.raises(ValueError):           # Hq not a multiple of Hkv
        FA.flash_attention(q[:, :3], k, k)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k.cpu(), k)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_grads_match_plain(cuda_device, case):
    """q, k and v get the gradients of autograd through the plain version
    (the repaired fault: the kernel's output had no grad_fn)."""
    b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, off = case
    rng = np.random.default_rng(3)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device)

    kw = dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
              q_offset=off)
    q, k, v, g = (t((b, hq, tq, d)), t((b, hkv, tk, d)), t((b, hkv, tk, d)),
                  t((b, hq, tq, d)))
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    FA.reset_launches()
    out = kops.flash_attention(*ins, **kw)
    grads = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 1, "flash_attention_bwd": 1}
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(TR.flash_attention_ref(*refs, **kw), refs, g)
    for name, a, w in zip("qkv", grads, want):
        assert a.abs().sum() > 0, name
        torch.testing.assert_close(a, w, rtol=5e-4, atol=5e-5,
                                   msg=lambda m: f"d{name}: {m}")
    _, lse = TR.flash_attention_fwd_ref(q, k, v, **kw)
    _, lse_k = FA.flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(lse_k, lse, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_bwd_bf16_matches_plain(cuda_device, case):
    b, hq, hkv, tq, tk, d, causal, window, softcap, prefix, off = case
    rng = np.random.default_rng(4)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device).to(torch.bfloat16)

    kw = dict(causal=causal, window=window, softcap=softcap, prefix=prefix,
              q_offset=off)
    q, k, v, g = (t((b, hq, tq, d)), t((b, hkv, tk, d)), t((b, hkv, tk, d)),
                  t((b, hq, tq, d)))
    out, lse = FA.flash_attention_fwd(q, k, v, **kw)
    got = FA.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    want = TR.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      out.float(), lse, g.float(), **kw)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w, rtol=1e-2,
                                   atol=1e-2 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_route_by_dtype(cuda_device, dtype):
    """A bf16 call runs the tensor-core kernels and a float32 call the
    CUDA-core ones, by kernel name in a torch.profiler trace; neither runs
    a kernel of the other route."""
    from torch.profiler import ProfilerActivity, profile
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, dout = (torch.randn(shape, device=cuda_device, generator=g
                                 ).to(dt)
                     for shape in ((1, 4, 128, 64), (1, 2, 128, 64),
                                   (1, 2, 128, 64), (1, 4, 128, 64)))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True)      # built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = FA.flash_attention_fwd(q, k, v, causal=True)
        FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    mine, other = (FA.ROUTES[dt], FA.ROUTES[torch.float32 if dt ==
                                           torch.bfloat16 else torch.bfloat16])
    for kern in mine["fwd"] + mine["bwd"]:
        assert any(kern in n for n in names), (kern, names)
    for kern in other["fwd"] + other["bwd"]:
        assert not any(kern in n for n in names), (kern, names)


@pytest.mark.gpu
def test_cuda_flash_attention_bf16_batch_heads_past_grid_axis_y(cuda_device):
    """b·Hq = 65,552 > 65535: the bf16 kernels (b·Hq on grid axis x) run
    forward and backward and match the plain versions at the bf16
    tolerances; the float32 route (b·Hq on axis y) refuses the shape."""
    b, hq, hkv, t, d = 4097, 16, 4, 16, 64
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, dout = (torch.randn(shape, device=cuda_device, generator=g
                                 ).bfloat16()
                     for shape in ((b, hq, t, d), (b, hkv, t, d),
                                   (b, hkv, t, d), (b, hq, t, d)))
    FA.reset_launches()
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 1, "flash_attention_bwd": 1}
    ref = TR.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=True)
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)
    want = TR.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(),
                                      causal=True)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w, rtol=1e-2,
                                   atol=1e-2 * float(w.abs().max()))
    with pytest.raises(ValueError, match="axis y"):
        FA.flash_attention(q.float(), k.float(), v.float())


# b, t, h, dh, ds (the last: dh and ds multiples of 4 but not of 8, padded
# with zeros to the tensor cores' mma width)
SSD_CASES = [(2, 256, 8, 64, 128), (1, 96, 4, 64, 128), (1, 1000, 3, 16, 16),
             (2, 300, 5, 32, 64), (1, 200, 3, 20, 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("case", SSD_CASES)
def test_cuda_ssd_scan_matches_plain(cuda_device, case, with_d):
    b, t, h, dh, ds = case
    rng = np.random.default_rng(5)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda_device)

    x = f(rng.standard_normal((b, t, h, dh)))
    dt = f(0.001 + 0.1 * rng.random((b, t, h)))
    A = f(-np.exp(rng.uniform(0, 2, h)))
    B = f(rng.standard_normal((b, t, 1, ds)))
    C = f(rng.standard_normal((b, t, 1, ds)))
    D = f(rng.standard_normal(h)) if with_d else None
    torch.backends.cuda.matmul.allow_tf32 = False
    SSD.reset_launches()
    y = SSD.ssd_scan(x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert SSD.launches == {"ssd_scan": 1}
    ref = TS.ssd_chunked(x, dt, A, B, C, D)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y, TR.ssd_scan_ref(x, dt, A, B, C, D),
                               rtol=2e-4, atol=2e-4)
    # the Function: kernel forward, gradients of ssd_chunked
    xs = x.clone().requires_grad_(True)
    y2 = kops.ssd_scan(xs, dt, A, B, C, D)
    (gx,) = torch.autograd.grad(y2.sum(), [xs])
    xr = x.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(TS.ssd_chunked(xr, dt, A, B, C, D).sum(),
                                [xr])
    torch.testing.assert_close(gx, gr)


@pytest.mark.gpu
def test_cuda_ssd_scan_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 2, 16, device=cuda_device)
    dt = torch.zeros(1, 8, 2, device=cuda_device)
    A = torch.zeros(2, device=cuda_device)
    B = torch.zeros(1, 8, 1, 16, device=cuda_device)
    with pytest.raises(NotImplementedError):        # n_groups 2
        SSD.ssd_scan(x, dt, A, B.expand(1, 8, 2, 16), B.expand(1, 8, 2, 16))
    with pytest.raises(ValueError):                 # dh > 64
        SSD.ssd_scan(x.expand(1, 8, 2, 16).repeat(1, 1, 1, 5), dt, A, B, B)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt.cpu(), A, B, B)


# -- threefry and the compiled step loop --------------------------------------

def _ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("n", [1, 7, 4097, 80_000])
def test_cuda_threefry_matches_plain(cuda_device, b, n):
    keys = R.split(R.PRNGKey(11), b)
    kd = keys.to(cuda_device)
    TFK.reset_launches()
    got_split = TFK.threefry_split(kd, 9)
    draws = {d: TFK.threefry_draw(kd, n, d, 3.5 if d == "normal" else 1.0)
             for d in TFK.DRAWS}
    # a step's subkeys are a strided column of the split
    col = TFK.threefry_draw(got_split[:, 4], n, "uniform")
    torch.cuda.synchronize()
    assert TFK.launches == {"threefry_split": 1, "threefry_draw": 4}
    assert torch.equal(got_split.cpu(), TR.threefry_split_ref(keys, 9))
    for d in ("bits", "uniform"):
        assert torch.equal(draws[d].cpu(), TR.threefry_draw_ref(keys, n, d))
    assert _ulp(draws["normal"].cpu(),
                TR.threefry_draw_ref(keys, n, "normal", 3.5)) <= 4
    assert torch.equal(col.cpu(), TR.threefry_draw_ref(
        TR.threefry_split_ref(keys, 9)[:, 4], n, "uniform"))
    # the plain version on the card equals the kernel too
    assert _ulp(draws["normal"], TR.threefry_draw_ref(kd, n, "normal",
                                                      3.5)) <= 4
    assert torch.equal(R.fold_in(kd[0], 77).cpu(),
                       R.fold_in(keys[0], 77))


@pytest.mark.gpu
def test_cuda_threefry_rejects_bad_keys(cuda_device):
    keys = torch.zeros(4, 2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        TFK.threefry_draw(keys.long(), 8, "uniform")
    with pytest.raises(ValueError):
        TFK.threefry_draw(keys.t(), 8, "uniform")
    with pytest.raises(ValueError):
        TFK.threefry_split(keys[:, :1], 2)


@pytest.mark.gpu
def test_cuda_delayed_group_folds_with_its_device_cursor(cuda_device):
    """A delayed group stepped past a full ring period on the card equals
    the same group on the CPU bit for bit, its cursor a device tensor that
    wraps."""
    rng = np.random.default_rng(4)
    n_pre, k, n_post = 300, 12, 200
    arrays = (rng.integers(0, n_post, (n_pre, k)).astype(np.int32),
              rng.random((n_pre, k)).astype(np.float32),
              rng.random((n_pre, k)) < 0.8)
    dly = rng.integers(0, 6, (n_pre, k)).astype(np.int32)
    groups = [TSYN.SynapseGroup(
        name="d", pre="a", post="b",
        ell=TF.triple_to_ell(*arrays, n_post, delay=dly, device=dev),
        max_delay=5, sign=-1.0) for dev in ("cpu", cuda_device)]
    states = [g.init_state(2) for g in groups]
    gs = torch.tensor([0.5, 1.5])
    for i in range(2 * groups[0].ring_slots + 1):
        spikes = torch.tensor(rng.random((2, n_pre)) < 0.2)
        outs = [g.step(st, spikes.to(st.dendritic.device),
                       gs.to(st.dendritic.device), 1.0)
                for g, st in zip(groups, states)]
        states = [o[0] for o in outs]
        assert torch.equal(outs[1][1].cpu(), outs[0][1])
        assert torch.equal(states[1].dendritic.cpu(), states[0].dendritic)
        assert states[1].cursor.device.type == torch.device(cuda_device).type
        assert states[1].cursor.tolist() == states[0].cursor.tolist() == [
            (i + 1) % groups[0].ring_slots] * 2


def _state_leaves(x, prefix=""):
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for key in sorted(x):
            yield from _state_leaves(x[key], f"{prefix}.{key}")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _state_leaves(getattr(x, f.name), f"{prefix}.{f.name}")


def _assert_runs_equal(a, b):
    for name in a.spike_counts:
        assert torch.equal(a.spike_counts[name], b.spike_counts[name]), name
        assert torch.equal(a.raster[name], b.raster[name]), name
    la, lb = dict(_state_leaves(a.state)), dict(_state_leaves(b.state))
    assert la.keys() == lb.keys()
    for key in la:
        x, y = la[key], lb[key]
        assert x.dtype == y.dtype and x.shape == y.shape, key
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), key


def _delayed_izhikevich(device):
    base = TIZ.spec(TIZ.IzhikevichNetConfig(n_total=2000, n_conn=50))
    ms = TSPEC.ModelSpec("delayed")
    for pop in base.populations.values():
        ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                 pop.input_fn)
    for sp in base.synapses:
        ms.add_synapse_population(
            sp.name, sp.pre, list(sp.post), sp.connect, sp.weight,
            representation="sparse",
            delay=TF.UniformIntDelay(0, 6) if sp.name == "exc" else None)
    return ms.build(dt=1.0, seed=5, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["izhikevich_delayed", "mushroom_body"])
def test_cuda_captured_run_equals_eager_run(cuda_device, monkeypatch, net):
    """Chunks of 8 captured as CUDA graphs (45 steps: 5 replays of 8 and
    one of 5), two calls through one runner with other gScales: each
    equals the eager run, and the launch counts are the eager run's."""
    monkeypatch.setattr(GR, "CHUNK_STEPS", 8)
    if net == "mushroom_body":
        model = TMB.compile_model(TMB.MushroomBodyConfig(
            n_pn=24, n_lhi=6, n_kc=150, n_dn=12), device=cuda_device)
        group, grid = "PN_KC", ([0.5, 1.0, 50.0], [2.0, 4.0, 8.0])
    else:
        model = _delayed_izhikevich(cuda_device)
        group, grid = "exc", ([0.3, 0.9, 1.2], [0.6, 1.0, 1.1])
    sim = model.simulator
    names = model._expand_group(group)
    st = sim.init_state(3)
    for values in grid:
        gs = {n: torch.tensor(values, device=cuda_device) for n in names}
        for m in GR.launch_counters():
            for key in m:
                m[key] = 0
        eager = sim.run(st, 45, gs, record_raster=True)
        torch.cuda.synchronize()
        want = [dict(m) for m in GR.launch_counters()]
        sim.run_compiled(st, 45, gs, record_raster=True)      # captures
        for m in GR.launch_counters():
            for key in m:
                m[key] = 0
        comp = sim.run_compiled(st, 45, gs, record_raster=True)
        torch.cuda.synchronize()
        assert [dict(m) for m in GR.launch_counters()] == want
        _assert_runs_equal(eager, comp)
    assert sim.graph_counts["captures"] == 2
    assert sim.graph_counts["replays"] == 4 * 6


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(1, 1), (1, 80001), (8, 80000), (3, 33),
                                 (2, 64)])
def test_cuda_spike_bitmask_equals_plain(cuda_device, b, n):
    rng = np.random.default_rng(n)
    bits = torch.tensor(rng.random((b, n)) < 0.3, device=cuda_device)
    bits[:, -1] = True                      # the last bit of the last word
    if n >= 32:
        bits[:, 31] = True                  # bit 31: int32's sign
    SBK.reset_launches()
    got = SBK.spike_bitmask(bits)
    assert SBK.launches["spike_bitmask"] == 1
    assert got.dtype == torch.int32 and got.shape == (b, -(-n // 32))
    assert torch.equal(got.cpu(), TR.spike_bitmask_ref(bits.cpu()))
    assert torch.equal(got, TR.spike_bitmask_ref(bits))


@pytest.mark.gpu
def test_cuda_spike_bitmask_ring_slot_from_the_device(cuda_device):
    """The ring variant reads its slot and active flag on the device: a
    CUDA graph captured once writes whatever row they name at each
    replay, and an inactive replay writes nothing."""
    rng = np.random.default_rng(1)
    b, n, cap = 2, 100, 5
    ring = torch.zeros((cap, b, 4), dtype=torch.int32, device=cuda_device)
    want = torch.zeros_like(ring)
    bits = torch.zeros((b, n), dtype=torch.bool, device=cuda_device)
    slot = torch.zeros((), dtype=torch.int32, device=cuda_device)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    SBK.spike_bitmask_into(bits, ring, slot, active)          # warm up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        SBK.spike_bitmask_into(bits, ring, slot, active)
    for i, (s, on) in enumerate([(3, True), (0, True), (3, False),
                                 (4, True), (3, True)]):
        new = torch.tensor(rng.random((b, n)) < 0.5, device=cuda_device)
        bits.copy_(new)
        slot.fill_(s)
        active.fill_(on)
        g.replay()
        if on:
            want[s] = TR.spike_bitmask_ref(new)
        torch.cuda.synchronize()
        assert torch.equal(ring, want), i
    # the plain version with the same device tensors agrees
    plain = torch.zeros_like(ring)
    TR.spike_bitmask_into_ref(bits, plain, slot, active)
    assert torch.equal(plain[3], ring[3])
    # host slots, and a slot past the ring writes nothing
    SBK.spike_bitmask_into(bits, ring, 1)
    assert torch.equal(ring[1], TR.spike_bitmask_ref(bits))
    slot.fill_(cap)
    before = ring.clone()
    SBK.spike_bitmask_into(bits, ring, slot)
    assert torch.equal(ring, before)
    with pytest.raises(ValueError):
        SBK.spike_bitmask_into(bits, ring, cap)
    with pytest.raises(TypeError):
        SBK.spike_bitmask(bits.to(torch.uint8))
    with pytest.raises(ValueError):
        SBK.spike_bitmask_into(bits, ring[:, :1], 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [45, 70])
def test_cuda_captured_observed_run_equals_eager_run(cuda_device,
                                                     monkeypatch, n_steps):
    """Probes (a packed spike ring, strided, windowed and reduced ones),
    scheduled custom updates (one writes a delayed group's g, its "post"
    sum one ELL launch) and the health monitor, replayed from CUDA graphs
    of 8 steps: recordings, counts, health and state equal the eager
    run's, launches too; the spike probe is the raster."""
    from repro_torch.obs.health import HealthConfig
    monkeypatch.setattr(GR, "CHUNK_STEPS", 8)
    base = TIZ.spec(TIZ.IzhikevichNetConfig(n_total=2000, n_conn=50))
    ms = TSPEC.ModelSpec("observed")
    for pop in base.populations.values():
        ms.add_neuron_population(pop.name, pop.n, pop.model, pop.params,
                                 pop.input_fn)
    for sp in base.synapses:
        ms.add_synapse_population(
            sp.name, sp.pre, list(sp.post), sp.connect, sp.weight,
            representation="sparse",
            delay=TF.UniformIntDelay(0, 6) if sp.name == "exc" else None)
    ms.probe("spk", "exc", "spikes")
    ms.probe("inh_spk", "inh", "spikes", every=10)
    ms.probe("vmean", "exc", "V", reduce="mean")
    ms.probe("v25", "exc", "V", every=25, window=20)
    ms.probe("gmax", "exc_exc", "g", reduce="max", every=4)
    ms.add_custom_update("norm", "exc_exc",
                         "g = g * 10.0 / maximum(w_sum, 1e-9)",
                         reduce={"w_sum": ("sum", "g", "post")}, every=9)
    ms.add_custom_update("recenter", "inh", "V = V - 0.1 * (v_mean + 65.0)",
                         reduce={"v_mean": ("mean", "V")}, every=6)
    model = ms.build(dt=1.0, seed=5, device=cuda_device,
                     monitor=HealthConfig(bands_hz={"exc": (1.0, 100.0)}))
    sim = model.simulator
    for batch in (1, 3):
        st = sim.init_state(batch)
        for m in GR.launch_counters():
            for key in m:
                m[key] = 0
        eager = sim.run(st, n_steps, record_raster=True)
        torch.cuda.synchronize()
        want = [dict(m) for m in GR.launch_counters()]
        # eagerly the due samples: every step of "spk", every 10th of
        # "inh_spk"
        assert want[-1]["spike_bitmask"] == n_steps + n_steps // 10
        sim.run_compiled(st, n_steps, record_raster=True)      # captures
        for m in GR.launch_counters():
            for key in m:
                m[key] = 0
        comp = sim.run_compiled(st, n_steps, record_raster=True)
        torch.cuda.synchronize()
        got = [dict(m) for m in GR.launch_counters()]
        # the graph packs every step's spikes into its staging rows
        assert got[:-1] == want[:-1]
        assert got[-1]["spike_bitmask"] == 2 * n_steps
        _assert_runs_equal(eager, comp)
        for name in eager.recordings.keys():
            x, y = eager.recordings[name], comp.recordings[name]
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), name
            assert torch.equal(eager.recordings.count(name),
                               comp.recordings.count(name)), name
        for f in dataclasses.fields(eager.health):
            a, b = getattr(eager.health, f.name), getattr(comp.health, f.name)
            if isinstance(a, dict):
                assert all(torch.equal(a[k], b[k]) for k in a), f.name
            else:
                assert torch.equal(a, b), f.name
        assert torch.equal(comp.recordings["spk"],
                           comp.raster["exc"].transpose(0, 1))
        assert torch.equal(comp.health.spike_total["exc"],
                           comp.spike_counts["exc"].sum(-1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the occupancy model against the runtime
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_h100_limits_equal_the_cards(cuda_device):
    got = AT.device_limits()
    for key, value in got.items():
        assert getattr(AT.H100, key) == value, key


@pytest.mark.gpu
@pytest.mark.parametrize("library", sorted({k.library
                                            for k in AT.KERNELS.values()}))
def test_cuda_library_names_the_models_kernels(cuda_device, library):
    """The built library numbers exactly the kernels the model lists."""
    want = sorted(n for n, k in AT.KERNELS.items() if k.library == library)
    assert sorted(AT.kernel_names(library)) == want


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(AT.KERNELS))
def test_cuda_occupancy_equals_the_runtime(cuda_device, kernel):
    """At every compiled block (and, for the kernels the model chooses a
    block for, at every block of whole warps the kernel may take)."""
    spec = AT.KERNELS[kernel]
    for block in spec.blocks:
        a = AT.kernel_attributes(kernel, block)
        smem = a["sharedSizeBytes"] + a["launchDynamicSharedBytes"]
        model = AT.occupancy(block, a["numRegs"], smem)["ctas"]
        assert model == AT.runtime_occupancy(kernel, block) > 0, block
        if spec.blocks[0] < 256 or len(spec.blocks) == 1:
            continue
        for q in range(32, a["maxThreadsPerBlock"] + 1, 32):
            want = AT.runtime_occupancy(kernel, block, q,
                                        a["launchDynamicSharedBytes"])
            assert AT.occupancy(q, a["numRegs"], smem)["ctas"] == want, q


def _forced(module, block):
    """Patch ``module.launch_plan`` to put ``block`` in its plan."""
    from unittest import mock
    orig = module.launch_plan

    def plan(*args, **kw):
        p = dict(orig(*args, **kw))
        p["block"] = block
        if "rows_per_cta" in p:
            p["rows_per_cta"] = block
            p["smem_bytes"] = AT.spmv_smem_bytes(block)
        if module in (IZ, HH):
            p["grid"] = (min(-(-args[1] // block), module.GRID_STRIDE_MAX),
                         args[0], 1)
        return p
    return mock.patch.object(module, "launch_plan", plan)


@pytest.mark.gpu
def test_cuda_every_compiled_block_gives_the_chosen_blocks_result(
        cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    dev = cuda_device

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    n_pre, k, n_post, n_slots = 20_000, 200, 20_000, 21
    g = rnd(n_pre, k)
    idx = torch.randint(0, n_post, (n_pre, k), device=dev, generator=gen,
                        dtype=torch.int32)
    valid = rnd(n_pre, k) < 0.8
    dly = torch.randint(0, n_slots, (n_pre, k), device=dev, generator=gen,
                        dtype=torch.int32)
    spk = rnd(2, n_pre) < 0.02
    v, u = -65.0 + 40.0 * rnd(2, 30_000), -13.0 + rnd(2, 30_000)
    isyn = 10.0 * rnd(2, 30_000)
    pa, pb, pc, pd = (rnd(30_000) for _ in range(4))
    hv, hm, hh_, hn = (-60.0 + 10 * rnd(1, 5000), rnd(1, 5000),
                       rnd(1, 5000), rnd(1, 5000))
    hi = rnd(1, 5000)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 2), device=dev,
                         generator=gen, dtype=torch.int32)
    ring = rnd(2, n_slots, n_post)
    acc0 = rnd(n_slots, n_post, 2).double()
    cur = torch.tensor([4, 9], dtype=torch.int32, device=dev)
    runs = {
        K: [lambda: K.ell_spmv(g, idx, valid, spk, n_post),
            lambda: K.ell_spmv_delay(g, idx, valid, dly, spk, n_post,
                                     n_slots)],
        IZ: [lambda: IZ.izhikevich_step(v, u, isyn, pa, pb, pc, pd, 1.0)],
        HH: [lambda: HH.hh_step(hv, hm, hh_, hn, hi, 0.1)],
        TFK: [lambda: TFK.threefry_split(keys, 5),
              lambda: TFK.threefry_draw(keys, 30_001, "normal", 2.0)],
        SBK: [lambda: SBK.spike_bitmask(spk)],
        DR: [lambda: DR.delay_ring_fold(ring, acc0.clone(), cur, -1.0,
                                        0.7)],
    }
    plains = {
        K: [lambda: TR.ell_spmv_ref(g, idx, valid, spk, n_post),
            lambda: TR.ell_spmv_delay_ref(g, idx, valid, dly, spk, n_post,
                                          n_slots)],
        IZ: [lambda: TR.izhikevich_step_ref(v, u, isyn, pa, pb, pc, pd,
                                            1.0)],
        HH: [lambda: TR.hh_step_ref(hv, hm, hh_, hn, hi, 0.1)],
        TFK: [lambda: TR.threefry_split_ref(keys, 5),
              lambda: TR.threefry_draw_ref(keys, 30_001, "normal", 2.0)],
        SBK: [lambda: TR.spike_bitmask_ref(spk)],
        DR: [lambda: TR.delay_ring_fold_ref(ring, acc0.clone(), cur, -1.0,
                                            0.7)],
    }
    blocks = {K: AT.SPMV_ROWS}
    for module, fns in runs.items():
        chosen = [fn() for fn in fns]
        for block in blocks.get(module, AT.ELEMENTWISE_BLOCKS):
            with _forced(module, block):
                for fn, want in zip(fns, chosen):
                    got = fn()
                    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                                    torch.utils._pytree.tree_leaves(want)):
                        assert torch.equal(a, b), (module.__name__, block)
        for i, (fn, plain) in enumerate(zip(fns, plains[module])):
            if module is TFK and i == 1:
                continue                       # normals: 4 ulp (above)
            got, want = fn(), plain()
            for a, b in zip(torch.utils._pytree.tree_leaves(got),
                            torch.utils._pytree.tree_leaves(want)):
                assert torch.equal(a, b), module.__name__


@pytest.mark.gpu
def test_cuda_torch_profiler_trace_writes_the_device_timeline(cuda_device,
                                                              tmp_path):
    from repro_torch.obs import profile as TPROF
    model = TIZ.compile_model(TIZ.IzhikevichNetConfig(n_total=2000,
                                                      n_conn=50))
    with TPROF.torch_profiler_trace(str(tmp_path)) as prof:
        model.run(20)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("izhikevich_step_kernel" in n for n in names)
    import json
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("cat") == "kernel" for e in doc["traceEvents"])
