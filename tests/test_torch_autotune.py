"""``repro_torch.kernels.autotune``, the paper's occupancy model in its CUDA
form, on the CPU: the calculator against hand-worked cases (one per
limiter, with the register and shared-memory allocation units and the
system's 1 KB a CTA), the block choices (the smallest among ties,
``feasible`` false exactly where ``launch_plan`` raises), and
``choose_propagation`` against the JAX package's on mode and capacity,
with the one difference that the TPU's VMEM model makes pinned side by
side.  Attributes are passed by hand: ``kernel_attributes`` reads a built
kernel and raises off the card (tests/test_torch_cuda.py holds the model
to the runtime there)."""

import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as JAT  # noqa: E402
from repro.core.snn import spec as JSPEC  # noqa: E402
from repro.sparse import formats as JF  # noqa: E402
from repro_torch.core.snn import spec as TSPEC  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import delay_ring as DR  # noqa: E402
from repro_torch.kernels import ell_spmv as K  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.sparse import formats as TF  # noqa: E402

KB = 1024


# -- the calculator -----------------------------------------------------------

@pytest.mark.parametrize("threads,regs,smem,ctas,limiter", [
    # 32 warps a CTA: 64 // 32
    (1024, 0, 0, 2, "threads"),
    # one warp a CTA: the threads allow 64, the SM holds 32 CTAs
    (32, 16, 0, 32, "CTAs"),
    # 33 registers -> 1056 a warp, allocated as 1280; a quarter of the
    # file (16384) holds 12 such warps, the SM 48: 6 CTAs of 8 warps
    # (unrounded, 65536 // (33 * 256) would be 7)
    (256, 33, 0, 6, "registers"),
    # 40 registers, 3 warps a CTA: 12 warps a quarter, 48 an SM, 16 CTAs
    # (the whole file, 65536 // 1280 = 51 warps, would give 17)
    (96, 40, 0, 16, "registers"),
    # 45 KB + 100 B of shared memory: + the 1 KB reserve, in units of
    # 128 B, 47232 a CTA: 4 in 228 KB (without the reserve, 5)
    (128, 0, 45 * KB + 100, 4, "shared memory"),
    # 45666 B: + 1 KB = 46690, allocated as 46720: 4 CTAs (46690 would
    # fit 5 times)
    (128, 0, 45666, 4, "shared memory"),
])
def test_occupancy_matches_the_calculator(threads, regs, smem, ctas,
                                          limiter):
    occ = AT.occupancy(threads, regs, smem)
    assert occ["ctas"] == ctas and occ["limiter"] == limiter
    warps = -(-threads // 32)
    assert occ["warps"] == ctas * warps
    assert occ["occupancy"] == ctas * warps / 64
    assert occ["by"][limiter] == ctas
    assert min(occ["by"].values()) == ctas


@pytest.mark.parametrize("threads,regs,smem", [
    (1025, 0, 0),                 # past 1024 threads a CTA
    (128, 256, 0),                # past 255 registers a thread
    (1024, 72, 0),                # 1024 x 72 registers past 64K a CTA
    (128, 0, 227 * KB + 1),       # past 227 KB a CTA
])
def test_occupancy_zero_where_a_cta_cannot_launch(threads, regs, smem):
    assert AT.occupancy(threads, regs, smem)["ctas"] == 0


def test_h100_limits_are_the_calculators():
    lim = AT.H100
    assert (lim.sms, lim.max_threads_per_sm, lim.max_warps_per_sm,
            lim.max_ctas_per_sm, lim.max_threads_per_cta) == (
        132, 2048, 64, 32, 1024)
    assert (lim.regs_per_sm, lim.max_regs_per_thread,
            lim.reg_alloc_unit) == (65536, 255, 256)
    assert (lim.smem_per_sm, lim.smem_per_cta, lim.smem_reserved_per_cta,
            lim.smem_alloc_unit) == (228 * KB, 227 * KB, KB, 128)
    with pytest.raises(Exception):
        lim.sms = 1                                   # frozen


def test_kernel_attributes_raise_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        AT.kernel_attributes("izhikevich_step", 256)
    with pytest.raises(RuntimeError, match="CUDA device"):
        AT.device_limits()
    with pytest.raises(RuntimeError, match="CUDA device"):
        AT.kernel_names("neuron_step")


def test_choices_off_the_card_plan_the_shape_alone():
    """Without a card the choosers read no registers (the CPU runs the
    plain versions); with one they read the card's, and nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for kernel in ("izhikevich_step", "hh_step", "delay_ring_fold<4>"):
        assert (AT.choose_block_elementwise(80_000, kernel, 20)
                == AT.choose_block_elementwise(80_000, kernel, 20, attrs={}))
    assert AT.spmv_regs() == AT.spmv_regs(delay=True) == {}
    assert (AT.choose_block_spmv(80_000, 800, 80_000, 20, 21)
            == AT.choose_block_spmv(80_000, 800, 80_000, 20, 21, attrs={}))
    assert K.launch_plan(20, 80_000, 800, 80_000)["rows_per_cta"] == 128


def test_sources_number_the_models_kernels():
    """Each library's KINFO_NAMES (the numbering its kernel_info takes)
    lists exactly the kernels the model names for it, once each."""
    import re
    from pathlib import Path
    csrc = Path(AT.__file__).parent / "csrc"
    found = {}
    for src in sorted(csrc.glob("*.cu")):
        m = re.search(r"^KINFO_NAMES\((\w+),((?:\s*\"[^\"]*\",?)+)\s*\)",
                      src.read_text(), re.M)
        assert m, f"{src.name} has no KINFO_NAMES"
        assert m.group(1) == src.stem
        found[src.stem] = re.findall(r'"([^"]*)"', m.group(2))
    for lib, names in found.items():
        assert len(set(names)) == len(names), lib
        assert sorted(names) == sorted(
            n for n, k in AT.KERNELS.items() if k.library == lib), lib
    assert {k.library for k in AT.KERNELS.values()} == set(found)


# -- choosing a block ---------------------------------------------------------

def _same(regs):
    return {b: {"numRegs": regs, "sharedSizeBytes": 0}
            for b in AT.ELEMENTWISE_BLOCKS}


@pytest.mark.parametrize("n,batch", [(80_000, 1), (20_000, 1), (100_000, 8),
                                     (5, 1), (1, 1)])
def test_elementwise_takes_the_smallest_block_of_a_tie(n, batch):
    """Under one wave every block puts the same threads on the card:
    occupancy x wave efficiency ties, and the paper's smallest block
    wins."""
    cfg = AT.choose_block_elementwise(n, "izhikevich_step", batch,
                                      attrs=_same(20))
    assert cfg["block"] == 128
    assert cfg["grid"] == (-(-n // 128), batch, 1)


def test_elementwise_takes_a_larger_block_that_scores_better():
    """128 threads at 255 registers: 2 CTAs (8 warps) an SM; 256 threads
    at 32 registers: 8 CTAs (64 warps)."""
    attrs = _same(32)
    attrs[128] = {"numRegs": 255, "sharedSizeBytes": 0}
    cfg = AT.choose_block_elementwise(1_000_000, "izhikevich_step",
                                      attrs=attrs)
    assert cfg["block"] == 256 and cfg["limiter"] == "threads"
    assert AT.occupancy(128, 255, 0)["ctas"] == 2


def test_elementwise_grid_stride_and_overflow():
    cfg = AT.choose_block_elementwise(10 ** 9, "hh_step", 2,
                                      attrs=_same(30), grid_x_max=4096)
    assert cfg["grid"] == (4096, 2, 1)
    with pytest.raises(ValueError, match="axis x"):
        AT.choose_block_elementwise(1024 * (2 ** 31), "threefry_draw",
                                    attrs=_same(30))
    with pytest.raises(ValueError, match="axis y"):
        AT.choose_block_elementwise(10, "threefry_draw", 65536,
                                    attrs=_same(30))


def test_spmv_takes_the_smallest_rows_of_a_tie_and_reads_registers():
    cfg = AT.choose_block_spmv(80_000, 1000, 80_000, 1, attrs={})
    assert cfg["rows"] == cfg["block"] == 128 and cfg["feasible"]
    assert cfg["smem_bytes"] == AT.spmv_smem_bytes(128) == 4368
    # registers that leave a 128-row CTA a third of the SM's warps move
    # the choice to where the CTAs hold more warps
    regs = {128: {"numRegs": 168}, 256: {"numRegs": 40},
            512: {"numRegs": 40}}
    cfg = AT.choose_block_spmv(1_000_000, 100, 1000, 8, attrs=regs)
    assert cfg["rows"] == 256 and cfg["feasible"]


SPMV_EDGES = [
    # (batch, n_pre, k, n_post, n_slots)
    (8 * 65535, 100, 8, 100, None),
    (8 * 65535 + 1, 100, 8, 100, None),
    (1, 100, K.K_MAX, 100, None),
    (1, 100, K.K_MAX + 1, 100, None),
    (1, 2 ** 31 - 1, 8, 100, None),
    (1, 2 ** 31, 8, 100, None),
    (8 * 65535, 100, 8, 2 ** 31 - 1, 2),
    (8 * 65535, 100, 8, 2 ** 31 - 1, 65535),
    (1, 100, 8, 100, 2 ** 31),
]


@pytest.mark.parametrize("shape", SPMV_EDGES, ids=str)
def test_spmv_feasible_exactly_where_launch_plan_raises(shape):
    batch, n_pre, k, n_post, n_slots = shape
    cfg = AT.choose_block_spmv(n_pre, k, n_post, batch, n_slots, attrs={})
    try:
        plan = K.launch_plan(batch, n_pre, k, n_post, n_slots=n_slots)
    except ValueError as e:
        assert not cfg["feasible"] and cfg["reason"] == str(e)
    else:
        assert cfg["feasible"]
        assert plan["rows_per_cta"] == cfg["rows"]
        assert plan["smem_bytes"] == cfg["smem_bytes"]


def test_fold_plan_reads_the_model():
    plan = DR.launch_plan(8, 21, 80_000)
    cfg = AT.choose_block_elementwise(20_000 * 8, "delay_ring_fold<4>", 21,
                                      attrs={})
    assert (plan["block"], plan["grid"]) == (cfg["block"], cfg["grid"])


def test_choices_record_trace_instants():
    trace.clear()
    AT.choose_block_spmv(1000, 10, 100, 1, tag="g:sparse", attrs={})
    ev = trace.events()[-1]
    assert ev["name"] == "choose_block_spmv" and ev["ph"] == "i"
    jkeys = {"tag", "n_pre", "k", "n_post", "b", "n_slots", "occupancy",
             "grid", "feasible"}
    assert jkeys <= set(ev["args"])
    assert {"rows", "block", "smem_bytes", "limiter"} <= set(ev["args"])
    assert ev["args"]["tag"] == "g:sparse"


# -- dense vs event -----------------------------------------------------------

# (n_pre, K, n_post, n_slots): the fault's two groups (200 -> 20000 at
# FixedFanout 10, 20000 -> 20000 at 100), the main path's undelayed
# exc->exc and inh->exc, the mushroom body's KC->DN at 100k KCs
AGREED = [(200, 10, 20_000, 1), (20_000, 100, 20_000, 1),
          (80_000, 800, 80_000, 1), (20_000, 200, 80_000, 1),
          (100_000, 100, 100, 1), (1000, 40, 1000, 1), (512, 64, 512, 1)]


@pytest.mark.parametrize("shape", AGREED, ids=str)
def test_choose_propagation_equals_the_jax_package(shape):
    n_pre, k, n_post, n_slots = shape
    port = AT.choose_propagation(n_pre, k, n_post, n_slots=n_slots,
                                 attrs={})
    ref = JAT.choose_propagation(n_pre, k, n_post, n_slots=n_slots)
    for key in ("mode", "capacity", "activity", "dense_slots",
                "event_slots"):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("shape,cap", [((80_000, 800, 80_000, 21), 20_000),
                                       ((20_000, 4000, 20_000, 1), 5000)],
                         ids=["delayed_exc_exc", "k4000"])
def test_choose_propagation_where_only_the_tpu_finds_no_tile(shape, cap):
    """The JAX package says "dense" here only because no TPU tile fits its
    16 MiB of VMEM (occupancy 0.0); on the card the live-row kernel runs
    the compacted problem, and the port says "event"."""
    n_pre, k, n_post, n_slots = shape
    ref = JAT.choose_propagation(n_pre, k, n_post, n_slots=n_slots)
    port = AT.choose_propagation(n_pre, k, n_post, n_slots=n_slots,
                                 attrs={})
    assert (ref["mode"], ref["event_occupancy"]) == ("dense", 0.0)
    assert (port["mode"], port["capacity"]) == ("event", cap)
    assert port["capacity"] == ref["capacity"]
    assert port["event_occupancy"] > 0.0


def _fault_spec(S, F):
    s = S.ModelSpec("fault")
    s.add_neuron_population("pre", 200, "izhikevich")
    s.add_neuron_population("big", 20_000, "izhikevich")
    s.add_neuron_population("post", 20_000, "izhikevich")
    s.add_synapse_population("small", "pre", "post",
                             connect=F.FixedFanout(10), weight=0.5,
                             representation="sparse")
    s.add_synapse_population("large", "big", "post",
                             connect=F.FixedFanout(100), weight=0.5,
                             representation="sparse")
    return s


def test_memory_report_propagation_equals_the_jax_package():
    """The fault: the port reported ("event", None) for both groups."""
    jrep = {r["name"]: r for r in _fault_spec(JSPEC, JF).build(
        dt=1.0, seed=1).memory_report() if "propagation" in r}
    trep = {r["name"]: r for r in _fault_spec(TSPEC, TF).build(
        dt=1.0, seed=1, device="cpu").memory_report() if "propagation" in r}
    assert (jrep["small"]["propagation_mode"],
            jrep["small"]["event_capacity"]) == ("dense", None)
    assert (jrep["large"]["propagation_mode"],
            jrep["large"]["event_capacity"]) == ("event", 5000)
    for name in ("small", "large"):
        for key in ("propagation", "propagation_mode", "event_capacity"):
            assert trep[name][key] == jrep[name][key], (name, key)


def test_occupancy_report_off_the_card():
    rep = AT.occupancy_report(attrs={})
    lines = rep.splitlines()
    assert lines[0] == "workload,block,grid,resident_ctas,occupancy,limiter"
    rows = {ln.split(",")[0]: ln for ln in lines[1:]}
    assert rows["ell_spmv exc->exc"].startswith("ell_spmv exc->exc,128,")
    assert "flash_fwd_wgmma<1>" in rows and "ssd_scan" in rows
