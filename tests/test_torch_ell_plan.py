"""``kernels.ell_spmv.launch_plan`` on the CPU: what the ELL kernels
(``csrc/ell_spmv.cu``: ``ell_spmv_live_kernel`` and, with ``n_slots``,
``ell_spmv_delay_live_kernel``) launch, the rows a CTA walks from the
occupancy model without the card's registers, held to an H100's limits (232,448 B
of shared memory a CTA, grid axis y <= 65535) at the main path's shapes
and the delay path's 21 slots, at B = 1, 8 and 65535, and at an n_pre that
is no multiple of a CTA's rows.  The kernels themselves run only on a card
(tests/test_torch_cuda.py)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import ell_spmv as K  # noqa: E402

SMEM_LIMIT = 232_448           # H100: shared memory one CTA can use
GRID_Y_LIMIT = 65_535
GRID_X_LIMIT = 2 ** 31 - 1
# the main path's four groups (Izhikevich net, 100k neurons, in-degree
# 1000) and chip_smoke.py's phase 2 matrix
MAIN_SHAPES = [(80_000, 1000, 80_000), (80_000, 1000, 20_000),
               (20_000, 1000, 80_000), (20_000, 1000, 20_000)]


@pytest.mark.parametrize("batch", [1, 8, 65535])
@pytest.mark.parametrize("n_pre,k,n_post", MAIN_SHAPES)
def test_plan_fits_the_card(n_pre, k, n_post, batch):
    plan = K.launch_plan(batch, n_pre, k, n_post)
    gx, gy, gz = plan["grid"]
    assert gz == 1 and 0 < gy <= GRID_Y_LIMIT and 0 < gx <= GRID_X_LIMIT
    assert gx * plan["rows_per_cta"] >= n_pre > (gx - 1) * plan["rows_per_cta"]
    assert gy * plan["members_per_cta"] >= batch
    # the rows a CTA walks come from the occupancy model, among the
    # compiled CTA shapes; off the card (no registers) the threads bound
    # every candidate alike and the smallest CTA wins the tie
    assert plan["block"] == plan["rows_per_cta"] == 128
    assert plan["rows_per_cta"] in AT.SPMV_ROWS
    assert plan["block"] % 32 == 0 and plan["block"] <= 1024
    assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
    # the CTA's LiveSmem: spike values [8][rows] float32, the live-row
    # list [rows] uint16, live rows per warp [rows / 32] int32
    rows = plan["rows_per_cta"]
    assert plan["smem_bytes"] == 4 * 8 * rows + 2 * rows + 4 * (rows // 32)
    assert plan["vec"] == 4
    # a CTA's items (live rows x slots / vec) fit the kernel's 32 bits
    assert plan["rows_per_cta"] * k // plan["vec"] < 2 ** 31


def test_main_path_is_one_wave():
    """80,000 rows at B <= 8: 625 CTAs of 128 rows, one wave of a Hopper's
    132 SMs at 16 resident CTAs an SM."""
    for b in (1, 8):
        plan = K.launch_plan(b, 80_000, 1000, 80_000)
        assert plan["grid"] == (625, 1, 1)
        assert plan["grid"][0] <= 132 * plan["resident_ctas"]
    assert K.launch_plan(9, 80_000, 1000, 80_000)["grid"] == (625, 2, 1)


def test_plan_raises_past_the_grid_and_the_index_range():
    K.launch_plan(8 * GRID_Y_LIMIT, 100, 8, 100)
    with pytest.raises(ValueError, match="axis y"):
        K.launch_plan(8 * GRID_Y_LIMIT + 1, 100, 8, 100)
    with pytest.raises(ValueError, match="slots a row"):
        K.launch_plan(1, 100, K.K_MAX + 1, 100)
    with pytest.raises(ValueError, match="int32"):
        K.launch_plan(1, 2 ** 31, 8, 100)


@pytest.mark.parametrize("k,aligned,vec", [(1000, True, 4), (12, True, 4),
                                           (10, True, 1), (1000, False, 1)])
def test_vector_width(k, aligned, vec):
    assert K.launch_plan(2, 300, k, 50, aligned)["vec"] == vec


@pytest.mark.parametrize("batch", [1, 8, 65535])
@pytest.mark.parametrize("n_pre,k,n_post", MAIN_SHAPES)
def test_delay_plan_is_the_scatter_plan(n_pre, k, n_post, batch):
    """The delay kernel walks the same CTAs; only its target has n_slots
    rows a member."""
    plan = K.launch_plan(batch, n_pre, k, n_post, n_slots=21)
    assert plan["n_slots"] == 21
    free = K.launch_plan(batch, n_pre, k, n_post)
    assert {k: v for k, v in plan.items() if k != "n_slots"} == {
        k: v for k, v in free.items() if k != "n_slots"}
    assert plan["grid"][2] == 1


@pytest.mark.parametrize("k,aligned,vec", [(1000, True, 4), (12, True, 4),
                                           (10, True, 1), (1000, False, 1)])
def test_delay_vector_width(k, aligned, vec):
    assert K.launch_plan(2, 300, k, 50, aligned, n_slots=7)["vec"] == vec


def test_delay_plan_raises_past_its_ranges():
    # the 64-bit index of [B, n_slots, n_post]
    K.launch_plan(8 * GRID_Y_LIMIT, 100, 8, 2 ** 31 - 1, n_slots=2)
    with pytest.raises(ValueError, match="64-bit index"):
        K.launch_plan(8 * GRID_Y_LIMIT, 100, 8, 2 ** 31 - 1,
                      n_slots=GRID_Y_LIMIT)
    with pytest.raises(ValueError, match="int32"):
        K.launch_plan(1, 100, 8, 100, n_slots=2 ** 31)
    with pytest.raises(ValueError, match="axis y"):
        K.launch_plan(8 * GRID_Y_LIMIT + 1, 100, 8, 100, n_slots=21)
    with pytest.raises(ValueError, match="slots a row"):
        K.launch_plan(1, 100, K.K_MAX + 1, 100, n_slots=21)
