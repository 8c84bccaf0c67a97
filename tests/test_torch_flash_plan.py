"""The host-side launch plan of repro_torch's flash attention
(``kernels.flash_attention.launch_plan``), on the CPU: which route each
dtype takes, and for the bf16 tensor-core kernels the tiles, ring stages,
shared memory, TMA boxes and grids at every head dim the wrapper takes
(D <= 256, D % 8 == 0).  The kernels check the plan's shared-memory bytes
against their own layout on the card (tests/test_torch_cuda.py); here the
plan itself is held to the card's limits.  No jax: the plan has no
counterpart in the JAX package."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402

SM_BYTES = 233_472            # shared memory of one H100 SM
RESERVED = 1_024              # the runtime's share of every resident CTA
HEAD_DIMS = list(range(8, FA.MAX_HEAD_DIM + 1, 8))
KERNELS = ("fwd", "dkdv", "dq")


def _plan(d, b=2, hq=4, hkv=2, tq=300, tk=300):
    return FA.launch_plan(torch.bfloat16, b, hq, hkv, tq, tk, d)


def test_route_by_dtype():
    bf = FA.launch_plan(torch.bfloat16, 1, 2, 1, 64, 64, 64)
    f32 = FA.launch_plan(torch.float32, 1, 2, 1, 64, 64, 64)
    assert bf["route"] == FA.ROUTES[torch.bfloat16]["route"] == "tensor_cores"
    assert f32 == {"route": FA.ROUTES[torch.float32]["route"]}
    assert f32["route"] == "cuda_cores"
    # the two routes name disjoint kernels, so a profile tells them apart
    names = [set(FA.ROUTES[dt]["fwd"] + FA.ROUTES[dt]["bwd"])
             for dt in (torch.bfloat16, torch.float32)]
    assert not names[0] & names[1]
    with pytest.raises(KeyError):
        FA.launch_plan(torch.float16, 1, 2, 1, 64, 64, 64)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bf16_plan_fits_shared_memory(d):
    """Every kernel's ring holds 2-3 stages (4 for the dK/dV kernel's two
    consumer warpgroups), as many as fit: one more stage would break the
    CTA's shared-memory budget (232,448 bytes, or half an SM where two
    CTAs share one)."""
    p = _plan(d)
    for name in KERNELS:
        k = p[name]
        most = 4 if k.get("consumer_warpgroups") == 2 else 3
        assert 2 <= k["stages"] <= most, (name, k)
        assert k["smem"] <= FA.SMEM_MAX, (name, k)
        assert k["ctas_per_sm"] * (k["smem"] + RESERVED) <= SM_BYTES, (name,
                                                                       k)
        if k["stages"] < most:
            per_stage = (k["smem"] - 1024 - 8) // k["stages"]
            budget = min(FA.SMEM_MAX, SM_BYTES // k["ctas_per_sm"] - RESERVED)
            assert k["smem"] + per_stage > budget, (name, k)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bf16_plan_tiles_and_tma_boxes(d):
    """D is loaded in 64-column boxes (128 bytes: the 128-byte swizzle of
    the wgmma operands), enough of them to cover D with fewer than 64
    columns of zero fill; the contraction over D (rounded up to 16) fits
    the panels.  Forward: 128 queries, 128-key tiles up to D = 128 and 64
    above; backward: 64-row tiles, dK/dV in blocks of at most two panels."""
    p = _plan(d)
    panels = p["panels"]
    assert panels * 64 >= d > (panels - 1) * 64
    assert -(-d // 16) * 16 <= panels * 64
    fwd, dkdv, dq = p["fwd"], p["dkdv"], p["dq"]
    assert fwd["boxes"] == {"q": (64, 128), "kv": (64, fwd["bk"])}
    assert fwd["bq"] == 128 and fwd["bk"] == (128 if d <= 128 else 64)
    assert fwd["threads"] == 384                   # 2 consumer + 1 producer WG
    for k in (dkdv, dq):
        assert k["boxes"] == {"q": (64, 64), "kv": (64, 64)}
        assert k["tile"] == 64
    assert dq["threads"] == 160 and dq["ctas_per_sm"] == (2 if d <= 64 else 1)
    # two consumer warpgroups and a producer one up to D = 64
    assert dkdv["consumer_warpgroups"] == (2 if d <= 64 else 1)
    assert dkdv["threads"] == (384 if d <= 64 else 160)
    assert dkdv["ctas_per_sm"] == 1
    if dkdv["consumer_warpgroups"] == 2:
        # the two warpgroups' float32 dK and dV meet in the Q / dO rings
        ring = 2 * dkdv["stages"] * panels * 64 * 128
        assert ring >= dkdv["col_panels"] * 2 * 64 * 64 * 4
    assert dkdv["col_panels"] == min(panels, 2)
    assert dkdv["grid"][2] * dkdv["col_panels"] >= panels
    # the boxes' rows never exceed what TMA takes (256)
    for k in (fwd, dkdv, dq):
        assert all(1 <= r <= 256 for _, r in k["boxes"].values())


# b, hq, hkv, tq, tk, d -> forward, dK/dV and dQ grids
GRIDS = [
    ((8, 14, 2, 2048, 2048, 64), (112, 16), (16, 32, 1), (112, 32)),
    ((4, 14, 2, 2048, 2048, 64), (56, 16), (8, 32, 1), (56, 32)),
    ((1, 16, 8, 2048, 2048, 256), (16, 16), (8, 32, 2), (16, 32)),
    ((1, 4, 2, 130, 300, 32), (4, 2), (2, 5, 1), (4, 3)),
    ((2, 4, 4, 200, 200, 40), (8, 2), (8, 4, 1), (8, 4)),
    ((1, 2, 1, 96, 96, 112), (2, 1), (1, 2, 1), (2, 2)),
    ((1, 2, 2, 256, 256, 192), (2, 2), (2, 4, 2), (2, 4)),
]


@pytest.mark.parametrize("shape,fwd,dkdv,dq", GRIDS)
def test_bf16_plan_grids(shape, fwd, dkdv, dq):
    """One forward CTA per (batch x query head, 128 queries); one dK/dV CTA
    per (batch x KV head, 64 keys, column block); one dQ CTA per (batch x
    query head, 64 queries): the tiles on grid axis y."""
    p = FA.launch_plan(torch.bfloat16, *shape)
    assert p["fwd"]["grid"] == fwd
    assert p["dkdv"]["grid"] == dkdv
    assert p["dq"]["grid"] == dq


def test_bf16_on_the_cpu_takes_the_plain_version():
    """A bf16 call on CPU tensors computes the plain version and launches
    nothing: the plan is for the card only."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 16, 40, generator=g).bfloat16()
               for _ in range(3))
    FA.reset_launches()
    out = FA.flash_attention(q, k, v, causal=True)
    assert FA.launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


# b·Hq = 4097 x 16 = 65,552: past grid axis y (65535), where the float32
# kernels put b·Hq; the bf16 kernels put it on axis x (2^31 - 1)
BIG_BATCH = (4097, 16, 4, 16, 16, 64)


def _meta(dtype, b, hq, hkv, tq, tk, d):
    return [torch.empty(shape, dtype=dtype, device="meta")
            for shape in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]


def test_bf16_takes_batch_heads_past_grid_axis_y():
    """The bf16 route takes b·Hq > 65535 (the reference takes any batch):
    its plan and the wrapper's checks accept it, the grids carry b·Hq and
    b·Hkv on axis x."""
    p = FA.launch_plan(torch.bfloat16, *BIG_BATCH)
    assert p["fwd"]["grid"] == (65_552, 1)
    assert p["dkdv"]["grid"] == (4097 * 4, 1, 1)
    assert p["dq"]["grid"] == (65_552, 1)
    shape, plan = FA._check(*_meta(torch.bfloat16, *BIG_BATCH), None, None, 0)
    assert shape == BIG_BATCH and plan == p


def test_float32_refuses_batch_heads_past_grid_axis_y():
    """The float32 kernels put b·Hq on grid axis y: past 65535 their plan
    and the wrapper's checks raise; at 65535 they accept."""
    with pytest.raises(ValueError, match="axis y"):
        FA.launch_plan(torch.float32, *BIG_BATCH)
    with pytest.raises(ValueError, match="axis y"):
        FA._check(*_meta(torch.float32, *BIG_BATCH), None, None, 0)
    ok = (4095, 16, 4, 16, 16, 64)          # b·Hq = 65,520
    assert FA._check(*_meta(torch.float32, *ok), None, None, 0)[1] == {
        "route": "cuda_cores"}


def test_bf16_refuses_grids_past_what_a_launch_takes():
    """The bf16 route still raises where its own grids overflow: the tiles
    on axis y, b·Hq on axis x."""
    with pytest.raises(ValueError, match="axis y"):
        FA.launch_plan(torch.bfloat16, 1, 2, 1, 65_536 * 128 + 1, 64, 64)
    with pytest.raises(ValueError, match="axis x"):
        FA.launch_plan(torch.bfloat16, 2 ** 28, 8, 1, 64, 64, 64)
