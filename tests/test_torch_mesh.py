"""The port's mesh (``repro_torch.launch.mesh``) and neuron-axis sharding
(``launch/sharding.py``) at 1, 2 and 8 gloo ranks, and without ranks.

The collectives under the JAX names (``all_gather`` tiled and stacked,
``psum`` / ``pmax`` / ``pmin`` on integers, floats and bools,
``all_to_all`` over either axis), the engine's spike exchange (bitmask
words gathered [D, B, W] and unpacked equal the gathered bool segments:
the gathered axis is rank-major, members kept apart), the refusals (no
fallback: another world size, rank, backend or device raises), and the
padding helpers against the JAX package's.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_mesh_cases as C  # noqa: E402
from _torch_dist import run_ranks  # noqa: E402
from repro.core.snn import bitmask as JBM  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro_torch.core.snn import bitmask as BM  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402

CASES = Path(C.__file__).resolve()


@pytest.fixture(scope="module", params=[1, 2, 8], ids=lambda d: f"D{d}")
def ranks(request, tmp_path_factory):
    return run_ranks(CASES, request.param,
                     tmp_path_factory.mktemp(f"mesh_D{request.param}"))


def test_collectives(ranks):
    D = ranks.world
    xs = [C._x(r) for r in range(D)]
    fs = [C._x(r, torch.float32) / 7.0 for r in range(D)]
    bs = [torch.tensor([r % 2 == 0, r == 0, True]) for r in range(D)]
    for r, res in enumerate(ranks.local("collectives")):
        got = res["local"]
        assert got["axis_index"] == r
        assert got["shape"] == {"neuron": D}
        assert got["axis_names"] == ("neuron",)
        assert torch.equal(got["tiled"], torch.cat(xs))
        assert torch.equal(got["stacked"], torch.stack(xs))
        assert torch.equal(got["gather_bool"], torch.stack(bs))
        assert torch.equal(got["psum"], sum(xs))
        assert torch.equal(got["pmax"], torch.stack(xs).amax(0))
        assert torch.equal(got["pmin"], torch.stack(xs).amin(0))
        torch.testing.assert_close(got["psum_f"], sum(fs), rtol=1e-6,
                                   atol=1e-5)
        assert torch.equal(got["pmax_f"], torch.stack(fs).amax(0))
        assert torch.equal(got["any"], torch.stack(bs).any(0))
        assert torch.equal(got["all"], torch.stack(bs).all(0))
        # all_to_all: row s of rank q's operand (10 q + s) lands on rank s
        want = (10 * torch.arange(D) + r).reshape(-1, 1).expand(-1, 2)
        assert torch.equal(got["a2a"], want)
        assert torch.equal(got["a2a_cols"], want.t())
        assert torch.equal(got["x_after"], xs[r])


def test_spike_exchange_keeps_members_apart(ranks):
    for res in ranks.local("spike_exchange"):
        got = res["local"]
        assert got["full"].shape == (3, 45 * ranks.world)
        assert torch.equal(got["full"], got["want"])


def test_no_fallback(ranks):
    for r, res in enumerate(ranks.local("errors")):
        got = res["local"]
        for name in ("world", "rank", "backend", "cuda_mesh", "resize",
                     "a2a_axis"):
            assert got[name] is not None, (r, name)
        assert "gloo" in got["backend"] and "cuda" in got["cuda_mesh"]
        assert got["again"] == (r, ranks.world)
        assert got["mesh_again"] == (f"Mesh(neuron={ranks.world}, rank={r}, "
                                     "device='cpu', backend='gloo')")


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

def test_a_card_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_snn_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_snn_mesh(device="cuda")


def test_many_ranks_need_a_rendezvous(monkeypatch):
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already up in this process")
    with pytest.raises(RuntimeError, match="rendezvous"):
        M.init_distributed(world_size=2)
    with pytest.raises(ValueError, match="outside"):
        M.init_distributed(rank=3, world_size=2)


@pytest.mark.parametrize("n,d", [(10, 4), (8, 4), (1, 8), (37, 8), (5, 1)])
def test_padding_equals_jax(n, d):
    assert SH.neuron_pad(n, d) == JSH.neuron_pad(n, d)
    x = np.arange(n * 2, dtype=np.float32).reshape(2, n)
    npad = SH.neuron_pad(n, d)
    got = SH.pad_neuron_axis(torch.as_tensor(x), npad, axis=1)
    want = JSH.pad_neuron_axis(jnp.asarray(x), npad, axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_snn_axis_and_shardings():
    assert M.snn_axis(SimpleNamespace(axis_names=("neuron",))) == "neuron"
    assert M.snn_axis(SimpleNamespace(axis_names=("x",))) == "x"
    with pytest.raises(ValueError, match="neuron"):
        M.snn_axis(SimpleNamespace(axis_names=("a", "b")))
    sh = SH.snn_shardings("neuron")
    assert sh["block"] == ("neuron", None, None)
    assert sh["ring"][-1] == "neuron" and sh["replicated"] == (None,)


def test_unpack_segments_of_stacked_members():
    """[D, W] as the JAX package's; [D, B, W] member by member."""
    rng = np.random.default_rng(0)
    bits = rng.random((4, 3, 45)) < 0.4             # [D, B, seg]
    words = BM.pack_spikes(torch.as_tensor(bits))   # [D, B, W]
    got = BM.unpack_segments(words, 45)
    assert torch.equal(got, torch.as_tensor(
        np.concatenate(list(bits), axis=-1)))
    for b in range(3):
        jw = np.asarray(words[:, b]).view(np.uint32)
        want = JBM.unpack_segments(jnp.asarray(jw), 45)
        np.testing.assert_array_equal(BM.unpack_segments(words[:, b], 45)
                                      .numpy(), np.asarray(want))
