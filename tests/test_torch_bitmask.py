"""GeNN's 32x spike bitmask in the port (``repro_torch.core.snn.bitmask``
and the plain version of ``kernels/csrc/spike_bitmask.cu``) against the JAX
package's ``repro.core.snn.bitmask``: the port's int32 words hold the JAX
uint32 words' bits exactly (compared through numpy's uint32 view), for
widths on both sides of a word boundary, multi-row inputs and bit 31 set;
unpacking inverts packing.  The kernel itself is held to the plain version
on a card in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.snn import bitmask as JBM  # noqa: E402
from repro_torch.core.snn import bitmask as TBM  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import spike_bitmask as SBK  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and CPU ops
    under several spinning thread pools ran up to ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(shape, p, seed):
    return np.random.default_rng(seed).random(shape) < p


@pytest.mark.parametrize("n", [1, 31, 32, 33, 80001])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_pack_equals_jax_words(n, p):
    bits = _bits((n,), p, n)
    want = np.asarray(JBM.pack_spikes(jnp.asarray(bits)))
    got = TBM.pack_spikes(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert got.shape == want.shape == (JBM.words_for(n),)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert TBM.words_for(n) == JBM.words_for(n)


@pytest.mark.parametrize("shape", [(3, 33), (2, 4, 64), (8, 80001)])
def test_pack_rows_equals_jax_and_unpacks(shape):
    bits = _bits(shape, 0.5, 7)
    want = np.asarray(JBM.pack_rows(jnp.asarray(bits)))
    got = TBM.pack_rows(torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = TBM.unpack_rows(got, shape[-1])
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JBM.unpack_rows(jnp.asarray(want),
                                                 shape[-1])))


def test_bit_31_and_the_sign_of_int32():
    """Neuron 31 of a word is its sign bit: packing sums in int64 and
    wraps once; unpacking masks the arithmetic shift's smear."""
    bits = np.zeros((2, 96), bool)
    bits[0, 31] = bits[0, 63] = True            # bit 31 of words 0 and 1
    bits[1, :] = True                           # every bit: -1 as int32
    got = TBM.pack_spikes(torch.from_numpy(bits))
    assert got[0].tolist() == [-2 ** 31, -2 ** 31, 0]
    assert got[1].tolist() == [-1, -1, -1]
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32), np.asarray(JBM.pack_rows(
            jnp.asarray(bits))))
    back = TBM.unpack_spikes(got, 96).numpy()
    np.testing.assert_array_equal(back, bits)
    # JAX words unpack in the port too (through the same bits)
    jw = np.asarray(JBM.pack_rows(jnp.asarray(bits))).view(np.int32)
    np.testing.assert_array_equal(
        TBM.unpack_rows(torch.from_numpy(jw.copy()), 96).numpy(), bits)


def test_trailing_bits_are_zero_and_segments_concatenate():
    bits = _bits((4, 45), 1.0, 0)
    words = TBM.pack_rows(torch.from_numpy(bits))
    # 45 bits: the second word keeps 13 ones and 19 zeros
    assert (words[:, 1] == (1 << 13) - 1).all()
    seg = TBM.unpack_segments(words, 45)
    np.testing.assert_array_equal(seg.numpy(), bits.reshape(-1))
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(JBM.unpack_segments(
            jnp.asarray(words.numpy().view(np.uint32)), 45)))


def test_non_bool_inputs_pack_as_nonzero():
    f = torch.tensor([[0.0, 2.0, 0.0, -1.0]])
    assert TBM.pack_spikes(f).tolist() == [[0b1010]]


def test_cpu_wrapper_takes_the_plain_version_without_a_launch():
    bits = torch.from_numpy(_bits((2, 70), 0.4, 3))
    SBK.reset_launches()
    words = kops.pack_spikes(bits)
    assert torch.equal(words, TR.spike_bitmask_ref(bits))
    ring = torch.zeros((5, 2, 3), dtype=torch.int32)
    kops.pack_spikes_into(bits, ring, 3)
    assert torch.equal(ring[3], words) and not ring[:3].any()
    # a device-tensor slot and active flag: index ops only
    slot = torch.tensor(1, dtype=torch.int32)
    kops.pack_spikes_into(bits, ring, slot, torch.tensor(False))
    assert not ring[1].any()
    kops.pack_spikes_into(bits, ring, slot, torch.tensor(True))
    assert torch.equal(ring[1], words)
    assert SBK.launches["spike_bitmask"] == 0
    with pytest.raises(ValueError):
        kops.pack_spikes_into(bits, ring, 2, torch.tensor(True))
