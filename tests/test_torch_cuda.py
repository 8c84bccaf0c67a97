"""repro_torch's CUDA kernels against their plain PyTorch versions, on a
card.  Marked ``gpu``: they skip where there is none (a CUDA kernel has no
CPU mode).  This file imports no jax, so it runs on a machine with only
PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: rtol=atol=1e-5 for the spmv kernels (atomics sum in another
order than index_add_), exact with integer-valued weights; rtol=atol=2e-4
for the neuron updates, whose spike decisions may differ on under 0.2% of
neurons (the parity contract of tests/test_kernels.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ell_spmv as K  # noqa: E402
from repro_torch.kernels import hh_step as HH  # noqa: E402
from repro_torch.kernels import izhikevich_step as IZ  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NEURON_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(1, 0.01), (4, 1.0)])
def test_cuda_kernels_match_plain(cuda_device, b, p):
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
    K.reset_launches()
    out = K.ell_spmv(g, idx, valid, spk, n_post)
    out_d = K.ell_spmv_delay(g, idx, valid, dly, spk, n_post, n_slots)
    torch.cuda.synchronize()
    assert K.launches == {"ell_spmv": 1, "ell_spmv_delay": 1}
    torch.testing.assert_close(out, TR.ell_spmv_ref(g, idx, valid, spk,
                                                    n_post), **TOL)
    torch.testing.assert_close(
        out_d, TR.ell_spmv_delay_ref(g, idx, valid, dly, spk, n_post,
                                     n_slots), **TOL)
    gi = torch.floor(8 * g)
    assert torch.equal(K.ell_spmv(gi, idx, valid, spk, n_post),
                       TR.ell_spmv_ref(gi, idx, valid, spk, n_post))


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
    for a, e in zip(hout, TR.hh_step_ref(*hh_in, 0.1, substeps=5)):
        torch.testing.assert_close(a, e, **NEURON_TOL)


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
