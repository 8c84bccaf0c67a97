"""whisper-tiny's server and trainer on the port against the JAX
package's, on the CPU at ``reduced()`` size (4 decoder and 2 encoder
layers, d 128, ``enc_seq`` 16, float32), the JAX weights carried over by
``convert.load_lm_params`` (the model's own parity is
``tests/test_torch_encdec.py``'s).

Tolerances (ROADMAP's parity contract), and why:
- the server's greedy tokens (bf16 caches) equal until JAX's top-2 margin
  falls to 1e-3 (``tests/test_torch_lm_families.py``'s rule: XLA's and
  torch's CPU rsqrt, sin and cos differ in the last bit, and bf16 caches
  carry that into the decode's logits);
- the trainer's audio within 4 float32 ulp (threefry's normal); its losses
  over 3 steps within rtol=1e-5 (``tests/test_torch_train.py``'s).
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import load_lm_params  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "whisper-tiny"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs one worker a core, and small
    CPU ops under several spinning thread pools ran ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The reduced configs and the JAX weights that ``JS.Server(seed=0)``
    and ``JTR.run(seed=0)`` draw (``init_params(cfg, PRNGKey(0))``), as
    numpy leaves, drawn once: the eager draw takes ~7 s."""
    jc, tc = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    arrays = jax.tree.map(np.asarray, JT.init_params(
        jc, jax.random.PRNGKey(0)))
    return jc, tc, arrays


def _drawn(jc, arrays):
    """``JT.init_params`` for the JAX server and trainer: the fixture's
    weights, for the config and key they draw with (asserted)."""
    key0 = np.asarray(jax.random.PRNGKey(0))

    def init(cfg, key):
        assert cfg == jc and np.array_equal(np.asarray(key), key0)
        return jax.tree.map(jnp.asarray, arrays)
    return mock.patch.object(JT, "init_params", init)


def test_server_matches_jax_server(weights):
    """2 requests in one wave over zero audio, bf16 caches (one wave: the
    JAX server compiles its decode step once a batch size)."""
    jc, tc, arrays = weights
    with _drawn(jc, arrays):
        jsrv = JS.Server(ARCH, use_reduced=True, max_batch=2, max_seq=64)
    with mock.patch.object(TT, "init_params", lambda cfg, gen:
                           load_lm_params(cfg, arrays, "cpu")):
        tsrv = TS.Server(ARCH, use_reduced=True, max_batch=2, max_seq=64,
                         device="cpu")
    extra = tsrv._extra(2)["audio"]
    assert extra.dtype == torch.float32 and not extra.any() \
        and tuple(extra.shape) == (2, tsrv.cfg.enc_seq, tsrv.cfg.d_model)
    margins = {}

    def recording(logits, req, _sample=jsrv._sample):
        top2 = np.sort(np.asarray(logits, np.float32))[-2:]
        margins.setdefault(req.rid, []).append(float(top2[1] - top2[0]))
        return _sample(logits, req)

    jsrv._sample = recording
    rng = np.random.default_rng(1)
    pairs = []
    for i, n in enumerate((5, 7)):
        prompt = rng.integers(3, tsrv.cfg.vocab, size=n).tolist()
        pairs.append((JS.Request(rid=i, prompt=prompt, max_new=6),
                      TS.Request(rid=i, prompt=prompt, max_new=6)))
        jsrv.submit(pairs[-1][0])
        tsrv.submit(pairs[-1][1])
    jsrv.run()
    FA.reset_launches()
    finished = tsrv.run()
    assert not any(FA.launches.values())
    compared = 0
    for jr, tr in pairs:
        assert tr.done and len(tr.out) == 6
        for j, (a, b) in enumerate(zip(jr.out, tr.out)):
            if a != b:        # a near tie in JAX: later tokens diverge
                assert margins[jr.rid][j] <= 1e-3, (jr.rid, j, jr.out,
                                                    tr.out)
                break
            compared += 1
    assert compared >= 8, f"only {compared} of 12 tokens compared"
    assert sorted(r.rid for r in finished) == [0, 1]
    assert [w["size"] for w in tsrv.waves] == [2]


def test_trainer_audio_and_losses_match_jax(weights, capsys):
    """Each step's audio is the JAX trainer's draw within 4 ulp; 3 steps
    from the JAX run's own weights give its losses."""
    jc, tc, arrays = weights
    for i in range(3):
        want = np.asarray(0.1 * jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(0), i),
            (2, jc.enc_seq, jc.d_model)))
        got = TTR.extra_inputs(tc, 2, i, 0, "cpu")["audio"].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        assert int(ulp.max()) <= 4, i
    assert TTR.extra_inputs(reduced(get_config("qwen2-0.5b")), 2, 0, 0,
                            "cpu") == {}

    with _drawn(jc, arrays):
        jlosses = JTR.run(ARCH, steps=3, batch=2, seq=32, log_every=1)
    tp = load_lm_params(tc, arrays, "cpu")
    with mock.patch.object(TT, "init_params", lambda cfg, gen: tp):
        tlosses = TTR.run(ARCH, steps=3, batch=2, seq=32, log_every=1,
                          device="cpu")
    assert len(tlosses) == 3 and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert "[train] step     3" in capsys.readouterr().out
