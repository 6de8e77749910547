"""The AM receiver of the PyTorch port against the JAX Receiver on the CPU.

The JAX reference is built with use_pallas=True (the fused front in interpret
mode, batched step_many), as tests/test_chain_batched.py does, so both
carry the fused-front state layout.  One JAX step() block warms the chain up
(compared against the port's step()); its state is carried into the port
with utils.convert, then two dispatches of K=3 and K=9 blocks (odd K keeps
the JAX time-fold at 1 for C=4) are compared with the bounds of
tests/test_chain_batched.py:58-69: audio 2e-4 absolute, spectra and S-meter
SNR 0.1 dB, squelch equal, every carried state leaf 1e-4.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode
from pebblesdr_tpu_torch.chain import receiver as trx_mod
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.utils import convert

FS, N, C = 2_048_000, 8192, 4
KW = dict(sample_rate=FS, frames_per_buffer=N, channels=C, agc_stride=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def am_plane(k: int, seed: int) -> np.ndarray:
    """[k*N, 2C] packed plane: AM (1 kHz, m=0.8) at 250 kHz, per-channel
    level, plus complex white noise at 1e-2."""
    t = np.arange(k * N) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = 0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
    x = np.stack([iq * (0.5 + 0.2 * i) for i in range(C)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def runs():
    jrx = JaxReceiver(JaxConfig(mode=DemodMode.AM, use_pallas=True, **KW))
    trx = Receiver(ReceiverConfig(**KW), "cpu")
    jp = jrx.default_params(250_000.0)
    tp = convert.params_from_numpy(trx, jleaves(jp))
    res = {}
    x0 = am_plane(1, 7)
    jst, jo = jax.jit(jrx.step)(jrx.init_state(), jp, jnp.asarray(x0))
    tst, to = trx.step(trx.init_state(), tp, torch.from_numpy(x0))
    res["step"] = (jo, to, None, None)
    tst = convert.state_from_numpy(trx, jleaves(jst))
    for k, seed in ((3, 0), (9, 1)):
        x = am_plane(k, seed)
        jst, jo = jrx._step_many_impl(jst, jp, jnp.asarray(x))
        tst, to = trx.step_many(tst, tp, torch.from_numpy(x))
        res[k] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))
    return res


RUNS = ["step", 3, 9]


@pytest.mark.parametrize("run", RUNS)
def test_audio(runs, run):
    jo, to, _, _ = runs[run]
    a, b = np.asarray(jo["audio"]), to["audio"].numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 2e-4
    if run == 9:
        assert np.abs(a).max() > 0.1  # the compared audio is not all delay


@pytest.mark.parametrize("key", ["spectrum", "zoomed"])
@pytest.mark.parametrize("run", RUNS)
def test_spectra(runs, run, key):
    jo, to, _, _ = runs[run]
    a, b = np.asarray(jo[key]), to[key].numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 0.1
    assert np.array_equal(np.asarray(jo["overload"]), to["overload"].numpy())


@pytest.mark.parametrize("run", RUNS)
def test_smeter_and_squelch(runs, run):
    jo, to, _, _ = runs[run]
    assert set(jo["smeter"]) == set(to["smeter"])
    for key in jo["smeter"]:
        assert np.abs(np.asarray(jo["smeter"][key])
                      - to["smeter"][key].numpy()).max() < 0.1, key
    assert np.array_equal(np.asarray(jo["squelch_open"]),
                          to["squelch_open"].numpy())


@pytest.mark.parametrize("run", [3, 9])
def test_carried_state(runs, run):
    _, _, js, ts = runs[run]
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        d = np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max()
        assert d < 1e-4, (i, d)


def test_squelch_hysteresis_closed_form():
    """The closed form == the sequential recurrence, incl. b without a."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        b = torch.from_numpy(rng.random((7, 5)) < 0.3)
        a = torch.from_numpy(rng.random((7, 5)) < 0.6)
        prev = torch.from_numpy(rng.random(5) < 0.5)
        want, o = [], prev
        for k in range(7):
            o = b[k] | (a[k] & o)
            want.append(o)
        assert torch.equal(trx_mod._squelch_hysteresis(b, a, prev),
                           torch.stack(want))


def test_squelch_gates_audio():
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    p = rx.default_params(250_000.0)
    x = torch.from_numpy(am_plane(3, 4))
    _, open_out = rx.step_many(rx.init_state(), p, x)
    shut = type(p)(**{**p.__dict__, "squelch_db": torch.tensor(200.0)})
    _, shut_out = rx.step_many(rx.init_state(), shut, x)
    assert bool(open_out["squelch_open"].all())
    assert not bool(shut_out["squelch_open"].any())
    assert float(shut_out["audio"].abs().max()) == 0.0


def test_input_layouts_agree():
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    p = rx.default_params(250_000.0)
    x = torch.from_numpy(am_plane(3, 5))
    _, ref = rx.step_many(rx.init_state(), p, x)
    cplx = torch.complex(x[:, :C], x[:, C:]).T.reshape(C, 3, N).transpose(0, 1)
    for iq in (x.reshape(3, N, 2 * C), (x[:, :C], x[:, C:]),
               torch.stack([x[:, :C], x[:, C:]]).reshape(2, 3, N, C),
               cplx.contiguous()):
        _, out = rx.step_many(rx.init_state(), p, iq)
        assert torch.equal(out["audio"], ref["audio"])


@pytest.mark.parametrize("bad", ["packed2d", "packed3d", "complex", "pair"])
def test_channel_count_guards(bad):
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    st, p = rx.init_state(), rx.default_params()
    wrong = C + 1
    iq = {"packed2d": torch.zeros(N, 2 * wrong + 1),
          "packed3d": torch.zeros(1, N, 2 * wrong),
          "complex": torch.zeros(1, wrong, N, dtype=torch.complex64),
          "pair": (torch.zeros(N, wrong), torch.zeros(N, wrong))}[bad]
    with pytest.raises(ValueError):
        rx.step_many(st, p, iq)


@pytest.mark.parametrize("iq", [torch.zeros(N, 2 * (C + 1)),
                                torch.zeros(2, N, C + 1),
                                torch.zeros(C + 1, N, dtype=torch.complex64)])
def test_step_channel_guard(iq):
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    with pytest.raises(ValueError, match="channels"):
        rx.step(rx.init_state(), rx.default_params(), iq)


def test_folded_plane_rejected():
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    with pytest.raises(ValueError, match="folded by 2"):
        rx.step_many(rx.init_state(), rx.default_params(),
                     torch.zeros(N, 4 * C))


@pytest.mark.parametrize("kw", [dict(mode=DemodMode.USB),
                                dict(frames_per_buffer=3072),
                                dict(spectrum_bins=4096),
                                dict(agc_mode="long")])
def test_unported_configs_rejected(kw):
    with pytest.raises(ValueError):
        Receiver(ReceiverConfig(**{**KW, **kw}), "cpu")


def test_convert_round_trip():
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    st, _ = rx.step_many(rx.init_state(), rx.default_params(250_000.0),
                         torch.from_numpy(am_plane(1, 6)))
    arrays = convert.state_to_numpy(st)
    back = convert.state_to_numpy(convert.state_from_numpy(rx, arrays))
    assert len(arrays) == len(back)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        convert.state_from_numpy(rx, arrays + [arrays[0]])


def test_port_imports_no_jax():
    """The port runs a CPU step in a fresh interpreter without loading jax."""
    code = (
        "import sys, numpy as np, torch\n"
        "from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig\n"
        "rx = Receiver(ReceiverConfig(sample_rate=2048000, "
        "frames_per_buffer=8192, channels=2), 'cpu')\n"
        "x = torch.from_numpy(np.random.default_rng(0).standard_normal("
        "(8192, 4)).astype(np.float32))\n"
        "st, out = rx.step(rx.init_state(), rx.default_params(250000.0), x)\n"
        "assert out['audio'].shape == (2, rx.audio_blk)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
