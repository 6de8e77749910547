"""The port's SSB, CW and DIG receivers against the JAX package on the CPU.

The demods (demod/ssb.py) against pebblesdr_tpu.demod.ssb, exactly; the
Receiver for USB, LSB, CWU and DIGL against the JAX Receiver (the harness of
torch_parity.py: one step() warm-up, the state carried across, dispatches of
K = 3 and 9, bounds of tests/test_chain_batched.py:58-69); and
tests/test_chain.py:111-139's tone checks on the port's own CPU Receiver.
These modes' composed front response (factor 64, 2007 taps) is one the CUDA
front_fir runs on items of 4 channels (ops/front.py fir_march_layout).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.demod import ssb as jssb
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import ssb
from pebblesdr_tpu_torch.demod.modes import DemodMode

# mode -> the tone's offset from the carrier (inside the mode's passband)
MODES = {DemodMode.USB: 1500.0, DemodMode.LSB: -1500.0,
         DemodMode.CWU: 1000.0, DemodMode.DIGL: -1500.0}
KS = (3, 9)


@pytest.mark.parametrize("name", ["usb_demod", "lsb_demod", "dsb_demod"])
def test_demods_match_jax(name):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 4096))
         + 1j * rng.standard_normal((4, 4096))).astype(np.complex64)
    want = np.asarray(getattr(jssb, name)(jnp.asarray(x)))
    got = getattr(ssb, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module", params=list(MODES), ids=lambda m: m.name)
def runs(request):
    off = MODES[request.param]
    return tp.run(request.param, lambda k, s: tp.tone_plane(k, s, off), KS)


@pytest.mark.parametrize("run", ["step", *KS])
def test_audio(runs, run):
    scale = tp.check_audio(*runs[run][:2])
    if run == 9:
        assert scale > 0.1       # the compared audio is not all delay


@pytest.mark.parametrize("run", ["step", *KS])
def test_spectra_smeter_and_squelch(runs, run):
    jo, to, _, _ = runs[run]
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)


@pytest.mark.parametrize("run", KS)
def test_carried_state(runs, run):
    _, _, js, ts = runs[run]
    tp.check_state(js, ts)


def _tone_audio(mode: DemodMode, k: int) -> tuple[Receiver, np.ndarray]:
    """Channel 0's audio of the port's CPU Receiver for a 0.4 tone at
    carrier + 1.5 kHz (the carrier at 400 kHz, AGC off), k blocks."""
    rx = Receiver(ReceiverConfig(sample_rate=tp.FS, frames_per_buffer=tp.N,
                                 mode=mode, agc_mode="off"), "cpu")
    t = np.arange(k * tp.N) / tp.FS
    iq = 0.4 * np.exp(2j * np.pi * (400_000.0 + 1500.0) * t)
    x = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    _, out = rx.step_many(rx.init_state(), rx.default_params(400_000.0),
                          torch.from_numpy(x))
    return rx, out["audio"][:, 0].reshape(-1).numpy()


def test_usb_tone():
    rx, audio = _tone_audio(DemodMode.USB, 8)
    tail = audio[-4 * rx.audio_blk:].astype(np.float64)
    amp, resid = tp.tone_fit(tail, 1500.0, 48000.0)
    snr = 10 * np.log10(amp ** 2 / 2 / max(np.mean(resid ** 2), 1e-20))
    # I+Q of A e^{jwt} = A sqrt(2) sin(wt + pi/4)
    assert amp == pytest.approx(0.4 * np.sqrt(2.0), rel=0.1)
    assert snr > 40


def test_lsb_rejects_usb_signal():
    rx, audio = _tone_audio(DemodMode.LSB, 6)
    assert np.sqrt(np.mean(audio[-2 * rx.audio_blk:] ** 2)) < 0.02


def test_ssb_front_runs_factor_64():
    """USB's decimation (20 kHz protected) is factor 64, its composed
    response 2007 taps, and 32 kHz audio resamples to 768 samples a block."""
    rx = Receiver(ReceiverConfig(sample_rate=tp.FS, frames_per_buffer=32768,
                                 mode=DemodMode.USB), "cpu")
    assert (rx.plan.factor, rx.front.h.numel()) == (64, 2007)
    assert (rx.demod_rate, rx.audio_blk) == (32000, 768)
    assert rx.init_state().demod is None
