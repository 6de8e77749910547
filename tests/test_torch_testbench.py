"""The port's TestBench and TriggeredCapture (pebblesdr_tpu_torch/chain/
testbench.py) on the CPU: the checks of tests/test_testbench.py (a -40 dB
tone read at -40 +- 1 dB on the raw_iq tap, -60 dB noise, the taps flowing
through the chain, save), the history against the JAX TestBench's with a
tone and with a sweep injected (every recorded tap and the audio within
2e-4, the staged-slice bound of tests/test_torch_receiver_staged.py), and
TriggeredCapture's captures equal to the JAX package's on the same feeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.chain import testbench as jtb
from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.chain.testbench import TestBench, TriggeredCapture
from pebblesdr_tpu_torch.demod.modes import DemodMode

FS, N = 512_000, 8192
TOL = 2e-4
KW = dict(sample_rate=FS, frames_per_buffer=N, agc_mode="off")


def _rx(**kw):
    return Receiver(ReceiverConfig(mode=DemodMode.AM, taps=True,
                                   **{**KW, **kw}), "cpu")


def _silence():
    return torch.zeros(1, N, dtype=torch.complex64)


def test_requires_taps():
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **KW), "cpu")
    with pytest.raises(ValueError):
        TestBench(rx)


def test_injected_tone_at_calibrated_level():
    """A -40 dB tone injected into silence reads -40 dB on the raw_iq tap's
    spectrum (the reference's calibrated-injection check)."""
    rx = _rx()
    tb = TestBench(rx, inject=("tone", {"freq_hz": 100_000.0, "db": -40.0}))
    state, params = rx.init_state(), rx.default_params(100_000.0)
    for _ in range(4):
        state, _ = tb.step(state, params, _silence())
    freqs, db = tb.tap_spectrum_db("raw_iq", FS)
    peak = np.argmax(db)
    assert abs(freqs[peak] - 100_000.0) < FS / 4096
    assert db[peak] == pytest.approx(-40.0, abs=1.0)


def test_noise_injection_floor():
    rx = _rx()
    tb = TestBench(rx, inject=("noise", {"db": -60.0}))
    state, params = rx.init_state(), rx.default_params(0.0)
    for _ in range(4):
        state, _ = tb.step(state, params, _silence())
    x = tb.tap("raw_iq")[0]
    assert 10 * np.log10(np.mean(np.abs(x) ** 2)) == pytest.approx(-60.0,
                                                                   abs=1.0)


def test_taps_flow_through_chain():
    rx = _rx()
    tb = TestBench(rx, inject=("tone", {"freq_hz": 100_000.0, "db": -20.0}))
    state, params = rx.init_state(), rx.default_params(100_000.0)
    for _ in range(3):
        state, _ = tb.step(state, params, _silence())
    assert set(tb.history) >= {"raw_iq", "post_mixer", "post_bp",
                               "post_demod", "audio"}
    assert tb.blocks == 3 and len(tb.history["post_bp"]) == 3
    # post_mixer: the tone tuned to DC
    freqs, db = tb.tap_spectrum_db("post_mixer", rx.demod_rate)
    assert abs(freqs[np.argmax(db)]) < rx.demod_rate / 1024


def test_save(tmp_path):
    rx = _rx()
    tb = TestBench(rx, inject=("sweep", {"start_hz": -100e3,
                                         "stop_hz": 100e3,
                                         "rate_hz_per_sec": 1e7,
                                         "db": -30.0}))
    state, _ = tb.step(rx.init_state(), rx.default_params(0.0), _silence())
    path = str(tmp_path / "taps.npz")
    tb.save(path)
    data = np.load(path)
    assert "raw_iq_re" in data and "audio" in data
    assert data["raw_iq_re"].shape == (1, N)


@pytest.mark.parametrize("inject", [
    ("tone", {"freq_hz": 100_300.0, "db": -20.0}),
    ("sweep", {"start_hz": 90e3, "stop_hz": 110e3, "rate_hz_per_sec": 4e6,
               "db": -20.0, "pulse_on_samples": 3000,
               "pulse_period_samples": 5000})], ids=["tone", "sweep"])
def test_history_matches_jax(inject):
    """The same injection into the same capture through both packages'
    TestBench: every tap of every block and the audio within 2e-4."""
    jrx = JaxReceiver(JaxConfig(mode=JaxMode.AM, taps=True, **KW))
    jbench = jtb.TestBench(jrx, inject=inject)
    tbench = TestBench(_rx(), inject=inject)
    rng = np.random.default_rng(2)
    js, jp = jrx.init_state(), jrx.default_params(100_000.0)
    ts, tp = tbench.rx.init_state(), tbench.rx.default_params(100_000.0)
    for _ in range(3):
        x = (1e-3 * (rng.standard_normal((1, N))
                     + 1j * rng.standard_normal((1, N)))).astype(np.complex64)
        js, _ = jbench.step(js, jp, jnp.asarray(x))
        ts, _ = tbench.step(ts, tp, torch.from_numpy(x))
    assert set(jbench.history) == set(tbench.history)
    for name in jbench.history:
        a, b = jbench.tap(name), tbench.tap(name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.abs(a - b).max() < TOL, (name, np.abs(a - b).max())
    assert np.abs(tbench.tap("post_bp")).max() > 1e-3


FEEDS = {
    "rising normal": (dict(mode="normal", level=0.5, slope="rising",
                           n_pre=64, n_post=256),
                      np.sin(2 * np.pi * 100.0 * np.arange(8192) / 48000.0),
                      1024),
    "falling": (dict(mode="normal", level=-0.2, slope="falling", n_pre=32,
                     n_post=64), np.sin(2 * np.pi * np.arange(4096) / 256.0),
                4096),
    "single": (dict(mode="single", level=0.0, n_pre=16, n_post=32),
               np.sin(2 * np.pi * np.arange(4096) / 128.0), 4096),
    "step across a block": (dict(mode="normal", level=0.5, n_pre=100,
                                 n_post=200),
                            np.r_[np.zeros(1000), np.ones(1048)], 1050),
    "complex": (dict(mode="normal", level=0.0, n_pre=8, n_post=16),
                np.exp(2j * np.pi * np.arange(2048) / 256.0), 512),
    "free": (dict(mode="free", n_pre=16, n_post=48), np.arange(300.0), 100),
}


@pytest.mark.parametrize("case", list(FEEDS))
def test_triggered_capture_matches_jax(case):
    kw, sig, blk = FEEDS[case]
    dtype = np.complex64 if np.iscomplexobj(sig) else np.float32
    sig = sig.astype(dtype)
    got, want = TriggeredCapture(**kw), jtb.TriggeredCapture(**kw)
    for i in range(0, len(sig), blk):
        assert got.feed(sig[i:i + blk]) == want.feed(sig[i:i + blk])
    if kw["mode"] == "single":
        got.rearm()
        want.rearm()
        assert got.feed(sig) == want.feed(sig)
    assert len(got.captures) == len(want.captures) > 0
    for a, b in zip(got.captures, want.captures):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if kw["mode"] != "free":
        up = kw.get("slope", "rising") == "rising"
        for cap in got.captures:
            pre, at = cap[kw["n_pre"] - 1].real, cap[kw["n_pre"]].real
            assert (pre < kw["level"] <= at) if up else \
                (pre >= kw["level"] > at)
    with pytest.raises(ValueError):
        TriggeredCapture(mode="auto")
