"""The port's entry points run their products in IEEE float32 whatever the
process has set, and give the caller's settings back (utils/precision.py).

On the CPU, torch.set_float32_matmul_precision("medium") makes float32
matmuls one-pass bf16 products.  Under it, the port's AM Receiver (C = 4,
K = 3, torch_parity.py's plane) is held to a run under "highest" within
torch_parity.check_run's bounds (audio 2e-4, spectra and S-meter 0.1 dB,
squelch equal), shifted_power and fir_apply_real_signal give the same bits,
the bank's step_many its "highest" outputs, and each restores "medium" and
the cuDNN flag afterwards.  The bare products do change under "medium"
(checked on the undecorated functions), so the comparison has teeth.  The
card case ("high", TF32) is in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import fir, resampler, spectrum
from pebblesdr_tpu_torch.utils.precision import ieee_float32


@pytest.fixture
def medium():
    """The process at "medium" with cuDNN TF32 on, for the test; "highest"
    and the cuDNN default after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("medium")
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = prev


def assert_caller_settings():
    assert torch.get_float32_matmul_precision() == "medium"
    assert torch.backends.cudnn.allow_tf32


def _am_run(rx, params, planes):
    st = rx.init_state()
    outs = []
    for x in planes:
        st, out = rx.step_many(st, params, torch.from_numpy(x))
        outs.append(out)
    return outs


def test_receiver_under_medium_matches_highest(medium, monkeypatch):
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **tp.KW), "cpu")
    params = rx.default_params(tp.TUNE)
    planes = [tp.tone_plane(3, s, 300.0, am=True) for s in range(3)]
    with ieee_float32():
        ref = _am_run(rx, params, planes)
    seen = []
    apply_many = resampler.apply_many

    def spy(*a, **k):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return apply_many(*a, **k)

    monkeypatch.setattr(resampler, "apply_many", spy)
    got = _am_run(rx, params, planes)
    assert_caller_settings()
    assert seen == [("highest", False, False)] * 3
    for r, g in zip(ref, got):
        tp.check_audio(r, g)
        for key in ("spectrum", "zoomed"):
            assert np.abs(r[key].numpy() - g[key].numpy()).max() < 0.1, key
        for key in r["smeter"]:
            assert np.abs(r["smeter"][key].numpy()
                          - g["smeter"][key].numpy()).max() < 0.1, key
        assert torch.equal(r["squelch_open"], g["squelch_open"])
    assert np.abs(ref[-1]["audio"].numpy()).max() > 0.5   # after the fill


def test_step_restores_the_callers_setting(medium):
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **tp.KW), "cpu")
    x = torch.from_numpy(tp.tone_plane(1, 0, 300.0, am=True))
    rx.step(rx.init_state(), rx.default_params(tp.TUNE), x)
    assert_caller_settings()


def test_shifted_power_pins_ieee(medium):
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((4, 1024))
                          + 1j * np.random.default_rng(1).standard_normal(
                              (4, 1024))).astype(np.complex64))
    with ieee_float32():
        ref = spectrum.shifted_power(x)
        exact = spectrum.shifted_power.__wrapped__(x)
    bare = spectrum.shifted_power.__wrapped__(x)       # at "medium": bf16
    assert torch.equal(spectrum.shifted_power(x), ref)
    assert_caller_settings()
    assert torch.equal(exact, ref)
    assert (bare - ref).abs().max() > 1e-3 * ref.abs().max()


def test_fir_apply_real_signal_pins_ieee(medium):
    taps = np.hanning(63) / np.hanning(63).sum()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 8192)).astype(np.float32))
    tail = torch.zeros(4, 62)
    with ieee_float32():
        ref = fir.fir_apply_real_signal(x, tail, taps, decim=4)[0]
    bare = fir.fir_apply_real_signal.__wrapped__(x, tail, taps, decim=4)[0]
    assert torch.equal(fir.fir_apply_real_signal(x, tail, taps, decim=4)[0],
                       ref)
    assert_caller_settings()
    assert (bare - ref).abs().max() > 1e-4


def test_bank_step_many_pins_ieee(medium):
    fs, n = 2_048_000, 8192
    t = np.arange(2 * n) / fs
    rng = np.random.default_rng(4)
    iq = (0.3 * np.exp(2j * np.pi * 250_000.0 * t)
          * (1 + 0.5 * np.cos(2 * np.pi * 700.0 * t))
          + 1e-2 * (rng.standard_normal(t.size)
                    + 1j * rng.standard_normal(t.size))).astype(np.complex64)
    bank = PfbBankReceiver(fs, n, [250_000.0, -300_000.0], device="cpu")
    x = torch.from_numpy(iq)
    with ieee_float32():
        _, ref = bank.step_many(bank.init_state(), x)
    _, got = bank.step_many(bank.init_state(), x)
    assert_caller_settings()
    assert torch.equal(got["audio"], ref["audio"])
    assert torch.equal(got["smeter"]["snr_db"], ref["smeter"]["snr_db"])


def test_ieee_float32_restores_on_error(medium):
    with pytest.raises(RuntimeError):
        with ieee_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            raise RuntimeError("boom")
    assert_caller_settings()


def test_nested_entry_points_keep_the_outer_setting(medium):
    """A Receiver step inside an entry point (the bank) leaves "highest"
    on until the outer one returns."""
    with ieee_float32():
        with ieee_float32():
            pass
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cudnn.allow_tf32
    assert_caller_settings()
