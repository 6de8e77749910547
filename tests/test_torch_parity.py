"""The port's whole-chain parity harness (pebblesdr_tpu_torch/tools/
parity_harness.py) against the JAX package's (tools/parity_harness.py):
its float64 scipy goldens, snr_db and fixture equal the originals on the
same seeded inputs (within 1e-12 of scale: both are float64 scipy), and
the port's chain on the CPU, block by block through Receiver.step at one
channel, meets tests/test_parity.py's thresholds on its signals (LSB as
USB; FMM at the JAX chain's SNR less 3 dB).  The batched path is in
tests/test_torch_parity_batched.py."""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from pebblesdr_tpu.chain.receiver import (  # noqa: E402
    Receiver as JaxReceiver, ReceiverConfig as JaxConfig)
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode  # noqa: E402
from pebblesdr_tpu.ops import pll as jpll  # noqa: E402
from pebblesdr_tpu_torch.chain.receiver import (  # noqa: E402
    Receiver, ReceiverConfig)
from pebblesdr_tpu_torch.demod.modes import DemodMode  # noqa: E402
from pebblesdr_tpu_torch.ops import pll as tpll  # noqa: E402
from pebblesdr_tpu_torch.tools import parity_harness as ph  # noqa: E402
from tools import parity_harness as jph  # noqa: E402

FS = 2_048_000
MODES = [m.name for m in ph.GOLDEN_MODES]
# tests/test_parity.py's carrier per mode (the tune; SAM's signal sits
# 200 Hz above it); LSB as USB, FMM as FMS
CARRIER = {"AM": 250_000.0, "USB": 400_000.0, "LSB": 400_000.0,
           "FMN": 150_000.0, "SAM": 250_000.0, "FMS": 300_000.0,
           "FMM": 300_000.0}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the chain's ops are small, and the suite runs
    several workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= rtol, err


def receivers(name: str, frames: int = 32768):
    """(the port's Receiver on the CPU, the JAX Receiver) of one mode."""
    t = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=frames,
                                mode=DemodMode[name], agc_mode="off"), "cpu")
    j = JaxReceiver(JaxConfig(sample_rate=FS, frames_per_buffer=frames,
                              mode=JaxMode[name], agc_mode="off"))
    return t, j


def noisy_capture(name: str, seconds: float = 0.25, seed: int = 1):
    """The mode's parity signal at its carrier plus seeded complex noise."""
    n = int(FS * seconds)
    iq = ph.mode_signal(DemodMode[name], FS, n, CARRIER[name], 0.3)
    rng = np.random.default_rng(seed)
    iq = iq + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64)


def jax_golden(name: str, iq, tune: float, jrx):
    if name == "FMN":
        return jph.scipy_golden_nfm(iq, FS, tune, jrx)
    if name == "SAM":
        return jph.scipy_golden_sam(iq, FS, tune, jrx)
    if name in ("FMM", "FMS"):
        return jph.scipy_golden_wfm(iq, FS, tune, jrx, stereo=name == "FMS",
                                    return_stereo=name == "FMS")
    return jph.scipy_golden(iq, FS, tune, JaxMode[name], jrx.info.lo_cut,
                            jrx.info.hi_cut, jrx.info.max_output_bw,
                            jrx.cfg.audio_rate, jrx.blk)


@pytest.mark.parametrize("name", MODES)
def test_golden_matches_jax(name):
    """Each mode's golden, from the port's Receiver and copies of the plan
    and taps, equals the JAX harness's from the JAX Receiver; also with the
    DC removal formed once and passed in."""
    trx, jrx = receivers(name)
    iq = noisy_capture(name)
    tune = CARRIER[name]
    want = jax_golden(name, iq, tune, jrx)
    for x_dc in (None, ph.dc_removed64(iq)):
        got = ph.golden(iq, FS, tune, trx, x_dc=x_dc)
        close(got, want)


@pytest.mark.parametrize("protect", [30_000.0, 20_000.0, 200_000.0])
def test_front_bandpass_resample_match_jax(protect):
    iq = noisy_capture("AM", 0.1)
    x, rate = ph._front64(iq, FS, 123_456.0, protect)
    jx, jrate = jph._front64(iq, FS, 123_456.0, protect)
    assert rate == jrate
    close(x, jx)
    close(ph._bandpass64(x, rate, -3000.0, 5000.0, 1024),
          jph._bandpass64(jx, jrate, -3000.0, 5000.0, 1024))
    close(ph._resample64(x.real, rate, 48_000),
          jph._resample64(jx.real, jrate, 48_000))


@pytest.mark.parametrize("detector", ["atan2", "costas", "cross", "pilot"])
def test_pll64_matches_jax(detector):
    rng = np.random.default_rng(2)
    n = 4096
    t = np.arange(n) / 64_000.0
    x = (np.exp(2j * np.pi * 170.0 * t)
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    kw = dict(bw_hz=100.0, zeta=0.707, range_hz=1000.0, detector=detector)
    got = ph._pll64(tpll.make_pll_config(64_000.0, **kw), x)
    want = jph._pll64(jpll.make_pll_config(64_000.0, **kw), x)
    close(got, want)


def test_snr_db_matches_jax():
    rng = np.random.default_rng(3)
    ref = rng.standard_normal(20_000)
    got = np.convolve(ref, [0.1, 0.9, -0.05], mode="same") \
        + 1e-4 * rng.standard_normal(20_000)
    for skip in (0, 4_000):
        assert ph.snr_db(ref, got, skip) == pytest.approx(
            jph.snr_db(ref, got, skip), rel=1e-12)


def test_fixture_matches_jax(tmp_path, capsys):
    """The default fixture is the JAX harness's, byte for byte."""
    ph.make_fixture(str(tmp_path / "port.wav"))
    jph.make_fixture(str(tmp_path / "jax.wav"))
    assert (tmp_path / "port.wav").read_bytes() == \
        (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("name", MODES)
def test_chain_step_matches_golden(name):
    """tests/test_parity.py's signal (1 s, one carrier) through Receiver.step
    block by block at one channel on the CPU, held to the golden with the
    test's skip and threshold; FM stereo's golden must demux (> 30 dB)."""
    mode = DemodMode[name]
    tune = CARRIER[name]
    iq = ph.parity_capture(mode, FS, FS, [tune])
    got, rx = ph.run_chain(iq, FS, mode, [tune], 32768, "cpu")
    assert got.shape[0] == 1 and got.shape[-1] == 62 * rx.audio_blk
    ref = ph.golden(iq, FS, tune, rx)
    if mode == DemodMode.FMS:
        sep = ph.separation_db(ref[0], ref[1], rx.cfg.audio_rate, 1000.0)
        assert sep > ph.GOLDEN_SEPARATION_DB, sep
        ref, got = ref[0], got[:, 0]
    snr = ph.snr_db(ref, got[0], ph.skip_samples(rx))
    assert snr > ph.MIN_SNR_DB[mode], f"{name} parity SNR {snr:.1f} dB"


def test_main_needs_a_card_without_device_cpu(tmp_path, capsys):
    """No fallback: without --device cpu the harness wants the card and,
    without one, stops naming the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "fix.wav")
    ph.make_fixture(path, seconds=0.1)
    with pytest.raises(SystemExit) as exc:
        ph.main([path])
    assert exc.value.code != 0
    assert "--device cuda: no CUDA device" in capsys.readouterr().err


def test_main_on_the_cpu(tmp_path, capsys):
    """The fixture through step_many at two channels, K = 31, on the CPU."""
    path = str(tmp_path / "fix.wav")
    assert ph.main(["--make-fixture", path]) == 0
    assert ph.main([path, "--device", "cpu", "--channels", "2", "--blocks",
                    "31", "--batched", "--min-snr", "60"]) == 0
    out = capsys.readouterr().out
    assert "over 2 channel(s) (step_many K=31 on cpu)" in out and "PASS" in out
