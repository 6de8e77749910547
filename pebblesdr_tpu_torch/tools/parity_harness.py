"""Whole-chain parity harness: IQ -> the port's Receiver -> compare with an
independent float64 scipy implementation of the same receive math.

Port of tools/parity_harness.py.  The goldens are copies of that module's
float64 scipy goldens (windowed-sinc / halfband designs, scipy.signal
filtering, numpy demod math): a code path that shares nothing with the
port's float32 chain or its CUDA kernels but the plan and the taps
(ops/decimator.py build_plan, ops/fir.py) and the configuration the
Receiver reads.  The WFM golden designs its own low-pass and recovers the
pilot by the analytic signal, so only the rate bookkeeping is shared.

    python -m pebblesdr_tpu_torch.tools.parity_harness --make-fixture fix.wav
    python -m pebblesdr_tpu_torch.tools.parity_harness fix.wav --mode AM \\
        --tune 250000 [--device cpu] [--channels 64 --blocks 32 --batched]

Every channel is tuned to --tune and held to the one golden.  --batched
runs K = --blocks blocks a dispatch through Receiver.step_many (the main
path), otherwise block by block through Receiver.step.  Runs on the card
unless --device says otherwise (no fallback: --device cuda without a CUDA
device is an error).  Prints the per-channel minimum and median SNR of the
chain against the golden; exits 1 below --min-snr (default 40 dB) on any
channel.
"""

from __future__ import annotations

import argparse
import math
import sys
from fractions import Fraction

import numpy as np
import scipy.signal
import torch

from pebblesdr_tpu_torch.demod.modes import DemodMode, from_string
from pebblesdr_tpu_torch.io import wav
from pebblesdr_tpu_torch.ops import decimator as decim_mod
from pebblesdr_tpu_torch.ops import fir as fir_mod
from pebblesdr_tpu_torch.tools import quality

DC_ALPHA = 0.9999
# the modes with a golden
GOLDEN_MODES = (DemodMode.AM, DemodMode.USB, DemodMode.LSB, DemodMode.FMN,
                DemodMode.SAM, DemodMode.FMM, DemodMode.FMS)
# FMM's reference: the JAX chain's least SNR against this golden (tools/
# parity_harness.py on the CPU) over the FMM signals the port is held to:
# 142.9 dB on tests/test_parity.py's composite at +300 kHz; 140.2 / 140.9
# with two carriers at -+250 kHz (1 s); 141.6 / 143.3 / 137.6 / 143.3 with
# four at -750 / -250 / +250 / +750 kHz (2 dispatches of 32 x 32768 and
# half a block).  At float32's floor the SNR moves by dB with the tones'
# start phase and the neighbours, in both chains.
JAX_FMM_SNR_DB = 137.6
# the least SNR of the chain against the golden: tests/test_parity.py's
# thresholds (AM :37, USB :55, NFM :71, SAM :86, FMS :132 on the left
# channel), LSB as USB, FMM the JAX chain's less 3 dB
MIN_SNR_DB = {DemodMode.AM: 60.0, DemodMode.USB: 60.0, DemodMode.LSB: 60.0,
              DemodMode.FMN: 60.0, DemodMode.SAM: 55.0, DemodMode.FMS: 70.0,
              DemodMode.FMM: JAX_FMM_SNR_DB - 3.0}
# the FM stereo golden's own separation of an L-only program (tests/
# test_parity.py:127): a broken demux in the golden reads ~0 dB
GOLDEN_SEPARATION_DB = 30.0


# ------------------------------------------------------------------ goldens

def dc_removed64(iq: np.ndarray) -> np.ndarray:
    """The goldens' DC removal in float64: x - m, m the one-pole average
    (alpha 0.9999).  Form it once per capture and pass it as x_dc to every
    golden of that capture."""
    x = iq.astype(np.complex128)
    return x - scipy.signal.lfilter([1 - DC_ALPHA], [1, -DC_ALPHA], x)


def _front64(iq: np.ndarray, fs: int, tune_hz: float, protect_bw: float,
             x_dc: np.ndarray | None = None):
    """Shared float64 front end: DC removal -> mix -> halfband cascade.
    Returns (x, rate_out)."""
    x = dc_removed64(iq) if x_dc is None else x_dc
    n = np.arange(len(x))
    x = x * np.exp(-2j * np.pi * tune_hz * n / fs)
    plan = decim_mod.build_plan(fs, protect_bw)
    for st in plan.stages:
        x = scipy.signal.lfilter(st.taps, [1.0], x)[::2]
    return x, plan.rate_out


def _bandpass64(x: np.ndarray, rate: float, lo_cut: float, hi_cut: float,
                blk: int) -> np.ndarray:
    taps = fir_mod.design_bandpass_complex(lo_cut, hi_cut, rate, blk + 1)
    return scipy.signal.lfilter(taps, [1.0], x)


def _resample64(audio: np.ndarray, rate: float, audio_rate: int) -> np.ndarray:
    fr = Fraction(int(audio_rate), int(round(rate)))
    return scipy.signal.resample_poly(audio, fr.numerator, fr.denominator)


def scipy_golden(iq: np.ndarray, fs: int, tune_hz: float, mode: DemodMode,
                 lo_cut: float, hi_cut: float, protect_bw: float,
                 audio_rate: int, blk: int,
                 x_dc: np.ndarray | None = None) -> np.ndarray:
    """AM and USB/LSB golden: front end -> FastFIR bandpass (the same
    windowed-sinc design) -> envelope with a one-pole DC blocker and a
    6 kHz Kaiser low-pass (AM) or I +- Q (USB / LSB) -> resample."""
    x, rate = _front64(iq, fs, tune_hz, protect_bw, x_dc)
    x = _bandpass64(x, rate, lo_cut, hi_cut, blk)
    if mode == DemodMode.AM:
        mag = np.abs(x)
        dc = scipy.signal.lfilter([1 - DC_ALPHA], [1, -DC_ALPHA], mag)
        audio = mag - dc
        lp = fir_mod.design_lowpass_kaiser(6000.0, rate, atten_db=50.0)
        audio = scipy.signal.lfilter(lp, [1.0], audio)
    elif mode == DemodMode.USB:
        audio = x.real + x.imag
    elif mode == DemodMode.LSB:
        audio = x.real - x.imag
    else:
        raise ValueError(f"no scipy golden for {mode}")
    return _resample64(audio, rate, audio_rate)


def _pll64(cfg, x: np.ndarray) -> np.ndarray:
    """Float64 per-sample PLL with the loop's semantics (alpha/beta gains,
    fdev clamp, amp EWMA, detector family): an independent sequential
    implementation of the same loop spec.  Returns the per-sample phase
    USED to mix each sample."""
    dev_lo = cfg.freq_lo - cfg.freq_center
    dev_hi = cfg.freq_hi - cfg.freq_center
    phase = 0.0
    fdev = 0.0
    amp = 1.0
    phases = np.empty(len(x), np.float64)
    two_pi = 2.0 * math.pi
    for i, xt in enumerate(x):
        phases[i] = phase
        amp += 1e-3 * (abs(xt) - amp)
        if cfg.detector == "pilot":
            a_half = max((math.pi / 4.0) * amp, 1e-6)
            err = xt.real * math.cos(phase) / a_half
        else:
            z = xt * complex(math.cos(-phase), math.sin(-phase))
            if cfg.detector == "atan2":
                err = math.atan2(z.imag, z.real)
            elif cfg.detector == "costas":
                err = z.real * z.imag / max(amp * amp, 1e-12)
            else:
                err = z.imag * (1.0 if z.real >= 0 else -1.0)
        fdev = min(max(fdev + cfg.beta * err, dev_lo), dev_hi)
        phase = phase + (cfg.freq_center + fdev) + cfg.alpha * err
        phase = math.fmod(phase + math.pi, two_pi)
        if phase < 0:
            phase += two_pi
        phase -= math.pi
    return phases


def scipy_golden_nfm(iq: np.ndarray, fs: int, tune_hz: float, rx,
                     x_dc: np.ndarray | None = None) -> np.ndarray:
    """NFM conj-product discriminator golden: bandpass -> angle(x conj(prev))
    gain -> 0.999 DC tracker -> voice low-pass -> resample."""
    x, rate = _front64(iq, fs, tune_hz, rx.info.max_output_bw, x_dc)
    x = _bandpass64(x, rate, rx.info.lo_cut, rx.info.hi_cut, rx.blk)
    cfg = rx.nfm_cfg
    prev = np.concatenate([[0.0 + 0.0j], x[:-1]])
    delta = x * np.conj(prev)
    gain = rate / (2.0 * np.pi * cfg.max_deviation)
    audio = np.arctan2(delta.imag, delta.real) * gain
    a = 0.999
    dc = scipy.signal.lfilter([1 - a], [1, -a], audio)
    audio = audio - dc
    audio = scipy.signal.lfilter(cfg.voice_taps.astype(np.float64), [1.0],
                                 audio)
    return _resample64(audio, rate, rx.cfg.audio_rate)


def scipy_golden_sam(iq: np.ndarray, fs: int, tune_hz: float, rx,
                     x_dc: np.ndarray | None = None) -> np.ndarray:
    """SAM golden: float64 per-sample PLL carrier recovery -> coherent mix ->
    0.999 DC removal -> resample (mono)."""
    x, rate = _front64(iq, fs, tune_hz, rx.info.max_output_bw, x_dc)
    x = _bandpass64(x, rate, rx.info.lo_cut, rx.info.hi_cut, rx.blk)
    phases = _pll64(rx.sam_cfg.pll, x)
    base = x * np.exp(-1j * phases)
    mono = base.real
    a = 0.999
    dc = scipy.signal.lfilter([1 - a], [1, -a], mono)
    mono = mono - dc
    return _resample64(mono, rate, rx.cfg.audio_rate)


def scipy_golden_wfm(iq: np.ndarray, fs: int, tune_hz: float, rx,
                     stereo: bool, return_stereo: bool = False,
                     x_dc: np.ndarray | None = None):
    """WFM golden, independent of the chain's WFM design:

      * composite discriminator: float64 conj-product angle;
      * pilot recovery by the analytic signal: a narrow 19 kHz FIR bandpass
        (its own firwin design) -> scipy.signal.hilbert -> instantaneous
        phase;
      * audio low-pass: its own Kaiser design (15 kHz pass / 19 kHz stop);
      * de-emphasis: the RC recursion from the time constant.

    Only the rate bookkeeping (decimation geometry, 75 kHz deviation) is
    shared.  Returns LEFT at the audio rate, or (L, R) with return_stereo
    (so a caller can hold the golden's own stereo separation)."""
    x, rate = _front64(iq, fs, tune_hz, rx.info.max_output_bw, x_dc)
    cfg = rx.wfm_cfg
    prev = np.concatenate([[0.0 + 0.0j], x[:-1]])
    delta = x * np.conj(prev)
    gain = rate / (2.0 * np.pi * 75000.0)
    raw = np.arctan2(delta.imag, delta.real) * gain
    # own audio LP design (15 kHz pass, stop at the 19 kHz pilot, 60 dB)
    ntaps, beta = scipy.signal.kaiserord(60.0, (19000.0 - 15000.0)
                                         / (rate / 2.0))
    ntaps |= 1  # odd length -> integer group delay
    lp = scipy.signal.firwin(ntaps, 17000.0, window=("kaiser", beta),
                             fs=rate)
    dec = cfg.audio_decim
    audio_rate = rate / dec
    mono = scipy.signal.lfilter(lp, [1.0], raw)[::dec]
    if stereo:
        # analytic-signal pilot: pilot = A sin(psi); the analytic real part
        # is A cos(theta), so psi = theta + pi/2 and sin(2 psi) = -sin(2
        # theta)
        nbp, bbp = scipy.signal.kaiserord(50.0, 400.0 / (rate / 2.0))
        nbp |= 1
        bp = scipy.signal.firwin(nbp, [18800.0, 19200.0],
                                 window=("kaiser", bbp), pass_zero=False,
                                 fs=rate)
        pilot = scipy.signal.lfilter(bp, [1.0], raw)
        # compensate the bandpass group delay so pilot phase aligns with raw
        gd = (nbp - 1) // 2
        pilot = np.concatenate([pilot[gd:], np.zeros(gd)])
        theta = np.angle(scipy.signal.hilbert(pilot))
        lmr = raw * 2.0 * (-np.sin(2.0 * theta))
        lmr_a = scipy.signal.lfilter(lp, [1.0], lmr)[::dec]
        left = mono + lmr_a
        right = mono - lmr_a
    else:
        left = mono
        right = mono
    a = math.exp(-1.0 / (cfg.deemphasis_us * 1e-6 * audio_rate))
    left = scipy.signal.lfilter([1 - a], [1, -a], left)
    right = scipy.signal.lfilter([1 - a], [1, -a], right)
    left = _resample64(left, audio_rate, rx.cfg.audio_rate)
    right = _resample64(right, audio_rate, rx.cfg.audio_rate)
    return (left, right) if return_stereo else left


def golden(iq: np.ndarray, fs: int, tune_hz: float, rx,
           x_dc: np.ndarray | None = None):
    """The golden of rx's mode at one tune: [M] float64 audio, or (L, R)
    for FM stereo."""
    mode = rx.cfg.mode
    if mode == DemodMode.FMN:
        return scipy_golden_nfm(iq, fs, tune_hz, rx, x_dc)
    if mode == DemodMode.SAM:
        return scipy_golden_sam(iq, fs, tune_hz, rx, x_dc)
    if mode in (DemodMode.FMM, DemodMode.FMS):
        stereo = mode == DemodMode.FMS
        return scipy_golden_wfm(iq, fs, tune_hz, rx, stereo=stereo,
                                return_stereo=stereo, x_dc=x_dc)
    return scipy_golden(iq, fs, tune_hz, mode, rx.info.lo_cut,
                        rx.info.hi_cut, rx.info.max_output_bw,
                        rx.cfg.audio_rate, rx.blk, x_dc)


def snr_db(ref: np.ndarray, got: np.ndarray, skip: int,
           eq_taps: int = 33) -> float:
    """Parity SNR with a short least-squares equalizer.

    The two implementations use different (both correct) resampler filters,
    so they differ by a small LINEAR filter (fractional group delay +
    ripple); a 33-tap LS fit absorbs exactly that and nothing else: the
    remaining error is genuine nonlinear/numerical mismatch.
    """
    n = min(len(ref), len(got))
    r, g = ref[skip:n], got[skip:n]
    m = len(r) - eq_taps
    cols = np.stack([g[i:i + m] for i in range(eq_taps)], axis=1)
    target = r[eq_taps // 2: eq_taps // 2 + m]
    w, *_ = np.linalg.lstsq(cols, target, rcond=None)
    err = target - cols @ w
    return 10 * np.log10(max(np.mean(target**2), 1e-20)
                         / max(np.mean(err**2), 1e-20))


def skip_samples(rx) -> int:
    """The audio samples snr_db skips (tests/test_parity.py's): a quarter
    second for USB / LSB, half a second otherwise (the DC blockers' settling
    and the SAM loop's pull-in)."""
    ssb = rx.cfg.mode in (DemodMode.USB, DemodMode.LSB)
    return rx.cfg.audio_rate // (4 if ssb else 2)


# ------------------------------------------------------------------ signals

def mode_signal(mode: DemodMode, fs: int, n: int, carrier_hz: float,
                phase: float = 0.0) -> np.ndarray:
    """tests/test_parity.py's signal for mode (complex128, n samples at fs)
    at carrier_hz, its audio tones started at phase (radians; 0 is the
    test's signal): AM (1 kHz, m = 0.8); USB (tones at +700 and +1900 Hz)
    and LSB (the same below the carrier); NFM (1 kHz at 3 kHz deviation);
    SAM (AM 200 Hz above the carrier); FMS (an L-only 1 kHz program with
    the pilot and a phase-coherent 38 kHz subcarrier, 75 kHz deviation) and
    FMM (its composite without the subcarrier).  The AM signal's 1e-3
    noise is added by parity_capture."""
    t = np.arange(n) / fs
    arg = 2 * np.pi * 1000.0 * t + phase
    if mode in (DemodMode.AM, DemodMode.SAM):
        env = (1 + 0.8 * np.cos(arg)) / 2
        off = 200.0 if mode == DemodMode.SAM else 0.0
        return 0.5 * env * np.exp(2j * np.pi * (carrier_hz + off) * t)
    if mode in (DemodMode.USB, DemodMode.LSB):
        sign = 1.0 if mode == DemodMode.USB else -1.0
        return (0.3 * np.exp(1j * (2 * np.pi * (carrier_hz + sign * 700.0)
                                   * t + phase))
                + 0.2 * np.exp(1j * (2 * np.pi * (carrier_hz + sign * 1900.0)
                                     * t + phase)))
    if mode == DemodMode.FMN:
        ph = 2 * np.pi * np.cumsum(3000.0 * np.sin(arg)) / fs
        return 0.5 * np.exp(1j * (2 * np.pi * carrier_hz * t + ph))
    if mode in (DemodMode.FMS, DemodMode.FMM):
        th = 2 * np.pi * 19000.0 * t
        tone = 0.45 * np.sin(arg)
        comp = tone + 0.1 * np.sin(th)
        if mode == DemodMode.FMS:
            comp = comp + tone * np.sin(2 * th)
        ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
        return 0.5 * np.exp(1j * (2 * np.pi * carrier_hz * t + ph))
    raise ValueError(f"no parity signal for {mode}")


def carrier_phase(i: int) -> float:
    """Carrier i's tone start phase, i (i + 1) / 4 rad (0, 0.5, 1.5, 3):
    no shift of the carriers maps these phases onto themselves, so chain /
    golden tone phasors tell apart a channel that reads another carrier,
    even where every channel does (hold_channels)."""
    return i * (i + 1) / 4.0


def parity_capture(mode: DemodMode, fs: int, n: int, carriers) -> np.ndarray:
    """One complex64 capture of n samples holding mode_signal at each
    carrier, carrier i's tones started at carrier_phase(i); AM adds
    tests/test_parity.py's seeded 1e-3 complex noise.  One carrier gives
    the test's signal exactly."""
    iq = sum(mode_signal(mode, fs, n, c, carrier_phase(i))
             for i, c in enumerate(carriers))
    iq = iq.astype(np.complex64)
    if mode == DemodMode.AM:
        rng = np.random.default_rng(0)
        iq += (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
               ).astype(np.complex64)
    return iq


def probe_tone(mode: DemodMode) -> float:
    """The audio tone (Hz) of mode_signal that tone_phasor reads: the
    700 Hz tone of USB / LSB, 1 kHz otherwise."""
    return 700.0 if mode in (DemodMode.USB, DemodMode.LSB) else 1000.0


def tone_phasor(x: np.ndarray, rate: float, f0: float) -> complex:
    """Complex amplitude of a least-squares fit of a tone at f0 (with a DC
    term): chain / golden phasors of channels on carriers started at other
    phases differ by those phases, so a channel that reads another
    carrier shows."""
    tt = np.arange(len(x)) / rate
    a = np.stack([np.cos(2 * np.pi * f0 * tt), np.sin(2 * np.pi * f0 * tt),
                  np.ones(len(x))], 1)
    c, *_ = np.linalg.lstsq(a, x, rcond=None)
    return complex(c[0], -c[1])


def separation_db(left: np.ndarray, right: np.ndarray, rate: float,
                  f0: float) -> float:
    """Stereo separation of an L-only tone at f0 over the second half:
    20 log10 |L| / |R| (tests/test_parity.py's check of the golden)."""
    half = len(left) // 2
    return 20 * np.log10(abs(tone_phasor(left[half:], rate, f0))
                         / max(abs(tone_phasor(right[half:], rate, f0)),
                               1e-12))


def hold_channels(got: np.ndarray, refs: list, carrier_of, rx):
    """Each channel against its carrier's golden: got [C, M] chain audio
    ([C, 2, M] FM stereo: the left channel is held), refs one golden per
    carrier ((L, R) for FM stereo), carrier_of[c] channel c's carrier.
    A channel whose audio equals, bit for bit, an earlier channel's on the
    same carrier takes that channel's SNR and phasor (they would be the
    same numbers).  Returns (SNR dB [C], spread): spread is the largest
    relative distance of a channel's chain / golden tone phasor from
    channel 0's (channels on one path share the chain's response: about
    1e-6 to 1e-3), 0.5 or more where a channel reads a carrier other than
    its own."""
    stereo = got.ndim == 3
    skip, rate = skip_samples(rx), rx.cfg.audio_rate
    f0 = probe_tone(rx.cfg.mode)
    snrs, rel, held = [], [], {}
    for c, k in enumerate(carrier_of):
        ref = refs[k][0] if stereo else refs[k]
        g = got[c, 0] if stereo else got[c]
        same = next((d for d in held.get(k, ()) if np.array_equal(
            g, got[d, 0] if stereo else got[d])), None)
        if same is not None:
            snrs.append(snrs[same])
            rel.append(rel[same])
            continue
        held.setdefault(k, []).append(c)
        n = min(len(ref), len(g))
        snrs.append(snr_db(ref, g, skip))
        rel.append(tone_phasor(g[skip:n], rate, f0)
                   / tone_phasor(ref[skip:n], rate, f0))
    rel = np.asarray(rel)
    return np.asarray(snrs), float(np.abs(rel / rel[0] - 1.0).max())


def make_fixture(path: str, mode: DemodMode = DemodMode.AM,
                 carriers=(250_000.0,), seconds: float = 2.0) -> None:
    """Write parity_capture(mode) at carriers (fs 2.048 Msps) as an IQ WAV
    whose center frequency is the first carrier; the defaults write the JAX
    harness's fixture (2 s of AM at +250 kHz) byte for byte."""
    fs = 2_048_000
    iq = parity_capture(mode, fs, int(fs * seconds), carriers)
    wav.write_iq_wav(path, iq, fs, center_freq_hz=float(carriers[0]),
                     demod_mode=mode.value)
    where = ", ".join(f"{c / 1e3:+g}" for c in carriers)
    print(f"fixture written: {path} ({seconds}s {mode.value} @ {where} kHz, "
          f"2.048 Msps)")


# ------------------------------------------------------------------ chain

def run_chain(iq: np.ndarray, fs: int, mode: DemodMode, tunes, frames: int,
              device, blocks: int = 1, batched: bool = False):
    """The port's Receiver (AGC off) on one capture shared by every channel,
    channel c tuned to tunes[c], through tools/quality.py's run_chain:
    block by block through Receiver.step, or with batched K = blocks
    blocks a dispatch through Receiver.step_many.  The capture's whole
    dispatches run (whole blocks with step).  Returns (audio on the host,
    float64 [C, M], [C, 2, M] for FM stereo: left, right; the Receiver)."""
    tunes = np.atleast_1d(np.asarray(tunes, np.float64))
    c = len(tunes)
    rows = frames * (blocks if batched else 1)
    ri = torch.from_numpy(np.stack([iq.real, iq.imag], axis=1)
                          .astype(np.float32))
    # the [rows, 2C] lane-packed planes, built on the device: C copies of
    # I, then of Q
    planes = (ri[i * rows:(i + 1) * rows].to(device)
              .repeat_interleave(c, dim=1) for i in range(len(iq) // rows))
    rx, _, outs = quality.run_chain(device, planes, tunes, batched,
                                    n=frames, fs=fs, mode=mode,
                                    agc_mode="off")
    return quality.audio_of(outs), rx


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    from pebblesdr_tpu_torch.serve.cli import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("wav_path", nargs="?")
    p.add_argument("--make-fixture", metavar="PATH",
                   help="write a fixture: --mode's parity signal (default "
                        "AM) at --carriers for --seconds")
    p.add_argument("--carriers", default="250000",
                   help="fixture carriers in Hz, comma-separated")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="fixture length")
    p.add_argument("--mode", default=None,
                   help="demod mode (default: the recording's)")
    p.add_argument("--tune", type=float, default=None,
                   help="tune offset in Hz for every channel (default: the "
                        "recording's center frequency)")
    p.add_argument("--frames", type=int, default=32768)
    p.add_argument("--min-snr", type=float, default=40.0)
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the default; an error "
                        "without a CUDA device), 'cuda:N' or 'cpu'")
    p.add_argument("--channels", type=int, default=1,
                   help="channels, all tuned to --tune")
    p.add_argument("--blocks", type=int, default=1,
                   help="blocks a dispatch with --batched")
    p.add_argument("--batched", action="store_true",
                   help="run Receiver.step_many (K = --blocks) instead of "
                        "Receiver.step per block")
    args = p.parse_args(argv)

    if args.make_fixture:
        make_fixture(args.make_fixture, from_string(args.mode or "AM"),
                     [float(c) for c in args.carriers.split(",")],
                     args.seconds)
        return 0
    if not args.wav_path:
        p.error("wav_path required (or --make-fixture)")
    device = resolve_device(p, args.device)

    iq, info = wav.read_iq_wav(args.wav_path)
    mode = from_string(args.mode or info.demod_mode)
    tune = args.tune if args.tune is not None else info.center_freq_hz
    if mode not in GOLDEN_MODES:
        print(f"scipy golden implemented for "
              f"{[m.value for m in GOLDEN_MODES]}", file=sys.stderr)
        return 2

    got, rx = run_chain(iq, info.sample_rate, mode,
                        np.full(args.channels, tune), args.frames, device,
                        blocks=args.blocks, batched=args.batched)
    ref = golden(iq, info.sample_rate, tune, rx)
    if mode == DemodMode.FMS:   # stereo: compare the left channel
        ref, got = ref[0], got[:, 0]
    skip = skip_samples(rx)
    snrs = np.array([snr_db(ref, g, skip) for g in got])
    path = (f"step_many K={args.blocks}" if args.batched else "step")
    print(f"chain vs scipy-golden SNR over {len(snrs)} channel(s) ({path} on "
          f"{device}): min {snrs.min():.1f} dB, median "
          f"{np.median(snrs):.1f} dB ({got.shape[-1]} samples, skip {skip})")
    if snrs.min() < args.min_snr:
        print(f"FAIL: {int(np.sum(snrs < args.min_snr))} channel(s) below "
              f"{args.min_snr} dB", file=sys.stderr)
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
