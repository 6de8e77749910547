"""Test-signal generators: a tone, Gaussian noise and a frequency sweep with
pulse modulation (port of pebblesdr_tpu/core/siggen.py).

The foundation of the test strategy: inject a calibrated signal at a known
level and assert the chain's behaviour (chain/testbench.py).  Every
generator is (state, n) -> (state', samples [n] complex64), so a continuous
signal can be made block by block with its phase carried.

The sweep is a per-sample recurrence in float32: the frequency steps by
rate / fs a sample and wraps (or clips, or turns) at the band's edges, and
the carrier phase integrates it.  Each wrap decision reads the accumulated
rounding of the frequency, so no closed form follows the JAX package's
sweep (a float64 recurrence wraps on another sample at 100 -> 2000 Hz,
1e5 Hz/s, 48 kHz).  The phase step ph + f / fs is taken as XLA compiles
the JAX step: the division by the constant rate becomes a product with its
float32 reciprocal, fused with the add (one rounding); a true division
drifts the phase by 7.6e-6 cycles over 32768 samples.  On a CUDA device
the sweep runs as one launch of the recurrence kernel csrc/recur.cu
sweep_scan (K7: one thread carries the phase, frequency, direction and
pulse counter; the block's other warps turn each finished tile into
samples); on the CPU as sweep_plain, a Python loop over samples of the
same float32 operations on 0-d tensors.
sweep.launches counts the kernel launches.

Noise draws from an explicit torch.Generator on the device: the JAX
package's random bits cannot be reproduced, only their distribution.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from pebblesdr_tpu_torch.kernels import build

TWO_PI = 2.0 * math.pi
SWEEP_MODES = ("single", "repeat", "repeat_reverse")   # recur.cu's mode 0-2
SOURCE = "pebblesdr_tpu_torch/csrc/recur.cu"
# the lax.scan the kernel replaces (no Pallas kernel: a per-sample scan)
REPLACES = "pebblesdr_tpu/core/siggen.py:119"


@dataclasses.dataclass(frozen=True)
class ToneState:
    phase: torch.Tensor     # fractional cycles in [0, 1), float32 scalar


def tone_init(device) -> ToneState:
    return ToneState(phase=torch.zeros((), dtype=torch.float32,
                                       device=device))


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def tone(state: ToneState, n: int, freq_hz, sample_rate: float,
         amplitude=1.0):
    """Complex exponential at freq_hz; phase carried across blocks."""
    dev = state.phase.device
    f = _f32(np.float32(freq_hz) / np.float32(sample_rate), dev)
    k = torch.arange(n, dtype=torch.float32, device=dev)
    ph = torch.remainder(state.phase + torch.remainder(f * k, 1.0), 1.0)
    theta = np.float32(TWO_PI) * ph
    amp = np.float32(amplitude)
    y = torch.complex(amp * torch.cos(theta), amp * torch.sin(theta))
    new_phase = torch.remainder(state.phase + torch.remainder(f * n, 1.0),
                                1.0)
    return ToneState(phase=new_phase), y


def noise(generator: torch.Generator, n: int, db_level: float = 0.0):
    """Complex Gaussian noise of total power db_level dB (0 dB = unit power),
    drawn from `generator` on its device."""
    amp = 10.0 ** (db_level / 20.0) / math.sqrt(2.0)
    dev = generator.device
    re = torch.randn(n, generator=generator, dtype=torch.float32, device=dev)
    im = torch.randn(n, generator=generator, dtype=torch.float32, device=dev)
    return torch.complex(re, im) * np.float32(amp)


@dataclasses.dataclass(frozen=True)
class SweepState:
    phase: torch.Tensor        # carrier fractional cycles [0, 1), float32
    freq: torch.Tensor         # current sweep frequency (Hz), float32
    direction: torch.Tensor    # +1 / -1 (repeat_reverse), float32
    pulse_count: torch.Tensor  # samples into the pulse period, int32


def sweep_init(start_hz: float, device) -> SweepState:
    return SweepState(
        phase=torch.zeros((), dtype=torch.float32, device=device),
        freq=_f32(start_hz, device),
        direction=torch.ones((), dtype=torch.float32, device=device),
        pulse_count=torch.zeros((), dtype=torch.int32, device=device))


def _sweep_consts(start_hz, stop_hz, rate_hz_per_sec, sample_rate,
                  amplitude) -> dict:
    """The sweep's float32 constants as the JAX step rounds them: the
    reciprocal of the float32 sample rate, the step rate / fs (a float64
    quotient, then float32), the band edges and clip limits, 2 pi and the
    amplitude."""
    return {"inv_fs": np.float32(1.0) / np.float32(sample_rate),
            "df": np.float32(rate_hz_per_sec / sample_rate),
            "start": np.float32(start_hz), "stop": np.float32(stop_hz),
            "lo": np.float32(min(start_hz, stop_hz)),
            "hi": np.float32(max(start_hz, stop_hz)),
            "two_pi": np.float32(TWO_PI), "amp": np.float32(amplitude)}


def _check_mode(mode: str) -> None:
    if mode not in SWEEP_MODES:
        raise ValueError(f"sweep mode {mode!r} not in {SWEEP_MODES}")


def sweep_plain(state: SweepState, n: int, start_hz: float, stop_hz: float,
                rate_hz_per_sec: float, sample_rate: float, amplitude=1.0,
                mode: str = "repeat", pulse_on_samples: int = 0,
                pulse_period_samples: int = 0):
    """Plain version of sweep: one step per sample on 0-d tensors, in
    float32; the phase step's fused product and add is formed in float64
    (the float32 product is exact there) and rounded once to float32.
    Same arguments and results as sweep."""
    _check_mode(mode)
    dev = state.phase.device
    k = {key: _f32(v, dev) for key, v in _sweep_consts(
        start_hz, stop_hz, rate_hz_per_sec, sample_rate, amplitude).items()}
    ph, f, d, pc = (state.phase, state.freq, state.direction,
                    state.pulse_count)
    on_t = torch.ones((), dtype=torch.bool, device=dev)
    phs, ons = [], []
    inv_fs = k["inv_fs"].double()
    for _ in range(n):
        ph = torch.remainder((f.double() * inv_fs + ph.double()).float(),
                             1.0)
        f2 = f + d * k["df"]
        if mode == "single":
            f2 = torch.minimum(torch.maximum(f2, k["lo"]), k["hi"])
        elif mode == "repeat":
            f2 = torch.where(f2 > k["stop"], k["start"], f2)
        else:
            d = torch.where((f2 > k["stop"]) | (f2 < k["start"]), -d, d)
            f2 = torch.minimum(torch.maximum(f2, k["start"]), k["stop"])
        on = on_t
        if pulse_period_samples > 0:
            on = pc < pulse_on_samples
            pc = torch.remainder(pc + 1, pulse_period_samples)
        phs.append(ph)
        ons.append(on)
        f = f2
    new_state = SweepState(phase=ph, freq=f, direction=d, pulse_count=pc)
    if not n:
        return new_state, torch.zeros(0, dtype=torch.complex64, device=dev)
    theta = k["two_pi"] * torch.stack(phs)
    gate = torch.stack(ons).to(torch.float32) * k["amp"]
    return new_state, torch.complex(torch.cos(theta) * gate,
                                    torch.sin(theta) * gate)


@functools.cache
def _lib():
    """csrc/recur.cu, built at first use, with sweep_scan's C signature."""
    lib = build.load("recur")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.recur_sweep_scan.restype = i
    lib.recur_sweep_scan.argtypes = [i, i, i, f, f, f, f, f, f, f, f, i, i,
                                     p, p, p, p, p, p, p, p, p, p]
    lib.recur_error_string.restype = ctypes.c_char_p
    lib.recur_error_string.argtypes = [i]
    return lib


def sweep(state: SweepState, n: int, start_hz: float, stop_hz: float,
          rate_hz_per_sec: float, sample_rate: float, amplitude=1.0,
          mode: str = "repeat", pulse_on_samples: int = 0,
          pulse_period_samples: int = 0):
    """Frequency sweep with optional pulse (on/off) modulation: the
    frequency advances rate / fs per sample from the state's, wrapping to
    start_hz past stop_hz ("repeat"), clipped to the band ("single"), or
    turning at either edge ("repeat_reverse"); the carrier phase integrates
    it.  With pulse_period_samples > 0 the output is on for the first
    pulse_on_samples of each period.  The CUDA kernel (csrc/recur.cu
    sweep_scan, one launch) for a state on a CUDA device, sweep_plain on the
    CPU.  Returns (state', samples [n] complex64)."""
    _check_mode(mode)
    dev = state.phase.device
    if dev.type == "cpu":
        return sweep_plain(state, n, start_hz, stop_hz, rate_hz_per_sec,
                           sample_rate, amplitude, mode, pulse_on_samples,
                           pulse_period_samples)
    if dev.type != "cuda":
        raise ValueError(f"sweep runs on cuda or cpu, not {dev}")
    leaves = (state.phase, state.freq, state.direction, state.pulse_count)
    for v, dtype in zip(leaves, (torch.float32,) * 3 + (torch.int32,)):
        if v.device != dev or v.dtype != dtype or v.dim() != 0:
            raise ValueError(f"sweep: the state must be 0-d tensors on {dev} "
                             f"(phase, freq, direction float32, pulse_count "
                             f"int32), got {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"sweep: n={n} out of range")
    k = _sweep_consts(start_hz, stop_hz, rate_hz_per_sec, sample_rate,
                      amplitude)
    y = torch.empty(n, dtype=torch.complex64, device=dev)
    outs = [torch.empty_like(v) for v in leaves]
    lib = _lib()
    err = lib.recur_sweep_scan(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        SWEEP_MODES.index(mode), n, *(float(k[key]) for key in (
            "inv_fs", "df", "start", "stop", "lo", "hi", "two_pi", "amp")),
        int(pulse_on_samples), int(pulse_period_samples),
        *(v.data_ptr() for v in leaves), y.data_ptr(),
        *(v.data_ptr() for v in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err} "
                           f"({lib.recur_error_string(err).decode()})")
    sweep.launches += 1
    return SweepState(*outs), y


sweep.launches = 0   # CUDA kernel launches (the plain path never counts)
