"""Misc DSP utilities (port of pebblesdr_tpu/ops/util_filters.py).

Capability parity with:
  * MovingAvgFilter (pebblelib/movingavgfilter.h:24-61): uniform / weighted
    moving averages with running variance & stdDev;
  * MedianFilter<T> (pebblelib/medianfilter.h): sliding median;
  * DelayLine (pebblelib/delayline.h:13-28): ring-buffer delay;
  * Butterworth (pebblelib/butterworth.h:35): classic IIR design as a
    cascade of biquads run by ops.iir.biquad_apply;
  * SampleClock (pebblelib/sampleclock.h:8): sample-count timing;
  * ALawCompression (pebblelib/alawcompression.h:11): G.711 a-law (the
    ghpsdr3 audio wire format), numpy.

The array ops take torch tensors [C, N] and run on their device; the
design helpers and a-law are host-side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from pebblesdr_tpu_torch.ops import iir as iir_mod


# ------------------------------------------------------------ moving average

def moving_avg(x: torch.Tensor, window: int, tail: torch.Tensor | None = None,
               weights: torch.Tensor | None = None):
    """Sliding average (uniform, or weighted when `weights` given) over the
    trailing `window` samples.  x: [C, N]; tail: [C, window-1] carried
    history.  Returns (y [C, N], new_tail)."""
    c = x.shape[0]
    if tail is None:
        tail = torch.zeros(c, window - 1, dtype=x.dtype, device=x.device)
    ext = torch.cat([tail, x], dim=-1)
    w = (torch.full((window,), 1.0 / window) if weights is None
         else torch.flip(weights / torch.sum(weights), [0]))
    y = F.conv1d(ext[:, None, :],
                 w.to(device=x.device, dtype=x.dtype)[None, None, :])[:, 0]
    return y, ext[:, ext.shape[-1] - (window - 1):]


def moving_variance(x: torch.Tensor, window: int):
    """Sliding mean/variance/std over the trailing window (MovingAvgFilter
    variance capability).  Returns (mean, var, std) each [C, N]."""
    zeros = torch.zeros(x.shape[0], window - 1, dtype=x.dtype, device=x.device)
    m, _ = moving_avg(x, window, tail=zeros)
    m2, _ = moving_avg(x * x, window, tail=zeros)
    var = torch.clamp_min(m2 - m * m, 0.0)
    return m, var, torch.sqrt(var)


# ------------------------------------------------------------------- median

def median_filter(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding median over a centred window, edges padded with the edge
    value.  x: [C, N] -> [C, N].  An even window averages the two middle
    values (the JAX package's jnp.median: lo * 0.5 + hi * 0.5)."""
    c, n = x.shape
    pad = window // 2
    ext = torch.cat([x[:, :1].expand(c, pad), x, x[:, -1:].expand(c, pad)],
                    dim=-1)
    frames = ext.unfold(-1, window, 1)[:, :n]                  # [C, N, W]
    s = torch.sort(frames, dim=-1).values
    lo = s[..., (window - 1) // 2]
    if window % 2:
        return lo
    return lo * 0.5 + s[..., window // 2] * 0.5


# ---------------------------------------------------------------- delay line

@dataclasses.dataclass(frozen=True)
class DelayLinePlan:
    delay: int


def delay_line(x: torch.Tensor, delay: int, tail: torch.Tensor | None = None):
    """Pure delay by `delay` samples with carried state (DelayLine
    capability).  Returns (y, new_tail [C, delay])."""
    c, n = x.shape
    if tail is None:
        tail = torch.zeros(c, delay, dtype=x.dtype, device=x.device)
    full = torch.cat([tail, x], dim=-1)
    return full[:, :n], full[:, n:]


# --------------------------------------------------------------- butterworth

def design_butterworth(order: int, cutoff_hz, sample_rate: float,
                       kind: str = "lowpass") -> list[iir_mod.BiquadCoef]:
    """Butterworth LP/HP/BP as a cascade of biquad sections (apply each with
    ops.iir.biquad_apply)."""
    btype = {"lowpass": "lowpass", "highpass": "highpass",
             "bandpass": "bandpass"}[kind]
    sos = scipy.signal.butter(order, cutoff_hz, btype=btype, fs=sample_rate,
                              output="sos")
    out = []
    for b0, b1, b2, a0, a1, a2 in sos:
        out.append(iir_mod.BiquadCoef(b0 / a0, b1 / a0, b2 / a0, a1 / a0,
                                      a2 / a0))
    return out


def butterworth_apply(states: list[torch.Tensor], x: torch.Tensor,
                      coefs: list[iir_mod.BiquadCoef]):
    new_states = []
    y = x
    for st, cf in zip(states, coefs):
        st2, y = iir_mod.biquad_apply(st, y, cf)
        new_states.append(st2)
    return new_states, y


# -------------------------------------------------------------- sample clock

@dataclasses.dataclass
class SampleClock:
    """Sample-count wall clock (SampleClock capability): convert running
    sample counts to seconds/durations at a fixed rate."""
    sample_rate: float
    count: int = 0

    def tick(self, n: int = 1) -> None:
        self.count += n

    @property
    def seconds(self) -> float:
        return self.count / self.sample_rate

    def duration(self, start_count: int) -> float:
        return (self.count - start_count) / self.sample_rate


# -------------------------------------------------------------------- a-law

def alaw_compress(x: np.ndarray) -> np.ndarray:
    """float32 [-1,1] -> u8 G.711 a-law (ghpsdr3 audio wire format)."""
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    sign = (pcm >> 8) & 0x80
    mag = np.where(sign != 0, -pcm.astype(np.int32), pcm.astype(np.int32))
    mag = np.minimum(mag, 32635)
    exp = np.zeros_like(mag)
    for e in range(7, 0, -1):
        exp = np.where((mag >> (e + 7)) & 1 == 1, np.maximum(exp, e), exp)
    mant = np.where(exp == 0, (mag >> 4) & 0x0F, (mag >> (exp + 3)) & 0x0F)
    val = (sign | (exp << 4) | mant).astype(np.uint8)
    return val ^ 0x55


def alaw_expand(a: np.ndarray) -> np.ndarray:
    """u8 a-law -> float32 [-1,1]."""
    a = a.astype(np.uint8) ^ 0x55
    sign = a & 0x80
    exp = (a >> 4) & 0x07
    mant = (a & 0x0F).astype(np.int32)
    mag = np.where(exp == 0, (mant << 4) + 8, ((mant << 4) + 0x108) << (exp - 1))
    pcm = np.where(sign != 0, -mag, mag).astype(np.float32)
    return pcm / 32768.0
