"""FIR design (host, float64/scipy) and the streaming real-signal FIR.

Port of pebblesdr_tpu/ops/fir.py.  The design functions are copied verbatim
(numpy/scipy, so the port needs no jax); the apply path keeps the JAX
package's banded-matmul forms.  There is deliberately no conv1d fallback:
cuDNN convolutions default to TF32, which the receive chain must not use.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch

from pebblesdr_tpu_torch.core import windows as win


# ---------------------------------------------------------------- design (host)

def design_lowpass_kaiser(cutoff_hz: float, sample_rate: float, atten_db: float = 60.0,
                          transition_hz: float | None = None, max_taps: int = 127) -> np.ndarray:
    """Kaiser-windowed LP (CFir::InitLPFilter capability)."""
    if transition_hz is None:
        transition_hz = max(0.1 * cutoff_hz, 0.02 * sample_rate)
    ntaps, beta = scipy.signal.kaiserord(atten_db, transition_hz / (0.5 * sample_rate))
    ntaps = min(ntaps | 1, max_taps)  # odd, bounded
    return scipy.signal.firwin(ntaps, cutoff_hz, window=("kaiser", beta), fs=sample_rate)


def design_windowed_sinc(ntaps: int, cutoff_hz: float, sample_rate: float,
                         kind: win.WindowType = win.WindowType.BLACKMAN_NUTTALL) -> np.ndarray:
    """Windowed-sinc LP, the FastFIR prototype (fastfir.cpp:231-250 semantics)."""
    fc = cutoff_hz / sample_rate  # cycles/sample
    n = np.arange(ntaps, dtype=np.float64)
    x = n - 0.5 * (ntaps - 1)
    w = win.window(kind, ntaps, periodic=False)
    h = np.where(x == 0.0, 2.0 * fc, np.sin(2.0 * np.pi * fc * x) / (np.pi * np.where(x == 0, 1.0, x)))
    return h * w


def shift_to_bandpass(h: np.ndarray, center_hz: float, sample_rate: float) -> np.ndarray:
    """LP taps -> complex bandpass taps centered at center_hz."""
    ntaps = len(h)
    x = np.arange(ntaps, dtype=np.float64) - 0.5 * (ntaps - 1)
    return h * np.exp(2j * np.pi * (center_hz / sample_rate) * x)


def design_bandpass_complex(lo_hz: float, hi_hz: float, sample_rate: float, ntaps: int,
                            kind: win.WindowType = win.WindowType.BLACKMAN_NUTTALL) -> np.ndarray:
    """Arbitrary complex bandpass (lo..hi may span negative freqs), FastFIR-style."""
    assert hi_hz > lo_hz
    half_bw = (hi_hz - lo_hz) / 2.0
    center = (hi_hz + lo_hz) / 2.0
    lp = design_windowed_sinc(ntaps, half_bw, sample_rate, kind)
    return shift_to_bandpass(lp, center, sample_rate)


def design_halfband(ntaps: int, wpass: float) -> np.ndarray:
    """Equiripple halfband decimation filter (remez + halfband constraint);
    wpass is the alias-free bandwidth as a fraction of the input rate."""
    assert ntaps % 2 == 1
    fp = wpass / 2.0  # passband edge in cycles/sample
    h = scipy.signal.remez(ntaps, [0.0, fp, 0.5 - fp, 0.5], [1.0, 0.0], fs=1.0)
    # enforce exact halfband structure: odd-indexed (from center) taps are zero
    center = ntaps // 2
    for i in range(ntaps):
        if i != center and (i - center) % 2 == 0:
            h[i] = 0.0
    h[center] = 0.5
    # normalize DC gain to exactly 1
    return h / np.sum(h)


CIC3_TAPS = np.array([1.0, 3.0, 3.0, 1.0]) / 8.0  # CIC3 comb as FIR (decim 2)


# ---------------------------------------------------------------- apply (device)

_BANDED_MAX_ENTRIES = 4_000_000


@functools.lru_cache(maxsize=32)
def _banded_np(taps_bytes: bytes, n: int, decim: int) -> np.ndarray:
    taps_np = np.frombuffer(taps_bytes, np.float32)
    t = len(taps_np)
    m = n // decim
    b = np.zeros((n + t - 1, m), np.float32)
    out_i = np.arange(m)
    for j in range(t):
        b[out_i * decim + t - 1 - j, out_i] = taps_np[j]
    return b


def banded_fir_matrix(taps_np: np.ndarray, n: int, decim: int = 1) -> np.ndarray:
    """[N+T-1, N//decim] banded operator (float32): y = x_ext @ B == causal
    FIR with T taps, x_ext = [tail (T-1) | x (N)]."""
    return _banded_np(np.ascontiguousarray(taps_np, np.float32).tobytes(),
                      int(n), int(decim))


@functools.lru_cache(maxsize=32)
def _banded_dev(taps_bytes: bytes, n: int, decim: int,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_banded_np(taps_bytes, n, decim)).to(device)


def _banded_seg(n: int, t: int, decim: int) -> int:
    """Segment length for the windowed long-input FIR path; 0 if none fits
    (same rule as the JAX package: smallest segment with >= 64 outputs)."""
    for seg in (256, 512, 1024, 2048):
        if (n % seg == 0 and seg % decim == 0 and seg >= t
                and seg // decim >= 64
                and (seg + t - 1) * (seg // decim) <= _BANDED_MAX_ENTRIES):
            return seg
    for seg in (2048, 1024, 512):
        if (n % seg == 0 and seg % decim == 0 and seg >= t
                and (seg + t - 1) * (seg // decim) <= _BANDED_MAX_ENTRIES):
            return seg
    return 0


def fir_apply_real_signal(x: torch.Tensor, tail: torch.Tensor,
                          taps_np: np.ndarray, decim: int = 1):
    """Streaming FIR on a real float32 signal x [C, N] with static taps.

    Short inputs: one matmul against the whole-block banded operator.  Long
    inputs (a multi-block dispatch): windows of `seg` samples plus the T-1
    sample history, one batched matmul against the per-segment operator.
    tail: [C, T-1] carried input history.  Returns (y [C, N//decim], tail')."""
    taps32 = np.ascontiguousarray(taps_np, np.float32)
    key = taps32.tobytes()
    t = len(taps32)
    c, n = x.shape
    xx = torch.cat([tail, x], dim=-1)
    if (n + t - 1) * (n // decim) <= _BANDED_MAX_ENTRIES:
        y = torch.matmul(xx, _banded_dev(key, n, decim, x.device))
    else:
        seg = _banded_seg(n, t, decim)
        if not seg:
            raise ValueError(f"no banded FIR geometry for N={n}, taps={t}, "
                             f"decim={decim}")
        k = n // seg
        base = xx[:, :n].reshape(c, k, seg)
        if t > 1:
            carry = x.reshape(c, k, seg)[:, :, seg - (t - 1):]
            wins = torch.cat([base, carry], dim=-1)      # [C, K, seg+T-1]
        else:
            wins = base
        y = torch.matmul(wins, _banded_dev(key, seg, decim, x.device))
        y = y.reshape(c, n // decim)
    new_tail = xx[:, xx.shape[-1] - (t - 1):]
    return y, new_tail
