"""FIR design (host, float64/scipy) and the streaming FIRs.

Port of pebblesdr_tpu/ops/fir.py.  The design functions are copied verbatim
(numpy/scipy, so the port needs no jax); the real-signal apply path keeps
the JAX package's banded-matmul forms.  The halfband stage runs as
fir_apply (a strided conv1d on the stacked [re; im] rows, the JAX
package's _conv_real; ops/decimator.py), plain PyTorch.  cuDNN
convolutions default to TF32 and matmuls run at the process's precision,
which the receive chain must not take: fir_apply and fir_apply_real_signal
pin IEEE float32 for their own products and restore the caller's settings
(utils/precision.py).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch

from pebblesdr_tpu_torch.core import windows as win
from pebblesdr_tpu_torch.utils.precision import ieee_float32


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


def design_cfir_kaiser_lp(astop_db: float, fpass_hz: float, fstop_hz: float,
                          sample_rate: float) -> np.ndarray:
    """CFir::InitLPFilter's EXACT Kaiser design (fir.cpp:~InitLPFilter):
    beta from the standard Kaiser attenuation formula, tap count from the
    (Astop-8)/(2.285*2pi*dF) estimate, sinc at the (pass+stop)/2 6 dB
    cutoff.  Used where reference-exact filter shapes matter (SAM rails)."""
    norm_pass = fpass_hz / sample_rate
    norm_stop = fstop_hz / sample_rate
    norm_cut = (norm_stop + norm_pass) / 2.0
    if astop_db < 20.96:
        beta = 0.0
    elif astop_db >= 50.0:
        beta = 0.1102 * (astop_db - 8.71)
    else:
        beta = (0.5842 * (astop_db - 20.96) ** 0.4
                + 0.07886 * (astop_db - 20.96))
    ntaps = int((astop_db - 8.0)
                / (2.285 * 2.0 * np.pi * (norm_stop - norm_pass)) + 1)
    ntaps = max(3, ntaps)
    n = np.arange(ntaps, dtype=np.float64)
    fc = 0.5 * (ntaps - 1)
    x = n - fc
    c = np.where(x == 0.0, 2.0 * norm_cut,
                 np.sin(2.0 * np.pi * x * norm_cut)
                 / (np.pi * np.where(x == 0.0, 1.0, x)))
    xk = (n - (ntaps - 1) / 2.0) / ((ntaps - 1) / 2.0)
    w = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - xk * xk))) / np.i0(beta)
    return c * w


def design_rail_pair(h: np.ndarray, center_hz: float,
                     sample_rate: float) -> tuple[np.ndarray, np.ndarray]:
    """CFir::GenerateHBFilter's rail pair: (2h cos, 2h sin) shifted by
    center_hz, applied INDEPENDENTLY to the re/im rails (the phasing
    method, not a complex convolution)."""
    ntaps = len(h)
    x = np.arange(ntaps, dtype=np.float64) - 0.5 * (ntaps - 1)
    ang = 2.0 * np.pi * (center_hz / sample_rate) * x
    return 2.0 * h * np.cos(ang), 2.0 * h * np.sin(ang)


def design_hilbert(ntaps: int, center_hz: float, bw_hz: float,
                   sample_rate: float) -> np.ndarray:
    """Complex analytic bandpass (Hilbert pair) — CFir::GenerateHBFilter
    analog, used by SAM (demod_sam.cpp:36)."""
    lp = design_windowed_sinc(ntaps, bw_hz / 2.0, sample_rate)
    return 2.0 * shift_to_bandpass(lp, center_hz, sample_rate)


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


def _windows(xx: torch.Tensor, x: torch.Tensor, seg: int, t: int,
             dim: int) -> torch.Tensor:
    """The K = N/seg windows of seg + T-1 samples of the tail-extended
    stream xx along `dim` (-1 for [C, N], 0 for time-major [N, C]), from
    two reshapes: [C, K, seg+T-1] or [K, seg+T-1, C]."""
    n = x.shape[dim]
    k = n // seg
    if dim == 0:
        base = xx[:n].reshape(k, seg, -1)
        carry = x.reshape(k, seg, -1)[:, seg - (t - 1):]
        return torch.cat([base, carry], dim=1) if t > 1 else base
    c = x.shape[0]
    base = xx[:, :n].reshape(c, k, seg)
    carry = x.reshape(c, k, seg)[:, :, seg - (t - 1):]
    return torch.cat([base, carry], dim=-1) if t > 1 else base


def tm_fir_decimate(x_t: torch.Tensor, taps_np: np.ndarray,
                    tail_t: torch.Tensor, decim: int, seg: int = 512):
    """Streaming decimating FIR along axis 0 of a time-major plane x_t
    [M, C] float32 (all lanes share the taps): one banded-operator matmul
    per segment of `seg` rows (halved until it divides M).  tail_t: [T-1, C]
    carried history rows.  Returns (y_t [M/decim, C], tail_t')."""
    taps32 = np.ascontiguousarray(taps_np, np.float32)
    t = len(taps32)
    m, c = x_t.shape
    while m % seg:
        seg //= 2
    if seg < t - 1:
        raise ValueError(f"tm_fir_decimate: {m} rows give segments of {seg}, "
                         f"shorter than the {t - 1}-row history")
    xx = torch.cat([tail_t, x_t], dim=0)                    # [M+T-1, C]
    wins = _windows(xx, x_t, seg, t, 0)                     # [K, seg+T-1, C]
    b = _banded_dev(taps32.tobytes(), seg, decim, x_t.device)
    y = torch.matmul(wins.transpose(1, 2), b)               # [K, C, seg/decim]
    return (y.transpose(1, 2).reshape(m // decim, c),
            xx[xx.shape[0] - (t - 1):])


@ieee_float32()
def fir_apply_real_signal(x: torch.Tensor, tail: torch.Tensor,
                          taps_np: np.ndarray, decim: int = 1,
                          block: int = 0):
    """Streaming FIR on a real float32 signal x [C, N] with static taps.

    Short inputs: one matmul against the whole-block banded operator.  Long
    inputs (a multi-block dispatch): windows of `seg` samples plus the T-1
    sample history, one batched matmul against the per-segment operator;
    where no segment fits, each output's T input samples (a strided view)
    against the reversed taps.  block > 0 with decim not dividing it: x is
    N / block blocks, each decimated on its own grid from its first sample
    (block // decim outputs each, as one call per block gives: the JAX
    package's per-block path); one window of `block` samples per block.
    tail: [C, T-1] carried input history.  Returns (y [C, M], tail'), M =
    N // decim, or N / block * (block // decim) on per-block grids."""
    taps32 = np.ascontiguousarray(taps_np, np.float32)
    key = taps32.tobytes()
    t = len(taps32)
    c, n = x.shape
    xx = torch.cat([tail, x], dim=-1)
    seg = _banded_seg(n, t, decim)
    if block and block % decim:
        if n % block or block < t - 1:
            raise ValueError(f"fir_apply_real_signal: {n} samples are not "
                             f"whole blocks of {block} (>= T-1 = {t - 1})")
        y = torch.matmul(_windows(xx, x, block, t, -1),
                         _banded_dev(key, block, decim, x.device))
        y = y.reshape(c, -1)
    elif (n + t - 1) * (n // decim) <= _BANDED_MAX_ENTRIES:
        y = torch.matmul(xx, _banded_dev(key, n, decim, x.device))
    elif seg:
        y = torch.matmul(_windows(xx, x, seg, t, -1),
                         _banded_dev(key, seg, decim, x.device))
        y = y.reshape(c, n // decim)
    else:
        rev = torch.from_numpy(taps32[::-1].copy()).to(x.device)
        y = torch.matmul(xx.unfold(-1, t, decim)[:, :n // decim], rev)
    new_tail = xx[:, xx.shape[-1] - (t - 1):]
    return y, new_tail


@functools.lru_cache(maxsize=16)
def _banded_pair_dev(a_bytes: bytes, b_bytes: bytes, n: int, decim: int,
                     device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [_banded_np(a_bytes, n, decim), _banded_np(b_bytes, n, decim)],
        axis=1)).to(device)


def fir_apply_real_signal_pair(x: torch.Tensor, tail: torch.Tensor,
                               taps_a_np: np.ndarray, taps_b_np: np.ndarray,
                               decim: int = 1):
    """Two static-tap FIRs of equal length over the same real stream x
    [C, N] in one banded matmul against [B_a | B_b] (the window stack is
    built once).  tail: [C, T-1].  Returns (y_a [C, N//decim], y_b,
    tail')."""
    a32 = np.ascontiguousarray(taps_a_np, np.float32)
    b32 = np.ascontiguousarray(taps_b_np, np.float32)
    t = len(a32)
    if len(b32) != t:
        raise ValueError("fir_apply_real_signal_pair needs tap sets of equal "
                         "length")
    xx = torch.cat([tail, x], dim=-1)
    c, n = x.shape
    m = n // decim
    seg = _banded_seg(n, t, decim)
    b = _banded_pair_dev(a32.tobytes(), b32.tobytes(), seg or n, decim,
                         x.device)
    if seg:
        y = torch.matmul(_windows(xx, x, seg, t, -1), b)  # [C, K, 2 seg/decim]
        ms = seg // decim
        y_a, y_b = y[:, :, :ms].reshape(c, m), y[:, :, ms:].reshape(c, m)
    else:
        y = torch.matmul(xx, b)                           # [C, 2M]
        y_a, y_b = y[:, :m], y[:, m:]
    return y_a, y_b, xx[:, xx.shape[-1] - (t - 1):]


def fir_tail_init(channels: int, ntaps: int, device,
                  dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    return torch.zeros(channels, max(ntaps - 1, 0), dtype=dtype,
                       device=device)


def fir_apply_complex(x: torch.Tensor, taps_c, tail: torch.Tensor,
                      decim: int = 1, taps_np: np.ndarray | None = None):
    """Streaming FIR with complex static taps (Hilbert / shifted bandpass)
    on x [C, N] complex64, tail [C, T-1]: the JAX package's taps_np path,
    fir_apply_real_signal_pair on the stacked [re; im] rows (each real row
    against both tap sets, one window stack, one matmul).  taps_np defaults
    to taps_c's values.  Returns (y [C, N] complex64, tail')."""
    if decim != 1:
        raise ValueError("fir_apply_complex with decim > 1 (the JAX "
                         "package's strided complex convolution) is not "
                         "ported")
    if taps_np is None:
        taps_np = (taps_c.detach().cpu().numpy()
                   if isinstance(taps_c, torch.Tensor) else taps_c)
    h = np.asarray(taps_np)
    c = x.shape[0]
    rows = torch.cat([x.real, x.imag], dim=0)                  # [2C, N]
    tail2 = torch.cat([tail.real, tail.imag], dim=0)
    ya, yb, tail_rows = fir_apply_real_signal_pair(
        rows, tail2, h.real.astype(np.float32), h.imag.astype(np.float32))
    # (xr + j xi)(hr + j hi): re = xr hr - xi hi, im = xr hi + xi hr
    y = torch.complex(ya[:c] - yb[c:], yb[:c] + ya[c:])
    return y, torch.complex(tail_rows[:c], tail_rows[c:]).to(tail.dtype)


def fir_apply(x: torch.Tensor, taps, tail: torch.Tensor, decim: int = 1):
    """Streaming FIR: x [C, N] complex64, real taps [T] (numpy or a tensor),
    tail [C, T-1] complex64.  y[m] = sum_k h[k] xin[m decim - k] on the
    tail-extended stream, as one strided conv1d (IEEE float32) of the
    stacked [re; im] rows.  Returns (y [C, N/decim], tail')."""
    c = x.shape[0]
    h = torch.as_tensor(np.asarray(taps, np.float32) if not isinstance(
        taps, torch.Tensor) else taps, dtype=torch.float32, device=x.device)
    t = h.shape[0]
    xx = torch.cat([tail, x], dim=-1)                          # [C, N+T-1]
    xr = torch.cat([xx.real, xx.imag], dim=0)
    with ieee_float32():     # cuDNN allows TF32 by default
        yr = torch.nn.functional.conv1d(xr[:, None, :],
                                        h.flip(0)[None, None, :],
                                        stride=decim)[:, 0]
    tail = xx[:, xx.shape[-1] - (t - 1):] if t > 1 else xx[:, :0]
    return torch.complex(yr[:c], yr[c:]), tail
