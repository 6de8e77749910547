"""FastFIR: FFT overlap-save complex bandpass (port of pebblesdr_tpu/ops/fastfir.py).

The mask is a runtime input, designed on the host as the FFT of a
(block+1)-tap Blackman-Nuttall windowed-sinc bandpass (CFastFIR capability,
fastfir.cpp:191-272).  ``apply_many`` runs K overlap-save rounds at once and
equals K sequential ``apply`` calls to FFT rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from pebblesdr_tpu_torch.core import windows as win
from pebblesdr_tpu_torch.ops import fir

SEG_MULT = 8  # dispatch-path FFT segment length, in blocks (power of two)


def design_mask(lo_hz: float, hi_hz: float, sample_rate: float, block: int,
                offset_hz: float = 0.0) -> np.ndarray:
    """Frequency-domain filter mask [2*block] complex64 for overlap-save."""
    lo = lo_hz + offset_hz
    hi = hi_hz + offset_hz
    nyq = sample_rate / 2.0
    lo = max(lo, -nyq + 1.0)
    hi = min(hi, nyq - 1.0)
    assert hi > lo, f"bad bandpass {lo_hz}..{hi_hz}"
    fft_size = 2 * block
    ntaps = block + 1
    taps = fir.design_bandpass_complex(lo, hi, sample_rate, ntaps,
                                       kind=win.WindowType.BLACKMAN_NUTTALL)
    buf = np.zeros(fft_size, dtype=np.complex128)
    buf[:ntaps] = taps
    return np.fft.fft(buf).astype(np.complex64)


def state_init(channels: int, block: int, device) -> torch.Tensor:
    return torch.zeros(channels, block, dtype=torch.complex64, device=device)


def apply(state: torch.Tensor, x: torch.Tensor, mask: torch.Tensor):
    """One overlap-save step.  x, state: [C, B]; mask [2B] complex64."""
    xx = torch.cat([state, x], dim=-1)
    filtered = torch.fft.ifft(torch.fft.fft(xx, dim=-1) * mask[None, :], dim=-1)
    b = x.shape[-1]
    return x, filtered[:, b:].to(torch.complex64)


def apply_many(state: torch.Tensor, x_cat: torch.Tensor, mask: torch.Tensor,
               block: int, seg_mult: int = SEG_MULT):
    """K overlap-save rounds in one batched FFT.  x_cat: [C, K*block],
    state: [C, block].  Returns (state', y [C, K*block]).

    With K >= seg_mult > 2 the segments lengthen to L = seg_mult*B, each
    emitting L - B samples (the 2B-bin mask converts to L bins through its
    B+1 taps); otherwise window k pairs blocks (k, k+1) at 50% overlap."""
    c, l = x_cat.shape
    k = l // block
    ext = torch.cat([state, x_cat], dim=-1)            # [C, (K+1)*B]
    b = block
    if seg_mult > 2 and k >= seg_mult:
        t = (seg_mult - 1) * b                         # outputs per segment
        n_seg = -(-l // t)
        need = (n_seg + 1) * t
        ext_p = (torch.nn.functional.pad(ext, (0, need - ext.shape[-1]))
                 if need > ext.shape[-1] else ext)
        lo = ext_p[:, :n_seg * t].reshape(c, n_seg, t)
        hi = ext_p[:, t:t + n_seg * t].reshape(c, n_seg, t)[:, :, :b]
        wins = torch.cat([lo, hi], dim=-1)              # [C, S, T+B]
        taps = torch.fft.ifft(mask)[:b + 1]
        mask_l = torch.fft.fft(taps, n=t + b)
        filtered = torch.fft.ifft(torch.fft.fft(wins, dim=-1)
                                  * mask_l[None, None, :], dim=-1)
        y = filtered[:, :, b:].reshape(c, n_seg * t)[:, :l]
        return ext[:, ext.shape[-1] - b:], y.to(torch.complex64)
    lo = ext[:, :l].reshape(c, k, block)               # blocks 0..K-1
    hi = ext[:, block:].reshape(c, k, block)           # blocks 1..K
    wins = torch.cat([lo, hi], dim=-1)                 # [C, K, 2B]
    filtered = torch.fft.ifft(torch.fft.fft(wins, dim=-1)
                              * mask[None, None, :], dim=-1)
    y = filtered[:, :, block:].reshape(c, l)
    return ext[:, ext.shape[-1] - block:], y.to(torch.complex64)
