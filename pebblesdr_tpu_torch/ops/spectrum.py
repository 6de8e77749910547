"""Windowed power spectrum by DFT matmul (port of pebblesdr_tpu/ops/spectrum.py):
dB spectra (power_spectrum, averaged_spectrum), the FFT-to-pixel
reduction (map_to_screen) and the host-side Waterfall buffer.

The fftshifted DFT runs as real matmuls in the Karatsuba form (three
products instead of four).  Every matmul here must run in IEEE float32: a
reduced-precision product (TF32 on the card, bf16 on the CPU under
"medium", one-pass bf16 on the TPU) lifts the S-meter noise floor by tens
of dB, so shifted_power pins IEEE float32 for its products whatever the
process has set (utils/precision.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pebblesdr_tpu_torch.core import db as dbu
from pebblesdr_tpu_torch.core import windows as win
from pebblesdr_tpu_torch.utils.precision import ieee_float32

MIN_BINS = 2048   # fft.h:21
MAX_BINS = 65535  # fft.h:22
OVERLOAD_LEVEL = 1.0  # |sample| above full scale = ADC overload
_DFT_MAX_MATMUL = 4096


def make_window(n_bins: int, kind: win.WindowType = win.WindowType.BLACKMAN_HARRIS):
    """Returns (window [n] float32 numpy, coherent_gain scalar)."""
    w = win.window(kind, n_bins, periodic=True)
    return np.asarray(w, np.float32), win.coherent_gain(w)


def dft_mats_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the DFT matrix with fftshifted output columns, float32."""
    k = np.arange(n)
    shifted_rows = np.fft.fftshift(k)  # output bin order -f..+f
    w = np.exp(-2j * np.pi * np.outer(k, shifted_rows) / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_mats(n: int, device: torch.device):
    fr, fi = dft_mats_np(n)
    fr_t = torch.from_numpy(fr).to(device)
    fi_t = torch.from_numpy(fi).to(device)
    return fr_t, fi_t, fr_t + fi_t


@ieee_float32()
def shifted_power(xw: torch.Tensor) -> torch.Tensor:
    """|fftshift(fft(xw))|^2 for [..., N] complex64, via real matmuls."""
    n = xw.shape[-1]
    if n > _DFT_MAX_MATMUL:
        spec = torch.fft.fftshift(torch.fft.fft(xw, dim=-1), dim=-1)
        return spec.real ** 2 + spec.imag ** 2
    fr, fi, fs = _dft_mats(n, xw.device)
    xr, xi = xw.real, xw.imag
    t1 = torch.matmul(xr, fr)
    t2 = torch.matmul(xi, fi)
    t3 = torch.matmul(xr + xi, fs)
    sr = t1 - t2
    si = t3 - t1 - t2
    return sr * sr + si * si


@dataclasses.dataclass(frozen=True)
class SpectrumState:
    avg_power: torch.Tensor  # [C, bins] linear power running average


def state_init(channels: int, n_bins: int, device) -> SpectrumState:
    return SpectrumState(avg_power=torch.zeros(channels, n_bins,
                                               dtype=torch.float32,
                                               device=device))


def averaged_spectrum(state: SpectrumState, x: torch.Tensor, window: torch.Tensor,
                      coherent_gain: float, smoothing: float = 0.0,
                      db_offset: float = 0.0):
    """x: [C, N] complex64 -> (state', dB [C, N] fftshifted, overload [C]),
    exponential averaging in the linear-power domain."""
    n = x.shape[-1]
    overload = torch.amax(torch.abs(x.real), dim=-1) > OVERLOAD_LEVEL
    xw = x * window[None, :]
    norm = 1.0 / (n * coherent_gain)
    power = shifted_power(xw) * (norm * norm)
    avg = smoothing * state.avg_power + (1.0 - smoothing) * power
    return SpectrumState(avg_power=avg), dbu.power_to_db(avg) + db_offset, overload


def power_spectrum(x: torch.Tensor, window: torch.Tensor, coherent_gain: float,
                   db_offset: float = 0.0):
    """x: [C, N] complex64 -> (spectrum_db [C, N] fftshifted, overload [C]
    bool), on x's device.  0 dB == a full-scale coherent tone (the window's
    coherent gain normalized out, fft.cpp:351-360)."""
    n = x.shape[-1]
    overload = torch.amax(torch.abs(x.real), dim=-1) > OVERLOAD_LEVEL
    xw = x * window[None, :]
    norm = 1.0 / (n * coherent_gain)
    power = shifted_power(xw) * (norm * norm)
    return dbu.power_to_db(power) + db_offset, overload


def map_to_screen(spectrum_db: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """Max-bin FFT->pixel reduction (mapFFTToScreen capability,
    signalspectrum.cpp:137-168) on the rows' device.  Requires bins %
    n_pixels == 0; max preserves narrow signals."""
    c, bins = spectrum_db.shape
    assert bins % n_pixels == 0, "bins must divide evenly into pixels"
    return torch.amax(spectrum_db.reshape(c, n_pixels, bins // n_pixels),
                      dim=-1)


class Waterfall:
    """Host-side rolling waterfall buffer (SpectrumWidget waterfall-mode data
    product, spectrumwidget.h:18-90): push per-block dB rows (numpy or a
    tensor on any device: the row is reduced to pixels there and only the
    pixels are fetched), read a [rows, pixels] image array (newest last)."""

    def __init__(self, n_pixels: int, depth: int = 256):
        self.n_pixels = n_pixels
        self.depth = depth
        self._buf = np.full((depth, n_pixels), -160.0, np.float32)

    def push(self, spectrum_db) -> None:
        rows = torch.as_tensor(spectrum_db)
        if rows.ndim == 1:
            rows = rows[None]
        row = map_to_screen(rows, self.n_pixels)[0].cpu().numpy()
        self._buf = np.roll(self._buf, -1, axis=0)
        self._buf[-1] = row

    @property
    def image(self) -> np.ndarray:
        return self._buf
