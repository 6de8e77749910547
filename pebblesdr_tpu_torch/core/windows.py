"""FFT window functions with coherent-gain / ENBW metadata (host, numpy).

Port of pebblesdr_tpu/core/windows.py (copied, not imported: the JAX
package's ``core/__init__`` imports jax).  Windows are designed in float64
and returned as numpy arrays; callers move them to their device once.
"""

from __future__ import annotations

import enum

import numpy as np


class WindowType(enum.Enum):
    RECTANGULAR = "rectangular"
    HANNING = "hanning"
    HAMMING = "hamming"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS = "blackmanharris"
    BLACKMAN_NUTTALL = "blackmannuttall"
    FLATTOP = "flattop"


# cosine-sum coefficients a0..a3(.. a4 for flattop)
_COSINE_SUM = {
    WindowType.HANNING: [0.5, 0.5],
    WindowType.HAMMING: [0.54, 0.46],
    WindowType.BLACKMAN: [0.42, 0.5, 0.08],
    WindowType.BLACKMAN_HARRIS: [0.35875, 0.48829, 0.14128, 0.01168],
    WindowType.BLACKMAN_NUTTALL: [0.3635819, 0.4891775, 0.1365995, 0.0106411],
    WindowType.FLATTOP: [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368],
}


def window(kind: WindowType, n: int, periodic: bool = True) -> np.ndarray:
    """Window of length n as float64 (periodic: denominator n; symmetric FIR
    designs pass periodic=False)."""
    if kind == WindowType.RECTANGULAR:
        return np.ones(n, dtype=np.float64)
    coeffs = _COSINE_SUM[kind]
    denom = n if periodic else n - 1
    x = 2.0 * np.pi * np.arange(n) / denom
    w = np.zeros(n, dtype=np.float64)
    for k, a in enumerate(coeffs):
        w += ((-1.0) ** k) * a * np.cos(k * x)
    return w


def coherent_gain(w: np.ndarray) -> float:
    """Mean of window — scales a coherent tone; used to normalize dB spectra."""
    return float(np.mean(w))


def enbw(w: np.ndarray) -> float:
    """Equivalent noise bandwidth in bins: N*sum(w^2)/sum(w)^2."""
    return float(len(w) * np.sum(w**2) / np.sum(w) ** 2)
