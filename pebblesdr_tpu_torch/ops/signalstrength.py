"""Frequency-domain signal strength: in-band power, side-band noise, SNR.

Port of pebblesdr_tpu/ops/signalstrength.py (fdEstimate capability,
signalstrength.cpp:289-378) on the linear power spectrum of the demod-rate
block.  The masks are host-designed runtime inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from pebblesdr_tpu_torch.core import db as dbu


def band_bins(lo_hz: float, hi_hz: float, sample_rate: float, n_bins: int):
    """fftshifted bin index range [start, stop) covering lo..hi Hz."""
    res = sample_rate / n_bins
    start = int(np.floor(lo_hz / res)) + n_bins // 2
    stop = int(np.ceil(hi_hz / res)) + n_bins // 2
    start = max(0, min(n_bins - 1, start))
    stop = max(start + 1, min(n_bins, stop))
    return start, stop


def band_masks(lo_hz: float, hi_hz: float, sample_rate: float, n_bins: int):
    """(band_mask, noise_mask) [n_bins] float32 numpy."""
    start, stop = band_bins(lo_hz, hi_hz, sample_rate, n_bins)
    width = stop - start
    band = np.zeros(n_bins, np.float32)
    band[start:stop] = 1.0
    noise = np.zeros(n_bins, np.float32)
    noise[max(0, start - width):start] = 1.0
    noise[stop:min(n_bins, stop + width)] = 1.0
    if noise.sum() == 0:
        noise[:] = 1.0
    return band, noise


def fd_estimate_masked(power_lin: torch.Tensor, band_mask: torch.Tensor,
                       noise_mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """power_lin [R, bins], masks [bins] -> dict(signal_db, peak_db,
    noise_db, snr_db), each [R]."""
    nb = torch.clamp_min(torch.sum(band_mask), 1.0)
    nn = torch.clamp_min(torch.sum(noise_mask), 1.0)
    sig_avg = torch.sum(power_lin * band_mask, dim=-1) / nb
    sig_peak = torch.amax(power_lin * band_mask, dim=-1)
    noise = torch.sum(power_lin * noise_mask, dim=-1) / nn
    return {
        "signal_db": dbu.power_to_db(sig_avg),
        "peak_db": dbu.power_to_db(sig_peak),
        "noise_db": dbu.power_to_db(noise),
        "snr_db": dbu.power_to_db(sig_avg) - dbu.power_to_db(noise),
    }
