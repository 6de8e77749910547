"""Frequency-domain signal strength: in-band power, side-band noise, SNR.

Port of pebblesdr_tpu/ops/signalstrength.py (fdEstimate capability,
signalstrength.cpp:289-378) on the linear power spectrum of the demod-rate
block: by masks (fd_estimate_masked, the Receiver's; the masks are
host-designed runtime inputs) or by a bin range (fd_estimate); and the
time-domain estimate td_estimate.
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


def fd_estimate(power_lin: torch.Tensor, start: int, stop: int):
    """power_lin [C, bins] linear fftshifted power spectrum -> dict(signal_db,
    peak_db, noise_db, snr_db), each [C].  Noise is measured in two side
    windows of the band's width directly below and above it (clipped to the
    spectrum's edges), like fdEstimate."""
    n_bins = power_lin.shape[-1]
    width = stop - start
    band = power_lin[:, start:stop]
    sig_avg = torch.mean(band, dim=-1)
    sig_peak = torch.amax(band, dim=-1)
    lo_s = max(0, start - width)
    lo_e = max(lo_s + 1, start)
    hi_s = min(n_bins - 1, stop)
    hi_e = min(n_bins, stop + width)
    noise = (torch.sum(power_lin[:, lo_s:lo_e], dim=-1)
             + torch.sum(power_lin[:, hi_s:hi_e], dim=-1)) / (
        (lo_e - lo_s) + (hi_e - hi_s))
    return {
        "signal_db": dbu.power_to_db(sig_avg),
        "peak_db": dbu.power_to_db(sig_peak),
        "noise_db": dbu.power_to_db(noise),
        "snr_db": dbu.power_to_db(sig_avg) - dbu.power_to_db(noise),
    }


def td_estimate(x: torch.Tensor):
    """Time-domain RMS / peak estimate [C] in dB (signalstrength.cpp:
    195-285) of x [C, N]."""
    p = x.abs() ** 2
    return {
        "rms_db": dbu.power_to_db(torch.mean(p, dim=-1)),
        "peak_db": dbu.power_to_db(torch.amax(p, dim=-1)),
    }
