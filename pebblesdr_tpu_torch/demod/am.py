"""AM envelope demodulator (port of pebblesdr_tpu/demod/am.py).

Magnitude detection, chunked DC removal (alpha 0.9999, 256-sample chunks)
and the post-detection Kaiser low-pass at half the filter bandwidth
(Demod_AM capability, demod_am.cpp:36-64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import fir, iir


@dataclasses.dataclass(frozen=True)
class AMConfig:
    sample_rate: float
    bandwidth: float
    taps: np.ndarray  # post-detect LP FIR (host-designed)

    @staticmethod
    def make(sample_rate: float, bandwidth: float = 12000.0) -> "AMConfig":
        taps = fir.design_lowpass_kaiser(bandwidth / 2.0, sample_rate, atten_db=50.0)
        return AMConfig(sample_rate=sample_rate, bandwidth=bandwidth, taps=taps)


@dataclasses.dataclass(frozen=True)
class AMState:
    dc: torch.Tensor       # [C] DC-blocker mean
    lp_tail: torch.Tensor  # [C, taps-1] FIR tail


def am_init(cfg: AMConfig, channels: int, device) -> AMState:
    return AMState(
        dc=torch.zeros(channels, dtype=torch.float32, device=device),
        lp_tail=torch.zeros(channels, max(len(cfg.taps) - 1, 0),
                            dtype=torch.float32, device=device),
    )


def am_demod(cfg: AMConfig, state: AMState, x: torch.Tensor):
    """x: [C, N] complex64 (post-bandpass) -> (state', audio [C, N] float32)."""
    mag = torch.abs(x)
    dc, audio = iir.dc_removal_chunked(state.dc, mag, alpha=0.9999, chunk=256)
    audio, tail = fir.fir_apply_real_signal(audio, state.lp_tail, cfg.taps)
    return AMState(dc=dc, lp_tail=tail), audio
