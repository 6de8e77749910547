"""CTCSS tone squelch (port of the CTCSS part of pebblesdr_tpu/ops/goertzel.py).

Neighbouring CTCSS tones sit 2.3-4 Hz apart, closer than one audio block's
DFT bins.  Per block the configured tone's and its two table neighbours'
single-bin DFT responses are de-rotated by the block-start phase of each
tone (advanced in closed form by 2 pi f blk / fs per block) and EWMA-ed as
complex values: coherent integration with a 0.25 s time constant, ~1-2 Hz
of noise bandwidth.  The squelch opens when the tone's integrated power
beats nb_ratio x both neighbours' and an absolute floor.  The K-block form
(ctcss_update_many) is one lower-triangular matmul (iir.ewma_tables).

Not ported: the Goertzel power/OOK detectors and the DTMF tables.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import iir

# CTCSS sub-audible squelch tones in Hz (goertzel.h:232-277)
CTCSS_TONES = [
    67.0, 69.3, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5, 94.8, 97.4,
    100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3, 131.8, 136.5,
    141.3, 146.2, 151.4, 156.7, 162.2, 167.9, 173.8, 179.9, 186.2, 192.8,
    203.5, 210.7, 218.1, 225.7, 233.6, 241.8, 250.3,
]


def dft_vectors(freqs_hz, sample_rate: float, n: int) -> np.ndarray:
    """[num_bins, n] complex64 DFT basis rows (non-integer k supported)."""
    freqs = np.atleast_1d(np.asarray(freqs_hz, np.float64))
    t = np.arange(n, dtype=np.float64)
    return np.exp(-2j * np.pi * freqs[:, None] * t[None, :]
                  / sample_rate).astype(np.complex64)


@dataclasses.dataclass(frozen=True, eq=False)
class CtcssConfig:
    tone_hz: float
    alpha: float             # per-block EWMA
    nb_ratio: float          # tone power vs the larger neighbour's
    min_power: float         # absolute floor (silence)
    basis_re: np.ndarray     # [3, blk] block-local DFT rows (tone, lo, hi)
    basis_im: np.ndarray
    dphi: np.ndarray         # [3] phase advance per block (rad)

    @staticmethod
    def make(tone_hz: float, sample_rate: float, blk: int,
             tau_s: float = 0.25, nb_ratio: float = 4.0,
             min_power: float = 1e-5) -> "CtcssConfig":
        tones = sorted(CTCSS_TONES)
        if tone_hz not in tones:
            raise ValueError(f"{tone_hz} Hz is not a CTCSS table tone")
        i = tones.index(tone_hz)
        lo = tones[i - 1] if i > 0 else tone_hz - 2.3
        hi = tones[i + 1] if i + 1 < len(tones) else tone_hz + 4.0
        freqs = [tone_hz, lo, hi]
        basis = dft_vectors(freqs, sample_rate, blk)
        dphi = (2.0 * np.pi * np.asarray(freqs, np.float64) * blk
                / sample_rate) % (2.0 * np.pi)
        return CtcssConfig(tone_hz=tone_hz,
                           alpha=float(np.exp(-(blk / sample_rate) / tau_s)),
                           nb_ratio=nb_ratio, min_power=min_power,
                           basis_re=basis.real.astype(np.float32),
                           basis_im=basis.imag.astype(np.float32),
                           dphi=dphi.astype(np.float32))


@dataclasses.dataclass(frozen=True)
class CtcssState:
    iq: torch.Tensor     # [C, 3, 2] EWMA of the de-rotated (re, im) responses
    phase: torch.Tensor  # [3] block-start phase of each tone (rad)


def ctcss_init(channels: int, device) -> CtcssState:
    return CtcssState(
        iq=torch.zeros(channels, 3, 2, dtype=torch.float32, device=device),
        phase=torch.zeros(3, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=16)
def _tables(cfg: CtcssConfig, device: torch.device):
    """(basis_re.T, basis_im.T [blk, 3], dphi [3]) on the device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cfg.basis_re.T, cfg.basis_im.T, cfg.dphi))


def _ctcss_resp(cfg: CtcssConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio [..., blk] real -> block responses [..., 3, 2] (re, im)."""
    bre, bim, _ = _tables(cfg, audio.device)
    blk = audio.shape[-1]
    return torch.stack([torch.matmul(audio, bre) / blk,
                        torch.matmul(audio, bim) / blk], dim=-1)


def _ctcss_open(cfg: CtcssConfig, iq: torch.Tensor) -> torch.Tensor:
    p = torch.sum(iq * iq, dim=-1)                            # [..., 3]
    p_tone = p[..., 0]
    return ((p_tone > cfg.nb_ratio * torch.maximum(p[..., 1], p[..., 2]))
            & (p_tone > cfg.min_power))


def _rot(iq: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate (re, im) pairs by -phase, given cos and sin of the phase."""
    re = iq[..., 0] * cos + iq[..., 1] * sin
    im = iq[..., 1] * cos - iq[..., 0] * sin
    return torch.stack([re, im], dim=-1)


def ctcss_update(cfg: CtcssConfig, state: CtcssState, audio: torch.Tensor):
    """One block: audio [C, blk] real -> (state', open [C] bool)."""
    resp = _rot(_ctcss_resp(cfg, audio), torch.cos(state.phase)[None],
                torch.sin(state.phase)[None])
    a = cfg.alpha
    iq = a * state.iq + (1.0 - a) * resp
    dphi = _tables(cfg, audio.device)[2]
    phase = torch.remainder(state.phase + dphi, 2.0 * math.pi)
    return CtcssState(iq=iq, phase=phase), _ctcss_open(cfg, iq)


def ctcss_update_many(cfg: CtcssConfig, state: CtcssState,
                      audio: torch.Tensor):
    """K blocks at once: audio [K, C, blk] -> (state', open [K, C] bool).
    Block k's responses are de-rotated by phase + k dphi; the cross-block
    EWMA is the closed-form lower-triangular matmul."""
    k = audio.shape[0]
    resp = _ctcss_resp(cfg, audio)                            # [K, C, 3, 2]
    dphi = _tables(cfg, audio.device)[2]
    ks = torch.arange(k, dtype=torch.float32, device=audio.device)
    ang = state.phase[None, :] + ks[:, None] * dphi[None, :]  # [K, 3]
    resp = _rot(resp, torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :])
    lmat, seed = iir.ewma_tables(k, cfg.alpha, audio.device)
    iq = (torch.matmul(lmat, resp.reshape(k, -1)).reshape(resp.shape)
          + seed[:, None, None, None] * state.iq[None])
    phase = torch.remainder(state.phase + k * dphi, 2.0 * math.pi)
    return CtcssState(iq=iq[-1], phase=phase), _ctcss_open(cfg, iq)
