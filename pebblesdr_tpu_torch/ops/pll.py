"""Open-loop 19 kHz pilot recovery for WFM stereo (no per-sample scan).

Port of the open pilot of pebblesdr_tpu/ops/pll.py (PilotOpenConfig,
pilot_open_core / pilot_open_core_tm / _pilot_open_post).  Per chunk of L
samples: (1) a Hann-windowed DFT bin at the pilot frequency gives one phasor
(a matmul; the window is the pilot bandpass); (2) the conj product of
successive chunk phasors measures the frequency deviation, smoothed by an
EWMA in closed form; (3) a cumsum integrates it into a phase; (4) the
residual phasor, EWMA-smoothed, gives the remaining phase offset and the
lock level.  The per-sample pilot phase is linear within each chunk:
phase(fL + t) = p0[f] + wf[f] t.  Every matmul is IEEE float32 (the JAX
package asks Precision.HIGHEST: bf16 EWMA matmuls bias the loops).

The closed-loop PLL ("pll" pilot) is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import iir

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class PilotOpenConfig:
    freq_center: float        # rad/sample (the 19 kHz ramp)
    dev_max: float            # rad/sample clamp on the frequency estimate
    chunk: int = 256
    bw_hz: float = 10.0       # loop bandwidth
    sample_rate: float = 0.0  # the EWMA alphas follow the chunk actually used


def make_pilot_open_config(sample_rate: float, pilot_hz: float = 19000.0,
                           range_hz: float = 100.0, bw_hz: float = 10.0,
                           chunk: int = 256) -> PilotOpenConfig:
    wc = TWO_PI * pilot_hz / sample_rate
    return PilotOpenConfig(freq_center=wc,
                           dev_max=TWO_PI * range_hz / sample_rate,
                           chunk=chunk, bw_hz=bw_hz,
                           sample_rate=float(sample_rate))


@dataclasses.dataclass(frozen=True)
class PilotOpenState:
    z_prev: torch.Tensor  # [C] complex64: previous chunk phasor (ramp-referenced)
    dw: torch.Tensor      # [C] f32: frequency deviation estimate, rad/sample
    psi: torch.Tensor     # [C] f32: integrated deviation phase at the next chunk
    r: torch.Tensor       # [C] complex64: smoothed residual phasor
    base: torch.Tensor    # [C] f32: pilot ramp phase at the next sample (mod 2 pi)


def pilot_open_init(channels: int, device) -> PilotOpenState:
    def zeros(dtype):
        return torch.zeros(channels, dtype=dtype, device=device)

    return PilotOpenState(z_prev=zeros(torch.complex64),
                          dw=zeros(torch.float32), psi=zeros(torch.float32),
                          r=zeros(torch.complex64), base=zeros(torch.float32))


def _ewma_closed(prev: torch.Tensor, p: torch.Tensor, a: float) -> torch.Tensor:
    """y_k = a y_{k-1} + (1-a) p_k over the trailing axis of p [C, K], seeded
    by prev [C], as one [K, K] matmul.  Real or complex."""
    lmat, seed = iir.ewma_tables(p.shape[-1], float(a), p.device)
    lmat = lmat.T
    if p.is_complex():
        re = torch.matmul(p.real, lmat) + prev.real[..., None] * seed
        im = torch.matmul(p.imag, lmat) + prev.imag[..., None] * seed
        return torch.complex(re, im)
    return torch.matmul(p, lmat) + prev[..., None] * seed


@functools.lru_cache(maxsize=16)
def _chunk_tables(wc: float, ell: int, f: int, device: torch.device):
    """The chunk-DFT matrix [L, 2] (Hann window x pilot ramp, re/im), the
    per-chunk ramp phase (cos, sin, value) [F] and the in-chunk index [L]."""
    t_in = np.arange(ell, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * t_in / ell)   # periodic Hann
    win = win / win.sum()
    mat = win * np.exp(-1j * wc * t_in)
    ramp_f = np.mod(wc * ell * np.arange(f, dtype=np.float64), 2 * np.pi)
    as_dev = functools.partial(torch.as_tensor, device=device)
    return (as_dev(np.stack([mat.real, mat.imag], axis=1).astype(np.float32)),
            as_dev(np.cos(ramp_f).astype(np.float32)),
            as_dev(np.sin(ramp_f).astype(np.float32)),
            as_dev(ramp_f.astype(np.float32)),
            as_dev(t_in.astype(np.float32)))


def _alpha(cfg: PilotOpenConfig, ell: int) -> float:
    """EWMA coefficient at the chunk actually used (keeps the configured loop
    bandwidth when the chunk adapts to the block length)."""
    fs = cfg.sample_rate or (TWO_PI * 19000.0 / cfg.freq_center)
    return math.exp(-TWO_PI * cfg.bw_hz * ell / fs)


def pilot_open_core(cfg: PilotOpenConfig, state: PilotOpenState,
                    raw: torch.Tensor, chunk: int | None = None):
    """Track the pilot in the channel-major composite raw [C, N] float32.

    Returns (state', (p0 [C, F], wf [C, F], t_in [L]), level [C, F])."""
    c, n = raw.shape
    ell = int(chunk or cfg.chunk)
    if n % ell:
        raise ValueError(f"composite of {n} samples is not a whole number of "
                         f"{ell}-sample pilot chunks")
    f = n // ell
    tabs = _chunk_tables(cfg.freq_center, ell, f, raw.device)
    zz = torch.matmul(raw.reshape(c, f, ell), tabs[0])      # [C, F, 2]
    z = torch.complex(zz[..., 0], zz[..., 1])
    return _pilot_open_post(cfg, state, z, ell, n, _alpha(cfg, ell), *tabs[1:])


def pilot_open_core_tm(cfg: PilotOpenConfig, state: PilotOpenState,
                       raw_t: torch.Tensor, chunk: int | None = None):
    """pilot_open_core for the time-major composite raw_t [N, C] that the
    front end's discriminator emits: the chunk-DFT matmul runs on the
    time-major rows, and only the [C, F] phasors are transposed."""
    n, c = raw_t.shape
    ell = int(chunk or cfg.chunk)
    if n % ell:
        raise ValueError(f"composite of {n} samples is not a whole number of "
                         f"{ell}-sample pilot chunks")
    f = n // ell
    tabs = _chunk_tables(cfg.freq_center, ell, f, raw_t.device)
    # [F, L, C] x [L, 2] -> [F, C, 2] -> [C, F, 2]
    zz = torch.matmul(raw_t.reshape(f, ell, c).transpose(1, 2), tabs[0])
    zz = zz.transpose(0, 1)
    z = torch.complex(zz[..., 0].contiguous(), zz[..., 1].contiguous())
    return _pilot_open_post(cfg, state, z, ell, n, _alpha(cfg, ell), *tabs[1:])


def _pilot_open_post(cfg, state, z, ell, n, alpha, rotf_c, rotf_s, ramp_d,
                     tin_d):
    """Chunk phasors z [C, F] -> smoothed frequency/phase params."""
    wc = cfg.freq_center
    rotf = torch.complex(rotf_c, -rotf_s)                 # e^{-j ramp_f}
    z = z * rotf[None, :] * torch.exp(-1j * state.base)[:, None]

    # frequency: conj product between successive chunk phasors
    zprev = torch.cat([state.z_prev[:, None], z[:, :-1]], dim=1)
    d = z * torch.conj(zprev)
    dwm = torch.clamp(torch.atan2(d.imag, d.real) / ell,
                      -cfg.dev_max, cfg.dev_max)
    dw = _ewma_closed(state.dw, dwm, alpha)               # [C, F]

    # integrated deviation phase at chunk starts (exclusive cumsum, seeded)
    cs = torch.cumsum(dw, dim=-1)
    psi = state.psi[:, None] + ell * (cs - dw)            # [C, F]
    psi_next = state.psi + ell * cs[:, -1]

    # residual phasor, smoothed; its angle is the remaining phase offset
    rres = z * torch.exp(-1j * psi)
    r = _ewma_closed(state.r, rres, alpha)                # [C, F]
    ang = torch.atan2(r.imag, r.real)
    level = torch.abs(r)

    new_state = PilotOpenState(
        z_prev=z[:, -1], dw=dw[:, -1],
        psi=torch.remainder(psi_next + math.pi, TWO_PI) - math.pi,
        r=r[:, -1],
        base=torch.remainder(state.base + float(np.mod(wc * n, 2 * np.pi)),
                             TWO_PI))
    # +pi/2: "phase of e^{j psi}" -> the pilot ~= A sin(phase) convention
    p0 = state.base[:, None] + ramp_d[None, :] + psi + ang + (math.pi / 2.0)
    wf = wc + dw
    return new_state, (p0, wf, tin_d), level
