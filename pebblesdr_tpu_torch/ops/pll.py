"""Open-loop carrier recovery (no per-sample scan): the 19 kHz pilot for WFM
stereo and the squaring loop for RDS's BPSK subcarrier.

Port of the open pilot of pebblesdr_tpu/ops/pll.py (PilotOpenConfig,
pilot_open_core / pilot_open_core_tm / _pilot_open_post) and of its
scan-free squaring loop (CostasOpenConfig, costas_open_run).  The pilot,
per chunk of L samples: (1) a Hann-windowed DFT bin at the pilot frequency gives one phasor
(a matmul; the window is the pilot bandpass); (2) the conj product of
successive chunk phasors measures the frequency deviation, smoothed by an
EWMA in closed form; (3) a cumsum integrates it into a phase; (4) the
residual phasor, EWMA-smoothed, gives the remaining phase offset and the
lock level.  The per-sample pilot phase is linear within each chunk:
phase(fL + t) = p0[f] + wf[f] t.  Every matmul is IEEE float32 (the JAX
package asks Precision.HIGHEST: bf16 EWMA matmuls bias the loops).

The two-stage aimed carrier loop of SAM (pll_run_aimed) is ported with its
open stage-2 smoother (costas_open_run, square=False).  The closed-loop
PLL (pll_run, the per-sample scan: the "pll" pilot and SAM's
algorithm="scan") and the chunked loop (pll_run_blockwise: SAM's
smooth="loop") are not; of them only the configuration (PLLConfig,
make_pll_config) and the state (PLLState, pll_init) are, because RdsConfig
and SAMState carry them.
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


# ------------------------------------------- closed-loop PLL configuration

@dataclasses.dataclass(frozen=True)
class PLLConfig:
    """The per-sample PLL's gains and clamps (its run is not ported)."""
    alpha: float
    beta: float
    freq_center: float   # radians/sample NCO center
    freq_lo: float       # radians/sample clamp
    freq_hi: float
    detector: str = "atan2"


def make_pll_config(sample_rate: float, bw_hz: float, zeta: float = 0.707,
                    center_hz: float = 0.0, range_hz: float = 1000.0,
                    detector: str = "atan2") -> PLLConfig:
    wn = TWO_PI * bw_hz / sample_rate
    norm = TWO_PI / sample_rate
    return PLLConfig(alpha=2.0 * zeta * wn, beta=wn * wn,
                     freq_center=center_hz * norm,
                     freq_lo=(center_hz - range_hz) * norm,
                     freq_hi=(center_hz + range_hz) * norm, detector=detector)


@dataclasses.dataclass(frozen=True)
class PLLState:
    phase: torch.Tensor  # [C] radians
    fdev: torch.Tensor   # [C] radians/sample deviation from freq_center
    amp: torch.Tensor    # [C] EWMA of |input| (detector gain normalization)


def pll_init(cfg: PLLConfig, channels: int, device) -> PLLState:
    def full(v):
        return torch.full((channels,), v, dtype=torch.float32, device=device)

    return PLLState(phase=full(0.0), fdev=full(0.0), amp=full(1.0))


# --------------------------------------- open-loop BPSK carrier (RDS, squared)

@dataclasses.dataclass(frozen=True)
class CostasOpenConfig:
    """Scan-free BPSK carrier recovery by squaring: s = x^2 drops the +-1
    data and leaves a tone at twice the carrier offset.  Per chunk, the
    conj product of successive chunk means measures the squared-carrier
    frequency (EWMA in closed form), a cumsum integrates it, and the
    smoothed residual phasor's unwrapped angle corrects the phase; the
    carrier phase is half the tracked one (the pi ambiguity is a BPSK sign
    flip, which RDS's differential coding absorbs).  square=False tracks a
    plain carrier with the same machinery."""
    dev_max: float                # rad/sample clamp (carrier frequency)
    chunk: int = 64
    bw_hz: float = 30.0
    sample_rate: float = 19000.0


def make_costas_open_config(sample_rate: float, range_hz: float = 200.0,
                            bw_hz: float = 30.0, chunk: int = 64,
                            square: bool = True) -> CostasOpenConfig:
    """The chunk shrinks until range_hz is measurable without aliasing: the
    chunk-to-chunk product reads |w L| < pi (2 w squared)."""
    wmax = (2.0 if square else 1.0) * TWO_PI * range_hz / sample_rate
    chunk = int(chunk)
    while chunk > 1 and wmax * chunk >= 0.9 * math.pi:
        chunk //= 2
    return CostasOpenConfig(dev_max=TWO_PI * range_hz / sample_rate,
                            chunk=chunk, bw_hz=bw_hz,
                            sample_rate=float(sample_rate))


@dataclasses.dataclass(frozen=True)
class CostasOpenState:
    w2: torch.Tensor      # [C] f32 smoothed squared-carrier freq (rad/sample)
    psi: torch.Tensor     # [C] f32 integrated squared-carrier phase
    r: torch.Tensor       # [C] complex64 smoothed residual phasor
    ang: torch.Tensor     # [C] f32 unwrapped residual angle
    z_prev: torch.Tensor  # [C] complex64 previous chunk phasor


def costas_open_init(channels: int, device) -> CostasOpenState:
    def zeros(dtype):
        return torch.zeros(channels, dtype=dtype, device=device)

    return CostasOpenState(w2=zeros(torch.float32), psi=zeros(torch.float32),
                           r=zeros(torch.complex64), ang=zeros(torch.float32),
                           z_prev=zeros(torch.complex64))


def costas_open_run(cfg: CostasOpenConfig, state: CostasOpenState,
                    x: torch.Tensor, chunk: int | None = None,
                    square: bool = True):
    """Track the BPSK carrier (square=True) or a plain carrier in x [C, N]
    complex64.  Returns (state', phases [C, N] carrier phase, level [C, F]
    lock level); streaming-exact for any whole-chunk blocking.  Coherent
    demod = (x * exp(-1j phases)).real."""
    c, n = x.shape
    ell = int(chunk or cfg.chunk)
    if n % ell:
        raise ValueError(f"carrier input of {n} samples is not a whole "
                         f"number of {ell}-sample chunks")
    f = n // ell
    alpha = math.exp(-TWO_PI * cfg.bw_hz * ell / cfg.sample_rate)

    s3 = (x * x if square else x).reshape(c, f, ell)
    zf = s3.mean(dim=-1)                                   # [C, F]
    zp = torch.cat([state.z_prev[:, None], zf[:, :-1]], dim=1)
    dm = zf * torch.conj(zp)
    lim = min((2.0 if square else 1.0) * cfg.dev_max, math.pi / ell)
    w2m = torch.clamp(torch.atan2(dm.imag, dm.real) / ell, -lim, lim)
    w2 = _ewma_closed(state.w2, w2m, alpha)                # [C, F]

    cs = torch.cumsum(w2, dim=-1)
    psi0 = state.psi[:, None] + ell * (cs - w2)            # [C, F] chunk starts
    psi_next = state.psi + ell * cs[:, -1]

    t_in = torch.arange(ell, dtype=torch.float32, device=x.device)
    ph_in = psi0[:, :, None] + w2[:, :, None] * t_in       # [C, F, L]
    zres = (s3 * torch.exp(-1j * ph_in.to(torch.complex64))).mean(dim=-1)
    r = _ewma_closed(state.r, zres, alpha)                 # [C, F]
    level = torch.abs(r)
    # the residual angle unwrapped: a cumsum of chunk-to-chunk increments
    r_prev = torch.cat([state.r[:, None], r[:, :-1]], dim=1)
    dprod = r * torch.conj(r_prev)
    dang = torch.where(torch.abs(r_prev) > 0,
                       torch.atan2(dprod.imag, dprod.real),
                       torch.atan2(r.imag, r.real))        # first chunk: seed
    ang = state.ang[:, None] + torch.cumsum(dang, dim=-1)  # [C, F]

    half = 0.5 if square else 1.0
    phases = half * (ph_in + ang[:, :, None]).reshape(c, n)
    # psi and ang wrap mod 4 pi, so the halved phase wraps mod 2 pi
    new_state = CostasOpenState(
        w2=w2[:, -1],
        psi=torch.remainder(psi_next + TWO_PI, 2.0 * TWO_PI) - TWO_PI,
        r=r[:, -1],
        ang=torch.remainder(ang[:, -1] + TWO_PI, 2.0 * TWO_PI) - TWO_PI,
        z_prev=zf[:, -1])
    return new_state, phases, level


# ------------------------------------------------ aimed carrier loop (SAM)

def pll_run_aimed(cfg: PLLConfig, state: CostasOpenState,
                  aim_phase: torch.Tensor, x: torch.Tensor, n_block: int = 0,
                  smooth_cfg: CostasOpenConfig | None = None):
    """Two-stage blockwise carrier loop for wide pull ranges (SAM: +-1 kHz
    at ~32 ksps), x [C, N] complex64 holding N / n_block logical blocks.

    Stage 1 aims: each block's carrier frequency from three coherent sums
    of growing length (folds 8, 4, 4), each a boxcar that attenuates the
    sidebands before its conj-product frequency read, the stream derotated
    by each stage's estimate before the next; clipped to the loop range,
    and the block derotated by the carried aim ramp.  Stage 2 tracks the
    near-DC residual with the open-loop smoother (costas_open_run,
    square=False; its chunk halves until it divides the block).  The aim
    phase carries across calls.  `state` is the smoother's CostasOpenState
    (the chunked-loop stage 2 of smooth_cfg None, pll_run_blockwise, is
    not ported).

    Returns (state', aim_phase' [C], phases [C, N], freqs [C, N]
    rad/sample)."""
    if smooth_cfg is None:
        raise ValueError("pll_run_aimed's chunked-loop stage 2 (SAM "
                         "smooth='loop', pll_run_blockwise) is not ported; "
                         "pass smooth_cfg for the open smoother")
    c, n = x.shape
    nb = n_block or n
    k = n // nb
    z = x.reshape(c, k, nb)
    f_est = torch.zeros(c, k, dtype=torch.float32, device=x.device)
    span = 1
    for fold in (8, 4, 4):
        z = z.reshape(c, k, -1, fold).sum(dim=-1)                # [C, K, M]
        span *= fold
        # within-block products only: the K-block call aims each block as
        # K sequential calls would
        dm = (z[:, :, 1:] * torch.conj(z[:, :, :-1])).mean(dim=-1)
        f_step = torch.atan2(dm.imag, dm.real) / span           # rad/sample
        f_est = f_est + f_step
        m_idx = torch.arange(z.shape[-1], dtype=torch.float32,
                             device=x.device)
        rot = (f_step[:, :, None] * span) * m_idx
        z = z * torch.exp(-1j * rot.to(torch.complex64))
    f_est = torch.clamp(f_est, cfg.freq_lo, cfg.freq_hi)
    # the carried aim phase at each block start: aim + cumsum(f_est nb)
    steps = f_est * float(nb)
    starts = aim_phase[:, None] + torch.cat(
        [torch.zeros(c, 1, dtype=torch.float32, device=x.device),
         torch.cumsum(steps[:, :-1], dim=-1)], dim=-1)           # [C, K]
    starts = torch.remainder(starts + math.pi, TWO_PI) - math.pi
    t_in = torch.arange(nb, dtype=torch.float32, device=x.device)
    ramp = (starts[:, :, None] + f_est[:, :, None] * t_in).reshape(c, n)
    xd = x * torch.exp(-1j * ramp.to(torch.complex64))
    ell = smooth_cfg.chunk
    while nb % ell:
        ell //= 2
    st2, ph_res, _ = costas_open_run(smooth_cfg, state, xd, chunk=ell,
                                     square=False)
    phases = ramp + ph_res
    freqs = torch.repeat_interleave(f_est, nb, dim=-1)
    aim2 = (torch.remainder(starts[:, -1] + steps[:, -1] + math.pi, TWO_PI)
            - math.pi)
    return st2, aim2, phases, freqs
