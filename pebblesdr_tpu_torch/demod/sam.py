"""SAM (synchronous AM) demodulator: carrier recovery + sideband mix.

Port of pebblesdr_tpu/demod/sam.py (Demod_SAM capability,
demod_sam.cpp:5-112): a carrier loop locks to the carrier, the signal is
mixed coherently to baseband, and the sidebands are split either by one
complex analytic (Hilbert) bandpass ("analytic", DC alpha 0.999) or by the
reference's per-rail phasing filters ("rails", DC alpha 0.9999).  mono = L
= lo + hi, R = hi - lo.

The carrier loop: algorithm "aimed" (default) on blocks that are a
multiple of 128 samples is the two-stage loop pll.pll_run_aimed, with the
open stage-2 smoother (smooth "open", default) or the chunked loop
(smooth "loop": pll_run_blockwise at pll_chunk, on a CUDA tensor the
recurrence kernel pll_chunk_scan); algorithm "scan", or a block the aim
cannot fold, is the per-sample loop pll.pll_run over the whole stream (on
a CUDA tensor the recurrence kernel pll_scan).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import fir, iir, pll

AIM_BLOCK = 128   # the aim's folds (8 x 4 x 4) need whole 128-sample spans


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    sample_rate: float
    pll: pll.PLLConfig
    hilbert_taps: np.ndarray
    algorithm: str = "aimed"     # or "scan" (the per-sample loop)
    pll_chunk: int = 8           # the chunked loop's chunk (smooth "loop"):
    #                              alpha chunk << 1 keeps it stable
    smooth: str = "open"         # or "loop" (the chunked loop)
    open_track: pll.CostasOpenConfig | None = None
    sideband: str = "analytic"   # or "rails"
    rail_taps_i: np.ndarray | None = None
    rail_taps_q: np.ndarray | None = None

    @staticmethod
    def make(sample_rate: float, bandwidth: float = 10000.0,
             algorithm: str = "aimed", smooth: str = "open",
             sideband: str = "analytic") -> "SAMConfig":
        cfg = pll.make_pll_config(sample_rate, bw_hz=100.0, zeta=0.707,
                                  range_hz=1000.0, detector="atan2")
        # analytic filter 0..bandwidth/2 at unit passband gain
        taps = 0.5 * fir.design_hilbert(61, bandwidth / 4.0, bandwidth / 2.0,
                                        sample_rate)
        # the reference's rail pair: Kaiser LP 40 dB / 4500 / 5500 shifted
        # +5000 Hz, applied per rail
        h = fir.design_cfir_kaiser_lp(40.0, 4500.0, 5500.0, sample_rate)
        hbi, hbq = fir.design_rail_pair(h, 5000.0, sample_rate)
        out = SAMConfig(sample_rate=sample_rate, pll=cfg, hilbert_taps=taps,
                        algorithm=algorithm, smooth=smooth,
                        open_track=pll.make_costas_open_config(
                            sample_rate, range_hz=200.0, bw_hz=50.0,
                            chunk=64, square=False),
                        sideband=sideband,
                        rail_taps_i=hbi.astype(np.float32),
                        rail_taps_q=hbq.astype(np.float32))
        check_ported(out)
        return out


ALGORITHMS = ("aimed", "scan")
SMOOTHERS = ("open", "loop")


def check_ported(cfg: SAMConfig) -> None:
    """Raise for what the port does not run: an unknown carrier algorithm,
    stage-2 smoother or sideband split.  Every block length runs: the aim
    takes blocks that are a multiple of AIM_BLOCK, others the per-sample
    loop."""
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"unknown SAM carrier algorithm {cfg.algorithm!r}")
    if cfg.smooth not in SMOOTHERS:
        raise ValueError(f"unknown SAM stage-2 smoother {cfg.smooth!r}")
    if cfg.sideband not in ("analytic", "rails"):
        raise ValueError(f"unknown SAM sideband split {cfg.sideband!r}")


@dataclasses.dataclass(frozen=True)
class SAMState:
    pll: pll.PLLState
    track: pll.CostasOpenState   # the open stage-2 smoother
    #                              (pll: the per-sample and chunked loops)
    dc: torch.Tensor             # [C] mono (L) DC blocker
    dc_r: torch.Tensor           # [C] sideband-mix (R) DC blocker
    hilbert_tail: torch.Tensor   # [C, T-1] complex64; rails [2C, T-1] f32
    align: torch.Tensor          # [C, (T-1)/2] complex64 delay; rails [C, 0]
    aim: torch.Tensor            # [C] carried aim-ramp phase


def sam_init(cfg: SAMConfig, channels: int, device) -> SAMState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.sideband == "rails":
        tail = zeros(2 * channels, len(cfg.rail_taps_i) - 1)
        align = zeros(channels, 0, dtype=torch.complex64)
    else:
        t = len(cfg.hilbert_taps)
        tail = fir.fir_tail_init(channels, t, device)
        align = zeros(channels, (t - 1) // 2, dtype=torch.complex64)
    return SAMState(pll=pll.pll_init(cfg.pll, channels, device),
                    track=pll.costas_open_init(channels, device),
                    dc=zeros(channels), dc_r=zeros(channels),
                    hilbert_tail=tail, align=align, aim=zeros(channels))


def sam_demod(cfg: SAMConfig, state: SAMState, x: torch.Tensor,
              n_block: int = 0):
    """x: [C, N] complex64 -> (state', audio [C, N] float32 mono)."""
    state2, mono, _, _ = sam_demod_stereo(cfg, state, x, n_block=n_block)
    return state2, mono


def sam_demod_stereo(cfg: SAMConfig, state: SAMState, x: torch.Tensor,
                     n_block: int = 0):
    """Carrier recovery over n_block-sample logical blocks of x [C, N]
    (all of x when 0), the coherent mix, and the sideband split.  Returns
    (state', mono, left, right), each [C, N] float32."""
    nb_len = n_block or x.shape[-1]
    check_ported(cfg)
    pll_state, track, aim = state.pll, state.track, state.aim
    if cfg.algorithm == "aimed" and nb_len % AIM_BLOCK == 0:
        if cfg.smooth == "open":
            track, aim, phases, _ = pll.pll_run_aimed(
                cfg.pll, state.track, state.aim, x, n_block=n_block,
                smooth_cfg=cfg.open_track)
        else:
            pll_state, aim, phases, _ = pll.pll_run_aimed(
                cfg.pll, state.pll, state.aim, x, chunk=cfg.pll_chunk,
                n_block=n_block)
    else:     # "scan", or a block too short for the multi-resolution aim
        pll_state, phases, _ = pll.pll_run(cfg.pll, state.pll, x)
    base = x * torch.exp(-1j * phases.to(torch.complex64))
    c, n = x.shape
    dc_prev = torch.cat([state.dc, state.dc_r])
    if cfg.sideband == "rails":
        # the reference's phasing method (demod_sam.cpp:83-112): DC-remove
        # the coherent rails, filter re with the in-phase and im with the
        # quadrature bandpass independently; L = re + im, R = re - im, mono
        # = the filtered re rail
        dc2, rails = iir.dc_removal_apply(
            dc_prev, torch.cat([base.real, base.imag]), alpha=0.9999)
        y_i, y_q, tail = fir.fir_apply_real_signal_pair(
            rails, state.hilbert_tail, cfg.rail_taps_i, cfg.rail_taps_q)
        re_f, im_f = y_i[:c], y_q[c:]
        return (SAMState(pll=pll_state, track=track, dc=dc2[:c],
                         dc_r=dc2[c:], hilbert_tail=tail, align=state.align,
                         aim=aim),
                re_f, re_f + im_f, re_f - im_f)
    hi, tail = fir.fir_apply_complex(base, None, state.hilbert_tail,
                                     taps_np=cfg.hilbert_taps)
    # align base with hi: the linear-phase Hilbert FIR delays by (T-1)/2
    full = torch.cat([state.align, base], dim=-1)
    base_d, new_align = full[:, :n], full[:, n:]
    # lo + hi and hi - lo (which still carries the carrier), one DC pass
    dc2, both = iir.dc_removal_apply(
        dc_prev, torch.cat([base_d.real, (2.0 * hi - base_d).real]),
        alpha=0.999)
    mono, right = both[:c], both[c:]
    return (SAMState(pll=pll_state, track=track, dc=dc2[:c], dc_r=dc2[c:],
                     hilbert_tail=tail, align=new_align, aim=aim),
            mono, mono, right)
