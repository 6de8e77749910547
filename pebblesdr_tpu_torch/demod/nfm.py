"""Narrowband FM demodulator (port of pebblesdr_tpu/demod/nfm.py).

The conjugate-product discriminator angle(x[n] conj(x[n-1])) (Demod_NFM
FM2, demod_nfm.cpp:124-140) or the derivative ratio (I dQ - Q dI) / |z|^2
(FM1, :99-119), both elementwise over the block with one carried sample, or
the CuteSDR NCO-PLL (algorithm "pll", :225-257: the loop frequency of the
per-sample pll.pll_run, on a CUDA tensor the recurrence kernel pll_scan),
then the DC-offset tracker (one pole, alpha 0.999) and the 3 kHz voice
low-pass.  NFMState carries the PLL's state for every algorithm, so its
leaves line up with the JAX pytree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import fir, iir, pll

ALGORITHMS = ("conj", "derivative", "pll")


@dataclasses.dataclass(frozen=True, eq=False)
class NFMConfig:
    sample_rate: float
    max_deviation: float = 5000.0
    algorithm: str = "conj"              # "conj" | "derivative" | "pll"
    voice_taps: np.ndarray | None = None
    pll: pll.PLLConfig | None = None

    @staticmethod
    def make(sample_rate: float, max_deviation: float = 5000.0,
             algorithm: str = "conj") -> "NFMConfig":
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown NFM algorithm {algorithm!r}")
        taps = fir.design_lowpass_kaiser(3000.0, sample_rate, atten_db=50.0)
        pcfg = pll.make_pll_config(sample_rate, bw_hz=max_deviation,
                                   zeta=0.707, range_hz=max_deviation * 2,
                                   detector="atan2")
        return NFMConfig(sample_rate=sample_rate, max_deviation=max_deviation,
                         algorithm=algorithm, voice_taps=taps, pll=pcfg)


@dataclasses.dataclass(frozen=True)
class NFMState:
    last: torch.Tensor     # [C] complex64 previous sample
    dc: torch.Tensor       # [C] DC-offset tracker
    lp_tail: torch.Tensor  # [C, T-1] voice low-pass history
    pll: pll.PLLState      # the "pll" algorithm's loop state


def nfm_init(cfg: NFMConfig, channels: int, device) -> NFMState:
    return NFMState(
        last=torch.zeros(channels, dtype=torch.complex64, device=device),
        dc=torch.zeros(channels, dtype=torch.float32, device=device),
        lp_tail=fir.fir_tail_init(channels, len(cfg.voice_taps), device,
                                  torch.float32),
        pll=pll.pll_init(cfg.pll, channels, device))


def nfm_demod(cfg: NFMConfig, state: NFMState, x: torch.Tensor):
    """x [C, N] complex64 -> (state', audio [C, N] float32)."""
    gain = cfg.sample_rate / (2.0 * np.pi * cfg.max_deviation)
    pll_state, last = state.pll, x[:, -1]
    if cfg.algorithm == "pll":
        # the loop frequency (rad/sample deviation) is the audio
        pll_state, _, freqs = pll.pll_run(cfg.pll, state.pll, x)
        audio, last = freqs * gain, state.last
    elif cfg.algorithm == "derivative":
        prev = torch.cat([state.last[:, None], x[:, :-1]], dim=-1)
        di = x.real - prev.real
        dq = x.imag - prev.imag
        mag2 = torch.clamp(x.real ** 2 + x.imag ** 2, min=1e-12)
        audio = (x.real * dq - x.imag * di) / mag2 * gain
    else:
        # x conj(prev) written out as the JAX package's complex product
        # computes it, so that the first sample from a zero state keeps
        # its signed zeros (atan2(-0, -0) = -pi)
        prev = torch.cat([state.last[:, None], x[:, :-1]], dim=-1)
        pr, pi = prev.real, -prev.imag
        re = x.real * pr - x.imag * pi
        im = x.real * pi + x.imag * pr
        audio = torch.atan2(im, re) * gain
    dc, audio = iir.dc_removal_apply(state.dc, audio, alpha=0.999)
    audio, tail = fir.fir_apply_real_signal(audio, state.lp_tail,
                                            cfg.voice_taps)
    return NFMState(last=last, dc=dc, lp_tail=tail, pll=pll_state), audio
