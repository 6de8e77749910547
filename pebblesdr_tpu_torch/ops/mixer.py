"""NCO mixer: tune a channel to baseband by complex phase-ramp multiply.

Port of pebblesdr_tpu/ops/mixer.py.  Phases are fractional cycles kept
modulo 1.0 in float32 with a split-precision frequency (hi on the 2^-12
grid, lo the residual), so k*hi mod 1 is exact.  ``jnp.mod`` is floor-mod:
its torch counterpart is ``torch.remainder`` (``torch.fmod`` would keep the
sign of a negative lo term).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
_SPLIT = 4096.0  # 2^12
_CHUNK = 128     # oscillator factorization chunk


@dataclasses.dataclass(frozen=True)
class MixerState:
    phase: torch.Tensor  # [C] fractional cycles in [0,1)


def mixer_init(channels: int, device) -> MixerState:
    return MixerState(phase=torch.zeros(channels, dtype=torch.float32,
                                        device=device))


def split_freq(freq_hz, sample_rate):
    """Host-side: normalized frequency as a (hi, lo) float32 pair, hi on the
    2^-12 grid and lo the small residual."""
    f = float(freq_hz) / float(sample_rate)
    f = f - np.floor(f)
    hi = np.float32(np.round(f * _SPLIT) / _SPLIT)
    lo = np.float32(f - float(hi))
    return hi, lo


def phase_ramp(phase0: torch.Tensor, n: int, f_hi: torch.Tensor,
               f_lo: torch.Tensor) -> torch.Tensor:
    """[C, n] fractional-cycle ramp starting at phase0 [C], step f_hi+f_lo [C]."""
    k = torch.arange(n, dtype=torch.float32, device=phase0.device)[None, :]
    ramp = torch.remainder(k * f_hi[:, None], 1.0) + k * f_lo[:, None]
    return torch.remainder(phase0[:, None] + ramp, 1.0)


def oscillator(phase0: torch.Tensor, n: int, f_hi: torch.Tensor,
               f_lo: torch.Tensor) -> torch.Tensor:
    """exp(-j*2*pi*(phase0 + k*(f_hi+f_lo))) for k in [0, n), factorized as
    coarse[q] * fine[r] with k = 128*q + r.  Returns complex64 [C, n]."""
    c = phase0.shape[0]
    if n % _CHUNK:
        ph = phase_ramp(phase0, n, f_hi, f_lo)
        return torch.exp(-1j * TWO_PI * ph).to(torch.complex64)
    dev = phase0.device
    q = n // _CHUNK
    r = torch.arange(_CHUNK, dtype=torch.float32, device=dev)[None, :]
    fine_arg = torch.remainder(r * f_hi[:, None], 1.0) + r * f_lo[:, None]
    qs = torch.arange(q, dtype=torch.float32, device=dev)[None, :] * float(_CHUNK)
    coarse_arg = (torch.remainder(qs * f_hi[:, None], 1.0) + qs * f_lo[:, None]
                  + phase0[:, None])
    fine = torch.exp(-1j * TWO_PI * torch.remainder(fine_arg, 1.0))
    coarse = torch.exp(-1j * TWO_PI * torch.remainder(coarse_arg, 1.0))
    return (coarse[:, :, None] * fine[:, None, :]).reshape(c, n).to(torch.complex64)


def mix(state: MixerState, x: torch.Tensor, f_hi, f_lo):
    """x: [C, N] complex64 -> (state', tuned [C, N]); frequency as a split
    pair (scalars or [C] tensors)."""
    n = x.shape[-1]
    dev = state.phase.device
    f_hi = torch.as_tensor(f_hi, dtype=torch.float32, device=dev).expand(
        state.phase.shape)
    f_lo = torch.as_tensor(f_lo, dtype=torch.float32, device=dev).expand(
        state.phase.shape)
    y = x * oscillator(state.phase, n, f_hi, f_lo)
    return MixerState(phase=advance_phase(state.phase, n, f_hi, f_lo)), y


def mix_blocks(state: MixerState, x: torch.Tensor, f_hi, f_lo,
               n_block: int):
    """x [C, K*n_block] complex64 mixed as K calls of mix on its n_block-
    sample blocks would, in one pass: block b's oscillator starts at mod(
    phase + mod(b mod(n_block hi, 1), 1) + b n_block lo, 1) (exact in its
    hi term), so each block's ramp stays as short, and as exact, as one
    call's.  Returns (state', tuned [C, K*n_block])."""
    c, total = x.shape
    k = total // n_block
    dev = state.phase.device
    f_hi = torch.as_tensor(f_hi, dtype=torch.float32, device=dev).expand(c)
    f_lo = torch.as_tensor(f_lo, dtype=torch.float32, device=dev).expand(c)
    b = torch.arange(k + 1, dtype=torch.float32, device=dev)[None, :]
    starts = torch.remainder(
        state.phase[:, None]
        + torch.remainder(b * torch.remainder(n_block * f_hi, 1.0)[:, None],
                          1.0)
        + b * (n_block * f_lo)[:, None], 1.0)                 # [C, K+1]
    osc = oscillator(starts[:, :k].reshape(-1), n_block,
                     f_hi.repeat_interleave(k), f_lo.repeat_interleave(k))
    return (MixerState(phase=starts[:, k].contiguous()),
            x * osc.reshape(c, total))


def advance_phase(phase: torch.Tensor, n: int, f_hi: torch.Tensor,
                  f_lo: torch.Tensor) -> torch.Tensor:
    """Phase after n samples, in the split form: mod(phase + mod(n*hi, 1) +
    n*lo, 1)."""
    return torch.remainder(phase + torch.remainder(n * f_hi, 1.0) + n * f_lo,
                           1.0)
