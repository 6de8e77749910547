"""Fractional resampler: windowed-sinc rate conversion to the audio rate.

Port of pebblesdr_tpu/ops/resampler.py (CFractResampler capability,
fractresampler.cpp:87-187).  The rate ratio is static, so the fractional
phase pattern repeats every block and the whole resampler is one matmul
against a banded [taps + N_in, N_out] operator built on the host in float64.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import numpy as np
import torch

from pebblesdr_tpu_torch.core import windows as win


@dataclasses.dataclass(frozen=True, eq=False)  # hashed by identity
class ResamplePlan:
    in_rate: float
    out_rate: float
    n_in: int
    n_out: int
    taps: int
    dense: np.ndarray       # [K + N_in, M] banded operator
    gather_idx: np.ndarray  # [M, K] int32 indices into the tail-extended input
    coefs: np.ndarray       # [M, K] float32 (dense's band, row by row)


def output_block(in_rate: int, out_rate: int, n_in: int) -> int:
    """Exact output block length, or raise if the geometry isn't rational."""
    m = Fraction(n_in) * Fraction(int(out_rate), int(in_rate))
    if m.denominator != 1:
        raise ValueError(
            f"n_in={n_in} not compatible with {in_rate}->{out_rate}; "
            f"need n_in divisible by {Fraction(int(in_rate), int(out_rate)).numerator}"
        )
    return int(m)


def plan(in_rate: int, out_rate: int, n_in: int, taps: int = 32) -> ResamplePlan:
    k = int(taps)
    m_out = output_block(in_rate, out_rate, n_in)
    step = Fraction(int(in_rate), int(out_rate))  # input samples per output
    ms = np.arange(m_out, dtype=np.float64)
    tau = ms * float(step)
    idx = np.floor(tau).astype(np.int64)
    frac = tau - idx

    j = np.arange(k, dtype=np.float64)
    u = frac[:, None] + (k / 2.0) - j[None, :]
    fc = 0.5 * min(1.0, out_rate / in_rate)   # anti-alias cutoff (cycles/in-sample)
    core = 2.0 * fc * np.sinc(2.0 * fc * u)
    wu = np.clip((u / (k / 2.0 + 1.0) + 1.0) / 2.0, 0.0, 1.0)  # -> [0,1]
    coeffs = win._COSINE_SUM[win.WindowType.BLACKMAN_HARRIS]
    wwin = np.zeros_like(wu)
    for kk, a in enumerate(coeffs):
        wwin += ((-1.0) ** kk) * a * np.cos(kk * 2.0 * np.pi * wu)
    kern = core * wwin
    kern = kern / np.sum(kern, axis=1, keepdims=True)  # unity DC gain per phase

    gather = (idx[:, None] - k + 1 + j[None, :].astype(np.int64)) + k  # tail offset
    assert gather.min() >= 0 and gather.max() < n_in + k
    dense = np.zeros((n_in + k, m_out), np.float32)
    for mm in range(m_out):
        dense[gather[mm], mm] = kern[mm]
    return ResamplePlan(float(in_rate), float(out_rate), n_in, m_out, k, dense,
                        gather.astype(np.int32), kern.astype(np.float32))


def state_init(p: ResamplePlan, channels: int, device,
               dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(channels, p.taps, dtype=dtype, device=device)


@functools.lru_cache(maxsize=8)  # the key keeps its plan alive
def _dense_dev(p: ResamplePlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(p.dense).to(device)


def _matmul(x: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(torch.matmul(x.real, dense),
                             torch.matmul(x.imag, dense))
    return torch.matmul(x, dense)


def apply(p: ResamplePlan, state: torch.Tensor, x: torch.Tensor):
    """x: [C, N_in] (real or complex) -> (state', y [C, N_out])."""
    xx = torch.cat([state, x], dim=-1)
    y = _matmul(xx, _dense_dev(p, x.device))
    return xx[:, xx.shape[-1] - p.taps:], y.to(x.dtype)


def apply_gather(p: ResamplePlan, state: torch.Tensor, x: torch.Tensor):
    """The gather + multiply-accumulate form of apply (kept for parity
    testing).  x: [C, N_in] -> (state', y [C, N_out])."""
    xx = torch.cat([state, x], dim=-1)
    idx = torch.from_numpy(p.gather_idx.astype(np.int64)).to(x.device)
    coefs = torch.from_numpy(p.coefs).to(x.device)
    y = torch.sum(xx[:, idx] * coefs[None], dim=-1)          # [C, M]
    return xx[:, xx.shape[-1] - p.taps:], y.to(x.dtype)


def apply_many(p: ResamplePlan, state: torch.Tensor, x_cat: torch.Tensor):
    """K consecutive blocks in one batched matmul against the per-block
    operator.  x_cat: [C, K*n_in] -> (state', y [C, K*n_out])."""
    c, length = x_cat.shape
    k = length // p.n_in
    ext = torch.cat([state, x_cat], dim=-1)             # [C, taps + K*N]
    if p.taps <= p.n_in:
        base = ext[:, :length].reshape(c, k, p.n_in)
        carry = x_cat.reshape(c, k, p.n_in)[:, :, p.n_in - p.taps:]
        wins = torch.cat([base, carry], dim=-1)         # [C, K, N + taps]
    else:
        wins = torch.stack([ext[:, i * p.n_in:i * p.n_in + p.n_in + p.taps]
                            for i in range(k)], dim=1)
    y = _matmul(wins, _dense_dev(p, x_cat.device))      # [C, K, M]
    return (ext[:, ext.shape[-1] - p.taps:],
            y.reshape(c, k * p.n_out).to(x_cat.dtype))
