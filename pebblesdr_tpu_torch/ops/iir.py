"""First-order IIR sections without a per-sample loop, and biquad design.

Port of the first-order half of pebblesdr_tpu/ops/iir.py:
y[n] = a*y[n-1] + b*x[n] as (1) a closed form with one cumsum when N*(1-a)
is small, (2) a chunked matmul (per-chunk zero-state response against a
triangular table, cross-chunk handoff over N/L scalars) otherwise, and (3) a
log-step scan where neither geometry fits (the JAX package's
associative_scan).  All three are the same recurrence.  Of the biquads only
the design and the state layout are ported (the WFM state carries biquad
leaves; no ported path applies one yet).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BiquadCoef:
    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def design_biquad(kind: str, f0_hz: float, sample_rate: float,
                  q: float) -> BiquadCoef:
    """RBJ-cookbook biquad: kinds 'lowpass'|'highpass'|'bandpass'|'notch'."""
    w0 = 2.0 * math.pi * f0_hz / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    if kind == "lowpass":
        b0, b1, b2 = (1 - cw) / 2, 1 - cw, (1 - cw) / 2
    elif kind == "highpass":
        b0, b1, b2 = (1 + cw) / 2, -(1 + cw), (1 + cw) / 2
    elif kind == "bandpass":
        b0, b1, b2 = alpha, 0.0, -alpha
    elif kind == "notch":
        b0, b1, b2 = 1.0, -2 * cw, 1.0
    else:
        raise ValueError(kind)
    a0 = 1 + alpha
    return BiquadCoef(b0 / a0, b1 / a0, b2 / a0, (-2 * cw) / a0,
                      (1 - alpha) / a0)


def biquad_state_init(channels: int, device,
                      dtype=torch.float32) -> torch.Tensor:
    """DF2 state [C, 2]: (w[n-1], w[n-2])."""
    return torch.zeros(channels, 2, dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def ewma_tables(k: int, a: float, device: torch.device):
    """Closed form of y_k = a y_{k-1} + (1-a) p_k over k = 0..K-1 seeded by
    y_{-1}: y = L @ p + s * y_{-1} with L[k, i] = (1-a) a^(k-i) (i <= k) and
    s[k] = a^(k+1), float32 [K, K] and [K]."""
    kk = np.arange(k)
    lmat = np.where(kk[:, None] >= kk[None, :],
                    (1.0 - a) * a ** (kk[:, None] - kk[None, :]), 0.0)
    return (torch.from_numpy(lmat.astype(np.float32)).to(device),
            torch.from_numpy((a ** (kk + 1)).astype(np.float32)).to(device))


def deemphasis_alpha(tau_us: float, sample_rate: float) -> float:
    """De-emphasis one-pole coefficient for 75 us (US) / 50 us (EU) FM audio."""
    return math.exp(-1.0 / (tau_us * 1e-6 * sample_rate))


@functools.lru_cache(maxsize=32)
def _chunk_tables_np(a: float, b: float, chunk: int):
    """T[j, n] = b a^{n-j} (n >= j), chunk-end row b a^{L-1-j}, injection
    a^{n+1} — float64 on the host, float32 on return."""
    k = np.arange(chunk)
    pow_a = a ** k.astype(np.float64)
    idx = np.subtract.outer(np.arange(chunk), np.arange(chunk))  # n - j
    tt = np.where(idx >= 0, b * pow_a[np.abs(idx)], 0.0).T       # [j, n]
    p_end = b * pow_a[::-1]
    inj = a * pow_a
    return (tt.astype(np.float32), p_end.astype(np.float32),
            inj.astype(np.float32), float(a ** chunk))


@functools.lru_cache(maxsize=32)
def _chunk_tables(a: float, b: float, chunk: int, device: torch.device):
    tt, p_end, inj, a_l = _chunk_tables_np(a, b, chunk)
    return (torch.from_numpy(tt).to(device), torch.from_numpy(p_end).to(device),
            torch.from_numpy(inj).to(device), a_l)


def _pick_chunk(n: int) -> int | None:
    for chunk in (512, 256, 128):
        if n % chunk == 0 and n > chunk:
            return chunk
    return None


def first_order_apply(y_prev: torch.Tensor, x: torch.Tensor, a: float, b: float):
    """y[n] = a*y[n-1] + b*x[n].  y_prev: [C]; x: [C, N] real or complex.
    Returns (y_last [C], y [C, N])."""
    n = x.shape[-1]
    rdt = x.real.dtype
    if 0.0 < a < 1.0 and n * (1.0 - a) < 10.0:
        # closed form: y[n] = a^n (a*y_prev + cumsum(b x[k] a^-k))
        k = torch.arange(n, dtype=torch.float32, device=x.device)
        a_pow = torch.exp(k * float(np.log(a))).to(rdt)
        a_inv = torch.exp(-k * float(np.log(a))).to(rdt)
        seed = (a * y_prev)[:, None].to(x.dtype)
        y = a_pow[None, :] * (seed + torch.cumsum(b * x * a_inv[None, :], dim=-1))
        return y[:, -1], y

    chunk = (_pick_chunk(n) if 0.0 < a < 1.0 and x.dtype == torch.float32
             else None)
    if chunk is not None:
        tt, p_end, inj, a_l = _chunk_tables(float(a), float(b), chunk, x.device)
        c = x.shape[0]
        k_n = n // chunk
        xc = x.reshape(c, k_n, chunk)
        y_zs = torch.matmul(xc, tt)                       # [C, K, L]
        d = torch.matmul(xc, p_end)                       # [C, K]
        _, t_end = _first_order_scan(y_prev, d, a_l, 1.0)
        v_in = torch.cat([y_prev[:, None], t_end[:, :-1]], dim=1)
        y = (y_zs + inj[None, None, :] * v_in[:, :, None]).reshape(c, n)
        return y[:, -1], y

    return _first_order_scan(y_prev, x, a, b)


def _first_order_scan(y_prev: torch.Tensor, x: torch.Tensor, a: float, b: float):
    """Log-step (Hillis-Steele) scan of y[n] = a*y[n-1] + b*x[n]: after the
    step with shift s every y[n] holds the sum over its last 2s terms."""
    y = b * x
    y = torch.cat([y[:, :1] + a * y_prev[:, None].to(y.dtype), y[:, 1:]], dim=1)
    n = x.shape[-1]
    shift = 1
    a_s = float(a)
    while shift < n:
        y = torch.cat([y[:, :shift], y[:, shift:] + a_s * y[:, :-shift]], dim=1)
        a_s = a_s * a_s
        shift *= 2
    return y[:, -1], y


def dc_removal_apply(y_prev: torch.Tensor, x: torch.Tensor,
                     alpha: float = 0.9999):
    """One-pole DC blocker: y[n] = x[n] - m[n], m[n] = alpha m[n-1] +
    (1-alpha) x[n] (Demod_AM DC removal, demod_am.cpp:36-64).  y_prev
    carries m.  Returns (m_last, y)."""
    m_last, m = first_order_apply(y_prev, x, alpha, 1.0 - alpha)
    return m_last, x - m


def dc_removal_chunked(y_prev: torch.Tensor, x: torch.Tensor,
                       alpha: float = 0.9999, chunk: int = 512):
    """DC blocker with a piecewise-constant estimate per `chunk` samples:
    chunk means, EWMA across chunks with coefficient alpha^chunk.
    x: [C, N] real or complex, N a multiple of chunk.  Returns (m_last, y)."""
    c, n = x.shape
    if n % chunk:
        raise ValueError(f"block length {n} is not a multiple of the DC "
                         f"chunk {chunk}")
    means = x.reshape(c, n // chunk, chunk).mean(dim=-1)
    a_c = float(alpha) ** chunk
    m_last, m = first_order_apply(y_prev, means, a_c, 1.0 - a_c)
    return m_last, x - torch.repeat_interleave(m, chunk, dim=-1)
