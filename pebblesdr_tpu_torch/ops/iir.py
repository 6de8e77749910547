"""First-order IIR sections without a per-sample loop, and biquad design.

Port of the first-order half of pebblesdr_tpu/ops/iir.py:
y[n] = a*y[n-1] + b*x[n] as (1) a closed form with one cumsum when N*(1-a)
is small, (2) a chunked matmul (per-chunk zero-state response against a
triangular table, cross-chunk handoff over N/L scalars) otherwise, and (3) a
log-step scan where neither geometry fits (the JAX package's
associative_scan).  All three are the same recurrence.  The DF2 biquad
(biquad_apply) is the same idea in two dimensions: per-chunk zero-state
responses as one triangular matmul, the cross-chunk state handoff as a
log-step scan with the constant powers of the 2x2 transfer matrix.
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


def _transfer(coef: BiquadCoef) -> np.ndarray:
    """The DF2 state transfer matrix M: v[n] = M v[n-1] + e0 x[n], with
    v = (w[n], w[n-1])."""
    return np.array([[-coef.a1, -coef.a2], [1.0, 0.0]], np.float64)


@functools.lru_cache(maxsize=32)
def _biquad_chunk_tables(coef: BiquadCoef, chunk: int, device: torch.device):
    """Float32 tables of the chunked biquad, built in float64 from the powers
    of M: tt [L, L] (tt[j, n] = h[n - j], the biquad's zero-state impulse
    response), p_end [L, 2] (M^{L-1-j} e0, the chunk-end state of input j),
    inj [L, 2] (the carried state's share of y[n]) and M^L; and M^L in
    float64."""
    pows = np.empty((chunk + 1, 2, 2), np.float64)
    pows[0] = np.eye(2)
    m = _transfer(coef)
    for k in range(1, chunk + 1):
        pows[k] = m @ pows[k - 1]
    # w[k] of a unit impulse is (M^k)[0, 0]; y[k] = b0 w[k] + b1 w[k-1]
    # + b2 w[k-2]
    phi = np.concatenate([[0.0, 0.0], pows[:chunk, 0, 0]])
    h = coef.b0 * phi[2:] + coef.b1 * phi[1:-1] + coef.b2 * phi[:-2]
    idx = np.subtract.outer(np.arange(chunk), np.arange(chunk))  # n - j
    tt = np.where(idx >= 0, h[np.abs(idx)], 0.0).T               # [j, n]
    p_end = pows[chunk - 1 - np.arange(chunk), :, 0]
    # w[m] from the carried state v = (w[-1], w[-2]): row 0 of M^{m+1}
    # (m >= -1), and (0, 1) at m = -2
    rows = np.concatenate([[[0.0, 1.0]], pows[:chunk + 1, 0, :]])
    inj = coef.b0 * rows[2:] + coef.b1 * rows[1:-1] + coef.b2 * rows[:-2]
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (tt, p_end, inj, pows[chunk])) + (pows[chunk],)


def _biquad_pick_chunk(n: int) -> int | None:
    for chunk in (512, 256, 128):
        if n % chunk == 0 and n > chunk:
            return chunk
    return None


@functools.lru_cache(maxsize=64)
def _scan_powers(a: tuple, k: int, device: torch.device, dtype: torch.dtype):
    """The transposed powers a^(2^i) (float64 on the host, then dtype) of a
    2x2 a given as a flat tuple, for a log-step scan over k steps."""
    a_s = np.array(a, np.float64).reshape(2, 2)
    out, shift = [], 1
    while shift < k:
        out.append(torch.from_numpy(a_s.T.copy()).to(device, dtype))
        a_s = a_s @ a_s
        shift *= 2
    return out


def _matrix_scan(v: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """Log-step (Hillis-Steele) scan of v[k] <- a v[k-1] + v[k] along axis 1
    of v [C, K, 2] with a constant 2x2 a: after the step with shift s every
    v[k] holds its last 2s terms, the shifted ones carried by a^s."""
    powers = _scan_powers(tuple(np.asarray(a, np.float64).ravel()),
                          v.shape[1], v.device, v.dtype)
    for i, a_t in enumerate(powers):
        shift = 1 << i
        v = torch.cat([v[:, :shift], v[:, shift:] + v[:, :-shift] @ a_t], dim=1)
    return v


def biquad_apply(state: torch.Tensor, x: torch.Tensor, coef: BiquadCoef):
    """Direct-form-2 biquad over x [C, N] with state [C, 2] (w[n-1],
    w[n-2]):  w[n] = x[n] - a1 w[n-1] - a2 w[n-2];  y[n] = b0 w[n] +
    b1 w[n-1] + b2 w[n-2].  Complex inputs filter re and im independently.

    float32 with N a multiple of a chunk (512, 256 or 128) and longer than
    it: per-chunk zero-state output against the triangular table of the
    impulse response, the chunk-end states handed across chunks by a
    log-step scan with the powers of M^L (N/L chunks: 256 at a 64-channel
    mono WFM dispatch), each chunk's carried-state share added.
    Other lengths: the log-step scan over samples.  Returns (state', y)."""
    if x.is_complex():
        s_r, y_r = biquad_apply(state.real, x.real, coef)
        s_i, y_i = biquad_apply(state.imag, x.imag, coef)
        return torch.complex(s_r, s_i), torch.complex(y_r, y_i)
    c, n = x.shape
    chunk = _biquad_pick_chunk(n) if x.dtype == torch.float32 else None
    if chunk is None:
        return _biquad_apply_scan(state, x, coef)
    tt, p_end, inj, a_l, a_l64 = _biquad_chunk_tables(coef, chunk, x.device)
    k = n // chunk
    xc = x.reshape(c, k, chunk)
    y_zs = torch.matmul(xc, tt)                                  # [C, K, L]
    d = torch.matmul(xc, p_end)                                  # [C, K, 2]
    # t_k = M^L t_{k-1} + d_k from t_{-1} = state: each chunk's end state
    d = torch.cat([d[:, :1] + (state @ a_l.T)[:, None], d[:, 1:]], dim=1)
    t_end = _matrix_scan(d, a_l64)
    v_in = torch.cat([state[:, None, :], t_end[:, :-1]], dim=1)
    y = (y_zs + torch.matmul(v_in, inj.T)).reshape(c, n)
    return t_end[:, -1], y


def _biquad_out(coef: BiquadCoef, state: torch.Tensor, w: torch.Tensor):
    """(state', y) from the DF2 internal signal w [C, N] of the scan."""
    w1 = torch.cat([state[:, :1], w[:, :-1]], dim=-1)
    w2 = torch.cat([state[:, 1:2], w1[:, :-1]], dim=-1)
    y = coef.b0 * w + coef.b1 * w1 + coef.b2 * w2
    return torch.stack([w[:, -1], w1[:, -1]], dim=-1), y


def _biquad_apply_scan(state: torch.Tensor, x: torch.Tensor, coef: BiquadCoef):
    """The biquad for lengths with no chunk: v[n] = M v[n-1] + (x[n], 0)
    as a log-step scan over the samples (the JAX package's associative
    2x2 matrix scan)."""
    m = _transfer(coef)
    m_t = _scan_powers(tuple(m.ravel()), 2, x.device, x.dtype)[0]
    v = torch.stack([x, torch.zeros_like(x)], dim=-1)            # [C, N, 2]
    v = torch.cat([v[:, :1] + (state @ m_t)[:, None], v[:, 1:]], dim=1)
    v = _matrix_scan(v, m)
    return _biquad_out(coef, state, v[..., 0])


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
    x: [C, N] real or complex; where N is not a multiple of chunk, the
    per-sample blocker dc_removal_apply, as in the JAX package.  Returns
    (m_last, y)."""
    c, n = x.shape
    if n % chunk:
        return dc_removal_apply(y_prev, x, alpha)
    means = x.reshape(c, n // chunk, chunk).mean(dim=-1)
    a_c = float(alpha) ** chunk
    m_last, m = first_order_apply(y_prev, means, a_c, 1.0 - a_c)
    return m_last, x - torch.repeat_interleave(m, chunk, dim=-1)
