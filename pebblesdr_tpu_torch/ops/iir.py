"""First-order IIR sections without a per-sample loop.

Port of the first-order half of pebblesdr_tpu/ops/iir.py:
y[n] = a*y[n-1] + b*x[n] as (1) a closed form with one cumsum when N*(1-a)
is small, (2) a chunked matmul (per-chunk zero-state response against a
triangular table, cross-chunk handoff over N/L scalars) otherwise, and (3) a
log-step scan where neither geometry fits (the JAX package's
associative_scan).  All three are the same recurrence.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
