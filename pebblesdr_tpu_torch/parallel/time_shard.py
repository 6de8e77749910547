"""Time-block (sequence) sharding with a halo from the left neighbour.

Port of pebblesdr_tpu/parallel/time_shard.py.  One continuous IQ stream's
time axis is split over the ranks of a mesh axis; every FIR or
overlap-save stage needs the last taps-1 input samples of its LEFT
neighbour (the in-shard twin of the carried tail that crosses block
boundaries in streaming), which comm.ring_shift_right delivers.  Each
function runs on one rank's shard [C, N_l] (channels first).

Streaming semantics: shard 0 consumes the carried tail of the previous
block; shard i > 0 its left neighbour's halo; the new carry (the global
block's last samples, i.e. the LAST shard's tail) reaches every shard.
"""

from __future__ import annotations

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import decimator as decim_mod
from pebblesdr_tpu_torch.ops import fir
from pebblesdr_tpu_torch.parallel import comm
from pebblesdr_tpu_torch.utils.precision import ieee_float32

_HI_GRID = 4096.0   # f_hi's grid is 2^-12 cycles (ops/mixer.py split_freq)


def left_halo(x_local: torch.Tensor, halo: int, mesh, axis: str = "time"
              ) -> torch.Tensor:
    """[C, N_l] -> [C, halo]: the last `halo` samples of the LEFT neighbour
    (shard 0 receives zeros)."""
    return comm.ring_shift_right(x_local[:, x_local.shape[1] - halo:]
                                 .contiguous(), mesh, axis)


def _last_shard_tail(x_local: torch.Tensor, halo: int, mesh,
                     axis: str = "time") -> torch.Tensor:
    """[C, halo]: the LAST shard's tail on every shard — the new streaming
    carry for the next global block."""
    tail = x_local[:, x_local.shape[1] - halo:].contiguous()
    return comm.broadcast_from(tail, mesh, axis, mesh.size(axis) - 1)


def _lead(carry: torch.Tensor, halo: torch.Tensor, mesh,
          axis: str) -> torch.Tensor:
    return carry if mesh.index(axis) == 0 else halo


def sharded_fir_decimate(x_local: torch.Tensor, taps, carry: torch.Tensor,
                         decim: int, mesh, axis: str = "time"):
    """Streaming FIR (+ decimation) over a time-sharded stream.

    x_local: [C, N_l] complex64 (N_l % decim == 0); taps: [T] real; carry:
    [C, T-1] the global stream tail of the previous block (the same on
    every shard).  Returns (y_local [C, N_l/decim], new_carry [C, T-1]):
    ops.fir.fir_apply on the unsharded stream."""
    taps = np.asarray(taps.cpu() if isinstance(taps, torch.Tensor) else taps,
                      np.float32)
    halo = len(taps) - 1
    lead = _lead(carry[:, carry.shape[1] - halo:],
                 left_halo(x_local, halo, mesh, axis), mesh, axis)
    y, _ = fir.fir_apply(x_local, taps, lead, decim)
    return y, _last_shard_tail(x_local, halo, mesh, axis)


def sharded_decimator_apply(plan: decim_mod.DecimatorPlan, carries,
                            x_local: torch.Tensor, mesh, axis: str = "time"):
    """The time-sharded halfband cascade: each stage exchanges its own halo
    at its own (decimated) rate.  carries: ops.decimator.state_init's
    tuple.  Returns (carries', y_local)."""
    new_carries = []
    y = x_local
    for st, carry in zip(plan.stages, carries):
        y, nc = sharded_fir_decimate(y, st.taps, carry, 2, mesh, axis)
        new_carries.append(nc)
    return tuple(new_carries), y


def sharded_mix(phase0: torch.Tensor, x_local: torch.Tensor, f_hi, f_lo,
                mesh, axis: str = "time"):
    """Time-sharded NCO mix: each shard offsets the phase ramp by its global
    start index (shard_idx * N_l).  phase0: [C] carried fractional phase.
    Returns (new_phase [C] — the phase after the WHOLE global block, the
    same on every shard — and y_local [C, N_l]).  f_hi is on the 2^-12
    grid, so k f_hi = (k mod 4096) f_hi mod 1: the index is reduced first
    and the product is exact at any k (JAX's k f_hi is rounded once k f_hi
    passes 2^12, a phase error of 0.01 cycle at a 2^19-sample shard)."""
    nl = x_local.shape[-1]
    n_shards = mesh.size(axis)
    dev = phase0.device
    f_hi = torch.as_tensor(f_hi, dtype=torch.float32, device=dev).expand(
        phase0.shape)
    f_lo = torch.as_tensor(f_lo, dtype=torch.float32, device=dev).expand(
        phase0.shape)

    def hi_turns(k):
        return torch.remainder(torch.remainder(k, _HI_GRID) * f_hi, 1.0)

    k0 = torch.tensor(float(mesh.index(axis) * nl), device=dev)
    shard_phase = torch.remainder(phase0 + hi_turns(k0)
                                  + torch.remainder(k0 * f_lo, 1.0), 1.0)
    k = torch.arange(nl, dtype=torch.float32, device=dev)[:, None]
    ramp = hi_turns(k).T + (k * f_lo).T
    ph = torch.remainder(shard_phase[:, None] + ramp, 1.0)
    y = x_local * torch.exp(-2j * np.pi * ph).to(torch.complex64)
    ntot = torch.tensor(float(n_shards * nl), device=dev)
    new_phase = torch.remainder(phase0 + hi_turns(ntot)
                                + torch.remainder(ntot * f_lo, 1.0), 1.0)
    return new_phase, y


def sharded_overlap_save(state_local: torch.Tensor, x_local: torch.Tensor,
                         mask: torch.Tensor, mesh, axis: str = "time"):
    """Time-sharded FastFIR overlap-save: each shard's chunk is one
    overlap-save round with B = N_l (mask sized 2 N_l); the B-sample
    overlap comes from the left neighbour (the carried state on shard 0).
    state_local: [C, N_l] the previous global block's tail (the same on
    every shard).  Returns (new_state [C, N_l], y_local [C, N_l])."""
    nl = x_local.shape[-1]
    prev = _lead(state_local, left_halo(x_local, nl, mesh, axis), mesh, axis)
    xx = torch.cat([prev, x_local], dim=-1)
    spec = torch.fft.fft(xx, dim=-1)
    y = torch.fft.ifft(spec * mask[None, :], dim=-1)[:, nl:]
    return (_last_shard_tail(x_local, nl, mesh, axis),
            y.to(torch.complex64))


def dc_seed(means: torch.Tensor, dc0: torch.Tensor, alpha: float, mesh,
            axis: str = "time", chunk: int = 512):
    """The chunked-EWMA DC estimate's cross-shard seed from this shard's
    chunk means [C, K_l]: (m_start [C] — the estimate entering the shard's
    first chunk, new_dc [C] — the global end-of-block estimate, the same on
    every shard), in closed form from one all-gather of the shards' affine
    maps m_end = A m_start + b (A = a^K_l, b the weighted chunk-mean sum),
    so no shard waits on another's pass.  Float64 inside."""
    kl = means.shape[-1]
    a = float(alpha) ** chunk
    kk = np.arange(kl)
    wv = torch.from_numpy((1.0 - a) * a ** (kl - 1 - kk)).to(means.device)
    mu = means.to(torch.complex128 if means.is_complex() else torch.float64)
    b_loc = (mu * wv[None, :]).sum(dim=-1)                       # [C]
    big_a = a ** kl
    i, tt = mesh.index(axis), mesh.size(axis)
    bs = comm.gather_axis(b_loc[None], mesh, axis, 0)             # [T, C]
    coef = torch.tensor([big_a ** (i - 1 - j) if j < i else 0.0
                         for j in range(tt)], dtype=torch.float64,
                        device=means.device)
    d0 = dc0.to(mu.dtype)
    m_start = big_a ** i * d0 + (coef[:, None] * bs).sum(dim=0)
    coef_t = torch.tensor([big_a ** (tt - 1 - j) for j in range(tt)],
                          dtype=torch.float64, device=means.device)
    new_dc = big_a ** tt * d0 + (coef_t[:, None] * bs).sum(dim=0)
    return m_start, new_dc


def chunk_estimates(means: torch.Tensor, m_start: torch.Tensor, alpha: float,
                    chunks, chunk: int = 512) -> torch.Tensor:
    """The post-update estimates m_k = a^(k+1) m_start + sum_{j<=k} (1-a)
    a^(k-j) mu_j of the given chunks k of a shard whose chunk means are
    means [C, K_l] (float64 inside): [C, len(chunks)]."""
    a = float(alpha) ** chunk
    kl = means.shape[-1]
    ks = np.asarray(list(chunks))
    jj = np.arange(kl)
    w = np.where(jj[None, :] <= ks[:, None],
                 (1.0 - a) * a ** np.maximum(ks[:, None] - jj[None, :], 0),
                 0.0)                                            # [n, K_l]
    mu = means.to(m_start.dtype)
    w_t = torch.from_numpy(w.T.copy()).to(means.device, mu.dtype)
    seed = torch.from_numpy(a ** (ks + 1.0)).to(means.device, mu.dtype)
    return mu @ w_t + seed[None, :] * m_start[:, None]


def sharded_dc_chunks(x_local: torch.Tensor, dc0: torch.Tensor, alpha: float,
                      mesh, axis: str = "time", chunk: int = 512):
    """Time-sharded chunked-EWMA DC estimate (ops.iir.dc_removal_chunked:
    per-chunk means, an EWMA across chunks with coefficient alpha^chunk,
    each chunk subtracting its post-update estimate).

    x_local: [C, N_l] complex (N_l % chunk == 0); dc0: [C] the carried
    global estimate entering this block (the same on every shard).
    Returns (m_start [C], m_all [C, K_l] per-chunk estimates, new_dc [C]),
    in x_local's dtype."""
    c, nl = x_local.shape
    if nl % chunk:
        raise ValueError(f"local chunk {nl} not divisible by dc chunk "
                         f"{chunk}")
    kl = nl // chunk
    means = x_local.reshape(c, kl, chunk).mean(dim=-1)
    m_start, new_dc = dc_seed(means, dc0, alpha, mesh, axis, chunk)
    m_all = chunk_estimates(means, m_start, alpha, range(kl), chunk)
    dt = x_local.dtype
    return m_start.to(dt), m_all.to(dt), new_dc.to(dt)


def sharded_dc_removal(x_local: torch.Tensor, dc0: torch.Tensor,
                       alpha: float, mesh, axis: str = "time",
                       chunk: int = 512):
    """The DC-removed stream and the carried estimate: the time-sharded twin
    of ops.iir.dc_removal_chunked.  Returns (new_dc [C], z_local [C, N_l])."""
    c, nl = x_local.shape
    _, m_all, new_dc = sharded_dc_chunks(x_local, dc0, alpha, mesh, axis,
                                         chunk)
    z = (x_local.reshape(c, nl // chunk, chunk)
         - m_all[:, :, None]).reshape(c, nl)
    return new_dc, z


@ieee_float32()
def sharded_composed_front(x_local: torch.Tensor, phase0: torch.Tensor, f_hi,
                           f_lo, carry: torch.Tensor, h_np, factor: int,
                           mesh, axis: str = "time"):
    """Time-sharded NCO mix + the WHOLE decimator cascade in one step, by
    the noble-identity composed response (ops.decimator.compose_response):
    one halo of D = the composed group delay post-mix samples instead of
    one per cascade stage.  The local filtering is
    fir.fir_apply_real_signal's segmented banded matmul.

    x_local: [C, N_l] complex64 (N_l % factor == 0); carry: [C, D]
    complex64 — the previous global block's last D post-mix samples (the
    same on every shard); h_np: the composed response (len D+1).  Returns
    (new_phase [C], new_carry [C, D], y_local [C, N_l/factor])."""
    d = carry.shape[-1]
    new_phase, z_local = sharded_mix(phase0, x_local, f_hi, f_lo, mesh, axis)
    lead = _lead(carry, left_halo(z_local, d, mesh, axis), mesh, axis)
    h32 = np.asarray(h_np, np.float32)
    yr, _ = fir.fir_apply_real_signal(z_local.real.contiguous(),
                                      lead.real.contiguous(), h32,
                                      decim=factor)
    yi, _ = fir.fir_apply_real_signal(z_local.imag.contiguous(),
                                      lead.imag.contiguous(), h32,
                                      decim=factor)
    y = torch.complex(yr, yi)
    return new_phase, _last_shard_tail(z_local, d, mesh, axis), y
