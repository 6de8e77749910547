"""Polyphase filterbank (PFB) channelizer: one wideband stream into M
uniform channels.

Port of pebblesdr_tpu/ops/pfb.py.  With frame k ending after hop fresh
samples (hop = M / os), channel m is

    y_m[k] = e^{+2 pi i m (M-1)/M} [lowpass_h(x e^{-2 pi i m t/M})](s_k),

the band centred at +m fs/M (wrapped into [-fs/2, fs/2)) at baseband,
decimated by hop, computed for all M channels at once: the branch filter
(T taps per branch, the reversed prototype as a [T, M] table) as T
shifted multiply-adds of [R, K, M] windows in IEEE float32, then an M-point
FFT and the fixed per-channel phase (the JAX package's dense DFT matmul
for M <= 128 is a TPU choice; the result is the same function).  os=2
frames advance by M/2 samples and undo the per-frame phase (-1)^{m(k+1)},
so a call must hold whole frame pairs.  The carry is the last T M - hop
input samples per row.  Plain PyTorch: the JAX package runs no Pallas
kernel here either.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from scipy import signal as sps


@dataclasses.dataclass(frozen=True, eq=False)
class PfbPlan:
    n_chan: int           # M: channels
    taps_per_branch: int  # T
    h: np.ndarray         # [T*M] float32 prototype (linear phase)
    fs_in: float
    fs_out: float         # fs_in / hop
    os: int = 1           # oversampling: frames advance by M/os samples

    @property
    def hop(self) -> int:
        return self.n_chan // self.os

    @property
    def state_len(self) -> int:
        return self.n_chan * self.taps_per_branch - self.hop


def plan(fs_in: float, n_chan: int, taps_per_branch: int = 12,
         beta: float = 9.0, os: int = 1) -> PfbPlan:
    """An M-channel plan: a Kaiser prototype cutting at the channel Nyquist
    fs_in/(2M) (os=1), or at fs_in/M with at least 32 taps per branch
    (os=2: channels at 2 fs/M keep an edge station's full band)."""
    m = int(n_chan)
    os = int(os)
    if os not in (1, 2):
        raise ValueError(f"os={os}: only 1 (critical) or 2 supported")
    if m % os:
        raise ValueError(f"n_chan {m} must divide by os {os}")
    t = int(taps_per_branch) if os == 1 else max(int(taps_per_branch), 32)
    cutoff = (1.0 if os == 1 else 2.0) / m   # fraction of input Nyquist
    h = sps.firwin(m * t, cutoff, window=("kaiser", beta), scale=True)
    return PfbPlan(n_chan=m, taps_per_branch=t, h=np.asarray(h, np.float32),
                   fs_in=float(fs_in), fs_out=float(fs_in) / (m // os),
                   os=os)


def init_state(p: PfbPlan, channels_in: int = 1, device="cuda"
               ) -> torch.Tensor:
    """Carry: the last T M - hop input samples per input row."""
    return torch.zeros(channels_in, p.state_len, dtype=torch.complex64,
                       device=device)


def channel_freqs(p: PfbPlan) -> np.ndarray:
    """Centre frequency (Hz, in [-fs/2, fs/2)) of each output channel."""
    m = p.n_chan
    f = np.arange(m) * p.fs_in / m
    f[f >= p.fs_in / 2] -= p.fs_in
    return f


@functools.lru_cache(maxsize=16)
def _tables(p: PfbPlan, device: torch.device):
    """(the reversed prototype [T, M] float32, the channel phase e^{2 pi i
    m (M-1)/M} [M] complex64) on the device."""
    m, t = p.n_chan, p.taps_per_branch
    hb = np.ascontiguousarray(p.h.reshape(t, m)[::-1, ::-1])
    phase = np.exp(2j * np.pi * np.arange(m) * (m - 1) / m).astype(
        np.complex64)
    return (torch.from_numpy(hb).to(device),
            torch.from_numpy(phase).to(device))


def apply(p: PfbPlan, state: torch.Tensor, x: torch.Tensor):
    """x [R, N] complex64 (N a multiple of hop; with os=2 whole frame
    pairs) -> (state', y [R, M, N/hop] complex64): row r's M channels at
    fs_out, centred at channel_freqs(p)."""
    r, n = x.shape
    m, t, hop, os = p.n_chan, p.taps_per_branch, p.hop, p.os
    if n % hop:
        raise ValueError(f"block length {n} not divisible by hop {hop}")
    if os == 2 and (n // hop) % 2:
        raise ValueError(f"os=2 needs whole frame pairs per call: {n} "
                         f"samples = {n // hop} frames of hop {hop}")
    k_out = n // hop
    ext = torch.cat([state, x.to(torch.complex64)], dim=1)  # [R, TM-hop+N]
    new_state = ext[:, ext.shape[1] - p.state_len:]
    # frame k reads ext[k hop : k hop + TM), whose position w = t' M + p'
    # holds prototype index TM - 1 - w: with rows of hop samples,
    # e[a] = [ext2[a], ..., ext2[a + os - 1]] (M samples), frame k's branch
    # t' is e[k + os t']
    ext2 = ext.reshape(r, k_out + (m * t) // hop - 1, hop)
    rows = ext2.shape[1] - os + 1
    e = torch.cat([ext2[:, s:s + rows] for s in range(os)], dim=-1)
    hb, phase = _tables(p, x.device)
    e_ri = torch.view_as_real(e)                           # [R, A, M, 2]
    v = None
    for tt in range(t):
        term = e_ri[:, os * tt: os * tt + k_out] * hb[tt][None, None, :, None]
        v = term if v is None else v + term
    # y_m[k] = e^{2 pi i m (M-1)/M} FFT_m(v[k])
    yf = torch.fft.fft(torch.view_as_complex(v.contiguous()), dim=-1)
    y = (yf * phase[None, None, :]).transpose(1, 2)         # [R, M, K]
    if os == 2:
        mm = np.arange(m)[:, None]
        kk = np.arange(k_out)[None, :]
        tw = np.where((mm * (kk + 1)) % 2 == 0, 1.0, -1.0).astype(np.float32)
        y = y * torch.from_numpy(tw).to(x.device)[None]
    return new_state, y
