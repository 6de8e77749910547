"""The sharded wideband FFT: one FFT split over the ranks of a mesh axis.

Port of pebblesdr_tpu/parallel/dist_fft.py: the four-step (Cooley-Tukey
N = N1 N2, Bailey) factorization X[k2 N1 + k1] = FFT_n2(W_N^(k1 n2)
FFT_n1(x[n1, n2])):

  1. the time block as a row-major [N1, N2] matrix, split along N1
     (contiguous time shards);
  2. a global transpose (one all-to-all) so the n1 axis is local;
  3. local length-N1 FFTs (torch.fft) and the twiddle W_N^(k1 n2);
  4. a transpose back (second all-to-all), local length-N2 FFTs;
  5. a final transpose (third all-to-all) into natural bin order.

The result is the full-length DFT in natural order, split contiguously
along frequency: each rank holds its own frequency span.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pebblesdr_tpu_torch.parallel import comm
from pebblesdr_tpu_torch.parallel import mesh as mesh_mod


def _a2a_transpose(a: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Global transpose of a row-split matrix: local [R/S, C] rows of the
    global [R, C] -> local [C/S, R] rows of the global [C, R] (rank d keeps
    column group d of every row), by one all-to-all."""
    s = mesh.size(axis)
    r_loc, c = a.shape
    b = comm.all_to_all(a.reshape(r_loc, s, c // s), mesh, axis, 1, 0)
    return b.reshape(s * r_loc, c // s).T.contiguous()


def fft_sharded(x2d: torch.Tensor, mesh, axis: str = "time",
                local: bool = False) -> torch.Tensor:
    """The distributed DFT of one long block.

    x2d: [N1, N2] complex64, the length N1 N2 time block in row-major order
    (its rows split contiguously over axis; N1 and N2 divisible by the
    axis size); local=True: x2d is already this rank's [N1/S, N2] rows.
    Returns this rank's [N2/S, N1] rows of the [N2, N1] result, whose
    row-major flattening is the natural-order DFT X[k], k = k2 N1 + k1: the
    contiguous frequency span k2 in [d N2/S, (d+1) N2/S)."""
    s = mesh.size(axis)
    if local:
        n1, n2 = x2d.shape[0] * s, x2d.shape[1]
        x_loc = x2d
    else:
        n1, n2 = x2d.shape
        if n1 % s or n2 % s:
            raise ValueError(f"[N1={n1}, N2={n2}] not divisible by the "
                             f"'{axis}' axis size {s}")
        r0, r1 = mesh_mod.time_range(mesh, n1, axis)
        x_loc = x2d[r0:r1]
    if n2 % s:
        raise ValueError(f"N2={n2} not divisible by the '{axis}' axis size "
                         f"{s}")
    x_loc = x_loc.to(mesh.device, torch.complex64)
    n = n1 * n2
    d = mesh.index(axis)
    t1 = _a2a_transpose(x_loc, mesh, axis)                 # [N2/S, N1]
    b = torch.fft.fft(t1, dim=1)                           # B[n2, k1]
    rows_n2 = (d * (n2 // s) + torch.arange(n2 // s, device=x_loc.device)
               ).to(torch.float32)
    k1 = torch.arange(n1, dtype=torch.float32, device=x_loc.device)
    ang = (-2.0 * math.pi / n) * rows_n2[:, None] * k1[None, :]
    b = b * torch.complex(torch.cos(ang), torch.sin(ang))
    t2 = _a2a_transpose(b, mesh, axis)                     # [N1/S, N2]
    c = torch.fft.fft(t2, dim=1)                           # C[k1, k2]
    return _a2a_transpose(c, mesh, axis)                   # [N2/S, N1]


def power_spectrum_sharded(x2d: torch.Tensor, mesh, axis: str = "time",
                           window: np.ndarray | None = None,
                           local: bool = False) -> torch.Tensor:
    """The windowed power spectrum |X|^2 / N^2 of one wideband block,
    natural bin order, this rank's contiguous [N/S] span of frequency.
    window: an optional length-N real window (applied to the rank's rows,
    no communication)."""
    s = mesh.size(axis)
    n1 = x2d.shape[0] * (s if local else 1)
    n2 = x2d.shape[1]
    n = n1 * n2
    if window is not None:
        w = torch.as_tensor(np.asarray(window, np.float32)).reshape(n1, n2)
        if local:
            r0, r1 = mesh_mod.time_range(mesh, n1, axis)
            w = w[r0:r1]
        x2d = x2d * w.to(x2d.device)
    xk = fft_sharded(x2d, mesh, axis, local)
    p = (xk.real ** 2 + xk.imag ** 2) / float(n) ** 2
    return p.reshape(-1)
