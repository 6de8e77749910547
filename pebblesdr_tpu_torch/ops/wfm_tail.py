"""Fused WFM stereo tail: stereo demux + decimating audio low-pass.

Port of ``wfm_tail_packed`` / ``_wfm_tail_kernel``
(pebblesdr_tpu/ops/pallas_kernels.py:917, :869).  From the time-major
composite raw [T, C] and the open pilot's per-chunk phase parameters
(phase(fL + r) = p0[f] + wf[f] r, ops/pll.py):

  * demux: lmr = raw * 2 sin(2 phase), mono = raw, packed a = [mono | lmr];
  * low-pass: audio[o] = sum_{j=0..D} h[j] a[F o - j] with a[t < 0] from the
    carried packed history (row d_rows + t; its L-R lanes are post-demux);
    hist' = a[T - d_rows .. T-1].

``wfm_tail`` launches the CUDA kernel (csrc/wfm_tail.cu) for CUDA tensors
and runs ``wfm_tail_reference`` (plain PyTorch) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import decimator

_TILE = 32         # decimated outputs per FIR block (kM in csrc/wfm_tail.cu)
_MAX_SMEM = 232448
SOURCE = "pebblesdr_tpu_torch/csrc/wfm_tail.cu"
REPLACES = "pebblesdr_tpu/ops/pallas_kernels.py:869"


@dataclasses.dataclass(frozen=True, eq=False)
class TailPlan:
    """Static geometry of the stereo tail on one device."""
    factor: int            # audio decimation
    d_rows: int            # carried history rows (D rounded up to 8)
    ell: int               # pilot chunk (rows per (p0, wf) pair)
    sub: int               # the plain version's window step
    h: torch.Tensor        # [D+1] float32 low-pass taps (kernel)
    w: torch.Tensor        # [d_rows + sub, sub/F] Toeplitz block (plain)

    @staticmethod
    def make(taps: np.ndarray, factor: int, ell: int, sub: int,
             device) -> "TailPlan":
        d = len(taps) - 1
        d_rows = ((d + 7) // 8) * 8
        if sub % factor or sub % ell:
            raise ValueError(f"tail sub-block {sub} must be a multiple of the "
                             f"decimation {factor} and the pilot chunk {ell}")
        w = decimator.build_composed_w(np.asarray(taps, np.float64), factor,
                                       sub, d_rows - d)
        return TailPlan(
            factor=int(factor), d_rows=d_rows, ell=int(ell), sub=int(sub),
            h=torch.as_tensor(np.asarray(taps, np.float32), device=device),
            w=torch.from_numpy(w).to(device))


def _check_geometry(plan: TailPlan, raw_t, p0_t, wf_t, hist) -> tuple[int, int]:
    if raw_t.dim() != 2:
        raise ValueError(f"composite must be [T, C], got {tuple(raw_t.shape)}")
    t, c = raw_t.shape
    if t % plan.sub:
        raise ValueError(f"composite of {t} rows is not a whole number of "
                         f"{plan.sub}-row tail sub-blocks")
    for name, v, shape in (("p0_t", p0_t, (t // plan.ell, c)),
                           ("wf_t", wf_t, (t // plan.ell, c)),
                           ("hist", hist, (plan.d_rows, 2 * c))):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{shape}")
    return t, c


def demux(plan: TailPlan, raw_t: torch.Tensor, p0_t: torch.Tensor,
          wf_t: torch.Tensor) -> torch.Tensor:
    """lmr [T, C] = raw * 2 sin(2 (p0[f] + wf[f] r)) for row f*ell + r."""
    t, c = raw_t.shape
    t_in = torch.arange(plan.ell, dtype=torch.float32, device=raw_t.device)
    ph2 = 2.0 * (p0_t[:, None, :] + wf_t[:, None, :] * t_in[None, :, None])
    return raw_t * (2.0 * torch.sin(ph2)).reshape(t, c)


def wfm_tail_reference(plan: TailPlan, raw_t: torch.Tensor,
                       p0_t: torch.Tensor, wf_t: torch.Tensor,
                       hist: torch.Tensor):
    """Plain PyTorch version of the stereo tail.  raw_t [T, C]; p0_t/wf_t
    [T/ell, C]; hist [d_rows, 2C].  Returns (audio [T/F, 2C] = [mono_a |
    lmr_a], hist' [d_rows, 2C])."""
    t, c = _check_geometry(plan, raw_t, p0_t, wf_t, hist)
    apl = torch.cat([raw_t, demux(plan, raw_t, p0_t, wf_t)], dim=1)
    ext = torch.cat([hist, apl], dim=0)                      # [d_rows + T, 2C]
    wins = ext.unfold(0, plan.d_rows + plan.sub, plan.sub)   # [nsub, 2C, L]
    y = torch.matmul(wins, plan.w).transpose(1, 2).reshape(t // plan.factor,
                                                           2 * c)
    return y, ext[ext.shape[0] - plan.d_rows:].contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/wfm_tail.cu, built at first use, with its C signatures."""
    lib = build.load("wfm_tail")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wfm_tail_forward.restype = ctypes.c_int
    lib.wfm_tail_forward.argtypes = [i, p, i, i, p, p, i, p, i, p, i, i, p, p,
                                     p]
    lib.wfm_tail_error_string.restype = ctypes.c_char_p
    lib.wfm_tail_error_string.argtypes = [i]
    lib.wfm_tail_smem_bytes.restype = ctypes.c_size_t
    lib.wfm_tail_smem_bytes.argtypes = [i, i, i]
    return lib


def wfm_tail(plan: TailPlan, raw_t: torch.Tensor, p0_t: torch.Tensor,
             wf_t: torch.Tensor, hist: torch.Tensor):
    """The stereo tail: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Same arguments and results as wfm_tail_reference."""
    if raw_t.device.type == "cpu":
        return wfm_tail_reference(plan, raw_t, p0_t, wf_t, hist)
    if raw_t.device.type != "cuda":
        raise ValueError(f"wfm_tail runs on cuda or cpu, not {raw_t.device}")
    t, c = _check_geometry(plan, raw_t, p0_t, wf_t, hist)
    dev = raw_t.device
    for name, v in (("raw_t", raw_t), ("p0_t", p0_t), ("wf_t", wf_t),
                    ("hist", hist), ("h", plan.h)):
        if (v.device != dev or v.dtype != torch.float32
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{dev}, got {v.dtype} on {v.device}")
    if t * 2 * c >= 2 ** 31 or t // plan.factor >= _TILE * 65536:
        raise ValueError(f"tail dispatch of {t} x {c} is too large for one "
                         f"kernel launch")
    lib = _lib()
    smem = lib.wfm_tail_smem_bytes(plan.h.numel(), plan.factor, plan.ell)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"low-pass of {plan.h.numel()} taps at decimation "
                         f"{plan.factor} does not fit the FIR tile")
    y = torch.empty(t // plan.factor, 2 * c, dtype=torch.float32, device=dev)
    hist_out = torch.empty(plan.d_rows, 2 * c, dtype=torch.float32, device=dev)
    err = lib.wfm_tail_forward(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        raw_t.data_ptr(), t, c, p0_t.data_ptr(), wf_t.data_ptr(), plan.ell,
        hist.data_ptr(), plan.d_rows, plan.h.data_ptr(), plan.h.numel(),
        plan.factor, y.data_ptr(), hist_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"wfm_tail kernel launch failed: CUDA error {err} "
                           f"({lib.wfm_tail_error_string(err).decode()})")
    wfm_tail.launches += 1
    return y, hist_out


wfm_tail.launches = 0  # CUDA kernel launches (the plain path never counts)
