"""Fused wideband front end: DC blocker + NCO mix + composed-FIR decimation.

Port of ``fused_front_packed`` / ``_front_kernel``
(pebblesdr_tpu/ops/pallas_kernels.py:516, :119) in its base form.  Input is
one lane-packed [T, 2C] float32 plane (re lanes [0, C), im lanes [C, 2C))
spanning T/n_block logical blocks.  Per dispatch:

  * DC: chunk means mu_k over 512 rows, m_k = a m_{k-1} + (1-a) mu_k with
    a = alpha^512 and m_{-1} the carried estimate; chunk k subtracts m_k;
  * NCO: u[t] = z[t] exp(-j 2 pi phi(t)), phi in the split form of the TPU
    kernel (t = 2048 s + 128 q + r; exact because f_hi is on the 2^-12 grid);
  * FIR: y[o] = sum_{j=0..D} h[j] u[F o - j], u[t < 0] from the carried
    post-mix tail (tail row d_rows + t); tail' = u[T - d_rows .. T-1];
  * raw[b] = the trailing raw_rows input rows of block b (display tails);
  * phase' = mod(phase0 + mod(T f_hi, 1) + T f_lo, 1).

``fused_front`` launches the CUDA kernel (csrc/front.cu) for a CUDA plane and
runs ``fused_front_reference`` (plain PyTorch) for a CPU plane.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import decimator
from pebblesdr_tpu_torch.ops.mixer import TWO_PI, advance_phase

DC_CHUNK = 512     # DC-estimate chunk (ops.iir.dc_removal_chunked)
SUB_BLOCK = 2048   # phase decomposition block and the plain FIR's window step
_Q = 128           # phase decomposition: coarse step
_FIR_TILE = 24     # decimated outputs per FIR block (kM in csrc/front.cu)
_MAX_SMEM = 232448  # shared memory one Hopper block may use (kMaxSmem)
SOURCE = "pebblesdr_tpu_torch/csrc/front.cu"
REPLACES = "pebblesdr_tpu/ops/pallas_kernels.py:119"


@dataclasses.dataclass(frozen=True, eq=False)
class FrontPlan:
    """Static geometry of one front end: the composed response and its
    Toeplitz block, on the device the front runs on."""
    factor: int
    d_rows: int            # carried history rows (D rounded up to 8)
    dc_alpha: float
    h: torch.Tensor        # [D+1] float32 composed response (kernel)
    w: torch.Tensor        # [d_rows + SUB_BLOCK, SUB_BLOCK/F] (plain version)

    @staticmethod
    def make(h_np: np.ndarray, factor: int, device,
             dc_alpha: float = 0.9999) -> "FrontPlan":
        d = len(h_np) - 1
        d_rows = ((d + 7) // 8) * 8
        w = decimator.build_composed_w(h_np, factor, SUB_BLOCK, d_rows - d)
        return FrontPlan(
            factor=int(factor), d_rows=d_rows, dc_alpha=float(dc_alpha),
            h=torch.as_tensor(np.asarray(h_np, np.float32), device=device),
            w=torch.from_numpy(w).to(device))

    @property
    def ewma(self) -> tuple[float, float]:
        """(a, 1 - a) of the per-chunk EWMA, rounded to float32 as the TPU
        kernel's weakly-typed constants are."""
        a = float(self.dc_alpha) ** DC_CHUNK
        return float(np.float32(a)), float(np.float32(1.0 - a))


def _check_geometry(plan: FrontPlan, x: torch.Tensor, n_block: int,
                    raw_rows: int) -> tuple[int, int, int]:
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"front input must be a [T, 2C] plane, got "
                         f"{tuple(x.shape)}")
    t = x.shape[0]
    n_block = n_block or t
    if n_block % SUB_BLOCK or t % n_block:
        raise ValueError(f"front needs n_block % {SUB_BLOCK} == 0 and "
                         f"T % n_block == 0 (T={t}, n_block={n_block})")
    if n_block % plan.factor:
        raise ValueError(f"n_block={n_block} not divisible by the decimation "
                         f"factor {plan.factor}")
    r = min(raw_rows, SUB_BLOCK) or 8
    return t, n_block, r


def fused_front_reference(plan: FrontPlan, x: torch.Tensor, dc: torch.Tensor,
                          phase0: torch.Tensor, f_hi: torch.Tensor,
                          f_lo: torch.Tensor, tail: torch.Tensor,
                          n_block: int = 0, raw_rows: int = 0):
    """Plain PyTorch version of the fused front end (see module docstring).

    x [T, 2C] f32; dc [1, 2C]; phase0/f_hi/f_lo [C]; tail [d_rows, 2C].
    Returns (y [T/F, 2C], dc' [1, 2C], tail' [d_rows, 2C], phase' [C],
    raw [T/n_block, R, 2C])."""
    t, n_block, r = _check_geometry(plan, x, n_block, raw_rows)
    c2 = x.shape[1]
    c = c2 // 2
    dev = x.device
    raw = x.reshape(t // n_block, n_block, c2)[:, n_block - r:, :].contiguous()

    # DC blocker: chunk means, then the EWMA across chunks in closed form
    # (float64 lower-triangular weights, one matmul)
    nchunk = t // DC_CHUNK
    means = x.reshape(nchunk, DC_CHUNK, c2).mean(dim=1)
    a = float(plan.dc_alpha) ** DC_CHUNK
    lmat, seed = _ewma_weights(nchunk, a, dev)
    m = (torch.matmul(lmat, means.double())
         + seed[:, None] * dc.double()).float()                # [nchunk, 2C]
    z = (x.reshape(nchunk, DC_CHUNK, c2) - m[:, None, :]).reshape(t, c2)

    # NCO mix: phasor = coarse (per 128 rows) x fine (row within them)
    cos_a, sin_a = oscillator(phase0, f_hi, f_lo, t)            # [T, C] each
    zr, zi = z[:, :c], z[:, c:]
    u = torch.cat([zr * cos_a + zi * sin_a, zi * cos_a - zr * sin_a], dim=1)

    # composed FIR: each SUB_BLOCK of outputs is W^T against its
    # tail-extended window
    ext = torch.cat([tail, u], dim=0)                           # [d_rows+T, 2C]
    wins = ext.unfold(0, plan.d_rows + SUB_BLOCK, SUB_BLOCK)     # [nsub, 2C, L]
    y = torch.matmul(wins, plan.w).transpose(1, 2).reshape(t // plan.factor, c2)
    return (y, m[-1:], ext[ext.shape[0] - plan.d_rows:].contiguous(),
            advance_phase(phase0, t, f_hi, f_lo), raw)


@functools.lru_cache(maxsize=8)
def _ewma_weights(nchunk: int, a: float, device: torch.device):
    """m = L @ mu + s * m_{-1}: L[k, i] = (1-a) a^(k-i) (i <= k), s = a^(k+1)."""
    kk = np.arange(nchunk)
    expo = kk[:, None] - kk[None, :]
    lmat = np.where(expo >= 0, (1.0 - a) * a ** np.maximum(expo, 0), 0.0)
    seed = a ** (kk + 1.0)
    return (torch.from_numpy(lmat).to(device),
            torch.from_numpy(seed).to(device))


def phase_tables(phase0: torch.Tensor, f_hi: torch.Tensor,
                 f_lo: torch.Tensor, t: int):
    """Oscillator phases (cycles) of rows 0..t-1 in the TPU kernel's split
    form t = 2048 s + 128 q + r: coarse [ceil(t/2048), 16, C] per (s, q) and
    fine [128, C] per r."""
    dev = phase0.device
    nsub = -(-t // SUB_BLOCK)
    k0 = (torch.arange(nsub, device=dev) * SUB_BLOCK).float()[:, None]
    ph0 = torch.remainder(phase0 + torch.remainder(k0 * f_hi, 1.0)
                          + k0 * f_lo, 1.0)                        # [nsub, C]
    qq = (torch.arange(SUB_BLOCK // _Q, device=dev) * _Q).float()[:, None]
    coarse = torch.remainder(ph0[:, None, :] + torch.remainder(qq * f_hi, 1.0)
                             + qq * f_lo, 1.0)                     # [nsub, 16, C]
    rr = torch.arange(_Q, device=dev).float()[:, None]
    fine = torch.remainder(torch.remainder(rr * f_hi, 1.0) + rr * f_lo, 1.0)
    return coarse, fine


def oscillator(phase0: torch.Tensor, f_hi: torch.Tensor, f_lo: torch.Tensor,
               t: int):
    """(cos, sin) of 2 pi phi(t) for rows 0..t-1, [t, C] each, as the
    product of the coarse and fine phasors."""
    coarse, fine = phase_tables(phase0, f_hi, f_lo, t)
    cr = torch.cos(TWO_PI * coarse)[:, :, None, :]
    ci = torch.sin(TWO_PI * coarse)[:, :, None, :]
    fr, fi = torch.cos(TWO_PI * fine), torch.sin(TWO_PI * fine)
    c = phase0.shape[0]
    cos_a = (cr * fr - ci * fi).reshape(-1, c)[:t]
    sin_a = (cr * fi + ci * fr).reshape(-1, c)[:t]
    return cos_a, sin_a


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/front.cu, built at first use, with its C signatures declared."""
    lib = build.load("front")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.front_forward.restype = ctypes.c_int
    lib.front_forward.argtypes = [
        i, p, i, i, i, i, p, p, i, p, p, p, p, i, i,
        ctypes.c_float, ctypes.c_float, p, p, p, p, p, p]
    lib.front_error_string.restype = ctypes.c_char_p
    lib.front_error_string.argtypes = [i]
    lib.front_fir_smem_bytes.restype = ctypes.c_size_t
    lib.front_fir_smem_bytes.argtypes = [i, i]
    return lib


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, shape):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def fused_front(plan: FrontPlan, x: torch.Tensor, dc: torch.Tensor,
                phase0: torch.Tensor, f_hi: torch.Tensor, f_lo: torch.Tensor,
                tail: torch.Tensor, n_block: int = 0, raw_rows: int = 0):
    """The fused front end: the CUDA kernel for a CUDA plane, the plain
    version for a CPU plane.  Same arguments and results as
    fused_front_reference."""
    if x.device.type == "cpu":
        return fused_front_reference(plan, x, dc, phase0, f_hi, f_lo, tail,
                                     n_block, raw_rows)
    if x.device.type != "cuda":
        raise ValueError(f"fused_front runs on cuda or cpu, not {x.device}")
    t, n_block, r = _check_geometry(plan, x, n_block, raw_rows)
    c2 = x.shape[1]
    c = c2 // 2
    dev = x.device
    _check_cuda("x", x, dev, (t, c2))
    _check_cuda("dc", dc, dev, (1, c2))
    _check_cuda("tail", tail, dev, (plan.d_rows, c2))
    for name, v in (("phase0", phase0), ("f_hi", f_hi), ("f_lo", f_lo)):
        _check_cuda(name, v, dev, (c,))
    _check_cuda("h", plan.h, dev, plan.h.shape)
    if t * c2 >= 2 ** 31 or t // plan.factor >= _FIR_TILE * 65536:
        raise ValueError(f"front dispatch of {t} x {c2} is too large for one "
                         f"kernel launch")
    lib = _lib()
    smem = lib.front_fir_smem_bytes(plan.h.numel(), plan.factor)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"composed response of {plan.h.numel()} taps at "
                         f"factor {plan.factor} does not fit the FIR tile")
    a, b = plan.ewma
    y = torch.empty(t // plan.factor, c2, dtype=torch.float32, device=dev)
    dc_out = torch.empty(1, c2, dtype=torch.float32, device=dev)
    tail_out = torch.empty(plan.d_rows, c2, dtype=torch.float32, device=dev)
    raw = torch.empty(t // n_block, r, c2, dtype=torch.float32, device=dev)
    mseq = torch.empty(t // DC_CHUNK, c2, dtype=torch.float32, device=dev)
    err = lib.front_forward(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        x.data_ptr(), t, c, n_block, r, dc.data_ptr(), tail.data_ptr(),
        plan.d_rows, phase0.data_ptr(), f_hi.data_ptr(), f_lo.data_ptr(),
        plan.h.data_ptr(), plan.h.numel(), plan.factor, a, b,
        mseq.data_ptr(), y.data_ptr(), dc_out.data_ptr(), tail_out.data_ptr(),
        raw.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"front kernel launch failed: CUDA error {err} "
                           f"({lib.front_error_string(err).decode()})")
    fused_front.launches += 1
    return y, dc_out, tail_out, advance_phase(phase0, t, f_hi, f_lo), raw


fused_front.launches = 0  # CUDA kernel launches (the plain path never counts)
