"""Fused WFM stereo tail: stereo demux + decimating audio low-pass.

Port of ``wfm_tail_packed`` / ``_wfm_tail_kernel``
(pebblesdr_tpu/ops/pallas_kernels.py:917, :869).  From the time-major
composite raw [T, C] and the open pilot's per-chunk phase parameters
(phase(fL + r) = p0[f] + wf[f] r, ops/pll.py):

  * demux: lmr = raw * 2 sin(2 phase), mono = raw, packed a = [mono | lmr];
  * low-pass: audio[o] = sum_{j=0..D} h[j] a[F o - j] with a[t < 0] from the
    carried packed history (row d_rows + t; its L-R lanes are post-demux);
    hist' = a[T - d_rows .. T-1].

``wfm_tail`` launches the CUDA kernel (csrc/wfm_tail.cu, one launch per
call: a time march that stages and demuxes each composite row once and
writes hist' itself) for CUDA tensors and runs ``wfm_tail_reference``
(plain PyTorch) for CPU tensors.  ``tail_march_layout`` and
``tail_march_plan`` mirror the kernel's shared-memory layout and work
items (the card tests hold them to the C exports).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import decimator
from pebblesdr_tpu_torch.ops.front import H100_SMS, PLANE_ALIGN

_CG = 16           # channels per work item (kCg in csrc/wfm_tail.cu)
_LANES = 2 * _CG   # [mono | L-R] lanes of a ring row (kLanes)
_STEP_OUT = 128    # outputs of one step: 8 FIR warps x 16 (kStepOut)
_BOX_ROWS = 128    # rows of a tensor-map box (kBoxRows)
_MAX_SLICE_TAPS = 64   # kMaxSliceTaps
_STAGE_BUDGET = 65536  # bytes of the raw stages (kStageBudget)
_RING_STEPS = 2        # steps the ring keeps where they fit (kRingSteps)
_MAX_STAGES = 4        # kMaxStages
_MAX_SMEM = 232448
SLICE_TAPS = (8, 16, 32, 60, 64)  # the kernel's instantiations (taps/slice)
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


def tail_slices(ntaps: int, factor: int) -> tuple[int, int]:
    """(S, dps): each polyphase branch of the low-pass cut into S slices of
    dps taps (tail_slices in csrc/wfm_tail.cu); dps 0 when no instantiation
    covers it."""
    if factor < 1 or ntaps < 1:
        return 0, 0
    need = -(-ntaps // factor)
    s = -(-need // _MAX_SLICE_TAPS)
    per = -(-need // s)
    return s, next((d for d in SLICE_TAPS if per <= d), 0)


def tail_march_layout(ntaps: int, factor: int,
                      d_rows: int | None = None) -> dict[str, int] | None:
    """The march's geometry and shared-memory layout in bytes (TailGeom in
    csrc/wfm_tail.cu, mirrored), or None when no instantiation covers the
    low-pass or it does not fit a block.  A step makes 128 outputs from
    step_rows = 128 F new rows; the ring of [mono | L-R] rows keeps `hist`
    rows before them (the FIR's F S dps - 1, or d_rows for hist' when that
    is more, in whole 128-row boxes: the prologue) and two steps where they
    fit, else the fewest that keep the rewind's copy off its source;
    `stages` raw stages of stage_rows x 16 float32; then the taps
    [F][S][dps].  d_rows defaults to TailPlan's (ntaps - 1 rounded up to
    8)."""
    n_s, dps = tail_slices(ntaps, factor)
    if not dps:
        return None
    if d_rows is None:
        d_rows = -(-(ntaps - 1) // 8) * 8
    step_rows = _STEP_OUT * factor
    fir_hist = factor * n_s * dps - 1
    hist = -(-max(fir_hist, d_rows) // _BOX_ROWS) * _BOX_ROWS
    stage_rows = max(step_rows, hist)
    stage_bytes = stage_rows * _CG * 4
    stages = min(max(_STAGE_BUDGET // stage_bytes, 2), _MAX_STAGES)
    ring = 128 + stages * stage_bytes
    x_min = max(-(-hist // step_rows), 1)
    for x in range(max(x_min, _RING_STEPS), x_min - 1, -1):
        ring_rows = hist + x * step_rows
        taps = ring + ring_rows * _LANES * 4
        smem = -(-(taps + factor * n_s * dps * 4) // 128) * 128
        if smem <= _MAX_SMEM:
            break
    if (smem > _MAX_SMEM or stage_bytes >= 2 ** 20
            or step_rows % _BOX_ROWS):
        return None
    return {"slices": n_s, "dps": dps, "step_rows": step_rows,
            "fir_hist": fir_hist, "hist": hist, "ring_rows": ring_rows,
            "stage_rows": stage_rows, "stage_bytes": stage_bytes,
            "stages": stages, "ring": ring, "taps": taps, "smem": smem}


def tail_march_plan(t: int, c: int, factor: int, ntaps: int,
                    n_sm: int = H100_SMS) -> dict | None:
    """The march's work items at one block per SM (tail_plan in
    csrc/wfm_tail.cu, mirrored): a channel group of 16 channels x a time
    segment of `seg_outputs` outputs (the last segment shorter), item i =
    segment i / groups, channel group i % groups.  The segment length
    gives the fewest rows on the busiest block, among those with at least
    two items per SM where the shape has them.  Each item stages and
    demuxes its prologue, rows [F o_s - hist, F o_s), then marches in
    steps of step_rows rows from row F o_s.  None when no instantiation
    covers the low-pass."""
    lay = tail_march_layout(ntaps, factor)
    if lay is None:
        return None
    m = t // factor
    groups = -(-c // _CG)
    max_seg = -(-m // _STEP_OUT)
    n_lo = min(max(-(-2 * n_sm // groups), 1), max_seg)
    best = (None, m, 1)
    for n in range(n_lo, min(4 * n_lo, max_seg) + 1):
        ms = -(-m // n)
        nseg = -(-m // ms)
        if nseg < n_lo:
            continue
        cost = -(-groups * nseg // n_sm) * (
            -(-ms // _STEP_OUT) * lay["step_rows"] + lay["hist"])
        if best[0] is None or cost < best[0]:
            best = (cost, ms, nseg)
    _, ms, nseg = best
    segments = [(o, min(o + ms, m)) for o in range(0, m, ms)]
    return {"seg_outputs": ms, "segments": segments, "groups": groups,
            "items": groups * nseg, "grid": min(groups * nseg, n_sm),
            "steps": [-(-(e - o) // _STEP_OUT) for o, e in segments],
            "step_outputs": _STEP_OUT, "step_rows": lay["step_rows"],
            "prologue_rows": lay["hist"], "smem": lay["smem"],
            "layout": lay}


def tail_tma(c: int) -> bool:
    """Whether the march stages a [T, C] float32 composite by tensor-map
    boxes: a box starts on a 16-byte boundary, so a row must fill whole 16
    bytes (C % 4 == 0); otherwise it stages element by element."""
    return c % 4 == 0


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
    return declare(build.load("wfm_tail"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A library built from csrc/wfm_tail.cu with its C signatures declared
    (also for the variants tools/tail_cells.py --sweep builds)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wfm_tail_forward.restype = ctypes.c_int
    lib.wfm_tail_forward.argtypes = [i, p, i, i, p, p, i, p, i, p, i, i, p, p,
                                     i, p]
    lib.wfm_tail_error_string.restype = ctypes.c_char_p
    lib.wfm_tail_error_string.argtypes = [i]
    lib.wfm_tail_smem_bytes.restype = ctypes.c_size_t
    lib.wfm_tail_smem_bytes.argtypes = [i, i, i]
    lib.wfm_tail_plan.restype = ctypes.c_int
    lib.wfm_tail_plan.argtypes = [i, i, i, i, i, i, p]
    return lib


def wfm_tail(plan: TailPlan, raw_t: torch.Tensor, p0_t: torch.Tensor,
             wf_t: torch.Tensor, hist: torch.Tensor):
    """The stereo tail: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Same arguments and results as wfm_tail_reference."""
    if raw_t.device.type == "cpu":
        return wfm_tail_reference(plan, raw_t, p0_t, wf_t, hist)
    if raw_t.device.type != "cuda":
        raise ValueError(f"wfm_tail runs on cuda or cpu, not {raw_t.device}")
    ret = _launch(plan, raw_t, p0_t, wf_t, hist)
    wfm_tail.launches += 1
    if not tail_tma(raw_t.shape[1]):
        wfm_tail.element_launches += 1
    return ret


def _launch(plan: TailPlan, raw_t: torch.Tensor, p0_t: torch.Tensor,
            wf_t: torch.Tensor, hist: torch.Tensor):
    """Check the arguments, allocate the outputs and launch csrc/wfm_tail.cu
    on raw_t's device and current stream."""
    t, c = _check_geometry(plan, raw_t, p0_t, wf_t, hist)
    dev = raw_t.device
    for name, v in (("raw_t", raw_t), ("p0_t", p0_t), ("wf_t", wf_t),
                    ("hist", hist), ("h", plan.h)):
        if (v.device != dev or v.dtype != torch.float32
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{dev}, got {v.dtype} on {v.device}")
    if t * 2 * c >= 2 ** 31:
        raise ValueError(f"tail dispatch of {t} x {c} is too large for one "
                         f"kernel launch")
    tma = tail_tma(c)
    if tma and raw_t.data_ptr() % PLANE_ALIGN:
        raise ValueError(f"raw_t must start on a {PLANE_ALIGN}-byte boundary "
                         f"(tensor-map staging), got address "
                         f"{raw_t.data_ptr():#x}")
    lib = _lib()
    smem = lib.wfm_tail_smem_bytes(plan.h.numel(), plan.factor, plan.ell)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"low-pass of {plan.h.numel()} taps at decimation "
                         f"{plan.factor} does not fit the march's block")
    y = torch.empty(t // plan.factor, 2 * c, dtype=torch.float32, device=dev)
    hist_out = torch.empty(plan.d_rows, 2 * c, dtype=torch.float32, device=dev)
    err = lib.wfm_tail_forward(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        raw_t.data_ptr(), t, c, p0_t.data_ptr(), wf_t.data_ptr(), plan.ell,
        hist.data_ptr(), plan.d_rows, plan.h.data_ptr(), plan.h.numel(),
        plan.factor, y.data_ptr(), hist_out.data_ptr(), int(tma),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"wfm_tail kernel launch failed: CUDA error {err} "
                           f"({lib.wfm_tail_error_string(err).decode()})")
    return y, hist_out


wfm_tail.launches = 0          # CUDA kernel launches (the plain path never
                               # counts)
wfm_tail.element_launches = 0  # of them, those that staged element by
                               # element (C % 4 != 0)
