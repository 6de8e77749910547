"""Fused wideband front end: DC blocker + NCO mix + composed-FIR decimation
(+ the FM discriminator of the decimated composite, for WFM), with the
front-end options int16 entry, static IQ balance and the noise blanker.

Port of ``fused_front_packed`` / ``_front_kernel``
(pebblesdr_tpu/ops/pallas_kernels.py:516, :119) at fold 1, with its
``in_scale``, ``iq_gain``/``iq_phase``, ``nb``, ``disc_gain``,
``y_tail_rows`` and ``comp_taps`` switches.  Input is one lane-packed [T, 2C] float32 or int16
plane (re lanes [0, C), im lanes [C, 2C)) spanning T/n_block logical blocks.
Per dispatch, in this order:

  * int16 entry: the plane is read as x * 2^-15 (exact in float32);
  * DC: chunk means mu_k over 512 rows, m_k = a m_{k-1} + (1-a) mu_k with
    a = alpha^512 and m_{-1} the carried estimate; chunk k subtracts m_k;
  * IQ balance (iq_gain g, iq_phase p): re' = g re, im' = im + p re;
  * noise blanker (nb = (threshold, blank_width, alpha, mode)), per lane:
    mag2 = |z|^2; the chunk means of mag2 and their EWMA with
    a = (1-alpha)^512 seeded by the carried nb_avg [1, 2C]; each chunk
    compares against the average entering it, spike = mag2 >
    threshold^2 max(avg, 1e-18); causal dilation over blank_width rows,
    seeded by the carried flags nb_tail [16, 2C];
  * NCO: u[t] = z[t] exp(-j 2 pi phi(t)), phi in the split form of the TPU
    kernel (t = 2048 s + 128 q + r; exact because f_hi is on the 2^-12 grid);
    then on the dilated flags NB1 ("blank") zeroes u and NB2 ("average")
    scales it by sqrt(avg / max(mag2, 1e-24));
  * FIR: y[o] = sum_{j=0..D} h[j] u[F o - j], u[t < 0] from the carried
    post-mix tail (tail row d_rows + t); tail' = u[T - d_rows .. T-1];
  * raw[b] = the trailing raw_rows input rows of block b (display tails);
  * phase' = mod(phase0 + mod(T f_hi, 1) + T f_lo, 1);
  * nb_avg' = the EWMA after the last chunk, nb_tail' = the last 16 rows of
    undilated flags (0/1);
  * with disc_gain != 0: disc[o] = atan2(y[o] conj(y[o-1])) * disc_gain per
    channel, y[-1] the carried disc_last [1, 2C], and disc_last' = y[-1];
    with y_tail_rows > 0, y is returned only as each block's trailing
    y_tail_rows rows, [K, y_tail_rows, 2C] (the WFM zoom windows);
  * with comp_taps (the hq geometry, tc taps), the discriminator output d
    is decimated by 2 before it is returned: disc[j] = sum_{i<tc} ct[i]
    d[2j - i] per channel, d[t < 0] from the carried comp_hist [hr, C]
    (row hr + t; hr = tc - 1 rounded up to 8, the top rows have no
    weight), so disc is [T/(2F), C]; comp_hist' = the last hr rows of d.

``fused_front`` launches the CUDA kernel (csrc/front.cu) for a CUDA plane and
runs ``fused_front_reference`` (plain PyTorch) for a CPU plane.  One call is
3 CUDA launches in the base form (front_means, front_dc_scan, front_fir,
which also writes tail' and nb_tail'), 5 with the blanker
(front_nb_means and a second front_dc_scan), 4 in the WFM form
(front_disc) and 4 in the hq form (front_comp).  Its first
pass, the chunk means and the raw tails (``front_means``), is also exposed
alone as ``chunk_means`` / ``chunk_means_reference``.  A CUDA plane must be
16-byte aligned (``PLANE_ALIGN``): the kernels stream it with bulk copies.

The TPU kernel also reads time-folded planes (lane group g = time segment g,
a layout that fills the TPU's 128-lane tiles at small C).  Hopper has no
such padding: ``unfold_plane`` turns a folded entry plane back into [T, 2C]
with one device copy, and the kernel reads only unfolded planes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import decimator, fir
from pebblesdr_tpu_torch.ops.mixer import TWO_PI, advance_phase

DC_CHUNK = 512     # DC-estimate chunk (ops.iir.dc_removal_chunked)
SUB_BLOCK = 2048   # phase decomposition block and the plain FIR's window step
_Q = 128           # phase decomposition: coarse step
_FIR_PART = 12     # decimated outputs of one front_fir part (kPartM in
                   # csrc/front.cu)
_FIR_GROUPS = 16   # branch groups of a part at most at 8 channels (kGroups)
_FIR_THREADS = 512  # threads of a front_fir block (kThreads)
FIR_CG = (8, 4)    # channels per front_fir work item: kCg where the layout
                   # fits, else kCgNarrow
_FIR_STAGE_BYTES = 49152  # the raw stages' budget (kMarchStageBytes)
_FIR_MAX_STAGES = 8       # kMarchMaxStages
_FIR_MAX_BOX = 256        # rows of a tensor-map box at most (kMarchMaxBox)
_MAX_SMEM = 232448  # shared memory one Hopper block may use (kMaxSmem)
FIR_BRANCH_TAPS = (8, 16, 24, 32, 40)  # front_fir instantiations (taps/branch)
H100_SMS = 132     # streaming multiprocessors of an H100 SXM
NB_TAIL_ROWS = 16  # carried spike-flag rows (the TPU kernel's tile height)
_NB_HALO = NB_TAIL_ROWS - 1  # flag rows of context before a front_fir unit
I16_SCALE = 2.0 ** -15      # int16 full scale 32768 -> 1.0
NB_MODES = ("blank", "average")  # NB1, NB2
COMP_DECIM = 2     # the hq composite decimation (comp_taps)
_MAX_COMP_TAPS = 32  # most comp_taps front_comp takes (kMaxCompTaps)
_COMP_CG = 32        # channels per front_comp work item (kCompCg)
_COMP_STEP_OUT = 64  # half-rate outputs of one front_comp step (kCompStepOut)
_COMP_HIST = 32      # d rows kept before a step, the prologue (kCompHist)
_COMP_BOX_ROWS = 32  # rows of a front_comp tensor-map box (kCompBoxRows)
_COMP_ALIGN = 16     # a front_comp segment's outputs divide (kCompAlign)
_COMP_BLOCKS_PER_SM = 2    # resident front_comp blocks (kCompBlocksPerSm)
_COMP_STAGE_BYTES = 65536  # front_comp's stages' budget (kCompStageBytes)
_COMP_MAX_STAGES = 4       # kCompMaxStages
_COMP_RING_STEPS = 2       # steps the d ring keeps (kCompRingSteps)
_SCAN_SEGS = 32            # front_dc_scan's segments per lane (kScanSegs)
_SCAN_LANES = 8            # its lanes per block at most (kScanLanes)
_SCAN_HELD = 64            # chunks a thread holds in registers (kScanHeld)
PLANE_ALIGN = 16   # bytes: a CUDA plane's alignment (bulk copies)
SOURCE = "pebblesdr_tpu_torch/csrc/front.cu"
REPLACES = "pebblesdr_tpu/ops/pallas_kernels.py:119"
MEANS_REPLACES = "pebblesdr_tpu/ops/pallas_kernels.py:193"


def comp_hist_rows(tc: int) -> int:
    """Rows of the carried composite-decimator history: tc - 1 rounded up
    to 8, as the TPU kernel's (pallas_kernels.py:670)."""
    return ((tc - 1 + 7) // 8) * 8


def _fir_busy_max(cg: int) -> int:
    """Branch groups of a part at most (march_busy_max): 16 at 8 channels,
    every thread group of the block at 4."""
    return _FIR_GROUPS if cg == 8 else _FIR_THREADS // (2 * cg)


def fir_parts(factor: int, cg: int = 8) -> tuple[int, int]:
    """(busy, parts) of front_fir's FIR map (march_busy, march_parts in
    csrc/front.cu) for items of cg channels: the block is 512 / (2 cg)
    thread groups of 2 cg lanes (32 at cg = 8, 64 at cg = 4); a step's
    outputs are `parts` parts of 12, each made by busy = min(F, busy_max)
    groups, one per branch (branches g, g + busy_max, ... at F > busy_max;
    busy_max 16 at cg = 8, 64 at cg = 4), so every group works at every F
    that divides the group count (the step is 12 parts outputs)."""
    busy = min(factor, _fir_busy_max(cg))
    return busy, _FIR_THREADS // (2 * cg) // busy


def fir_group_items(factor: int, cg: int = 8) -> list[list[tuple[int, int]]]:
    """front_fir's branch x part map: for each of a block's thread groups
    the (branch, part) items it runs; group G makes part G // busy of
    branches G % busy, G % busy + busy_max, ... < F (fir_parts)."""
    busy, parts = fir_parts(factor, cg)
    step = _fir_busy_max(cg)
    return [[(p, g // busy) for p in range(g % busy, factor, step)]
            if g // busy < parts else []
            for g in range(_FIR_THREADS // (2 * cg))]


def fir_box_lanes(cg: int, elem: int) -> int:
    """Lanes of a front_fir stage row (march_box_lanes): the item's cg
    channels, or the 16 bytes a tensor-map box must span when they are
    fewer (int16 at cg = 4: 8 lanes, the item reads its 4)."""
    return cg if cg * elem >= 16 else 16 // elem


def fir_branch_taps(ntaps: int, factor: int) -> int:
    """Taps per polyphase branch of the front_fir instantiation that covers
    ntaps taps at decimation `factor` (march_branch_taps), 0 when none
    does."""
    need = -(-ntaps // factor)
    return next((d for d in FIR_BRANCH_TAPS if need <= d), 0)


def fir_march_layout(ntaps: int, factor: int, nb: bool = False,
                     elem: int = 4, cg: int | None = None
                     ) -> dict[str, int] | None:
    """front_fir's geometry and shared-memory layout in bytes (MarchGeom in
    csrc/front.cu, mirrored) for a plane of elem-byte lanes and items of cg
    channels (None: march_cg's choice, 8 where that layout fits, else 4),
    or None when no instantiation covers ntaps/factor taps per branch or it
    does not fit a block.  A step makes km = 12 parts outputs (fir_parts)
    from step_rows = km F new rows; `stages` raw stages of one step each,
    rows of bw lanes (fir_box_lanes); the ring of mixed rows holds the
    history (hist = F (DP - 1) rows) and the fewest steps that keep its
    copy-down off its source; then the fine phasors and phase parameters,
    the taps, two sets of a unit's tables, the groups' partial sums (red =
    -1: inside the stage the step mixed, when it is as large) and, with the
    blanker, the flag words."""
    if cg is None:
        return next((lay for lay in (fir_march_layout(ntaps, factor, nb,
                                                      elem, g)
                                     for g in FIR_CG) if lay), None)
    dp = fir_branch_taps(ntaps, factor)
    if not dp:
        return None

    def a128(v):
        return (v + 127) & ~127

    busy, parts = fir_parts(factor, cg)
    bw = fir_box_lanes(cg, elem)
    km = _FIR_PART * parts
    step_rows = km * factor
    nbox = -(-step_rows // _FIR_MAX_BOX)
    while step_rows % nbox:
        nbox += 1
    box_rows = step_rows // nbox
    stage_bytes = step_rows * 2 * bw * elem
    stages = min(max(_FIR_STAGE_BYTES // stage_bytes, 2), _FIR_MAX_STAGES)
    hist = factor * (dp - 1)
    ring_rows = hist + max(-(-hist // step_rows), 1) * step_rows
    unit = max(hist, step_rows)
    nq, nk = unit // _Q + 2, unit // DC_CHUNK + 2
    lay = {"dp": dp, "cg": cg, "bw": bw, "busy": busy, "parts": parts,
           "km": km, "step_rows": step_rows,
           "box_rows": box_rows, "stage_bytes": stage_bytes,
           "stages": stages, "hist": hist, "ring_rows": ring_rows,
           "stage": 128}
    # one set of a unit's tables: coarse phasors, DC and blanker averages
    table = (a128(2 * nq * cg * 4) + a128(nk * 2 * cg * 4)
             + (a128(nk * 2 * cg * 4) if nb else 0))
    o = 128 + stages * stage_bytes
    plane = a128(ring_rows * cg * 4)
    lay["ring_re"], lay["ring_im"] = o, o + plane + 64
    o = a128(lay["ring_im"] + plane)
    lay["fine"] = o
    o += 2 * _Q * cg * 4 + 128                         # + phase parameters
    lay["taps"] = o
    o = a128(o + factor * dp * 4)
    lay["tables"] = o                                  # two sets
    o += 2 * table
    red_bytes = parts * busy * _FIR_PART * 2 * cg * 4
    lay["red_bytes"] = red_bytes
    lay["red"] = -1 if stage_bytes >= red_bytes else o
    if lay["red"] >= 0:
        o = a128(o + red_bytes)
    lay["flags"] = o
    if nb:
        o = a128(o + (_NB_HALO + unit) * 2)
        o = a128(o + unit * 2)                         # dilated words
    lay["smem"] = o
    ok = (o <= _MAX_SMEM and stage_bytes < 2 ** 20
          and (box_rows * bw * elem) % 128 == 0)
    return lay if ok else None


def fir_march_plan(t: int, c: int, factor: int, ntaps: int,
                   n_sm: int = H100_SMS, nb_bw: int = 0,
                   elem: int = 4) -> dict | None:
    """front_fir's work items at one block per SM (march_plan in
    csrc/front.cu, mirrored): a channel group of cg channels (the layout's)
    x a time segment of `seg_outputs` outputs (the last segment shorter),
    item i = segment i / groups, channel group i % groups.  The segment
    length gives the fewest rows on the busiest block, among those with at
    least two items per SM where the shape has them.  Each item mixes
    `prologue_rows` rows before its first step (the history, and with the
    blanker the bw - 1 flag rows above it), then marches in steps of
    step_rows rows.  None when no instantiation covers the plan."""
    lay = fir_march_layout(ntaps, factor, nb_bw > 0, elem)
    if lay is None:
        return None
    m = t // factor
    km = lay["km"]
    groups = -(-c // lay["cg"])
    max_seg = -(-m // km)
    n_lo = min(max(-(-2 * n_sm // groups), 1), max_seg)
    best = (None, m, 1)
    for n in range(n_lo, min(4 * n_lo, max_seg) + 1):
        ms = -(-m // n)
        nseg = -(-m // ms)
        if nseg < n_lo:
            continue
        cost = -(-groups * nseg // n_sm) * (
            -(-ms // km) * lay["step_rows"] + lay["hist"] + lay["step_rows"])
        if best[0] is None or cost < best[0]:
            best = (cost, ms, nseg)
    _, ms, nseg = best
    items = groups * nseg
    segments = [(o, min(o + ms, m)) for o in range(0, m, ms)]
    return {"seg_outputs": ms, "segments": segments, "groups": groups,
            "items": items, "grid": min(items, n_sm),
            "steps": [-(-(e - o) // km) for o, e in segments],
            "step_outputs": km, "step_rows": lay["step_rows"],
            "prologue_rows": lay["hist"] + max(nb_bw - 1, 0),
            "smem": lay["smem"], "layout": lay}


def comp_march_layout() -> dict[str, int]:
    """front_comp's geometry and shared-memory layout in bytes (CompGeom in
    csrc/front.cu, mirrored): `stages` stages of one unit (the prologue,
    the 32 rows before a segment, or a step of 128 rows) as [2][stage_rows]
    [32] float32 (the channel group's re lanes, then its im lanes), the
    ring of d rows (the 32-row history and two steps), the taps and two
    rows of y (the last row of the previous unit)."""
    def a128(v):
        return (v + 127) & ~127

    hist, step_rows = _COMP_HIST, COMP_DECIM * _COMP_STEP_OUT
    stage_rows = max(step_rows, hist)
    stage_bytes = stage_rows * 2 * _COMP_CG * 4
    stages = min(max(_COMP_STAGE_BYTES // stage_bytes, 2), _COMP_MAX_STAGES)
    ring_rows = hist + _COMP_RING_STEPS * step_rows
    ring = 128 + stages * stage_bytes
    taps = ring + ring_rows * _COMP_CG * 4
    prev = taps + _MAX_COMP_TAPS * 4
    return {"hist": hist, "step_rows": step_rows, "stage_rows": stage_rows,
            "stage_bytes": stage_bytes, "stages": stages,
            "ring_rows": ring_rows, "box_rows": _COMP_BOX_ROWS, "stage": 128,
            "ring": ring, "taps": taps, "prev": prev,
            "smem": a128(prev + 2 * 2 * _COMP_CG * 4)}


def comp_march_plan(m: int, c: int,
                    slots: int = _COMP_BLOCKS_PER_SM * H100_SMS) -> dict:
    """front_comp's work items on `slots` resident blocks (comp_plan in
    csrc/front.cu, mirrored; two blocks per H100 SM by default) for m
    decimated rows of y (m even): a channel group of 32 channels x a
    segment of `seg_outputs` half-rate outputs (a multiple of 16, so each
    segment starts on a 32-row box of y; the last segment shorter), item i
    = segment i / groups, channel group i % groups.  The segment length
    gives the fewest rows on the busiest block, among the choices from
    about two items per slot where the shape has them.  An item forms d of
    its prologue, rows [2 j_s - 32, 2 j_s), then of its own rows [2 j_s,
    2 j_e) in steps of 128 rows; it writes the y-tails and disc_last of its
    own rows, and the item whose segment ends at m / 2 writes
    comp_hist'."""
    lay = comp_march_layout()
    mh = m // 2
    groups = -(-c // _COMP_CG)
    max_seg = -(-mh // _COMP_STEP_OUT)
    n_lo = min(max(-(-2 * slots // groups), 1), max_seg)
    best = (None, mh, 1)
    for n in range(n_lo, min(4 * n_lo, max_seg) + 1):
        ms = -(-mh // n)
        ms = -(-ms // _COMP_ALIGN) * _COMP_ALIGN
        nseg = -(-mh // ms)
        cost = -(-groups * nseg // slots) * (
            -(-ms // _COMP_STEP_OUT) * lay["step_rows"] + lay["hist"])
        if best[0] is None or cost < best[0]:
            best = (cost, ms, nseg)
    _, ms, nseg = best
    segments = [(j, min(j + ms, mh)) for j in range(0, mh, ms)]
    return {"seg_outputs": ms, "segments": segments, "groups": groups,
            "items": groups * nseg, "grid": min(groups * nseg, slots),
            "steps": [-(-(e - j) // _COMP_STEP_OUT) for j, e in segments],
            "step_outputs": _COMP_STEP_OUT, "step_rows": lay["step_rows"],
            "prologue_rows": lay["hist"],
            "own_rows": [(2 * j, 2 * e) for j, e in segments],
            "writes_hist": [e == mh for _, e in segments],
            "smem": lay["smem"], "layout": lay}


def dc_scan_layout(nchunk: int, lanes: int) -> dict[str, int]:
    """front_dc_scan's launch (ScanGeom in csrc/front.cu, mirrored) for
    chunk means [nchunk, lanes]: lanes per block (a power of two <= 8, no
    more than the plane needs), 32 threads per lane (one per segment), the
    chunks each thread fetches into registers before its chains start (the
    least of 8, 16, 32, 64 that covers a segment; 0 for a longer one), the
    chunks of a segment, and for a longer segment the shared memory of the
    block's tile ([32 segments][len + 1][8 lanes], landed by cp.async; 0
    when it does not fit a block and the chains read device memory)."""
    lb = _SCAN_LANES
    while lb > 1 and lb // 2 >= lanes:
        lb //= 2
    seg = -(-nchunk // _SCAN_SEGS)
    held = 8
    while held < seg and held < _SCAN_HELD:
        held *= 2
    held = held if held >= seg else 0
    tile = _SCAN_SEGS * (seg + 1) * _SCAN_LANES * 4
    return {"lanes": lb, "blocks": -(-lanes // lb), "threads": _SCAN_SEGS * lb,
            "held": held, "len": seg,
            "smem": tile if not held and tile <= _MAX_SMEM - 8192 else 0}


def _fma32(x, y, z) -> np.ndarray:
    """float32 fma(x, y, z) with one rounding, elementwise: the product is
    exact in float64, TwoSum gives the float64 sum's error, and that error
    settles a float64 sum that lies on a float32 midpoint."""
    x, y, z = (np.asarray(v, np.float32).astype(np.float64) for v in (x, y, z))
    prod = x * y
    s = prod + z
    bv = s - prod
    err = (prod - (s - bv)) + (z - bv)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.inf, -np.inf).astype(np.float32))
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2
    tie = (s == mid) & (err != 0) & (s != r)
    up = np.maximum(r, other)
    lo = np.minimum(r, other)
    return np.where(tie, np.where(err > 0, up, lo), r).astype(np.float32)


def dc_scan_emulate(means, dc_in, a: float, b: float):
    """front_dc_scan's arithmetic in numpy float32, in its association:
    (m [nchunk, L], dc' [1, L]) of the chunk EWMA m_k = a m_{k-1} + b mu_k
    over means [nchunk, L] from dc_in [L] or [1, L], (a, b) float32.  Each
    lane's chunks are cut into 32 segments of ceil(nchunk / 32); each
    segment's (r, p) from (0, 1) by r = fma(a, r, b mu_k), p = p a; the 32
    seeds chained from dc_in by m = fma(p, m, r); each segment walked from
    its seed by m = fma(a, m, b mu_k).  The kernel's result equals it bit
    for bit."""
    mu = np.asarray(means, np.float32)
    nchunk, lanes = mu.shape
    a32, b32 = np.float32(a), np.float32(b)
    ln = -(-nchunk // _SCAN_SEGS)
    k0 = np.minimum(np.arange(_SCAN_SEGS) * ln, nchunk)
    k1 = np.minimum(k0 + ln, nchunk)

    def weighted(k):                      # b mu_k of each segment's chunk k
        return b32 * mu[np.minimum(k, nchunk - 1)]

    r = np.zeros((_SCAN_SEGS, lanes), np.float32)
    p = np.ones((_SCAN_SEGS, lanes), np.float32)
    for step in range(ln):
        k = k0 + step
        live = (k < k1)[:, None]
        r = np.where(live, _fma32(a32, r, weighted(k)), r)
        p = np.where(live, p * a32, p)
    m = np.asarray(dc_in, np.float32).reshape(lanes)
    seeds = np.empty((_SCAN_SEGS, lanes), np.float32)
    for q in range(_SCAN_SEGS):
        seeds[q] = m
        m = _fma32(p[q], m, r[q])
    out = np.empty_like(mu)
    for step in range(ln):
        k = k0 + step
        live = k < k1
        seeds = np.where(live[:, None], _fma32(a32, seeds, weighted(k)), seeds)
        out[k[live]] = seeds[live]
    return out, m[None, :]


def dc_scan_reference(means: torch.Tensor, dc: torch.Tensor, a: float):
    """Plain version of front_dc_scan: (m [nchunk, L], dc' [1, L]) of the
    chunk EWMA over means [nchunk, L] from dc [1, L], a in float64 (the
    closed form of _ewma)."""
    m = _ewma(means, dc, a)
    return m, m[m.shape[0] - 1:].clone()


def dc_scan(means: torch.Tensor, dc: torch.Tensor, a: float):
    """front_dc_scan alone (csrc/front.cu) for CUDA tensors, the plain
    version for CPU tensors: (m [nchunk, L], dc' [1, L]) of the chunk EWMA
    m_k = a m_{k-1} + (1 - a) mu_k over means [nchunk, L] from dc [1, L].
    The kernel takes (a, 1 - a) rounded to float32 (chunk_ewma) and runs
    on a copy of means."""
    if means.device.type == "cpu":
        return dc_scan_reference(means, dc, a)
    if means.device.type != "cuda":
        raise ValueError(f"dc_scan runs on cuda or cpu, not {means.device}")
    if means.dim() != 2:
        raise ValueError(f"dc_scan takes chunk means [nchunk, L], got "
                         f"{tuple(means.shape)}")
    nchunk, lanes = means.shape
    dev = means.device
    _check_cuda("means", means, dev, (nchunk, lanes))
    _check_cuda("dc", dc, dev, (1, lanes))
    if means.numel() >= 2 ** 31:
        raise ValueError(f"{tuple(means.shape)} means are too many for one "
                         f"launch")
    m = means.clone()
    dc_out = torch.empty(1, lanes, dtype=torch.float32, device=dev)
    a32, b32 = chunk_ewma(a)
    lib = _lib()
    err = lib.front_dc_scan_forward(
        _device_index(dev), m.data_ptr(), nchunk, lanes, dc.data_ptr(),
        dc_out.data_ptr(), a32, b32, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"front_dc_scan launch failed: CUDA error {err} "
                           f"({lib.front_error_string(err).decode()})")
    dc_scan.launches += 1
    return m, dc_out


def fir_tma(c: int, dtype: torch.dtype) -> bool:
    """Whether front_fir stages a [T, 2C] plane of this dtype by tensor-map
    boxes: a box starts on a 16-byte boundary, so C lanes must fill whole
    16 bytes (float32: C % 4 == 0; int16: C % 8 == 0; the row pitch is then
    a multiple of 16 bytes too); otherwise it stages element by element."""
    return (c * (2 if dtype == torch.int16 else 4)) % 16 == 0


@dataclasses.dataclass(frozen=True, eq=False)
class FrontPlan:
    """Static geometry of one front end: the composed response and its
    Toeplitz block, on the device the front runs on."""
    factor: int
    d_rows: int            # carried history rows (D rounded up to 8)
    dc_alpha: float
    h: torch.Tensor        # [D+1] float32 composed response (kernel)
    w: torch.Tensor        # [d_rows + SUB_BLOCK, SUB_BLOCK/F] (plain version)
    smem_bytes: int        # front_fir's shared memory (float32, no blanker);
                           # 0 = no kernel covers the response

    @staticmethod
    def make(h_np: np.ndarray, factor: int, device,
             dc_alpha: float = 0.9999) -> "FrontPlan":
        d = len(h_np) - 1
        d_rows = ((d + 7) // 8) * 8
        w = decimator.build_composed_w(h_np, factor, SUB_BLOCK, d_rows - d)
        lay = fir_march_layout(len(h_np), factor)
        return FrontPlan(
            factor=int(factor), d_rows=d_rows, dc_alpha=float(dc_alpha),
            h=torch.as_tensor(np.asarray(h_np, np.float32), device=device),
            w=torch.from_numpy(w).to(device),
            smem_bytes=lay["smem"] if lay else 0)

    @property
    def ewma(self) -> tuple[float, float]:
        """(a, 1 - a) of the per-chunk EWMA, rounded to float32 as the TPU
        kernel's weakly-typed constants are."""
        return chunk_ewma(float(self.dc_alpha) ** DC_CHUNK)


def chunk_ewma(a: float) -> tuple[float, float]:
    """(a, 1 - a) rounded to float32, 1 - a taken in float64 first."""
    return float(np.float32(a)), float(np.float32(1.0 - a))


def _check_geometry(plan: FrontPlan, x: torch.Tensor, n_block: int,
                    raw_rows: int, disc_gain: float = 0.0,
                    disc_last: torch.Tensor | None = None,
                    y_tail_rows: int = 0, iq_gain=None, iq_phase=None,
                    nb: tuple | None = None,
                    nb_avg: torch.Tensor | None = None,
                    nb_tail: torch.Tensor | None = None, comp_taps=None,
                    comp_hist: torch.Tensor | None = None
                    ) -> tuple[int, int, int]:
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"front input must be a [T, 2C] plane, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"front input must be float32 or int16, got "
                         f"{x.dtype}")
    t = x.shape[0]
    n_block = n_block or t
    if n_block % SUB_BLOCK or t % n_block:
        raise ValueError(f"front needs n_block % {SUB_BLOCK} == 0 and "
                         f"T % n_block == 0 (T={t}, n_block={n_block})")
    if n_block % plan.factor:
        raise ValueError(f"n_block={n_block} not divisible by the decimation "
                         f"factor {plan.factor}")
    if disc_gain and (disc_last is None
                      or tuple(disc_last.shape) != (1, x.shape[1])):
        raise ValueError(f"the discriminator needs disc_last [1, "
                         f"{x.shape[1]}]")
    if y_tail_rows and not (disc_gain
                            and 0 < y_tail_rows <= n_block // plan.factor):
        raise ValueError(f"y_tail_rows={y_tail_rows} needs disc_gain and at "
                         f"most {n_block // plan.factor} rows (the WFM path)")
    if (iq_gain is None) != (iq_phase is None):
        raise ValueError("IQ balance needs both iq_gain and iq_phase")
    if nb is not None:
        _, bw, _, mode = nb
        if mode not in NB_MODES or not 1 <= int(bw) <= NB_TAIL_ROWS:
            raise ValueError(f"noise blanker needs mode in {NB_MODES} and "
                             f"1 <= blank_width <= {NB_TAIL_ROWS}, got {nb}")
        c2 = x.shape[1]
        if (nb_avg is None or nb_tail is None
                or tuple(nb_avg.shape) != (1, c2)
                or tuple(nb_tail.shape) != (NB_TAIL_ROWS, c2)):
            raise ValueError(f"the noise blanker needs nb_avg [1, {c2}] and "
                             f"nb_tail [{NB_TAIL_ROWS}, {c2}]")
    if comp_taps is not None:
        tc = len(comp_taps)
        hr = comp_hist_rows(tc)
        m, mb = t // plan.factor, n_block // plan.factor
        if not disc_gain:
            raise ValueError("the composite decimation (comp_taps) needs the "
                             "discriminator (disc_gain)")
        if not 2 <= tc <= _MAX_COMP_TAPS:
            raise ValueError(f"comp_taps needs 2..{_MAX_COMP_TAPS} taps, got "
                             f"{tc}")
        if comp_hist is None or tuple(comp_hist.shape) != (hr, x.shape[1] // 2):
            raise ValueError(f"the composite decimation needs comp_hist "
                             f"[{hr}, {x.shape[1] // 2}]")
        if mb % COMP_DECIM or m < hr:
            raise ValueError(f"the composite decimation needs an even number "
                             f"of decimated rows per block and at least {hr} "
                             f"per dispatch (block {mb}, dispatch {m})")
    r = min(raw_rows, SUB_BLOCK) or 8
    return t, n_block, r


def discriminate(y: torch.Tensor, last: torch.Tensor, gain: float):
    """FM discriminator of a packed composite y [M, 2C] with the carried
    previous sample last [1, 2C]: (disc [M, C] = atan2(y conj(prev)) * gain,
    last' [1, 2C])."""
    c = y.shape[1] // 2
    prev = torch.cat([last, y[:-1]], dim=0)
    yr, yi, pr, pi = y[:, :c], y[:, c:], prev[:, :c], prev[:, c:]
    disc = torch.atan2(yi * pr - yr * pi, yr * pr + yi * pi) * gain
    return disc, y[y.shape[0] - 1:].clone()


def dequantize(x: torch.Tensor) -> torch.Tensor:
    """An int16 entry plane as float32 (full scale 32768 -> 1.0, exact);
    a float32 plane as it is."""
    return x.float() * I16_SCALE if x.dtype == torch.int16 else x


def chunk_means_reference(x: torch.Tensor, n_block: int = 0,
                          raw_rows: int = 0):
    """Plain version of front_means: (means [T/512, L], the mean of each
    512-row chunk of every lane; raw [T/n_block, raw_rows, L], the last
    raw_rows rows of each n_block-row block) of a [T, L] float32 or int16
    plane (int16 dequantized, x 2^-15).  n_block 0 = the whole plane."""
    t, n_block = _means_geometry(x, n_block, raw_rows)
    x = dequantize(x)
    lanes = x.shape[1]
    means = x.reshape(t // DC_CHUNK, DC_CHUNK, lanes).mean(dim=1)
    raw = x.reshape(t // n_block, n_block, lanes)[:, n_block - raw_rows:]
    return means, raw.contiguous()


def _means_geometry(x: torch.Tensor, n_block: int,
                    raw_rows: int) -> tuple[int, int]:
    """(T, n_block) of a chunk-means call: whole 512-row chunks and whole
    n_block-row blocks, 0 <= raw_rows <= n_block (n_block 0 = T)."""
    if x.dim() != 2:
        raise ValueError(f"chunk means take a [T, L] plane, got "
                         f"{tuple(x.shape)}")
    t = x.shape[0]
    n_block = n_block or t
    if t % DC_CHUNK or n_block % DC_CHUNK or t % n_block:
        raise ValueError(f"chunk means need T and n_block multiples of "
                         f"{DC_CHUNK}, n_block dividing T (T={t}, "
                         f"n_block={n_block})")
    if not 0 <= raw_rows <= n_block:
        raise ValueError(f"raw_rows={raw_rows} must lie in [0, {n_block}]")
    return t, n_block


def chunk_means(x: torch.Tensor, n_block: int = 0, raw_rows: int = 0):
    """front_means (csrc/front.cu) for a CUDA plane, the plain version for
    a CPU plane.  Same arguments and results as chunk_means_reference; a
    CUDA plane must be contiguous and 16-byte aligned."""
    if x.device.type == "cpu":
        return chunk_means_reference(x, n_block, raw_rows)
    if x.device.type != "cuda":
        raise ValueError(f"chunk_means runs on cuda or cpu, not {x.device}")
    return _launch_means(x, n_block, raw_rows)


def _launch_means(x: torch.Tensor, n_block: int, raw_rows: int):
    """Check the plane, allocate the outputs and launch front_means on x's
    device and current stream."""
    t, n_block = _means_geometry(x, n_block, raw_rows)
    lanes = x.shape[1]
    dev = x.device
    _check_cuda("x", x, dev, (t, lanes), (torch.float32, torch.int16))
    _check_plane(x)
    means = torch.empty(t // DC_CHUNK, lanes, dtype=torch.float32, device=dev)
    raw = torch.empty(t // n_block, raw_rows, lanes, dtype=torch.float32,
                      device=dev)
    lib = _lib()
    err = lib.front_means_forward(
        _device_index(dev), x.data_ptr(), int(x.dtype == torch.int16), t,
        lanes, n_block, raw_rows, means.data_ptr(),
        raw.data_ptr() if raw_rows else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"front_means launch failed: CUDA error {err} "
                           f"({lib.front_error_string(err).decode()})")
    chunk_means.launches += 1
    return means, raw


def _check_plane(x: torch.Tensor) -> None:
    """What front_means takes of a [T, L] CUDA plane besides its shape and
    type: 16-byte alignment, fewer than 2^31 elements, and two of its
    stages in one block's shared memory."""
    if x.data_ptr() % PLANE_ALIGN:
        raise ValueError(f"a CUDA plane must be {PLANE_ALIGN}-byte aligned "
                         f"(bulk copies); copy the view first")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"a {tuple(x.shape)} plane is too large for one "
                         f"kernel launch")
    lanes = x.shape[1]
    if not _means_smem_bytes(lanes, x.dtype == torch.int16):
        raise ValueError(f"front_means takes no plane of {lanes} {x.dtype} "
                         f"lanes (two of its stages exceed shared memory)")


@functools.lru_cache(maxsize=64)
def _means_smem_bytes(lanes: int, int16: bool) -> int:
    """front_means' shared memory for planes of `lanes` lanes, asked once
    per width (0: the kernel takes no such plane)."""
    return _lib().front_means_smem_bytes(lanes, int(int16))


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def dc_iq_reference(plan: FrontPlan, x: torch.Tensor, dc: torch.Tensor,
                    iq_gain=None, iq_phase=None,
                    means: torch.Tensor | None = None):
    """The front's input stage, plain PyTorch: (m [T/512, 2C] DC estimates,
    z [T, 2C] DC-removed and IQ-balanced plane) of a float32 plane x; means
    are x's chunk means when the caller has them."""
    t, c2 = x.shape
    nchunk = t // DC_CHUNK
    if means is None:
        means = chunk_means_reference(x)[0]
    m = _ewma(means, dc, float(plan.dc_alpha) ** DC_CHUNK)
    z = (x.reshape(nchunk, DC_CHUNK, c2) - m[:, None, :]).reshape(t, c2)
    if iq_gain is not None:
        c = c2 // 2
        zr, zi = z[:, :c], z[:, c:]
        z = torch.cat([zr * iq_gain, zi + iq_phase * zr], dim=1)
    return m, z


def _ewma(means: torch.Tensor, seed: torch.Tensor, a: float) -> torch.Tensor:
    """m_k = a m_{k-1} + (1-a) mu_k over the chunks, m_{-1} = seed [1, 2C],
    in closed form (float64 lower-triangular weights, one matmul)."""
    lmat, s = _ewma_weights(means.shape[0], a, means.device)
    return (torch.matmul(lmat, means.double())
            + s[:, None] * seed.double()).float()


class NbFlags(NamedTuple):
    """The noise blanker's detection on a [T, 2C] plane (plain version)."""
    mag2: torch.Tensor      # [T, 2C] |z|^2 per lane
    avg: torch.Tensor       # [T, 2C] the average entering each row's chunk
    spike: torch.Tensor     # [T, 2C] bool, undilated
    widened: torch.Tensor   # [T, 2C] bool, after the causal dilation
    avg_out: torch.Tensor   # [1, 2C] nb_avg'
    tail_out: torch.Tensor  # [16, 2C] nb_tail' (0/1 float32)


def nb_flags(z: torch.Tensor, nb: tuple, nb_avg: torch.Tensor,
             nb_tail: torch.Tensor) -> NbFlags:
    """Detection of the noise blanker (module docstring) on the DC-removed,
    IQ-balanced plane z [T, 2C], per lane as the TPU kernel computes it."""
    thr, bw, alpha, _ = nb
    t, c2 = z.shape
    c = c2 // 2
    zsw = torch.cat([z[:, c:], z[:, :c]], dim=1)
    mag2 = z * z + zsw * zsw
    nchunk = t // DC_CHUNK
    avgs = _ewma(mag2.reshape(nchunk, DC_CHUNK, c2).mean(dim=1), nb_avg,
                 (1.0 - alpha) ** DC_CHUNK)                    # [nchunk, 2C]
    avg = torch.cat([nb_avg, avgs[:-1]]).repeat_interleave(DC_CHUNK, dim=0)
    thr2 = float(np.float32(thr * thr))
    spike = mag2 > thr2 * torch.clamp(avg, min=1e-18)
    ext = torch.cat([nb_tail > 0, spike])                    # [16 + T, 2C]
    widened = spike.clone()
    for s in range(1, int(bw)):
        widened |= ext[NB_TAIL_ROWS - s:NB_TAIL_ROWS - s + t]
    return NbFlags(mag2, avg, spike, widened, avgs[-1:],
                   spike[t - NB_TAIL_ROWS:].float())


def fused_front_reference(plan: FrontPlan, x: torch.Tensor, dc: torch.Tensor,
                          phase0: torch.Tensor, f_hi: torch.Tensor,
                          f_lo: torch.Tensor, tail: torch.Tensor,
                          n_block: int = 0, raw_rows: int = 0,
                          disc_gain: float = 0.0,
                          disc_last: torch.Tensor | None = None,
                          y_tail_rows: int = 0, iq_gain=None, iq_phase=None,
                          nb: tuple | None = None,
                          nb_avg: torch.Tensor | None = None,
                          nb_tail: torch.Tensor | None = None,
                          nb_mask: torch.Tensor | None = None,
                          comp_taps: np.ndarray | None = None,
                          comp_hist: torch.Tensor | None = None):
    """Plain PyTorch version of the fused front end (see module docstring).

    x [T, 2C] f32 or int16; dc [1, 2C]; phase0/f_hi/f_lo [C]; tail
    [d_rows, 2C]; iq_gain/iq_phase scalar tensors; nb_avg [1, 2C] and
    nb_tail [16, 2C]; comp_hist [hr, C].  Returns (y [T/F, 2C], dc' [1,
    2C], tail' [d_rows, 2C], phase' [C], raw [T/n_block, R, 2C]), then with
    nb (nb_avg', nb_tail'), then with disc_gain (disc [T/F, C], disc_last'
    [1, 2C]), then with comp_taps comp_hist' [hr, C] (disc is then
    [T/(2F), C]); y is [T/n_block, y_tail_rows, 2C] when y_tail_rows > 0.
    With the blanker, a given nb_mask [T, 2C] uint8 receives the dilated
    flags (for checking a kernel's blanked positions)."""
    t, n_block, r = _check_geometry(plan, x, n_block, raw_rows, disc_gain,
                                    disc_last, y_tail_rows, iq_gain, iq_phase,
                                    nb, nb_avg, nb_tail, comp_taps, comp_hist)
    x = dequantize(x)
    means, raw = chunk_means_reference(x, n_block, r)
    m, z = dc_iq_reference(plan, x, dc, iq_gain, iq_phase, means)
    u = mix_reference(z, phase0, f_hi, f_lo)
    nb_out = ()
    if nb is not None:
        fl = nb_flags(z, nb, nb_avg, nb_tail)
        if nb[3] == "blank":
            u = torch.where(fl.widened, 0.0, u)
        else:
            scale = torch.sqrt(fl.avg / torch.clamp(fl.mag2, min=1e-24))
            u = torch.where(fl.widened, u * scale, u)
        nb_out = (fl.avg_out, fl.tail_out)
        if nb_mask is not None:
            nb_mask.copy_(fl.widened)

    y, ext = fir_reference(plan, u, tail)
    ret = (y, m[-1:], ext[ext.shape[0] - plan.d_rows:].contiguous(),
           advance_phase(phase0, t, f_hi, f_lo), raw) + nb_out
    if not disc_gain:
        return ret
    disc, dlast = discriminate(y, disc_last, disc_gain)
    if y_tail_rows:   # each block's trailing y_tail_rows rows
        mb = n_block // plan.factor
        ret = (y.reshape(t // n_block, mb, y.shape[1])[:, mb - y_tail_rows:]
               .contiguous(),) + ret[1:]
    if comp_taps is None:
        return ret + (disc, dlast)
    hr, tc = comp_hist.shape[0], len(comp_taps)
    hist_out = torch.cat([comp_hist, disc])[-hr:].contiguous()
    disc, _ = fir.tm_fir_decimate(disc, comp_taps, comp_hist[hr - (tc - 1):],
                                  COMP_DECIM)
    return ret + (disc, dlast, hist_out)


def mix_reference(z: torch.Tensor, phase0: torch.Tensor, f_hi: torch.Tensor,
                  f_lo: torch.Tensor) -> torch.Tensor:
    """The NCO mix of a packed plane z [T, 2C]: u = z exp(-j 2 pi phi(t)),
    the phasor as coarse (per 128 rows) x fine (row within them)."""
    c = z.shape[1] // 2
    cos_a, sin_a = oscillator(phase0, f_hi, f_lo, z.shape[0])  # [T, C] each
    zr, zi = z[:, :c], z[:, c:]
    return torch.cat([zr * cos_a + zi * sin_a, zi * cos_a - zr * sin_a],
                     dim=1)


def fir_reference(plan: FrontPlan, u: torch.Tensor, tail: torch.Tensor):
    """The composed decimating FIR of a mixed plane u [T, 2C] with the
    carried post-mix tail [d_rows, 2C]: (y [T/F, 2C], the tail-extended
    plane [d_rows + T, 2C]); each SUB_BLOCK of outputs is W^T against its
    tail-extended window."""
    t, c2 = u.shape
    ext = torch.cat([tail, u], dim=0)
    wins = ext.unfold(0, plan.d_rows + SUB_BLOCK, SUB_BLOCK)     # [nsub, 2C, L]
    y = torch.matmul(wins, plan.w).transpose(1, 2).reshape(t // plan.factor, c2)
    return y, ext


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
                 f_lo: torch.Tensor, t: int, sub: int = SUB_BLOCK):
    """Oscillator phases (cycles) of rows 0..t-1 in the TPU kernel's split
    form t = sub s + 128 q + r (sub = 2048 unless given): coarse
    [ceil(t/sub), sub/128, C] per (s, q) and fine [128, C] per r."""
    dev = phase0.device
    nsub = -(-t // sub)
    k0 = (torch.arange(nsub, device=dev) * sub).float()[:, None]
    ph0 = torch.remainder(phase0 + torch.remainder(k0 * f_hi, 1.0)
                          + k0 * f_lo, 1.0)                        # [nsub, C]
    qq = (torch.arange(sub // _Q, device=dev) * _Q).float()[:, None]
    coarse = torch.remainder(ph0[:, None, :] + torch.remainder(qq * f_hi, 1.0)
                             + qq * f_lo, 1.0)                # [nsub, sub/128, C]
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


def fold_plane_np(plane: np.ndarray, fold: int) -> np.ndarray:
    """[N, 2C] plane -> [N/fold, 2*fold*C] time-folded plane (numpy, the
    layout TPU feeders ship): lanes [re(g0) .. re(gG-1) | im(g0) ..
    im(gG-1)], lane group g holding the contiguous time segment g."""
    n, c2 = plane.shape
    c = c2 // 2
    xg = plane.reshape(fold, n // fold, c2)
    return np.concatenate([xg[g, :, :c] for g in range(fold)]
                          + [xg[g, :, c:] for g in range(fold)], axis=1)


def unfold_plane(x_f: torch.Tensor, fold: int) -> torch.Tensor:
    """Inverse of fold_plane_np on the tensor's device, one copy:
    [N/fold, 2*fold*C] -> [N, 2C]."""
    seg, lanes = x_f.shape
    c = lanes // (2 * fold)
    return (x_f.reshape(seg, 2, fold, c).permute(2, 0, 1, 3)
            .reshape(fold * seg, 2 * c))


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/front.cu, built at first use, with its C signatures declared."""
    return declare(build.load("front"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A library built from csrc/front.cu with its C signatures declared
    (also for the variants tools/ring_sweep.py builds)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.front_forward.restype = ctypes.c_int
    lib.front_forward.argtypes = [
        i, p, i, i, i, i, i,            # device, x, x_int16, T, C, n, r_rows
        p, p, i, p, p, p, p, i, i,      # dc_in .. h, ntaps, F
        f, f, p, p, p, p, p,            # a, b, mseq, y, dc_out, tail_out, raw
        p, p,                           # iq_gain, iq_phase
        i, f, i, f, f, p, p, p, p, p, p,  # nb_mode .. nb_mask
        f, p, i, p, p, p,               # disc_gain .. ytail
        p, i, p, i, p, i, p]            # comp_taps .. comp_hist_out, fir_tma,
                                        # stream
    lib.front_error_string.restype = ctypes.c_char_p
    lib.front_error_string.argtypes = [i]
    lib.front_fir_smem_bytes.restype = ctypes.c_size_t
    lib.front_fir_smem_bytes.argtypes = [i, i, i, i]
    lib.front_fir_plan.restype = ctypes.c_int
    lib.front_fir_plan.argtypes = [i, i, i, i, i, i, i, p]
    lib.front_means_smem_bytes.restype = ctypes.c_size_t
    lib.front_means_smem_bytes.argtypes = [i, i]
    lib.front_means_forward.restype = ctypes.c_int
    lib.front_means_forward.argtypes = [i, p, i, i, i, i, i, p, p, p]
    lib.front_comp_smem_bytes.restype = ctypes.c_size_t
    lib.front_comp_smem_bytes.argtypes = []
    lib.front_comp_plan.restype = ctypes.c_int
    lib.front_comp_plan.argtypes = [i, i, i, p]
    lib.front_dc_scan_plan.restype = ctypes.c_int
    lib.front_dc_scan_plan.argtypes = [i, i, p]
    lib.front_dc_scan_forward.restype = ctypes.c_int
    lib.front_dc_scan_forward.argtypes = [i, p, i, i, p, p, f, f, p]
    return lib


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, shape,
                dtypes=(torch.float32,)):
    if t.device != device or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous "
                         f"{'/'.join(str(d) for d in dtypes)} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def fused_front(plan: FrontPlan, x: torch.Tensor, dc: torch.Tensor,
                phase0: torch.Tensor, f_hi: torch.Tensor, f_lo: torch.Tensor,
                tail: torch.Tensor, n_block: int = 0, raw_rows: int = 0,
                disc_gain: float = 0.0, disc_last: torch.Tensor | None = None,
                y_tail_rows: int = 0, iq_gain=None, iq_phase=None,
                nb: tuple | None = None, nb_avg: torch.Tensor | None = None,
                nb_tail: torch.Tensor | None = None,
                nb_mask: torch.Tensor | None = None,
                comp_taps: np.ndarray | None = None,
                comp_hist: torch.Tensor | None = None):
    """The fused front end: the CUDA kernel for a CUDA plane, the plain
    version for a CPU plane.  Same arguments and results as
    fused_front_reference."""
    if x.device.type == "cpu":
        return fused_front_reference(plan, x, dc, phase0, f_hi, f_lo, tail,
                                     n_block, raw_rows, disc_gain, disc_last,
                                     y_tail_rows, iq_gain, iq_phase, nb,
                                     nb_avg, nb_tail, nb_mask, comp_taps,
                                     comp_hist)
    if x.device.type != "cuda":
        raise ValueError(f"fused_front runs on cuda or cpu, not {x.device}")
    ret = _launch(plan, x, dc, phase0, f_hi, f_lo, tail, n_block, raw_rows,
                  disc_gain, disc_last, y_tail_rows, iq_gain, iq_phase, nb,
                  nb_avg, nb_tail, nb_mask, comp_taps, comp_hist)
    fused_front.launches += 1
    if not fir_tma(x.shape[1] // 2, x.dtype):
        fused_front.element_launches += 1
    chunk_means.launches += 1      # K1's first pass is front_means
    dc_scan.launches += 1 if nb is None else 2   # the DC (and blanker) EWMA
    if comp_taps is not None:
        fused_front.comp_launches += 1
    return ret


def _launch(plan: FrontPlan, x: torch.Tensor, dc: torch.Tensor,
            phase0: torch.Tensor, f_hi: torch.Tensor, f_lo: torch.Tensor,
            tail: torch.Tensor, n_block: int, raw_rows: int, disc_gain: float,
            disc_last, y_tail_rows: int, iq_gain, iq_phase, nb, nb_avg,
            nb_tail, nb_mask=None, comp_taps=None, comp_hist=None):
    """Check the arguments, allocate the outputs and launch csrc/front.cu
    on x's device and current stream."""
    t, n_block, r = _check_geometry(plan, x, n_block, raw_rows, disc_gain,
                                    disc_last, y_tail_rows, iq_gain, iq_phase,
                                    nb, nb_avg, nb_tail, comp_taps, comp_hist)
    c2 = x.shape[1]
    c = c2 // 2
    dev = x.device
    _check_cuda("x", x, dev, (t, c2), (torch.float32, torch.int16))
    _check_plane(x)
    _check_cuda("dc", dc, dev, (1, c2))
    _check_cuda("tail", tail, dev, (plan.d_rows, c2))
    for name, v in (("phase0", phase0), ("f_hi", f_hi), ("f_lo", f_lo)):
        _check_cuda(name, v, dev, (c,))
    _check_cuda("h", plan.h, dev, plan.h.shape)
    if disc_gain:
        _check_cuda("disc_last", disc_last, dev, (1, c2))
    if iq_gain is not None:
        _check_cuda("iq_gain", iq_gain, dev, ())
        _check_cuda("iq_phase", iq_phase, dev, ())
    if nb is not None:
        _check_cuda("nb_avg", nb_avg, dev, (1, c2))
        _check_cuda("nb_tail", nb_tail, dev, (NB_TAIL_ROWS, c2))
        if nb_mask is not None:
            _check_cuda("nb_mask", nb_mask, dev, (t, c2), (torch.uint8,))
    ct = hr = None
    if comp_taps is not None:
        ct = _comp_taps_dev(np.ascontiguousarray(comp_taps, np.float32)
                            .tobytes(), dev)
        hr = comp_hist.shape[0]
        _check_cuda("comp_hist", comp_hist, dev, (hr, c))
    if t * c2 >= 2 ** 31:
        raise ValueError(f"front dispatch of {t} x {c2} is too large for one "
                         f"kernel launch")
    lib = _lib()
    i16 = x.dtype == torch.int16
    if not lib.front_fir_smem_bytes(plan.h.numel(), plan.factor,
                                    int(nb is not None), int(i16)):
        raise ValueError(f"no front_fir instantiation takes a composed "
                         f"response of {plan.h.numel()} taps at factor "
                         f"{plan.factor}")
    tma = fir_tma(c, x.dtype)
    a, b = plan.ewma

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    m = t // plan.factor
    y = empty(m, c2)
    dc_out, tail_out = empty(1, c2), empty(plan.d_rows, c2)
    raw, mseq = empty(t // n_block, r, c2), empty(t // DC_CHUNK, c2)
    disc = dlast = ytail = hist_out = None
    if disc_gain:
        disc, dlast = empty(m // (COMP_DECIM if ct is not None else 1),
                            c), empty(1, c2)
        if y_tail_rows:
            ytail = empty(t // n_block, y_tail_rows, c2)
        if ct is not None:
            hist_out = empty(hr, c)
    nb_mode, thr2, bw, nb_a, nb_b = 0, 0.0, 0, 0.0, 0.0
    nbseq = nb_avg_out = nb_tail_out = None
    if nb is not None:
        thr, bw, alpha, mode = nb
        nb_mode = 1 + NB_MODES.index(mode)
        thr2 = float(np.float32(thr * thr))
        nb_a, nb_b = chunk_ewma((1.0 - alpha) ** DC_CHUNK)
        nbseq = empty(t // DC_CHUNK, c2)
        nb_avg_out, nb_tail_out = empty(1, c2), empty(NB_TAIL_ROWS, c2)

    def ptr(v):
        return None if v is None else v.data_ptr()

    err = lib.front_forward(
        _device_index(dev), x.data_ptr(), int(x.dtype == torch.int16), t, c,
        n_block, r, dc.data_ptr(), tail.data_ptr(), plan.d_rows,
        phase0.data_ptr(), f_hi.data_ptr(), f_lo.data_ptr(), plan.h.data_ptr(),
        plan.h.numel(), plan.factor, a, b, mseq.data_ptr(), y.data_ptr(),
        dc_out.data_ptr(), tail_out.data_ptr(), raw.data_ptr(), ptr(iq_gain), ptr(iq_phase),
        nb_mode, thr2, int(bw), nb_a, nb_b, ptr(nb_avg), ptr(nb_tail),
        ptr(nbseq), ptr(nb_avg_out), ptr(nb_tail_out), ptr(nb_mask),
        float(disc_gain), ptr(disc_last), int(y_tail_rows),
        ptr(disc), ptr(dlast), ptr(ytail), ptr(ct),
        0 if ct is None else ct.numel(), ptr(comp_hist), hr or 0,
        ptr(hist_out), int(tma), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"front kernel launch failed: CUDA error {err} "
                           f"({lib.front_error_string(err).decode()})")
    ret = (y if ytail is None else ytail, dc_out, tail_out,
           advance_phase(phase0, t, f_hi, f_lo), raw)
    if nb is not None:
        ret += (nb_avg_out, nb_tail_out)
    if not disc_gain:
        return ret
    return ret + ((disc, dlast) if ct is None else (disc, dlast, hist_out))


@functools.lru_cache(maxsize=8)
def _comp_taps_dev(taps_bytes: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(taps_bytes, np.float32).copy()
                            ).to(device)


# wrapper calls that launched K1 (3-5 CUDA kernels each, module docstring;
# the plain path never counts)
fused_front.launches = 0
# of those, the launches whose front_fir staged the plane element by element
# (its row pitch breaks the tensor map's 16-byte rule, fir_tma); the rest
# staged it by tensor-map boxes
fused_front.element_launches = 0
# of those, the hq form's (comp_taps): each launches front_comp, the only
# pass that reads y there (no front_disc)
fused_front.comp_launches = 0
# front_means launches: chunk_means', and those inside K1 (fused_front, one
# per call) and the probes (kprobe.probe_front, one per plane)
chunk_means.launches = 0
# front_dc_scan launches: dc_scan's, and those inside K1 (one per call, two
# with the blanker) and the probes (one per plane)
dc_scan.launches = 0
