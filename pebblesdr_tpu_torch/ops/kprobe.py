"""K1 probes: the copy floors and the Toeplitz-product front variants v1-v5.

Port of the kernel bodies of the JAX package's K1 probe bench
(tools/kbench2.py); the port's bench is pebblesdr_tpu_torch/tools/kbench2.py.

  * Copy floors (floor_kernel / floor_call, tools/kbench2.py:82-99, on two
    planes [T, C]; main2's fk, :307-321, on one packed plane [T, 2C]): per
    sub-block of each plane, y = its first sub/F rows, read in full.
  * Front variants: K1's base form (ops/front.py: chunked-EWMA DC over 512
    rows, NCO in the split form t = sub s + 128 q + r with coarse phasors
    per 128 rows and a fine table built on the host in float64, then the
    composed FIR) with the FIR as the product of the composed Toeplitz block
    with the extended mixed input, y = W^T [tail; u] per sub-block, W =
    decimator.build_composed_w at the variant's sub.  Each keeps its
    carried-state layout:

    | variant | TPU kernel | x | dc | tail | phase | y |
    |---|---|---|---|---|---|---|
    | v1, v2 | make_v12 (:137-265) | [2, T, C] (re, im planes) | [2, C] | [2 d_rows, C] (re rows, then im rows) | [C] | [2, T/F, C] |
    | v3 | make_v3 (:380-487) | [T, 2C] | [1, 2C] | [d_rows, 2C] | [C] | [T/F, 2C] |
    | v4, v5 | main4's make (:539-667) | [T, 2C] | [1, 2C] | [d_rows, 2C] | [2C] | [T/F, 2C] |

    v1 runs two products (re, im), v2 one over [er | ei]; v3 mixes per
    channel, v4 with the packed tables A = [or | or], B = [oi | -oi] (y = z
    A + swap(z) B); v5 is v4 with the output rows in kt groups, each
    multiplied over only its span of d_rows + (sub/F/kt) F rows (rounded up
    to 8).  All compute the same function as K1's base form.

``probe_floor`` and ``probe_front`` launch the CUDA kernels
(csrc/front.cu: probe_floor_copy; front_means + front_dc_scan, then one
probe_toeplitz launch that also writes tail') for CUDA tensors and run the
plain versions for CPU tensors.  Their CUDA planes are 16-byte aligned, and
the floor's lane count and the front variants' channel count are multiples
of 4 (the kernels move bulk copies and tensor-map boxes).  The JAX tool's
products give no precision (one bf16 pass on a TPU; the package's K1 runs
_dot3, three bf16 passes).  The port's plain versions are IEEE float32;
probe_toeplitz runs the product on the tensor cores as 3xTF32: W split on
the host into TF32 hi + lo (``composed_wt_split``, ``tf32_round``: the
rounding of cvt.rna.tf32.f32), the mixed input split as it is staged, Y =
Wh Eh + Wh El + Wl Eh accumulated in float32 (one TF32 pass keeps about
three digits and misses the 3e-5 bound).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import decimator, front
from pebblesdr_tpu_torch.ops.mixer import TWO_PI, advance_phase
from pebblesdr_tpu_torch.utils import roofline

VARIANTS = ("v1", "v2", "v3", "v4", "v5")
TWO_PLANE = ("v1", "v2")
_FORM = {"v1": 1, "v2": 2, "v3": 3, "v4": 4, "v5": 4}
FORMS = (("v1", 1), ("v2", 1), ("v3", 1), ("v4", 1), ("v5", 2), ("v5", 4))
TILE_OUTPUTS = 64      # outputs per probe_toeplitz block (kPm, wgmma's M)
WARP_OUTPUTS = 16      # outputs of a v5 warp's mma.sync tiles
CHUNK_ROWS = 32        # extended rows per probe_toeplitz chunk (kPkc)
MAX_SUB = 8192         # with d_rows < 1024 the v4 coarse table fits a block
SOURCE = front.SOURCE
REPLACES = {            # the TPU kernel each form replaces
    "floor": "tools/kbench2.py:82",
    "floor128": "tools/kbench2.py:307",
    "v1": "tools/kbench2.py:144",
    "v2": "tools/kbench2.py:144",
    "v3": "tools/kbench2.py:386",
    "v4": "tools/kbench2.py:546",
    "v5": "tools/kbench2.py:590",
}


def check_geometry(t: int, sub: int, factor: int,
                   kt: int | None = None) -> None:
    """The probes' shape rules: sub-blocks of whole 512-row DC chunks that
    tile the dispatch and whole decimated rows per sub-block; for the front
    variants (kt given) output rows per sub-block a multiple of the
    kernel's 64-output tile, and per group a multiple of 16 (a v5 warp's
    16 outputs lie in one group)."""
    if sub <= 0 or sub % front.DC_CHUNK or t % sub:
        raise ValueError(f"sub={sub} must be a multiple of {front.DC_CHUNK} "
                         f"that divides T={t}")
    if sub % factor:
        raise ValueError(f"the decimation factor {factor} must divide "
                         f"sub={sub}")
    m = sub // factor
    if kt is not None and (kt < 1 or m % TILE_OUTPUTS
                           or m % (WARP_OUTPUTS * kt)):
        raise ValueError(f"sub/F={m} outputs per sub-block must be a "
                         f"multiple of {TILE_OUTPUTS} and of "
                         f"{WARP_OUTPUTS} kt (kt={kt})")
    if kt is not None and sub > MAX_SUB:
        raise ValueError(f"the front probes take sub <= {MAX_SUB}")


def probe_bound(variant: str, sub: int, kt: int, c: int, t: int,
                factor: int, d_rows: int = 0, taps: int = 0) -> dict:
    """Bytes and float32 operations of one call over t rows of c channels,
    and the least time the card could take for them (roofline.bound).
    Floors ("floor", "floor128"): the planes read once and 1/F of them
    written.  Front variants: the plane, W, the fine tables and the state
    read once, y and the state written once; the operations are those of
    the function, K1's base form (roofline.k1_ops: the FIR's 2 taps per
    output lane, the DC and the mix), not the product's.  product_flops
    counts the product as the variant runs it, 2 span per output lane
    (span = d_rows + sub dense, d_rows + (sub/F/kt) F rounded up to 8 for
    v5), most of it on the zeros of W; probe_toeplitz issues it three
    times on the tensor cores (3xTF32)."""
    c2, m = 2 * c, t // factor
    nbytes = (t + m) * c2 * 4
    ops = product = 0
    if variant not in ("floor", "floor128"):
        if variant not in VARIANTS:
            raise ValueError(f"unknown probe {variant!r}")
        ms = sub // factor
        span = (d_rows + sub if kt == 1
                else -(-(d_rows + (ms // kt) * factor) // 8) * 8)
        product = 2 * m * span * c2
        ops = roofline.k1_ops(taps, t, c, factor)
        tables = 4 if variant in ("v4", "v5") else 1
        nbytes += (ms * (d_rows + sub) + 2 * 128 * tables * c
                   + 2 * (1 + d_rows) * c2 + 3 * c2) * 4
    return {"bytes": nbytes, "flops": ops, "product_flops": product,
            **roofline.bound(nbytes, ops)}


def to_layout(variant: str, x: torch.Tensor, dc: torch.Tensor,
              tail: torch.Tensor, phase: torch.Tensor) -> tuple:
    """K1's packed layout (x [T, 2C], dc [1, 2C], tail [d_rows, 2C], phase
    [C]) in a variant's (module docstring).  x may be y [T/F, 2C]."""
    c = x.shape[-1] // 2
    if variant in TWO_PLANE:
        return (torch.stack([x[:, :c], x[:, c:]]).contiguous(),
                dc.reshape(2, c).contiguous(),
                torch.cat([tail[:, :c], tail[:, c:]]).contiguous(), phase)
    if variant in ("v4", "v5"):
        return x, dc, tail, torch.cat([phase, phase])
    return x, dc, tail, phase


def from_layout(variant: str, x: torch.Tensor, dc: torch.Tensor,
                tail: torch.Tensor, phase: torch.Tensor) -> tuple:
    """A variant's layout back in K1's packed one: the inverse of
    to_layout (v4/v5 keep the first half of their [2C] phase)."""
    if variant in TWO_PLANE:
        c, d = x.shape[-1], tail.shape[0] // 2
        return (torch.cat([x[0], x[1]], 1), dc.reshape(1, 2 * c),
                torch.cat([tail[:d], tail[d:]], 1), phase)
    if variant in ("v4", "v5"):
        return x, dc, tail, phase[:phase.shape[0] // 2]
    return x, dc, tail, phase


# ---------------------------------------------------------------- floors ---

def probe_floor_reference(planes, sub: int, factor: int) -> tuple:
    """Plain version of the copy floor: each [T, L] plane -> its first
    sub/F rows of every sub-block, [T/F, L]."""
    out = []
    for x in planes:
        t, lanes = x.shape
        check_geometry(t, sub, factor)
        out.append(x.reshape(t // sub, sub, lanes)[:, :sub // factor]
                   .reshape(t // factor, lanes))
    return tuple(out)


def probe_floor(planes, sub: int, factor: int) -> tuple:
    """The copy floor over one or two [T, L] float32 planes: the CUDA kernel
    for CUDA planes, the plain version for CPU planes."""
    planes = tuple(planes)
    if not 1 <= len(planes) <= 2:
        raise ValueError(f"probe_floor takes one or two planes, got "
                         f"{len(planes)}")
    dev = planes[0].device
    if dev.type == "cpu":
        return probe_floor_reference(planes, sub, factor)
    if dev.type != "cuda":
        raise ValueError(f"probe_floor runs on cuda or cpu, not {dev}")
    t, lanes = planes[0].shape
    check_geometry(t, sub, factor)
    if lanes % 4:
        raise ValueError(f"probe_floor's kernel takes lanes % 4 == 0 (every "
                         f"row boundary 16-byte aligned), got {lanes}")
    for i, x in enumerate(planes):
        front._check_cuda(f"plane {i}", x, dev, (t, lanes))
        if x.data_ptr() % front.PLANE_ALIGN:
            raise ValueError(f"probe_floor's planes must be "
                             f"{front.PLANE_ALIGN}-byte aligned")
    if t * lanes >= 2 ** 31:
        raise ValueError(f"a {t} x {lanes} plane is too large for one launch")
    ys = tuple(torch.empty(t // factor, lanes, dtype=torch.float32, device=dev)
               for _ in planes)
    err = _lib().probe_floor_forward(
        _index(dev), planes[0].data_ptr(),
        planes[1].data_ptr() if len(planes) == 2 else None, t, lanes, sub,
        sub // factor, ys[0].data_ptr(),
        ys[1].data_ptr() if len(ys) == 2 else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise(err, "probe_floor_copy")
    probe_floor.launches += 1
    return ys


# --------------------------------------------------------- front variants ---

@functools.lru_cache(maxsize=16)
def composed_wt(plan: front.FrontPlan, sub: int) -> torch.Tensor:
    """W^T [sub/F, d_rows + sub] at the variant's sub, on the plan's device
    (tools/kbench2.py:209-210), built once per plan and sub."""
    h = plan.h.cpu().numpy()
    w = decimator.build_composed_w(h, plan.factor, sub,
                                   plan.d_rows - (len(h) - 1))
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(plan.h.device)


def tf32_round(a) -> np.ndarray:
    """float32 values rounded to TF32 as cvt.rna.tf32.f32 rounds them: to
    nearest, ties away from zero, at the 13th mantissa bit from the bottom
    (the result is a float32 whose low 13 mantissa bits are zero)."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(a) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) = (tf32(a), tf32(a - hi)) in float32: the operands of the
    3xTF32 product (hi + lo is a to ~2^-22 of it)."""
    a = np.ascontiguousarray(a, np.float32)
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


@functools.lru_cache(maxsize=16)
def composed_wt_split(plan: front.FrontPlan, sub: int) -> tuple:
    """(wh, wl, kpad): composed_wt split into TF32 hi + lo once per plan
    and sub, on the plan's device, in probe_toeplitz's tile layout
    [(sub/F)/64 tiles][kpad/4][64 outputs][4 rows]: the W^T rows of a
    64-output tile, four extended rows at a time, so that each chunk of 32
    rows is one contiguous 8 KB range (a bulk copy), already in the
    K-major core-matrix layout of the wgmma descriptors.  kpad = K rounded
    up to 32, plus 32 rows of zeros (a chunk may run past K)."""
    wt = composed_wt(plan, sub).cpu().numpy()          # [m, K]
    m, k = wt.shape
    kpad = -(-k // CHUNK_ROWS) * CHUNK_ROWS + CHUNK_ROWS
    out = []
    for half in split_tf32(wt):
        w = np.zeros((m, kpad), np.float32)
        w[:, :k] = half
        w = w.reshape(m // TILE_OUTPUTS, TILE_OUTPUTS, kpad // 4, 4)
        out.append(torch.from_numpy(np.ascontiguousarray(
            w.transpose(0, 2, 1, 3))).to(plan.h.device))
    return out[0], out[1], kpad


def _f64(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return np.ascontiguousarray(np.asarray(v, np.float64))


def tune_tables(variant: str, f_hi, f_lo, device) -> dict:
    """The host tables of a variant from the tuning words f_hi/f_lo [C]
    (host values, cached): fhi/flo as float32 ([2C] for v4/v5) and the fine
    phasors of the row within 128, built in float64 and cast to float32
    (tools/kbench2.py:211-216; v4/v5 the packed [fr|fr], [fi|fi], [fi|-fi],
    [fr|-fr], :606-620), [128, lanes] each."""
    hi, lo = _f64(f_hi), _f64(f_lo)
    return _tune_tables(variant in ("v4", "v5"), hi.tobytes(), lo.tobytes(),
                        torch.device(device))


@functools.lru_cache(maxsize=32)
def _tune_tables(packed: bool, hi_b: bytes, lo_b: bytes,
                 device: torch.device) -> dict:
    hi, lo = np.frombuffer(hi_b), np.frombuffer(lo_b)
    r = np.arange(128, dtype=np.float64)[:, None]
    fine = np.mod(np.mod(r * hi[None, :], 1.0) + r * lo[None, :], 1.0)
    fr, fi = np.cos(TWO_PI * fine), np.sin(TWO_PI * fine)
    if packed:
        tabs = (np.concatenate([fr, fr], 1), np.concatenate([fi, fi], 1),
                np.concatenate([fi, -fi], 1), np.concatenate([fr, -fr], 1))
        hi, lo = np.concatenate([hi, hi]), np.concatenate([lo, lo])
    else:
        tabs = (fr, fi)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return {"fhi": dev(hi), "flo": dev(lo), "fine": tuple(map(dev, tabs))}


def _front_shapes(variant: str, plan: front.FrontPlan, x: torch.Tensor,
                  sub: int, kt: int):
    """(T, C, {name: expected shape}) of a variant's arguments."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown front variant {variant!r} (one of "
                         f"{VARIANTS})")
    if (variant == "v5") != (kt > 1):
        raise ValueError(f"kt={kt}: v5 is the K-tiled form (kt > 1), v1-v4 "
                         f"take kt = 1")
    d = plan.d_rows
    if variant in TWO_PLANE:
        if x.dim() != 3 or x.shape[0] != 2:
            raise ValueError(f"{variant} takes x [2, T, C], got "
                             f"{tuple(x.shape)}")
        t, c = x.shape[1], x.shape[2]
        shapes = {"x": (2, t, c), "dc": (2, c), "tail": (2 * d, c),
                  "phase": (c,)}
    else:
        if x.dim() != 2 or x.shape[1] % 2:
            raise ValueError(f"{variant} takes x [T, 2C], got "
                             f"{tuple(x.shape)}")
        t, c = x.shape[0], x.shape[1] // 2
        shapes = {"x": (t, 2 * c), "dc": (1, 2 * c), "tail": (d, 2 * c),
                  "phase": (2 * c,) if variant in ("v4", "v5") else (c,)}
    check_geometry(t, sub, plan.factor, kt)
    return t, c, shapes


def probe_front_reference(variant: str, plan: front.FrontPlan,
                          x: torch.Tensor, dc: torch.Tensor,
                          phase: torch.Tensor, f_hi, f_lo, tail: torch.Tensor,
                          sub: int, kt: int = 1, product=None) -> tuple:
    """Plain version of a front variant (module docstring): (y, dc', tail',
    phase') in the variant's layouts.  f_hi/f_lo [C] are host values.
    product(e, w) computes the Toeplitz products (e [..., K'] extended rows
    of a span, w [K', outputs]); torch.matmul in IEEE float32 unless given
    (the tests pass an emulation of the kernel's 3xTF32)."""
    mm = torch.matmul if product is None else product
    t, c, shapes = _front_shapes(variant, plan, x, sub, kt)
    for name, v in (("dc", dc), ("tail", tail), ("phase", phase)):
        if tuple(v.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{shapes[name]}")
    d, factor = plan.d_rows, plan.factor
    tabs = tune_tables(variant, f_hi, f_lo, x.device)
    x, dc, tail, _ = from_layout(variant, x, dc, tail, phase)
    m_dc, z = front.dc_iq_reference(plan, x, dc)
    coarse, _ = front.phase_tables(phase, tabs["fhi"], tabs["flo"], t, sub)
    cr = torch.cos(TWO_PI * coarse)[:, :, None, :]
    ci = torch.sin(TWO_PI * coarse)[:, :, None, :]
    if variant in ("v4", "v5"):    # y = z A + swap(z) B, lane by lane
        fr1, fi1, fi2, fr2 = tabs["fine"]
        a = (cr * fr1 - ci * fi1).reshape(-1, 2 * c)[:t]
        b = (cr * fi2 + ci * fr2).reshape(-1, 2 * c)[:t]
        u = z * a + torch.cat([z[:, c:], z[:, :c]], 1) * b
    else:
        fr, fi = tabs["fine"]
        cos_a = (cr * fr - ci * fi).reshape(-1, c)[:t]
        sin_a = (cr * fi + ci * fr).reshape(-1, c)[:t]
        zr, zi = z[:, :c], z[:, c:]
        u = torch.cat([zr * cos_a + zi * sin_a, zi * cos_a - zr * sin_a], 1)
    ext = torch.cat([tail, u])                          # [d + T, 2C]
    wins = ext.unfold(0, d + sub, sub)                  # [nsub, 2C, d + sub]
    w = composed_wt(plan, sub).to(x.device).T           # [d + sub, m]
    if kt == 1:
        y = mm(wins, w)
    else:       # each group of mt outputs over its own span (v5)
        mt = (sub // factor) // kt
        span = -(-(d + mt * factor) // 8) * 8
        y = torch.cat([mm(wins[:, :, g * mt * factor:
                               g * mt * factor + span],
                          w[g * mt * factor:g * mt * factor + span,
                            g * mt:(g + 1) * mt])
                       for g in range(kt)], dim=2)
    y = y.transpose(1, 2).reshape(t // factor, 2 * c)
    tail_out = ext[ext.shape[0] - d:]
    y, dc_out, tail_out, _ = to_layout(variant, y, m_dc[-1:].contiguous(),
                                       tail_out.contiguous(), phase)
    return y, dc_out, tail_out, advance_phase(phase, t, tabs["fhi"],
                                              tabs["flo"])


def probe_front(variant: str, plan: front.FrontPlan, x: torch.Tensor,
                dc: torch.Tensor, phase: torch.Tensor, f_hi, f_lo,
                tail: torch.Tensor, sub: int, kt: int = 1) -> tuple:
    """A front variant: the CUDA kernels for a CUDA input, the plain version
    for a CPU input.  Same arguments and results as probe_front_reference."""
    if x.device.type == "cpu":
        return probe_front_reference(variant, plan, x, dc, phase, f_hi, f_lo,
                                     tail, sub, kt)
    if x.device.type != "cuda":
        raise ValueError(f"probe_front runs on cuda or cpu, not {x.device}")
    t, c, shapes = _front_shapes(variant, plan, x, sub, kt)
    dev = x.device
    for name, v in (("x", x), ("dc", dc), ("tail", tail), ("phase", phase)):
        front._check_cuda(name, v, dev, shapes[name])
    two = variant in TWO_PLANE
    front._check_plane(x[0] if two else x)   # x[1] lies T C floats further
    if c % 4:
        raise ValueError(f"probe_toeplitz takes C % 4 == 0 (its tensor-map "
                         f"boxes start on 16 bytes), got C={c}")
    wh, wl, kpad = composed_wt_split(plan, sub)
    front._check_cuda("wh", wh, dev, wh.shape)
    tabs = tune_tables(variant, f_hi, f_lo, dev)
    if tabs["fhi"].shape[0] != shapes["phase"][0]:
        raise ValueError(f"f_hi/f_lo must have {c} channels")
    if t * 2 * c >= 2 ** 31:
        raise ValueError(f"a {t} x {2 * c} dispatch is too large for one "
                         f"launch")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    m = t // plan.factor
    y = empty(2, m, c) if two else empty(m, 2 * c)
    dc_out, tail_out = empty(*dc.shape), empty(*tail.shape)
    mseq = empty(t // front.DC_CHUNK, 2 * c)
    fine = tabs["fine"] + (None,) * (4 - len(tabs["fine"]))
    a, b = plan.ewma
    err = _lib().probe_front_forward(
        _index(dev), _FORM[variant], x[0].data_ptr() if two else x.data_ptr(),
        x[1].data_ptr() if two else None, t, c, sub, plan.factor, plan.d_rows,
        kt, dc.data_ptr(), tail.data_ptr(), phase.data_ptr(),
        tabs["fhi"].data_ptr(), tabs["flo"].data_ptr(),
        *(None if f is None else f.data_ptr() for f in fine), wh.data_ptr(),
        wl.data_ptr(), kpad, a, b, mseq.data_ptr(),
        y[0].data_ptr() if two else y.data_ptr(),
        y[1].data_ptr() if two else None, dc_out.data_ptr(),
        tail_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise(err, "probe_toeplitz")
    probe_front.launches += 1
    front.chunk_means.launches += 2 if two else 1   # front_means per plane
    front.dc_scan.launches += 2 if two else 1       # front_dc_scan per plane
    return y, dc_out, tail_out, advance_phase(phase, t, tabs["fhi"],
                                              tabs["flo"])


# ---------------------------------------------------------------- binding ---

@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/front.cu (K1 and the probes), with the probes' C signatures."""
    return declare(front._lib())


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A library built from csrc/front.cu with the probes' C signatures
    declared (also for the variants tools/ring_sweep.py builds)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_floor_forward.restype = ctypes.c_int
    lib.probe_floor_forward.argtypes = [i, p, p, i, i, i, i, p, p, p]
    lib.probe_front_forward.restype = ctypes.c_int
    lib.probe_front_forward.argtypes = [
        i, i, p, p, i, i, i, i, i, i,     # device, form, x0, x1, T .. kt
        p, p, p, p, p,                    # dc_in, tail_in, phase, fhi, flo
        p, p, p, p, p, p, i,              # f0 .. f3, wh, wl, kpad
        f, f, p, p, p, p, p, p]           # a, b, mseq, y0, y1, dc_out,
    #                                       tail_out, stream
    return lib


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _raise(err: int, name: str) -> None:
    if err:
        msg = front._lib().front_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


probe_floor.launches = 0   # CUDA kernel launches (the plain path never counts)
# probe_toeplitz launches (one per call, after front_means and front_dc_scan
# per plane, which chunk_means.launches and dc_scan.launches count)
probe_front.launches = 0
