"""The stateful per-sample stages of the front and the demod tail: the
EWMA, the noise blanker (per sample and chunked), the IQ balance (static
and adaptive) and the adaptive noise filter (ANF).  Port of
pebblesdr_tpu/ops/scanops.py.

EWMA (ewma): y[n] = (1 - alpha) y[n-1] + alpha x[n], the first-order
recurrence of ops/iir.py first_order_apply (closed form or chunked: a
linear recurrence, no per-sample loop).

NoiseBlanker NB1 / NB2 per sample (noise_blanker): the EWMA of |x|, a
spike where |x| > threshold * avg, the spike flags dilated to blank_width
samples centred on each spike by a max-pool (the JAX package's
reduce_window with "SAME" padding); NB1 zeroes the window, NB2 scales it to
the running average.  No state crosses a call but the average.

NoiseBlanker NB1 / NB2 (noise_blanker_chunked, the staged front's blanker):
the twin of the fused front's in-kernel blanker, with no scan.  The
average is the EWMA of |x|^2, piecewise constant per 512-sample chunk and
updated from the chunk means in closed form; a sample is a spike where
|x|^2 > threshold^2 avg (the average entering its chunk); a spike blanks
itself and the next blank_width - 1 samples (NB1: zero; NB2: scaled to the
running RMS), with the spike flags carried across calls.

IQBalance (iqbalance.cpp:65-87): the static correction iq_balance (I' =
gain I, Q' = Q + phase I) and the adaptive image-reject loop
auto_iq_balance (N4HY/dttsp, mu = 0.0025) in block form: per group of 64
samples, y = x + w conj(x) with w held, then w <- w - mu mean(y^2).  The
group sums do not depend on w: mean(y^2) = S2 + 2 w P + w^2 conj(S2) with
S2 = mean(x^2) and P = mean(|x|^2), so only a few complex multiply-adds
per group lie on the serial chain.  On a CUDA tensor the loop is one
launch of the recurrence kernel K5 (csrc/recur.cu iq_lms_scan); on a CPU
tensor its plain version iq_lms_scan_plain (the sums vectorised, then a
Python loop over the groups on [C] tensors, the chain's float32
operations in the kernel's order).  auto_iq_balance.launches counts the
kernel launches.

NoiseFilter ANF (noisefilter.cpp:5-106, the dttsp LMS): a 45-tap filter
predicts x from a copy delayed by 64 samples and outputs the prediction,
the periodic (tonal) part.  Block LMS: the weights are frozen for each
sub-block of `update_every` samples, the gradient is accumulated over it
and applied once (leak 1 - 1e-5, rate 0.01).  On a CUDA tensor the loop
over the sub-blocks is one launch of the recurrence kernel K8 (csrc/
recur.cu anf_scan); on a CPU tensor its plain version anf_plain (a Python
loop of a few batched matmuls per sub-block, the JAX package's lax.scan).
The batched receiver updates once per demod block (a K-block dispatch
runs K steps), the staged front every 16 samples.  Complex input runs as
two real ANFs stacked on the channel axis.  anf_scan.launches counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

import torch.nn.functional as F

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import iir

ANF_TAPS = 45          # noisefilter.cpp:5-16
ANF_DELAY = 64
ANF_RATE = 0.01
ANF_LEAK = 1.0 - 1e-5
# K8's two forms (csrc/recur.cu, kAnfChainMaxU and kAnfWideMin / Max): the
# chain form (one warp per row) up to this U, the wide form (a block of U
# rounded up to a warp, within these threads, per row) above it
ANF_FORMS = ("chain", "wide")          # recur.cu's form 1 and 2
ANF_CHAIN_MAX_U = 32
ANF_WIDE_THREADS = (64, 1024)
IQ_MU = 0.0025         # iqbalance.cpp:76-87
IQ_GROUP = 64          # samples per adaptive IQ update (K5's group)
SOURCE = "pebblesdr_tpu_torch/csrc/recur.cu"
REPLACES = "pebblesdr_tpu/ops/scanops.py:164"   # auto_iq_balance's lax.scan
ANF_REPLACES = "pebblesdr_tpu/ops/scanops.py:257"   # anf's lax.scan


# ------------------------------------------------------------- EWMA

def ewma(carry: torch.Tensor, x: torch.Tensor, alpha: float):
    """y[n] = (1 - alpha) y[n-1] + alpha x[n] over the last axis of x [C, N]
    from carry [C].  Returns (y_last [C], y [C, N])."""
    return iir.first_order_apply(carry, x, 1.0 - alpha, alpha)


# ------------------------------------------------------------- noise blanker

@dataclasses.dataclass(frozen=True)
class NoiseBlankerState:
    mag_avg: torch.Tensor  # [C] running EWMA of |x|


def noise_blanker_init(channels: int, device) -> NoiseBlankerState:
    return NoiseBlankerState(mag_avg=torch.zeros(channels, dtype=torch.float32,
                                                 device=device))


def noise_blanker(state: NoiseBlankerState, x: torch.Tensor,
                  threshold: float = 3.3, blank_width: int = 7,
                  alpha: float = 0.001, mode: str = "blank"):
    """NB1 ("blank": zero a window around spikes) / NB2 ("average":
    substitute the running average level) on x [C, N] complex64.  Returns
    (state', y)."""
    mag = x.abs()
    avg_last, avg = ewma(state.mag_avg, mag, alpha)
    spike = (mag > threshold * torch.clamp(avg, min=1e-9)).to(torch.float32)
    # centred dilation to blank_width samples ("SAME": the odd sample of an
    # even width pads after)
    lo = (blank_width - 1) // 2
    widened = F.max_pool1d(F.pad(spike[:, None], (lo, blank_width - 1 - lo)),
                           blank_width, stride=1)[:, 0] > 0.0
    if mode == "blank":
        y = torch.where(widened, torch.zeros_like(x), x)
    else:                            # NB2: substitute the running average
        sub = (avg / torch.clamp(mag, min=1e-12)) * x
        y = torch.where(widened, sub.to(x.dtype), x)
    return NoiseBlankerState(mag_avg=avg_last), y.to(torch.complex64)


@dataclasses.dataclass(frozen=True)
class NoiseBlankerChunkedState:
    mag_avg: torch.Tensor     # [C] chunked EWMA of |x|^2 (updates per chunk)
    spike_tail: torch.Tensor  # [C, blank_width - 1] trailing spike flags


def noise_blanker_chunked_init(channels: int, device, blank_width: int = 7
                               ) -> NoiseBlankerChunkedState:
    return NoiseBlankerChunkedState(
        mag_avg=torch.zeros(channels, dtype=torch.float32, device=device),
        spike_tail=torch.zeros(channels, blank_width - 1,
                               dtype=torch.float32, device=device))


def noise_blanker_chunked(state: NoiseBlankerChunkedState, x: torch.Tensor,
                          threshold: float = 3.3, blank_width: int = 7,
                          alpha: float = 0.001, chunk: int = 512,
                          mode: str = "blank"):
    """NB1 ("blank") / NB2 ("average") on x [C, N] complex64, N a multiple
    of chunk.  Returns (state', y)."""
    c, n = x.shape
    if n % chunk:
        raise ValueError(f"noise blanker: block length {n} is not a "
                         f"multiple of its {chunk}-sample chunk")
    nchunk = n // chunk
    mag2 = x.real * x.real + x.imag * x.imag
    means = mag2.reshape(c, nchunk, chunk).mean(dim=-1)           # [C, J]
    lmat, seed = iir.ewma_tables(nchunk, (1.0 - alpha) ** chunk, x.device)
    avgs = (torch.matmul(means, lmat.T)
            + seed[None, :] * state.mag_avg[:, None])             # [C, J]
    # chunk j's samples use the average entering it (end of chunk j-1)
    avg_in = torch.cat([state.mag_avg[:, None], avgs[:, :-1]], dim=1)
    avg_s = torch.repeat_interleave(avg_in, chunk, dim=1)          # [C, N]
    spike = (mag2 > threshold * threshold * torch.clamp(avg_s, min=1e-18)
             ).to(torch.float32)
    ext = torch.cat([state.spike_tail, spike], dim=1)
    widened = ext[:, blank_width - 1:] > 0.0
    for s in range(1, blank_width):
        widened = widened | (ext[:, blank_width - 1 - s:
                                 ext.shape[1] - s] > 0.0)
    if mode == "blank":
        y = torch.where(widened, torch.zeros_like(x), x)
    else:                            # NB2: substitute the running RMS level
        sub = x * torch.sqrt(avg_s / torch.clamp(mag2, min=1e-24))
        y = torch.where(widened, sub, x)
    return (NoiseBlankerChunkedState(
        mag_avg=avgs[:, -1],
        spike_tail=spike[:, spike.shape[1] - (blank_width - 1):]), y)


# ------------------------------------------------------------- IQ balance

def iq_balance(x: torch.Tensor, gain, phase) -> torch.Tensor:
    """The static correction: I' = gain I, Q' = Q + phase I."""
    return torch.complex(x.real * gain, x.imag + phase * x.real)


@dataclasses.dataclass(frozen=True)
class AutoIQBalanceState:
    w: torch.Tensor   # [C] complex64 adaptive image-reject weight


def auto_iq_balance_init(channels: int, device) -> AutoIQBalanceState:
    return AutoIQBalanceState(w=torch.zeros(channels, dtype=torch.complex64,
                                            device=device))


def iq_lms_scan_plain(x: torch.Tensor, w: torch.Tensor, mu: float = IQ_MU,
                      group: int = IQ_GROUP):
    """Plain version of K5: the adaptive IQ loop over x [C, N] complex64 (N
    a multiple of group) from the weight w [C] complex64.  The group sums
    S2 = mean(x^2) and P = mean(|x|^2) at once, then one step per group on
    [C] tensors: the group's output uses w, then w <- w - mu (S2 + 2 w P +
    w^2 conj(S2)).  Returns (y [C, N] complex64, w')."""
    c, n = x.shape
    g = n // group
    xr = x.real.reshape(c, g, group)
    xi = x.imag.reshape(c, g, group)
    inv = 1.0 / group
    s2r = (xr * xr - xi * xi).sum(dim=-1) * inv
    s2i = (2.0 * (xr * xi)).sum(dim=-1) * inv
    p = (xr * xr + xi * xi).sum(dim=-1) * inv
    wr, wi = w.real.contiguous(), w.imag.contiguous()
    wrs, wis = [], []
    for s2r_g, s2i_g, p_g in zip(s2r.unbind(1), s2i.unbind(1), p.unbind(1)):
        wrs.append(wr)
        wis.append(wi)
        w2r = wr * wr - wi * wi
        w2i = 2.0 * (wr * wi)
        mr = (s2r_g + 2.0 * (wr * p_g)) + (w2r * s2r_g + w2i * s2i_g)
        mi = (s2i_g + 2.0 * (wi * p_g)) + (w2i * s2r_g - w2r * s2i_g)
        wr, wi = wr - mu * mr, wi - mu * mi
    if not wrs:
        return x.clone(), torch.complex(wr, wi)
    gr = torch.stack(wrs, dim=1)[:, :, None]                   # [C, G, 1]
    gi = torch.stack(wis, dim=1)[:, :, None]
    # y = x + w conj(x): (xr + (wr xr + wi xi), xi + (wi xr - wr xi))
    y = torch.complex(xr + (gr * xr + gi * xi), xi + (gi * xr - gr * xi))
    return y.reshape(c, n), torch.complex(wr, wi)


@functools.cache
def _lib():
    """csrc/recur.cu, built at first use, with K5's and K8's C signatures
    and K8's limits."""
    lib = build.load("recur")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.recur_iq_lms_scan.restype = i
    lib.recur_iq_lms_scan.argtypes = [i, p, i, i, f, p, p, p, p]
    lib.recur_anf_scan_form.restype = i
    lib.recur_anf_scan_form.argtypes = [i, i, p, i, i, i, i, i, f, f, p, p,
                                        p, p, p, p]
    for name in ("recur_anf_max_taps", "recur_anf_max_hist"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    lib.recur_anf_form.restype = i
    lib.recur_anf_form.argtypes = [i]
    lib.recur_anf_threads.restype = i
    lib.recur_anf_threads.argtypes = [i, i]
    lib.recur_error_string.restype = ctypes.c_char_p
    lib.recur_error_string.argtypes = [i]
    return lib


def auto_iq_balance(state: AutoIQBalanceState, x: torch.Tensor,
                    mu: float = IQ_MU, update_every: int = IQ_GROUP):
    """Adaptive image rejection on x [C, N] complex64 (N a multiple of
    update_every): the CUDA kernel K5 (csrc/recur.cu iq_lms_scan, one
    launch, groups of 64) for CUDA tensors, iq_lms_scan_plain for CPU
    tensors.  Returns (state', y)."""
    if x.device.type == "cpu":
        y, w = iq_lms_scan_plain(x, state.w, mu, update_every)
        return AutoIQBalanceState(w=w), y
    if x.device.type != "cuda":
        raise ValueError(f"auto_iq_balance runs on cuda or cpu, not "
                         f"{x.device}")
    dev = x.device
    c, n = x.shape
    if update_every != IQ_GROUP:
        raise ValueError(f"auto_iq_balance: the kernel updates every "
                         f"{IQ_GROUP} samples, not {update_every}")
    if (x.dim() != 2 or x.dtype != torch.complex64 or not x.is_contiguous()
            or x.data_ptr() % 16 or n % IQ_GROUP or x.numel() >= 2 ** 31):
        raise ValueError(f"auto_iq_balance: x must be a contiguous, 16-byte "
                         f"aligned [C, N] complex64 tensor with N a multiple "
                         f"of {IQ_GROUP}, got {x.dtype} {tuple(x.shape)}")
    w = state.w
    if (w.device != dev or w.dtype != torch.complex64
            or tuple(w.shape) != (c,) or not w.is_contiguous()):
        raise ValueError(f"auto_iq_balance: the weight must be a contiguous "
                         f"[C] complex64 tensor on {dev}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    y = torch.empty_like(x)
    w2 = torch.empty_like(w)
    lib = _lib()
    err = lib.recur_iq_lms_scan(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        x.data_ptr(), c, n, mu, w.data_ptr(), y.data_ptr(), w2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"iq_lms_scan kernel launch failed: CUDA error "
                           f"{err} ({lib.recur_error_string(err).decode()})")
    auto_iq_balance.launches += 1
    return AutoIQBalanceState(w=w2), y


auto_iq_balance.launches = 0   # CUDA kernel launches (the plain path never
#                                counts)


# ------------------------------------------------------------- ANF


@dataclasses.dataclass(frozen=True)
class ANFState:
    weights: torch.Tensor  # [C, taps] adaptive filter
    delay: torch.Tensor    # [C, delay + taps - 1] recent input history


def anf_init(channels: int, device, taps: int = ANF_TAPS,
             delay: int = ANF_DELAY, dtype=torch.float32) -> ANFState:
    return ANFState(
        weights=torch.zeros(channels, taps, dtype=dtype, device=device),
        delay=torch.zeros(channels, delay + taps - 1, dtype=dtype,
                          device=device))


def anf_plain(x: torch.Tensor, w: torch.Tensor, hist: torch.Tensor,
              rate: float = ANF_RATE, leak: float = ANF_LEAK,
              update_every: int = 16):
    """Plain version of K8: the leaky block LMS over real rows x [R, N]
    float32 (N a multiple of update_every) from the weights w [R, taps] and
    the history hist [R, delay + taps - 1].  A Python loop over the
    updates, each a few batched matmuls (the JAX package's lax.scan).
    Returns (y [R, N] the predictions, w', hist')."""
    n = x.shape[-1]
    u = update_every
    taps = w.shape[-1]
    h = hist.shape[-1]                              # delay + taps - 1
    full = torch.cat([hist, x], dim=-1)             # [R, H + N]
    if not n:
        return x.clone(), w, hist
    # frames[:, m, k] = full[:, m + k]: the reference window of output m,
    # x delayed by `delay`..`delay + taps - 1` samples (a view)
    frames = full[:, :n + taps - 1].unfold(-1, taps, 1)       # [R, N, taps]
    preds = []
    for i in range(n // u):
        # one copy of the block's frames serves both products (a batched
        # matmul would copy the overlapping view for each)
        fr = frames[:, i * u:(i + 1) * u].contiguous()        # [R, U, taps]
        pred = torch.matmul(fr, w[:, :, None])[..., 0]        # [R, U]
        err = x[:, i * u:(i + 1) * u] - pred
        # w <- leak w + 2 rate grad, grad = err . frames / U
        w = torch.add(leak * w, torch.matmul(err[:, None, :], fr)[:, 0],
                      alpha=2.0 * rate / u)
        preds.append(pred)
    return torch.cat(preds, dim=-1), w, full[:, full.shape[-1] - h:]


def anf_form(update_every: int) -> str:
    """The form of K8 that runs at this U: "chain" or "wide"."""
    return ANF_FORMS[update_every > ANF_CHAIN_MAX_U]


def anf_threads(form: str, update_every: int) -> int:
    """K8's threads per block (one block per row): the chain form's chain
    warp and copy warp, the wide form's U rounded up to a warp."""
    if form == "chain":
        return 64
    lo, hi = ANF_WIDE_THREADS
    return min(max(-(-update_every // 32) * 32, lo), hi)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """fmaf in float32: the product and the sum in float64, rounded to
    float32 once (a float64 rounding of the sum can move a float32 tie, so
    the last bit may differ from a fused multiply-add)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).float()


def anf_emulate(x: torch.Tensor, w: torch.Tensor, hist: torch.Tensor,
                rate: float = ANF_RATE, leak: float = ANF_LEAK,
                update_every: int = 16, form: str | None = None):
    """K8's arithmetic on float32 tensors in the kernel's order of
    summation, for the tests (nothing on the main path calls it): x [R, N],
    w [R, taps], hist [R, H] as for anf_plain, form "chain" or "wide"
    (default: anf_form).  The chain form: lane L's product for output m,
    fmaf(f[m][L + 32], w[L + 32], f[m][L] w[L]), summed over the lanes by
    the butterfly's tree (lanes paired by bit 4, then 3, ..., 0); the
    gradient of taps L and L + 32 over the lane's slots j = 0 .. P - 1
    (slot j holds output j ^ mine, mine = L >> (5 - log2 P), P = U rounded
    up to a power of two) in min(4, P) accumulators over j mod 4, then
    (g0 + g1) + (g2 + g3).  The wide form: per piece of T = anf_threads
    outputs, the prediction in four accumulators over k mod 4; the gradient
    per warp of 32 outputs in four accumulators over m mod 4 that run on
    across the pieces, then over the warps in four accumulators over the
    warp index mod 4.  Both: w' = fmaf(alpha, g, leak w).  Returns (y, w',
    hist')."""
    u = int(update_every)
    form = form or anf_form(u)
    r, n = x.shape
    dev = x.device
    taps, h = w.shape[-1], hist.shape[-1]
    full = torch.cat([hist, x], dim=-1)
    if not n:
        return x.clone(), w, hist
    alpha = float(torch.tensor(2.0 * rate / u, dtype=torch.float32))
    leak32 = torch.tensor(leak, dtype=torch.float32, device=dev)
    frames = full[:, :n + taps - 1].unfold(-1, taps, 1)       # [R, N, taps]
    y = torch.empty_like(x)
    w = w.clone()
    if form == "chain":
        p = 1 << (u - 1).bit_length()
        acc = min(4, p)
        w64 = torch.zeros(r, 64, device=dev)
        w64[:, :taps] = w
        # tap k's lane k % 32 takes output slot[j, k] in its slot j
        mine = (torch.arange(64, device=dev) % 32) >> (6 - p.bit_length())
        slot = torch.arange(p, device=dev)[:, None] ^ mine[None]
        for i in range(n // u):
            fr = torch.zeros(r, p, 64, device=dev)
            fr[:, :u, :taps] = frames[:, i * u:(i + 1) * u]
            s = _fma(fr[..., 32:], w64[:, None, 32:],
                     fr[..., :32] * w64[:, None, :32])         # [R, P, 32]
            while s.shape[-1] > 1:
                half = s.shape[-1] // 2
                s = s[..., :half] + s[..., half:]
            pred = s[..., 0]
            err = torch.zeros(r, p, device=dev)
            err[:, :u] = x[:, i * u:(i + 1) * u] - pred[:, :u]
            y[:, i * u:(i + 1) * u] = pred[:, :u]
            e_s = err[:, slot]                                 # [R, P, 64]
            f_s = fr.gather(1, slot.expand(r, p, 64))
            g = torch.zeros(r, acc, 64, device=dev)
            for j0 in range(0, p, acc):
                g = _fma(e_s[:, j0:j0 + acc], f_s[:, j0:j0 + acc], g)
            gs = g[:, 0]
            if acc == 2:
                gs = g[:, 0] + g[:, 1]
            elif acc == 4:
                gs = (g[:, 0] + g[:, 1]) + (g[:, 2] + g[:, 3])
            w64 = _fma(gs, alpha, leak32 * w64)
        w = w64[:, :taps].clone()
    else:
        t = anf_threads("wide", u)
        warps = t // 32
        for i in range(n // u):
            g = torch.zeros(r, warps, 4, 64, device=dev)
            for m0 in range(0, u, t):
                ln, base = min(t, u - m0), i * u + m0
                fr = frames[:, base:base + ln]                 # [R, ln, taps]
                a = torch.zeros(r, ln, 4, device=dev)
                for k0 in range(0, taps, 4):
                    kk = min(4, taps - k0)
                    a[..., :kk] = _fma(fr[..., k0:k0 + kk],
                                       w[:, None, k0:k0 + kk], a[..., :kk])
                pred = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])
                y[:, base:base + ln] = pred
                err = torch.zeros(r, t, device=dev)
                err[:, :ln] = x[:, base:base + ln] - pred
                frp = torch.zeros(r, t, 64, device=dev)
                frp[:, :ln, :taps] = fr
                e4 = err.view(r, warps, 8, 4)
                f4 = frp.view(r, warps, 8, 4, 64)
                for j in range(8):
                    g = _fma(e4[:, :, j, :, None], f4[:, :, j], g)
            part = (g[:, :, 0] + g[:, :, 1]) + (g[:, :, 2] + g[:, :, 3])
            s = torch.zeros(r, 4, 64, device=dev)
            for j in range(warps):
                s[:, j % 4] = s[:, j % 4] + part[:, j]
            gs = (s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3])
            w = _fma(gs[:, :taps], alpha, leak32 * w)
    return y, w, full[:, full.shape[-1] - h:]


def anf_scan(x: torch.Tensor, w: torch.Tensor, hist: torch.Tensor,
             rate: float = ANF_RATE, leak: float = ANF_LEAK,
             update_every: int = 16, form: str | None = None):
    """K8 (csrc/recur.cu anf_scan): anf_plain's recurrence on CUDA tensors,
    one launch (one block per row) of the form anf_form picks for U (form
    "chain" or "wide" forces one; the chain form takes U <= 32).  x [R, N]
    float32, w [R, taps], hist [R, H] float32, contiguous, on one CUDA
    device.  Returns (y, w', hist')."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"anf_scan runs on cuda, not {dev}")
    r, n = x.shape if x.dim() == 2 else (0, 0)
    u = int(update_every)
    if (x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous()
            or u < 1 or n % u or x.numel() >= 2 ** 31):
        raise ValueError(f"anf_scan: x must be a contiguous [R, N] float32 "
                         f"tensor with N a multiple of update_every={u}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    lib = _lib()
    taps, h = w.shape[-1], hist.shape[-1]
    for name, t, shape in (("w", w, (r, taps)), ("hist", hist, (r, h))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"anf_scan: {name} must be a contiguous "
                             f"{list(shape)} float32 tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device} "
                             f"(contiguous: {t.is_contiguous()})")
    if not (0 < taps <= lib.recur_anf_max_taps()
            and taps - 1 <= h <= lib.recur_anf_max_hist()):
        raise ValueError(f"anf_scan: {taps} taps and a {h}-sample history "
                         f"exceed the kernel's {lib.recur_anf_max_taps()} "
                         f"taps / {lib.recur_anf_max_hist()} samples")
    if form not in (None, *ANF_FORMS) or (form == "chain"
                                          and u > ANF_CHAIN_MAX_U):
        raise ValueError(f"anf_scan: form {form!r} does not take "
                         f"update_every={u} (the chain form takes U <= "
                         f"{ANF_CHAIN_MAX_U})")
    y = torch.empty_like(x)
    w2 = torch.empty_like(w)
    hist2 = torch.empty_like(hist)
    err = lib.recur_anf_scan_form(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ANF_FORMS.index(form) + 1 if form else 0,
        x.data_ptr(), r, n, u, taps, h, 2.0 * rate / u, leak, w.data_ptr(),
        hist.data_ptr(), y.data_ptr(), w2.data_ptr(), hist2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"anf_scan kernel launch failed: CUDA error {err} "
                           f"({lib.recur_error_string(err).decode()})")
    anf_scan.launches += 1
    return y, w2, hist2


anf_scan.launches = 0   # CUDA kernel launches (the plain path never counts)


def anf(state: ANFState, x: torch.Tensor, rate: float = ANF_RATE,
        leak: float = ANF_LEAK, update_every: int = 16):
    """x [C, N] float32 or complex64 (N a multiple of update_every) ->
    (state', the prediction y [C, N] of x's periodic part).  The taps and
    the delay are the state's (anf_init).  Complex x
    runs as 2C real rows (re rows, then im rows) with real weights.  The
    rows go through K8 (anf_scan, one launch) on a CUDA tensor and
    anf_plain on a CPU tensor."""
    if x.is_complex():
        c = x.shape[0]

        def stack(t):
            return (torch.cat([t.real, t.imag]) if t.is_complex()
                    else t.repeat(2, 1))

        st, ys = anf(ANFState(weights=stack(state.weights),
                              delay=stack(state.delay)),
                     torch.cat([x.real, x.imag]), rate, leak, update_every)
        return (ANFState(weights=torch.complex(st.weights[:c], st.weights[c:]),
                         delay=torch.complex(st.delay[:c], st.delay[c:])),
                torch.complex(ys[:c], ys[c:]))
    run = anf_plain if x.device.type == "cpu" else anf_scan
    y, w, hist = run(x.contiguous(), state.weights.contiguous(),
                     state.delay.contiguous(), rate, leak, update_every)
    return ANFState(weights=w, delay=hist), y
