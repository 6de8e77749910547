"""The stateful per-sample stages of the front and the demod tail: the
chunked noise blanker, the IQ balance (static and adaptive) and the
adaptive noise filter (ANF).  Port of pebblesdr_tpu/ops/scanops.py.

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

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import iir

ANF_TAPS = 45          # noisefilter.cpp:5-16
ANF_DELAY = 64
ANF_RATE = 0.01
ANF_LEAK = 1.0 - 1e-5
IQ_MU = 0.0025         # iqbalance.cpp:76-87
IQ_GROUP = 64          # samples per adaptive IQ update (K5's group)
SOURCE = "pebblesdr_tpu_torch/csrc/recur.cu"
REPLACES = "pebblesdr_tpu/ops/scanops.py:164"   # auto_iq_balance's lax.scan
ANF_REPLACES = "pebblesdr_tpu/ops/scanops.py:257"   # anf's lax.scan


# ------------------------------------------------------------- noise blanker

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
    lib.recur_anf_scan.restype = i
    lib.recur_anf_scan.argtypes = [i, p, i, i, i, i, i, f, f, p, p, p, p, p,
                                   p]
    for name in ("recur_anf_max_taps", "recur_anf_max_hist"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
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


def anf_scan(x: torch.Tensor, w: torch.Tensor, hist: torch.Tensor,
             rate: float = ANF_RATE, leak: float = ANF_LEAK,
             update_every: int = 16):
    """K8 (csrc/recur.cu anf_scan): anf_plain's recurrence on CUDA tensors,
    one launch (one block per row).  x [R, N] float32, w [R, taps], hist
    [R, H] float32, contiguous, on one CUDA device.  Returns (y, w',
    hist')."""
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
    y = torch.empty_like(x)
    w2 = torch.empty_like(w)
    hist2 = torch.empty_like(hist)
    err = lib.recur_anf_scan(
        dev.index if dev.index is not None else torch.cuda.current_device(),
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
