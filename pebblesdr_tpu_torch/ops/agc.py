"""AGC (port of pebblesdr_tpu/ops/agc.py): the parallel form and the
sample-exact scan.

Log-domain CuteSDR AGC (agc.{h,cpp}): trailing 18 ms peak window (van Herk
cummax), knee/slope gain law, and a 15 ms delay line.  algorithm="parallel"
(the Receiver's): exponential release as one tilted cummax, attack
smoothing as max(rise pole, fall pole) first-order sections; the hang mode
('long') holds the peak envelope as a trailing windowed max over the 2 s
decay time (its own carried tail) and then releases fast
(RELEASE_TIMECONST).  With stride > 1 the envelope collapses to one max per
stride first and the gain is interpolated back linearly (the JAX package's
documented stride deviation).

algorithm="scan": the CuteSDR attack / decay / hang recurrence itself, one
step per sample of the windowed peak (every stride-th with stride > 1,
its levels resized back linearly as jax.image.resize does, within each
call), the parallel form's parity reference.  The recurrence runs on a
CUDA tensor as one launch of a kernel (csrc/recur.cu agc_scan, the
short-chain kernel: a lane a channel, the envelope staged by a copy warp;
agc_scan.launches counts them) and on a CPU tensor as its plain version
agc_scan_plain.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import short_chain
from pebblesdr_tpu_torch.ops.iir import first_order_apply

# agc.h constants
DELAY_TIMECONST = 0.015
WINDOW_TIMECONST = 0.018
ATTACK_RISE_TIMECONST = 0.002
ATTACK_FALL_TIMECONST = 0.005
DECAY_RISEFALL_RATIO = 0.3
RELEASE_TIMECONST = 0.05
AGC_OUTSCALE = 0.7
MAX_AMPLITUDE = 1.0
MIN_CONSTANT = 1e-8  # log floor ~ -160 dB
ALGORITHMS = ("parallel", "scan")
SOURCE = "pebblesdr_tpu_torch/csrc/recur.cu"
REPLACES = "pebblesdr_tpu/ops/agc.py:298"   # the scan AGC's lax.scan

MODES = {  # mode -> (decay_ms, use_hang)
    "off": (0.0, False),
    "fast": (100.0, False),
    "med": (250.0, False),
    "slow": (500.0, False),
    "long": (2000.0, True),
}


@dataclasses.dataclass(frozen=True)
class AGCConfig:
    sample_rate: float
    mode: str
    threshold_db: float = -20.0   # knee
    slope_factor: float = 0.0     # output slope above knee, 0..1
    stride: int = 1
    window: int = 0               # peak window samples
    delay: int = 0                # delay-line samples
    algorithm: str = "parallel"   # or "scan" (the sample-exact recurrence)

    @staticmethod
    def make(sample_rate: float, mode: str = "med", threshold_db: float = -20.0,
             slope_factor: float = 0.0, stride: int = 1,
             algorithm: str = "parallel") -> "AGCConfig":
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown AGC algorithm {algorithm!r} "
                             f"(algorithms: {', '.join(ALGORITHMS)})")
        if mode not in MODES:
            raise ValueError(f"unknown AGC mode {mode!r} (modes: "
                             f"{', '.join(MODES)})")
        return AGCConfig(
            sample_rate=sample_rate, mode=mode, threshold_db=threshold_db,
            slope_factor=slope_factor, stride=stride, algorithm=algorithm,
            window=max(1, int(WINDOW_TIMECONST * sample_rate)),
            delay=max(1, int(DELAY_TIMECONST * sample_rate)),
        )


@dataclasses.dataclass(frozen=True)
class AGCState:
    attack_avg: torch.Tensor       # [C] log-domain attack smoother (rise pole)
    decay_avg: torch.Tensor        # [C] log-domain decay envelope
    hang_count: torch.Tensor       # [C] int32 hang timer (scan; carried as
    #                                is by the parallel form)
    window_tail: torch.Tensor      # [C, window-1] previous log-magnitudes
    #                                (parallel with stride > 1: on the
    #                                coarse grid)
    delay_line: torch.Tensor       # [C, delay] delayed complex signal
    attack_fall_avg: torch.Tensor  # [C] fall pole
    hang_tail: torch.Tensor | None = None  # [C, hang-1] coarse peak history
    #                                        ('long'; None otherwise)


def hang_window(cfg: AGCConfig) -> int:
    """The parallel hang mode's held-max window on the coarse (stride)
    grid; 0 for the modes without hang and for the scan (its hang is a
    timer)."""
    decay_ms, use_hang = MODES[cfg.mode]
    if not use_hang or cfg.algorithm != "parallel":
        return 0
    return max(1, int((decay_ms / 1000.0) * cfg.sample_rate) // cfg.stride)


def agc_init(cfg: AGCConfig, channels: int, device) -> AGCState:
    floor = math.log10(MIN_CONSTANT)
    w = (max(1, cfg.window // cfg.stride)
         if cfg.algorithm == "parallel" and cfg.stride > 1 else cfg.window)
    h = hang_window(cfg)

    def full(*shape):
        return torch.full(shape, floor, dtype=torch.float32, device=device)

    return AGCState(
        attack_avg=full(channels),
        decay_avg=full(channels),
        hang_count=torch.zeros(channels, dtype=torch.int32, device=device),
        window_tail=full(channels, max(w - 1, 0)),
        delay_line=torch.zeros(channels, cfg.delay, dtype=torch.complex64,
                               device=device),
        attack_fall_avg=full(channels),
        hang_tail=full(channels, h - 1) if h > 1 else None,
    )


def _coef(timeconst_s: float, rate: float) -> float:
    return 1.0 - math.exp(-1.0 / (max(rate * timeconst_s, 1.0)))


def _gain_law(cfg: AGCConfig, level: torch.Tensor) -> torch.Tensor:
    knee = cfg.threshold_db / 20.0
    log_gain = torch.where(level > knee,
                           cfg.slope_factor * (level - knee) - level,
                           torch.full_like(level, -knee))
    return torch.pow(10.0, log_gain) * AGC_OUTSCALE


def agc_apply(cfg: AGCConfig, state: AGCState, x: torch.Tensor):
    """x: [C, N] complex64 -> (state', y [C, N]).  mode 'off' is identity."""
    if cfg.mode == "off":
        return state, x
    if cfg.algorithm == "scan":
        return _agc_apply_scan(cfg, state, x)
    c, n = x.shape
    s = cfg.stride
    if s > 1 and n % s:
        raise ValueError(f"AGC stride {s} must divide block length {n}")
    # max commutes with the monotone log10: decimate before the log
    mag = torch.abs(x)
    if s > 1:
        mag = torch.amax(mag.reshape(c, n // s, s), dim=-1)
    logmag = torch.log10(mag + MIN_CONSTANT)
    rate_s = cfg.sample_rate / s
    window = max(1, cfg.window // s)
    ext = torch.cat([state.window_tail, logmag], dim=-1)
    peak = _windowed_max(ext, window) if window > 1 else ext
    new_window_tail = ext[:, ext.shape[-1] - (window - 1):]

    # hang: the envelope may not fall below any peak of the last h coarse
    # samples (a trailing windowed max with its own tail), then releases
    # fast once the hold expires
    decay_ms, use_hang = MODES[cfg.mode]
    h = hang_window(cfg)
    held, new_hang_tail = peak, state.hang_tail
    if h > 1:
        ext_h = torch.cat([state.hang_tail, peak], dim=-1)
        held = _windowed_max(ext_h, h)
        new_hang_tail = ext_h[:, ext_h.shape[-1] - (h - 1):]
    release_s = RELEASE_TIMECONST if use_hang else decay_ms / 1000.0
    d = 0.43429448 / max(release_s, 1e-3) / rate_s
    dec_last, env = _decaying_max(state.decay_avg, held, d)
    rise_coef = _coef(ATTACK_RISE_TIMECONST, rate_s)
    fall_coef = _coef(ATTACK_FALL_TIMECONST, rate_s)
    att_last, lvl_rise = first_order_apply(state.attack_avg, env,
                                           1.0 - rise_coef, rise_coef)
    attf_last, lvl_fall = first_order_apply(state.attack_fall_avg, env,
                                            1.0 - fall_coef, fall_coef)
    gain = _gain_law(cfg, torch.maximum(lvl_rise, lvl_fall))
    if s > 1:
        # each coarse gain is reached at the END of its stride window:
        # g[i*s + j] = lerp(g[i-1], g[i], (j+1)/s)
        g0 = _gain_law(cfg, torch.maximum(state.attack_avg,
                                          state.attack_fall_avg))
        g_prev = torch.cat([g0[:, None], gain[:, :-1]], dim=-1)
        w_up = (torch.arange(1, s + 1, dtype=torch.float32, device=x.device)
                / s)[None, None, :]
        gain = (g_prev[:, :, None] * (1.0 - w_up)
                + gain[:, :, None] * w_up).reshape(c, n)

    full = torch.cat([state.delay_line, x], dim=-1)
    y = (full[:, :n] * gain).to(torch.complex64)
    new_state = AGCState(attack_avg=att_last, decay_avg=dec_last,
                         hang_count=state.hang_count,
                         window_tail=new_window_tail, delay_line=full[:, n:],
                         attack_fall_avg=attf_last, hang_tail=new_hang_tail)
    return new_state, y


def _windowed_max(ext: torch.Tensor, w: int) -> torch.Tensor:
    """Trailing sliding-window max via van Herk/Gil-Werman (two cummax
    passes).  ext: [C, N + w - 1] -> [C, N], out[i] = max(ext[i:i+w])."""
    c, length = ext.shape
    n = length - w + 1
    nb = -(-length // w)
    padded = torch.nn.functional.pad(ext, (0, nb * w - length),
                                     value=-math.inf)
    blocks = padded.reshape(c, nb, w)
    pre = torch.cummax(blocks, dim=2).values.reshape(c, nb * w)
    suf = torch.cummax(blocks.flip(2), dim=2).values.flip(2).reshape(c, nb * w)
    return torch.maximum(suf[:, :n], pre[:, w - 1:w - 1 + n])


def _decaying_max(carry: torch.Tensor, p: torch.Tensor, d: float):
    """e[n] = max(e[n-1] - d, p[n]) as one cummax of the tilted input:
    e[n] = cummax(p + d*k)[n] - d*n.  Returns (e_last [C], e [C, N])."""
    n = p.shape[1]
    tilt = d * torch.arange(n, dtype=p.dtype, device=p.device)[None, :]
    pp = torch.cat([torch.maximum(p[:, :1], carry[:, None] - d), p[:, 1:]],
                   dim=1)
    e = torch.cummax(pp + tilt, dim=1).values - tilt
    return e[:, -1], e


# ---------------------------------------------------------------- the scan

def scan_coefs(cfg: AGCConfig) -> dict:
    """The scan's smoother coefficients at rate / stride, as the JAX package
    derives them: attack rise / fall, decay rise (0.3 x the decay time) and
    fall (RELEASE_TIMECONST after the hang, the decay time without it), the
    hang in coarse steps, and whether the hang timer runs."""
    decay_ms, use_hang = MODES[cfg.mode]
    rate = cfg.sample_rate / cfg.stride
    return {"rise": _coef(ATTACK_RISE_TIMECONST, rate),
            "fall": _coef(ATTACK_FALL_TIMECONST, rate),
            "drise": _coef((decay_ms / 1000.0) * DECAY_RISEFALL_RATIO, rate),
            "dfall": _coef(RELEASE_TIMECONST if use_hang
                           else decay_ms / 1000.0, rate),
            "hang_samples": int((decay_ms / 1000.0) * cfg.sample_rate
                                / cfg.stride),
            "hang": use_hang}


def agc_scan_plain(env: torch.Tensor, att: torch.Tensor, dec: torch.Tensor,
                   hang: torch.Tensor, rise: float, fall: float,
                   drise: float, dfall: float, hang_samples: int,
                   use_hang: bool):
    """Plain version of agc_scan: the scan AGC's smoother, one step per
    column of env [C, M] float32, state att / dec [C] float32 and hang [C]
    int32.  Returns (att', dec', hang', levels [C, M] = max(att', dec')
    per step)."""
    c, m = env.shape
    levels = []
    zero = torch.zeros_like(hang)
    for p in env.unbind(1):
        att2 = torch.where(p > att, att + rise * (p - att),
                           att + fall * (p - att))
        rising = p > dec
        if use_hang:
            hang = torch.where(rising, zero, hang + 1)
            dec2 = torch.where(rising, dec + drise * (p - dec),
                               torch.where(hang > hang_samples,
                                           dec + dfall * (p - dec), dec))
        else:
            dec2 = torch.where(rising, dec + drise * (p - dec),
                               dec + dfall * (p - dec))
        levels.append(torch.maximum(att2, dec2))
        att, dec = att2, dec2
    if not levels:
        return att, dec, hang, torch.empty(c, 0, dtype=torch.float32,
                                           device=env.device)
    return att, dec, hang, torch.stack(levels, dim=1)


@functools.cache
def _lib():
    """csrc/recur.cu, built at first use, with agc_scan's C signature."""
    lib = build.load("recur")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.recur_agc_scan.restype = i
    lib.recur_agc_scan.argtypes = [i, i, p, i, i, f, f, f, f, i, p, p, p, p,
                                   p, p, p, p]
    lib.recur_error_string.restype = ctypes.c_char_p
    lib.recur_error_string.argtypes = [i]
    return lib


@functools.cache
def _agc_fn():
    """The bound C entry (recur_agc_scan)."""
    return _lib().recur_agc_scan


def agc_scan(env: torch.Tensor, att: torch.Tensor, dec: torch.Tensor,
             hang: torch.Tensor, rise: float, fall: float, drise: float,
             dfall: float, hang_samples: int, use_hang: bool):
    """The scan AGC's smoother: the CUDA kernel (csrc/recur.cu agc_scan, the
    short-chain kernel, one launch; the levels and the state' in one
    allocation) for CUDA tensors, agc_scan_plain for CPU tensors.  Same
    arguments and results as agc_scan_plain."""
    if env.device.type == "cpu":
        return agc_scan_plain(env, att, dec, hang, rise, fall, drise, dfall,
                              hang_samples, use_hang)
    if env.device.type != "cuda":
        raise ValueError(f"agc_scan runs on cuda or cpu, not {env.device}")
    return agc_launch(_agc_fn(), env, att, dec, hang, rise, fall, drise,
                      dfall, hang_samples, use_hang)


def agc_launch(fn, env: torch.Tensor, att: torch.Tensor, dec: torch.Tensor,
               hang: torch.Tensor, rise: float, fall: float, drise: float,
               dfall: float, hang_samples: int, use_hang: bool):
    """agc_scan's CUDA path through the C entry fn (a build of
    recur_agc_scan): the checks, one allocation for the levels and the
    state', one launch."""
    if (env.dim() != 2 or env.dtype != torch.float32
            or not env.is_contiguous() or env.numel() >= 2 ** 31):
        raise ValueError(f"agc_scan: env must be a contiguous [C, M] float32 "
                         f"tensor, got {env.dtype} {tuple(env.shape)}")
    c, m = env.shape
    idx = env.get_device()
    for v, dtype in ((att, torch.float32), (dec, torch.float32),
                     (hang, torch.int32)):
        if (v.dtype != dtype or v.shape != (c,) or v.get_device() != idx
                or not v.is_contiguous()):
            raise ValueError(f"agc_scan: state must be contiguous [C] "
                             f"tensors on {env.device} (att, dec float32, "
                             f"hang int32), got {v.dtype} {tuple(v.shape)} "
                             f"on {v.device}")
    # levels [C, M], then att', dec' and hang' [C] (float32, float32, int32)
    out = torch.empty(c * m + 3 * c, dtype=torch.float32, device=env.device)
    base, o = out.data_ptr(), 4 * c * m
    err = fn(
        idx, int(bool(use_hang)), env.data_ptr(), c, m, rise, fall, drise,
        dfall, int(hang_samples), att.data_ptr(), dec.data_ptr(),
        hang.data_ptr(), base, base + o, base + o + 4 * c, base + o + 8 * c,
        short_chain.raw_stream(idx))
    if err:
        raise RuntimeError(f"agc_scan kernel launch failed: CUDA error {err} "
                           f"({_lib().recur_error_string(err).decode()})")
    agc_scan.launches += 1
    levels, st = out.split([c * m, 3 * c])
    att2, dec2, hang2 = st.view(3, c).unbind(0)
    return att2, dec2, hang2.view(torch.int32), levels.view(c, m)


agc_scan.launches = 0   # CUDA kernel launches (the plain path never counts)


@functools.lru_cache(maxsize=16)
def _resize_taps(m: int, n: int, device: torch.device):
    """jax.image.resize(..., "linear") from m to n samples as two taps per
    output: sample position (i + 0.5) m/n - 0.5 in float32 (half-pixel
    centres), triangle weights to its two neighbours, those outside [0, m)
    dropped and the rest renormalised (edges clamp).  Returns (lo, hi
    indices [n] int64, their weights [n] float32)."""
    sf = ((np.arange(n, dtype=np.float32) + np.float32(0.5))
          * np.float32(1.0 / (n / m)) - np.float32(0.5))
    lo = np.floor(sf).astype(np.int64)
    hi = lo + 1
    w = []
    for j in (lo, hi):
        wj = np.maximum(np.float32(0.0),
                        np.float32(1.0) - np.abs(sf - j.astype(np.float32)))
        w.append(np.where((j >= 0) & (j < m), wj, np.float32(0.0)))
    total = w[0] + w[1]
    inside = ((np.abs(total) > 1000.0 * np.finfo(np.float32).eps)
              & (sf >= -0.5) & (sf <= m - 0.5))
    w = [np.where(inside, wj / np.where(total != 0, total, 1), 0)
         .astype(np.float32) for wj in w]
    as_dev = functools.partial(torch.as_tensor, device=device)
    return (as_dev(np.clip(lo, 0, m - 1)), as_dev(np.clip(hi, 0, m - 1)),
            as_dev(w[0]), as_dev(w[1]))


def resize_linear(levels: torch.Tensor, n: int) -> torch.Tensor:
    """levels [C, M] resized to [C, n] along time as jax.image.resize(...,
    "linear") does (half-pixel centres, edges clamped within the call)."""
    lo, hi, w_lo, w_hi = _resize_taps(levels.shape[-1], n, levels.device)
    return levels[:, lo] * w_lo + levels[:, hi] * w_hi


def _agc_apply_scan(cfg: AGCConfig, state: AGCState, x: torch.Tensor):
    """The sample-exact scan AGC (JAX agc_apply, algorithm 'scan'): the
    full-rate trailing peak window, its every stride-th value through the
    smoother (agc_scan), the levels resized back to N within the call, the
    gain law and the delay line."""
    c, n = x.shape
    s = cfg.stride
    if s > 1 and n % s:
        raise ValueError(f"AGC stride {s} must divide block length {n}")
    logmag = torch.log10(torch.abs(x) + MIN_CONSTANT)
    ext = torch.cat([state.window_tail, logmag], dim=-1)
    peak = _windowed_max(ext, cfg.window) if cfg.window > 1 else ext
    new_window_tail = ext[:, ext.shape[-1] - (cfg.window - 1):]
    env = (peak[:, ::s] if s > 1 else peak).contiguous()        # [C, M]
    k = scan_coefs(cfg)
    att, dec, hang, levels = agc_scan(
        env, state.attack_avg, state.decay_avg, state.hang_count, k["rise"],
        k["fall"], k["drise"], k["dfall"], k["hang_samples"], k["hang"])
    if s > 1:
        levels = resize_linear(levels, n)
    full = torch.cat([state.delay_line, x], dim=-1)
    y = (full[:, :n] * _gain_law(cfg, levels)).to(torch.complex64)
    return (AGCState(attack_avg=att, decay_avg=dec, hang_count=hang,
                     window_tail=new_window_tail, delay_line=full[:, n:],
                     attack_fall_avg=state.attack_fall_avg,
                     hang_tail=state.hang_tail), y)
