"""AGC, parallel form (port of the 'parallel' path of pebblesdr_tpu/ops/agc.py).

Log-domain CuteSDR AGC (agc.{h,cpp}): trailing 18 ms peak window (van Herk
cummax), exponential release as one tilted cummax, attack smoothing as
max(rise pole, fall pole) first-order sections, knee/slope gain law, and a
15 ms delay line.  The hang mode ('long') holds the peak envelope as a
trailing windowed max over the 2 s decay time (its own carried tail) and
then releases fast (RELEASE_TIMECONST).  With stride > 1 the envelope
collapses to one max per stride first and the gain is interpolated back
linearly (the JAX package's documented stride deviation).

Not ported: the sample-exact algorithm='scan' (a per-sample lax.scan in the
JAX package, its parity reference; the Receiver never builds it).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pebblesdr_tpu_torch.ops.iir import first_order_apply

# agc.h constants
DELAY_TIMECONST = 0.015
WINDOW_TIMECONST = 0.018
ATTACK_RISE_TIMECONST = 0.002
ATTACK_FALL_TIMECONST = 0.005
RELEASE_TIMECONST = 0.05
AGC_OUTSCALE = 0.7
MIN_CONSTANT = 1e-8  # log floor ~ -160 dB

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

    @staticmethod
    def make(sample_rate: float, mode: str = "med", threshold_db: float = -20.0,
             slope_factor: float = 0.0, stride: int = 1,
             algorithm: str = "parallel") -> "AGCConfig":
        if algorithm != "parallel":
            raise ValueError(f"AGC algorithm {algorithm!r} (the sample-exact "
                             f"per-sample scan) is not ported; the port runs "
                             f"'parallel'")
        if mode not in MODES:
            raise ValueError(f"unknown AGC mode {mode!r} (modes: "
                             f"{', '.join(MODES)})")
        return AGCConfig(
            sample_rate=sample_rate, mode=mode, threshold_db=threshold_db,
            slope_factor=slope_factor, stride=stride,
            window=max(1, int(WINDOW_TIMECONST * sample_rate)),
            delay=max(1, int(DELAY_TIMECONST * sample_rate)),
        )


@dataclasses.dataclass(frozen=True)
class AGCState:
    attack_avg: torch.Tensor       # [C] log-domain attack smoother (rise pole)
    decay_avg: torch.Tensor        # [C] log-domain decay envelope
    hang_count: torch.Tensor       # [C] int32 (scan-path field, carried as is)
    window_tail: torch.Tensor      # [C, window-1] previous log-magnitudes
    delay_line: torch.Tensor       # [C, delay] delayed complex signal
    attack_fall_avg: torch.Tensor  # [C] fall pole
    hang_tail: torch.Tensor | None = None  # [C, hang-1] coarse peak history
    #                                        ('long'; None otherwise)


def hang_window(cfg: AGCConfig) -> int:
    """The hang mode's held-max window on the coarse (stride) grid; 0 for
    the modes without hang."""
    decay_ms, use_hang = MODES[cfg.mode]
    if not use_hang:
        return 0
    return max(1, int((decay_ms / 1000.0) * cfg.sample_rate) // cfg.stride)


def agc_init(cfg: AGCConfig, channels: int, device) -> AGCState:
    floor = math.log10(MIN_CONSTANT)
    w = max(1, cfg.window // cfg.stride) if cfg.stride > 1 else cfg.window
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
