"""Goertzel tone detection: single-bin DFT power, the OOK (on/off keying)
detector and the CTCSS tone squelch (port of pebblesdr_tpu/ops/goertzel.py).

A Goertzel bin is a dot product with exp(-j 2 pi k n / N), so the stream is
framed into [C, F, N] and every bin of every frame is one complex matmul
against the DFT basis (goertzel_power, IEEE float32), non-integer k
included.  The OOK detector's per-frame envelopes, threshold decision and
asymmetric debounce are a recurrence over frames: on a CUDA device one
launch of csrc/recur.cu ook_scan (K6: one thread per channel carries the
peak, floor and mean envelopes, the decision and the two debounce
counters; the six threshold modes are template instances), on the CPU
ook_detect_plain, a Python loop over frames of the same float32 operations
on [C] tensors.  ook_detect.launches counts the kernel launches.

Neighbouring CTCSS tones sit 2.3-4 Hz apart, closer than one audio block's
DFT bins.  Per block the configured tone's and its two table neighbours'
single-bin DFT responses are de-rotated by the block-start phase of each
tone (advanced in closed form by 2 pi f blk / fs per block) and EWMA-ed as
complex values: coherent integration with a 0.25 s time constant, ~1-2 Hz
of noise bandwidth.  The squelch opens when the tone's integrated power
beats nb_ratio x both neighbours' and an absolute floor.  The K-block form
(ctcss_update_many) is one lower-triangular matmul (iir.ewma_tables).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import iir, short_chain
from pebblesdr_tpu_torch.utils.precision import ieee_float32

SOURCE = "pebblesdr_tpu_torch/csrc/recur.cu"
# the lax.scan the kernel replaces (no Pallas kernel: a scan over frames)
REPLACES = "pebblesdr_tpu/ops/goertzel.py:375"

# DTMF: (low Hz, high Hz) per key (goertzel.h:194-230)
DTMF_FREQS = {
    "1": (697, 1209), "2": (697, 1336), "3": (697, 1477), "A": (697, 1633),
    "4": (770, 1209), "5": (770, 1336), "6": (770, 1477), "B": (770, 1633),
    "7": (852, 1209), "8": (852, 1336), "9": (852, 1477), "C": (852, 1633),
    "*": (941, 1209), "0": (941, 1336), "#": (941, 1477), "D": (941, 1633),
}

# CTCSS sub-audible squelch tones in Hz (goertzel.h:232-277)
CTCSS_TONES = [
    67.0, 69.3, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5, 94.8, 97.4,
    100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3, 131.8, 136.5,
    141.3, 146.2, 151.4, 156.7, 162.2, 167.9, 173.8, 179.9, 186.2, 192.8,
    203.5, 210.7, 218.1, 225.7, 233.6, 241.8, 250.3,
]


def dft_vectors(freqs_hz, sample_rate: float, n: int) -> np.ndarray:
    """[num_bins, n] complex64 DFT basis rows (non-integer k supported)."""
    freqs = np.atleast_1d(np.asarray(freqs_hz, np.float64))
    t = np.arange(n, dtype=np.float64)
    return np.exp(-2j * np.pi * freqs[:, None] * t[None, :]
                  / sample_rate).astype(np.complex64)


@dataclasses.dataclass(frozen=True, eq=False)
class CtcssConfig:
    tone_hz: float
    alpha: float             # per-block EWMA
    nb_ratio: float          # tone power vs the larger neighbour's
    min_power: float         # absolute floor (silence)
    basis_re: np.ndarray     # [3, blk] block-local DFT rows (tone, lo, hi)
    basis_im: np.ndarray
    dphi: np.ndarray         # [3] phase advance per block (rad)

    @staticmethod
    def make(tone_hz: float, sample_rate: float, blk: int,
             tau_s: float = 0.25, nb_ratio: float = 4.0,
             min_power: float = 1e-5) -> "CtcssConfig":
        tones = sorted(CTCSS_TONES)
        if tone_hz not in tones:
            raise ValueError(f"{tone_hz} Hz is not a CTCSS table tone")
        i = tones.index(tone_hz)
        lo = tones[i - 1] if i > 0 else tone_hz - 2.3
        hi = tones[i + 1] if i + 1 < len(tones) else tone_hz + 4.0
        freqs = [tone_hz, lo, hi]
        basis = dft_vectors(freqs, sample_rate, blk)
        dphi = (2.0 * np.pi * np.asarray(freqs, np.float64) * blk
                / sample_rate) % (2.0 * np.pi)
        return CtcssConfig(tone_hz=tone_hz,
                           alpha=float(np.exp(-(blk / sample_rate) / tau_s)),
                           nb_ratio=nb_ratio, min_power=min_power,
                           basis_re=basis.real.astype(np.float32),
                           basis_im=basis.imag.astype(np.float32),
                           dphi=dphi.astype(np.float32))


@dataclasses.dataclass(frozen=True)
class CtcssState:
    iq: torch.Tensor     # [C, 3, 2] EWMA of the de-rotated (re, im) responses
    phase: torch.Tensor  # [3] block-start phase of each tone (rad)


def ctcss_init(channels: int, device) -> CtcssState:
    return CtcssState(
        iq=torch.zeros(channels, 3, 2, dtype=torch.float32, device=device),
        phase=torch.zeros(3, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=16)
def _tables(cfg: CtcssConfig, device: torch.device):
    """(basis_re.T, basis_im.T [blk, 3], dphi [3]) on the device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cfg.basis_re.T, cfg.basis_im.T, cfg.dphi))


def _ctcss_resp(cfg: CtcssConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio [..., blk] real -> block responses [..., 3, 2] (re, im)."""
    bre, bim, _ = _tables(cfg, audio.device)
    blk = audio.shape[-1]
    return torch.stack([torch.matmul(audio, bre) / blk,
                        torch.matmul(audio, bim) / blk], dim=-1)


def _ctcss_open(cfg: CtcssConfig, iq: torch.Tensor) -> torch.Tensor:
    p = torch.sum(iq * iq, dim=-1)                            # [..., 3]
    p_tone = p[..., 0]
    return ((p_tone > cfg.nb_ratio * torch.maximum(p[..., 1], p[..., 2]))
            & (p_tone > cfg.min_power))


def _rot(iq: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate (re, im) pairs by -phase, given cos and sin of the phase."""
    re = iq[..., 0] * cos + iq[..., 1] * sin
    im = iq[..., 1] * cos - iq[..., 0] * sin
    return torch.stack([re, im], dim=-1)


def ctcss_update(cfg: CtcssConfig, state: CtcssState, audio: torch.Tensor):
    """One block: audio [C, blk] real -> (state', open [C] bool)."""
    resp = _rot(_ctcss_resp(cfg, audio), torch.cos(state.phase)[None],
                torch.sin(state.phase)[None])
    a = cfg.alpha
    iq = a * state.iq + (1.0 - a) * resp
    dphi = _tables(cfg, audio.device)[2]
    phase = torch.remainder(state.phase + dphi, 2.0 * math.pi)
    return CtcssState(iq=iq, phase=phase), _ctcss_open(cfg, iq)


def ctcss_update_many(cfg: CtcssConfig, state: CtcssState,
                      audio: torch.Tensor):
    """K blocks at once: audio [K, C, blk] -> (state', open [K, C] bool).
    Block k's responses are de-rotated by phase + k dphi; the cross-block
    EWMA is the closed-form lower-triangular matmul."""
    k = audio.shape[0]
    resp = _ctcss_resp(cfg, audio)                            # [K, C, 3, 2]
    dphi = _tables(cfg, audio.device)[2]
    ks = torch.arange(k, dtype=torch.float32, device=audio.device)
    ang = state.phase[None, :] + ks[:, None] * dphi[None, :]  # [K, 3]
    resp = _rot(resp, torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :])
    lmat, seed = iir.ewma_tables(k, cfg.alpha, audio.device)
    iq = (torch.matmul(lmat, resp.reshape(k, -1)).reshape(resp.shape)
          + seed[:, None, None, None] * state.iq[None])
    phase = torch.remainder(state.phase + k * dphi, 2.0 * math.pi)
    return CtcssState(iq=iq[-1], phase=phase), _ctcss_open(cfg, iq)


# ------------------------------------------------------- Goertzel power

@functools.lru_cache(maxsize=32)
def _basis_dev(basis_bytes: bytes, shape: tuple, device: torch.device):
    """A [B, N] complex64 basis as its [N, B] transpose on the device."""
    b = np.frombuffer(basis_bytes, np.complex64).reshape(shape)
    return torch.from_numpy(b.T.copy()).to(device)


@ieee_float32()
def goertzel_power(x: torch.Tensor, basis: np.ndarray) -> torch.Tensor:
    """x [C, F, N] real or complex frames, basis [B, N] complex64 (numpy,
    dft_vectors) -> power [C, F, B] float32.  Normalized so a
    unit-amplitude tone exactly on a bin gives power 1.0."""
    b = np.ascontiguousarray(basis, np.complex64)
    resp = torch.matmul(x.to(torch.complex64),
                        _basis_dev(b.tobytes(), b.shape, x.device)
                        ) / x.shape[-1]
    return resp.abs() ** 2


def frame_stream(x: torch.Tensor, frame: int) -> torch.Tensor:
    """[C, N] -> [C, N // frame, frame] (N must divide)."""
    c, n = x.shape
    return x.reshape(c, n // frame, frame)


# N estimation (goertzel.h:103-104, goertzel.cpp:438-455)

def est_n_for_shortest_bit(ms_shortest_bit: float, sample_rate: float) -> int:
    """Largest usable integration length: N shorter than the shortest
    keying element (120 wpm morse: a 10 ms dot at 8 ksps -> N <= 80)."""
    return max(1, int(ms_shortest_bit * 1e-3 * sample_rate))


def est_n_for_bin_bandwidth(bandwidth_hz: float, sample_rate: float) -> int:
    """Smallest N whose bin (fs / N wide) is as narrow as bandwidth_hz."""
    return max(1, int(round(sample_rate / bandwidth_hz)))


def choose_n(sample_rate: float, ms_shortest_bit: float | None = None,
             bandwidth_hz: float | None = None) -> int:
    """Integration length from the timing and selectivity constraints: as
    narrow a bin as the bandwidth asks for, capped so no keying element is
    smeared; with one constraint given, that one decides."""
    n_max = (est_n_for_shortest_bit(ms_shortest_bit, sample_rate)
             if ms_shortest_bit is not None else None)
    n_min = (est_n_for_bin_bandwidth(bandwidth_hz, sample_rate)
             if bandwidth_hz is not None else None)
    if n_min is None and n_max is None:
        raise ValueError("need ms_shortest_bit and/or bandwidth_hz")
    if n_min is None:
        return n_max
    if n_max is None:
        return n_min
    return min(n_min, n_max)


def compare_bin_freqs(tone_hz: float, n: int, sample_rate: float,
                      delta_frac: float = 0.75):
    """(low, high) compare-bin frequencies at tone +- delta_frac x the bin
    width (goertzel.cpp:503-506 places them at +-0.75)."""
    bw = sample_rate / n
    return tone_hz - delta_frac * bw, tone_hz + delta_frac * bw


# --------------------------------------------------------- OOK detector

THRESHOLD_MODES = ("compare", "peak", "average", "min_max", "manual",
                   "noise")                     # recur.cu's OokStep<0-5>


@dataclasses.dataclass(frozen=True)
class OOKConfig:
    """The on/off decision's threshold scheme (GoertzelOOK's TH_* family,
    goertzel.h:84): compare (main power > compare_ratio x the mean of the
    two off-tone bins), peak (EWMA peak and floor envelopes: mark above
    floor + 0.67 delta, space below floor + 0.33 delta, hysteresis
    between), average (main > avg_ratio x the running mean), min_max (one
    threshold at floor + 0.6 delta, gated on peak > min_max_snr x floor),
    manual (a fixed power), noise (main > noise_snr x a floor that learns
    only during space).  attack_frames / decay_frames: the asymmetric
    debounce (goertzel.cpp:531-556)."""
    mode: str
    compare_ratio: float
    avg_ratio: float
    manual_threshold: float
    noise_snr: float
    attack_frames: int
    decay_frames: int
    attack_alpha: float    # envelope EWMA, toward the signal
    decay_alpha: float     # envelope EWMA, away from it
    avg_alpha: float       # running-mean EWMA (average mode)
    min_max_snr: float     # least peak / floor ratio for min_max

    @staticmethod
    def make(mode: str = "peak", compare_ratio: float = 4.0,
             avg_ratio: float = 1.5, manual_threshold: float = 1e-3,
             noise_snr: float = 4.0, attack_frames: int = 2,
             decay_frames: int = 2, attack_alpha: float = 0.4,
             decay_alpha: float = 0.02, avg_alpha: float = 0.01,
             min_max_snr: float = 4.0) -> "OOKConfig":
        if mode not in THRESHOLD_MODES:
            raise ValueError(f"mode {mode!r} not in {THRESHOLD_MODES}")
        return OOKConfig(mode=mode, compare_ratio=compare_ratio,
                         avg_ratio=avg_ratio,
                         manual_threshold=manual_threshold,
                         noise_snr=noise_snr, attack_frames=attack_frames,
                         decay_frames=decay_frames,
                         attack_alpha=attack_alpha, decay_alpha=decay_alpha,
                         avg_alpha=avg_alpha, min_max_snr=min_max_snr)

    def ratio(self) -> float:
        """The mode's one parameter (compare_ratio, avg_ratio, min_max_snr,
        manual_threshold or noise_snr; unused by peak)."""
        return {"compare": self.compare_ratio, "average": self.avg_ratio,
                "min_max": self.min_max_snr, "manual": self.manual_threshold,
                "noise": self.noise_snr}.get(self.mode, 0.0)

    def consts(self) -> dict:
        """The step's float32 constants as the JAX step rounds them: each
        Python-float product folded in float64 first (0.1 x decay_alpha,
        1 - avg_alpha), then cast once."""
        f = np.float32
        return {"aa": f(self.attack_alpha), "da": f(self.decay_alpha),
                "fa": f(0.1 * self.decay_alpha),
                "keep": f(1.0 - self.avg_alpha), "va": f(self.avg_alpha),
                "ratio": f(self.ratio())}


@dataclasses.dataclass(frozen=True)
class OOKState:
    peak: torch.Tensor     # [C] EWMA peak power envelope
    floor: torch.Tensor    # [C] EWMA floor / noise power envelope
    avg: torch.Tensor      # [C] running mean power
    state: torch.Tensor    # [C] bool current mark/space decision
    attack: torch.Tensor   # [C] int32 consecutive on-frames while off
    decay: torch.Tensor    # [C] int32 consecutive off-frames while on


def ook_init(channels: int, device) -> OOKState:
    def full(v, dtype=torch.float32):
        return torch.full((channels,), v, dtype=dtype, device=device)

    return OOKState(peak=full(1e-6), floor=full(1e-6), avg=full(1e-6),
                    state=full(False, torch.bool),
                    attack=full(0, torch.int32), decay=full(0, torch.int32))


def _raw_decision(cfg: OOKConfig, k: dict, pm, pl, ph, peak, floor, avg,
                  last):
    """The per-frame threshold decision of one mode (no debounce); k:
    cfg.consts() as tensors."""
    if cfg.mode == "compare":
        return pm > k["ratio"] * torch.clamp_min((pl + ph) * 0.5, 1e-18)
    if cfg.mode == "peak":
        delta = peak - floor
        up = floor + 0.67 * delta
        down = floor + 0.33 * delta
        return torch.where(pm >= up, True, torch.where(pm <= down, False,
                                                       last))
    if cfg.mode == "average":
        return pm > k["ratio"] * avg
    if cfg.mode == "min_max":
        valid = peak > k["ratio"] * torch.clamp_min(floor, 1e-18)
        return valid & (pm > floor + 0.6 * (peak - floor))
    if cfg.mode == "manual":
        return pm > k["ratio"]
    return pm > k["ratio"] * torch.clamp_min(floor, 1e-18)       # noise


def ook_detect_plain(cfg: OOKConfig, state: OOKState, power_main,
                     power_low=None, power_high=None):
    """Plain version of ook_detect: one step per frame over [C, F] powers,
    in float32 on [C] tensors.  Same arguments and results."""
    dev = power_main.device
    if power_low is None or power_high is None:
        power_low = power_high = torch.zeros_like(power_main)
    k = {key: torch.tensor(v, dtype=torch.float32, device=dev)
         for key, v in cfg.consts().items()}
    peak, floor, avg = state.peak, state.floor, state.avg
    st, att, dec = state.state, state.attack, state.decay
    zero = torch.zeros_like(att)
    marks = []
    for pm, pl, ph in zip(power_main.unbind(1), power_low.unbind(1),
                          power_high.unbind(1)):
        peak2 = torch.where(pm > peak, peak + k["aa"] * (pm - peak),
                            peak + k["da"] * (pm - peak))
        floor2 = torch.where(pm < floor, floor + k["aa"] * (pm - floor),
                             floor + k["fa"] * (pm - floor))
        if cfg.mode == "noise":
            floor2 = torch.where(st, floor, floor2)
        avg2 = k["keep"] * avg + k["va"] * pm
        raw = _raw_decision(cfg, k, pm, pl, ph, peak2, floor2, avg2, st)
        att2 = torch.where(raw & ~st, att + 1, zero)
        dec2 = torch.where(~raw & st, dec + 1, zero)
        turn_on = att2 >= cfg.attack_frames
        turn_off = dec2 >= cfg.decay_frames
        st = torch.where(turn_on, True, torch.where(turn_off, False, st))
        att = torch.where(turn_on, zero, att2)
        dec = torch.where(turn_off, zero, dec2)
        peak, floor, avg = peak2, floor2, avg2
        marks.append(st)
    c = power_main.shape[0]
    marks = (torch.stack(marks, dim=1) if marks
             else torch.zeros(c, 0, dtype=torch.bool, device=dev))
    return OOKState(peak=peak, floor=floor, avg=avg, state=st, attack=att,
                    decay=dec), marks


def ook_margin(cfg: OOKConfig, state: OOKState, power_main, power_low,
               power_high) -> float:
    """The smallest distance of a frame's main power from the threshold(s)
    its mode compares it with (both for peak, and min_max's gate),
    relative to the larger of the two, along the plain path in float64:
    a decision whose margin is below float32's rounding may go either way
    in two orders of the same float32 operations.  numpy; inputs [C, F]."""
    pm, pl, ph = (np.asarray(v.detach().cpu(), np.float64)
                  for v in (power_main, power_low, power_high))
    peak, floor, avg = (np.asarray(v.detach().cpu(), np.float64)
                        for v in (state.peak, state.floor, state.avg))
    st = np.asarray(state.state.detach().cpu())
    att = np.asarray(state.attack.detach().cpu())
    dec = np.asarray(state.decay.detach().cpu())
    a, d, r = cfg.attack_alpha, cfg.decay_alpha, cfg.ratio()
    worst = np.inf

    def gap(u, v):
        return np.abs(u - v) / np.maximum(np.maximum(np.abs(u), np.abs(v)),
                                          1e-30)

    for t in range(pm.shape[1]):
        p = pm[:, t]
        peak = np.where(p > peak, peak + a * (p - peak),
                        peak + d * (p - peak))
        floor2 = np.where(p < floor, floor + a * (p - floor),
                          floor + 0.1 * d * (p - floor))
        floor = np.where(st, floor, floor2) if cfg.mode == "noise" else floor2
        avg = (1.0 - cfg.avg_alpha) * avg + cfg.avg_alpha * p
        if cfg.mode == "compare":
            thr = [r * np.maximum((pl[:, t] + ph[:, t]) * 0.5, 1e-18)]
        elif cfg.mode == "peak":
            thr = [floor + 0.67 * (peak - floor),
                   floor + 0.33 * (peak - floor)]
        elif cfg.mode == "average":
            thr = [r * avg]
        elif cfg.mode == "min_max":
            thr = [floor + 0.6 * (peak - floor)]
            worst = min(worst, float(gap(peak, r * np.maximum(floor, 1e-18))
                                     .min()))
        elif cfg.mode == "manual":
            thr = [np.full_like(p, r)]
        else:
            thr = [r * np.maximum(floor, 1e-18)]
        worst = min(worst, min(float(gap(p, u).min()) for u in thr))
        if cfg.mode == "peak":
            raw = np.where(p >= thr[0], True, np.where(p <= thr[1], False,
                                                       st))
        elif cfg.mode == "min_max":
            raw = (peak > r * np.maximum(floor, 1e-18)) & (p > thr[0])
        else:
            raw = p > thr[0]
        att2 = np.where(raw & ~st, att + 1, 0)
        dec2 = np.where(~raw & st, dec + 1, 0)
        on, off = att2 >= cfg.attack_frames, dec2 >= cfg.decay_frames
        st = np.where(on, True, np.where(off, False, st))
        att, dec = np.where(on, 0, att2), np.where(off, 0, dec2)
    return worst


class _OokConsts(ctypes.Structure):
    """recur.cu's OokConsts: the step's constants, as the kernel reads
    them."""
    _fields_ = [(name, ctypes.c_float) for name in ("aa", "da", "fa", "keep",
                                                     "va", "ratio")] + [
        ("attack_frames", ctypes.c_int), ("decay_frames", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def ook_consts(cfg: OOKConfig) -> tuple:
    """The kernel's view of a configuration, built once per (frozen,
    hashable) config: (the mode's index, the OokConsts structure holding
    cfg.consts() and the debounce lengths, its address)."""
    k = cfg.consts()
    st = _OokConsts(*(float(k[name]) for name in ("aa", "da", "fa", "keep",
                                                   "va", "ratio")),
                    int(cfg.attack_frames), int(cfg.decay_frames))
    return THRESHOLD_MODES.index(cfg.mode), st, ctypes.addressof(st)


@functools.cache
def _lib():
    """csrc/recur.cu, built at first use, with ook_scan's C signature."""
    lib = build.load("recur")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.recur_ook_scan.restype = i
    # the powers (pointer, channel and frame strides, bins), the state in
    # (6), the marks, the state' block, the stream
    lib.recur_ook_scan.argtypes = ([i, i, p, i, i, p, q, i, i] + [p] * 6
                                   + [p, p, p])
    lib.recur_error_string.restype = ctypes.c_char_p
    lib.recur_error_string.argtypes = [i]
    return lib


@functools.cache
def _ook_fn():
    """The bound C entry (recur_ook_scan)."""
    return _lib().recur_ook_scan


_STATE_DTYPES = (torch.float32,) * 3 + (torch.bool, torch.int32, torch.int32)


def ook_detect(cfg: OOKConfig, state: OOKState, power_main: torch.Tensor,
               power_low: torch.Tensor | None = None,
               power_high: torch.Tensor | None = None):
    """OOK decision per frame (GoertzelOOK::processResult,
    goertzel.cpp:676-820) with the configured threshold mode and the
    asymmetric attack/decay debounce.  power_*: [C, F] main and low/high
    compare-bin powers (low and high read in compare mode only; None: zero
    powers).  The CUDA kernel (csrc/recur.cu ook_scan, one launch, the
    powers read where they lie: ops/short_chain.py ook_input) for CUDA
    tensors, ook_detect_plain for CPU tensors.  Returns (state', marks
    [C, F] bool)."""
    dev = power_main.device
    if dev.type == "cpu":
        return ook_detect_plain(cfg, state, power_main, power_low,
                                power_high)
    if dev.type != "cuda":
        raise ValueError(f"ook_detect runs on cuda or cpu, not {dev}")
    return ook_launch(_ook_fn(), cfg, state, power_main, power_low,
                      power_high)


def ook_launch(fn, cfg: OOKConfig, state: OOKState, pm: torch.Tensor,
               pl: torch.Tensor | None, ph: torch.Tensor | None):
    """ook_detect's CUDA path through the C entry fn (a build of
    recur_ook_scan): the checks, the marks and one allocation for the
    state', one launch."""
    shape = pm.shape
    idx = pm.get_device()
    for v in (pm, pl, ph):
        if v is not None and (v.dtype is not torch.float32 or v.shape != shape
                              or v.get_device() != idx or v.dim() != 2):
            raise ValueError(f"ook_detect: powers must be [C, F] float32 on "
                             f"{pm.device}, got {v.dtype} {tuple(v.shape)} "
                             f"on {v.device}")
    c, f = shape
    rows = (c,)
    leaves = (state.peak, state.floor, state.avg, state.state, state.attack,
              state.decay)
    for v, dtype in zip(leaves, _STATE_DTYPES):
        if (v.dtype is not dtype or v.shape != rows or v.get_device() != idx
                or not v.is_contiguous()):
            raise ValueError(f"ook_detect: the state must be contiguous [C] "
                             f"tensors on {pm.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if 4 * c * f >= 2 ** 31:
        raise ValueError(f"ook_detect: [{c}, {f}] is too large for one "
                         f"launch")
    mode, _, consts = ook_consts(cfg)
    p, cs, fs, bins = short_chain.ook_input(pm, pl, ph, mode == 0)
    marks = torch.empty(c, f, dtype=torch.bool, device=pm.device)
    # state': six [C] rows of 4-byte words (peak, floor, avg; attack,
    # decay; the decisions' bytes at the start of the sixth)
    words = torch.empty(6, c, dtype=torch.float32, device=pm.device)
    err = fn(idx, mode, consts, c, f, p.data_ptr(), cs, fs, bins,
             leaves[0].data_ptr(), leaves[1].data_ptr(),
             leaves[2].data_ptr(), leaves[3].data_ptr(), leaves[4].data_ptr(),
             leaves[5].data_ptr(), marks.data_ptr(), words.data_ptr(),
             short_chain.raw_stream(idx))
    if err:
        raise RuntimeError(f"ook_detect kernel launch failed: CUDA error "
                           f"{err} ({_lib().recur_error_string(err).decode()})")
    ook_detect.launches += 1
    peak, floor, avg, att, dec, st = words.unbind(0)
    return (OOKState(peak=peak, floor=floor, avg=avg,
                     state=st.view(torch.bool)[:c],
                     attack=att.view(torch.int32),
                     decay=dec.view(torch.int32)), marks)


ook_detect.launches = 0   # CUDA kernel launches (the plain path never counts)
