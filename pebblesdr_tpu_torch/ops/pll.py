"""Carrier recovery: the per-sample second-order loop and its chunked form
(hand-written CUDA recurrences), and the open-loop trackers (no per-sample
loop) for the 19 kHz WFM pilot and RDS's BPSK subcarrier.

Port of pebblesdr_tpu/ops/pll.py.

The closed loops: pll_run (the per-sample loop, pll.pll_run: the RDS "scan"
Costas carrier, SAM's "scan" and short blocks, NFM "pll") and
pll_run_blockwise (the loop at the chunk rate over coherent chunk phasors:
SAM's smooth="loop", the second stage of pll_run_aimed).  Each loop carries
three floats per channel from sample to sample, so on a CUDA tensor it runs
as one launch of a recurrence kernel (csrc/recur.cu's loop kernel, one
chain thread per channel: pll_scan, four phase detectors; pll_chunk_scan at
the chunk rate; its plan is ops/short_chain.py loop_plan), and
on a CPU tensor as its plain version (pll_scan_plain, pll_chunk_scan_plain:
a Python loop over time of the same float32 arithmetic on [C] tensors).
pll_scan.launches / pll_chunk_scan.launches count the kernel launches
(pll_scan.detector_launches per detector).

The open pilot, per chunk of L samples: (1) a Hann-windowed DFT bin at the
pilot frequency gives one phasor (a matmul; the window is the pilot
bandpass); (2) the conj product of successive chunk phasors measures the
frequency deviation, smoothed by an EWMA in closed form; (3) a cumsum
integrates it into a phase; (4) the residual phasor, EWMA-smoothed, gives
the remaining phase offset and the lock level.  The per-sample pilot phase
is linear within each chunk: phase(fL + t) = p0[f] + wf[f] t
(pilot_open_run builds it per sample for the stereo tail without K2).
Every matmul is IEEE float32 (the JAX package asks Precision.HIGHEST: bf16
EWMA matmuls bias the loops).  The squaring loop (CostasOpenConfig, costas_open_run) and
SAM's two-stage aimed loop (pll_run_aimed, with the open stage-2 smoother
or the chunked loop) are scan-free around their loops likewise.
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

TWO_PI = 2.0 * math.pi
DETECTORS = ("atan2", "cross", "costas", "pilot")   # recur.cu's det 0-3
SOURCE = "pebblesdr_tpu_torch/csrc/recur.cu"
# the lax.scan each kernel replaces (no Pallas kernel: a per-sample scan)
REPLACES = {"pll_scan": "pebblesdr_tpu/ops/pll.py:116",
            "pll_chunk_scan": "pebblesdr_tpu/ops/pll.py:182"}


@dataclasses.dataclass(frozen=True)
class PilotOpenConfig:
    freq_center: float        # rad/sample (the 19 kHz ramp)
    dev_max: float            # rad/sample clamp on the frequency estimate
    chunk: int = 256
    bw_hz: float = 10.0       # loop bandwidth
    sample_rate: float = 0.0  # the EWMA alphas follow the chunk actually used


def make_pilot_open_config(sample_rate: float, pilot_hz: float = 19000.0,
                           range_hz: float = 100.0, bw_hz: float = 10.0,
                           chunk: int = 256) -> PilotOpenConfig:
    wc = TWO_PI * pilot_hz / sample_rate
    return PilotOpenConfig(freq_center=wc,
                           dev_max=TWO_PI * range_hz / sample_rate,
                           chunk=chunk, bw_hz=bw_hz,
                           sample_rate=float(sample_rate))


@dataclasses.dataclass(frozen=True)
class PilotOpenState:
    z_prev: torch.Tensor  # [C] complex64: previous chunk phasor (ramp-referenced)
    dw: torch.Tensor      # [C] f32: frequency deviation estimate, rad/sample
    psi: torch.Tensor     # [C] f32: integrated deviation phase at the next chunk
    r: torch.Tensor       # [C] complex64: smoothed residual phasor
    base: torch.Tensor    # [C] f32: pilot ramp phase at the next sample (mod 2 pi)


def pilot_open_init(channels: int, device) -> PilotOpenState:
    def zeros(dtype):
        return torch.zeros(channels, dtype=dtype, device=device)

    return PilotOpenState(z_prev=zeros(torch.complex64),
                          dw=zeros(torch.float32), psi=zeros(torch.float32),
                          r=zeros(torch.complex64), base=zeros(torch.float32))


def _ewma_closed(prev: torch.Tensor, p: torch.Tensor, a: float) -> torch.Tensor:
    """y_k = a y_{k-1} + (1-a) p_k over the trailing axis of p [C, K], seeded
    by prev [C], as one [K, K] matmul.  Real or complex."""
    lmat, seed = iir.ewma_tables(p.shape[-1], float(a), p.device)
    lmat = lmat.T
    if p.is_complex():
        re = torch.matmul(p.real, lmat) + prev.real[..., None] * seed
        im = torch.matmul(p.imag, lmat) + prev.imag[..., None] * seed
        return torch.complex(re, im)
    return torch.matmul(p, lmat) + prev[..., None] * seed


@functools.lru_cache(maxsize=16)
def _chunk_tables(wc: float, ell: int, f: int, device: torch.device):
    """The chunk-DFT matrix [L, 2] (Hann window x pilot ramp, re/im), the
    per-chunk ramp phase (cos, sin, value) [F] and the in-chunk index [L]."""
    t_in = np.arange(ell, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * t_in / ell)   # periodic Hann
    win = win / win.sum()
    mat = win * np.exp(-1j * wc * t_in)
    ramp_f = np.mod(wc * ell * np.arange(f, dtype=np.float64), 2 * np.pi)
    as_dev = functools.partial(torch.as_tensor, device=device)
    return (as_dev(np.stack([mat.real, mat.imag], axis=1).astype(np.float32)),
            as_dev(np.cos(ramp_f).astype(np.float32)),
            as_dev(np.sin(ramp_f).astype(np.float32)),
            as_dev(ramp_f.astype(np.float32)),
            as_dev(t_in.astype(np.float32)))


def _alpha(cfg: PilotOpenConfig, ell: int) -> float:
    """EWMA coefficient at the chunk actually used (keeps the configured loop
    bandwidth when the chunk adapts to the block length)."""
    fs = cfg.sample_rate or (TWO_PI * 19000.0 / cfg.freq_center)
    return math.exp(-TWO_PI * cfg.bw_hz * ell / fs)


def pilot_open_core(cfg: PilotOpenConfig, state: PilotOpenState,
                    raw: torch.Tensor, chunk: int | None = None):
    """Track the pilot in the channel-major composite raw [C, N] float32.

    Returns (state', (p0 [C, F], wf [C, F], t_in [L]), level [C, F])."""
    c, n = raw.shape
    ell = int(chunk or cfg.chunk)
    if n % ell:
        raise ValueError(f"composite of {n} samples is not a whole number of "
                         f"{ell}-sample pilot chunks")
    f = n // ell
    tabs = _chunk_tables(cfg.freq_center, ell, f, raw.device)
    zz = torch.matmul(raw.reshape(c, f, ell), tabs[0])      # [C, F, 2]
    z = torch.complex(zz[..., 0], zz[..., 1])
    return _pilot_open_post(cfg, state, z, ell, n, _alpha(cfg, ell), *tabs[1:])


def pilot_open_core_tm(cfg: PilotOpenConfig, state: PilotOpenState,
                       raw_t: torch.Tensor, chunk: int | None = None):
    """pilot_open_core for the time-major composite raw_t [N, C] that the
    front end's discriminator emits: the chunk-DFT matmul runs on the
    time-major rows, and only the [C, F] phasors are transposed."""
    n, c = raw_t.shape
    ell = int(chunk or cfg.chunk)
    if n % ell:
        raise ValueError(f"composite of {n} samples is not a whole number of "
                         f"{ell}-sample pilot chunks")
    f = n // ell
    tabs = _chunk_tables(cfg.freq_center, ell, f, raw_t.device)
    # [F, L, C] x [L, 2] -> [F, C, 2] -> [C, F, 2]
    zz = torch.matmul(raw_t.reshape(f, ell, c).transpose(1, 2), tabs[0])
    zz = zz.transpose(0, 1)
    z = torch.complex(zz[..., 0].contiguous(), zz[..., 1].contiguous())
    return _pilot_open_post(cfg, state, z, ell, n, _alpha(cfg, ell), *tabs[1:])


def _pilot_open_post(cfg, state, z, ell, n, alpha, rotf_c, rotf_s, ramp_d,
                     tin_d):
    """Chunk phasors z [C, F] -> smoothed frequency/phase params."""
    wc = cfg.freq_center
    rotf = torch.complex(rotf_c, -rotf_s)                 # e^{-j ramp_f}
    z = z * rotf[None, :] * torch.exp(-1j * state.base)[:, None]

    # frequency: conj product between successive chunk phasors
    zprev = torch.cat([state.z_prev[:, None], z[:, :-1]], dim=1)
    d = z * torch.conj(zprev)
    dwm = torch.clamp(torch.atan2(d.imag, d.real) / ell,
                      -cfg.dev_max, cfg.dev_max)
    dw = _ewma_closed(state.dw, dwm, alpha)               # [C, F]

    # integrated deviation phase at chunk starts (exclusive cumsum, seeded)
    cs = torch.cumsum(dw, dim=-1)
    psi = state.psi[:, None] + ell * (cs - dw)            # [C, F]
    psi_next = state.psi + ell * cs[:, -1]

    # residual phasor, smoothed; its angle is the remaining phase offset
    rres = z * torch.exp(-1j * psi)
    r = _ewma_closed(state.r, rres, alpha)                # [C, F]
    ang = torch.atan2(r.imag, r.real)
    level = torch.abs(r)

    new_state = PilotOpenState(
        z_prev=z[:, -1], dw=dw[:, -1],
        psi=torch.remainder(psi_next + math.pi, TWO_PI) - math.pi,
        r=r[:, -1],
        base=torch.remainder(state.base + float(np.mod(wc * n, 2 * np.pi)),
                             TWO_PI))
    # +pi/2: "phase of e^{j psi}" -> the pilot ~= A sin(phase) convention
    p0 = state.base[:, None] + ramp_d[None, :] + psi + ang + (math.pi / 2.0)
    wf = wc + dw
    return new_state, (p0, wf, tin_d), level


def pilot_open_run(cfg: PilotOpenConfig, state: PilotOpenState,
                   raw: torch.Tensor, chunk: int | None = None):
    """pilot_open_core with the per-sample phase built from the chunk
    parameters: (state', phases [C, N], level [C, F])."""
    c, n = raw.shape
    new_state, (p0, wf, tin_d), level = pilot_open_core(cfg, state, raw,
                                                        chunk)
    phases = (p0[:, :, None] + wf[:, :, None] * tin_d[None, None, :]
              ).reshape(c, n)
    return new_state, phases, level


# ------------------------------------------------------ the closed loop

@dataclasses.dataclass(frozen=True)
class PLLConfig:
    """The second-order loop's gains and clamps: alpha = 2 zeta wn, beta =
    wn^2, wn = 2 pi BW / fs; the detector 'atan2' (four-quadrant, SAM and
    NFM), 'cross' (Im(z) sign(Re(z)), complex carriers), 'costas' (Re(z)
    Im(z) / amp^2, BPSK) or 'pilot' (a real pilot, Re(x) cos(phase))."""
    alpha: float
    beta: float
    freq_center: float   # radians/sample NCO center
    freq_lo: float       # radians/sample clamp
    freq_hi: float
    detector: str = "atan2"


def make_pll_config(sample_rate: float, bw_hz: float, zeta: float = 0.707,
                    center_hz: float = 0.0, range_hz: float = 1000.0,
                    detector: str = "atan2") -> PLLConfig:
    wn = TWO_PI * bw_hz / sample_rate
    norm = TWO_PI / sample_rate
    return PLLConfig(alpha=2.0 * zeta * wn, beta=wn * wn,
                     freq_center=center_hz * norm,
                     freq_lo=(center_hz - range_hz) * norm,
                     freq_hi=(center_hz + range_hz) * norm, detector=detector)


@dataclasses.dataclass(frozen=True)
class PLLState:
    phase: torch.Tensor  # [C] radians
    fdev: torch.Tensor   # [C] radians/sample deviation from freq_center
    amp: torch.Tensor    # [C] EWMA of |input| (detector gain normalization)


def pll_init(cfg: PLLConfig, channels: int, device) -> PLLState:
    def full(v):
        return torch.full((channels,), v, dtype=torch.float32, device=device)

    return PLLState(phase=full(0.0), fdev=full(0.0), amp=full(1.0))


def _wrap(a: torch.Tensor) -> torch.Tensor:
    """mod(a + pi, 2 pi) - pi in float32 (torch.remainder is jnp.mod's
    fmod-and-adjust)."""
    return torch.remainder(a + math.pi, TWO_PI) - math.pi


def _derotate(zr, zi, phase):
    """(Re, Im) of z e^{-j phase}, as the complex64 product computes it."""
    c, s = torch.cos(phase), torch.sin(phase)
    return zr * c + zi * s, zi * c - zr * s


def pll_scan_plain(x: torch.Tensor, phase: torch.Tensor, fdev: torch.Tensor,
                   amp: torch.Tensor, detector: str, alpha: float,
                   beta: float, wc: float, dev_lo: float, dev_hi: float):
    """Plain version of pll_scan: the loop of pll.pll_run, one step per
    sample over x [C, N] complex64, state [C] float32.  Returns (phase',
    fdev', amp', phases [C, N] (the phase used on each sample), freqs [C, N]
    (fdev' + wc))."""
    c, n = x.shape
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    mag = torch.hypot(xr, xi)
    phases, fdevs = [], []
    for xr_t, xi_t, mag_t in zip(xr.unbind(1), xi.unbind(1), mag.unbind(1)):
        amp2 = amp + 1e-3 * (mag_t - amp)
        if detector == "pilot":
            a_half = torch.clamp((math.pi / 4.0) * amp2, min=1e-6)
            err = xr_t * torch.cos(phase) / a_half
        else:
            zr, zi = _derotate(xr_t, xi_t, phase)
            if detector == "atan2":
                err = torch.atan2(zi, zr)
            elif detector == "costas":
                err = zr * zi / torch.clamp(amp2 * amp2, min=1e-12)
            else:                                          # cross
                err = zi * torch.sign(zr)
        fdev2 = torch.clamp(fdev + beta * err, dev_lo, dev_hi)
        phases.append(phase)
        fdevs.append(fdev2)
        phase = _wrap(phase + (wc + fdev2) + alpha * err)
        fdev, amp = fdev2, amp2
    return phase, fdev, amp, _columns(phases, c, x.device), \
        _columns(fdevs, c, x.device) + wc


def _columns(cols: list, c: int, device) -> torch.Tensor:
    """The [C] tensors of a plain loop's steps as the columns of [C, N]."""
    if not cols:
        return torch.empty(c, 0, dtype=torch.float32, device=device)
    return torch.stack(cols, dim=1)


def pll_chunk_scan_plain(z: torch.Tensor, phase: torch.Tensor,
                         fdev: torch.Tensor, amp: torch.Tensor, pilot: bool,
                         alpha: float, beta: float, dev_lo: float,
                         dev_hi: float):
    """Plain version of pll_chunk_scan: the loop of pll.pll_run_blockwise,
    one step per chunk phasor z [C, F] complex64 (gains at the chunk rate,
    fdev in radians per chunk).  Returns (phase', fdev', amp', offs [C, F]
    (the loop phase at each chunk), fdevs [C, F])."""
    c, f = z.shape
    zr_all, zi_all = z.real.contiguous(), z.imag.contiguous()
    mag = torch.hypot(zr_all, zi_all)
    offs, fdevs = [], []
    for zr_k, zi_k, mag_k in zip(zr_all.unbind(1), zi_all.unbind(1),
                                 mag.unbind(1)):
        amp2 = amp + 0.05 * (mag_k - amp)
        zr, zi = _derotate(zr_k, zi_k, phase)
        if pilot:                                      # zz * 1j
            zr, zi = -zi, zr
        err = torch.atan2(zi, zr)
        fdev2 = torch.clamp(fdev + beta * err, dev_lo, dev_hi)
        offs.append(phase)
        fdevs.append(fdev2)
        phase = _wrap(phase + fdev2 + alpha * err)
        fdev, amp = fdev2, amp2
    return (phase, fdev, amp, _columns(offs, c, z.device),
            _columns(fdevs, c, z.device))


@functools.cache
def _lib():
    """csrc/recur.cu, built at first use, with the loops' C signatures."""
    lib = build.load("recur")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.recur_pll_scan.restype = i
    lib.recur_pll_scan.argtypes = [i, i, p, i, i, f, f, f, f, f, p, p, p, p,
                                   p, p, p, p, p]
    lib.recur_pll_chunk_scan.restype = i
    lib.recur_pll_chunk_scan.argtypes = [i, i, p, i, i, f, f, f, f, p, p, p,
                                         p, p, p, p, p, p]
    lib.recur_probe.restype = i
    lib.recur_probe.argtypes = [i, i, i, p, p]
    lib.recur_probe_fed.restype = i
    lib.recur_probe_fed.argtypes = [i, i, i, p, i, p, p]
    lib.recur_loop_plan.restype = i
    lib.recur_loop_plan.argtypes = [i, p]
    lib.recur_error_string.restype = ctypes.c_char_p
    lib.recur_error_string.argtypes = [i]
    return lib


# the forms of csrc/recur.cu's chain probe (recur_probe's form 0-20; "iq
# lms" is K5's, ops/scanops.py auto_iq_balance; "ook <mode>" K6's in each
# threshold mode, ops/goertzel.py ook_detect; "sweep <mode>" K7's without
# pulses, core/siggen.py sweep; "anf <U>" K8's update of U samples,
# ops/scanops.py anf: its time per step is per update)
PROBE_FORMS = DETECTORS + (
    "chunk", "chunk pilot", "agc hang", "agc", "iq lms",
    "ook compare", "ook peak", "ook average", "ook min_max", "ook manual",
    "ook noise", "sweep single", "sweep repeat", "sweep repeat_reverse",
    "anf 1", "anf 16", "anf 1024")


# the forms whose chain probe is also fed from memory (recur_probe_fed):
# the register-only probe of these may fold steps on its constant inputs
# (K3's and K3c's fixed input folds |x| out of its loop).  K4's and K6's
# probe is one lane of the short-chain kernel's loop; K3's and K3c's runs
# the loop kernel's chain alone (Step::chain), with what reads no loop
# state precomputed in the pattern: their serial floor.
FED_FORMS = ("agc hang", "agc", "ook compare", "ook peak", "ook average",
             "ook min_max", "ook manual", "ook noise") + DETECTORS + (
                 "chunk", "chunk pilot")
# the probes' constants, as csrc/recur.cu recur_probe and recur_probe_fed
# pass them: the loops' (alpha, beta, wc, dev_lo, dev_hi), K3c's wc 0
PROBE_LOOP = {"pll": (0.0139, 9.6e-5, 0.03, -0.098, 0.098),
              "chunk": (0.1, 0.01, 0.0, -0.5, 0.5)}
LOOP_PATTERN = 1024      # frames of the K3 / K3c probes' patterns


def _loop_pattern(form: str, rng) -> np.ndarray:
    """The K3 / K3c fed probe's frames [n, 4] float32: re, im, amp' (the
    amp EWMA after the frame, run over the pattern until it settles) and
    q (costas max(amp'^2, 1e-12), pilot max((pi/4) amp', 1e-6), else 0),
    in float32 as the kernel computes them.  Every tone completes whole
    cycles over the pattern, so the loop runs on across its wrap."""
    n = LOOP_PATTERN
    k = np.arange(n)
    if form in ("chunk", "chunk pilot"):
        # a drifting tone: 16 cycles plus a swing of +-0.12 rad a chunk
        x = 0.5 * np.exp(1j * (2 * np.pi * 16 * k / n
                               + 20.0 * np.sin(2 * np.pi * k / n)))
    elif form == "pilot":
        # a real tone 5 cycles over the pattern: 0.0307 rad a sample
        x = 0.1 * np.sin(2 * np.pi * 5 * k / n + 0.4) + 0j
    else:
        # a complex tone 7 cycles (costas: 6, BPSK-keyed in 16-frame
        # symbols) over the pattern: 0.0430 (0.0368) rad a sample against
        # the probe's wc of 0.03
        cyc = 6 if form == "costas" else 7
        x = 0.5 * np.exp(1j * (2 * np.pi * cyc * k / n + 0.4))
        if form == "costas":
            x = x * np.repeat(np.where(rng.random(n // 16) < 0.5, -1, 1), 16)
    # noise 20 dB below the signal's power
    power = float(np.mean(np.abs(x) ** 2))
    if form == "pilot":
        x = x + np.sqrt(power / 100.0) * rng.standard_normal(n)
    else:
        sd = np.sqrt(power / 200.0)
        x = x + sd * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = x.astype(np.complex64)
    mag = np.hypot(x.real, x.imag).astype(np.float32)
    rate = np.float32(0.05 if form.startswith("chunk") else 1e-3)
    amp, amps = np.float32(1.0), np.empty(n, np.float32)
    for _ in range(8):
        for t in range(n):
            amp = np.float32(amp + rate * np.float32(mag[t] - amp))
            amps[t] = amp
    if form == "costas":
        q = np.maximum(amps * amps, np.float32(1e-12))
    elif form == "pilot":
        q = np.maximum(np.float32(math.pi / 4) * amps, np.float32(1e-6))
    else:
        q = np.zeros(n, np.float32)
    return np.stack([x.real, x.imag, amps, q], 1).astype(np.float32)


def probe_pattern(form: str) -> np.ndarray:
    """The fed probe's input pattern of one form (numpy float32, seeded):
    for the AGC, 512 log10 envelope samples of a keyed carrier (on runs of
    128 and 64 at ~-0.3, off runs of 256 and 64 at ~-2: the decay average
    rises, holds, then falls past the probe's 100-sample hang); for the OOK
    detector, 256 [main, low, high] frames (the layout goertzel_power
    writes and the kernel reads in place) keyed in runs cycling
    through 6, 10, 8, 12 and 7 frames (marks at 0.4 with a +-10 % fade,
    spaces near 1e-3, the compare bins near 2e-3 with a little of the
    keying on the low one), as tools/cells.py ook_powers makes them; for K3
    and K3c, 1024 [re, im, amp', q] frames (_loop_pattern) with noise 20
    dB down: atan2 and cross a complex tone 0.013 rad a sample off the
    probe's wc, costas a BPSK-keyed carrier, pilot a real tone near wc,
    the chunk forms the phasors of a drifting tone, so that the loop
    tracks and never sits at a fixed point."""
    if form not in FED_FORMS:
        raise ValueError(f"no fed probe for {form!r}")
    rng = np.random.default_rng(FED_FORMS.index(form))
    if form in DETECTORS or form.startswith("chunk"):
        return _loop_pattern(form, rng)
    if form.startswith("agc"):
        on = np.concatenate([np.ones(128), np.zeros(256), np.ones(64),
                             np.zeros(64)]).astype(bool)
        env = np.where(on, -0.3, -2.0) + 0.02 * rng.standard_normal(512)
        return env.astype(np.float32)
    n, runs = 256, (6, 10, 8, 12, 7)
    key = np.zeros(n, bool)
    t, j, mark = 0, 0, False
    while t < n:
        key[t:t + runs[j % 5]] = mark
        t, j, mark = t + runs[j % 5], j + 1, not mark
    fade = 1 + 0.1 * np.sin(np.arange(n) / 40.0)
    frames = np.stack([np.where(key, 0.4 * fade,
                                1e-3 * (1 + 0.5 * rng.random(n))),
                       0.03 * key + 2e-3 * (1 + 0.5 * rng.random(n)),
                       2e-3 * (1 + 0.5 * rng.random(n))], 1)
    return frames.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pattern_dev(form: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(probe_pattern(form)).to(device)


def chain_probe(form: str, steps: int, device, fed: bool = False
                ) -> torch.Tensor:
    """Launch the serial floor's probe of one recurrence form on a CUDA
    device: one thread runs `steps` steps of the form's dependent chain on
    inputs held in registers (no memory inside the loop); or, with fed=True
    (FED_FORMS only: recur_probe_fed, steps rounded up to a multiple of 4),
    one lane of the K4 / K6 kernel's own chain loop, or of the K3 / K3c
    loop kernel's chain alone (what reads no loop state precomputed in the
    pattern), its constants pinned, its inputs read from a small pattern
    (probe_pattern) staged in shared memory a register group ahead and its
    outputs stored there, as the kernel does.  Timed over many steps, its
    time per step is the latency of one step's chain, the recurrence
    kernels' serial floor (utils/roofline.py).  Returns its [1] float32
    output (a sum of the outputs, which keeps every step)."""
    dev = torch.device(device)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _lib()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if fed:
        if form not in FED_FORMS:
            raise ValueError(f"no fed probe for {form!r}")
        data = _pattern_dev(form, torch.device("cuda", index))
        err = lib.recur_probe_fed(index, PROBE_FORMS.index(form),
                                  -(-int(steps) // 4) * 4, data.data_ptr(),
                                  data.shape[0], out.data_ptr(), stream)
    else:
        err = lib.recur_probe(index, PROBE_FORMS.index(form), int(steps),
                              out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"chain probe launch failed: CUDA error {err} "
                           f"({lib.recur_error_string(err).decode()})")
    return out


def _check_loop(name: str, x: torch.Tensor, state) -> torch.device:
    """The loops' argument checks: x [C, N] complex64 and the [C] float32
    state on one CUDA device, contiguous."""
    dev = x.device
    if x.dim() != 2 or x.dtype != torch.complex64 or not x.is_contiguous():
        raise ValueError(f"{name}: input must be a contiguous [C, N] "
                         f"complex64 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    for v in state:
        if (v.device != dev or v.dtype != torch.float32
                or tuple(v.shape) != (x.shape[0],) or not v.is_contiguous()):
            raise ValueError(f"{name}: state must be contiguous [C] float32 "
                             f"tensors on {dev}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {tuple(x.shape)} is too large for one "
                         f"launch")
    return dev


def loop_launch(entry, name: str, x: torch.Tensor, state, flag: int,
                consts: tuple):
    """The CUDA path of pll_scan and pll_chunk_scan through a C entry of
    csrc/recur.cu (this build's recur_pll_scan / recur_pll_chunk_scan, or
    another build's of the same signature): the checks, the outputs'
    allocation and one launch on x's device and stream.  Returns (phase',
    fdev', amp', out0 [C, N], out1 [C, N]); counts nothing."""
    dev = _check_loop(name, x, state)
    c, n = x.shape
    outs = [torch.empty(c, n, dtype=torch.float32, device=dev)
            for _ in range(2)]
    st_out = [torch.empty(c, dtype=torch.float32, device=dev)
              for _ in range(3)]
    idx = x.get_device()
    err = entry(idx, flag, x.data_ptr(), c, n, *consts,
                *(v.data_ptr() for v in state), *(v.data_ptr() for v in outs),
                *(v.data_ptr() for v in st_out), short_chain.raw_stream(idx))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({_lib().recur_error_string(err).decode()})")
    return (*st_out, *outs)


def pll_scan(x: torch.Tensor, phase: torch.Tensor, fdev: torch.Tensor,
             amp: torch.Tensor, detector: str, alpha: float, beta: float,
             wc: float, dev_lo: float, dev_hi: float):
    """The per-sample loop: the CUDA kernel (csrc/recur.cu pll_scan, one
    launch) for CUDA tensors, pll_scan_plain for CPU tensors.  Same
    arguments and results as pll_scan_plain."""
    if detector not in DETECTORS:
        raise ValueError(f"unknown PLL detector {detector!r} (detectors: "
                         f"{', '.join(DETECTORS)})")
    if x.device.type == "cpu":
        return pll_scan_plain(x, phase, fdev, amp, detector, alpha, beta, wc,
                              dev_lo, dev_hi)
    if x.device.type != "cuda":
        raise ValueError(f"pll_scan runs on cuda or cpu, not {x.device}")
    ret = loop_launch(_lib().recur_pll_scan, "pll_scan", x,
                      (phase, fdev, amp), DETECTORS.index(detector),
                      (alpha, beta, wc, dev_lo, dev_hi))
    pll_scan.launches += 1
    pll_scan.detector_launches[detector] += 1
    return ret


def pll_chunk_scan(z: torch.Tensor, phase: torch.Tensor, fdev: torch.Tensor,
                   amp: torch.Tensor, pilot: bool, alpha: float, beta: float,
                   dev_lo: float, dev_hi: float):
    """The loop at the chunk rate: the CUDA kernel (csrc/recur.cu
    pll_chunk_scan, one launch) for CUDA tensors, pll_chunk_scan_plain for
    CPU tensors.  Same arguments and results as pll_chunk_scan_plain."""
    if z.device.type == "cpu":
        return pll_chunk_scan_plain(z, phase, fdev, amp, pilot, alpha, beta,
                                    dev_lo, dev_hi)
    if z.device.type != "cuda":
        raise ValueError(f"pll_chunk_scan runs on cuda or cpu, not "
                         f"{z.device}")
    ret = loop_launch(_lib().recur_pll_chunk_scan, "pll_chunk_scan", z,
                      (phase, fdev, amp), int(bool(pilot)),
                      (alpha, beta, dev_lo, dev_hi))
    pll_chunk_scan.launches += 1
    return ret


pll_scan.launches = 0            # CUDA kernel launches (the plain path never
pll_scan.detector_launches = dict.fromkeys(DETECTORS, 0)   # counts)
pll_chunk_scan.launches = 0


def _complex(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x.to(torch.complex64).contiguous()
    return torch.complex(x.float(), torch.zeros_like(x, dtype=torch.float32))


def pll_run(cfg: PLLConfig, state: PLLState, x: torch.Tensor):
    """Track the carrier in x [C, N] complex64 (a real x is taken as its
    complex form).  Returns (state', phases [C, N], freqs [C, N]): the NCO
    phase used to mix each sample and the loop frequency after it
    (absolute, radians/sample)."""
    ph, fr, am, phases, freqs = pll_scan(
        _complex(x), state.phase, state.fdev, state.amp, cfg.detector,
        cfg.alpha, cfg.beta, cfg.freq_center,
        cfg.freq_lo - cfg.freq_center, cfg.freq_hi - cfg.freq_center)
    return PLLState(phase=ph, fdev=fr, amp=am), phases, freqs


@functools.lru_cache(maxsize=16)
def _blockwise_tables(wc: float, chunk: int, f: int, device: torch.device):
    """The centre-frequency derotation of pll_run_blockwise: rot_in
    [chunk] = e^{-j wc t}, rot_chunk [F] = e^{-j wc chunk k}, and the
    in-chunk and chunk indices, float32 as the JAX package forms them."""
    t_in = torch.arange(chunk, dtype=torch.float32, device=device)
    k_idx = torch.arange(f, dtype=torch.float32, device=device)
    rot_in = torch.exp(-1j * (wc * t_in).to(torch.complex64))
    rot_chunk = torch.exp(-1j * ((wc * chunk) * k_idx).to(torch.complex64))
    return t_in, k_idx, rot_in, rot_chunk


def pll_run_blockwise(cfg: PLLConfig, state: PLLState, x: torch.Tensor,
                      chunk: int = 256):
    """The chunked loop: each chunk of x [C, N] derotated by the centre
    frequency and summed coherently into one phasor (an IEEE float32
    product), the loop run over the chunk phasors (pll_chunk_scan, gains
    rescaled to the chunk rate), and the per-sample phase rebuilt as the
    centre ramp + the chunk's loop phase + the in-chunk drift.  The
    'pilot' detector takes the real part of x; others a complex carrier.
    Returns (state', phases [C, N], freqs [C, N]) like pll_run."""
    c, n = x.shape
    if n % chunk:
        raise ValueError(f"pll_run_blockwise: {n} samples are not a whole "
                         f"number of {chunk}-sample chunks")
    f = n // chunk
    wc = cfg.freq_center
    t_in, k_idx, rot_in, rot_chunk = _blockwise_tables(wc, chunk, f,
                                                       x.device)
    xc = x.reshape(c, f, chunk)
    if cfg.detector == "pilot":
        xc = torch.complex(xc.real.float(), torch.zeros_like(xc.real.float()))
    z = torch.matmul(xc.to(torch.complex64), rot_in) * rot_chunk[None] / chunk
    ph, fr, am, offs, fdevs = pll_chunk_scan(
        z.contiguous(), state.phase, state.fdev * chunk, state.amp,
        cfg.detector == "pilot", cfg.alpha * chunk, cfg.beta * chunk * chunk,
        (cfg.freq_lo - wc) * chunk, (cfg.freq_hi - wc) * chunk)
    center_ramp = (wc * chunk) * k_idx[None, :, None] + wc * t_in[None, None]
    in_chunk = (fdevs / chunk)[:, :, None] * t_in[None, None]
    phases = (center_ramp + offs[:, :, None] + in_chunk).reshape(c, n)
    freqs = (wc + fdevs / chunk)[:, :, None].expand(c, f, chunk).reshape(c, n)
    return PLLState(phase=ph, fdev=fr / chunk, amp=am), phases, freqs


# --------------------------------------- open-loop BPSK carrier (RDS, squared)

@dataclasses.dataclass(frozen=True)
class CostasOpenConfig:
    """Scan-free BPSK carrier recovery by squaring: s = x^2 drops the +-1
    data and leaves a tone at twice the carrier offset.  Per chunk, the
    conj product of successive chunk means measures the squared-carrier
    frequency (EWMA in closed form), a cumsum integrates it, and the
    smoothed residual phasor's unwrapped angle corrects the phase; the
    carrier phase is half the tracked one (the pi ambiguity is a BPSK sign
    flip, which RDS's differential coding absorbs).  square=False tracks a
    plain carrier with the same machinery."""
    dev_max: float                # rad/sample clamp (carrier frequency)
    chunk: int = 64
    bw_hz: float = 30.0
    sample_rate: float = 19000.0


def make_costas_open_config(sample_rate: float, range_hz: float = 200.0,
                            bw_hz: float = 30.0, chunk: int = 64,
                            square: bool = True) -> CostasOpenConfig:
    """The chunk shrinks until range_hz is measurable without aliasing: the
    chunk-to-chunk product reads |w L| < pi (2 w squared)."""
    wmax = (2.0 if square else 1.0) * TWO_PI * range_hz / sample_rate
    chunk = int(chunk)
    while chunk > 1 and wmax * chunk >= 0.9 * math.pi:
        chunk //= 2
    return CostasOpenConfig(dev_max=TWO_PI * range_hz / sample_rate,
                            chunk=chunk, bw_hz=bw_hz,
                            sample_rate=float(sample_rate))


@dataclasses.dataclass(frozen=True)
class CostasOpenState:
    w2: torch.Tensor      # [C] f32 smoothed squared-carrier freq (rad/sample)
    psi: torch.Tensor     # [C] f32 integrated squared-carrier phase
    r: torch.Tensor       # [C] complex64 smoothed residual phasor
    ang: torch.Tensor     # [C] f32 unwrapped residual angle
    z_prev: torch.Tensor  # [C] complex64 previous chunk phasor


def costas_open_init(channels: int, device) -> CostasOpenState:
    def zeros(dtype):
        return torch.zeros(channels, dtype=dtype, device=device)

    return CostasOpenState(w2=zeros(torch.float32), psi=zeros(torch.float32),
                           r=zeros(torch.complex64), ang=zeros(torch.float32),
                           z_prev=zeros(torch.complex64))


def costas_open_run(cfg: CostasOpenConfig, state: CostasOpenState,
                    x: torch.Tensor, chunk: int | None = None,
                    square: bool = True):
    """Track the BPSK carrier (square=True) or a plain carrier in x [C, N]
    complex64.  Returns (state', phases [C, N] carrier phase, level [C, F]
    lock level); streaming-exact for any whole-chunk blocking.  Coherent
    demod = (x * exp(-1j phases)).real."""
    c, n = x.shape
    ell = int(chunk or cfg.chunk)
    if n % ell:
        raise ValueError(f"carrier input of {n} samples is not a whole "
                         f"number of {ell}-sample chunks")
    f = n // ell
    alpha = math.exp(-TWO_PI * cfg.bw_hz * ell / cfg.sample_rate)

    s3 = (x * x if square else x).reshape(c, f, ell)
    zf = s3.mean(dim=-1)                                   # [C, F]
    zp = torch.cat([state.z_prev[:, None], zf[:, :-1]], dim=1)
    dm = zf * torch.conj(zp)
    lim = min((2.0 if square else 1.0) * cfg.dev_max, math.pi / ell)
    w2m = torch.clamp(torch.atan2(dm.imag, dm.real) / ell, -lim, lim)
    w2 = _ewma_closed(state.w2, w2m, alpha)                # [C, F]

    cs = torch.cumsum(w2, dim=-1)
    psi0 = state.psi[:, None] + ell * (cs - w2)            # [C, F] chunk starts
    psi_next = state.psi + ell * cs[:, -1]

    t_in = torch.arange(ell, dtype=torch.float32, device=x.device)
    ph_in = psi0[:, :, None] + w2[:, :, None] * t_in       # [C, F, L]
    zres = (s3 * torch.exp(-1j * ph_in.to(torch.complex64))).mean(dim=-1)
    r = _ewma_closed(state.r, zres, alpha)                 # [C, F]
    level = torch.abs(r)
    # the residual angle unwrapped: a cumsum of chunk-to-chunk increments
    r_prev = torch.cat([state.r[:, None], r[:, :-1]], dim=1)
    dprod = r * torch.conj(r_prev)
    dang = torch.where(torch.abs(r_prev) > 0,
                       torch.atan2(dprod.imag, dprod.real),
                       torch.atan2(r.imag, r.real))        # first chunk: seed
    ang = state.ang[:, None] + torch.cumsum(dang, dim=-1)  # [C, F]

    half = 0.5 if square else 1.0
    phases = half * (ph_in + ang[:, :, None]).reshape(c, n)
    # psi and ang wrap mod 4 pi, so the halved phase wraps mod 2 pi
    new_state = CostasOpenState(
        w2=w2[:, -1],
        psi=torch.remainder(psi_next + TWO_PI, 2.0 * TWO_PI) - TWO_PI,
        r=r[:, -1],
        ang=torch.remainder(ang[:, -1] + TWO_PI, 2.0 * TWO_PI) - TWO_PI,
        z_prev=zf[:, -1])
    return new_state, phases, level


# ------------------------------------------------ aimed carrier loop (SAM)

def pll_run_aimed(cfg: PLLConfig, state, aim_phase: torch.Tensor,
                  x: torch.Tensor, chunk: int = 64, n_block: int = 0,
                  smooth_cfg: CostasOpenConfig | None = None):
    """Two-stage blockwise carrier loop for wide pull ranges (SAM: +-1 kHz
    at ~32 ksps), x [C, N] complex64 holding N / n_block logical blocks.

    Stage 1 aims: each block's carrier frequency from three coherent sums
    of growing length (folds 8, 4, 4), each a boxcar that attenuates the
    sidebands before its conj-product frequency read, the stream derotated
    by each stage's estimate before the next; clipped to the loop range,
    and the block derotated by the carried aim ramp.  Stage 2 tracks the
    near-DC residual: with smooth_cfg (a CostasOpenConfig; `state` its
    CostasOpenState) the open-loop smoother (costas_open_run, square=False;
    its chunk halves until it divides the block), else the chunked loop
    (pll_run_blockwise at `chunk`, around a zero centre with the clamp
    widened to [lo - hi, hi - lo]; `state` a PLLState).  The aim phase
    carries across calls.

    Returns (state', aim_phase' [C], phases [C, N], freqs [C, N]
    rad/sample)."""
    c, n = x.shape
    nb = n_block or n
    k = n // nb
    z = x.reshape(c, k, nb)
    f_est = torch.zeros(c, k, dtype=torch.float32, device=x.device)
    span = 1
    for fold in (8, 4, 4):
        z = z.reshape(c, k, -1, fold).sum(dim=-1)                # [C, K, M]
        span *= fold
        # within-block products only: the K-block call aims each block as
        # K sequential calls would
        dm = (z[:, :, 1:] * torch.conj(z[:, :, :-1])).mean(dim=-1)
        f_step = torch.atan2(dm.imag, dm.real) / span           # rad/sample
        f_est = f_est + f_step
        m_idx = torch.arange(z.shape[-1], dtype=torch.float32,
                             device=x.device)
        rot = (f_step[:, :, None] * span) * m_idx
        z = z * torch.exp(-1j * rot.to(torch.complex64))
    f_est = torch.clamp(f_est, cfg.freq_lo, cfg.freq_hi)
    # the carried aim phase at each block start: aim + cumsum(f_est nb)
    steps = f_est * float(nb)
    starts = aim_phase[:, None] + torch.cat(
        [torch.zeros(c, 1, dtype=torch.float32, device=x.device),
         torch.cumsum(steps[:, :-1], dim=-1)], dim=-1)           # [C, K]
    starts = torch.remainder(starts + math.pi, TWO_PI) - math.pi
    t_in = torch.arange(nb, dtype=torch.float32, device=x.device)
    ramp = (starts[:, :, None] + f_est[:, :, None] * t_in).reshape(c, n)
    xd = x * torch.exp(-1j * ramp.to(torch.complex64))
    freqs = torch.repeat_interleave(f_est, nb, dim=-1)
    if smooth_cfg is not None:
        ell = smooth_cfg.chunk
        while nb % ell:
            ell //= 2
        st2, ph_res, _ = costas_open_run(smooth_cfg, state, xd, chunk=ell,
                                         square=False)
    else:
        cfg0 = dataclasses.replace(cfg, freq_center=0.0,
                                   freq_lo=cfg.freq_lo - cfg.freq_hi,
                                   freq_hi=cfg.freq_hi - cfg.freq_lo)
        st2, ph_res, fr_res = pll_run_blockwise(cfg0, state, xd, chunk=chunk)
        freqs = freqs + fr_res
    phases = ramp + ph_res
    aim2 = (torch.remainder(starts[:, -1] + steps[:, -1] + math.pi, TWO_PI)
            - math.pi)
    return st2, aim2, phases, freqs
