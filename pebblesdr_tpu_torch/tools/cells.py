"""The timed receiver cells and the kernel checks that the card tools share.

``chip_smoke.py``, ``tools/bench.py``, ``tools/cell_profile.py``,
``fir_cells.py``, ``tail_cells.py``, ``anf_cells.py`` and
``recur_cells.py`` build and time their cells here:

- the bench signal's planes (``am_plane``, ``wfm_plane``, ``tone_plane``,
  ``to_i16``) and the audio's tone fits (``tone_snr_db``,
  ``tone_amplitude``);
- ``make_cell`` (a Receiver and its dispatch plane), ``dispatch``,
  ``time_cells`` (warm-up, CUDA-event windows, ``check_cell``'s launch
  counts and audio checks), ``dispatch_profile`` (host enqueue, device
  busy, idle share), ``kernel_times`` / ``launch_ms`` (device ms per
  launch from torch.profiler);
- ``CELLS``, the registry of the named cells of ``PERF.md`` section 4,
  built by ``named_cell``;
- the inputs and bounds of the kernel checks (``check_options_form``,
  ``tail_inputs``, ``ook_powers``, ``probe_ns``, ``anf_signal``).

Each function takes the torch module and the port's modules it drives as
its first arguments, as ``chip_smoke.py``'s phases pass them: a tool that
times an older checkout, whose ``chip_smoke.py`` still defines these
functions, calls either with the same arguments.  Nothing of torch or the
package is imported at module level, so a tool can read this file's
``CELLS`` while another checkout's package is the one imported.  What
builds tensors takes ``device`` (default ``"cuda"``): without a CUDA
device that raises, unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import re
import time
from typing import NamedTuple

import numpy as np

FS = 2_048_000
HEADLINE = dict(channels=64, frames=32768, blocks=32, agc_stride=16)
SPECTRA_EVERY = 6
WARMUP = 3
WINDOWS = 3
WINDOW_DISPATCHES = 10
TONE_SNR_DB = 40.0       # 1 kHz tone (AM m = 0.8; WFM L), band above 100 Hz
FRONT_RTOL = 3e-5        # K1 vs plain: relative max error (TPU kernel's bound)
NB1 = (3.3, 7, 0.001, "blank")     # the Receiver's NB1 (threshold, width,
#                                    alpha, mode)
IQ = (1.05, 0.02)                  # static IQ balance (gain, phase)
PROBE_STEPS = 32768   # steps of the chain probe (serial floor)
OOK_MARGIN = 1e-5        # least decision margin (ops/goertzel.py ook_margin)
OOK_RTOL = 1e-6          # K6's state vs plain, of each leaf's scale (the
#                          kernel repeats the plain version's float32
#                          operations one by one: bit-equal where measured)
ANF_RTOL = 1e-5       # K8 vs anf_plain: y and w' within 1e-5 of their scale
#                       (the same sums in another order, through the LMS
#                       feedback: 2048 updates at the staged shape)
PFB_CELL = dict(bank=128, stations=127)   # bench.py:228-290


class CellSpec(NamedTuple):
    """A named cell: its mode, channels (the bank's: stations), blocks a
    dispatch, frames a block, entry plane ("f32", "i16", "fold<G>",
    "imbalanced": the AM plane through an IQ imbalance, "bank": the dense
    filterbank's one wideband plane), receiver options and audio checks
    (make_cell's)."""
    mode: str
    channels: int
    blocks: int
    frames: int = 32768
    entry: str = "f32"
    opts: dict = {}
    checks: dict = {}


# The named cells of PERF.md section 4 (tools/cell_profile.py times any of
# them; chip_smoke.py's phases 4-42 time them among others)
CELLS = {
    "am_64ch": CellSpec("AM", 64, 32),
    "wfm_64ch": CellSpec("FMS", 64, 32),
    "wfm_hq_64ch": CellSpec("FMS", 64, 32, opts={"wfm_hq": True}),
    "am_nb_64ch": CellSpec("AM", 64, 32,
                           opts={"enable_noise_blanker": True}),
    "am_256ch": CellSpec("AM", 256, 16),
    "am_i16_256ch": CellSpec("AM", 256, 16, entry="i16"),
    "am_16ch": CellSpec("AM", 16, 64, entry="fold4"),
    "wfm_rds_64ch": CellSpec("FMS", 64, 32, opts={"rds": True}),
    "wfm_16ch": CellSpec("FMS", 16, 64, entry="fold4"),
    "wfm_rds_scan_64ch": CellSpec("FMS", 64, 32,
                                  opts={"rds": True, "rds_alg": "scan"}),
    "sam_short_64ch": CellSpec("SAM", 64, 128, 2048),
    # the ANF outputs its prediction: its SNR is printed, not held
    "am_anf_long_64ch": CellSpec("AM", 64, 32,
                                 opts={"enable_anf": True, "agc_mode": "long"},
                                 checks={"snr": False, "anf": True}),
    "am_iqauto_64ch": CellSpec("AM", 64, 32, entry="imbalanced",
                               opts={"enable_iq_balance": "auto"}),
    "am_iqauto_anf_64ch": CellSpec("AM", 64, 32, entry="imbalanced",
                                   opts={"enable_iq_balance": "auto",
                                         "enable_anf": True},
                                   checks={"snr": False, "anf": True}),
    "pfb_127st_bank128": CellSpec("AM", PFB_CELL["stations"], 32,
                                  entry="bank", checks={"snr": False}),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_or_cpu(torch, device):
    """device as a torch.device: a CUDA device without a card raises (pass
    "cpu" to run on the CPU), never a fall back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device (pass "
                           f"device 'cpu' to run on the CPU)")
    return dev


def sync(torch, device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rel_err(got, ref) -> float:
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    return float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))


def packed(iq: np.ndarray, channels: int, rng=None,
           noise: float = 0.0) -> np.ndarray:
    """[n, 2C] float32 packed plane of a complex128 [n] signal on every
    channel, plus noise * rng.standard_normal((n, 2C)) added in float64
    before the one rounding to float32 (the signal's columns are not
    materialized in float64: a full-width plane is ~1 GiB of them)."""
    if not noise:
        return np.concatenate([np.repeat(v.astype(np.float32)[:, None],
                                         channels, 1)
                               for v in (iq.real, iq.imag)], axis=1)
    z = rng.standard_normal((len(iq), 2 * channels))
    z *= noise
    z[:, :channels] += iq.real[:, None]
    z[:, channels:] += iq.imag[:, None]
    return z.astype(np.float32)


def wfm_plane(channels: int, n_rows: int, rng, noise: float = 0.0,
              program: str = "mono", t0: float = 0.0, fs: int = FS):
    """[n_rows, 2C] float32 packed plane: broadcast FM at 250 kHz on every
    channel of an fs capture.  "mono": bench.py's wfm signal (1 kHz on L
    and R, pilot); "left": the L-only 700 Hz program of bench.py's quality
    row; "rds": 1 kHz mono, pilot and the RDS PS groups on 57 kHz.  t0:
    start time."""
    from pebblesdr_tpu_torch.tools import soak
    t = t0 + np.arange(n_rows) / fs
    th = 2 * np.pi * 19000.0 * t
    if program == "mono":
        comp = 0.45 * np.sin(2 * np.pi * 1000.0 * t) + 0.1 * np.sin(th)
    elif program == "rds":
        comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t) + 0.1 * np.sin(th)
                + 0.06 * soak.rds_biphase(t) * np.cos(3 * th))
    else:
        lt = np.sin(2 * np.pi * 700.0 * t)
        comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
    return packed(iq, channels, rng, noise)


def reset_launches(front, wfm_tail) -> None:
    from pebblesdr_tpu_torch.core import siggen
    from pebblesdr_tpu_torch.ops import agc, goertzel, pll, scanops
    goertzel.ook_detect.launches = 0
    siggen.sweep.launches = 0
    front.fused_front.launches = 0
    front.fused_front.comp_launches = 0
    front.chunk_means.launches = 0
    front.dc_scan.launches = 0
    wfm_tail.wfm_tail.launches = 0
    pll.pll_scan.launches = 0
    pll.pll_scan.detector_launches.update(dict.fromkeys(pll.DETECTORS, 0))
    pll.pll_chunk_scan.launches = 0
    agc.agc_scan.launches = 0
    scanops.auto_iq_balance.launches = 0
    scanops.anf_scan.launches = 0


def count_launches(cell, front, wfm_tail) -> None:
    """Add the wrappers' launch counts since reset_launches to the cell's
    (K1, K2, front_means, front_dc_scan, front_comp, pll_scan,
    iq_lms_scan, anf_scan) and set every count to 0 again."""
    from pebblesdr_tpu_torch.ops import pll, scanops
    counts = (front.fused_front.launches, wfm_tail.wfm_tail.launches,
              front.chunk_means.launches, front.dc_scan.launches,
              front.fused_front.comp_launches, pll.pll_scan.launches,
              scanops.auto_iq_balance.launches, scanops.anf_scan.launches)
    cell["launches"] = [a + b for a, b in zip(cell["launches"], counts)]
    reset_launches(front, wfm_tail)


def am_plane(channels: int, n_rows: int, rng, noise: float = 0.0,
             fs: int = FS):
    """[n_rows, 2C] float32 packed plane: an AM carrier at 250 kHz (1 kHz
    tone, m = 0.8) on every channel of an fs capture, with optional
    complex white noise."""
    t = np.arange(n_rows) / fs
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = 0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
    return packed(iq, channels, rng, noise)


def to_i16(plane: np.ndarray, scale: float = 32768.0) -> np.ndarray:
    return np.clip(np.round(plane * scale), -32768, 32767).astype(np.int16)


def tone_snr_db(audio: np.ndarray, rate: float, f0: float = 1000.0,
                band: tuple = (100.0, None)) -> float:
    """Least-squares fit of a tone (cos, sin) at f0; SNR of the fit against
    the residual in band (lo, hi) Hz (default: above 100 Hz)."""
    t = np.arange(len(audio)) / rate
    basis = np.stack([np.cos(2 * np.pi * f0 * t), np.sin(2 * np.pi * f0 * t),
                      np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, audio, rcond=None)
    fit = basis[:, :2] @ coef[:2]
    res = audio - basis @ coef
    spec = np.fft.rfft(res)
    freqs = np.fft.rfftfreq(len(res), 1 / rate)
    spec[freqs <= band[0]] = 0.0
    if band[1] is not None:
        spec[freqs > band[1]] = 0.0
    res_hp = np.fft.irfft(spec, n=len(res))
    return float(10 * np.log10(np.mean(fit ** 2) / max(np.mean(res_hp ** 2),
                                                        1e-30)))


def tone_amplitude(audio: np.ndarray, rate: float, f0: float) -> float:
    """The amplitude of a least-squares fit of a tone at f0."""
    t = np.arange(len(audio)) / rate
    basis = np.stack([np.cos(2 * np.pi * f0 * t), np.sin(2 * np.pi * f0 * t),
                      np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, audio, rcond=None)
    return float(np.hypot(coef[0], coef[1]))


def tone_plane(channels: int, n_rows: int, offset_hz: float, amp: float,
               fs: int = FS):
    """[n_rows, 2C] float32 packed plane: a tone of amplitude amp at 250 kHz
    + offset_hz on every channel (tests/test_chain.py:118's USB tone)."""
    t = np.arange(n_rows) / fs
    iq = amp * np.exp(2j * np.pi * (250_000.0 + offset_hz) * t)
    return packed(iq, channels)


def time_cuda(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def runs_loop(rx) -> bool:
    """Whether a receiver runs the per-sample carrier loop (pll_scan, once
    per dispatch): the scan RDS carrier, or SAM's per-sample form."""
    return ((rx.rds_cfg is not None and rx.rds_cfg.alg == "scan")
            or (rx.sam_cfg is not None
                and (rx.blk % 128 != 0 or rx.sam_cfg.algorithm == "scan")))


def assert_margin(fl, nb, tag: str) -> None:
    """The blanker's spike test is a comparison: fail unless no sample's
    ratio mag2 / (thr^2 max(avg, 1e-18)) lies in [0.999, 1.001]."""
    ratio = fl.mag2 / (float(np.float32(nb[0] ** 2)) * fl.avg.clamp(min=1e-18))
    near = int(((ratio >= 0.999) & (ratio <= 1.001)).sum())
    if near:
        raise RuntimeError(f"{tag}: {near} samples within 0.1 % of the "
                           f"blanker's threshold")


def make_cell(torch, receiver, front, mode, name: str, channels: int,
              blocks: int, entry: str = "f32", opts: dict | None = None,
              tone: tuple | None = None, plane=None,
              checks: dict | None = None, frames: int | None = None,
              fs: int = FS, block: np.ndarray | None = None,
              device="cuda"):
    """One timed cell: a receiver on the device and its dispatch plane (one
    bench signal block repeated: the AM signal, or for FMS and FMM the WFM
    one; block: that [N, 2C] float32 block given).  entry: "f32", "i16",
    or "fold<G>" / "f32_fold<G>" / "i16_fold<G>", the block time-folded by
    G (bench.py:130-146: G blocks side by side, lane group g = block g) and
    repeated K / G times.  tone =
    (offset Hz, amplitude, audio Hz, audio amplitude): the block is that
    tone above the 250 kHz carrier instead, and the cell's audio is held to
    that frequency and amplitude (within 10 %).  plane: a function
    (channels, rows) giving the whole dispatch's plane instead (a signal
    whose period is not a block).  checks: "snr_band" (lo, hi) Hz of the
    tone SNR's residual, "snr" False to print the SNR unchecked, "ctcss"
    True to require ctcss_open on every channel, "anf" True to require
    the ANF's max |w| > 1e-3, "skip_blocks" the leading blocks of the last
    dispatch left out of the tone SNR.  frames: the block length (default
    the headline's); fs: the capture's rate; opts may set agc_stride
    (default the headline's 16)."""
    dev = card_or_cpu(torch, device)
    n = frames or HEADLINE["frames"]
    opts = {"agc_stride": HEADLINE["agc_stride"], **(opts or {})}
    wfm = mode.name == "FMS" and opts.get("stereo", True)   # stereo
    cfg = receiver.ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                  channels=channels, mode=mode, **opts)
    rx = receiver.Receiver(cfg, dev)
    fm = mode.name in ("FMS", "FMM")
    if plane is not None:
        iq = torch.from_numpy(plane(channels, blocks * n)).to(dev)
    else:
        if block is None:
            block = (tone_plane(channels, n, *tone[:2], fs=fs) if tone else
                     wfm_plane(channels, n, None, fs=fs) if fm else
                     am_plane(channels, n, None, fs=fs))
        if entry.startswith("i16"):
            block = to_i16(block)
        fold = int(entry.split("fold")[1]) if "fold" in entry else 1
        if fold > 1:
            block = front.fold_plane_np(np.tile(block, (fold, 1)), fold)
        iq = torch.from_numpy(block).to(dev).repeat(blocks // fold, 1)
        iq = iq.contiguous()
    return {"name": name, "rx": rx, "cfg": cfg, "wfm": wfm, "tone": tone,
            "params": rx.default_params(250_000.0), "iq": iq,
            "blocks": blocks, "channels": channels, "state": rx.init_state(),
            "out": None, "i": 0, "launches": [0] * 8,
            "windows": [], "checks": checks or {}, "frames": n, "fs": fs,
            "device": dev}


def dispatch(cell, spectra: bool | None = None):
    """One step_many of the cell, its state carried; the spectra every
    cell["spectra_every"]-th dispatch (SPECTRA_EVERY unless the cell says)
    unless spectra says.  Returns the outputs."""
    i = cell["i"]
    if spectra is None:
        spectra = i % cell.get("spectra_every", SPECTRA_EVERY) == 0
    cell["state"], cell["out"] = cell["rx"].step_many(
        cell["state"], cell["params"], cell["iq"], spectra=spectra)
    cell["i"] = i + 1
    return cell["out"]


def time_cells(torch, front, wfm_tail, cells: list, tag: str) -> None:
    """Warm each cell up, then time WINDOWS windows of each, interleaved
    (cell A, cell B, cell A, ...), counting each cell's kernel launches,
    then check_cell each.  Spectra every cell["spectra_every"]-th dispatch
    (SPECTRA_EVERY unless the cell says)."""
    def counted(cell, fn):
        reset_launches(front, wfm_tail)
        fn()
        torch.cuda.synchronize()
        count_launches(cell, front, wfm_tail)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cell in cells:
        counted(cell, lambda: [dispatch(cell) for _ in range(WARMUP)])
    for _ in range(WINDOWS):
        for cell in cells:
            counted(cell, lambda: cell["windows"].append(
                time_cuda(torch, lambda: dispatch(cell), WINDOW_DISPATCHES)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for cell in cells:
        c, k, n = cell["channels"], cell["blocks"], cell["frames"]
        launches = cell["launches"]
        windows = cell["windows"]
        best = min(windows)                               # ms per dispatch
        cell.update(block_ms=best / k, msps=c * n * k / (best / 1e3) / 1e6,
                    realtime=n * k / (best / 1e3) / cell.get("fs", FS),
                    peak_gib=peak)
        log(f"{tag} {cell['name']} {c}ch x {n} x {k}: dispatch ms per "
            f"window " + " ".join(f"{w:.4f}" for w in windows)
            + f"; block {cell['block_ms']:.5f} ms, {cell['msps']:.1f} Msps "
            f"per GPU, {cell['realtime']:.1f}x realtime per channel, window "
            f"spread {max(windows) / best:.3f}; K1 launches {launches[0]}, "
            f"K2 launches {launches[1]}, front_means launches {launches[2]}, "
            f"front_dc_scan launches {launches[3]}, front_comp launches "
            f"{launches[4]}, pll_scan launches {launches[5]}, iq_lms_scan "
            f"launches {launches[6]}, anf_scan launches {launches[7]} for "
            f"{cell['i']} dispatches "
            f"({launches[0] / cell['i']:g} K1 per dispatch); peak device "
            f"memory {peak:.3f} GiB" + (" (cells timed together)"
                                        if len(cells) > 1 else ""))
        check_cell(torch, cell, tag)


def check_cell(torch, cell, tag: str) -> tuple:
    """check_launches, then check_audio; returns the launch counts."""
    launches = check_launches(cell, tag)
    check_audio(torch, cell, tag)
    return launches


def check_launches(cell, tag: str) -> tuple:
    """The cell's launch counts (count_launches) over its cell["i"]
    dispatches, held to what its receiver runs: K1 with front_means and
    front_dc_scan (twice with the blanker) once a dispatch unless the front
    is staged, K2 once for FM stereo with the batched tail (and front_comp
    at hq), pll_scan where the per-sample loop runs, iq_lms_scan with
    enable_iq_balance="auto", anf_scan with the ANF; on the CPU none (the
    plain versions never count).  Raises RuntimeError otherwise."""
    n_dispatch = cell["i"]
    runs = n_dispatch if cell["device"].type == "cuda" else 0
    launches = tuple(cell["launches"])
    cfg, rx = cell["cfg"], cell["rx"]
    scans = 2 if cfg.enable_noise_blanker else 1
    fused = 0 if rx.staged else runs
    k2 = runs if getattr(rx, "wfm_tail", None) else 0
    if launches != (fused, k2, fused, scans * fused,
                    k2 if cfg.wfm_hq else 0,
                    runs if runs_loop(rx) else 0,
                    runs if cfg.enable_iq_balance == "auto" else 0,
                    runs if cfg.enable_anf else 0):
        raise RuntimeError(f"{tag} {cell['name']}: launches (K1, K2, "
                           f"front_means, front_dc_scan, front_comp, "
                           f"pll_scan, iq_lms_scan, anf_scan) "
                           f"{launches} for {n_dispatch} dispatches")
    return launches


def check_audio(torch, cell, tag: str) -> None:
    """The cell's last dispatch: finite audio of the receiver's shape,
    squelch open, pilot locked (FM stereo), RDS outputs finite, the checks
    make_cell names, and the tone SNR >= TONE_SNR_DB (and its amplitude
    for a tone cell).  Raises RuntimeError on a miss; sets cell["snr_db"]."""
    c, k = cell["channels"], cell["blocks"]
    wfm = cell["wfm"]
    out = cell["out"]
    audio = out["audio"]
    # WFM: left and right
    shape = ((k, c, 2) if wfm else (k, c)) + (cell["rx"].audio_blk,)
    if not bool(torch.isfinite(audio).all()):
        raise RuntimeError(f"{tag} {cell['name']}: audio is not finite")
    if tuple(audio.shape) != shape:
        raise RuntimeError(f"{tag} {cell['name']}: audio shape "
                           f"{tuple(audio.shape)}")
    if not bool(out["squelch_open"].all()):
        raise RuntimeError(f"{tag} {cell['name']}: squelch closed")
    if wfm and not bool(out["pilot_locked"].all()):
        raise RuntimeError(f"{tag} {cell['name']}: pilot not locked")
    if "rds_soft" in out:
        soft, n_sym = out["rds_soft"], cell["rx"].rds_cfg.n_sym
        if (tuple(soft.shape) != (k, c, n_sym)
                or not bool(torch.isfinite(soft).all())
                or tuple(out["rds_timing"].shape) != (k, c)):
            raise RuntimeError(f"{tag} {cell['name']}: RDS outputs "
                               f"{tuple(soft.shape)}")
        log(f"{tag} {cell['name']} rds_soft {tuple(soft.shape)} finite, "
            f"{n_sym} symbols per block per channel")
    checks = cell["checks"]
    if checks.get("ctcss"):
        opened = out["ctcss_open"]
        log(f"{tag} {cell['name']} ctcss_open on {int(opened.sum())} of "
            f"{opened.numel()} blocks x channels of the last dispatch")
        if not bool(opened.all()):
            raise RuntimeError(f"{tag} {cell['name']}: the CTCSS "
                               f"squelch is closed")
    if checks.get("anf"):
        w = float(cell["state"].anf.weights.abs().max())
        log(f"{tag} {cell['name']} ANF max |w| {w:.4g} (> 1e-3)")
        if not w > 1e-3:
            raise RuntimeError(f"{tag} {cell['name']}: the ANF did not "
                               f"adapt")
    tone = audio[:, 0, 0, :] if wfm else audio[:, 0, :]  # WFM: L channel
    tone = tone[checks.get("skip_blocks", 0):]
    tone = tone.reshape(-1).double().cpu().numpy()
    f0, want = (cell["tone"][2:] if cell["tone"] else (1000.0, None))
    wcfg = cell["rx"].wfm_cfg
    if wcfg is not None:
        # each block's audio spans blk // audio_decim tail samples of
        # its blk (4095 of 4096 at 2.88 Msps: one composite sample
        # dropped a block, as the JAX package's per-block path does):
        # the tone plays that much faster
        blk = cell["rx"].wfm_tail_blk
        f0 *= blk / (wcfg.audio_decim * (blk // wcfg.audio_decim))
    band = checks.get("snr_band", (100.0, None))
    snr = tone_snr_db(tone, cell["cfg"].audio_rate, f0, band)
    amp = tone_amplitude(tone, cell["cfg"].audio_rate, f0)
    check_snr = checks.get("snr", True)
    log(f"{tag} {cell['name']} {f0:g} Hz tone SNR {snr:.2f} dB "
        + (f"(>= {TONE_SNR_DB}) " if check_snr else "(not checked) ")
        + f"over {band[0]:g}-{band[1] or cell['cfg'].audio_rate / 2:g} "
        f"Hz, amplitude {amp:.5f}"
        + (f" (want {want:.5f} within 10 %)" if want else "")
        + f", S-meter SNR {float(out['smeter']['snr_db'][-1, 0]):.2f} dB")
    cell["snr_db"] = snr
    if check_snr and not snr >= TONE_SNR_DB:
        raise RuntimeError(f"{tag} {cell['name']}: tone SNR below its "
                           f"bound")
    if want and not abs(amp - want) <= 0.1 * want:
        raise RuntimeError(f"{tag} {cell['name']}: tone amplitude "
                           f"{amp:.5f}, want {want:.5f}")


def tail_inputs(torch, c: int, n: int, ell: int, rng, device="cuda"):
    """A composite-like raw plane and pilot parameters on the device."""
    dev = card_or_cpu(torch, device)
    raw = rng.standard_normal((n, c)).astype(np.float32) * 0.5
    p0 = rng.uniform(0.0, 10.0, (n // ell, c)).astype(np.float32)
    wf = (2 * np.pi * 19000.0 / 256000.0
          + 1e-4 * rng.standard_normal((n // ell, c))).astype(np.float32)
    return [torch.from_numpy(v).to(dev) for v in (raw, p0, wf)]


def kernel_times(torch, fn, reps: int = 3, want: tuple = (),
                 tries: int = 3) -> dict:
    """{kernel: (device ms per launch, launches recorded)} of each CUDA
    kernel fn launches, over reps calls: the device records of a
    torch.profiler trace (CUDA activity only), read from prof.events() as
    dispatch_profile reads them.  key_averages() is not used: it gives no
    device time to a record it marks asynchronous, and on the H100 it gave
    none at all for some traces of a few launches.  A count below reps
    means records were lost; while no kernel was recorded, or none whose
    name starts with one of the names in want, the calls are traced
    again, up to tries traces; the last trace's records are returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        rows = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue
            m = re.search(r"(front_\w+|wfm_tail_\w+|probe_\w+|recur_\w+)"
                          r"(<[^>]*>)?", ev.name)
            if m:
                tot, n = rows.get(m.group(0), (0.0, 0))
                rows[m.group(0)] = (tot + (ev.time_range.end
                                           - ev.time_range.start) / 1e3,
                                    n + 1)
        if rows and all(any(k.startswith(w) for k in rows) for w in want):
            break
    return {k: (tot / n, n) for k, (tot, n) in rows.items()}


def launch_ms(times: dict, name: str) -> float:
    """The device ms per launch of the kernel whose name starts with name in
    kernel_times' result (kernel_times(..., want=(name,)) traces again
    while it has none); a RuntimeError naming the kernel if no trace
    recorded it."""
    for k, (ms, _) in times.items():
        if k.startswith(name):
            return ms
    raise RuntimeError(f"torch.profiler recorded no {name} launch in "
                       f"any of its traces")


def check_options_form(torch, front, plan, args, kw, tag: str,
                       keep: bool = False) -> dict:
    """One K1 call and one plain call on the same inputs: every output
    within FRONT_RTOL relative (the phase in absolute), and with the
    blanker on, its margin asserted first and no blanked position or
    nb_tail' flag that differs.  keep: also return K1's outputs ("out")."""
    masks = [{}, {}]
    if kw.get("nb"):
        x, dc = args[0], args[1]
        _, z = front.dc_iq_reference(plan, front.dequantize(x), dc,
                                     kw["iq_gain"], kw["iq_phase"])
        assert_margin(front.nb_flags(z, kw["nb"], kw["nb_avg"], kw["nb_tail"]),
                      kw["nb"], tag)
        del z
        masks = [{"nb_mask": torch.zeros(x.shape, dtype=torch.uint8,
                                         device=x.device)} for _ in range(2)]
    out_k = front.fused_front(plan, *args, **kw, **masks[0])
    out_r = front.fused_front_reference(plan, *args, **kw, **masks[1])
    sync(torch, args[0].device)
    names = ("y", "dc", "tail", "phase", "raw", "nb_avg", "nb_tail")
    errs = {nm: rel_err(a, b) for nm, a, b in zip(names, out_k, out_r)
            if nm != "phase"}
    errs["phase"] = float((out_k[3] - out_r[3]).abs().max())
    mism = 0
    if kw.get("nb"):
        mism = (int((masks[0]["nb_mask"] != masks[1]["nb_mask"]).sum())
                + int((out_k[6] != out_r[6]).sum()))
    worst = max(errs.values())
    max_abs = float((out_k[0] - out_r[0]).abs().max())
    log(f"{tag}: relative max errors "
        + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items())
        + f" (worst {worst:.3g}); max abs y error {max_abs:.3g}"
        + (f"; flag mismatches {mism}" if kw.get("nb") else ""))
    if not (worst <= FRONT_RTOL and mism == 0):
        raise RuntimeError(f"{tag}: K1 disagrees with its plain version")
    return {"worst": worst, "max_abs_err": max_abs,
            **({"out": out_k} if keep else {})}


def dispatch_profile(torch, cell, tag: str, reps: int = 5,
                     dispatch=None) -> dict:
    """One cell's dispatches with spectra off (on where the cell computes
    them every dispatch): timed by CUDA events without the profiler, their
    host enqueue time (no sync inside), then under torch.profiler (CUDA
    activity) for the device busy time per dispatch (the union of its
    kernels' intervals).  Idle share = 1 - busy / event-timed ms; with the
    kernels that take the most device time.  dispatch: a function running
    one dispatch of the cell (default: its Receiver's step_many)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    st = [cell["state"]]
    spectra = cell.get("spectra_every", SPECTRA_EVERY) == 1

    def step():
        st[0], _ = cell["rx"].step_many(st[0], cell["params"], cell["iq"],
                                        spectra=spectra)

    step = dispatch or step

    step()
    ms = time_cuda(torch, step, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    host = (time.perf_counter() - t0) * 1e3 / reps    # enqueue, no sync
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        key = re.sub(r"^void\s+|\(anonymous namespace\)::|at::native::", "",
                     ev.name)
        key = re.sub(r"\(.*", "", key)[:48]
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e3 / reps
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy = busy / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    idle = max(0.0, 1.0 - busy / ms)
    log(f"{tag} {cell['name']} profile (spectra {'on' if spectra else 'off'}"
        f"): {ms:.4f} ms per dispatch by "
        f"events, host enqueue {host:.4f} ms, device busy {busy:.4f} ms "
        f"(idle share {idle:.3f}; "
        f"{len(spans) // reps} kernels per dispatch); top (ms): "
        + ", ".join(f"{nm} {t:.4f}" for nm, t in top))
    return {"ms": ms, "host_ms": host, "busy_ms": busy, "idle": idle,
            "kernels": len(spans) / reps}


def probe_ns(torch, pll, form: str, steps: int = PROBE_STEPS,
             fed: bool = False, device="cuda") -> float:
    """The serial floor's step latency of one form (ns): the chain probe
    over `steps` steps, timed by events; register-only, or with fed=True
    (pll.FED_FORMS: the register-only probe may fold steps on its constant
    inputs) one lane of the K4 / K6 kernel's own chain loop, or the K3 /
    K3c loop kernel's chain alone, its constants pinned and its inputs
    read from a small pattern in shared memory."""
    dev = card_or_cpu(torch, device)
    pll.chain_probe(form, 256, dev, fed=fed)
    ms = time_cuda(torch, lambda: pll.chain_probe(form, steps, dev,
                                                  fed=fed), 3)
    return ms * 1e6 / steps


def ook_powers(torch, c: int, f: int, rng, device="cuda"):
    """(main, low, high) [C, F] float32 bin powers on the device, the three
    columns of one [C, F, 3] tensor (the layout goertzel_power writes and
    K6 reads in place), whose decisions sit far from every mode's
    threshold: marks and spaces in runs cycling through 6, 10, 8, 12 and
    7 frames (a 50 % duty, so the average mode's mean stays near half the
    mark level), marks at 0.4 with a +-10 % fade, spaces near 1e-3, the
    compare bins near 2e-3 with a little of the keying on the low one (a
    deeper fade or a duty far from half puts decisions within 1e-5 of
    their thresholds)."""
    dev = card_or_cpu(torch, device)
    runs = (6, 10, 8, 12, 7)
    key = np.zeros((c, f), bool)
    for i in range(c):
        t, j, on = 0, i, False
        while t < f:
            key[i, t:t + runs[j % 5]] = on
            t, j, on = t + runs[j % 5], j + 1, not on
    fade = 1 + 0.1 * np.sin(np.arange(f) / 40.0 + np.arange(c)[:, None])
    pows = (np.where(key, 0.4 * fade, 1e-3 * (1 + 0.5 * rng.random((c, f)))),
            0.03 * key + 2e-3 * (1 + 0.5 * rng.random((c, f))),
            2e-3 * (1 + 0.5 * rng.random((c, f))))
    p3 = torch.from_numpy(np.stack(pows, -1).astype(np.float32)).to(dev)
    return [p3[:, :, 0], p3[:, :, 1], p3[:, :, 2]]


def anf_signal(c: int, n: int, rng) -> np.ndarray:
    """[c, n] complex64 at the demod rate (64 kHz): an 800 Hz tone (a phase
    per channel), 2100 Hz on I, and noise at 0.1."""
    t = np.arange(n) / 64_000.0 + rng.random()
    x = (0.3 * np.exp(1j * (2 * np.pi * 800.0 * t
                            + np.arange(c)[:, None]))
         + 0.2 * np.cos(2 * np.pi * 2100.0 * t)
         + 0.1 * (rng.standard_normal((c, n))
                  + 1j * rng.standard_normal((c, n))))
    return x.astype(np.complex64)


class BankCell:
    """A PfbBankReceiver behind the Receiver's step_many(state, params, iq,
    spectra) signature (time_cells, dispatch_profile); every other
    attribute is its tail Receiver's."""

    def __init__(self, bank):
        self.bank = bank

    def __getattr__(self, name):
        return getattr(self.bank.rx, name)

    def step_many(self, state, params, iq, spectra=True):
        return self.bank.step_many(state, iq, params, spectra)


def make_iqauto_cell(torch, receiver, front, name: str = "am_iqauto_64ch",
                     opts: dict | None = None, checks: dict | None = None,
                     device="cuda"):
    """am_iqauto_64ch: am_64ch's shape and signal (AM, 64 channels, 32
    blocks of 32768 frames, AGC stride 16) with enable_iq_balance="auto",
    the plane through tests/test_chain.py:204-236's IQ imbalance; opts:
    more receiver options (another cell of this signal, `name`)."""
    cell = make_cell(torch, receiver, front, receiver.DemodMode.AM, name,
                     HEADLINE["channels"], HEADLINE["blocks"],
                     opts={"enable_iq_balance": "auto", **(opts or {})},
                     checks=checks, device=device)
    c = HEADLINE["channels"]
    i = cell["iq"][:, :c].clone()
    cell["iq"][:, :c] = 1.06 * i
    cell["iq"][:, c:] += 0.08 * i
    return cell


def make_bank_cell(torch, receiver=None, front=None,
                   blocks: int = HEADLINE["blocks"],
                   stations: int = PFB_CELL["stations"],
                   bank: int = PFB_CELL["bank"],
                   frames: int = HEADLINE["frames"], fs: int = FS,
                   agc_stride: int = HEADLINE["agc_stride"], device="cuda"):
    """pfb_127st_bank128 (bench.py:228-290): one fs capture (the bench's
    AM block, an [N, 2] plane repeated over `blocks` blocks of `frames`)
    through a `bank`-channel filterbank, `stations` AM stations on bank
    channels 1, 2, ... (16 kHz channels and 256-sample channel blocks at
    the defaults), spectra every dispatch, as the bench computes them.
    The bench's carrier sits between two channel centres, so the tone SNR
    is printed, not held."""
    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu_torch.ops import pfb
    dev = card_or_cpu(torch, device)
    centers = pfb.channel_freqs(pfb.plan(fs, bank))
    tunes = centers[(1 + np.arange(stations)) % bank]
    pfb_rx = PfbBankReceiver(fs, frames, tunes, n_bank=bank,
                             agc_stride=agc_stride, device=dev)
    block = am_plane(1, frames, None, fs=fs)
    iq = torch.from_numpy(block).to(dev).repeat(blocks, 1).contiguous()
    return {"name": f"pfb_{stations}st_bank{bank}", "rx": BankCell(pfb_rx),
            "cfg": pfb_rx.rx.cfg, "wfm": False, "tone": None,
            "params": pfb_rx.params, "iq": iq, "blocks": blocks,
            "channels": len(tunes), "state": pfb_rx.init_state(),
            "out": None, "i": 0, "launches": [0] * 8, "windows": [],
            "checks": dict(CELLS["pfb_127st_bank128"].checks), "frames": frames,
            "fs": fs, "spectra_every": 1, "device": dev}


def named_cell(torch, receiver, front, name: str, device="cuda") -> dict:
    """The cell of CELLS called name, built on the device."""
    spec = CELLS[name]
    if spec.entry == "bank":
        return make_bank_cell(torch, receiver, front, spec.blocks,
                              device=device)
    if spec.entry == "imbalanced":
        return make_iqauto_cell(torch, receiver, front, name, spec.opts,
                                spec.checks, device=device)
    return make_cell(torch, receiver, front, receiver.DemodMode[spec.mode],
                     name, spec.channels, spec.blocks, spec.entry, spec.opts,
                     checks=spec.checks, frames=spec.frames, device=device)
