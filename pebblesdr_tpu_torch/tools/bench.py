"""The port's headline benchmark, bench.py's timing matrix on the card: IQ
Msamples/s per card through the port's full filter + demod chain.

    python -m pebblesdr_tpu_torch.tools.bench

Rows (BENCH_MODE=matrix, the default; bench.py:566-625's order and
shapes): am at 64 channels (K = BLOCKS blocks a dispatch, 2 x STEPS
dispatches a window), wfm, wfm_rds, wfm_hq and sam at 64 channels; am and
am_i16 at 256 channels (K = max(8, BLOCKS // 2), max(16, STEPS // 2)
dispatches); am and wfm at 16 channels (K = 2 x BLOCKS, the plane
time-folded by pick_fold's G = 4); am_nb at 64 channels; pfb (127 AM
stations on bank channels 1-127 of a 128-channel filterbank, K = 2 x
BLOCKS, max(16, STEPS // 2) dispatches); quality (tools/quality.py's row
at one channel).  Each row runs in its own subprocess (this module with
BENCH_MODE=<row>) with a timeout (BENCH_ROW_TIMEOUT, 900 s) and one
retry; a row that fails or times out twice becomes an "error" row and the
matrix goes on.

A receiver row: tools/cells.py make_cell builds the Receiver and its
dispatch plane, bench.py's _synth_iq block (2.048 Msps, N = 32768 frames)
repeated K times, as int16 for am_i16 or BENCH_I16, time-folded by
pick_fold's G where the JAX Receiver folds (not with the blanker, not at
hq); AGC stride 16, display spectra every 6th dispatch.  3 warm-up
dispatches, then windows of `steps` dispatches, each timed by the host
clock between torch.cuda.synchronize() calls: 3 windows, more while they
spread more than 1.5x, up to 6; the best window makes the row.  The row
is then held to cells.check_cell (launch counts, finite audio of the
receiver's shape, squelch open, pilot locked for FM stereo, tone SNR >=
40 dB); a row that misses one reports "error" and no "msps_per_chip".
Keys (bench.py's): config, msps_per_chip, realtime_per_channel, block_ms,
compile_warmup_s (here building the receiver and plane, loading the
kernels and the warm-up), windows_s, window_spread, vs_baseline (against
the C++ reference's 0.291 Msps on one channel, bench.py:37); and
k1_per_dispatch, k2_per_dispatch (the wrappers' launch counts over every
dispatch of the row), peak_gib (torch.cuda.max_memory_allocated) and
device.  Numbers are not rounded.

BENCH_MODE=ab times two rows (BENCH_AB, default am,am_i16) in one process:
4 pairs of interleaved windows of max(8, STEPS // 4) dispatches; a_msps,
b_msps (best windows), b_over_a_ratio (the median of the pairs' ratios),
ratio_spread, pairs_s.

Prints one JSON line: metric, value, unit, vs_baseline (the first timed
row's), matrix, total_bench_s and device (the card's name, power limit and
count as nvidia-smi reports them).  Env knobs, bench.py's: BENCH_MODE
(matrix, am, wfm, wfm_rds, wfm_hq, sam, am_nb, am_i16, pfb, quality, ab),
BENCH_CHANNELS, BENCH_BLOCKS, BENCH_STEPS, BENCH_FRAMES, BENCH_FS,
BENCH_AGC_STRIDE, BENCH_SPECTRA_EVERY, BENCH_AB, BENCH_PFB_BANK,
BENCH_PFB_STATIONS, BENCH_ROW_TIMEOUT, BENCH_I16; and BENCH_DEVICE
(default cuda): without a CUDA device the bench raises.  BENCH_DEVICE=cpu
runs the rows on the CPU for the tests (device "cpu"); no number of such a
row is the card's.  BENCH_PROFILE=1 (the card only) adds to each receiver
row cells.dispatch_profile's events_ms, host_enqueue_ms, device_busy_ms,
idle_share and kernels_per_dispatch (kernels in the trace), per dispatch
with the spectra off, after its windows.
The kernels build at first use into build/kernels/.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from pebblesdr_tpu_torch.tools import cells

CHANNELS = int(os.environ.get("BENCH_CHANNELS", "64"))
FRAMES = int(os.environ.get("BENCH_FRAMES", "32768"))
FS = int(os.environ.get("BENCH_FS", "2048000"))
WARMUP = 3
STEPS = int(os.environ.get("BENCH_STEPS", "40"))
BLOCKS = int(os.environ.get("BENCH_BLOCKS", "32"))
MODE = os.environ.get("BENCH_MODE", "matrix")
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")
PROFILE = bool(os.environ.get("BENCH_PROFILE"))
REFERENCE_MSPS = 2048.0 / 7.035e-3 / 1e6   # the C++ reference: 0.291 Msps
ROOT = Path(__file__).resolve().parents[2]   # where `-m` finds the package


def _device():
    """BENCH_DEVICE as a torch.device; a CUDA device without a card raises."""
    import torch
    dev = cells.card_or_cpu(torch, DEVICE)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def device_info() -> dict:
    """BENCH_DEVICE's card: its name, power limit and the cards' count as
    nvidia-smi reports them (no torch: the matrix's process only starts
    rows), or the CPU.  A CUDA device without a card raises."""
    kind, _, index = DEVICE.partition(":")
    if kind == "cpu":
        return {"platform": "cpu"}
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"BENCH_DEVICE {DEVICE!r}: no CUDA device "
                           f"({e}); BENCH_DEVICE=cpu runs on the CPU") from e
    if kind != "cuda" or int(index or 0) >= len(lines):
        raise RuntimeError(f"BENCH_DEVICE {DEVICE!r}: no such CUDA device "
                           f"({len(lines)} found)")
    name, power = (v.strip() for v in lines[int(index or 0)].split(","))
    return {"platform": "gpu", "name": name, "power_limit": power,
            "count": len(lines)}


def _synth_iq(mode_name: str, frames: int, channels: int = 1) -> np.ndarray:
    """bench.py's signal as the [frames, 2C] float32 plane it ships, every
    channel alike: FM stereo at 250 kHz (1 kHz on L and R, the pilot) for
    the wfm rows, else AM at 250 kHz (1 kHz, m = 0.8)."""
    if mode_name.startswith("wfm"):
        return cells.wfm_plane(channels, frames, None, fs=FS)
    return cells.am_plane(channels, frames, None, fs=FS)


def _timed_windows(run_once, sync, steps: int):
    """3 windows of `steps` dispatches, each between two sync() calls on
    the host clock; while they spread more than 1.5x, up to 3 more, so
    that one calm window anchors the best.  (best seconds, all)."""
    dts = []
    for w in range(6):
        if w >= 3 and max(dts) / max(min(dts), 1e-9) <= 1.5:
            break
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            run_once(i)
        sync()
        dts.append(time.perf_counter() - t0)
    return min(dts), dts


def _runner(cell, every: int, profiled: bool = False):
    """(run_once(i), sync(), check()) of a built cell: run_once dispatches
    with the spectra on every `every`-th i; sync waits for the device and
    moves the wrappers' launch counts into the cell; check holds the cell
    to cells.check_cell (RuntimeError on a miss) and returns the row's
    launches per dispatch and peak device memory, and with `profiled`
    first cells.dispatch_profile's per-dispatch events ms, host enqueue
    ms, device busy ms, idle share and kernels in the trace (5
    dispatches, spectra off, their launches not the row's)."""
    import torch

    from pebblesdr_tpu_torch.ops import front, wfm_tail
    dev = cell["device"]
    if profiled and dev.type != "cuda":
        raise RuntimeError("BENCH_PROFILE needs a CUDA device")

    def run_once(i):
        return cells.dispatch(cell, spectra=(i % every == 0))

    def sync():
        cells.sync(torch, dev)
        cells.count_launches(cell, front, wfm_tail)

    def check() -> dict:
        prof = {}
        if profiled:
            p = cells.dispatch_profile(torch, cell, "#")
            cells.reset_launches(front, wfm_tail)
            prof = {"events_ms": p["ms"], "host_enqueue_ms": p["host_ms"],
                    "device_busy_ms": p["busy_ms"], "idle_share": p["idle"],
                    "kernels_per_dispatch": p["kernels"]}
        launches = cells.check_cell(torch, cell, "bench")
        return {**prof, "k1_per_dispatch": launches[0] / cell["i"],
                "k2_per_dispatch": launches[1] / cell["i"],
                "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if dev.type == "cuda" else None)}

    return run_once, sync, check


def _warm(cell, every: int, t_c: float, label: str, profiled: bool = False):
    """The runner of a built cell after WARMUP dispatches, and the seconds
    since t_c (the build and the warm-up).  The wrappers' launch counts
    start at 0 here, so the cell counts its own dispatches only, whatever
    ran before in this process."""
    from pebblesdr_tpu_torch.ops import front, wfm_tail
    run_once, sync, check = _runner(cell, every, profiled)
    cells.reset_launches(front, wfm_tail)
    for i in range(WARMUP):
        run_once(i)
    sync()
    build_s = time.perf_counter() - t_c
    print(f"# [{label}] build+warmup {build_s:.1f}s", file=sys.stderr)
    return run_once, sync, check, build_s


def _build_runner(mode_name: str, channels: int, blocks: int,
                  frames: int = FRAMES, profiled: bool = False):
    """One row's receiver and plane (cells.make_cell), warmed up: returns
    (run_once(i) -> outputs, sync(), check() -> the row's launch and
    memory keys, build_s).  Shared by bench_receiver and bench_ab."""
    import torch

    from pebblesdr_tpu_torch.chain import receiver
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.ops import front
    dev = _device()
    mode = {"wfm": DemodMode.FMS, "wfm_rds": DemodMode.FMS,
            "wfm_hq": DemodMode.FMS, "sam": DemodMode.SAM}.get(
        mode_name, DemodMode.AM)
    opts = dict(rds=(mode_name == "wfm_rds"), wfm_hq=(mode_name == "wfm_hq"),
                enable_noise_blanker=(mode_name == "am_nb"),
                agc_stride=int(os.environ.get("BENCH_AGC_STRIDE", "16")))
    i16 = bool(os.environ.get("BENCH_I16")) or mode_name.endswith("_i16")
    # the JAX Receiver folds by pick_fold's G, but not with the in-kernel
    # blanker (no closed-form group seams) or at hq
    fold = (1 if opts["enable_noise_blanker"] or opts["wfm_hq"]
            else front.pick_fold(channels, blocks))
    entry = ("i16" if i16 else "f32") + (f"_fold{fold}" if fold > 1 else "")
    t_c = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cell = cells.make_cell(torch, receiver, front, mode,
                           f"{mode_name}_{channels}ch", channels, blocks,
                           entry, opts, frames=frames, fs=FS,
                           block=_synth_iq(mode_name, frames, channels),
                           device=dev)
    return _warm(cell, int(os.environ.get("BENCH_SPECTRA_EVERY", "6")), t_c,
                 f"{mode_name} {channels}ch", profiled)


def _rate_row(config: str, samples: int, channels: int, dt: float,
              dts: list, blocks_timed: int, build_s: float) -> dict:
    msps = samples / dt / 1e6
    return {"config": config, "msps_per_chip": msps,
            "realtime_per_channel": samples / channels / dt / FS,
            "block_ms": dt / blocks_timed * 1e3, "compile_warmup_s": build_s,
            "windows_s": dts,
            "window_spread": max(dts) / max(min(dts), 1e-9),
            "vs_baseline": msps / REFERENCE_MSPS}


def _checked(row: dict, check) -> dict:
    """row with check()'s keys, or an error row if the check failed."""
    try:
        return {**row, **check()}
    except RuntimeError as e:
        return {"config": row["config"], "error": str(e)}


def bench_receiver(mode_name: str, channels: int, blocks: int, steps: int,
                   frames: int = FRAMES, profiled: bool | None = None) -> dict:
    """One receiver row (module docstring); profiled: BENCH_PROFILE's
    keys (default: as BENCH_PROFILE says)."""
    profiled = PROFILE if profiled is None else profiled
    run_once, sync, check, build_s = _build_runner(mode_name, channels,
                                                   blocks, frames, profiled)
    dt, dts = _timed_windows(run_once, sync, steps)
    print(f"# [{mode_name} {channels}ch] windows "
          f"{['%.4fs' % d for d in dts]}; block "
          f"{dt / (steps * blocks) * 1e3:.5f} ms", file=sys.stderr)
    return _checked(_rate_row(f"{mode_name}_{channels}ch",
                              channels * frames * blocks * steps, channels,
                              dt, dts, steps * blocks, build_s), check)


def bench_ab(mode_a: str, mode_b: str, channels: int, blocks: int,
             steps: int, frames: int = FRAMES) -> dict:
    """Two rows in one process, their windows on adjacent dispatches (A, B,
    A, B, ...): the ratio's spread is the uncertainty of a row-vs-row
    comparison."""
    run_a, sync_a, check_a, _ = _build_runner(mode_a, channels, blocks,
                                              frames)
    run_b, sync_b, check_b, _ = _build_runner(mode_b, channels, blocks,
                                              frames)
    pairs = []
    win_steps = max(8, steps // 4)
    for _ in range(4):
        ts = []
        for run, sync in ((run_a, sync_a), (run_b, sync_b)):
            sync()
            t0 = time.perf_counter()
            for i in range(win_steps):
                run(i)
            sync()
            ts.append(time.perf_counter() - t0)
        pairs.append(tuple(ts))
    ratios = [tb / ta for ta, tb in pairs]
    samples = channels * frames * blocks * win_steps
    row = {"config": f"ab_{mode_a}_vs_{mode_b}_{channels}ch",
           "a_msps": samples / min(p[0] for p in pairs) / 1e6,
           "b_msps": samples / min(p[1] for p in pairs) / 1e6,
           "b_over_a_ratio": float(np.median(ratios)),
           "ratio_spread": max(ratios) / min(ratios),
           "pairs_s": [list(p) for p in pairs]}
    return _checked(row, lambda: {
        **{f"a_{k}": v for k, v in check_a().items()},
        **{f"b_{k}": v for k, v in check_b().items()}})


def bench_pfb(stations: int, blocks: int, steps: int,
              frames: int = FRAMES) -> dict:
    """The dense bank: one wideband capture (the AM block repeated K times)
    through a BENCH_PFB_BANK-channel filterbank into `stations` AM
    stations on bank channels 1, 2, ... (cells.make_bank_cell), AGC on at
    BENCH_AGC_STRIDE, spectra every dispatch; delivered work = every
    station demodulating the full-rate stream."""
    import torch

    from pebblesdr_tpu_torch.chain import receiver
    from pebblesdr_tpu_torch.ops import front
    m = int(os.environ.get("BENCH_PFB_BANK", "128"))
    dev = _device()
    t_c = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cell = cells.make_bank_cell(
        torch, receiver, front, blocks, stations, m, frames, FS,
        int(os.environ.get("BENCH_AGC_STRIDE", "16")), device=dev)
    run_once, sync, check, build_s = _warm(cell, 1, t_c,
                                           f"pfb {stations}st bank{m}")
    dt, dts = _timed_windows(run_once, sync, steps)
    print(f"# [pfb] windows {['%.4fs' % d for d in dts]}; block "
          f"{dt / (steps * blocks) * 1e3:.5f} ms", file=sys.stderr)
    return _checked(_rate_row(f"pfb_{stations}st_bank{m}",
                              stations * frames * blocks * steps, stations,
                              dt, dts, steps * blocks, build_s), check)


def run_one(mode: str) -> dict:
    """One row in this process (BENCH_MODE=<row>), naming its device."""
    dev = _device()
    if mode == "pfb":
        row = bench_pfb(int(os.environ.get("BENCH_PFB_STATIONS", "127")),
                        BLOCKS, STEPS)
    elif mode == "quality":
        from pebblesdr_tpu_torch.tools import quality
        from pebblesdr_tpu_torch.utils import precision
        with precision.ieee_float32():
            row = quality.quality_row(dev, 1)
    elif mode == "ab":
        a, b = os.environ.get("BENCH_AB", "am,am_i16").split(",")
        row = bench_ab(a.strip(), b.strip(), CHANNELS, BLOCKS, STEPS)
    else:
        row = bench_receiver(mode, CHANNELS, BLOCKS, STEPS)
    return {**row, "device": _device_name(dev)}


def _row_subprocess(mode: str, channels=None, blocks=None, steps=None,
                    timeout_s=None, retries=1) -> dict:
    """One matrix row in a subprocess (this module, BENCH_MODE=mode), with
    a kill timer and `retries` more attempts: a row that hangs or dies
    must not sink the matrix.  Its row, or an error row."""
    timeout_s = timeout_s or int(os.environ.get("BENCH_ROW_TIMEOUT", "900"))
    env = dict(os.environ, BENCH_MODE=mode)
    for key, v in (("BENCH_CHANNELS", channels), ("BENCH_BLOCKS", blocks),
                   ("BENCH_STEPS", steps)):
        if v is not None:
            env[key] = str(v)
    failure = None
    t0 = time.perf_counter()
    for attempt in range(retries + 1):
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "pebblesdr_tpu_torch.tools.bench"],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=timeout_s)
        except subprocess.TimeoutExpired as e:
            if e.stderr:
                sys.stderr.write(e.stderr if isinstance(e.stderr, str)
                                 else e.stderr.decode())
            failure = f"timed out after {timeout_s} s"
        else:
            sys.stderr.write(proc.stderr)
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    print(f"# row {mode}: {time.perf_counter() - t0:.1f} s",
                          file=sys.stderr)
                    d = json.loads(line)
                    return d["matrix"][0] if "matrix" in d else d
            failure = f"exit code {proc.returncode}"
        print(f"# row {mode} attempt {attempt}: {failure}", file=sys.stderr)
    return {"config": mode, "error": f"{failure} ({retries + 1} attempts)"}


def main() -> None:
    device = device_info()
    t_all = time.perf_counter()
    if MODE == "matrix":
        # the headline row gets 2x steps: a window's fixed fill and drain
        # bias short windows high
        rows = [_row_subprocess("am", CHANNELS, BLOCKS, 2 * STEPS)]
        for mode in ("wfm", "wfm_rds", "wfm_hq", "sam"):
            rows.append(_row_subprocess(mode, CHANNELS, BLOCKS, STEPS))
        # channel scaling: 256 channels (float32 and int16 entry planes)
        # and 16 (time-folded planes, twice the blocks a dispatch)
        for mode in ("am", "am_i16"):
            rows.append(_row_subprocess(mode, 256, max(8, BLOCKS // 2),
                                        max(16, STEPS // 2)))
        for mode in ("am", "wfm"):
            rows.append(_row_subprocess(mode, 16, 2 * BLOCKS, STEPS))
        rows.append(_row_subprocess("am_nb", CHANNELS, BLOCKS, STEPS))
        rows.append(_row_subprocess("pfb", blocks=2 * BLOCKS,
                                    steps=max(16, STEPS // 2)))
        rows.append(_row_subprocess("quality"))
        ok = [r for r in rows if "msps_per_chip" in r]
        head = ok[0] if ok else {"config": "none", "msps_per_chip": 0.0,
                                 "vs_baseline": 0.0}
    else:
        with contextlib.redirect_stdout(sys.stderr):    # logs off stdout
            head = run_one(MODE)
        rows = [head]
    result = {
        "metric": "iq_msps_per_chip",
        "value": head.get("msps_per_chip", 0.0),
        "unit": "Msamples/s/chip (full %s chain)" % head["config"],
        "vs_baseline": head.get("vs_baseline", 0.0),
        "matrix": rows,
        "total_bench_s": time.perf_counter() - t_all,
        "device": device,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
