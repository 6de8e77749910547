"""K2, the stereo tail (ops/wfm_tail.py), at the shapes of its cells on the
card, for the checkout at ROOT (default: this one; any checkout of the
port with a chip_smoke.py, e.g. a parent commit unpacked under build/).

    python pebblesdr_tpu_torch/tools/tail_cells.py [ROOT [TAG]]

(run as a script, not with -m, so that ROOT's package is the one imported)

Shapes (PERF.md section 4): wfm_64ch (composite [131072, 64]; also
wfm_rds_64ch's, and wfm_hq_64ch's after K1e) and wfm_16ch ([262144, 16]),
the receiver's plan (235 taps, F = 4, ell 256, sub 2048).  At each, K2 is
first checked against wfm_tail_reference over two streaming calls from a
random history (3e-5 relative, chip_smoke.FRONT_RTOL); then timed: the
device time of each CUDA kernel it launches, per launch and per call,
over 10 calls (torch.profiler), CUDA events around 10 calls after 3
warm-ups, and the host's enqueue ms per call over 20 calls (no sync).
The last line is one JSON object of the results.  Raises without a CUDA
device.

    python pebblesdr_tpu_torch/tools/tail_cells.py --sweep [variant ...]

builds variants of this checkout's csrc/wfm_tail.cu side by side (into
build/tail_sweep/; SWEEP below: other warps per block, FIR warps and
outputs per warp, ring steps, stage budgets, loop unrolling and the
decimation left to run time, and probes that are timed only, their
outputs wrong by design: "no_sine" demuxes with the phase in place of
its sine, "no_fir" skips the FIR's multiply-adds, "no_demux" the steps'
demux, "no_store" the audio's stores), checks each other variant against
wfm_tail_reference once at each shape (one that disagrees is reported
and not timed), and times every variant's launch (torch.profiler over
10 calls) in turns, forwards then backwards.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# (cell, channels, composite rows)
CELLS = (("wfm_64ch", 64, 131072), ("wfm_16ch", 16, 262144))
_NO_FIR = ("poly::fir_column<kPartM, DPS>(",
           "if (false) poly::fir_column<kPartM, DPS>(")
_NO_DEMUX = ("demux(stage(u), g.step_rows, pos);", "(void)pos;")
# name: ({constant: value}, [(source text, replacement)]); the probes'
# outputs are wrong by design and not checked
SWEEP = {
    "built": ({}, []),
    "w8": ({"kWarps": 8}, []),
    "w16_m8": ({"kFirWarps": 16, "kPartM": 8}, []),
    "ring1": ({"kRingSteps": 1}, []),
    "stages3": ({"kStageBudget": 98304}, []),
    "generic_f": ({}, [("if (s.dps == 60 && F == 4) return", "if (false) return")]),
    "demux_unroll1": ({}, [("#pragma unroll 4", "#pragma unroll 1")]),
    "demux_unroll8": ({}, [("#pragma unroll 4", "#pragma unroll 8")]),
    "no_sine": ({}, [("return 2.0f * sinf(ph);", "return ph;")]),
    "no_fir": ({}, [_NO_FIR]),
    "no_demux": ({}, [_NO_DEMUX]),
    "no_fir_demux": ({}, [_NO_FIR, _NO_DEMUX]),
    "no_store": ({}, [("if (o < o_e) yl[", "if (o < o_e && acc[ol] == 1.5f) yl[")]),
}
PROBES = ("no_sine", "no_fir", "no_demux", "no_fir_demux", "no_store")


def kernel_ms(torch, fn, reps: int = 10) -> dict:
    """{kernel: (device ms per launch, launches per call)} of each
    wfm_tail_* kernel fn launches, over reps calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        m = re.search(r"wfm_tail_\w+", ev.key)
        if us and m:
            tot, n = rows.get(m.group(0), (0.0, 0))
            rows[m.group(0)] = (tot + us / 1e3, n + ev.count)
    return {k: (tot / n, n / reps) for k, (tot, n) in rows.items()}


def variant_source(src: str, consts: dict, subs: list) -> str:
    """wfm_tail.cu with its constants set and text replaced; each must
    occur exactly once."""
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"{name} is defined {n} times in wfm_tail.cu")
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def sweep(names: list[str]) -> list[dict]:
    """The --sweep mode (module docstring)."""
    import concurrent.futures
    import ctypes

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("tail_cells needs a CUDA device")

    import chip_smoke as cs
    from pebblesdr_tpu_torch.demod import wfm
    from pebblesdr_tpu_torch.kernels import build
    from pebblesdr_tpu_torch.ops import wfm_tail
    from pebblesdr_tpu_torch.utils import roofline

    names = names or list(SWEEP)
    out_dir = build.BUILD_DIR.parent / "tail_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "wfm_tail.cu").read_text()

    def compile_variant(name):
        cu, so = out_dir / f"wfm_tail_{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(variant_source(src, *SWEEP[name]))
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                               str(build.CSRC), "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return so

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        sos = dict(zip(names, pool.map(compile_variant, names)))
    libs = {name: wfm_tail.declare(ctypes.CDLL(str(so)))
            for name, so in sos.items()}
    built_lib = wfm_tail._lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    cfg = wfm.WFMConfig.make(256_000.0)
    plan = wfm_tail.TailPlan.make(cfg.audio_taps, cfg.audio_decim, 256, 2048,
                                  "cuda")
    rows = []
    try:
        for cell, c, n in CELLS:
            args = cs.tail_inputs(torch, c, n, plan.ell,
                                  np.random.default_rng(5))
            hist = torch.zeros(plan.d_rows, 2 * c, device="cuda")
            ref = wfm_tail.wfm_tail_reference(plan, *args, hist)
            calls = {}
            for name, lib in libs.items():
                wfm_tail._lib = lambda lib=lib: lib
                got = wfm_tail.wfm_tail(plan, *args, hist)
                torch.cuda.synchronize()
                err = max(cs.rel_err(a, b) for a, b in zip(got, ref))
                if name not in PROBES and not err <= cs.FRONT_RTOL:
                    print(f"{cell} {name:10s} disagrees with the plain "
                          f"version ({err:.3g}): not timed", flush=True)
                    continue
                calls[name] = lambda: wfm_tail.wfm_tail(plan, *args, hist)
            times = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                wfm_tail._lib = lambda lib=libs[name]: lib
                times[name].append(sum(ms * per for ms, per in kernel_ms(
                    torch, calls[name]).values()))
            b = roofline.k2_bound(plan, n, c)
            for name, ts in times.items():
                ms = sum(ts) / len(ts)
                rows.append({"cell": cell, "variant": name, "ms": ms,
                             "runs": ts, "bound_ms": b["bound_ms"]})
                print(f"{cell} {name:10s} K2 {ms:.4f} ms per launch (runs "
                      f"{', '.join(f'{t:.4f}' for t in ts)}; "
                      f"{b['bound_ms'] / ms:.1%} of the {b['bound_ms']:.4f} "
                      f"ms bound)" + (" probe" if name in PROBES else ""),
                      flush=True)
            del args, hist, ref
            torch.cuda.empty_cache()
    finally:
        wfm_tail._lib = built_lib
    print(json.dumps({"device": card, "variants": {
        nm: SWEEP[nm] for nm in names}, "rows": rows}), flush=True)
    return rows


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--sweep"]:
        sys.path.insert(0, os.getcwd())
        return sweep(argv[1:])
    root = os.path.abspath(argv[0] if argv else os.getcwd())
    tag = argv[1] if len(argv) > 1 else os.path.basename(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pebblesdr_tpu_torch.demod import wfm
    from pebblesdr_tpu_torch.ops import wfm_tail

    if not torch.cuda.is_available():
        raise RuntimeError("tail_cells needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{tag}] {card}", flush=True)
    cfg = wfm.WFMConfig.make(256_000.0)
    plan = wfm_tail.TailPlan.make(cfg.audio_taps, cfg.audio_decim, 256, 2048,
                                  "cuda")
    res = {}
    for name, c, n in CELLS:
        rng = np.random.default_rng(5)
        hist_k = hist_r = torch.from_numpy(rng.standard_normal(
            (plan.d_rows, 2 * c)).astype(np.float32) * 0.3).cuda()
        worst = 0.0
        for _ in range(2):
            args = cs.tail_inputs(torch, c, n, plan.ell, rng)
            out_k = wfm_tail.wfm_tail(plan, *args, hist_k)
            out_r = wfm_tail.wfm_tail_reference(plan, *args, hist_r)
            torch.cuda.synchronize()
            worst = max(worst, *(cs.rel_err(a, b)
                                 for a, b in zip(out_k, out_r)))
            hist_k, hist_r = out_k[1], out_r[1]
        if not worst <= cs.FRONT_RTOL:
            raise RuntimeError(f"[{tag}] {name}: K2 disagrees with its plain "
                               f"version ({worst:.3g} > {cs.FRONT_RTOL})")
        del out_k, out_r

        def call():
            return wfm_tail.wfm_tail(plan, *args, hist_k)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        events = cs.time_cuda(torch, call, 10)
        launches = kernel_ms(torch, call)
        h0 = time.perf_counter()
        for _ in range(20):
            call()
        host = (time.perf_counter() - h0) / 20 * 1e3
        torch.cuda.synchronize()
        device = sum(ms * per for ms, per in launches.values())
        print(f"[{tag}] {name}: K2 {device:.4f} ms of device time per call "
              f"({sum(per for _, per in launches.values()):g} launches: "
              + ", ".join(f"{k} {ms:.4f} x{per:g}"
                          for k, (ms, per) in sorted(launches.items()))
              + f"), {events:.4f} ms per call by events, host "
              f"{host:.4f} ms per call; worst relative error {worst:.3g}",
              flush=True)
        res[name] = {"device_ms": device, "events_ms": events,
                     "host_ms": host, "worst": worst,
                     "launch_ms": {k: ms for k, (ms, _) in launches.items()},
                     "launches_per_call": sum(p for _, p in launches.values())}
        del args, hist_k, hist_r
        torch.cuda.empty_cache()
    out = {"tag": tag, "device": card, "cells": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
