"""Sweep front_means' bulk-copy ring, or front_fir's time march, on the
card: variants of csrc/front.cu with other ring constants, built side by
side and called through their C entries on the cells' planes.

    python -m pebblesdr_tpu_torch.tools.ring_sweep [variant ...]
    python -m pebblesdr_tpu_torch.tools.ring_sweep --march [variant ...]

A variant sets kMeansThreads, kMeansStageBytes (the largest stage),
kMeansRingBytes (the ring; at least two stages) and kMeansBlocksPerSm
(the persistent grid's blocks per SM).  Each variant's means and raw tails
are first checked against ops/front.py chunk_means_reference (raw tails
and int16 means exactly, float32 means within 1e-6 max |x|); then every
variant is timed at each cell in turns (CUDA events around 20 calls after
a warm-up, the mean of two turns, forwards then backwards), beside the
PyTorch call that computes the same means.  The built production kernel
is the variant "built"; the sources go to build/ring_sweep/.  Each line
gives ms per call and the share of roofline.means_bound; the last line is
one JSON object of them all.  Raises without a CUDA device.

With --march a variant sets front_fir's kPartM (outputs of one part of a
step; a step is 32 / min(F, 16) parts), kMarchStageBytes (the raw stages'
budget) and kMarchPersistent (1: a persistent grid of one block per SM
walks the work items; 0: one block per item).  Each
variant runs K1 (ops/front.py fused_front through the variant's library)
at the shapes of am_64ch, am_i16_256ch, am_16ch, wfm_64ch and wfm_hq_64ch
(the last two with their F = 8 and F = 4 plans; a variant whose layout
does not fit a cell's plan is skipped there), is checked against the
plain version once (y within 3e-5 relative), then every variant's
front_fir is timed per launch (torch.profiler over 10 calls) in turns,
forwards then backwards, beside roofline.fir_bound.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from pebblesdr_tpu_torch.kernels import build

# name: (threads, stage bytes, ring bytes, blocks per SM)
VARIANTS = {
    "built": None,                       # the constants in csrc/front.cu
    "s16k_x2": (256, 16384, 32768, 1),
    "s32k_x4": (256, 32768, 131072, 1),
    "s64k_x2": (256, 65536, 131072, 1),
    "s16k_x8": (256, 16384, 131072, 1),
    "s32k_x2_2sm": (256, 32768, 65536, 2),
    "s16k_x6_2sm": (256, 16384, 98304, 2),
    "s32k_x2_512t": (512, 32768, 65536, 1),
}
CONSTANTS = ("kMeansThreads", "kMeansStageBytes", "kMeansRingBytes",
             "kMeansBlocksPerSm")
# name: (outputs per step, stage budget, ring budget, blocks per SM,
# persistent)
MARCH_VARIANTS = {
    "built": None,
    "part8": (8, 49152, 1),
    "part16": (16, 49152, 1),
    "stages_deep": (12, 98304, 1),
    "block_per_item": (12, 49152, 0),
}
MARCH_CONSTANTS = ("kPartM", "kMarchStageBytes", "kMarchPersistent")
# (name, channels, blocks of 32768 rows, int16, protected bandwidth)
MARCH_CELLS = (("am_64ch", 64, 32, False, 30_000),
               ("am_i16_256ch", 256, 16, True, 30_000),
               ("am_16ch", 16, 64, False, 30_000),
               ("wfm_64ch", 64, 32, False, 200_000),
               ("wfm_hq_64ch", 64, 32, False, 400_000))
# (name, channels, blocks of 32768 rows, int16) of the AM cells
CELLS = (("am_64ch", 64, 32, False), ("am_256ch", 256, 16, False),
         ("am_i16_256ch", 256, 16, True), ("am_16ch", 16, 64, False))
OUT = build.BUILD_DIR.parent / "ring_sweep"


def variant_source(src: str, values: tuple[int, ...],
                   names: tuple[str, ...] = CONSTANTS) -> str:
    """front.cu with the constants `names` set to values; each constant
    must be defined exactly once."""
    for name, value in zip(names, values):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"{name} is defined {n} times in front.cu")
    return src


def _build(name: str, values, names=CONSTANTS) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    if values is None:
        return build.build("front")
    cu = OUT / f"front_{name}.cu"
    cu.write_text(variant_source((build.CSRC / "front.cu").read_text(),
                                 values, names))
    so = OUT / f"libfront_{name}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return so


def march(names: list[str]) -> list[dict]:
    """The --march sweep (module docstring)."""
    import numpy as np
    import torch

    from pebblesdr_tpu_torch.ops import decimator, front
    from pebblesdr_tpu_torch.ops.mixer import split_freq
    from pebblesdr_tpu_torch.tools.fir_cells import kernel_ms
    from pebblesdr_tpu_torch.utils import roofline

    if not torch.cuda.is_available():
        raise RuntimeError("ring_sweep needs a CUDA device")
    names = names or list(MARCH_VARIANTS)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda nm: front.declare(ctypes.CDLL(str(_build(
                f"march_{nm}", MARCH_VARIANTS[nm], MARCH_CONSTANTS)))),
            names)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    built_lib = front._lib
    rows, n = [], 32768
    gen = torch.Generator(device="cuda").manual_seed(7)
    try:
        for cell, c, k, i16, protect in MARCH_CELLS:
            p = decimator.build_plan(2_048_000, protect)
            plan = front.FrontPlan.make(decimator.compose_response(p),
                                        p.factor, "cuda")
            x = torch.randn(k * n, 2 * c, generator=gen, device="cuda") * 0.3
            x = ((x * 8192.0).round().to(torch.int16) if i16
                 else x + 0.05).contiguous()
            tunes = [split_freq(250_000.0 + 1234.5 * i, 2_048_000)
                     for i in range(c)]
            hi, lo = (torch.tensor(np.array([v[j] for v in tunes]),
                                   device="cuda") for j in (0, 1))
            z = dict(dtype=torch.float32, device="cuda")
            args = (x, torch.zeros(1, 2 * c, **z), torch.zeros(c, **z), hi,
                    lo, torch.zeros(plan.d_rows, 2 * c, **z))
            ref = front.fused_front_reference(plan, *args, n_block=n)[0]
            scale = float(ref.abs().max())
            calls = {}
            for name, lib in libs.items():
                front._lib = lambda lib=lib: lib
                try:
                    y = front.fused_front(plan, *args, n_block=n)[0]
                except ValueError as e:          # its geometry does not fit
                    print(f"{cell} {name:16s} refused: {e}", flush=True)
                    continue
                err = float((y - ref).abs().max()) / scale
                if err > 3e-5:
                    raise RuntimeError(f"{name} disagrees with the plain "
                                       f"version at {cell}: {err:.3g}")
                calls[name] = (lib, lambda: front.fused_front(
                    plan, *args, n_block=n))
            times = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                lib, fn = calls[name]
                front._lib = lambda lib=lib: lib
                fn()
                fir = [v for kk, v in kernel_ms(torch, fn).items()
                       if kk.startswith("front_fir")]
                times[name].append(fir[0])
            b = roofline.fir_bound(plan, k * n, c, x.element_size())
            for name, ts in times.items():
                ms = sum(ts) / len(ts)
                rows.append({"cell": cell, "variant": name, "ms": ms,
                             "runs": ts, "bound_ms": b["bound_ms"],
                             "share": b["bound_ms"] / ms})
                print(f"{cell} {name:16s} front_fir {ms:.4f} ms per launch "
                      f"(runs {', '.join(f'{t:.4f}' for t in ts)}; "
                      f"{b['bound_ms'] / ms:.1%} of the "
                      f"{b['bound_ms']:.4f} ms bound)", flush=True)
            del x, args, ref, calls
            torch.cuda.empty_cache()
    finally:
        front._lib = built_lib
    print(json.dumps({"device": card, "variants": {
        nm: MARCH_VARIANTS[nm] for nm in names}, "rows": rows}), flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    argv = list(argv or [])
    if argv[:1] == ["--march"]:
        return march(argv[1:])
    import torch

    from pebblesdr_tpu_torch.ops import front
    from pebblesdr_tpu_torch.utils import roofline

    if not torch.cuda.is_available():
        raise RuntimeError("ring_sweep needs a CUDA device")
    names = list(argv or VARIANTS)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda nm: _build(nm, VARIANTS[nm]),
                                        names)))
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, so in libs.items():
        fns[name] = ctypes.CDLL(str(so)).front_means_forward
        fns[name].argtypes = [i, p, i, i, i, i, i, p, p, p]
        fns[name].restype = i
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    n, raw_rows = 32768, 2048
    gen = torch.Generator(device=dev).manual_seed(7)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for cell, c, k, i16 in CELLS:
        x = torch.randn(k * n, 2 * c, generator=gen, device=dev) * 0.3 + 0.05
        if i16:
            x = (x * 8192.0).round().to(torch.int16)
        ref = front.chunk_means_reference(x, n, raw_rows)
        means, raw = torch.empty_like(ref[0]), torch.empty_like(ref[1])
        tol = 1e-6 * float(front.dequantize(x).abs().max())

        def call(fn):
            return lambda: fn(dev.index, x.data_ptr(), int(i16), k * n, 2 * c,
                              n, raw_rows, means.data_ptr(), raw.data_ptr(),
                              stream)

        calls = {name: call(fn) for name, fn in fns.items()}
        for name, fn in calls.items():
            if fn():
                raise RuntimeError(f"{name}: launch failed at {cell}")
            torch.cuda.synchronize()
            if not (torch.equal(raw, ref[1]) and (
                    torch.equal(means, ref[0]) if i16
                    else float((means - ref[0]).abs().max()) <= tol)):
                raise RuntimeError(f"{name} disagrees with the plain "
                                   f"version at {cell}")
        view = x.view(-1, front.DC_CHUNK, 2 * c)
        calls["library"] = ((lambda: torch.sum(view, 1, dtype=torch.float32))
                            if i16 else (lambda: view.mean(1)))
        times = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            calls[name]()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                calls[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 20)
        b = roofline.means_bound(k * n, 2 * c, x.element_size(), k, raw_rows)
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            rows.append({"cell": cell, "variant": name, "ms": ms,
                         "bound_ms": b["bound_ms"],
                         "share": b["bound_ms"] / ms})
            print(f"{cell} {name:14s} {ms:.4f} ms ({b['bound_ms'] / ms:.1%} "
                  f"of the {b['bound_ms']:.4f} ms bound)", flush=True)
        del x, ref, means, raw, view, calls
        torch.cuda.empty_cache()
    print(json.dumps({"device": card,
                      "variants": {nm: VARIANTS[nm] for nm in names},
                      "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
