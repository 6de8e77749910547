"""Sweep front_means' bulk-copy ring, front_fir's time march, front_comp's
pass over y or front_dc_scan's tile on the card: variants of
csrc/front.cu with other constants, built side by side and called through
their C entries on the cells' planes.

    python -m pebblesdr_tpu_torch.tools.ring_sweep [variant ...]
    python -m pebblesdr_tpu_torch.tools.ring_sweep --march [variant ...]
    python -m pebblesdr_tpu_torch.tools.ring_sweep --comp [variant ...]
    python -m pebblesdr_tpu_torch.tools.ring_sweep --scan [variant ...]
    python -m pebblesdr_tpu_torch.tools.ring_sweep --probe [variant ...]

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
walks the work items; 0: one block per item), or writes K1's carried
history after a block's items (history_last) or through a call of a
function of its own (history_call), or not at all (no_history, a probe
whose tail' is not written).  Each
variant runs K1 (ops/front.py fused_front through the variant's library)
at the shapes of am_64ch, am_i16_256ch, am_16ch, wfm_64ch and wfm_hq_64ch
(the last two with their F = 8 and F = 4 plans; a variant whose layout
does not fit a cell's plan is skipped there), is checked against the
plain version once (y within 3e-5 relative), then every variant's
front_fir is timed per launch (torch.profiler over 10 calls) in turns,
forwards then backwards, beside roofline.fir_bound.

With --comp a variant sets front_comp's kCompWarps (warps of a block) or
kCompBlocksPerSm (resident blocks per SM; two cap a thread at 64
registers), or replaces source text (row_tails: the y-tails stored row by row
as d is formed, not as boxes from the stage); the probes (no_atan2: the
discriminator without its atan2; fir1: one tap per output; no_form: steps
that form no d) are timed only, their outputs wrong by design.  Each variant runs K1's hq form at wfm_hq_64ch's shape; every
other variant's outputs must equal the built kernel's bit for bit; then
front_comp is timed per launch (torch.profiler over 10 calls) in turns,
forwards then backwards, beside roofline.comp_bound.

With --scan a variant sets front_dc_scan's kScanLanes (lanes per block at
most: fewer lanes are more, smaller blocks) or kScanBatch (the chunks a
long segment's chain reads at once), or replaces source text; the probes
(no_copy: a long segment's tile not landed; no_chains: no chains over
the tile; no_seed_chain: the seeds not chained) are timed only, their
outputs wrong by design.
Each variant runs the scan alone (the C entry front_dc_scan_forward) on
the chunk means of the shapes K1 gives it at am_64ch, am_16ch and
am_256ch; m and dc' must equal ops/front.py dc_scan_emulate bit for bit;
then each is timed per launch in turns beside roofline.scan_bound.

With --probe a variant replaces source text of probe_toeplitz (the K1
probes' tensor-core product): mma_sync runs the dense forms on mma.sync
m16n8k8 instead of wgmma, cvt_split splits E into TF32 with
cvt.rna.tf32.f32 instead of its two integer operations; the probes
(one_pass: the dense product's Wh Eh pass alone; no_mma: no product;
no_mix: no chunk mixed or split; no_fetch: no DC or fine phasor loaded)
are timed only, their outputs wrong by design.  Each variant
runs the front forms v2, v3, v4 and v5 (kt 4) at the probe bench's shape
(8 x 32768 rows x 64 channels, sub 2048, the AM plan); every other
variant's y must be within 3e-5 of the plain version; then
probe_toeplitz is timed per launch in turns beside kprobe.probe_bound.
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
# ({constant: value}, [(source text, replacement)]) variants of the march:
# K1's carried history written after each block's items instead of before
# them, or by a call of a function of its own, and (a probe, tail' wrong)
# not written at all
_HISTORY_CALL = ("  march_history<Tx, NB>(x, a);        "
                 "// K1's carried history\n")
MARCH_VARIANTS.update({
    "history_last": ({}, [(_HISTORY_CALL, ""), (
        "      pos += g.step_rows;\n    }\n  }\n}",
        "      pos += g.step_rows;\n    }\n  }\n"
        "  march_history<Tx, NB>(x, a);\n}")]),
    "no_history": ({}, [(_HISTORY_CALL, "")]),
    "history_call": ({}, [("__device__ __forceinline__ void march_history(",
                           "__device__ __noinline__ void march_history(")]),
})
# name: ({constant: value}, [(source text, replacement)])
_ROW_TAILS = ("  c.tail_tma = c.tma && c.ytail != nullptr",
              "  c.tail_tma = false && c.ytail != nullptr")
COMP_VARIANTS = {
    "built": ({}, []),
    "w16_b1": ({"kCompBlocksPerSm": 1}, []),
    "w8_b2": ({"kCompWarps": 8}, []),
    "row_tails": ({}, [_ROW_TAILS]),
    "no_atan2": ({}, [("return __fmul_rn(atan2f(im, re), gain);",
                       "return __fmul_rn(__fadd_rn(im, re), gain);")]),
    "fir1": ({}, [("if (i >= 0 && i < kMaxCompTaps && i < a.tc)",
                   "if (i == 0)")]),
    "no_form": ({}, [("      form(t0, kCompStepRows, pos, false);",
                      "      (void)t0;")]),
}
COMP_PROBES = ("no_atan2", "fir1", "no_form")
# name: ({constant: value}, [(source text, replacement)]); the probes'
# outputs are wrong by design and not checked
SCAN_VARIANTS = {
    "built": ({}, []),
    "l4": ({"kScanLanes": 4}, []),
    "batch8": ({"kScanBatch": 8}, []),
    "no_copy": ({}, [("      __pipeline_memcpy_async(\n          scan_tile",
                      "      if (k < 0) __pipeline_memcpy_async(\n          scan_tile")]),
    "no_chains": ({}, [("    batches(tile, kScanLanes, summary);",
                        "    (void)tile;"),
                       ("    batches(tile, kScanLanes, walk);",
                        "    (void)tile;")]),
    "no_seed_chain": ({}, [("      m = __fmaf_rn(seg_p[q][tx], m, seg_r[q][tx]);",
                            "      m = seg_r[q][tx];")]),
}
SCAN_PROBES = ("no_copy", "no_chains", "no_seed_chain")
# name: ({}, [(source text, replacement)]); the probes' outputs are wrong by
# design and not checked
_MMA3 = ("""        wg_mma<kNw>(acc, ah, bh, s8);
        wg_mma<kNw>(acc, ah, bl, 1);
        wg_mma<kNw>(acc, al, bh, 1);""",
         "        (void)ah; (void)al; (void)bh; (void)bl;")
PROBE_VARIANTS = {
    "built": ({}, []),
    "mma_sync": ({}, [("constexpr bool kPWgmma = true;",
                       "constexpr bool kPWgmma = false;")]),
    "one_pass": ({}, [(_MMA3[0], """        wg_mma<kNw>(acc, ah, bh, s8);
        (void)al; (void)bl;""")]),
    "cvt_split": ({}, [(
        "  return __uint_as_float((__float_as_uint(x) + 0x1000u) & "
        "0xFFFFE000u);",
        "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : "
        "\"f\"(x));\n  return __uint_as_float(r);")]),
    "no_mma": ({}, [_MMA3, ("          mma_tf32(acc + 4 * j, ah, vh);\n"
                            "          mma_tf32(acc + 4 * j, ah, vl);\n"
                            "          mma_tf32(acc + 4 * j, al, vh);",
                            "          (void)vh; (void)vl;")]),
    "no_mix": ({}, [("      mix_chunk(q + 1, cur);", "      (void)cur;")]),
    "no_fetch": ({}, [("    if (kAhead2 && q + 2 < total) fetch(q + 2, nxt);\n"
                       "    if (!kAhead2 && q + 1 < total) fetch(q + 1, cur);",
                       "    (void)nxt;")]),
}
PROBE_PROBES = ("one_pass", "no_mma", "no_mix", "no_fetch")
PROBE_FORMS = (("v2", 1), ("v3", 1), ("v4", 1), ("v5", 4))
# (cell, chunks, lanes) of the scans K1 launches
SCAN_CELLS = (("am_64ch", 2048, 128), ("am_16ch", 4096, 32),
              ("am_256ch", 1024, 512))
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
                   names: tuple[str, ...] = CONSTANTS,
                   subs: tuple = ()) -> str:
    """front.cu with the constants `names` set to values and the text subs
    [(old, new)] replaced; each constant must be defined exactly once, each
    text must occur exactly once."""
    for name, value in zip(names, values):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"{name} is defined {n} times in front.cu")
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def _build(name: str, values, names=CONSTANTS, subs=()) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    if values is None:
        return build.build("front")
    cu = OUT / f"front_{name}.cu"
    cu.write_text(variant_source((build.CSRC / "front.cu").read_text(),
                                 values, names, subs))
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
    libs = _variant_libs("march", names, MARCH_VARIANTS, MARCH_CONSTANTS)
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


def _variant_libs(prefix: str, names: list[str], variants: dict,
                  constants: tuple[str, ...] = ()) -> dict:
    """The libraries of the named variants, built side by side: a variant
    is None (the built kernel), a tuple of the constants' values, or
    ({constant: value}, [(old, new)])."""
    from pebblesdr_tpu_torch.ops import front

    def lib(nm):
        v = variants[nm]
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], dict):
            so = _build(f"{prefix}_{nm}", tuple(v[0].values()),
                        tuple(v[0]), v[1])
        else:
            so = _build(f"{prefix}_{nm}", v, constants)
        return front.declare(ctypes.CDLL(str(so)))

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(lib, names)))


def _in_turns(torch, calls: dict, kernel: str) -> dict:
    """Device ms per launch of `kernel` for each of calls, timed forwards
    then backwards (torch.profiler over 10 calls each time)."""
    from pebblesdr_tpu_torch.tools.fir_cells import kernel_ms
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        calls[name]()
        times[name].append(next(v for kk, v in kernel_ms(
            torch, calls[name], pattern=kernel + r"\w*").items()
            if kk.startswith(kernel)))
    return times


def comp(names: list[str]) -> list[dict]:
    """The --comp sweep (module docstring)."""
    import numpy as np
    import torch

    from pebblesdr_tpu_torch.demod import wfm
    from pebblesdr_tpu_torch.ops import decimator, front
    from pebblesdr_tpu_torch.ops.mixer import split_freq
    from pebblesdr_tpu_torch.utils import roofline

    if not torch.cuda.is_available():
        raise RuntimeError("ring_sweep needs a CUDA device")
    names = names or list(COMP_VARIANTS)
    libs = _variant_libs("comp", names, COMP_VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    built_lib = front._lib
    n, c, k, fs = 32768, 64, 32, 2_048_000
    p = decimator.build_plan(fs, 400_000)
    plan = front.FrontPlan.make(decimator.compose_response(p), p.factor,
                                "cuda")
    gen = torch.Generator(device="cuda").manual_seed(10)
    z = dict(dtype=torch.float32, device="cuda")
    x = (torch.randn(k * n, 2 * c, generator=gen, device="cuda") * 0.3
         + 0.05).contiguous()
    hi, lo = (torch.full((c,), float(v), device="cuda")
              for v in split_freq(250_000.0, fs))
    taps = wfm.WFMConfig.make(fs / p.factor / 2, comp_decim=2).comp_taps
    hr, zt = front.comp_hist_rows(len(taps)), 2048
    args = (x, torch.zeros(1, 2 * c, **z), torch.zeros(c, **z), hi, lo,
            torch.zeros(plan.d_rows, 2 * c, **z))
    kw = dict(n_block=n, raw_rows=2048,
              disc_gain=fs / p.factor / (2 * np.pi * 75_000.0),
              disc_last=0.1 * torch.randn(1, 2 * c, generator=gen,
                                          device="cuda"),
              y_tail_rows=zt, comp_taps=taps,
              comp_hist=0.1 * torch.randn(hr, c, generator=gen,
                                          device="cuda"))
    rows = []
    try:
        front._lib = built_lib
        ref = front.fused_front(plan, *args, **kw)
        calls = {}
        for name, lib in libs.items():
            front._lib = lambda lib=lib: lib
            out = front.fused_front(plan, *args, **kw)
            if name not in COMP_PROBES and not all(
                    torch.equal(a, b) for a, b in zip(out, ref)):
                raise RuntimeError(f"{name}: outputs differ from the built "
                                   f"kernel's bits")
            calls[name] = (lambda lib=lib: (
                setattr(front, "_lib", lambda: lib),
                front.fused_front(plan, *args, **kw)))
        times = _in_turns(torch, calls, "front_comp")
        b = roofline.comp_bound(k * n // p.factor, c, len(taps), hr, k, zt)
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            rows.append({"variant": name, "ms": ms, "runs": ts,
                         "bound_ms": b["bound_ms"],
                         "share": b["bound_ms"] / ms})
            print(f"wfm_hq_64ch {name:14s} front_comp {ms:.4f} ms per "
                  f"launch (runs {', '.join(f'{t:.4f}' for t in ts)}; "
                  f"{b['bound_ms'] / ms:.1%} of the {b['bound_ms']:.4f} ms "
                  f"bound)" + (" probe" if name in COMP_PROBES else ""),
                  flush=True)
    finally:
        front._lib = built_lib
    print(json.dumps({"device": card, "variants": {
        nm: COMP_VARIANTS[nm] for nm in names}, "rows": rows}), flush=True)
    return rows


def scan(names: list[str]) -> list[dict]:
    """The --scan sweep (module docstring)."""
    import numpy as np
    import torch

    from pebblesdr_tpu_torch.ops import front
    from pebblesdr_tpu_torch.utils import roofline

    if not torch.cuda.is_available():
        raise RuntimeError("ring_sweep needs a CUDA device")
    names = names or list(SCAN_VARIANTS)
    libs = _variant_libs("scan", names, SCAN_VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    a32, b32 = front.chunk_ewma(0.9999 ** front.DC_CHUNK)
    rng = np.random.default_rng(11)
    rows = []
    for cell, nchunk, lanes in SCAN_CELLS:
        mu = (rng.standard_normal((nchunk, lanes)) * 0.01 + 0.05).astype(
            np.float32)
        dc = np.full((1, lanes), 0.02, np.float32)
        em, ed = front.dc_scan_emulate(mu, dc, a32, b32)
        mu_d, dc_d = torch.from_numpy(mu).to(dev), torch.from_numpy(dc).to(dev)
        m, d = torch.empty_like(mu_d), torch.empty_like(dc_d)
        calls = {}
        for name, lib in libs.items():
            def call(lib=lib):
                m.copy_(mu_d)
                err = lib.front_dc_scan_forward(
                    dev.index, m.data_ptr(), nchunk, lanes, dc_d.data_ptr(),
                    d.data_ptr(), a32, b32, stream)
                if err:
                    raise RuntimeError(f"front_dc_scan launch failed: {err}")
            call()
            torch.cuda.synchronize()
            if name not in SCAN_PROBES and not (
                    np.array_equal(m.cpu().numpy().view(np.uint32),
                                   em.view(np.uint32))
                    and np.array_equal(d.cpu().numpy().view(np.uint32),
                                       ed.view(np.uint32))):
                raise RuntimeError(f"{name} disagrees with dc_scan_emulate "
                                   f"at {cell}")
            calls[name] = call
        times = _in_turns(torch, calls, "front_dc_scan")
        b = roofline.scan_bound(nchunk, lanes)
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            rows.append({"cell": cell, "variant": name, "ms": ms, "runs": ts,
                         "bound_ms": b["bound_ms"],
                         "share": b["bound_ms"] / ms})
            print(f"{cell} {name:10s} front_dc_scan {ms:.4f} ms per launch "
                  f"(runs {', '.join(f'{t:.4f}' for t in ts)}; "
                  f"{b['bound_ms'] / ms:.1%} of the {b['bound_ms']:.4f} ms "
                  f"bound)" + (" probe" if name in SCAN_PROBES else ""),
                  flush=True)
    print(json.dumps({"device": card, "variants": {
        nm: SCAN_VARIANTS[nm] for nm in names}, "rows": rows}), flush=True)
    return rows


def probe(names: list[str]) -> list[dict]:
    """The --probe sweep (module docstring)."""
    import numpy as np
    import torch

    from pebblesdr_tpu_torch.ops import decimator, front, kprobe

    if not torch.cuda.is_available():
        raise RuntimeError("ring_sweep needs a CUDA device")
    names = names or list(PROBE_VARIANTS)
    libs = {nm: kprobe.declare(lib) for nm, lib in _variant_libs(
        "probe", names, PROBE_VARIANTS).items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    built_lib = kprobe._lib
    n, c, k, fs, sub = 32768, 64, 8, 2_048_000, 2048
    p = decimator.build_plan(fs, 30_000)
    plan = front.FrontPlan.make(decimator.compose_response(p), p.factor,
                                "cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    z = dict(dtype=torch.float32, device="cuda")
    x = (torch.randn(k * n, 2 * c, generator=gen, device="cuda") * 0.5
         + 0.2).contiguous()
    f_hi, f_lo = np.full(c, 0.1220703125), np.zeros(c)
    rows = []
    try:
        for variant, kt in PROBE_FORMS:
            args = kprobe.to_layout(variant, x, torch.zeros(1, 2 * c, **z),
                                    0.1 * torch.randn(plan.d_rows, 2 * c,
                                                      generator=gen,
                                                      device="cuda"),
                                    torch.zeros(c, **z))
            run = (lambda: kprobe.probe_front(
                variant, plan, args[0], args[1], args[3], f_hi, f_lo,
                args[2], sub, kt))
            ref = kprobe.probe_front_reference(variant, plan, args[0],
                                               args[1], args[3], f_hi, f_lo,
                                               args[2], sub, kt)[0]
            scale = float(ref.abs().max())
            calls = {}
            for name, lib in libs.items():
                kprobe._lib = lambda lib=lib: lib
                y = run()[0]
                err = float((y - ref).abs().max()) / scale
                if name not in PROBE_PROBES and err > 3e-5:
                    raise RuntimeError(f"{name} disagrees with the plain "
                                       f"version at {variant}: {err:.3g}")
                calls[name] = (lambda lib=lib: (
                    setattr(kprobe, "_lib", lambda: lib), run()))
            times = _in_turns(torch, calls, "probe_toeplitz")
            b = kprobe.probe_bound(variant, sub, kt, c, k * n, plan.factor,
                                   plan.d_rows, plan.h.numel())
            tag = variant + (f" kt={kt}" if kt > 1 else "")
            for name, ts in times.items():
                ms = sum(ts) / len(ts)
                rows.append({"form": tag, "variant": name, "ms": ms,
                             "runs": ts, "bound_ms": b["bound_ms"],
                             "tflops": 3 * b["product_flops"] / ms / 1e9})
                print(f"{tag:8s} {name:10s} probe_toeplitz {ms:.4f} ms per "
                      f"launch (runs {', '.join(f'{t:.4f}' for t in ts)}; "
                      f"{3 * b['product_flops'] / ms / 1e9:.1f} TFLOP/s of "
                      f"TF32 passes)"
                      + (" probe" if name in PROBE_PROBES else ""),
                      flush=True)
            del args, ref, calls
    finally:
        kprobe._lib = built_lib
    print(json.dumps({"device": card, "variants": {
        nm: PROBE_VARIANTS[nm] for nm in names}, "rows": rows}), flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    argv = list(argv or [])
    if argv[:1] == ["--probe"]:
        return probe(argv[1:])
    if argv[:1] == ["--march"]:
        return march(argv[1:])
    if argv[:1] == ["--comp"]:
        return comp(argv[1:])
    if argv[:1] == ["--scan"]:
        return scan(argv[1:])
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
