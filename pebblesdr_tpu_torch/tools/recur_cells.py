"""K3 and K3c (csrc/recur.cu pll_scan, pll_chunk_scan: the carrier loops on
the loop kernel), K4 (agc_scan, the scan AGC's smoother) and K6 (ook_scan,
the OOK detector) at the main path's shapes on the card, beside another
build of recur.cu (a parent commit's, say) timed in turns in the same
process.

    python -m pebblesdr_tpu_torch.tools.recur_cells [--ptxas] [--k3]
        [--against RECUR_CU [TAG]]

Shapes (tag, rows, steps): K3 atan2 at NFM "pll"'s [64, 32768] and
sam_short_64ch's [64, 8192], costas at wfm_rds_scan_64ch's [64, 9728],
cross and pilot at the WFM composite's first 8192 steps [64, 8192] (19 kHz
at 256 ksps), K3c at the SAM loop's [64, 4096] chunk phasors with the pilot
flag off and on (seeded synthetic signals at each caller's constants; --k3:
these rows only); K4 "long" (the hang) and "med" at [64, 2048]
(a dispatch's envelope at am_64ch, stride 16: chip_smoke.py phase 30's
input); K6 in each of its six threshold modes at [64, 2048] and K6 "peak"
at cw_taps_64ch's [64, 34] frames (cells.ook_powers, phase 37's),
the three powers as the three columns of one [C, F, 3] tensor, the layout
goertzel_power hands MorseModem.  At
every shape each library is first held to its plain version (K3's and
K3c's outputs and state equal bit for bit; K4's levels and state equal;
K6's marks equal and its state within 1e-6 of each
leaf's scale, on powers whose decision margin is asserted; one that
disagrees raises), then the libraries are timed in turns, this one, the
other, the other, this one: the device ms per launch of the kernel
(torch.profiler over 10 calls, cells.kernel_times) and CUDA
events per call over 10 calls after 3 warm-ups.  A call is the wrapper's
whole host path: for this checkout the wrappers themselves
(ops/pll.py pll_scan, pll_chunk_scan, ops/agc.py agc_scan, ops/goertzel.py
ook_detect), for another library the
host path its own C signature asks for (K3's and K3c's through
pll.loop_launch; a K6 entry without
recur_short_plan takes the three powers stacked into [C, F, 4] float4
frames and float32 marks, as its wrapper did).  Each time is printed with
its share of the bound (utils/roofline.py pll_scan_bound,
pll_chunk_bound, agc_scan_bound, ook_scan_bound)
at the chain probe fed from memory (ops/pll.py chain_probe(fed=True));
the register-only probe's reading is printed beside it, and so is the
launch floor (the register-only probe over no step, per launch: the fed
probe stages its pattern first).

    python -m pebblesdr_tpu_torch.tools.recur_cells --sweep [--short]
        [--source RECUR_CU] [variant ...]

builds timing-only variants of a recur.cu (this checkout's, or RECUR_CU
with its directory's headers) side by side into build/recur_sweep/
(text replaced, each text found once) and times each in turns, forwards
then backwards (torch.profiler per launch).  By default the loop kernel's
variants (SWEEP_LOOP: the layout, 1 to 16 chains a warp and 1 to 4 chain
warps a block, and the stateless input work in the chain lane's step
instead of on the copy warp, each held to the plain version bit for bit;
and timing-only probes, probe_*) at the K3 / K3c shapes (with --sass
DIR the variants' SASS and chain-loop summaries instead, sass_* variants
compile-only); with --short
the K4 / K6 kernel's
(SWEEP_TILED for a source whose K4 and K6 run on a tiled kernel,
SWEEP_SHORT for one with recur_short_kernel) at [64, 2048] (K4 long and
med, K6 in each mode) and at cw_taps_64ch's [64, 34] (K6 peak), where
"built" is held to the plain version and the others drop a part of the
kernel's work (their outputs wrong by design) to attribute the time per
step.

--against builds RECUR_CU (its directory's headers on the include path)
into build/recur_cells/ with this checkout's nvcc flags.  --sass DIR
writes the SASS of K3 in each detector, K3c in both forms, K4 without the
hang and K6 in compare, peak and average mode
(this build's, and RECUR_CU's) to DIR/recur_sass_<tag>.txt, prints each
K3 / K3c kernel's and fed probe's chain loop (its instructions and
convergence barriers, loop_summary) and stops.  --ptxas builds
this checkout's recur.cu (and RECUR_CU, where one is given) once more with
-Xptxas -v and prints the registers, stack frame, spills and shared memory
of every K3 / K3c / K4 / K6 kernel instantiation and probe.  The last
line is one JSON object of the results.  Raises without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

# K3 / K3c: (tag, probe form, rows, steps)
LOOP_SHAPES = (("atan2 nfm", "atan2", 64, 32768),
               ("atan2 sam_short", "atan2", 64, 8192),
               ("costas", "costas", 64, 9728),
               ("cross", "cross", 64, 8192),
               ("pilot", "pilot", 64, 8192),
               ("chunk", "chunk", 64, 4096),
               ("chunk pilot", "chunk pilot", 64, 4096))
K4_SHAPES = (("agc long", 64, 2048), ("agc med", 64, 2048))
OOK_LONG = (64, 2048)
OOK_CW = (64, 34)          # cw_taps_64ch: 16 ms blocks, 480-sample frames
CALL_REPS, WARM = 10, 3
# --sass: K3 in each detector, K3c in both forms, K4 without the hang, K6
# in compare, peak and average mode
SASS_PATTERN = (r"PllStepILi[0-3]E|ChunkStepILb[01]E|AgcStepILb0|"
                r"OokStepILi[012]E")

_LOOP = ("      float o[2];\n#pragma unroll 4\n      for (int t = 0; t < len;"
         " ++t) {\n        s.step(src[t], o);")
# recur_kernel's parts (a source whose K4 and K6 run on it): name ->
# [(source text, replacement)]
SWEEP_TILED = {
    "built": [],
    # the chain reads two frames of the tile once and alternates them
    # every 8 steps instead of one frame from shared memory a step
    "in_regs": [(_LOOP, "      float o[2];\n      const In xa = src[0], "
                 "xb = src[len - 1];\n#pragma unroll 4\n      for (int t = 0;"
                 " t < len; ++t) {\n        s.step(((t >> 3) & 1) ? xa : xb,"
                 " o);")],
    # no output written to the shared tile
    "no_store": [("        out_s[i & 1][0][tid][t] = o[0];\n", "")],
    # no block barrier per tile: the chain never waits for the stagers
    "no_barrier": [("    __syncthreads();\n  }\n  if (st >= 0 && tiles > 0) "
                    "store_tile(tiles - 1);",
                    "  }\n  if (st >= 0 && tiles > 0) store_tile(tiles - 1);")],
    # the stagers copy nothing inside the loop (the barriers stay)
    "no_stage": [("      if (i + 1 < tiles) load_tile(i + 1);\n"
                  "      if (i > 0) store_tile(i - 1);\n", "")],
}
SWEEP_TILED["chain_only"] = [sub for name in ("in_regs", "no_store",
                                              "no_barrier", "no_stage")
                             for sub in SWEEP_TILED[name]]
# recur_short_kernel's parts (a source whose K4 and K6 run on it)
SWEEP_SHORT = {
    "built": [],
    # the chain lanes read no frames after a segment's first group
    "in_regs": [("      sh_fetch<TRIO>(nxt, xs, fs, t + kShU);\n",
                 "      nxt = cur;\n")],
    # a full group's outputs are not stored
    "no_out": [("        sh_put(orow_i + t + j, sh_out(s, o2));\n", "")],
    # no step in a full group (the data movement alone)
    "no_chain": [("        s.step(x, o2);\n        sh_put(orow_i + t + j,",
                  "        sh_put(orow_i + t + j,")],
    # no lower bound of one block per SM on the launch (ptxas then keeps
    # the loop in fewer registers and schedules it otherwise)
    "no_min_blocks": [("__launch_bounds__(kShThreads, 1)",
                       "__launch_bounds__(kShThreads)")],
    # 8 or 32 channels a block (built: 16; the parent's kernel: 8)
    "block8": [("constexpr int kShLanes = 16;", "constexpr int kShLanes = 8;")],
    "block32": [("constexpr int kShLanes = 16;",
                 "constexpr int kShLanes = 32;")],
}
SWEEP_SHORT["chain_only"] = SWEEP_SHORT["in_regs"] + SWEEP_SHORT["no_out"]


def _loop_layout(lanes: int, warps: int) -> list:
    """The loop kernel at lanes chains a warp and warps chain warps a block
    (built: 1 x 1; 32 rows a block stage 64 frames, 64 rows 64 frames in
    two stages: the shared memory)."""
    subs = []
    if lanes != 1:
        subs.append(("constexpr int kPlLanes = 1;",
                     f"constexpr int kPlLanes = {lanes};"))
    if warps != 1:
        subs.append(("constexpr int kPlWarps = 1;",
                     f"constexpr int kPlWarps = {warps};"))
    if lanes * warps >= 32:
        subs.append(("constexpr int kPlL = 128;", "constexpr int kPlL = 64;"))
    if lanes * warps >= 64:
        subs.append(("constexpr int kPlStages = 3;",
                     "constexpr int kPlStages = 2;"))
    return subs


# recur_loop_kernel's variants (K3, K3c): whole designs, held to the plain
# version bit for bit: the layout, lanes x warps (built: 1 x 1), and the
# input work that reads no loop state in the chain lane's step ("inline")
# instead of on the copy warp; and timing-only probes (probe_*, not held):
# no output stored in a full group
SWEEP_LOOP = {"built": [],
              "inline": [("constexpr bool kPlPrep = true;",
                          "constexpr bool kPlPrep = false;")],
              # compile-only (--sass; never timed): the chain loop without
              # its stage wait, its hand-back, or its pass-form write-out,
              # to see which puts BSSY / BSYNC pairs in the chain loop
              "sass_no_wait": [("    bulk::mbar_wait(kPlPrep ? &ready[slot] "
                                ": &full[slot],\n                    "
                                "static_cast<uint32_t>(i / S) & 1u);\n", "")],
              "sass_no_handback": [
                  ("    bulk::fence_async_smem();\n    // a warp-synchronous",
                   "    // a warp-synchronous"),
                  ("    if (lane == 0) bulk::mbar_arrive_expect_tx(&done[slot], "
                   "0);\n  }\n  if (mine) {",
                   "  }\n  if (mine) {")],
              "sass_no_pass": [("    if (p.form == 1) {\n      // the pass form: "
                                "each chain warp", "    if (false) {\n      // "
                                "the pass form: each chain warp")],
              # the chain thread's warp-mates leave at the top (no block
              # barrier after; compile-only), no copy-warp code, no block
              # barrier
              "sass_exit_early": [
                  ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid "
                   ">> 5;\n",
                   "  const int tid = threadIdx.x, lane = tid & 31, warp = tid "
                   ">> 5;\n  if (kPlRows == 1 && tid != 0 && tid < 32) "
                   "return;\n")],
              # neither (the chain loop with no mbarrier operation)
              "sass_no_mbarrier": None,
              # the chain's exit on the lane index as the hardware gives it
              # (%laneid), and a launch bound of one warp (no launch)
              "sass_laneid": [("  if (kPlRows == 1 ? tid != 0 : lane >= kPlLanes) "
                               "return;",
                               "  unsigned lid;\n  asm(\"mov.u32 %0, %%laneid;"
                               "\" : \"=r\"(lid));\n  if (kPlRows == 1 ? "
                               "(tid != 0 || lid != 0) : lane >= kPlLanes) "
                               "return;")],
              "sass_lb32": [("__launch_bounds__(kPlThreads, 1)",
                             "__launch_bounds__(32, 1)")],
              "sass_no_copy": [("  if (!chain) {\n    // the copy warp: lane l",
                                "  if (!chain) return;\n  if (false) {\n    "
                                "// the copy warp: lane l")],
              "sass_no_barrier": [("&done[i], kPlWarps);\n    }\n    bulk::"
                                   "fence_mbar_init();\n    sh_pin_write(s, "
                                   "pin_w);\n  }\n  __syncthreads();",
                                   "&done[i], kPlWarps);\n    }\n    bulk::"
                                   "fence_mbar_init();\n    sh_pin_write(s, "
                                   "pin_w);\n  }")],
              # the chain warp's __syncwarp at a stage's end even with one
              # lane (ptxas then keeps BSSY / BSYNC pairs in the chain)
              "warpsync": [("    if (kPlLanes > 1) __syncwarp(kPlMask);\n"
                            "    if (lane == 0) bulk::mbar_arrive_expect_tx("
                            "&done[slot], 0);",
                            "    __syncwarp(kPlMask);\n"
                            "    if (lane == 0) bulk::mbar_arrive_expect_tx("
                            "&done[slot], 0);")],
              "probe_no_out": [("        o0[t + j] = o[0];\n"
                                "        o1[t + j] = o[1];\n      }\n"
                                "      cur = nxt;",
                                "      }\n      cur = nxt;")]}
SWEEP_LOOP["sass_no_mbarrier"] = (SWEEP_LOOP["sass_no_wait"]
                                  + SWEEP_LOOP["sass_no_handback"])
for _lanes in (1, 4, 8, 16):
    for _warps in (1, 2, 4):
        if (_lanes, _warps) != (1, 1):
            SWEEP_LOOP[f"l{_lanes}w{_warps}"] = _loop_layout(_lanes, _warps)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """K4's and K6's C signatures (K6's by its generation: a library with
    recur_short_plan takes the powers where they lie), and the probes'."""
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.recur_agc_scan.restype = i
    lib.recur_agc_scan.argtypes = [i, i, p, i, i, f, f, f, f, i, p, p, p, p,
                                   p, p, p, p]
    lib.recur_ook_scan.restype = i
    if hasattr(lib, "recur_short_plan"):
        lib.recur_ook_scan.argtypes = ([i, i, p, i, i, p, q, i, i] + [p] * 6
                                       + [p, p, p])
    else:
        lib.recur_ook_scan.argtypes = ([i, i, p, i, i] + [f] * 6 + [i, i]
                                       + [p] * 14)
    lib.recur_pll_scan.restype = i
    lib.recur_pll_scan.argtypes = [i, i, p, i, i, f, f, f, f, f] + [p] * 9
    lib.recur_pll_chunk_scan.restype = i
    lib.recur_pll_chunk_scan.argtypes = [i, i, p, i, i, f, f, f, f] + [p] * 9
    lib.recur_probe.restype = i
    lib.recur_probe.argtypes = [i, i, i, p, p]
    if hasattr(lib, "recur_probe_fed"):
        lib.recur_probe_fed.restype = i
        lib.recur_probe_fed.argtypes = [i, i, i, p, i, p, p]
    return lib


def ook_tiled_call(torch, goertzel, lib, cfg, state, pm, pl, ph):
    """K6 through a library whose entry takes [C, F, 4] float4 frames:
    its wrapper's host path (the checks, the stack, the float32 marks,
    the compare kernel)."""
    dev = pm.device
    c, f = pm.shape
    for v in (pm, pl, ph):
        if (v.device != dev or v.dtype != torch.float32
                or tuple(v.shape) != (c, f)):
            raise ValueError("ook_detect: powers must be [C, F] float32")
    leaves = (state.peak, state.floor, state.avg, state.state, state.attack,
              state.decay)
    for v, dtype in zip(leaves, (torch.float32,) * 3
                        + (torch.bool, torch.int32, torch.int32)):
        if (v.device != dev or v.dtype != dtype or tuple(v.shape) != (c,)
                or not v.is_contiguous()):
            raise ValueError("ook_detect: the state must be contiguous [C]")
    frames = torch.stack((pm, pl, ph, torch.zeros_like(pm)), dim=-1)
    marks = torch.empty(c, f, dtype=torch.float32, device=dev)
    outs = [torch.empty_like(v) for v in leaves]
    k = cfg.consts()
    err = lib.recur_ook_scan(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        goertzel.THRESHOLD_MODES.index(cfg.mode), frames.data_ptr(), c, f,
        *(float(k[key]) for key in ("aa", "da", "fa", "keep", "va",
                                     "ratio")),
        int(cfg.attack_frames), int(cfg.decay_frames),
        *(v.data_ptr() for v in leaves), marks.data_ptr(),
        *(v.data_ptr() for v in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    return goertzel.OOKState(*outs), marks != 0


def agc_call(torch, lib, env, att, dec, hang, k):
    """K4 through another library's recur_agc_scan (the signature every
    generation shares), with its earlier wrapper's host path."""
    dev = env.device
    c, m = env.shape
    levels = torch.empty(c, m, dtype=torch.float32, device=dev)
    att2, dec2, hang2 = (torch.empty_like(v) for v in (att, dec, hang))
    err = lib.recur_agc_scan(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        int(bool(k["hang"])), env.data_ptr(), c, m, k["rise"], k["fall"],
        k["drise"], k["dfall"], int(k["hang_samples"]), att.data_ptr(),
        dec.data_ptr(), hang.data_ptr(), levels.data_ptr(), att2.data_ptr(),
        dec2.data_ptr(), hang2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    return att2, dec2, hang2, levels


def loop_input(torch, pll, tag: str, c: int, n: int, rng):
    """One K3 / K3c shape's call at its caller's constants: (the wrapper,
    the plain version, their arguments, the C entry's name, flag and
    constants for pll.loop_launch).  Seeded synthetic signals: NFM voice
    at 3 kHz deviation (64 ksps), an AM carrier 230 Hz off (SAM, 64 ksps;
    K3c: its chunk phasors, 8 samples a chunk), BPSK at 1187.5 baud 3 Hz
    off (RDS at 19 ksps), the 19 kHz pilot 5 Hz off at 256 ksps (cross:
    the complex carrier at unit amplitude; pilot: the real composite)."""
    t = np.arange(n, dtype=np.float64)
    ch = np.arange(c)[:, None]
    noise = rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))
    det = tag.split()[0]
    if tag == "atan2 nfm":
        fs = 64000.0
        cfg = pll.make_pll_config(fs, 5000.0, range_hz=10000.0)
        x = 0.5 * np.exp(1j * (2 * np.pi * 150.0 * t / fs + 3.0 * np.sin(
            2 * np.pi * 1000.0 * t / fs) + ch)) + 1e-3 * noise
    elif tag == "atan2 sam_short" or det == "chunk":
        fs = 64000.0
        cfg = pll.make_pll_config(fs, 100.0, range_hz=1000.0)
        if det == "chunk":       # phasors of 8-sample chunks
            t = 8.0 * t
        x = (0.3 * np.exp(1j * (2 * np.pi * 230.0 * t / fs + 0.7 * ch))
             + 1e-4 * noise)
    elif det == "costas":
        fs = 19000.0
        cfg = pll.make_pll_config(fs, 30.0, range_hz=100.0,
                                  detector="costas")
        data = np.repeat(np.where(rng.random((c, n // 16 + 1)) < 0.5, -1.0,
                                  1.0), 16, axis=1)[:, :n]
        x = (0.5 * data * np.exp(1j * (2 * np.pi * 3.0 * t / fs + ch))
             + 0.02 * noise)
    else:                         # cross, pilot
        fs = 256000.0
        cfg = pll.make_pll_config(fs, 10.0, center_hz=19000.0,
                                  range_hz=100.0, detector=det)
        ph = 2 * np.pi * 19005.0 * t / fs + 0.3 * ch
        if det == "pilot":
            x = (0.1 * np.sin(ph) + 0.3 * np.sin(2 * np.pi * 1000.0 * t / fs)
                 + 0.01 * noise.real)
        else:
            x = np.exp(1j * ph) + 0.01 * noise
    x = torch.from_numpy(x.astype(np.complex64)).cuda()
    st = (torch.zeros(c, device="cuda"), torch.zeros(c, device="cuda"),
          torch.ones(c, device="cuda"))
    wc, lo, hi = cfg.freq_center, cfg.freq_lo, cfg.freq_hi
    if det == "chunk":
        pilot = tag == "chunk pilot"
        consts = (cfg.alpha * 8, cfg.beta * 64, (lo - wc) * 8, (hi - wc) * 8)
        return (pll.pll_chunk_scan, pll.pll_chunk_scan_plain,
                (x, *st, pilot, *consts), "recur_pll_chunk_scan",
                int(pilot), consts)
    consts = (cfg.alpha, cfg.beta, wc, lo - wc, hi - wc)
    return (pll.pll_scan, pll.pll_scan_plain, (x, *st, det, *consts),
            "recur_pll_scan", pll.DETECTORS.index(det), consts)


def ptxas_report(build, source) -> list[str]:
    """-Xptxas -v's lines for a recur.cu's K3 / K3c / K4 / K6 kernels and
    their probes: the entry, its properties' heading, its stack / spills
    and its registers / shared memory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(source.parent), "-o", str(build.BUILD_DIR / "ptxas_recur.so"),
         str(source)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lines, keep = [], 0
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            # mangled names: the steps appear in the template args
            keep = 4 if re.search(r"PllStep|ChunkStep|AgcStep|OokStep",
                                  line) else 0
        if keep:
            lines.append(line.strip())
            keep -= 1
    return lines


def sass_report(build, lib_path, pattern: str) -> str:
    """cuobjdump -sass of a built library, only the functions whose
    (mangled) names match pattern."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"cuobjdump failed:\n{proc.stderr}")
    keep, out = False, []
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            keep = re.search(pattern, line) is not None
        if keep:
            out.append(line)
    return "\n".join(out)


def loop_summary(sass: str) -> list[str]:
    """Per function of a SASS listing whose name holds recur_loop_kernel or
    probe_loop_fed_kernel: its chain loop (the backward branch of at most
    1600 instructions whose body holds the most FADD: the unrolled group of
    steps) with its instructions, convergence barriers (BSSY, BSYNC) and
    shared loads and stores."""
    out = []
    for part in sass.split("Function :")[1:]:
        name = part.split("\n", 1)[0].strip()
        kind = re.search(r"recur_loop_kernel|probe_loop_fed_kernel", name)
        step = re.search(r"(PllStepILi\d|ChunkStepILb\d)", name)
        if not kind or not step:
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        best = None
        for addr, text in ins:
            m = re.search(r"BRA (?:!?U?P\w+, )?0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if len(body) > 1600:
                continue
            key = sum("FADD" in t for t in body)
            if best is None or key > best[0]:
                best = (key, body)
        if best:
            body = best[1]
            out.append(f"{kind.group(0)} {step.group(1)}: chain loop of "
                       f"{len(body)} instructions, "
                       f"{sum('BSSY' in t for t in body)} BSSY, "
                       f"{sum('BSYNC' in t for t in body)} BSYNC, "
                       f"{sum('LDS' in t for t in body)} LDS, "
                       f"{sum('STS' in t for t in body)} STS")
    return out


def variant_source(src: str, subs: list) -> str:
    """recur.cu with text replaced; each text must occur exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def compile_variants(build, source, table: dict, names: list[str]) -> dict:
    """{name: library path} of a sweep table's variants of source, nvcc
    runs in parallel (the source's directory on the include path)."""
    import concurrent.futures
    out_dir = build.BUILD_DIR.parent / "recur_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = source.read_text()

    def one(name):
        cu, so = out_dir / f"recur_{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(variant_source(src, table[name]))
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                               str(source.parent), "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return so

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def build_other(build, src: str, tag: str) -> ctypes.CDLL:
    so = build.BUILD_DIR.parent / "recur_cells" / f"librecur_{tag}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                           os.path.dirname(src), "-o", str(so), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return declare(ctypes.CDLL(str(so)))


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, os.getcwd())
    from pathlib import Path

    import torch

    from pebblesdr_tpu_torch.kernels import build
    from pebblesdr_tpu_torch.tools import cells as cs
    from pebblesdr_tpu_torch.ops import agc, goertzel, pll
    from pebblesdr_tpu_torch.utils import convert, roofline

    if not torch.cuda.is_available():
        raise RuntimeError("recur_cells needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out = {"device": card}
    flags = {f: f in argv for f in ("--ptxas", "--k3", "--short")}
    argv = [a for a in argv if a not in flags]
    ptxas = flags["--ptxas"]
    sass = None
    if "--sass" in argv:
        i = argv.index("--sass")
        sass = Path(argv[i + 1])
        del argv[i:i + 2]
    this = declare(pll._lib())
    libs = {"this": this}
    sources = {"this": build.CSRC / "recur.cu"}
    sweep = argv[:1] == ["--sweep"]
    if sweep:
        rest = argv[1:]
        source = build.CSRC / "recur.cu"
        if rest[:1] == ["--source"]:
            source, rest = Path(os.path.abspath(rest[1])), rest[2:]
            sources["source"] = source
        text = source.read_text()
        if flags["--short"]:
            table = (SWEEP_SHORT if "recur_short_kernel" in text
                     else SWEEP_TILED)
        elif "recur_loop_kernel" in text:
            table = SWEEP_LOOP
        else:
            raise ValueError(f"{source} has no loop kernel to sweep "
                             f"(--short: the K4 / K6 variants)")
        names = rest or [n for n in table if not n.startswith("sass_")]
        if sass is None and any(n.startswith("sass_") for n in names):
            raise ValueError("sass_* variants are compile-only: --sass DIR")
        variant_paths = compile_variants(build, source, table, names)
        libs = {name: declare(ctypes.CDLL(str(so))) for name, so in
                variant_paths.items()}
    if argv[:1] == ["--against"]:
        tag = argv[2] if len(argv) > 2 else "other"
        libs[tag] = build_other(build, os.path.abspath(argv[1]), tag)
        sources[tag] = Path(os.path.abspath(argv[1]))
    if sass is not None:
        # the SASS of the K4 and K6 kernels and probes (mangled names
        # matching SASS_PATTERN), for this build and, with --against, the
        # other's; then stop
        dest = sass
        dest.mkdir(parents=True, exist_ok=True)
        for tag, path in [("this", build.library_path("recur"))] + [
                (t, build.BUILD_DIR.parent / "recur_cells" / f"librecur_{t}.so")
                for t in libs if t != "this" and not sweep] + (
                    list(variant_paths.items()) if sweep else []):
            text = sass_report(build, path, SASS_PATTERN)
            (dest / f"recur_sass_{tag}.txt").write_text(text)
            print(f"sass ({tag}): {len(text.splitlines())} lines to "
                  f"{dest / f'recur_sass_{tag}.txt'}", flush=True)
            out[f"loops_{tag}"] = loop_summary(text)
            print("\n".join(out[f"loops_{tag}"]), flush=True)
        return out
    if ptxas:
        out["ptxas"] = {}
        for tag, src in sources.items():
            out["ptxas"][tag] = ptxas_report(build, src)
            print(f"ptxas ({tag}: {src}):\n" + "\n".join(out["ptxas"][tag]),
                  flush=True)

    # K3 / K3c rows unless a K4 / K6 sweep; K4 / K6 rows unless --k3 or a
    # loop sweep
    do_loop = not (sweep and flags["--short"])
    do_short = not flags["--k3"] and not (sweep and not flags["--short"])
    loop_forms = pll.DETECTORS + ("chunk", "chunk pilot")
    # the chain probes: register-only and fed from memory
    probes = {}
    for form in pll.FED_FORMS:
        if not (do_loop if form in loop_forms else do_short):
            continue
        row = {}
        for fed in (False, True):
            pll.chain_probe(form, 256, "cuda", fed=fed)
            ms = cs.time_cuda(torch, lambda: pll.chain_probe(
                form, cs.PROBE_STEPS, "cuda", fed=fed), 3)
            row["fed" if fed else "registers"] = ms * 1e6 / cs.PROBE_STEPS
        probes[form] = row
        print(f"chain probe {form}: {row['registers']:.2f} ns per step on "
              f"registers, {row['fed']:.2f} fed from memory", flush=True)
    out["probes"] = probes
    # what a launch costs with next to no work: the register-only probe
    # over 0 steps (the fed probe stages its pattern first)
    floor = cs.launch_ms(cs.kernel_times(
        torch, lambda: pll.chain_probe("ook peak", 0, "cuda"),
        reps=CALL_REPS, want=("probe_kernel",)), "probe_kernel")
    out["launch_floor_ms"] = floor
    print(f"launch floor (a one-thread launch with no step): {floor:.4f} ms "
          f"per launch", flush=True)
    rows = []

    def measure(tag, shape, cands, kernel_key, bound, form=None):
        """cands: {name: call}; each held (hold), then timed in turns."""
        order = list(cands) + list(cands)[::-1]
        launch = {name: [] for name in cands}
        call = {name: [] for name in cands}
        for name in order:
            fn = cands[name]
            for _ in range(WARM):
                fn()
            call[name].append(cs.time_cuda(torch, fn, CALL_REPS))
            times = cs.kernel_times(torch, fn, reps=CALL_REPS,
                                    want=("recur_",))
            k = [(ms, n) for key, (ms, n) in times.items()
                 if kernel_key in key]
            launch[name].append(sum(ms * n for ms, n in k)
                                / max(sum(n for _, n in k), 1)
                                if k else float("nan"))
        for name in cands:
            ms = min(launch[name])
            row = {"tag": tag, "shape": list(shape), "build": name,
                   "launch_ms": launch[name], "call_ms": call[name],
                   "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"],
                   "serial_ms": bound["serial_ms"],
                   "bytes_ms": bound["bytes"] / roofline.HBM_BYTES_PER_S
                   * 1e3}
            if form is not None:
                row["step_ns"] = ms * 1e6 / shape[1]
                row["register_bound_ms"] = (shape[1] * probes[form][
                    "registers"] * 1e-6)
            rows.append(row)
            print(f"{tag} {list(shape)} {name}: per launch "
                  f"{', '.join(f'{t:.4f}' for t in launch[name])} ms, per "
                  f"call {', '.join(f'{t:.4f}' for t in call[name])} ms; "
                  f"{bound['bound_ms'] / ms:.1%} of the "
                  f"{bound['bound_ms']:.5f} ms bound per launch "
                  f"({bound['bound_by']})"
                  + (f"; {row['step_ns']:.1f} ns a step against "
                     f"{probes[form]['fed']:.1f} fed, "
                     f"{probes[form]['registers']:.1f} on registers; the "
                     f"register probe's bound {row['register_bound_ms']:.4f}"
                     f" ms, the bytes' {row['bytes_ms']:.5f} ms"
                     if form is not None else ""), flush=True)

    # K3 and K3c: every library held to the plain version bit for bit
    rng = np.random.default_rng(3)
    for tag, form, c, n in LOOP_SHAPES if do_loop else ():
        wrapper, plain, args, entry, flag, consts = loop_input(
            torch, pll, tag, c, n, rng)
        ref = plain(*args)
        torch.cuda.synchronize()
        cands = {}
        for name, lib in libs.items():
            if name == "this" and not sweep:
                fn = (lambda: wrapper(*args))
            else:
                fn = (lambda lib=lib: pll.loop_launch(
                    getattr(lib, entry), tag, args[0], args[1:4], flag,
                    consts))
            got = fn()
            torch.cuda.synchronize()
            if not name.startswith("probe_") and not all(
                    a.shape == b.shape and torch.equal(a, b)
                    for a, b in zip(got, ref)):
                raise RuntimeError(f"{tag} {name}: K3 differs from its plain "
                                   f"version")
            cands[name] = fn
        chunk = form.startswith("chunk")
        bound = (roofline.pll_chunk_bound if chunk else
                 roofline.pll_scan_bound)(c, n, probes[form]["fed"])
        measure(tag, (c, n), cands, "ChunkStep" if chunk else "PllStep",
                bound, form=form)

    # K4
    rng = np.random.default_rng(4)
    for tag, c, m in K4_SHAPES if do_short else ():
        mode = tag.split()[1]
        key = np.where(((m - 1 - np.arange(m)) // 300) % 2, 1.0, 0.01)
        env = torch.from_numpy(np.log10(np.abs(
            0.5 * key + 1e-3 * rng.standard_normal((c, m))) + 1e-8)
            .astype(np.float32)).cuda()
        k = agc.scan_coefs(agc.AGCConfig.make(64000.0, mode, stride=16,
                                              algorithm="scan"))
        st = (torch.full((c,), -0.5, device="cuda"),
              torch.full((c,), -0.5, device="cuda"),
              torch.zeros(c, dtype=torch.int32, device="cuda"))
        kargs = (k["rise"], k["fall"], k["drise"], k["dfall"],
                 k["hang_samples"], k["hang"])
        ref = agc.agc_scan_plain(env, *st, *kargs)
        cands = {}
        for name, lib in libs.items():
            if name == "this" and not sweep:
                fn = (lambda: agc.agc_scan(env, *st, *kargs))
            else:
                fn = (lambda lib=lib: agc_call(torch, lib, env, *st, k))
            if name == "this" or not sweep or name == "built":
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise RuntimeError(f"{tag} {name}: K4 differs from "
                                       f"agc_scan_plain")
            cands[name] = fn
        step = probes["agc hang" if mode == "long" else "agc"]["fed"]
        measure(tag, (c, m), cands, "AgcStep",
                roofline.agc_scan_bound(c, m, step))

    # K6
    def ook_cands(cfg, state, pows):
        margin = goertzel.ook_margin(cfg, state, *pows)
        if not margin >= cs.OOK_MARGIN:
            raise RuntimeError(f"ook {cfg.mode}: a decision margin "
                               f"{margin:.3g} below {cs.OOK_MARGIN}")
        ref_st, ref_m = goertzel.ook_detect_plain(cfg, state, *pows)
        cands = {}
        for name, lib in libs.items():
            if name == "this" and not sweep:
                fn = (lambda: goertzel.ook_detect(cfg, state, *pows))
            elif hasattr(lib, "recur_short_plan"):
                fn = (lambda lib=lib: goertzel.ook_launch(
                    lib.recur_ook_scan, cfg, state, *pows))
            else:
                fn = (lambda lib=lib: ook_tiled_call(
                    torch, goertzel, lib, cfg, state, *pows))
            if name == "this" or not sweep or name == "built":
                st_k, m_k = fn()
                torch.cuda.synchronize()
                ok = torch.equal(m_k, ref_m)
                for a, b in zip(convert.leaves(st_k),
                                convert.leaves(ref_st)):
                    if a.dtype == torch.float32 and b.numel():
                        scale = max(float(b.abs().max()), 1e-30)
                        ok &= float((a - b).abs().max()) <= \
                            cs.OOK_RTOL * scale
                    elif b.numel():
                        ok &= torch.equal(a, b)
                if not ok:
                    raise RuntimeError(f"ook {cfg.mode} {name}: K6 differs "
                                       f"from ook_detect_plain")
            cands[name] = fn
        return cands

    rng = np.random.default_rng(37)
    c, f = OOK_LONG
    for mode in goertzel.THRESHOLD_MODES if do_short else ():
        cfg = goertzel.OOKConfig.make(mode=mode, manual_threshold=0.1)
        pows = cs.ook_powers(torch, c, f, rng)
        cands = ook_cands(cfg, goertzel.ook_init(c, "cuda"), pows)
        measure(f"ook {mode}", (c, f), cands, "OokStep",
                roofline.ook_scan_bound(c, f, probes[f"ook {mode}"]["fed"],
                                        compare=mode == "compare"))
    c, f = OOK_CW
    if do_short:
        cfg = goertzel.OOKConfig.make(mode="peak")
        pows = cs.ook_powers(torch, c, f, np.random.default_rng(40))
        cands = ook_cands(cfg, goertzel.ook_init(c, "cuda"), pows)
        measure("ook peak cw", (c, f), cands, "OokStep",
                roofline.ook_scan_bound(c, f, probes["ook peak"]["fed"]))
    out["rows"] = rows
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
