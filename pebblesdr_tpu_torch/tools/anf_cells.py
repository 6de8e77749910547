"""K8 (csrc/recur.cu anf_scan, the ANF's block LMS) at the main path's
shapes on the card, beside another build of recur.cu (a parent commit's,
say) timed in turns in the same process.

    python -m pebblesdr_tpu_torch.tools.anf_cells [--ptxas]
        [--against RECUR_CU [TAG]]

Shapes (tag, rows, N, U): "staged" [128, 32768] at U = 16 (the staged
front's am_iqauto_anf_64ch: 64 complex channels as 128 real rows),
"batched" the same at U = 1024 (am_anf_long_64ch), "sample" [128, 2048]
at U = 1; then this build's crossover at [128, 32768]: U = 8, 16 and 32
in each form (forced through recur_anf_scan_form), and U = 33, 64, 128,
256 in the wide form.  At every shape each library is first held to
anf_plain from the same adapted state (y and w' within 1e-5 of their
scale, hist' equal; one that disagrees raises), then the libraries are
timed in turns, this one, the other, the other, this one: the device ms
per launch of the recur_anf* kernels (torch.profiler over 10 launches,
cells.kernel_times) and CUDA events per call over 10 calls after 3
warm-ups.  Each time is printed with its share of the bound
(utils/roofline.py anf_scan_bound, with the chain probe's ns per update
at U = 1, 16, 1024).

    python -m pebblesdr_tpu_torch.tools.anf_cells --sweep [variant ...]

builds variants of this checkout's recur.cu side by side (into
build/anf_sweep/; SWEEP below: text replaced, each text found once) and
times each at the staged and batched shapes in turns, forwards then
backwards (torch.profiler per launch); the variants in PROBES skip a part
of the chain or of the wide form's work (timing only, their outputs
wrong by design), the others are first held to anf_plain.

--against builds RECUR_CU (its directory's headers on the include path)
into build/anf_cells/ with this checkout's nvcc flags; it must export
recur_anf_scan with this checkout's C signature.  --ptxas builds this
checkout's recur.cu once more with -Xptxas -v and prints each K8 kernel's
registers, stack frame, spills and shared memory.  The last line is one
JSON object of the results.  Raises without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

SHAPES = (("staged", 128, 32768, 16), ("batched", 128, 32768, 1024),
          ("sample", 128, 2048, 1))
CROSSOVER = ((8, ("chain", "wide")), (16, ("chain", "wide")),
             (32, ("chain", "wide")), (33, ("wide",)), (64, ("wide",)),
             (128, ("wide",)), (256, ("wide",)))
PROBE_FORM = {1: "anf 1", 16: "anf 16", 1024: "anf 1024"}
# name: [(source text, replacement)]
SWEEP = {
    "built": [],
    "no_bcast": [("const float em = j ? __shfl_xor_sync(0xffffffffu, e, "
                  "j * kGroup) : e;", "const float em = e;")],
    "no_halving": [("  anf_halve<P, 0>(v);\n", "\n")],
    "loads_first": [("  const float s = anf_chain_sum<P>(fa, fb, w0, w1);\n"
                     "  asm volatile(\"\" ::: \"memory\");\n", ""),
                    ("  anf_chain_learn<P>(fa, fb, xv, s, w0, w1, c, yl);",
                     "  const float s = anf_chain_sum<P>(fa, fb, w0, w1);\n"
                     "  anf_chain_learn<P>(fa, fb, xv, s, w0, w1, c, yl);")],
    "no_xor": [("for (int d = kGroup >> 1; d > 0; d >>= 1)",
                "for (int d = 0; d > 0; d >>= 1)")],
    "no_shfl": [("const float em = j ? __shfl_xor_sync(0xffffffffu, e, "
                 "j * kGroup) : e;", "const float em = e;"),
                ("  anf_halve<P, 0>(v);\n", "\n"),
                ("for (int d = kGroup >> 1; d > 0; d >>= 1)",
                 "for (int d = 0; d > 0; d >>= 1)")],
    "one_lds": [("    fr[j] = *reinterpret_cast<const float*>(b + c.o[j]);",
                 "    fr[j] = f[0] + j;")],
    "no_grad": [("    ga[j % kAcc] = fmaf(em, fa[j], ga[j % kAcc]);\n"
                 "    gb[j % kAcc] = fmaf(em, fb[j], gb[j % kAcc]);",
                 "    ga[j % kAcc] += em;")],
    "no_store": [("if (c.mine_ok && (c.lane & (kGroup - 1)) == 0) *yl = s;",
                  "if (c.mine_ok && (c.lane & (kGroup - 1)) == 0 && s == 1.5f)"
                  " *yl = s;")],
    "wide_no_pred": [("anf_wide_pred<true>(sm.ring, lo, sm.w, taps, p0, p1);",
                      "p0 = p1 = 0.f;"),
                     ("anf_wide_pred<false>(sm.ring, lo, sm.w, taps, p0, p1);",
                      "p0 = p1 = 0.f;")],
    "wide_no_grad": [("      if (cnt > 0) {\n",
                      "      if (cnt > 0 && taps < 0) {\n")],
}
PROBES = tuple(name for name in SWEEP
               if name not in ("built", "loads_first"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """recur_anf_scan's C signature (and recur_anf_scan_form's where the
    library has it)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.recur_anf_scan.restype = i
    lib.recur_anf_scan.argtypes = [i, p, i, i, i, i, i, f, f, p, p, p, p, p,
                                   p]
    if hasattr(lib, "recur_anf_scan_form"):
        lib.recur_anf_scan_form.restype = i
        lib.recur_anf_scan_form.argtypes = [i, i, p, i, i, i, i, i, f, f, p,
                                            p, p, p, p, p]
    return lib


def ptxas_report(build, source) -> list[str]:
    """-Xptxas -v's lines for recur.cu's K8 kernels: the entry, its
    properties' heading, its stack / spills and its registers / shared
    memory."""
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(build.BUILD_DIR / "ptxas_anf.so"), str(source)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lines, keep = [], 0
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if re.search(r"recur_anf|probe_anf", line) else 0
        if keep:
            lines.append(line.strip())
            keep -= 1
    return lines


def variant_source(src: str, subs: list) -> str:
    """recur.cu with text replaced; each text must occur exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def compile_variants(build, names: list[str]) -> dict:
    """{name: library path} of SWEEP's variants, nvcc runs in parallel."""
    import concurrent.futures
    out_dir = build.BUILD_DIR.parent / "anf_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "recur.cu").read_text()

    def one(name):
        cu, so = out_dir / f"recur_{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(variant_source(src, SWEEP[name]))
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                               str(build.CSRC), "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return so

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, os.getcwd())
    import torch

    from pebblesdr_tpu_torch.kernels import build
    from pebblesdr_tpu_torch.tools import cells as cs
    from pebblesdr_tpu_torch.ops import pll, scanops
    from pebblesdr_tpu_torch.utils import roofline

    if not torch.cuda.is_available():
        raise RuntimeError("anf_cells needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out = {"device": card}
    if "--ptxas" in argv:
        argv.remove("--ptxas")
        out["ptxas"] = ptxas_report(build, build.CSRC / "recur.cu")
        print("\n".join(out["ptxas"]), flush=True)
    libs = {"this": declare(scanops._lib())}
    sweep = argv[:1] == ["--sweep"]
    if sweep:
        names = argv[1:] or list(SWEEP)
        libs = {name: declare(ctypes.CDLL(str(so))) for name, so in
                compile_variants(build, names).items()}
    if argv[:1] == ["--against"]:
        src = os.path.abspath(argv[1])
        tag = argv[2] if len(argv) > 2 else "other"
        so = build.BUILD_DIR.parent / "anf_cells" / f"librecur_{tag}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                               os.path.dirname(src), "-o", str(so), src],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        libs[tag] = declare(ctypes.CDLL(str(so)))
    dev = torch.cuda.current_device()

    def run(lib, x, w, h, u, form=None):
        y, w2, h2 = (torch.empty_like(t) for t in (x, w, h))
        args = (x.data_ptr(), x.shape[0], x.shape[1], u, w.shape[1],
                h.shape[1], 2.0 * scanops.ANF_RATE / u, scanops.ANF_LEAK,
                w.data_ptr(), h.data_ptr(), y.data_ptr(), w2.data_ptr(),
                h2.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if form:
            err = lib.recur_anf_scan_form(
                dev, scanops.ANF_FORMS.index(form) + 1, *args)
        else:
            err = lib.recur_anf_scan(dev, *args)
        if err:
            raise RuntimeError(f"K8 launch failed: CUDA error {err}")
        return y, w2, h2

    steps = {u: cs.probe_ns(torch, pll, f) for u, f in PROBE_FORM.items()}
    rows = []

    def measure(tag, r, n, u, cands):
        """cands: {name: (lib, form)} checked, then timed in turns."""
        rng = np.random.default_rng(u)
        c = r // 2
        x = torch.from_numpy(cs.anf_signal(c, n, rng)).cuda()
        x = torch.cat([x.real, x.imag]).contiguous()
        warm = torch.from_numpy(cs.anf_signal(c, n, rng)).cuda()
        warm = torch.cat([warm.real, warm.imag]).contiguous()
        st = scanops.anf_init(r, "cuda")
        _, w, h = scanops.anf_plain(warm, st.weights, st.delay,
                                    update_every=u)     # an adapted state
        h = h.contiguous()
        y_p, w_p, h_p = scanops.anf_plain(x, w, h, update_every=u)
        for name, (lib, form) in cands.items():
            if name in PROBES:
                continue
            y, w2, h2 = run(lib, x, w, h, u, form)
            torch.cuda.synchronize()
            ry = float((y - y_p).abs().max()) / float(y_p.abs().max())
            rw = float((w2 - w_p).abs().max()) / float(w_p.abs().max())
            if not (ry <= cs.ANF_RTOL and rw <= cs.ANF_RTOL
                    and torch.equal(h2, h_p)):
                raise RuntimeError(f"{tag} U={u} {name}: y {ry:.3g}, w' "
                                   f"{rw:.3g} of scale from anf_plain")
        order = list(cands) + list(cands)[::-1]
        launch = {name: [] for name in cands}
        call = {name: [] for name in cands}
        for name in order:
            lib, form = cands[name]

            def fn(lib=lib, form=form):
                return run(lib, x, w, h, u, form)

            for _ in range(3):
                fn()
            call[name].append(cs.time_cuda(torch, fn, 10))
            times = cs.kernel_times(torch, fn, reps=10, want=("recur_anf",))
            k8 = [(ms, k) for key, (ms, k) in times.items()
                  if key.startswith("recur_anf")]
            launch[name].append(sum(ms * k for ms, k in k8)
                                / sum(k for _, k in k8))
        step = steps.get(u)
        b = roofline.anf_scan_bound(r, n, u, step) if step else None
        for name in cands:
            ms = min(launch[name])
            row = {"tag": tag, "rows": r, "n": n, "u": u, "build": name,
                   "form": cands[name][1] or (
                       scanops.anf_form(u) if name == "this" or sweep
                       else "built"),
                   "launch_ms": launch[name], "call_ms": call[name]}
            share = ""
            if b:
                row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                           serial_ms=b["serial_ms"])
                share = (f"; {b['bound_ms'] / ms:.1%} of the "
                         f"{b['bound_ms']:.4f} ms bound ({b['bound_by']}, "
                         f"chain probe {step:.1f} ns)")
            rows.append(row)
            print(f"{tag} [{r}, {n}] U={u} {name} ({row['form']}): per "
                  f"launch {', '.join(f'{t:.4f}' for t in launch[name])} "
                  f"ms, per call {', '.join(f'{t:.4f}' for t in call[name])}"
                  f" ms{share}", flush=True)
        del x, warm, y_p, w_p, h_p
        torch.cuda.empty_cache()

    for tag, r, n, u in SHAPES[:2] if sweep else SHAPES:
        measure(tag, r, n, u, {name: (lib, None) for name, lib in
                               libs.items()})
    for u, forms in () if sweep else CROSSOVER:
        measure("crossover", 128, 32768 // u * u, u,
                {f: (libs["this"], f) for f in forms})
    out["rows"] = rows
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
