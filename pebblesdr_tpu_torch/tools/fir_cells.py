"""K1 and its FIR pass front_fir at the shape and form of each front cell,
on the card, for the checkout at ROOT (default: this one; any checkout of
the port with a chip_smoke.py, e.g. a parent commit unpacked under build/).

    python pebblesdr_tpu_torch/tools/fir_cells.py [ROOT [TAG]]

(run as a script, not with -m, so that ROOT's package is the one imported)

Cells (PERF.md section 4): am_64ch (base form), am_nb_64ch (NB1 + IQ),
am_256ch, am_i16_256ch (int16), am_16ch, wfm_64ch (the F = 8 plan),
wfm_hq_64ch (the F = 4 plan), and on front_fir's 4-channel items
usb_64ch (the F = 64 / 2007-tap plan of SSB, CW and DIG) and none_64ch (the
F = 32 / 1159-tap plan of NONE), each on its cell's plane from
chip_smoke.py with a small carried tail (a checkout whose front_fir has no
geometry for a cell's plan skips it).  K1 is first checked against its plain version
on the same inputs (chip_smoke.check_options_form: 3e-5 relative, blanker
flags equal); then timed: CUDA events around 10 calls after 3 warm-ups,
the host's enqueue ms per call over 20 calls, and the device time per
launch of each kernel over 10 calls (torch.profiler); and the sha256 of
one call's y and tail' (and nb_tail' at am_nb_64ch), so that two
checkouts' runs show whether their outputs are the same bits.  The WFM
plans run K1's base form (front_fir is the same pass in every form);
then their cells' own forms, the WFM form at wfm_64ch (discriminator,
y-tails) and the hq form at wfm_hq_64ch
(with the composite decimation, from a random comp_hist), are held to
the plain version (3e-5 relative, disc and comp_hist' 1e-4 absolute),
hashed (y-tails, tail', disc, dlast and comp_hist'), timed by events and
profiled, each kernel's device time per launch over 10 calls.  The last
line is one JSON object of the results.  Raises without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

FS = 2_048_000
N = 32768
# (cell, channels, blocks, form, plan)
CELLS = (("am_64ch", 64, 32, "f32", "am"),
         ("am_nb_64ch", 64, 32, "nb1_iq", "am"),
         ("am_256ch", 256, 16, "f32", "am"),
         ("am_i16_256ch", 256, 16, "i16", "am"),
         ("am_16ch", 16, 64, "f32", "am"),
         ("wfm_64ch", 64, 32, "f32", "wfm"),
         ("wfm_hq_64ch", 64, 32, "f32", "hq"),
         ("usb_64ch", 64, 32, "f32", "usb"),
         ("none_64ch", 64, 32, "f32", "none"))
PROTECT = {"am": 30_000, "wfm": 200_000, "hq": 400_000, "usb": 20_000,
           "none": 48_000}


def kernel_ms(torch, fn, reps: int = 10,
              pattern: str = r"front_\w+") -> dict:
    """Device ms per launch of each kernel fn launches whose name matches
    pattern (default: the front_* kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        m = re.search(pattern, ev.key)
        if us and m:
            tot, n = rows.get(m.group(0), (0.0, 0))
            rows[m.group(0)] = (tot + us / 1e3, n + ev.count)
    return {k: tot / n for k, (tot, n) in rows.items()}


def own_form(torch, cs, front, wfm, plan, args, kw, form: str,
             tag: str) -> dict:
    """A WFM cell's own form of K1 (the discriminator and y-tails; "hq":
    with the composite decimation from a random comp_hist, seeded) against
    its plain version, the sha256 of its outputs, its K1 ms by events and
    each kernel's device time per launch."""
    c = args[0].shape[1] // 2
    zeros = dict(dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(7)
    rate = FS / plan.factor
    fkw = dict(kw, disc_gain=rate / (2 * np.pi * 75_000.0),
               disc_last=torch.from_numpy(rng.standard_normal(
                   (1, 2 * c)).astype(np.float32) * 0.1).cuda(),
               y_tail_rows=min(N // plan.factor, 2048))
    names = ["y_tail", "dc", "tail", "phase", "raw", "disc", "dlast"]
    if form == "hq":
        taps = wfm.WFMConfig.make(rate / 2, comp_decim=2).comp_taps
        fkw.update(comp_taps=taps, comp_hist=torch.from_numpy(
            rng.standard_normal((front.comp_hist_rows(len(taps)), c))
            .astype(np.float32) * 0.1).cuda())
        names.append("comp_hist")
    out_k = front.fused_front(plan, *args, **fkw)
    out_r = front.fused_front_reference(plan, *args, **fkw)
    torch.cuda.synchronize()
    absolute = ("phase", "disc", "comp_hist")
    errs = {nm: (float((a - b).abs().max()) if nm in absolute
                 else cs.rel_err(a, b)) for nm, a, b in zip(names, out_k, out_r)}
    bad = [nm for nm, v in errs.items()
           if v > (1e-4 if nm in absolute else cs.FRONT_RTOL)]
    if bad:
        raise RuntimeError(f"{tag}: {bad} disagree with the plain version: "
                           f"{errs}")
    bits = {nm: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
            for nm, v in zip(names, out_k)
            if nm in ("y_tail", "tail", "disc", "dlast", "comp_hist")}
    del out_k, out_r

    def call():
        return front.fused_front(plan, *args, **fkw)

    for _ in range(3):
        call()
    k1 = cs.time_cuda(torch, call, 10)
    launches = kernel_ms(torch, call)
    print(f"{tag}: vs plain " + " ".join(f"{kk}={v:.3g}" for kk, v in
                                          errs.items())
          + f"; K1 {k1:.4f} ms (events); sha256 "
          + " ".join(f"{kk} {v}" for kk, v in bits.items())
          + "; per launch: " + ", ".join(f"{kk} {v:.4f}" for kk, v in
                                        sorted(launches.items())), flush=True)
    return {"form_k1_ms": k1, "form_launch_ms": launches,
            "form_errors": errs, "form_sha256": bits}


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    root = os.path.abspath(argv[0] if argv else os.getcwd())
    tag = argv[1] if len(argv) > 1 else os.path.basename(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pebblesdr_tpu_torch.demod import wfm
    from pebblesdr_tpu_torch.ops import decimator, front
    from pebblesdr_tpu_torch.ops.mixer import split_freq

    if not torch.cuda.is_available():
        raise RuntimeError("fir_cells needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{tag}] {card}", flush=True)
    plans = {}
    for name, protect in PROTECT.items():
        p = decimator.build_plan(FS, protect)
        plans[name] = front.FrontPlan.make(decimator.compose_response(p),
                                           p.factor, "cuda")
    zeros = dict(dtype=torch.float32, device="cuda")
    iq = tuple(torch.tensor(v, device="cuda") for v in cs.IQ)
    res = {}
    for name, c, k, form, pk in CELLS:
        plan = plans[pk]
        if not plan.smem_bytes:      # a checkout without this geometry
            print(f"[{tag}] {name}: no front_fir instantiation for "
                  f"{plan.h.numel()} taps at factor {plan.factor}; skipped",
                  flush=True)
            continue
        i16 = form == "i16"
        block = cs.am_plane(c, N, None)
        x = torch.from_numpy(cs.to_i16(block) if i16 else block).cuda()
        x = x.repeat(k, 1).contiguous()
        tunes = [split_freq(250_000.0 + 1234.5 * i, FS) for i in range(c)]
        f_hi, f_lo = (torch.tensor(np.array([v[j] for v in tunes]),
                                   device="cuda") for j in (0, 1))
        tail = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (plan.d_rows, 2 * c)).astype(np.float32) * 0.1).cuda()
        args = (x, torch.full((1, 2 * c), 0.01, **zeros),
                torch.full((c,), 0.3, **zeros), f_hi, f_lo, tail)
        kw = dict(n_block=N, raw_rows=2048)
        if form == "nb1_iq":
            kw.update(iq_gain=iq[0], iq_phase=iq[1], nb=cs.NB1,
                      nb_avg=torch.zeros(1, 2 * c, **zeros),
                      nb_tail=torch.zeros(16, 2 * c, **zeros))
        check = cs.check_options_form(torch, front, plan, args, kw,
                                      f"[{tag}] {name}")

        def call():
            return front.fused_front(plan, *args, **kw)

        out = call()
        hashed = (("y", out[0]), ("tail", out[2])) + (
            (("nb_tail", out[6]),) if "nb" in kw else ())
        bits = {nm: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
                for nm, v in hashed}
        del out
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call()
        end.record()
        end.synchronize()
        k1 = start.elapsed_time(end) / 10
        launches = kernel_ms(torch, call)
        h0 = time.perf_counter()
        for _ in range(20):
            call()
        host = (time.perf_counter() - h0) / 20 * 1e3
        torch.cuda.synchronize()
        fir = next((v for kk, v in launches.items()
                    if kk.startswith("front_fir")), None)
        print(f"[{tag}] {name}: front_fir {fir:.4f} ms per launch, K1 "
              f"{k1:.4f} ms (events), host {host:.4f} ms per call; sha256 "
              + " ".join(f"{kk}' {v}" if kk != "y" else f"y {v}"
                         for kk, v in bits.items()) + "; per launch: "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in
                          sorted(launches.items())), flush=True)
        res[name] = {"front_fir_ms": fir, "k1_ms": k1, "host_ms": host,
                     "launch_ms": launches, "worst": check["worst"],
                     "sha256": bits}
        if pk in ("wfm", "hq"):    # the cell's own form: WFM, or hq
            res[name].update(own_form(torch, cs, front, wfm, plan, args, kw,
                                      pk, f"[{tag}] {name} ({pk} form)"))
        del args, x, tail
        torch.cuda.empty_cache()
    out = {"tag": tag, "device": card, "cells": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
