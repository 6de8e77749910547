"""Dispatch ms and device busy per dispatch of receiver cells on the card,
for the checkout at ROOT (default: this one; any checkout of the port with
a chip_smoke.py, e.g. a parent commit unpacked under build/).

    python pebblesdr_tpu_torch/tools/cell_profile.py [--spectra-every S]
        [ROOT [TAG [CELL ...]]]

(run as a script, not with -m, so that ROOT's package is the one imported)

Cells (PERF.md section 4; by default the first three): am_64ch (AM, 64
channels, 32 blocks of 32768 frames), wfm_64ch (FM stereo, the same
shape), wfm_hq_64ch (FM stereo at the hq geometry), and by name
am_nb_64ch (NB1), am_256ch, am_i16_256ch (256 channels, 16 blocks, float32
and int16), am_16ch (16 channels, 64 blocks, folded by 4), wfm_rds_64ch
(RDS), wfm_16ch (16 channels, 64 blocks, folded by 4), and the cells of
the per-sample loops: wfm_rds_scan_64ch (wfm_rds_64ch with the scan RDS
carrier) and sam_short_64ch (SAM, 64 channels, 128 blocks of 2048
frames: 64-sample demod blocks), and the cells of the staged front and
the dense bank: am_iqauto_64ch (am_64ch with enable_iq_balance="auto"
on an IQ-imbalanced plane) and pfb_127st_bank128 (bench.py:228-290: 127
AM stations through a 128-channel filterbank; a checkout whose
chip_smoke.py has STAGED_CELLS), and the ANF's cells am_anf_long_64ch and
am_iqauto_anf_64ch (am_iqauto_64ch with enable_anf=True; a checkout whose
chip_smoke.py has ANF_CELLS).  Each is built and timed by
ROOT's chip_smoke.py: time_cells (3 warm-up dispatches, then 3 windows of
10 dispatches with spectra every 6th, pfb_127st_bank128 every one; launch
counts, audio shape, squelch, pilot lock and tone SNR checked), then
dispatch_profile (5 dispatches with spectra off, pfb_127st_bank128 on: ms
by events, host enqueue, device busy from torch.profiler, idle share).
--spectra-every S computes the spectra every S-th dispatch in every cell
(so two checkouts whose cells differ in it compare at one setting).  The
last line is one JSON object of the results.  Raises without a CUDA
device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# name: (mode, channels, blocks, entry, receiver options[, frames])
CELLS = {"am_64ch": ("AM", 64, 32, "f32", {}),
         "wfm_64ch": ("FMS", 64, 32, "f32", {}),
         "wfm_hq_64ch": ("FMS", 64, 32, "f32", {"wfm_hq": True}),
         "am_nb_64ch": ("AM", 64, 32, "f32", {"enable_noise_blanker": True}),
         "am_256ch": ("AM", 256, 16, "f32", {}),
         "am_i16_256ch": ("AM", 256, 16, "i16", {}),
         "am_16ch": ("AM", 16, 64, "fold4", {}),
         "wfm_rds_64ch": ("FMS", 64, 32, "f32", {"rds": True}),
         "wfm_16ch": ("FMS", 16, 64, "fold4", {}),
         "wfm_rds_scan_64ch": ("FMS", 64, 32, "f32",
                               {"rds": True, "rds_alg": "scan"}),
         "sam_short_64ch": ("SAM", 64, 128, "f32", {}, 2048)}
DEFAULT = ("am_64ch", "wfm_64ch", "wfm_hq_64ch")


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    every = None
    if "--spectra-every" in argv:
        i = argv.index("--spectra-every")
        every = int(argv[i + 1])
        del argv[i:i + 2]
    root = os.path.abspath(argv[0] if argv else os.getcwd())
    tag = argv[1] if len(argv) > 1 else os.path.basename(root)
    names = argv[2:] or list(DEFAULT)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pebblesdr_tpu_torch.chain import receiver
    from pebblesdr_tpu_torch.ops import front, wfm_tail

    if not torch.cuda.is_available():
        raise RuntimeError("cell_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{tag}] {card}", flush=True)
    if every:
        cs.SPECTRA_EVERY = every
    res = {}
    for name in names:
        made = {**getattr(cs, "STAGED_CELLS", {}),
                **getattr(cs, "ANF_CELLS", {})}
        if name in made:
            cell = made[name](torch, receiver, front)
        else:
            mode, c, k, entry, opts, *frames = CELLS[name]
            cell = cs.make_cell(torch, receiver, front,
                                getattr(receiver.DemodMode, mode), name, c,
                                k, entry, opts,
                                **({"frames": frames[0]} if frames else {}))
        if every:
            cell["spectra_every"] = every
        cs.time_cells(torch, front, wfm_tail, [cell], f"[{tag}]")
        prof = cs.dispatch_profile(torch, cell, f"[{tag}]")
        res[name] = {"windows": cell["windows"], **prof}
        del cell
        torch.cuda.empty_cache()
    out = {"tag": tag, "device": card, "cells": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
