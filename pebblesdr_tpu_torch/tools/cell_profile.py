"""Dispatch ms and device busy per dispatch of receiver cells on the card,
for the checkout at ROOT (default: this one; any checkout of the port with
a chip_smoke.py, e.g. a parent commit unpacked under build/).

    python pebblesdr_tpu_torch/tools/cell_profile.py [--spectra-every S]
        [ROOT [TAG [CELL ...]]]

(run as a script, not with -m, so that ROOT's package is the one imported)

Cells: any of the named cells of tools/cells.py's CELLS (PERF.md section
4) by name; by default am_64ch (AM, 64 channels, 32 blocks of 32768
frames), wfm_64ch (FM stereo, the same shape) and wfm_hq_64ch (FM stereo
at the hq geometry).  ROOT's own cell machinery builds and times each:
its package's tools/cells.py, or in a checkout from before that module its
chip_smoke.py (the cells it names in STAGED_CELLS or ANF_CELLS by its own
functions, the others at this tree's CELLS entry; a cell that checkout
cannot build raises).  time_cells (3 warm-up dispatches, then 3 windows
of 10 dispatches with spectra every 6th, pfb_127st_bank128 every one;
launch counts, audio shape, squelch, pilot lock and tone SNR checked),
then dispatch_profile (5 dispatches with spectra off, pfb_127st_bank128
on: ms by events, host enqueue, device busy from torch.profiler, idle
share).  --spectra-every S computes the spectra every S-th dispatch in
every cell (so two checkouts whose cells differ in it compare at one
setting).  The last line is one JSON object of the results.  Raises
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import runpy
import subprocess
import sys
import types

DEFAULT = ("am_64ch", "wfm_64ch", "wfm_hq_64ch")
HERE = os.path.dirname(os.path.abspath(__file__))


def machinery(root: str):
    """The cell machinery of the checkout at root, whose package is the one
    on sys.path: its tools/cells.py, or in a checkout from before that
    module its chip_smoke.py run as a namespace.  fir_cells.py and
    tail_cells.py load this function from this file by path."""
    if os.path.exists(os.path.join(root, "pebblesdr_tpu_torch", "tools",
                                   "cells.py")):
        from pebblesdr_tpu_torch.tools import cells
        return cells
    return types.SimpleNamespace(**runpy.run_path(
        os.path.join(root, "chip_smoke.py")))


def build_cell(cs, torch, receiver, front, name: str) -> dict:
    """The cell called name, built by the checkout's cell machinery cs."""
    if hasattr(cs, "named_cell"):
        return cs.named_cell(torch, receiver, front, name)
    made = {**getattr(cs, "STAGED_CELLS", {}), **getattr(cs, "ANF_CELLS", {})}
    if name in made:
        return made[name](torch, receiver, front)
    spec = runpy.run_path(os.path.join(HERE, "cells.py"))["CELLS"][name]
    return cs.make_cell(torch, receiver, front,
                        getattr(receiver.DemodMode, spec.mode), name,
                        spec.channels, spec.blocks, spec.entry, spec.opts,
                        frames=spec.frames)


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

    from pebblesdr_tpu_torch.chain import receiver
    from pebblesdr_tpu_torch.ops import front, wfm_tail

    if not torch.cuda.is_available():
        raise RuntimeError("cell_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[{tag}] {card}", flush=True)
    cs = machinery(root)
    res = {}
    for name in names:
        cell = build_cell(cs, torch, receiver, front, name)
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
