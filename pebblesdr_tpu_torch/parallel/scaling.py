"""Scaling accounting for the sharded chain.

Port of pebblesdr_tpu/parallel/scaling.py.  ``halo_accounting`` and
``measure_step`` port as they are.  JAX's ``hlo_collective_stats`` and
``step_cost`` read XLA's compiled program (its HLO text and cost
analysis), which torch's eager step does not have; their counterparts here
count what a step really did: ``collective_stats`` runs the step and reads
parallel/comm.py's counters (collectives by kind, their payload bytes, and
where ranks share a card over gloo the host hops and their bytes), and
``step_cost`` takes the front's bytes and operations from
utils/roofline.py's K1 model at the shard's shape.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import decimator
from pebblesdr_tpu_torch.parallel import comm
from pebblesdr_tpu_torch.utils import roofline


def collective_stats(fn) -> dict:
    """Run fn() once and count its collectives (comm.counters)."""
    comm.reset_counters()
    fn()
    c = comm.counters
    return {"collective_ops": dict(c["calls"]),
            "collective_count": sum(c["calls"].values()),
            "collective_bytes": sum(c["bytes"].values()),
            "host_hops": c["hops"], "host_hop_bytes": c["hop_bytes"]}


def step_cost(rx, rows: int, channels: int) -> dict:
    """The fused front's bytes moved and operations on one shard of rows x
    channels (roofline.k1_bound's model; float32 plane, no raw tails)."""
    plan = rx.front
    c2, m = 2 * channels, rows // plan.factor
    nbytes = rows * c2 * 4 + 2 * plan.d_rows * c2 * 4 + m * c2 * 4
    ops = roofline.k1_ops(plan.h.numel(), rows, channels, plan.factor)
    return {"flops": float(ops), "bytes_accessed": float(nbytes),
            **roofline.k1_bound(plan, rows, channels, 4, rows, 0)}


def halo_accounting(rx, channels: int) -> dict:
    """Static cross-rank traffic per block of the time-sharded front end
    against the input volume (the only per-block communication of the
    sharded chain; the channel axis carries none by construction)."""
    taps_halo = sum((len(st.taps) - 1) for st in rx.plan.stages)
    os_state = rx.blk  # the overlap-save carried segment (one demod block)
    dc_seed = 1
    mix_phase = 1
    halo_complex = taps_halo + os_state + dc_seed + mix_phase
    halo_bytes = channels * halo_complex * 8  # complex64
    input_bytes = channels * rx.cfg.frames_per_buffer * 8
    return {
        "halo_complex_per_channel": int(halo_complex),
        "halo_bytes_per_block": int(halo_bytes),
        "input_bytes_per_block": int(input_bytes),
        "halo_share": halo_bytes / max(input_bytes, 1),
        "composed_halo_complex_per_channel":
            len(decimator.compose_response(rx.plan)) - 1,
    }


def measure_step(step_fn, args, steps: int = 8) -> float:
    """Median of 3 wall times per call of `steps` repeated calls (after a
    warm-up call), synchronizing the card when one is in use."""
    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    step_fn(*args)
    sync()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(*args)
        sync()
        times.append((time.perf_counter() - t0) / steps)
    return float(np.median(times))
