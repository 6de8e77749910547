"""Perform: stage timing (min/max/avg), and a torch.profiler trace hook.

Port of pebblesdr_tpu/utils/perform.py (the reference's rdtsc-style
profiler, pebblelib/perform.h:18-41, as a context manager).  A Perform
built for a CUDA device synchronizes the device before it reads the clock
at the end of each measured region, so a region that only enqueues work is
charged for it; on the CPU it reads the clock as it is.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Perform:
    def __init__(self, device: str | torch.device | None = None):
        self.samples: dict[str, list[float]] = defaultdict(list)
        dev = torch.device(device) if device is not None else None
        self._sync = dev if dev is not None and dev.type == "cuda" else None

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self, name: str, skip_warmup: int = 1) -> dict:
        xs = self.samples.get(name, [])
        xs = xs[skip_warmup:] if len(xs) > skip_warmup else xs
        if not xs:
            return {}
        return {
            "min": round(min(xs) * 1e3, 3),
            "max": round(max(xs) * 1e3, 3),
            "avg": round(sum(xs) / len(xs) * 1e3, 3),
            "n": len(xs),
        }

    def report(self) -> dict:
        return {k: self.stats(k) for k in self.samples}


@contextlib.contextmanager
def trace(dirname: str):
    """torch.profiler trace of the block (CPU and, where there is one, CUDA
    activity), written to dirname as a Chrome trace (trace.json) on exit;
    yields the profiler, whose key_averages() reads the kernels' times."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(dirname, exist_ok=True)
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))
