"""K1 probe bench on the card: the copy floors, the port's K1, and the
Toeplitz-product front variants v1-v5.

Port of the JAX package's tools/kbench2.py (its kernels are in
ops/kprobe.py).  On a CUDA device:

    python -m pebblesdr_tpu_torch.tools.kbench2 [variants...]

Variants (default: floor v0 v1 v2):
  floor    : copy-only kernel on two planes [T, C], sub 2048, 4096, 8192
  v0       : the port's production K1 (ops/front.fused_front, base form)
  v1, v2   : the front on two planes with the fine table: two products,
             or one product over [er | ei]; sub 2048, 4096
  floor128 : copy-only kernel on one packed plane [T, 2C]
  floorxla : the strided slice and the reshape-sum, as plain torch calls
  v3       : the front on one packed plane
  v4       : the front with the packed A/B phasor tables, kt = 1 (v4) and
             kt = 2, 4 (v5, the K-tiled product)
Environment: TB_CHANNELS (64), TB_FRAMES (32768), TB_BLOCKS (8),
TB_STEPS (40).  floor, v0, v1 and v2 read the AM tone at 250 kHz;
floor128, floorxla, v3 and v4 a seeded normal plane.  Each call takes a
whole dispatch of TB_BLOCKS blocks, in one launch, and carries its state to
the next.  Times: CUDA events around TB_STEPS calls after 2 warm-up calls,
the best of 3 windows; each line gives ms per block, Msps (GB/s read for
the floors) and the block's bound (kprobe.probe_bound; v0's
roofline.k1_bound).

``main(argv, device="cpu")`` runs the plain versions on the CPU (times are
then the CPU's); with no CUDA device and no CPU request it raises.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import front, kprobe
from pebblesdr_tpu_torch.utils import roofline

FS = 2_048_000
F_HI = 0.1220703125        # 250 kHz at 2.048 Msps, exact in float32
NAMES = ("floor", "v0", "v1", "v2", "floor128", "floorxla", "v3", "v4")
DEFAULT = ("floor", "v0", "v1", "v2")
WARMUP = 2
WINDOWS = 3


def settings() -> dict:
    """The TB_* variables, read at each run."""
    env = os.environ.get
    return {"channels": int(env("TB_CHANNELS", "64")),
            "frames": int(env("TB_FRAMES", "32768")),
            "blocks": int(env("TB_BLOCKS", "8")),
            "steps": int(env("TB_STEPS", "40"))}


def am_planes(c: int, n: int, k: int, device) -> torch.Tensor:
    """[2, k n, c] re and im planes: the AM tone at 250 kHz (1 kHz, m =
    0.8) of tools/kbench2.py:53-58 on every channel, one n-row block
    repeated k times."""
    t = np.arange(n) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)).astype(np.complex64)
    ri = np.broadcast_to(np.stack([iq.real, iq.imag]).astype(np.float32)
                         [:, :, None], (2, n, c))
    planes = torch.from_numpy(np.ascontiguousarray(ri)).to(device)
    return planes.repeat(1, k, 1)


def normal_plane(rows: int, lanes: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(rows, lanes, generator=gen, device=device)


class Bench:
    """Times one line: fn(state) -> state over whole dispatches."""

    def __init__(self, device: torch.device, s: dict):
        self.dev, self.s = device, s
        self.results: list[dict] = []

    def _window(self, fn, st):
        steps = self.s["steps"]
        if self.dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                st = fn(st)
            end.record()
            end.synchronize()
            return st, start.elapsed_time(end)
        t0 = time.perf_counter()
        for _ in range(steps):
            st = fn(st)
        return st, (time.perf_counter() - t0) * 1e3

    def measure(self, name: str, fn, state, bnd: dict, read_bytes: int = 0,
                **info) -> dict:
        before = (kprobe.probe_floor.launches, kprobe.probe_front.launches,
                  front.fused_front.launches)
        for _ in range(WARMUP):
            state = fn(state)
        windows = []
        for _ in range(WINDOWS):
            state, ms = self._window(fn, state)
            windows.append(ms)
        c, n, k = self.s["channels"], self.s["frames"], self.s["blocks"]
        dt = min(windows) / (self.s["steps"] * k)
        msps = c * n / (dt * 1e-3) / 1e6
        b_ms = bnd["bound_ms"] / k
        line = f"{name:>34s}: {dt:8.4f} ms/block  ({msps:7.0f} Msps"
        if read_bytes:
            line += f", {read_bytes / k / (dt * 1e-3) / 1e9:6.0f} GB/s read"
        print(line + f"); bound {b_ms:.4f} ms/block ({bnd['bound_by']})",
              flush=True)
        after = (kprobe.probe_floor.launches, kprobe.probe_front.launches,
                 front.fused_front.launches)
        res = {"name": name, "ms_block": dt, "windows_ms": windows,
               "msps": msps, "bound_ms_block": b_ms,
               "bound_by": bnd["bound_by"],
               "launches": {key: a - b for key, a, b in zip(
                   ("probe_floor", "probe_front", "fused_front"), after,
                   before)}, **info}
        self.results.append(res)
        return res


def main(argv=None, device=None) -> list[dict]:
    """Run the named variants (module docstring) and return one record per
    printed line: name, ms_block, windows_ms, msps, bound_ms_block,
    bound_by, the wrappers' launches during the line, and its variant, sub
    and kt."""
    which = list(sys.argv[1:] if argv is None else argv) or list(DEFAULT)
    unknown = [w for w in which if w not in NAMES]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; choose from {NAMES}")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kbench2 needs a CUDA device; main(argv, "
                           "device='cpu') runs the plain versions")
    s = settings()
    c, n, k = s["channels"], s["frames"], s["blocks"]
    t = n * k
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                 channels=c, mode=DemodMode.AM,
                                 agc_stride=16), dev)
    plan = rx.front
    factor, d = plan.factor, plan.d_rows
    f_hi, f_lo = np.full(c, F_HI), np.zeros(c)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"kbench2 on {kind}: {c} channels, {k} blocks of {n} frames per "
          f"call, {s['steps']} calls per window; AM plan factor {factor}, "
          f"{plan.h.numel()} taps, d_rows {d}", flush=True)
    bench = Bench(dev, s)
    zeros = dict(dtype=torch.float32, device=dev)
    x2 = (am_planes(c, n, k, dev)
          if {"floor", "v0", "v1", "v2"} & set(which) else None)
    xn = (normal_plane(t, 2 * c, dev)
          if {"floor128", "floorxla", "v3", "v4"} & set(which) else None)

    def front_line(label, variant, x, state, sub, kt=1):
        def fn(st):
            _, dc, tl, ph = kprobe.probe_front(variant, plan, x, st[0], st[1],
                                               f_hi, f_lo, st[2], sub, kt)
            return dc, ph, tl
        bench.measure(label, fn, state,
                      kprobe.probe_bound(variant, sub, kt, c, t, factor, d,
                                         plan.h.numel()),
                      variant=variant, sub=sub, kt=kt)

    for w in (name for name in NAMES if name in which):
        if w in ("floor", "floor128"):
            planes = (x2[0], x2[1]) if w == "floor" else (xn,)
            for sub in (2048, 4096, 8192):
                bench.measure(
                    f"floor copy-only sub={sub}" if w == "floor"
                    else f"floor128 packed sub={sub}",
                    lambda st, sub=sub: (kprobe.probe_floor(planes, sub,
                                                            factor), st)[1],
                    None, kprobe.probe_bound(w, sub, 1, c, t, factor),
                    read_bytes=t * 2 * c * 4, variant=w, sub=sub, kt=1)
        elif w == "v0":
            xpk = torch.cat([x2[0], x2[1]], 1)
            hi, lo = (torch.tensor(v, **zeros) for v in (f_hi, f_lo))

            def fn(st):
                _, dc, tl, ph, _ = front.fused_front(plan, xpk, st[0], st[1],
                                                     hi, lo, st[2], n_block=n)
                return dc, ph, tl
            b = roofline.k1_bound(plan, t, c, 4, n, 8)    # 8 raw rows
            bench.measure("v0 port K1 (fused_front)", fn,
                          (torch.zeros(1, 2 * c, **zeros),
                           torch.zeros(c, **zeros),
                           torch.zeros(d, 2 * c, **zeros)), b,
                          variant="v0", sub=front.SUB_BLOCK, kt=1)
        elif w in ("v1", "v2"):
            for sub in (2048, 4096):
                front_line(f"{w} fine-table{'+packed' if w == 'v2' else ''} "
                           f"sub={sub}", w, x2,
                           (torch.zeros(2, c, **zeros),
                            torch.zeros(c, **zeros),
                            torch.zeros(2 * d, c, **zeros)), sub)
        elif w == "floorxla":
            b = kprobe.probe_bound("floor128", factor, 1, c, t, factor)
            bench.measure("floorxla strided slice (torch)",
                          lambda st: (xn[::factor].abs(), st)[1], None, b,
                          read_bytes=t * 2 * c * 4, variant=w, sub=0, kt=1)
            bench.measure("floorxla reshape-sum (torch)",
                          lambda st: (xn.view(t // factor, factor, 2 * c)
                                      .sum(1).abs(), st)[1], None, b,
                          read_bytes=t * 2 * c * 4, variant=w, sub=0, kt=1)
        elif w == "v3":
            for sub in (2048, 4096):
                front_line(f"v3 packed-plane sub={sub}", "v3", xn,
                           (torch.zeros(1, 2 * c, **zeros),
                            torch.zeros(c, **zeros),
                            torch.zeros(d, 2 * c, **zeros)), sub)
        else:   # v4: kt = 1, and the K-tiled v5 at kt = 2, 4
            for sub in (2048, 4096):
                for kt in (1, 2, 4):
                    v = "v4" if kt == 1 else "v5"
                    front_line(f"{v} packed-tables sub={sub} kt={kt}", v, xn,
                               (torch.zeros(1, 2 * c, **zeros),
                                torch.zeros(2 * c, **zeros),
                                torch.zeros(d, 2 * c, **zeros)), sub, kt)
    return bench.results


if __name__ == "__main__":
    main()
