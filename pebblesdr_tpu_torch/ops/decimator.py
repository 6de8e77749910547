"""Halfband decimation: the plan, its composed response and the staged
cascade.

Port of pebblesdr_tpu/ops/decimator.py: the stage chooser
(buildDecimationChain capability, decimator.cpp:64-149), the noble-identity
collapse of the cascade into one full-rate FIR, which the fused front end
(ops/front.py) applies, and the staged cascade (state_init, apply: one
halfband stage after another), which the staged front and RDS's staged
input run.  Each stage is ops/fir.fir_apply, one strided conv1d of the
stacked [re; im] rows (on the H100 it beat the JAX package's even/odd
polyphase form, whose strided phase views run as generic elementwise
kernels, 2.7x: PERF.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import fir

MIN_DECIMATED_RATE = 15000  # decimator.h:245

# taps -> alias-free bandwidth fraction of input rate (decimator.h:152-171 spec)
HALFBAND_SPECS: list[tuple[int, float]] = [
    (7, 0.0030),
    (11, 0.0500),
    (15, 0.0980),
    (19, 0.1434),
    (23, 0.1820),
    (27, 0.2160),
    (31, 0.2440),
    (35, 0.2680),
    (39, 0.2880),
    (43, 0.3060),
    (47, 0.3200),
    (51, 0.3332),
    (55, 0.4000),
]


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str          # "cic3" or "hb{taps}"
    taps: np.ndarray   # float64 host-side taps (DC gain 1)


@dataclasses.dataclass(frozen=True)
class DecimatorPlan:
    stages: tuple[Stage, ...]
    rate_in: float
    rate_out: float
    protect_bw: float

    @property
    def factor(self) -> int:
        return 2 ** len(self.stages)


_halfband_cache: dict[int, np.ndarray] = {}


def _halfband(ntaps: int, wpass: float) -> np.ndarray:
    if ntaps not in _halfband_cache:
        _halfband_cache[ntaps] = fir.design_halfband(ntaps, wpass)
    return _halfband_cache[ntaps]


def build_plan(sample_rate: float, protect_bw: float,
               sample_rate_out: float = 0.0, use_cic3: bool = True) -> DecimatorPlan:
    """Decimate by 2 while the post-stage rate stays >= max(min_rate,
    sample_rate_out) and a halfband exists that protects protect_bw."""
    min_rate = max(float(sample_rate_out), float(MIN_DECIMATED_RATE))
    rate = float(sample_rate)
    stages: list[Stage] = []
    while rate / 2.0 >= min_rate:
        need = protect_bw / rate  # required alias-free fraction at this rate
        chosen = None
        for ntaps, wpass in HALFBAND_SPECS:
            if wpass >= need:
                if use_cic3 and ntaps == 7:
                    chosen = Stage("cic3", fir.CIC3_TAPS)
                else:
                    chosen = Stage(f"hb{ntaps}", _halfband(ntaps, wpass))
                break
        if chosen is None:
            break  # no filter can protect this bandwidth — stop decimating
        stages.append(chosen)
        rate /= 2.0
    return DecimatorPlan(tuple(stages), float(sample_rate), rate, float(protect_bw))


def compose_response(plan: DecimatorPlan) -> np.ndarray:
    """Collapse the stage cascade into ONE full-rate FIR (noble identity):
    H = h1 * up2(h2) * up4(h3) * ... in float64."""
    h = np.array([1.0])
    up = 1
    for st in plan.stages:
        taps = np.asarray(st.taps, np.float64)
        hu = np.zeros((len(taps) - 1) * up + 1)
        hu[::up] = taps
        h = np.convolve(h, hu)
        up *= 2
    return h


def build_composed_w(h: np.ndarray, factor: int, sub_block: int,
                     pad: int) -> np.ndarray:
    """W [pad + D + sub, sub/factor] f32 with W[w, o] = H[D + pad + F*o - w]
    (zero outside [0, D]): the Toeplitz block mapping a tail-extended
    time-major input chunk to its decimated outputs, y = W^T @ xext.
    (pebblesdr_tpu/ops/pallas_kernels.py:104.)"""
    d = len(h) - 1
    o_out = sub_block // factor
    wn = pad + d + sub_block
    w = np.zeros((wn, o_out), np.float32)
    for o in range(o_out):
        base = pad + d + factor * o
        w[base - d: base + 1, o] = h[::-1]
    return w


def state_init(plan: DecimatorPlan, channels: int, device
               ) -> tuple[torch.Tensor, ...]:
    """The cascade's carry: one [C, T-1] complex64 tail per stage."""
    return tuple(fir.fir_tail_init(channels, len(st.taps), device)
                 for st in plan.stages)


def apply(plan: DecimatorPlan, state: tuple[torch.Tensor, ...],
          x: torch.Tensor):
    """x [C, N] complex64, N a multiple of 2^stages -> (state', y [C,
    N / 2^stages]): each stage the halfband with its float32 taps as a
    strided conv1d (fir.fir_apply)."""
    tails = []
    for st, tail in zip(plan.stages, state):
        x, tail = fir.fir_apply(x, st.taps.astype(np.float32), tail, 2)
        tails.append(tail)
    return tuple(tails), x
