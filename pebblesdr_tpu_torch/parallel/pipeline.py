"""Stage pipelining: chain stages on a ring of ranks.

Port of pebblesdr_tpu/parallel/pipeline.py.  The reference's only
concurrency is pipeline parallelism between Qt threads (device producer ->
chain -> audio output; pebblelib/producerconsumer.h:18-96).  Here the
receive chain is split into S stages, stage s runs on rank s of a
``stage`` mesh axis, and every tick each rank runs its stage on the block
it holds, then hands the result to its right neighbour (one ring shift).
After S-1 warm-up ticks all S ranks compute different blocks of the stream
at once, and one finished block leaves the last rank per tick.

Inter-stage payloads ride one fixed [rows, width] float32 buffer (each
stage unpads its input and pads its output).  A rank advances only its own
stage's state, behind the warm-up/flush gate (rank s holds block t - s at
tick t); the last stage's output reaches every rank by one all-reduce per
tick; ``RingPipeline.run`` returns every stage's state from its owner
rank, so back-to-back runs compose, streaming-exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from pebblesdr_tpu_torch.parallel import comm
from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
from pebblesdr_tpu_torch.utils.precision import ieee_float32


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: fn(state, x) -> (state', y) with x float32
    [in_shape], y float32 [out_shape]."""
    fn: Callable[[Any, torch.Tensor], tuple[Any, torch.Tensor]]
    in_shape: tuple[int, int]
    out_shape: tuple[int, int]


def stage_mesh(n: int, device_type: str | None = None):
    """A one-axis ("stage",) mesh of n ranks."""
    return mesh_mod.make_axis_mesh("stage", n, device_type)


class RingPipeline:
    """S-stage ring over the ``stage`` axis of mesh.

    run(states, xs): xs [T, *stages[0].in_shape] -> (states', ys [T,
    *stages[-1].out_shape]), on every rank; T + S - 1 ticks (the ring
    drains at the end of every run, so runs compose); block b's result
    leaves at tick b + S - 1."""

    def __init__(self, stages: list[Stage], mesh, axis: str = "stage"):
        self.stages = list(stages)
        self.mesh = mesh
        self.axis = axis
        s = len(self.stages)
        if mesh.size(axis) != s:
            raise ValueError(f"mesh axis '{axis}' has {mesh.size(axis)} "
                             f"ranks, need one per stage ({s})")
        self.rows = max(max(st.in_shape[0], st.out_shape[0])
                        for st in self.stages)
        self.width = max(max(st.in_shape[1], st.out_shape[1])
                         for st in self.stages)

    @ieee_float32()
    def run(self, states, xs: torch.Tensor):
        """Process T = xs.shape[0] blocks; returns (states', ys)."""
        mesh, axis, s = self.mesh, self.axis, len(self.stages)
        dev = mesh.device
        idx = mesh.index(axis)
        st_i = self.stages[idx]
        states = list(states)
        t_blocks = xs.shape[0]
        buf = torch.zeros(self.rows, self.width, device=dev)
        out_r, out_w = self.stages[-1].out_shape
        ys = []
        for t in range(t_blocks + s - 1):
            b = buf
            if idx == 0:
                b = torch.zeros(self.rows, self.width, device=dev)
                if t < t_blocks:
                    b[:xs.shape[1], :xs.shape[2]] = xs[t].to(dev)
            x = b[:st_i.in_shape[0], :st_i.in_shape[1]]
            new_i, y = st_i.fn(states[idx], x)
            y_pad = torch.zeros(self.rows, self.width, device=dev)
            y_pad[:st_i.out_shape[0], :st_i.out_shape[1]] = y
            # warm-up/flush gate: rank idx holds block t - idx; its state
            # advances only while that block is real
            if t >= idx and t - idx < t_blocks:
                states[idx] = new_i
            out = comm.all_sum(y_pad if idx == s - 1 else
                               torch.zeros_like(y_pad), mesh, axis)
            if t >= s - 1:
                ys.append(out[:out_r, :out_w])
            buf = comm.ring_shift_right(y_pad, mesh, axis)
        # every stage's state from the rank that owns it
        new_states = tuple(comm.tree_broadcast_from(states[i], mesh, axis, i)
                           for i in range(s))
        return new_states, torch.stack(ys)


# ---------------------------------------------------------------------------
# The receive chain split into stages: the classic 4-deep SDR pipeline
# (front mix -> decimate -> bandpass -> demod/audio), built from the staged
# front's ops, so the pipelined chain is the staged Receiver's step.
# ---------------------------------------------------------------------------

def _pack(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([z.real, z.imag], dim=0)


def _unpack(b: torch.Tensor) -> torch.Tensor:
    c = b.shape[0] // 2
    return torch.complex(b[:c], b[c:])


def am_chain_stages(rx, params) -> tuple[list[Stage], tuple]:
    """Split an AM Receiver's chain into 4 pipeline stages.

    Returns (stages, init_states).  Payload layout: complex [C, n] rides as
    packed [2C, n] float32 planes; the final stage emits real audio [C,
    audio_blk].  The stages are the STAGED front's ops (dc_removal_chunked,
    mixer.mix, decimator.apply), so rx must run the staged front (for
    example ReceiverConfig(taps=True)): the fused front (K1) keeps its DC
    and decimator state lane-packed, which these stages cannot consume."""
    from pebblesdr_tpu_torch.demod import am as am_mod
    from pebblesdr_tpu_torch.ops import (agc, decimator, fastfir, front, iir,
                                         mixer, resampler)

    if not rx.staged:
        raise ValueError(
            "am_chain_stages needs the staged front's state layout; build "
            "the Receiver on the staged front (e.g. taps=True): the fused "
            "front (K1) keeps its dc/decim state lane-packed, which the "
            "per-stage fns cannot consume")
    c = rx.cfg.channels
    n = rx.cfg.frames_per_buffer
    blk = rx.blk
    base = rx.init_state()

    def s_front(state, b):
        dc, mx = state
        dc, x = iir.dc_removal_chunked(dc, _unpack(b), alpha=0.9999,
                                       chunk=front.DC_CHUNK)
        mx, x = mixer.mix(mx, x, params.tune_hi, params.tune_lo)
        return (dc, mx), _pack(x)

    def s_decim(state, b):
        state, x = decimator.apply(rx.plan, state, _unpack(b))
        return state, _pack(x)

    def s_bandpass(state, b):
        mask = torch.complex(params.bp_mask[0], params.bp_mask[1])
        state, x = fastfir.apply(state, _unpack(b), mask)
        return state, _pack(x)

    def s_demod(state, b):
        agc_st, dm, rs = state
        agc_st, x = agc.agc_apply(rx.agc_cfg, agc_st, _unpack(b))
        dm, audio = am_mod.am_demod(rx.am_cfg, dm, x)
        rs, audio = resampler.apply_many(rx.rs_plan, rs, audio)
        return (agc_st, dm, rs), audio

    stages = [
        Stage(s_front, (2 * c, n), (2 * c, n)),
        Stage(s_decim, (2 * c, n), (2 * c, blk)),
        Stage(s_bandpass, (2 * c, blk), (2 * c, blk)),
        Stage(s_demod, (2 * c, blk), (c, rx.audio_blk)),
    ]
    init = ((base.dc, base.mixer), base.decim, base.fastfir,
            (base.agc, base.demod, base.resamp))
    return stages, init
