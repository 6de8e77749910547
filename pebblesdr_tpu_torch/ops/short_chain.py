"""The host side of csrc/recur.cu's short-chain kernel (K4 agc_scan, K6
ook_scan): its launch plan and K6's input streams and output block; and
the launch plan of its loop kernel (K3 pll_scan, K3c pll_chunk_scan).

The kernel gives each block 16 channels (a chain warp, a lane a channel,
and a copy warp; 64 channels take 4 SMs, 256 take 16).  A launch of N frames
takes the "pass" form where N <= STAGE_FRAMES (the whole row in one stage:
one load round trip, the chain, one store) and the "ring" form above it
(segments of STAGE_FRAMES frames through STAGES stages).  short_plan
mirrors the C short_plan (the card test holds it to recur_short_plan), so
the CPU tests reach the form choice and the shared-memory layout.

K6 reads its powers where they lie (ook_input): the three columns of one
[C, F, 3] tensor (goertzel_power's output, "the trio") as frames of three
floats, the main power first and, in compare mode, the compare bins' low
and high powers after it; or the main power's plane alone (frames of one
float; no compare bins: zero powers).  Separate low and high planes in
compare mode are packed into a trio first (the kernel reads the bins from
the trio only; no caller on the main path passes them so).  Its state'
comes back in one allocation of six [C] rows of 4-byte words (peak, floor,
avg; attack, decay; the decisions' bytes at the start of the sixth).

The loop kernel gives each block LOOP_WARPS chain warps of LOOP_LANES
chains (one chain a block: 64 channels on 64 SMs) and a copy warp, and
streams each [C, N] complex64 row through stages of LOOP_STAGE_FRAMES
float2 frames as the short-chain kernel streams its frames ("pass" where
N <= LOOP_STAGE_FRAMES, "ring" above); the copy warp writes each landed
row's denominators q (costas, pilot) beside it, and the chain lanes two
float output rows a stage.
loop_plan mirrors the C loop_plan (the card test holds it to
recur_loop_plan).
"""

from __future__ import annotations

import dataclasses

import torch

LANES = 16            # channels per block: the chain warp's lanes (kShLanes)
THREADS = 64          # the chain warp and the copy warp (kShThreads)
GROUP = 4             # steps per register group (kShU)
STAGE_FRAMES = 128    # frames per stage in the ring form (kShL)
STAGES = 3            # stages in the ring form (kShStages)
PIN_BYTES = 32        # the step's pinned constants (kShPinBytes)
FORMS = ("pass", "ring")


def _round(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ShortPlan:
    form: str             # "pass" or "ring"
    frames: int           # frames per stage (L)
    stages: int
    pitch: int            # floats per staged row
    out_pitch: int        # bytes per output row in a stage
    smem: int             # dynamic shared-memory bytes
    lanes: int = LANES
    threads: int = THREADS

    def as_ints(self) -> list[int]:
        """The 8 values recur_short_plan writes, in its order."""
        return [FORMS.index(self.form) + 1, self.frames, self.stages,
                self.pitch, self.out_pitch, self.smem, self.lanes,
                self.threads]


def short_plan(n: int, fs: int, esz: int) -> ShortPlan:
    """The launch plan for n frames of fs floats and esz-byte outputs
    (csrc/recur.cu short_plan): the form, the stage's frames, the staged
    row's pitch (= 4 mod 32 floats: the rows start in banks as far apart
    as 16-byte rows allow; with room for the row's float offset in its
    16-byte line and a register group read past the segment), the output
    rows' pitch (the pass form: the row itself, so that the block's rows
    are contiguous as in device memory; the ring form: 16-byte multiples,
    never a multiple of 128) and the shared memory (the step's pinned
    constants, the stages' full and done mbarriers, the input and the
    output stages)."""
    if fs < 1 or n < 0 or esz not in (1, 4):
        raise ValueError(f"short_plan: {n} frames of {fs} floats, "
                         f"{esz}-byte outputs")
    form = "pass" if n <= STAGE_FRAMES else "ring"
    frames = n if form == "pass" else STAGE_FRAMES
    stages = 0 if n <= 0 else (1 if form == "pass" else STAGES)
    pitch = _round((frames + 2 * GROUP) * fs, 32) + 4
    if form == "pass":
        out_pitch = frames * esz
    else:
        out_pitch = _round(frames * esz, 16)
        out_pitch += 16 if out_pitch % 128 == 0 else 0
    smem = (PIN_BYTES + _round(2 * stages * 8, 16)
            + stages * LANES * (pitch * 4 + out_pitch))
    return ShortPlan(form, frames, stages, pitch, out_pitch, smem)


LOOP_LANES = 1           # chains a chain warp (kPlLanes)
LOOP_WARPS = 1           # chain warps a block (kPlWarps)
LOOP_GROUP = 4           # steps per register group (kPlU)
LOOP_STAGE_FRAMES = 128  # frames per stage in the ring form (kPlL)
LOOP_STAGES = 3          # stages in the ring form (kPlStages)


@dataclasses.dataclass(frozen=True)
class LoopPlan:
    form: str             # "pass" or "ring"
    frames: int           # frames per stage (L)
    stages: int
    pitch: int            # floats per staged row (two a frame)
    qpitch: int           # floats per row of denominators q
    out_pitch: int        # bytes per output row in a stage
    smem: int             # dynamic shared-memory bytes
    lanes: int = LOOP_LANES
    warps: int = LOOP_WARPS

    @property
    def rows(self) -> int:
        """Channels a block."""
        return self.lanes * self.warps

    @property
    def threads(self) -> int:
        """The chain warps and the copy warp."""
        return 32 * (self.warps + 1)

    def as_ints(self) -> list[int]:
        """The 10 values recur_loop_plan writes, in its order."""
        return [FORMS.index(self.form) + 1, self.frames, self.stages,
                self.pitch, self.qpitch, self.out_pitch, self.smem,
                self.lanes, self.warps, self.threads]


def loop_plan(n: int) -> LoopPlan:
    """The loop kernel's plan for n complex frames (csrc/recur.cu
    loop_plan): the form, the stage's frames, the staged row's pitch (=
    4 mod 32 floats, room for the row's float offset in its 16-byte line
    and a register group read past the segment), the q rows' pitch (= 1
    mod 32 floats: the copy warp's denominators for the chain lanes), the
    output rows' pitch (as short_plan's, for 4-byte outputs) and the
    shared memory (the pinned constants, the full, ready and done
    mbarriers, the input, q and the two outputs' stages)."""
    if n < 0:
        raise ValueError(f"loop_plan: {n} frames")
    form = "pass" if n <= LOOP_STAGE_FRAMES else "ring"
    frames = n if form == "pass" else LOOP_STAGE_FRAMES
    stages = 0 if n <= 0 else (1 if form == "pass" else LOOP_STAGES)
    pitch = _round((frames + 2 * LOOP_GROUP) * 2, 32) + 4
    qpitch = _round(frames + LOOP_GROUP, 32) + 1
    if form == "pass":
        out_pitch = frames * 4
    else:
        out_pitch = _round(frames * 4, 16)
        out_pitch += 16 if out_pitch % 128 == 0 else 0
    rows = LOOP_LANES * LOOP_WARPS
    smem = (PIN_BYTES + _round(3 * stages * 8, 16)
            + stages * rows * (pitch * 4 + 2 * out_pitch)
            + _round(stages * rows * qpitch * 4, 16))
    return LoopPlan(form, frames, stages, pitch, qpitch, out_pitch, smem)


def loop_blocks(c: int) -> int:
    """Blocks of a loop-kernel launch over c channels."""
    return -(-c // (LOOP_LANES * LOOP_WARPS))


def raw_stream(idx: int) -> int:
    """The handle of device idx's current CUDA stream, as
    torch.cuda.current_stream(idx).cuda_stream gives it without building a
    Stream object (a few microseconds of a call that takes tens)."""
    return torch._C._cuda_getCurrentRawStream(idx)


def blocks(c: int) -> int:
    """Blocks of a launch over c channels."""
    return -(-c // LANES)


def is_trio(pm, pl, ph) -> bool:
    """Whether main, low and high are the three columns of one [C, F, 3]
    tensor whose frames are contiguous: low and high one and two floats
    after main, all three with main's strides and a frame stride of 3."""
    if pl is None or ph is None:
        return False
    s = pm.stride()
    return (s[1] == 3 and pl.stride() == s and ph.stride() == s
            and pl.data_ptr() == pm.data_ptr() + 4
            and ph.data_ptr() == pm.data_ptr() + 8)


def ook_input(pm, pl, ph, compare: bool) -> tuple:
    """K6's input (tensor, channel stride, frame stride, bins): the main
    power of row c's frame t at tensor[c cs + t fs] (floats); bins: the
    frame's next two floats are the low and high powers (read in compare
    mode only).  In compare mode with bins (low and high not None): the
    trio's columns as they lie, or separate planes packed into a trio.
    Otherwise the main power alone, in place where its frame stride is 1
    to 3 floats (a column of the trio, say), else a contiguous copy."""
    c, f = pm.shape
    if compare and pl is not None and ph is not None:
        if not is_trio(pm, pl, ph):
            pm = torch.stack((pm, pl, ph), dim=-1)[:, :, 0]
        return pm, (pm.stride(0) if c > 1 else 3 * f), 3, 1
    fs = pm.stride(1) if f > 1 else 1
    if not 1 <= fs <= 3:
        pm, fs = pm.contiguous(), 1
    return pm, (pm.stride(0) if c > 1 else fs * f), fs, 0
