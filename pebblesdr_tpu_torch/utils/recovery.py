"""Stream recovery: consume health signals, checkpoint, resync after drops.

Port of pebblesdr_tpu/utils/recovery.py.  The reference only counts
producer overruns (signalspectrum.cpp:73-77); recovery is the operator
restarting the app.  Here the carry state is an explicit tree of tensors,
so recovery is a first-class operation:

  * **detect**: `HealthMonitor` flags sequence gaps (dropped IQ blocks)
    and falling behind;
  * **checkpoint**: the supervisor snapshots the chain state every K
    blocks (utils/checkpoint.py .npz), so a killed stream resumes bit for
    bit from the last snapshot;
  * **resync**: after a gap of G samples the carried oscillator phase is
    stale by G f cycles; `resync_state` advances every channel's NCO phase
    across the gap (in closed form: the phase ramp is exact, ops/mixer.py),
    so phase-coherent demods (SSB/CW/SAM/WFM pilot) come back aligned with
    the transmitter instead of at a random phase.  Filter tails and the
    AGC and PLL carries are kept: they re-converge within their own time
    constants, a bounded audio disturbance instead of a full restart.

Every action is logged as a structured `RecoveryEvent` (host side: this is
control-plane code, not chain math).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from pebblesdr_tpu_torch.ops.mixer import MixerState
from pebblesdr_tpu_torch.utils import checkpoint as ckpt
from pebblesdr_tpu_torch.utils.health import HealthMonitor


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    kind: str          # "gap" | "checkpoint" | "restore"
    block: int         # block index at which the event fired
    detail: dict
    t: float = dataclasses.field(default_factory=time.monotonic)


def resync_state(rx, state, params, gap_samples: int):
    """Advance the carried NCO phase across a gap of `gap_samples` device
    samples (per channel, split precision as ops/mixer.py mixes):
    remainder(phase + remainder(g tune_hi, 1) + remainder(g tune_lo, 1), 1)
    in float32, as the JAX package's jnp.mod takes it.

    Returns the resynced state.  Other carries (filter tails, AGC, PLLs)
    are left to re-converge: their transients are bounded by their own
    group delays and loop bandwidths."""
    g = float(gap_samples)
    phase = state.mixer.phase
    new_phase = torch.remainder(
        phase + torch.remainder(g * params.tune_hi, 1.0)
        + torch.remainder(g * params.tune_lo, 1.0), 1.0)
    return dataclasses.replace(state, mixer=MixerState(phase=new_phase))


class StreamSupervisor:
    """Wraps a streaming run of `rx.step` with detection and recovery.

    Usage:
        sup = StreamSupervisor(rx, params, checkpoint_path="chain.npz",
                               checkpoint_every=50)
        for seq, blk in source:               # seq = producer sequence number
            state = sup.observe(state, seq)   # resync if seq gapped
            state, out = rx.step(state, params, blk)
            sup.block_done(state)             # periodic checkpoint

    After a crash: `state, meta = sup.restore(rx.init_state())` resumes
    from the last snapshot; `meta["seq"]` says which producer block comes
    next.
    """

    def __init__(self, rx, params, checkpoint_path: str | None = None,
                 checkpoint_every: int = 50,
                 monitor: HealthMonitor | None = None):
        self.rx = rx
        self.params = params
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.monitor = monitor or HealthMonitor(
            sample_rate=rx.cfg.sample_rate,
            frames_per_buffer=rx.cfg.frames_per_buffer)
        self.events: list[RecoveryEvent] = []
        self._expected_seq: int | None = None
        self._blocks = 0

    # ------------------------------------------------------------- pre-step
    def observe(self, state, seq: int | None = None):
        """Call BEFORE stepping block `seq`: if the producer sequence
        gapped, resync the carry state across the missing samples."""
        if (seq is not None and self._expected_seq is not None
                and seq > self._expected_seq):
            gap_blocks = seq - self._expected_seq
            gap_samples = gap_blocks * self.rx.cfg.frames_per_buffer
            state = resync_state(self.rx, state, self.params, gap_samples)
            self.monitor.dropped_blocks += gap_blocks
            self.events.append(RecoveryEvent(
                kind="gap", block=self._blocks,
                detail={"gap_blocks": gap_blocks,
                        "gap_samples": gap_samples, "seq": seq}))
        if seq is not None:
            self._expected_seq = seq + 1
        return state

    # ------------------------------------------------------------ post-step
    def block_done(self, state, feeder_overruns: int = 0) -> None:
        """Call AFTER each processed block: health accounting and the
        periodic checkpoint."""
        self._blocks += 1
        self.monitor.block_done(feeder_overruns=feeder_overruns)
        if (self.checkpoint_path and self.checkpoint_every
                and self._blocks % self.checkpoint_every == 0):
            ckpt.save_state(self.checkpoint_path, state,
                            extra={"seq": self._expected_seq,
                                   "blocks": self._blocks})
            self.events.append(RecoveryEvent(
                kind="checkpoint", block=self._blocks,
                detail={"path": self.checkpoint_path}))

    # -------------------------------------------------------------- restore
    def restore(self, template):
        """Load the last checkpoint into `template`'s structure.  Returns
        (state, meta) and re-arms the supervisor's sequence and block
        counters."""
        state, meta = ckpt.load_state(self.checkpoint_path, template)
        self._expected_seq = meta.get("seq")
        self._blocks = int(meta.get("blocks", 0))
        self.events.append(RecoveryEvent(
            kind="restore", block=self._blocks,
            detail={"path": self.checkpoint_path, "seq": self._expected_seq}))
        return state, meta

    def report(self) -> dict:
        rep = self.monitor.report()
        rep["events"] = [
            {"kind": e.kind, "block": e.block, **e.detail}
            for e in self.events]
        return rep
