"""Stream health monitoring and structured metrics.

Port of pebblesdr_tpu/utils/health.py (host code, the standard library
only).  The reference's only health surface is Key_DeviceHealthValue and producer
overrun counters (device_interfaces.h:89-90, signalspectrum.cpp:73-77).
Here: a HealthMonitor that tracks block cadence, overruns and the
real-time factor, and flags dropped-block and falling-behind conditions,
and a Metrics aggregator exporting per-host structured metrics (samples/s,
real-time factor, per-stage ms, SNR).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque


@dataclasses.dataclass
class HealthMonitor:
    sample_rate: float
    frames_per_buffer: int
    window: int = 50                       # blocks in the rolling window
    blocks: int = 0
    dropped_blocks: int = 0
    overruns: int = 0
    _times: deque = dataclasses.field(default_factory=lambda: deque(maxlen=51))
    _last_seq: int | None = None

    def block_done(self, seq: int | None = None,
                   feeder_overruns: int = 0) -> None:
        """Call once per processed block; seq = producer sequence number if
        available (gaps => dropped blocks)."""
        self.blocks += 1
        self._times.append(time.monotonic())
        if (seq is not None and self._last_seq is not None
                and seq > self._last_seq + 1):
            self.dropped_blocks += seq - self._last_seq - 1
        self._last_seq = seq
        self.overruns = feeder_overruns

    @property
    def realtime_factor(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        processed = (len(self._times) - 1) * self.frames_per_buffer
        return processed / self.sample_rate / max(span, 1e-9)

    @property
    def healthy(self) -> bool:
        return self.realtime_factor >= 1.0 and self.dropped_blocks == 0

    def report(self) -> dict:
        return {
            "blocks": self.blocks,
            "dropped_blocks": self.dropped_blocks,
            "feeder_overruns": self.overruns,
            "realtime_factor": round(self.realtime_factor, 3),
            "healthy": self.healthy,
        }


class Metrics:
    """Structured metrics aggregator: counters + gauges + stage timings,
    exported as one JSON object per host."""

    def __init__(self, host_id: int = 0):
        self.host_id = host_id
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self._t0 = time.monotonic()

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def export(self, perform=None) -> dict:
        """The metrics as a dict; with `perform` (utils/perform.py Perform)
        its stage timings under "stages_ms"."""
        out = {
            "host": self.host_id,
            "uptime_s": round(time.monotonic() - self._t0, 1),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
        }
        if perform is not None:
            out["stages_ms"] = perform.report()
        return out

    def export_json(self, perform=None) -> str:
        return json.dumps(self.export(perform))
