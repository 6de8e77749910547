"""WWV/WWVH time-code decoder: 100 Hz subcarrier pulse-width demodulation
(port of pebblesdr_tpu/modem/wwv.py).

WWV sends one pulse-width-modulated bit of 100 Hz subcarrier a second
(170 ms = 0, 470 ms = 1, 770 ms = a position marker; no pulse at :00) in
the published NIST layout (NIST SP 432), WWV_LAYOUT below, which the
encoder and the decoder both read.  WwvModem is the device half: the
100 Hz power of every 10 ms frame as one complex matmul (ops/goertzel.py
goertzel_power); WwvDecoder (pulse widths, marker alignment, BCD fields),
WwvFrame and the encoders are host copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import goertzel

FRAME_MS = 10.0

# --------------------------------------------------------------- the standard
#
# second-of-minute -> what that second carries:
#   "minute"      no 100 Hz pulse (1000 Hz minute tone, start of frame)
#   "M"           position marker (770 ms pulse)
#   0             unused, always binary 0
#   (field, w)    BCD data bit: adds `w` to `field` when the bit is 1
#
# Fields: minutes (0-59), hours (0-23), day_of_year (1-366), year_units +
# year_tens (2-digit year of century), dst1 (DST in effect at 00:00Z),
# dst2 (DST at 24:00Z), leap (leap-second warning), dut1_sign (1 = UT1
# ahead of UTC), dut1_mag (|UT1-UTC| in 0.1 s units, 0-7).
WWV_LAYOUT: dict[int, object] = {
    0: "minute",
    1: 0,
    2: ("dst1", 1),
    3: ("leap", 1),
    4: ("year_units", 1), 5: ("year_units", 2),
    6: ("year_units", 4), 7: ("year_units", 8),
    8: 0,
    9: "M",
    10: ("minutes", 1), 11: ("minutes", 2),
    12: ("minutes", 4), 13: ("minutes", 8),
    14: 0,
    15: ("minutes", 10), 16: ("minutes", 20), 17: ("minutes", 40),
    18: 0,
    19: "M",
    20: ("hours", 1), 21: ("hours", 2), 22: ("hours", 4), 23: ("hours", 8),
    24: 0,
    25: ("hours", 10), 26: ("hours", 20),
    27: 0, 28: 0,
    29: "M",
    30: ("day_of_year", 1), 31: ("day_of_year", 2),
    32: ("day_of_year", 4), 33: ("day_of_year", 8),
    34: 0,
    35: ("day_of_year", 10), 36: ("day_of_year", 20),
    37: ("day_of_year", 40), 38: ("day_of_year", 80),
    39: "M",
    40: ("day_of_year", 100), 41: ("day_of_year", 200),
    42: 0, 43: 0, 44: 0, 45: 0, 46: 0, 47: 0, 48: 0,
    49: "M",
    50: ("dut1_sign", 1),
    51: ("year_tens", 10), 52: ("year_tens", 20),
    53: ("year_tens", 40), 54: ("year_tens", 80),
    55: ("dst2", 1),
    56: ("dut1_mag", 1), 57: ("dut1_mag", 2), 58: ("dut1_mag", 4),
    59: "M",
}
assert sorted(WWV_LAYOUT) == list(range(60))

MARKER_SECONDS = tuple(s for s, v in WWV_LAYOUT.items() if v == "M")
ZERO_SECONDS = tuple(s for s, v in WWV_LAYOUT.items() if v == 0)

# pulse widths (ms) — tone on from 30 ms after the second tick
PULSE_MS = {0: 170, 1: 470, "M": 770}


@dataclasses.dataclass
class WwvFrame:
    """One decoded (or to-be-encoded) WWV minute."""
    minutes: int = 0
    hours: int = 0
    day_of_year: int = 1
    year: int = 0            # 2-digit year of century (00-99)
    dst1: bool = False       # DST in effect at 00:00Z today
    dst2: bool = False       # DST in effect at 24:00Z today
    leap: bool = False       # leap second at end of month
    dut1: float = 0.0        # UT1-UTC, signed, 0.1 s resolution, |.|<=0.7

    def field_bits(self) -> dict[int, int]:
        """Expand this frame into {second: bit} per WWV_LAYOUT."""
        vals = {
            "minutes": self.minutes,
            "hours": self.hours,
            "day_of_year": self.day_of_year,
            "year_units": self.year % 10,
            "year_tens": self.year - self.year % 10,
            "dst1": int(self.dst1),
            "dst2": int(self.dst2),
            "leap": int(self.leap),
            "dut1_sign": int(self.dut1 >= 0),
            "dut1_mag": int(round(abs(self.dut1) * 10.0)),
        }
        bits: dict[int, int] = {}
        # BCD digit-weight decomposition: each field value is the sum of the
        # weights whose bit is set, taken digit by digit (largest first)
        for field in set(v[0] for v in WWV_LAYOUT.values()
                         if isinstance(v, tuple)):
            remaining = vals[field]
            for sec, w in sorted(((s, v[1]) for s, v in WWV_LAYOUT.items()
                                  if isinstance(v, tuple) and v[0] == field),
                                 key=lambda t: -t[1]):
                bits[sec] = 1 if remaining >= w else 0
                if bits[sec]:
                    remaining -= w
        return bits

    def symbols(self) -> list:
        """The 60 per-second symbols for this minute: None (minute mark,
        no 100 Hz pulse), 'M', 0, or 1."""
        bits = self.field_bits()
        out: list = []
        for s in range(60):
            v = WWV_LAYOUT[s]
            if v == "minute":
                out.append(None)
            elif v == "M":
                out.append("M")
            elif v == 0:
                out.append(0)
            else:
                out.append(bits[s])
        return out


class WwvModem:
    """[C, N] real or complex audio (after the AM demod) -> 100 Hz power
    per 10 ms frame.  The 10 ms frame puts 100 Hz exactly on DFT bin 1 and
    the 1000 / 1200 Hz tick and minute tones on integer bins: no leakage
    into the subcarrier."""

    def __init__(self, sample_rate: float):
        self.sample_rate = sample_rate
        self.frame = int(round(sample_rate * FRAME_MS / 1000.0))
        self.basis = goertzel.dft_vectors([100.0], sample_rate, self.frame)

    def detect(self, x: torch.Tensor) -> torch.Tensor:
        """-> [C, F] 100 Hz power per 10 ms frame."""
        frames = goertzel.frame_stream(x, self.frame)
        return goertzel.goertzel_power(frames, self.basis)[:, :, 0]


@dataclasses.dataclass
class WwvDecoder:
    """100 Hz power frames -> pulses -> marker-aligned frame -> field decode.

    Feed 10 ms power frames (WwvModem.detect output); once a full minute
    with a valid marker pattern is seen, `frame` holds the decoded WwvFrame
    and the convenience fields (minutes/hours/day_of_year/...) are set.
    """

    threshold: float = 0.5   # fraction of tracked pulse peak
    _powers: list = dataclasses.field(default_factory=list)
    frame: WwvFrame | None = None
    # convenience mirrors of the last decoded frame
    minutes: int | None = None
    hours: int | None = None
    day_of_year: int | None = None
    year: int | None = None
    dut1: float | None = None

    SEC_FRAMES = 100  # 10 ms power frames per second

    def feed(self, powers: np.ndarray) -> None:
        """powers: [F] 100 Hz power per 10 ms frame."""
        self._powers.extend(np.asarray(powers).ravel().tolist())
        self._try_decode()

    # ------------------------------------------------------------- internals

    def _extract_pulses(self) -> list[tuple[int, object]]:
        """-> [(start_frame, symbol)] for complete pulses in the buffer."""
        p = np.asarray(self._powers)
        if len(p) < 3 * self.SEC_FRAMES:
            return []
        peak = np.percentile(p, 90)
        if peak <= 0:
            return []
        on = p > self.threshold * peak
        pulses: list[tuple[int, object]] = []
        i = 0
        while i < len(on):
            while i < len(on) and not on[i]:
                i += 1
            start = i
            while i < len(on) and on[i]:
                i += 1
            if i >= len(on):
                break  # pulse may continue into the next block
            width_ms = (i - start) * FRAME_MS
            if width_ms < 60:
                continue  # glitch (or a 1000 Hz tick leaking — it can't)
            if width_ms < 320:
                sym = 0
            elif width_ms < 620:
                sym = 1
            else:
                sym = "M"
            pulses.append((start, sym))
        return pulses

    def _second_grid(self, pulses) -> tuple[int, list]:
        """Snap pulses onto a 1 s grid.  Returns (first_second_start_frame,
        symbols list indexed by grid second; None = no pulse that second)."""
        if not pulses:
            return 0, []
        sf = self.SEC_FRAMES
        first = pulses[0][0]
        last = pulses[-1][0]
        n_sec = (last - first) // sf + 1
        syms: list = [None] * (n_sec + 1)
        for start, sym in pulses:
            idx = int(round((start - first) / sf))
            if 0 <= idx < len(syms) and abs((start - first) - idx * sf) <= 3:
                syms[idx] = sym
        return first, syms

    def _try_decode(self) -> None:
        pulses = self._extract_pulses()
        first, syms = self._second_grid(pulses)
        # Slide a 60 s window over the grid; a window aligned on the minute
        # start must show: no pulse at :00, markers at every MARKER_SECONDS,
        # binary 0 at every ZERO_SECONDS, and 0/1 data everywhere else.
        for t in range(len(syms) - 59):
            win = syms[t:t + 60]
            if win[0] is not None:
                continue
            if any(win[s] != "M" for s in MARKER_SECONDS):
                continue
            if any(win[s] != 0 for s in ZERO_SECONDS):
                continue
            data_secs = [s for s, v in WWV_LAYOUT.items()
                         if isinstance(v, tuple)]
            if any(win[s] not in (0, 1) for s in data_secs):
                continue
            vals: dict[str, int] = {}
            for s in data_secs:
                field, w = WWV_LAYOUT[s]
                vals[field] = vals.get(field, 0) + w * win[s]
            minutes = vals.get("minutes", 0)
            hours = vals.get("hours", 0)
            doy = vals.get("day_of_year", 0)
            if not (minutes < 60 and hours < 24 and 1 <= doy <= 366):
                continue
            fr = WwvFrame(
                minutes=minutes, hours=hours, day_of_year=doy,
                year=vals.get("year_tens", 0) + vals.get("year_units", 0),
                dst1=bool(vals.get("dst1", 0)), dst2=bool(vals.get("dst2", 0)),
                leap=bool(vals.get("leap", 0)),
                dut1=(1.0 if vals.get("dut1_sign", 0) else -1.0)
                * 0.1 * vals.get("dut1_mag", 0))
            self.frame = fr
            self.minutes, self.hours = fr.minutes, fr.hours
            self.day_of_year, self.year = fr.day_of_year, fr.year
            self.dut1 = fr.dut1
            # drop everything up to the end of the decoded minute
            consumed_frames = min(first + (t + 60) * self.SEC_FRAMES,
                                  len(self._powers))
            del self._powers[:consumed_frames]
            return


def encode_wwv_frame(frame: WwvFrame, sample_rate: float,
                     seconds: int | None = None, start_second: int = 0,
                     amplitude: float = 1.0, ticks: bool = True,
                     corrupt_marker: int | None = None) -> np.ndarray:
    """Standard-derived fixture: WWV-format audio carrying `frame`.

    Generates the per-second 100 Hz pulse sequence straight from WWV_LAYOUT
    (tone on 30 ms after the second, PULSE_MS widths), plus — when `ticks` —
    the 5 ms 1000 Hz second ticks and the 800 ms 1000 Hz minute tone at :00,
    so the fixture carries the same co-channel tones a real receiver sees.
    The minute repeats with its `minutes` field advancing.

    start_second: begin mid-minute (the decoder must self-align).
    corrupt_marker: if set, that second-of-minute's symbol is replaced by a
    binary 0 in EVERY transmitted minute (negative-test hook: a decoder that
    ignores the marker pattern would still "decode").
    """
    if seconds is None:
        seconds = 130
    n_per_sec = int(sample_rate)
    t = np.arange(n_per_sec) / sample_rate
    sub = np.sin(2 * np.pi * 100.0 * t).astype(np.float32)
    tick = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    out = np.zeros(seconds * n_per_sec, np.float32)
    minute = 0
    for k in range(seconds):
        sec_of_min = (start_second + k) % 60
        if sec_of_min == 0 and k > 0:
            minute += 1
        fr = dataclasses.replace(frame,
                                 minutes=(frame.minutes + minute) % 60)
        sym = fr.symbols()[sec_of_min]
        if corrupt_marker is not None and sec_of_min == corrupt_marker:
            sym = 0
        seg = out[k * n_per_sec:(k + 1) * n_per_sec]
        if sym is not None:
            on0 = int(0.030 * sample_rate)
            n_on = int(PULSE_MS[sym] / 1000.0 * sample_rate)
            seg[on0:on0 + n_on] = amplitude * sub[on0:on0 + n_on]
        if ticks:
            if sym is None:  # minute mark: 800 ms 1000 Hz tone
                seg[:int(0.8 * sample_rate)] += amplitude * tick[:int(0.8 * sample_rate)]
            else:            # 5 ms second tick
                seg[:int(0.005 * sample_rate)] += amplitude * tick[:int(0.005 * sample_rate)]
    return out


def encode_wwv(minutes: int, hours: int, sample_rate: float,
               seconds: int = 130, amplitude: float = 1.0) -> np.ndarray:
    """Back-compat wrapper: encode a frame carrying (minutes, hours)."""
    return encode_wwv_frame(WwvFrame(minutes=minutes, hours=hours),
                            sample_rate, seconds=seconds, amplitude=amplitude)
