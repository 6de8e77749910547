"""CW (Morse) decoder: Goertzel-OOK tone detection and adaptive-WPM timing
decode (port of pebblesdr_tpu/modem/morse.py).

MorseModem is the device half: frame powers (one complex matmul,
ops/goertzel.py goertzel_power) and the OOK decisions (ook_detect: on a
card one launch of csrc/recur.cu ook_scan, K6) on the demod-rate stream;
or the matched detector (an NCO mix to baseband, a decimating low-pass,
then the same detector).  MorseDecoder is the host half, a copy: mark and
space run lengths to dots, dashes and characters, tracking the WPM.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pebblesdr_tpu_torch.modem.morse_code import MORSE_TO_CHAR
from pebblesdr_tpu_torch.ops import fir, goertzel


class MorseModem:
    """Device side: complex demod-rate input [C, N] -> marks [C, F] bool.

    frame (the Goertzel integration length) defaults to the reference's
    estimation rules (goertzel.h:103-104): no longer than 1/4 of the dot at
    the hinted WPM and, with bandwidth_hz, no shorter than the bin width
    that bandwidth asks for.  threshold_mode selects the OOK decision
    (ops/goertzel.py OOKConfig); detector "goertzel" (the tone's bin and
    its two compare bins) or "matched" (morse.cpp:775-806: mix the tone to
    baseband, a matched-bandwidth low-pass, one envelope a frame)."""

    def __init__(self, sample_rate: float, tone_hz: float = 1000.0,
                 frame: int | None = None, wpm_hint: float = 20.0,
                 bandwidth_hz: float | None = None,
                 threshold_mode: str = "peak", detector: str = "goertzel",
                 **ook_kwargs):
        if frame is None:
            dot_ms = 1.2 / wpm_hint * 1e3
            frame = max(8, goertzel.choose_n(
                sample_rate, ms_shortest_bit=dot_ms / 4,
                bandwidth_hz=bandwidth_hz))
        self.frame = int(frame)
        self.frame_rate = sample_rate / self.frame
        self.sample_rate = sample_rate
        self.tone_hz = tone_hz
        if detector not in ("goertzel", "matched"):
            raise ValueError(detector)
        self.detector = detector
        lo, hi = goertzel.compare_bin_freqs(tone_hz, self.frame, sample_rate,
                                            delta_frac=1.0)
        self.basis = goertzel.dft_vectors([tone_hz, lo, hi], sample_rate,
                                          self.frame)
        if detector == "matched":
            # cutoff half the frame rate, taps spanning ~2 frames (fldigi's
            # cw_FIR_filter sinc)
            self.mf_taps = fir.design_lowpass_kaiser(
                self.frame_rate / 2.0, sample_rate, atten_db=40.0,
                transition_hz=self.frame_rate / 2.0,
                max_taps=2 * self.frame + 1).astype(np.float32)
        self.ook_cfg = goertzel.OOKConfig.make(mode=threshold_mode,
                                               **ook_kwargs)

    def init_state(self, channels: int, device="cuda"):
        ook = goertzel.ook_init(channels, device)
        if self.detector == "matched":
            t = len(self.mf_taps)
            return (ook,
                    torch.zeros(channels, dtype=torch.float32,
                                device=device),              # NCO phase
                    torch.zeros(2 * channels, t - 1, dtype=torch.float32,
                                device=device))              # FIR tail
        return ook

    def detect(self, state, x: torch.Tensor):
        """x: [C, N] complex64 (N divisible by frame) -> (state', marks
        [C, F] bool)."""
        if self.detector == "matched":
            return self._matched(state, x)
        frames = goertzel.frame_stream(x, self.frame)
        p = goertzel.goertzel_power(frames, self.basis)
        return goertzel.ook_detect(self.ook_cfg, state, p[:, :, 0],
                                   p[:, :, 1], p[:, :, 2])

    def _matched(self, state, x: torch.Tensor):
        ook, phase0, tail = state
        c, n = x.shape
        # NCO mix to baseband (the carried phase keeps block continuity)
        f0 = np.float32(self.tone_hz / self.sample_rate)
        k = torch.arange(n, dtype=torch.float32, device=x.device)
        ramp = torch.remainder(phase0[:, None] + k[None, :] * f0, 1.0)
        theta = np.float32(-2.0 * np.pi) * ramp
        y = x * torch.complex(torch.cos(theta), torch.sin(theta))
        phase1 = torch.remainder(phase0 + np.float32(n) * f0, 1.0)
        # the matched-bandwidth low-pass, one result per frame, on the
        # stacked re / im rails
        out, tail2 = fir.fir_apply_real_signal(
            torch.cat([y.real, y.imag]), tail, self.mf_taps,
            decim=self.frame)
        p = out[:c] ** 2 + out[c:] ** 2                       # [C, F]
        # no compare bins: they read as zero powers
        ook2, marks = goertzel.ook_detect(self.ook_cfg, ook, p)
        return (ook2, phase1, tail2), marks


@dataclasses.dataclass
class MorseDecoder:
    """Host side: mark/space run lengths -> characters, adaptive WPM.

    frames_per_unit tracks the dot length in frames (an EWMA over the
    classified dots and dashes, morse.h:86-178)."""

    frame_rate: float
    wpm: float = 20.0
    _symbol: str = ""
    _text: str = ""
    _run_state: bool = False
    _run_len: int = 0

    def __post_init__(self):
        self.frames_per_unit = 1.2 / self.wpm * self.frame_rate

    @property
    def tracked_wpm(self) -> float:
        return 1.2 * self.frame_rate / self.frames_per_unit

    def feed(self, marks: np.ndarray) -> str:
        """marks: [F] bool frames.  Returns the newly decoded text."""
        out = []
        for m in np.asarray(marks).astype(bool):
            if m == self._run_state:
                self._run_len += 1
                # a very long space: flush the pending word boundary
                if (not m) and self._run_len == int(7 * self.frames_per_unit):
                    out.append(self._finish_char(word_gap=True))
            else:
                out.append(self._end_run())
                self._run_state = bool(m)
                self._run_len = 1
        new = "".join(s for s in out if s)
        self._text += new
        return new

    def _end_run(self) -> str:
        u = self.frames_per_unit
        n = self._run_len
        if self._run_len == 0:
            return ""
        if self._run_state:  # a mark ended: dot or dash
            if n < 2.0 * u:
                self._symbol += "."
                self.frames_per_unit += 0.1 * (n - self.frames_per_unit)
            else:
                self._symbol += "-"
                self.frames_per_unit += 0.1 * (n / 3.0 - self.frames_per_unit)
            return ""
        # a space ended
        if n < 2.0 * u:
            return ""  # intra-character gap
        if n < 5.0 * u:
            return self._finish_char()
        return self._finish_char(word_gap=True)

    def _finish_char(self, word_gap: bool = False) -> str:
        ch = MORSE_TO_CHAR.get(self._symbol, "" if not self._symbol else "?")
        self._symbol = ""
        if word_gap and ch:
            return ch + " "
        if word_gap:
            return ""
        return ch

    def flush(self) -> str:
        s = self._end_run()
        s += self._finish_char()
        self._run_len = 0
        self._text += s
        return s

    @property
    def text(self) -> str:
        return self._text
