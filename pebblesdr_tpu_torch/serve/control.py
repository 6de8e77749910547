"""Interactive runtime control: live retune/mode/filter/AGC/squelch keys.

The control capability of ReceiverWidget (application/receiverwidget.h:28-140
— frequency up/down, mode/filter/AGC selectors, squelch/gain sliders changed
while the chain runs) and SpectrumWidget's mouse tuning
(spectrumwidget.h:18-90), driven from the terminal instead of Qt.

Port of pebblesdr_tpu/serve/control.py on the port's Receiver.  Tuning
frequency, bandpass mask, squelch, gain and mute are RxParams *inputs* of
the step: changing them is a params update, tensors on the receiver's
device (Receiver.retune/set_bandpass), and the same Receiver keeps running.
Only a demod-mode or AGC-mode switch rebuilds the Receiver, on the same
device, exactly like the reference tearing down and rebuilding its demod
object (receiver.cpp setDemodMode capability).

Key map (also printed by `--display ... --keys help`):
  Left/Right      tune down/up by the current step
  Up/Down         tune step x10 / /10 (1 Hz .. 1 MHz)
  m / M           next / previous demod mode      (chain rebuild)
  a               cycle AGC off/fast/med/slow/long (chain rebuild)
  [ / ]           narrow / widen the bandpass (params-only mask redesign)
  s / S           squelch threshold +3 / -3 dB
  g / G           audio gain +3 / -3 dB
  space           mute toggle
  p               snap-tune to the strongest wideband spectrum peak
  n / N           next / previous preset station (--presets csv|db)
  z               cycle display source wide / zoom / split
  q               quit
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver
from pebblesdr_tpu_torch.demod.modes import DemodMode, from_string

# cycling order for the 'm' key (the receiverwidget mode selector list)
MODE_CYCLE = [DemodMode.AM, DemodMode.SAM, DemodMode.USB, DemodMode.LSB,
              DemodMode.CWU, DemodMode.CWL, DemodMode.DSB, DemodMode.FMN,
              DemodMode.FMM, DemodMode.FMS]
AGC_CYCLE = ["off", "fast", "med", "slow", "long"]

# escape sequences -> key tokens
_ESCAPES = {"\x1b[C": "right", "\x1b[D": "left",
            "\x1b[A": "up", "\x1b[B": "down"}


def parse_keys(data: str) -> list[str]:
    """Byte/char stream -> key tokens ('right', 'm', ' ', ...)."""
    out = []
    i = 0
    while i < len(data):
        matched = False
        for seq, name in _ESCAPES.items():
            if data.startswith(seq, i):
                out.append(name)
                i += len(seq)
                matched = True
                break
        if not matched:
            out.append(data[i])
            i += 1
    return out


class ScriptedKeys:
    """Key source for tests/demos: a fixed token string, N keys per poll."""

    def __init__(self, text: str, per_poll: int = 1):
        self._keys = parse_keys(text)
        self.per_poll = per_poll

    def poll(self) -> list[str]:
        take, self._keys = (self._keys[:self.per_poll],
                            self._keys[self.per_poll:])
        return take


class TtyKeys:
    """Nonblocking key source from a real terminal (cbreak mode + select)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdin
        self._saved = None

    def __enter__(self):
        import termios
        import tty

        self._fd = self.stream.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        import termios

        if self._saved is not None:
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self) -> list[str]:
        import select

        data = ""
        while select.select([self.stream], [], [], 0)[0]:
            ch = self.stream.read(1)
            if not ch:      # end of input: readable forever, nothing read
                break
            data += ch
        return parse_keys(data)


class ControlSurface:
    """Owns the live Receiver + RxParams and applies key events to them.

    params-only events (retune, bandpass, squelch, gain, mute) mutate
    `self.params` — the caller keeps stepping the same Receiver.
    Chain-swap events (mode, AGC) rebuild `self.rx` on its device and set
    the reset flag — the caller re-inits chain state (a mode change resets
    the demod pipeline in the reference too)."""

    def __init__(self, rx: Receiver, params, tune_hz: float,
                 squelch_db: float | None = None, gain: float = 1.0,
                 source=None, center_hz: float = 0.0,
                 iq_static: tuple[float, float] | None = None,
                 bandpass: tuple[float, float] | None = None,
                 presets=None):
        self.rx = rx
        self.params = params
        self.tune = float(tune_hz)
        # device-LO handoff (receiver.cpp:604-637 capability): when arrow
        # tuning pushes the mixer offset past ~45% of the capture width and
        # the source can retune its hardware LO (set_center_freq), shift
        # the LO and re-center the mixer — continuous tuning across the
        # whole band instead of clipping at the capture edge
        self.source = source if (source is not None
                                 and hasattr(source, "set_center_freq")) \
            else None
        self.center_hz = float(center_hz)
        self.step = 1000.0
        self.mode = rx.cfg.mode
        self.agc = rx.cfg.agc_mode or rx.info.agc_mode
        self.squelch_db = squelch_db
        self.gain = gain
        self.mute = False
        # startup static overrides (CLI --iq-balance / --bandpass) survive
        # mode/AGC rebuilds — default_params would silently drop them
        # (advisor r4)
        self.iq_static = iq_static
        self.cli_bandpass = bandpass
        self.display = "wide"   # 'z' cycles wide -> zoom -> split
        self.bp_lo = bandpass[0] if bandpass else rx.info.lo_cut
        self.bp_hi = bandpass[1] if bandpass else rx.info.hi_cut
        self._last_spectrum: np.ndarray | None = None  # latest wide dB row
        # preset stations for 'n'/'N' stepping (utils.settings.Preset list;
        # the ReceiverWidget frequency/preset selector analog), kept sorted
        # by absolute frequency
        self.presets = sorted(presets, key=lambda p: p.freq_hz) \
            if presets else None
        self.quit = False
        self._reset = False
        self.events: list[str] = []

    def take_reset(self) -> bool:
        r, self._reset = self._reset, False
        return r

    def apply_levels(self):
        """Push the surface's squelch/gain/mute into params (call once after
        construction if the CLI pre-set them)."""
        self._apply_levels()

    def note_spectrum(self, db_row) -> None:
        """Stash the latest device-rate spectrum row (channel 0, dB over
        [-fs/2, fs/2) about the capture center) for the 'p' peak-snap key.
        The CLI loop calls this once per dispatch with the one row, sliced
        on the device and fetched (a tensor row is fetched here)."""
        if isinstance(db_row, torch.Tensor):
            db_row = db_row.detach().cpu().numpy()
        self._last_spectrum = np.asarray(db_row, np.float32).reshape(-1)

    # ------------------------------------------------------------- internals

    def _rebuild(self):
        cfg = dataclasses.replace(self.rx.cfg, mode=self.mode,
                                  agc_mode=self.agc)
        self.rx = Receiver(cfg, self.rx.device)
        self.params = self.rx.default_params(self.tune)
        if self.cli_bandpass is not None:
            # the explicit CLI bandpass outlives rebuilds; key-driven edits
            # reset to the new mode's default band
            self.bp_lo, self.bp_hi = self.cli_bandpass
            self.params = self.rx.set_bandpass(self.params, self.bp_lo,
                                               self.bp_hi)
        else:
            self.bp_lo = self.rx.info.lo_cut
            self.bp_hi = self.rx.info.hi_cut
        if self.iq_static is not None:
            g, ph = self.iq_static
            self.params = dataclasses.replace(
                self.params, iq_gain=self._scalar(g),
                iq_phase=self._scalar(ph))
        self._apply_levels()
        self._reset = True

    def _scalar(self, v, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype, device=self.rx.device)

    def _apply_levels(self):
        repl = {"gain": self._scalar(self.gain),
                "mute": self._scalar(self.mute, torch.bool)}
        if self.squelch_db is not None:
            repl["squelch_db"] = self._scalar(self.squelch_db)
        self.params = dataclasses.replace(self.params, **repl)

    def _set_tune(self, new_tune: float) -> str:
        """Shared retune policy for arrow and snap tuning: past ~45% of the
        capture width a hardware-retunable source takes the offset on its
        LO (receiver.cpp:604-637) and the mixer re-centers; otherwise the
        offset clips to the capture band."""
        self.tune = float(new_tune)
        fs = self.rx.cfg.sample_rate
        if self.source is not None and abs(self.tune) > 0.45 * fs:
            self.center_hz += self.tune
            self.source.set_center_freq(self.center_hz)
            self.tune = 0.0
            self.params = self.rx.retune(self.params, 0.0)
            return f"LO {self.center_hz / 1e6:.6f} MHz"
        self.tune = float(np.clip(self.tune, -fs / 2, fs / 2))
        self.params = self.rx.retune(self.params, self.tune)
        return f"TUNE {self.tune / 1e3:.3f} kHz"

    # ---------------------------------------------------------------- events

    def handle(self, key: str) -> str | None:
        """Apply one key token; returns a human-readable event (or None)."""
        ev = self._handle(key)
        if ev:
            self.events.append(ev)
        return ev

    def _handle(self, key: str) -> str | None:
        if key == "q":
            self.quit = True
            return "QUIT"
        if key in ("left", "right"):
            return self._set_tune(
                self.tune + (self.step if key == "right" else -self.step))
        if key in ("up", "down"):
            self.step = float(np.clip(
                self.step * (10.0 if key == "up" else 0.1), 1.0, 1e6))
            return f"STEP {self.step:g} Hz"
        if key in ("m", "M"):
            idx = (MODE_CYCLE.index(self.mode)
                   if self.mode in MODE_CYCLE else 0)
            idx = (idx + (1 if key == "m" else -1)) % len(MODE_CYCLE)
            self.mode = MODE_CYCLE[idx]
            self._rebuild()
            return f"MODE {self.mode.value}"
        if key == "a":
            idx = (AGC_CYCLE.index(self.agc)
                   if self.agc in AGC_CYCLE else 0)
            self.agc = AGC_CYCLE[(idx + 1) % len(AGC_CYCLE)]
            self._rebuild()
            return f"AGC {self.agc}"
        if key in ("[", "]"):
            f = 0.8 if key == "[" else 1.25
            # scale both cuts about their center (keeps CW offsets centered)
            mid = (self.bp_lo + self.bp_hi) / 2
            half = (self.bp_hi - self.bp_lo) / 2 * f
            half = float(np.clip(half, 50.0, self.rx.demod_rate / 2 - 100.0))
            self.bp_lo, self.bp_hi = mid - half, mid + half
            self.params = self.rx.set_bandpass(self.params, self.bp_lo,
                                               self.bp_hi)
            return f"BW {self.bp_hi - self.bp_lo:.0f} Hz"
        if key in ("s", "S"):
            cur = self.squelch_db if self.squelch_db is not None else -999.0
            if cur <= -999.0:
                cur = -10.0 if key == "s" else -999.0
            else:
                cur += 3.0 if key == "s" else -3.0
            self.squelch_db = float(np.clip(cur, -999.0, 60.0))
            self._apply_levels()
            return f"SQL {self.squelch_db:.0f} dB"
        if key in ("g", "G"):
            self.gain *= 10.0 ** (0.15 if key == "g" else -0.15)
            self.gain = float(np.clip(self.gain, 1e-3, 1e3))
            self._apply_levels()
            return f"GAIN {20 * np.log10(self.gain):+.1f} dB"
        if key == " ":
            self.mute = not self.mute
            self._apply_levels()
            return f"MUTE {'on' if self.mute else 'off'}"
        if key == "p":
            # snap-tune to the strongest peak of the latest device-rate
            # spectrum — the terminal analog of SpectrumWidget's mouse
            # click-to-tune (spectrumwidget.h:18-90).  The row spans
            # [-fs/2, fs/2) about the capture center; the current station's
            # own passband (plus a 2 kHz skirt) is masked so repeated 'p'
            # walks to the next station.
            if self._last_spectrum is None:
                return None
            db = np.asarray(self._last_spectrum, np.float32)
            fs = self.rx.cfg.sample_rate
            freqs = (np.arange(db.size) / db.size - 0.5) * fs
            own = ((freqs >= self.tune + self.bp_lo - 2e3)
                   & (freqs <= self.tune + self.bp_hi + 2e3))
            masked = np.where(own, -np.inf, db)
            if not np.isfinite(masked).any():
                return None  # the guard covers the whole capture (e.g. WFM
                #              on a narrow capture): nothing to snap to
            ev = self._set_tune(float(freqs[int(np.argmax(masked))]))
            return ev.replace("TUNE", "SNAP", 1) if ev else ev
        if key in ("n", "N") and self.presets:
            # preset-station stepping (the ReceiverWidget preset selector):
            # jump to the next/previous station by absolute frequency; the
            # device-LO handoff (via _set_tune) reaches stations outside
            # the current capture when the source is hardware-retunable.
            # A preset carrying a different mode swaps the chain like the
            # reference's preset recall does.
            cur = self.center_hz + self.tune
            if key == "n":
                cands = [p for p in self.presets if p.freq_hz > cur + 1.0]
                pre = cands[0] if cands else self.presets[0]   # wrap
            else:
                cands = [p for p in self.presets if p.freq_hz < cur - 1.0]
                pre = cands[-1] if cands else self.presets[-1]
            self._set_tune(pre.freq_hz - self.center_hz)
            try:
                pm = from_string(pre.mode) if pre.mode else None
            except ValueError:
                pm = None
            if pm is not None and pm != self.mode:
                self.mode = pm
                self._rebuild()
            return f"PRESET {pre.name} {pre.freq_hz / 1e6:.4f} MHz"
        if key == "z":
            # display-source cycle (spectrumwidget.h:18-90 zoom/split
            # capability, terminal form): wide (device-rate) -> zoom
            # (demod-rate) -> split (both panels)
            cyc = ("wide", "zoom", "split")
            self.display = cyc[(cyc.index(self.display) + 1) % len(cyc)]
            return f"DISPLAY {self.display}"
        return None
