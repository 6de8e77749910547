"""Terminal thin client: spectrum panel, waterfall rows, S-meter bar.

The presentation analog of the reference's Qt widgets — SpectrumWidget's
spectrum/waterfall modes (application/spectrumwidget.h:18-90), SMeterWidget +
BargraphMeter (application/smeterwidget.*, bargraphmeter.*) — rendered
headlessly as ANSI-256 text from the chain's exported display products
(`out["spectrum"]`/`out["zoomed"]` dB rows and `out["smeter"]`).  The
FFT->pixel reduction itself is `ops.spectrum.map_to_screen`
(signalspectrum.cpp:137-168 capability); this module only turns mapped rows
into strings, so it works over ssh, in CI logs, and in notebooks.

Port of pebblesdr_tpu/serve/display.py: the rows are numpy arrays or torch
tensors on any device; map_to_screen reduces a row to pixels on its device
and only the pixels are fetched.
"""

from __future__ import annotations

import numpy as np

import torch

from pebblesdr_tpu_torch.core import db as dbu
from pebblesdr_tpu_torch.ops.spectrum import map_to_screen

# xterm-256 heat ramp: black -> deep blue -> cyan -> green -> yellow ->
# red -> white (the classic waterfall palette)
_HEAT = (16, 17, 18, 19, 20, 21, 27, 33, 39, 45, 51, 50, 49, 48, 47, 46,
         82, 118, 154, 190, 226, 220, 214, 208, 202, 196, 203, 210, 217,
         224, 231)
_RESET = "\x1b[0m"
# eighth-block characters for sub-row resolution in the spectrum panel
_BLOCKS = " ▁▂▃▄▅▆▇█"


def _norm(db_row: np.ndarray, db_min: float, db_max: float) -> np.ndarray:
    return np.clip((np.asarray(db_row, np.float64) - db_min)
                   / max(db_max - db_min, 1e-9), 0.0, 1.0)


def pick_width(n_bins: int, max_width: int = 128) -> int:
    """Largest pixel count <= max_width that divides the bin count evenly
    (map_to_screen requires bins % pixels == 0)."""
    for w in range(min(max_width, n_bins), 0, -1):
        if n_bins % w == 0:
            return w
    return 1


def waterfall_row(db_row, db_min: float = -130.0, db_max: float = -20.0,
                  color: bool = True) -> str:
    """One waterfall scanline: a background-colored space per pixel (the
    waterfall mode of SpectrumWidget, newest line at the bottom)."""
    v = _norm(db_row, db_min, db_max)
    idx = (v * (len(_HEAT) - 1)).round().astype(int)
    if not color:
        ramp = " .:-=+*#%@"
        return "".join(ramp[min(int(i * (len(ramp) - 1) / (len(_HEAT) - 1)),
                                len(ramp) - 1)] for i in idx)
    return "".join(f"\x1b[48;5;{_HEAT[i]}m " for i in idx) + _RESET


def spectrum_panel(db_row, height: int = 12, db_min: float = -130.0,
                   db_max: float = -20.0) -> list[str]:
    """Bar-graph spectrum (SpectrumWidget spectrum mode): one column per
    pixel, eighth-block vertical resolution, top row first."""
    v = _norm(db_row, db_min, db_max) * height * 8  # in eighth-rows
    rows = []
    for r in range(height, 0, -1):
        base = (r - 1) * 8
        cells = np.clip(v - base, 0, 8).astype(int)
        rows.append("".join(_BLOCKS[c] for c in cells))
    return rows


def smeter_bar(signal_db: float, snr_db: float | None = None,
               width: int = 24, db_min: float = -127.0,
               db_max: float = -13.0) -> str:
    """S-meter line: S-unit label (S0..S9, then dB over S9 — db.h S9=-73 dBm,
    6 dB/unit) + bar + raw dB (+ SNR), the SMeterWidget/BargraphMeter
    product."""
    s = float(dbu.db_to_s_units(signal_db))
    label = (f"S9+{int(round((s - 9.0) * dbu.DB_PER_S_UNIT)):02d}" if s > 9.0
             else f"S{max(int(s), 0)}   ")
    fill = int(np.clip((signal_db - db_min) / (db_max - db_min), 0, 1) * width)
    bar = "█" * fill + "░" * (width - fill)
    text = f"{label} {bar} {signal_db:6.1f} dB"
    if snr_db is not None:
        text += f"  SNR {snr_db:5.1f} dB"
    return text


def freq_axis(center_hz: float, span_hz: float, width: int,
              ticks: int = 5) -> str:
    """Frequency tick labels under a spectrum/waterfall of `width` pixels."""
    marks = np.linspace(center_hz - span_hz / 2, center_hz + span_hz / 2,
                        ticks)
    cell = max(width // (ticks - 1), 1) if ticks > 1 else width
    out = []
    for i, f in enumerate(marks):
        unit = ("GHz", 1e9) if abs(f) >= 1e9 else \
               ("MHz", 1e6) if abs(f) >= 1e6 else ("kHz", 1e3)
        lbl = f"{f / unit[1]:.6g}{unit[0]}"
        out.append(lbl.center(cell) if i < ticks - 1 else lbl)
    return "".join(out)[:width + 16]


class TerminalDisplay:
    """Stateful frame renderer for the CLI: `frame(...)` returns the text to
    print for one update (a waterfall scanline, or a redrawn spectrum panel
    with an S-meter footer)."""

    def __init__(self, mode: str = "waterfall", width: int = 96,
                 height: int = 12, db_min: float = -130.0,
                 db_max: float = -20.0, color: bool = True):
        if mode not in ("waterfall", "spectrum"):
            raise ValueError(f"display mode {mode!r}")
        self.mode, self.width, self.height = mode, width, height
        self.db_min, self.db_max, self.color = db_min, db_max, color
        self._first = True

    def frame(self, spectrum_db: np.ndarray, smeter: dict | None = None,
              center_hz: float = 0.0, span_hz: float = 0.0) -> str:
        row = torch.as_tensor(spectrum_db, dtype=torch.float32).reshape(1, -1)
        w = pick_width(row.shape[-1], self.width)
        px = map_to_screen(row, w)[0].cpu().numpy()
        sm = ""
        if smeter is not None:
            sm = smeter_bar(float(smeter.get("signal_db", -120.0)),
                            float(smeter["snr_db"])
                            if "snr_db" in smeter else None)
        if self.mode == "waterfall":
            line = waterfall_row(px, self.db_min, self.db_max, self.color)
            if sm:
                line += "  " + sm
            if self._first and span_hz:
                self._first = False
                return freq_axis(center_hz, span_hz, w) + "\n" + line
            return line
        rows = spectrum_panel(px, self.height, self.db_min, self.db_max)
        parts = rows + ([freq_axis(center_hz, span_hz, w)] if span_hz else [])
        if sm:
            parts.append(sm)
        # repaint in place after the first frame
        prefix = "" if self._first else f"\x1b[{len(parts)}F\x1b[J"
        self._first = False
        return prefix + "\n".join(parts)
