"""Demodulation mode table: per-mode filter presets, AGC defaults, bandwidth.

A copy of pebblesdr_tpu/demod/modes.py (enum and dataclass only), so that the
port loads nothing of the JAX package; tests/test_torch_design.py holds the
two tables equal.  maxOutputBW drives the decimation target (~30 kHz for
narrowband modes, ~200 kHz for WFM).
"""

from __future__ import annotations

import dataclasses
import enum


class DemodMode(enum.Enum):
    AM = "AM"
    SAM = "SAM"
    FMN = "FMN"
    FMM = "FM-Mono"
    FMS = "FM-Stereo"
    DSB = "DSB"
    LSB = "LSB"
    USB = "USB"
    CWL = "CWL"
    CWU = "CWU"
    DIGL = "DIGL"
    DIGU = "DIGU"
    NONE = "NONE"


@dataclasses.dataclass(frozen=True)
class ModeInfo:
    mode: DemodMode
    filters: tuple[float, ...]      # selectable bandpass widths (Hz)
    default_filter: float
    lo_cut: float                   # default bandpass edges (Hz, rel. carrier)
    hi_cut: float
    max_output_bw: float            # decimation protect bandwidth
    agc_mode: str                   # default AGC preset
    cw_offset: float = 0.0


_NB_FILTERS = (16000.0, 12000.0, 8000.0, 6000.0, 4000.0)
_SSB_FILTERS = (4000.0, 3300.0, 2700.0, 2400.0, 1800.0)
_CW_FILTERS = (1800.0, 1200.0, 800.0, 400.0, 250.0, 100.0)

MODE_INFO: dict[DemodMode, ModeInfo] = {
    DemodMode.AM: ModeInfo(DemodMode.AM, _NB_FILTERS, 12000.0, -6000.0, 6000.0, 30000.0, "med"),
    DemodMode.SAM: ModeInfo(DemodMode.SAM, _NB_FILTERS, 12000.0, -6000.0, 6000.0, 30000.0, "med"),
    DemodMode.FMN: ModeInfo(DemodMode.FMN, (30000.0, 10000.0, 7000.0), 30000.0, -15000.0, 15000.0, 30000.0, "off"),
    # WFM default composite geometry: protect 200 kHz -> the decimator stops
    # at ~256 kHz, exactly the +-128 kHz Carson band of broadcast FM (75 kHz
    # deviation + 15 kHz audio) — the common SDR geometry, ~35 dB stereo
    # separation.  ReceiverConfig.wfm_hq=True doubles the protect bandwidth
    # so the composite runs >=400 kHz like the reference's WFM downconverter
    # (downconvert.cpp:220-240), restoring ~47.5 dB separation at ~1.5x the
    # chain cost.  The quality/cost trade-off is documented in
    # docs/configuration.md and PARITY.md (deviation 5).
    DemodMode.FMM: ModeInfo(DemodMode.FMM, (200000.0,), 200000.0, -100000.0, 100000.0, 200000.0, "off"),
    DemodMode.FMS: ModeInfo(DemodMode.FMS, (200000.0,), 200000.0, -100000.0, 100000.0, 200000.0, "off"),
    DemodMode.DSB: ModeInfo(DemodMode.DSB, _NB_FILTERS, 12000.0, -6000.0, 6000.0, 30000.0, "med"),
    DemodMode.LSB: ModeInfo(DemodMode.LSB, _SSB_FILTERS, 2700.0, -3000.0, -300.0, 20000.0, "slow"),
    DemodMode.USB: ModeInfo(DemodMode.USB, _SSB_FILTERS, 2700.0, 300.0, 3000.0, 20000.0, "slow"),
    DemodMode.CWL: ModeInfo(DemodMode.CWL, _CW_FILTERS, 800.0, -1400.0, -600.0, 20000.0, "fast", cw_offset=-1000.0),
    DemodMode.CWU: ModeInfo(DemodMode.CWU, _CW_FILTERS, 800.0, 600.0, 1400.0, 20000.0, "fast", cw_offset=1000.0),
    DemodMode.DIGL: ModeInfo(DemodMode.DIGL, _SSB_FILTERS, 2400.0, -2700.0, -300.0, 20000.0, "fast"),
    DemodMode.DIGU: ModeInfo(DemodMode.DIGU, _SSB_FILTERS, 2400.0, 300.0, 2700.0, 20000.0, "fast"),
    DemodMode.NONE: ModeInfo(DemodMode.NONE, (48000.0,), 48000.0, -24000.0, 24000.0, 48000.0, "off"),
}


def from_string(name: str) -> DemodMode:
    for m in DemodMode:
        if m.value.lower() == name.lower() or m.name.lower() == name.lower():
            return m
    raise ValueError(f"unknown demod mode {name!r}")


def is_wfm(mode: DemodMode) -> bool:
    return mode in (DemodMode.FMM, DemodMode.FMS)
