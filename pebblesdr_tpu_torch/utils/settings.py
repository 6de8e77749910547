"""Settings persistence (receiver and per-device configuration as JSON),
presets and the station database.

A copy of pebblesdr_tpu/utils/settings.py (no JAX in it; the port imports
none of the JAX package): Settings, Preset, the presets CSV reader and
writer, the EiBi import, stations_near, load_stations, which reads the
port's own copy of the shipped station list (pebblesdr_tpu_torch/data/
stations.csv) plus the user DB ($PEBBLESDR_STATIONS or
~/.pebblesdr_tpu/stations.csv) where present, as the JAX package does, and
load_memory (data/memory.csv; data/bands.csv ships beside it).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

DEFAULTS = {
    "frames_per_buffer": 32768,
    "spectrum_bins": 2048,
    "updates_per_second": 10,
    "db_offset": 0.0,
    "audio_rate": 48000,
    "last_freq_hz": 10_000_000.0,
    "last_mode": "AM",
    "agc_mode": "med",
    "squelch_db": -999.0,
    "gain": 1.0,
}


class Settings:
    def __init__(self, path: str = "~/.pebblesdr_tpu/settings.json"):
        self.path = os.path.expanduser(path)
        self.values: dict[str, Any] = dict(DEFAULTS)
        self.device: dict[str, dict[str, Any]] = {}
        self.read()

    def read(self) -> None:
        if os.path.exists(self.path):
            with open(self.path) as f:
                data = json.load(f)
            self.values.update(data.get("global", {}))
            self.device.update(data.get("device", {}))

    def write(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"global": self.values, "device": self.device}, f,
                      indent=2, sort_keys=True)

    def get(self, key: str, default=None):
        return self.values.get(key, DEFAULTS.get(key, default))

    def set(self, key: str, value) -> None:
        self.values[key] = value

    def device_settings(self, name: str) -> dict:
        """Per-device namespace (the per-plugin .ini analog)."""
        return self.device.setdefault(name, {})


@dataclasses.dataclass
class Preset:
    """A station/band/memory entry (presets.h:43-133 capability)."""
    name: str
    freq_hz: float
    mode: str = "AM"
    notes: str = ""
    lo_hz: float = 0.0   # band edges (0 = single station)
    hi_hz: float = 0.0


def load_presets_csv(path: str) -> list[Preset]:
    """Load stations/bands from CSV: name,freq_hz,mode[,notes[,lo,hi]]
    (the eibi.csv / bands.csv / memory.csv capability)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 2:
                continue
            out.append(Preset(
                name=parts[0], freq_hz=float(parts[1]),
                mode=parts[2] if len(parts) > 2 else "AM",
                notes=parts[3] if len(parts) > 3 else "",
                lo_hz=float(parts[4]) if len(parts) > 4 else 0.0,
                hi_hz=float(parts[5]) if len(parts) > 5 else 0.0,
            ))
    return out


def save_presets_csv(path: str, presets: list[Preset]) -> None:
    with open(path, "w") as f:
        f.write("# name,freq_hz,mode,notes,lo_hz,hi_hz\n")
        for p in presets:
            f.write(f"{p.name},{p.freq_hz},{p.mode},{p.notes},{p.lo_hz},{p.hi_hz}\n")


def data_path(name: str) -> str:
    """Path of a data fixture shipped with the port (bands.csv /
    stations.csv / memory.csv, the reference's presets data files,
    presets.h:43-133)."""
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "data", name)


USER_STATIONS = "~/.pebblesdr_tpu/stations.csv"


def load_stations() -> list[Preset]:
    """The station DB (eibi.csv capability): the shipped curated list plus,
    when present, the user DB at $PEBBLESDR_STATIONS or ~/.pebblesdr_tpu/
    stations.csv — where tools/fetch_eibi.py writes the full converted EiBi
    schedule (the reference ships a 555 kB snapshot; we fetch the CURRENT
    season instead of vendoring a stale one)."""
    presets = load_presets_csv(data_path("stations.csv"))
    user = os.environ.get("PEBBLESDR_STATIONS",
                          os.path.expanduser(USER_STATIONS))
    if os.path.exists(user):
        presets = presets + load_presets_csv(user)
    return presets


def import_eibi_csv(path: str, langs: tuple[str, ...] = ()) -> list[Preset]:
    """Import a real EiBi shortwave schedule (http://eibispace.de sk*.csv):
    semicolon-separated ``kHz;Time(UTC);Days;ITU;Station;Lng;Target;Remarks``
    — the reference ships a 555 kB snapshot (application/eibi.csv) and parses
    it in Presets (presets.cpp); here the import converts to Preset rows so
    the full DB drops into the same station-lookup path as the shipped
    fixture.  `langs` optionally filters by the Lng column."""
    out: list[Preset] = []
    with open(path, encoding="latin-1") as f:
        for line in f:
            parts = line.rstrip("\n").split(";")
            if len(parts) < 5:
                continue
            try:
                khz = float(parts[0])
            except ValueError:
                continue  # header or malformed row
            lng = parts[5].strip() if len(parts) > 5 else ""
            if langs and lng not in langs:
                continue
            time_utc = parts[1].strip()
            itu = parts[3].strip()
            station = parts[4].strip()
            target = parts[6].strip() if len(parts) > 6 else ""
            notes = " ".join(x for x in (time_utc, itu, target) if x)
            out.append(Preset(name=station, freq_hz=khz * 1000.0,
                              mode="AM", notes=notes))
    return out


def stations_near(presets: list[Preset], center_hz: float, span_hz: float
                  ) -> list[Preset]:
    """Stations inside a capture window (what a band-scanning UI or the
    --stations CLI uses to seed a dense channel bank)."""
    lo, hi = center_hz - span_hz / 2.0, center_hz + span_hz / 2.0
    return sorted((p for p in presets if lo <= p.freq_hz <= hi),
                  key=lambda p: p.freq_hz)


def load_memory() -> list[Preset]:
    return load_presets_csv(data_path("memory.csv"))
