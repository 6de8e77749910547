"""dB / power / amplitude conversions and S-unit mapping (port of
pebblesdr_tpu/core/db.py, torch tensors; numbers and numpy arrays are
taken through torch.as_tensor).

Capability parity with the reference's static conversion helpers
(pebblelib/db.h:9-143): power<->dB, amplitude<->dB, S-units for the
S-meter, with clamping to a minimum dB floor.
"""

from __future__ import annotations

import torch

# Floor used when converting zero/negative powers.
MIN_DB = -200.0
_EPS = 1e-20


def power_to_db(power: torch.Tensor) -> torch.Tensor:
    """10*log10(power), clamped to MIN_DB."""
    return torch.clamp_min(10.0 * torch.log10(torch.clamp_min(power, _EPS)),
                           MIN_DB)


def db_to_power(db) -> torch.Tensor:
    return torch.pow(10.0, torch.as_tensor(db, dtype=torch.float32) / 10.0)


def amplitude_to_db(amplitude) -> torch.Tensor:
    """20*log10(|amplitude|), clamped to MIN_DB."""
    a = torch.abs(torch.as_tensor(amplitude))
    return torch.clamp_min(20.0 * torch.log10(torch.clamp_min(a, _EPS)),
                           MIN_DB)


def db_to_amplitude(db) -> torch.Tensor:
    return torch.pow(10.0, torch.as_tensor(db, dtype=torch.float32) / 20.0)


# S-meter: S9 = -73 dBm, 6 dB per S-unit below, dB-over-S9 above
# (capability of DB::dBToSUnit, pebblelib/db.h).
S9_DBM = -73.0
DB_PER_S_UNIT = 6.0


def db_to_s_units(db):
    """Map dB(m) to S-units (S0..S9; values >9 mean dB over S9 / 6).  Plain
    arithmetic: a float stays a float, a tensor a tensor."""
    return 9.0 + (db - S9_DBM) / DB_PER_S_UNIT


def clip_db(db, lo=MIN_DB, hi=0.0) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(db), lo, hi)
