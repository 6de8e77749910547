"""dB / power conversions (port of pebblesdr_tpu/core/db.py, torch tensors)."""

from __future__ import annotations

import torch

# Floor used when converting zero/negative powers.
MIN_DB = -200.0
_EPS = 1e-20


def power_to_db(power: torch.Tensor) -> torch.Tensor:
    """10*log10(power), clamped to MIN_DB."""
    return torch.clamp_min(10.0 * torch.log10(torch.clamp_min(power, _EPS)),
                           MIN_DB)
