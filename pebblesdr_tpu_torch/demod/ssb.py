"""SSB/CW/DIG/DSB demodulation: sideband-filtered product detection.

Port of pebblesdr_tpu/demod/ssb.py.  After the FastFIR bandpass has
selected the sideband, SSB audio is I+Q (USB, CWU, DIGU) or I-Q (LSB, CWL,
DIGL); CW is SSB with a narrow filter (the bandpass design); DSB is 2*I
(application/demod.cpp:143-166).  Stateless and elementwise.
"""

from __future__ import annotations

import torch


def usb_demod(x: torch.Tensor) -> torch.Tensor:
    """x: [C, N] complex64 -> [C, N] float32."""
    return (x.real + x.imag).to(torch.float32)


def lsb_demod(x: torch.Tensor) -> torch.Tensor:
    return (x.real - x.imag).to(torch.float32)


def dsb_demod(x: torch.Tensor) -> torch.Tensor:
    return (2.0 * x.real).to(torch.float32)
