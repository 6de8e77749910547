"""Wire-format IQ decode: raw device/file bytes -> [n] complex64 in [-1, 1).

Port of pebblesdr_tpu/core/iqformat.py.  Formats (the reference's CPX wire
formats, pebblelib/cpx.h:43-92, and DeviceInterfaceBase::normalizeIQ,
pebblelib/deviceinterfacebase.h:105-117):
  u8  (offset-128, rtl-sdr/hackrf)     CPXU8
  i8                                    CPX8
  u16 (offset-32768)                    CPXU16
  i16 (most soundcard/SDR-IQ devices)   CPX16
  f32                                   CPXFLOAT
  f64                                   (down-converted to float32)
plus an optional I/Q order swap (some devices deliver QI).

decode_iq runs on whatever device holds ``raw`` (the card right after the
copy, or the CPU); decode_iq_host and encode_iq_u8 are the numpy copies
used by the file and socket paths.
"""

from __future__ import annotations

import numpy as np
import torch

_SCALES = {
    "u8": 1.0 / 128.0,
    "i8": 1.0 / 128.0,
    "u16": 1.0 / 32768.0,
    "i16": 1.0 / 32768.0,
    "f32": 1.0,
    "f64": 1.0,
}

_OFFSETS = {"u8": 128.0, "u16": 32768.0}


def decode_iq(raw: torch.Tensor, fmt: str = "i16",
              swap_iq: bool = False) -> torch.Tensor:
    """Decode interleaved raw samples [2*n] (or [..., 2*n]) to complex64
    [..., n] on raw's device.

    raw must already have the integer/float dtype named by fmt
    (``torch.from_numpy(np.frombuffer(...))``, moved to the device or not).
    """
    if raw.dtype == torch.uint16:
        # uint16 has few kernels on the card: widen through its int16 view
        raw = raw.view(torch.int16).to(torch.int32) & 0xFFFF
    x = raw.to(torch.float32)
    x = (x - _OFFSETS.get(fmt, 0.0)) * _SCALES[fmt]
    i = x[..., 0::2]
    q = x[..., 1::2]
    if swap_iq:
        i, q = q, i
    return torch.complex(i.contiguous(), q.contiguous())


def decode_iq_host(raw_bytes: bytes, fmt: str = "i16",
                   swap_iq: bool = False) -> np.ndarray:
    """Host-side variant for file/socket ingest paths (numpy)."""
    np_dtype = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16,
                "i16": np.int16, "f32": np.float32, "f64": np.float64}[fmt]
    x = np.frombuffer(raw_bytes, dtype=np_dtype).astype(np.float32)
    x = (x - _OFFSETS.get(fmt, 0.0)) * _SCALES[fmt]
    i, q = x[0::2], x[1::2]
    if swap_iq:
        i, q = q, i
    return (i + 1j * q).astype(np.complex64)


def encode_iq_u8(x: np.ndarray) -> bytes:
    """complex64 [-1,1) -> interleaved u8 (rtl_tcp wire format, serve path)."""
    out = np.empty(2 * x.shape[-1], dtype=np.uint8)
    out[0::2] = np.clip(np.round(x.real * 128.0 + 128.0), 0, 255).astype(np.uint8)
    out[1::2] = np.clip(np.round(x.imag * 128.0 + 128.0), 0, 255).astype(np.uint8)
    return out.tobytes()
