"""IQ WAV file reader/writer with SDR metadata, and the audio WAV writer.

A copy of pebblesdr_tpu/io/wav.py (pure numpy, so the port imports none of
the JAX package; tests/test_torch_io.py holds the two to the same bytes).
RIFF WAV read and write for 2-channel I/Q in PCM int16 or IEEE float32 (and
8-bit unsigned on read), with a 'fact' chunk carrying the sample count and
a private 'sdr ' chunk with a key=value payload (center_freq, mode) so a
recording replays with its tuning; Pebble-style 'pebb' chunks are parsed
too.  write_audio_wav writes mono [n] or stereo [2, n] float32 audio as
int16.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    num_samples: int
    fmt: str                     # 'i16' | 'f32'
    center_freq_hz: float = 0.0  # LO / capture center
    demod_mode: str = ""


def _chunks(buf: bytes):
    pos = 12
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def read_iq_wav(path: str) -> tuple[np.ndarray, WavInfo]:
    """Returns (iq complex64 [n], WavInfo)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = None
    data = None
    meta = {}
    num_fact = None
    for cid, off, size in _chunks(buf):
        if cid == b"fmt ":
            (audio_fmt, channels, rate, _br, _ba, bits) = struct.unpack_from(
                "<HHIIHH", buf, off)
            fmt = (audio_fmt, channels, rate, bits)
        elif cid == b"data":
            data = buf[off:off + size]
        elif cid == b"fact":
            num_fact = struct.unpack_from("<I", buf, off)[0]
        elif cid in (b"sdr ", b"pebb"):
            try:
                text = buf[off:off + size].split(b"\0")[0].decode("utf-8")
                for kv in text.split(";"):
                    if "=" in kv:
                        k, v = kv.split("=", 1)
                        meta[k.strip()] = v.strip()
            except UnicodeDecodeError:
                pass
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, rate, bits = fmt
    if channels != 2:
        raise ValueError(f"{path}: need 2-channel I/Q wav, got {channels}")
    if audio_fmt == 1 and bits == 16:
        raw = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        kind = "i16"
    elif audio_fmt == 3 and bits == 32:
        raw = np.frombuffer(data, dtype="<f4").astype(np.float32)
        kind = "f32"
    elif audio_fmt == 1 and bits == 8:
        raw = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        kind = "u8"
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_fmt}/{bits}")
    iq = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    info = WavInfo(
        sample_rate=rate,
        num_samples=num_fact if num_fact is not None else len(iq),
        fmt=kind,
        center_freq_hz=float(meta.get("center_freq", meta.get("lofreq", 0.0))),
        demod_mode=meta.get("mode", ""),
    )
    return iq, info


def write_iq_wav(path: str, iq: np.ndarray, sample_rate: int,
                 fmt: str = "f32", center_freq_hz: float = 0.0,
                 demod_mode: str = "") -> None:
    """Write complex64 [n] as 2-channel I/Q wav with SDR metadata."""
    n = len(iq)
    inter = np.empty(2 * n, np.float32)
    inter[0::2] = iq.real
    inter[1::2] = iq.imag
    if fmt == "i16":
        payload = np.clip(np.round(inter * 32767.0), -32768, 32767).astype("<i2").tobytes()
        audio_fmt, bits = 1, 16
    elif fmt == "f32":
        payload = inter.astype("<f4").tobytes()
        audio_fmt, bits = 3, 32
    else:
        raise ValueError(fmt)
    meta = f"center_freq={center_freq_hz};mode={demod_mode}".encode() + b"\0"
    if len(meta) & 1:
        meta += b"\0"
    block_align = 2 * bits // 8
    chunks = [
        (b"fmt ", struct.pack("<HHIIHH", audio_fmt, 2, sample_rate,
                              sample_rate * block_align, block_align, bits)),
        (b"fact", struct.pack("<I", n)),
        (b"sdr ", meta),
        (b"data", payload),
    ]
    body = b"WAVE"
    for cid, cdata in chunks:
        body += cid + struct.pack("<I", len(cdata)) + cdata
        if len(cdata) & 1:
            body += b"\0"
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_audio_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono [n] or stereo [2, n] float32 audio as int16 wav."""
    if audio.ndim == 1:
        audio = audio[None]
    channels, n = audio.shape
    inter = np.empty(channels * n, np.float32)
    for c in range(channels):
        inter[c::channels] = audio[c]
    payload = np.clip(np.round(inter * 32767.0), -32768, 32767).astype("<i2").tobytes()
    block_align = channels * 2
    body = (b"WAVE"
            + b"fmt " + struct.pack("<I", 16)
            + struct.pack("<HHIIHH", 1, channels, sample_rate,
                          sample_rate * block_align, block_align, 16)
            + b"data" + struct.pack("<I", len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
