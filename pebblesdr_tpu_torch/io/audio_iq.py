"""Soundcard audio-IQ input source — the FunCube/SoftRock device class.

Port of pebblesdr_tpu/io/audio_iq.py (host code).

Those front ends tune RF in hardware and deliver baseband I/Q as a STEREO
AUDIO stream; the reference ingests it through its Audio input +
DeviceInterfaceBase::normalizeIQ (pebblelib/deviceinterfacebase.h:100-112,
plugins/FunCubeSDRDevice).  This source provides the same transport on a
Linux host: a PortAudio *input* stream over the ctypes binding pattern of
io/audio_out.PortAudioOutput, with the reference's channel-order /
gain / balance surface:

  * order: 'iq' | 'qi' | 'i' | 'q'  (DeviceInterface::IQOrder,
    device_interfaces.h:140-145; normalizeIQ applies it once per block)
  * gain: user scale (m_userIQGain analog)
  * balance_gain / balance_phase: static IQ-balance hints stored on the
    device (deviceinterfacebase.cpp:20-22) — exposed via get/set for the
    chain's iq-balance step (params.iq_gain/iq_phase), and optionally
    applied in-source (apply_balance=True) for consumers that bypass the
    chain.

A `stream_factory` hook lets tests (and wav-backed replay) substitute the
hardware stream: any object with read(frames) -> float32 [frames, channels]
and close().
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from pebblesdr_tpu_torch.io.sources import Source, SourceInfo

_ORDERS = ("iq", "qi", "i", "q")


class PortAudioInputStream:
    """Blocking PortAudio capture stream (ctypes on the system
    libportaudio; raises a clear RuntimeError when absent)."""

    _PA_FLOAT32 = 0x00000001

    def __init__(self, rate: int, channels: int = 2,
                 frames_per_buffer: int = 1024, device: str = "default"):
        import ctypes

        from pebblesdr_tpu_torch.io.audio_out import PortAudioOutput

        pa = PortAudioOutput._load()
        # input-side prototypes (the output set is declared by _load)
        pa.Pa_ReadStream.restype = ctypes.c_int
        pa.Pa_ReadStream.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_ulong]
        err = pa.Pa_Initialize()
        if err:
            raise RuntimeError(f"Pa_Initialize failed ({err})")
        self._pa = pa
        self.channels = channels
        stream = ctypes.c_void_p()
        err = pa.Pa_OpenDefaultStream(
            ctypes.byref(stream), channels, 0,
            ctypes.c_ulong(self._PA_FLOAT32), ctypes.c_double(rate),
            ctypes.c_ulong(frames_per_buffer), None, None)
        if err:
            pa.Pa_Terminate()
            raise RuntimeError(f"Pa_OpenDefaultStream (input) failed ({err})")
        self._stream = stream
        pa.Pa_StartStream(stream)

    def read(self, frames: int) -> np.ndarray:
        import ctypes

        buf = np.empty((frames, self.channels), np.float32)
        self._pa.Pa_ReadStream(self._stream,
                               buf.ctypes.data_as(ctypes.c_void_p),
                               ctypes.c_ulong(frames))
        return buf

    def close(self) -> None:
        if self._stream is not None:
            self._pa.Pa_StopStream(self._stream)
            self._pa.Pa_CloseStream(self._stream)
            self._stream = None
            self._pa.Pa_Terminate()


class WavStream:
    """Wav-backed fake audio stream (loopback testing / replay): serves a
    [N, 2] float32 array as if it were the capture device."""

    def __init__(self, frames: np.ndarray, loop: bool = True):
        self.frames = np.asarray(frames, np.float32)
        if self.frames.ndim == 1:
            self.frames = self.frames[:, None]
        self.loop = loop
        self.pos = 0

    def read(self, frames: int) -> Optional[np.ndarray]:
        n = len(self.frames)
        if self.pos >= n and not self.loop:
            return None
        out = np.empty((frames, self.frames.shape[1]), np.float32)
        got = 0
        while got < frames:
            take = min(frames - got, n - self.pos)
            if take <= 0:
                if not self.loop:
                    return out[:got] if got else None
                self.pos = 0
                continue
            out[got:got + take] = self.frames[self.pos:self.pos + take]
            self.pos += take
            got += take
        return out

    def close(self) -> None:
        pass


class AudioIqSource(Source):
    """Audio-IQ device source: stereo soundcard frames -> complex64 blocks."""

    def __init__(self, sample_rate: int = 96000, device: str = "default",
                 order: str = "iq", gain: float = 1.0,
                 balance_gain: float = 1.0, balance_phase: float = 0.0,
                 apply_balance: bool = False,
                 center_freq_hz: float = 0.0,
                 stream_factory: Callable | None = None):
        if order not in _ORDERS:
            raise ValueError(f"order must be one of {_ORDERS}")
        self.info = SourceInfo(sample_rate=sample_rate,
                               center_freq_hz=center_freq_hz,
                               name=f"audio:{device}")
        self.order = order
        self.gain = float(gain)
        self.balance_gain = float(balance_gain)
        self.balance_phase = float(balance_phase)
        self.apply_balance = apply_balance
        if stream_factory is None:
            self._stream = PortAudioInputStream(sample_rate, channels=2,
                                                device=device)
        else:
            self._stream = stream_factory()

    def read_block(self, n: int) -> Optional[np.ndarray]:
        frames = self._stream.read(n)
        if frames is None or len(frames) == 0:
            return None
        if frames.shape[1] < 2:  # mono capture: Q mirrors I (IONLY-style)
            i = q = frames[:, 0]
        else:
            i, q = frames[:, 0], frames[:, 1]
        if self.order == "qi":
            i, q = q, i
        elif self.order == "i":
            q = i
        elif self.order == "q":
            i = q
        iq = (i.astype(np.float64) + 1j * q.astype(np.float64)) * self.gain
        if self.apply_balance:
            # the standard static correction the chain's iq-balance step
            # applies (iqbalance.cpp capability): Q' = Q*gain + I*phase
            iq = iq.real + 1j * (iq.imag * self.balance_gain
                                 + iq.real * self.balance_phase)
        return iq.astype(np.complex64)

    # StandardKeys analog for the balance hints (deviceinterfacebase.cpp:241+)
    def get(self, key: str):
        if key == "iq_balance_gain":
            return self.balance_gain
        if key == "iq_balance_phase":
            return self.balance_phase
        if key == "iq_order":
            return self.order
        return super().get(key)

    def set(self, key: str, value) -> None:
        if key == "iq_balance_gain":
            self.balance_gain = float(value)
        elif key == "iq_balance_phase":
            self.balance_phase = float(value)
        elif key == "iq_order":
            if value not in _ORDERS:
                raise ValueError(f"order must be one of {_ORDERS}")
            self.order = value
        else:
            super().set(key, value)

    def close(self) -> None:
        self._stream.close()
