"""Native host runtime: the C++ IQ ring buffer, wire-format decode and the
UDP pump, bound with ctypes.

Port of pebblesdr_tpu/runtime/__init__.py.  The library is built from the
port's own ``csrc/ring.cpp`` by ``kernels/build.py`` (g++, no
``-march=native``) into ``build/kernels/`` at its first use, never at
import; the JAX package's prebuilt library is never loaded.  ``load()``
raises with the compiler's stderr when the build fails; ``available()``
answers the automatic choice (``SdrIpSource(native=None)``), and the
decoders fall back to numpy when the library cannot be built.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pebblesdr_tpu_torch.kernels import build as _build

_lib = None
_path = None


def load():
    """The loaded runtime library, building csrc/ring.cpp first if needed.
    Raises RuntimeError (with g++'s stderr) when it cannot be built."""
    global _lib, _path
    if _lib is not None:
        return _lib
    lib = _build.load_host("ring")
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_acquire_write.restype = ctypes.c_void_p
    lib.ring_acquire_write.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ring_commit_write.argtypes = [ctypes.c_void_p]
    lib.ring_acquire_read.restype = ctypes.c_void_p
    lib.ring_acquire_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ring_release_read.argtypes = [ctypes.c_void_p]
    lib.ring_filled.restype = ctypes.c_size_t
    lib.ring_filled.argtypes = [ctypes.c_void_p]
    lib.ring_overruns.restype = ctypes.c_uint64
    lib.ring_overruns.argtypes = [ctypes.c_void_p]
    for name in ("decode_u8", "decode_i8", "decode_i16", "decode_u16",
                 "decode_f32", "deint_i16", "deint_i8_to_i16",
                 "deint_u8_to_i16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int]
    lib.udp_pump_create.restype = ctypes.c_void_p
    lib.udp_pump_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_int]
    lib.udp_pump_port.restype = ctypes.c_int
    lib.udp_pump_port.argtypes = [ctypes.c_void_p]
    lib.udp_pump_read.restype = ctypes.c_int
    lib.udp_pump_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int]
    lib.udp_pump_counters.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 6
    lib.udp_pump_stop.argtypes = [ctypes.c_void_p]
    lib.udp_pump_destroy.argtypes = [ctypes.c_void_p]
    _lib, _path = lib, _build.host_library_path("ring")
    return lib


def library_path():
    """Where the loaded library lies (None before the first load)."""
    return _path


def _try_load():
    """The library, or None when it cannot be built."""
    try:
        return load()
    except (RuntimeError, OSError):
        return None


def available() -> bool:
    return _try_load() is not None


class NativeRing:
    """ProducerConsumer-equivalent buffer ring backed by the C++ runtime."""

    def __init__(self, n_buffers: int, buf_bytes: int):
        self._lib = load()
        self.buf_bytes = buf_bytes
        self._ring = self._lib.ring_create(n_buffers, buf_bytes)

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.ring_destroy(self._ring)
            self._ring = None

    def write(self, data: bytes, timeout_ms: int = -1,
              drop_oldest: bool = True) -> bool:
        assert len(data) <= self.buf_bytes
        ptr = self._lib.ring_acquire_write(self._ring, timeout_ms,
                                           1 if drop_oldest else 0)
        if not ptr:
            return False
        ctypes.memmove(ptr, data, len(data))
        self._lib.ring_commit_write(self._ring)
        return True

    def read(self, nbytes: int | None = None, timeout_ms: int = -1) -> bytes | None:
        ptr = self._lib.ring_acquire_read(self._ring, timeout_ms)
        if not ptr:
            return None
        out = ctypes.string_at(ptr, nbytes or self.buf_bytes)
        self._lib.ring_release_read(self._ring)
        return out

    @property
    def filled(self) -> int:
        return self._lib.ring_filled(self._ring)

    @property
    def overruns(self) -> int:
        return self._lib.ring_overruns(self._ring)


_DECODERS = {"u8": "decode_u8", "i8": "decode_i8", "i16": "decode_i16",
             "u16": "decode_u16", "f32": "decode_f32"}
_DTYPES = {"u8": np.uint8, "i8": np.int8, "i16": np.int16, "u16": np.uint16,
           "f32": np.float32}


def decode_iq_planes(raw: bytes | np.ndarray, fmt: str,
                     swap_iq: bool = False) -> np.ndarray:
    """Interleaved wire bytes -> [2, n] float32 (re, im) planes.

    Native when the runtime library builds; numpy otherwise (the same math
    as core.iqformat)."""
    arr = np.frombuffer(raw, dtype=_DTYPES[fmt]) if isinstance(raw, (bytes, bytearray)) \
        else np.ascontiguousarray(raw, dtype=_DTYPES[fmt])
    n = arr.size // 2
    lib = _try_load()
    if lib is not None:
        out = np.empty((2, n), np.float32)
        getattr(lib, _DECODERS[fmt])(
            arr.ctypes.data_as(ctypes.c_void_p), n,
            out[0].ctypes.data_as(ctypes.c_void_p),
            out[1].ctypes.data_as(ctypes.c_void_p),
            1 if swap_iq else 0)
        return out
    x = arr.astype(np.float32)
    if fmt == "u8":
        x = (x - 128.0) / 128.0
    elif fmt == "i8":
        x = x / 128.0
    elif fmt == "i16":
        x = x / 32768.0
    elif fmt == "u16":
        x = (x - 32768.0) / 32768.0
    i, q = x[0::2], x[1::2]
    if swap_iq:
        i, q = q, i
    return np.stack([i, q])


_DEINT16 = {"i16": "deint_i16", "i8": "deint_i8_to_i16",
            "u8": "deint_u8_to_i16"}


def deint_iq_planes_i16(raw: bytes | np.ndarray, fmt: str,
                        swap_iq: bool = False) -> np.ndarray:
    """Interleaved integer wire bytes -> [2, n] INT16 (re, im) planes.

    The native-container path: the chain takes int16 entry planes and
    dequantizes inside K1, so the host never converts to float and copies
    half the bytes.  i8/u8 rescale to full-scale i16 (lossless << 8); fmt
    must be one of i16/i8/u8."""
    if fmt not in _DEINT16:
        raise ValueError(f"no i16 passthrough for wire format {fmt!r}")
    arr = np.frombuffer(raw, dtype=_DTYPES[fmt]) if isinstance(raw, (bytes, bytearray)) \
        else np.ascontiguousarray(raw, dtype=_DTYPES[fmt])
    n = arr.size // 2
    lib = _try_load()
    if lib is not None:
        out = np.empty((2, n), np.int16)
        getattr(lib, _DEINT16[fmt])(
            arr.ctypes.data_as(ctypes.c_void_p), n,
            out[0].ctypes.data_as(ctypes.c_void_p),
            out[1].ctypes.data_as(ctypes.c_void_p),
            1 if swap_iq else 0)
        return out
    if fmt == "i16":
        x = arr.astype(np.int16)
    elif fmt == "i8":
        x = (arr.astype(np.int16) << 8)
    else:  # u8
        x = ((arr.astype(np.int16) - 128) << 8)
    i, q = x[0::2], x[1::2]
    if swap_iq:
        i, q = q, i
    return np.stack([i, q])


_FMT_CODES = {"i16": 0, "u8": 1, "i8": 2, "u16": 3, "f32": 4}


class NativeUdpPump:
    """High-rate UDP IQ receiver on a dedicated C++ thread: header strip,
    LE16 sequence-gap tracking (a gap under 1024 zero-filled and counted in
    counters['dropped_datagrams'], a larger one taken as a restart and
    counted in counters['resyncs']), wire-format decode to deinterleaved
    float32 planes, whole blocks committed into a native ring with
    drop-oldest overrun semantics.  close() drains what the socket already
    holds first, so the counters cover every datagram sent before it; a
    block that finds no ring slot then (the ring full with no consumer) is
    counted in counters['discarded'].

    The native data plane for Msps network sources (SDR-IP at 2 Msps is
    ~8 k datagrams/s: a per-datagram Python loop steals time the chain
    feeder needs); the ProducerConsumer producer-thread role, filled by a
    socket."""

    def __init__(self, port: int = 0, header_bytes: int = 0,
                 seq_le16_offset: int = -1, fmt: str = "i16",
                 swap_iq: bool = False, block_samples: int = 32768,
                 ring_buffers: int = 16, bind_host: str = "",
                 drop_oldest: bool = False):
        # drop_oldest=False (default): backpressure to the 8 MB socket
        # buffer; kernel loss surfaces as tracked sequence gaps, never a
        # silent splice.  True: real-time freshness (ProducerConsumer POLL
        # drop-oldest semantics), counted in counters['overruns'].
        self._lib = load()
        self.block_samples = block_samples
        self._pump = self._lib.udp_pump_create(
            bind_host.encode(), port, header_bytes, seq_le16_offset,
            _FMT_CODES[fmt], 1 if swap_iq else 0, block_samples, ring_buffers,
            1 if drop_oldest else 0)
        if not self._pump:
            raise OSError(f"udp pump failed to bind port {port}")
        self.port = self._lib.udp_pump_port(self._pump)

    def read_planes(self, timeout_ms: int = 5000) -> np.ndarray | None:
        """One block as [2, block_samples] float32 (re, im) planes, or None
        on timeout."""
        out = np.empty((2, self.block_samples), np.float32)
        ok = self._lib.udp_pump_read(
            self._pump, out.ctypes.data_as(ctypes.c_void_p), timeout_ms)
        return out if ok else None

    def read_block(self, timeout_ms: int = 5000) -> np.ndarray | None:
        """One block as complex64 (the planes path avoids the complex round
        trip)."""
        p = self.read_planes(timeout_ms)
        return None if p is None else (p[0] + 1j * p[1]).astype(np.complex64)

    @property
    def counters(self) -> dict:
        """datagrams, dropped_datagrams, overruns, bytes, resyncs and
        discarded (whole blocks no ring slot took: the pump stopped while
        the ring was full), still readable after close()."""
        if self._pump is None:
            return dict(self._final)
        vals = [ctypes.c_uint64() for _ in range(6)]
        self._lib.udp_pump_counters(self._pump, *[ctypes.byref(v) for v in vals])
        return {"datagrams": vals[0].value, "dropped_datagrams": vals[1].value,
                "overruns": vals[2].value, "bytes": vals[3].value,
                "resyncs": vals[4].value, "discarded": vals[5].value}

    def close(self) -> None:
        if getattr(self, "_pump", None):
            self._lib.udp_pump_stop(self._pump)    # drains the socket first
            self._final = self.counters
            self._lib.udp_pump_destroy(self._pump)
            self._pump = None

    def __del__(self):
        self.close()
