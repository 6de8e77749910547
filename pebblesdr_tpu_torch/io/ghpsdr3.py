"""ghpsdr3 dspserver network client (port of pebblesdr_tpu/io/ghpsdr3.py).

Capability parity with Ghpsdr3Device (plugins/Ghpsdr3Device,
ghpsdr3device.h:17-60): connect to a ghpsdr3 "dspserver", attach a receiver,
send text commands (setfrequency/setmode/setfilter/startaudiostream ...) and
receive the 2000-byte framed answers: a spectrum snapshot header + bins and
G.711 a-law audio, which we expand to float32 (ops.util_filters.alaw_expand).

Unlike IQ sources, a dspserver delivers POST-demod audio + display spectrum
(the remote end runs the DSP), so this is an `AudioSource`, not an IQ Source:
read_audio() yields float32 audio blocks; spectrum callbacks deliver dB rows.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from pebblesdr_tpu_torch.ops.util_filters import alaw_expand

# dspserver answer types (ghpsdr3 protocol)
SPECTRUM_BUFFER = 0
AUDIO_BUFFER = 1

HEADER_LEN = 48
AUDIO_RATE = 8000  # dspserver aLaw audio rate

MODES = {"LSB": 0, "USB": 1, "DSB": 2, "CWL": 3, "CWU": 4, "FMN": 5,
         "AM": 6, "SAM": 11}


class Ghpsdr3Client:
    def __init__(self, host: str, port: int = 8000, receiver: int = 0,
                 timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.receiver = receiver
        self.audio_buf: list[np.ndarray] = []
        self.last_spectrum: np.ndarray | None = None
        self.sample_rate = 0
        self._lock = threading.Condition()
        self._stop = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self.command(f"attachreceiver {receiver}")

    # ------------------------------------------------------------- commands

    def command(self, cmd: str) -> None:
        """dspserver commands are 64-byte zero-padded ASCII lines."""
        payload = cmd.encode()[:64]
        self.sock.sendall(payload + b"\0" * (64 - len(payload)))

    def set_frequency(self, hz: float) -> None:
        self.command(f"setfrequency {int(hz)}")

    # uniform hardware-retune surface (what the live control's device-LO
    # handoff probes for; rtl_tcp/SDR-IP/HPSDR spell it this way)
    def set_center_freq(self, hz: float) -> None:
        self.set_frequency(hz)

    def set_mode(self, mode: str) -> None:
        self.command(f"setmode {MODES.get(mode.upper(), 6)}")

    def set_filter(self, lo: int, hi: int) -> None:
        self.command(f"setfilter {lo} {hi}")

    def start_audio(self, buffer_size: int = 2000) -> None:
        self.command(f"startaudiostream {buffer_size} {AUDIO_RATE} 1 0")
        self._reader.start()

    def get_spectrum(self, width: int = 480) -> None:
        self.command(f"getspectrum {width}")

    # --------------------------------------------------------------- reading

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("dspserver closed connection")
            buf += chunk
        return buf

    def _read_loop(self) -> None:
        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(HEADER_LEN)
                btype = hdr[0]
                length = struct.unpack(">H", hdr[1:3])[0]
                payload = self._recv_exact(length)
                if btype == AUDIO_BUFFER:
                    audio = alaw_expand(np.frombuffer(payload, np.uint8))
                    with self._lock:
                        self.audio_buf.append(audio)
                        self._lock.notify_all()
                elif btype == SPECTRUM_BUFFER:
                    # payload: u8 dB values (offset-encoded), sample rate in hdr
                    self.sample_rate = struct.unpack(">I", hdr[9:13])[0]
                    with self._lock:
                        self.last_spectrum = (
                            -(np.frombuffer(payload, np.uint8).astype(np.float32)))
                        self._lock.notify_all()
        except (ConnectionError, OSError):
            pass

    def read_audio(self, n: int, timeout: float = 5.0) -> np.ndarray:
        """Blocking read of n float32 audio samples at 8 kHz."""
        out = np.zeros(0, np.float32)
        with self._lock:
            while len(out) < n:
                while not self.audio_buf:
                    if not self._lock.wait(timeout):
                        raise TimeoutError("no audio from dspserver")
                out = np.concatenate([out] + self.audio_buf)
                self.audio_buf.clear()
        extra = out[n:]
        if len(extra):
            with self._lock:
                self.audio_buf.insert(0, extra)
        return out[:n]

    def close(self) -> None:
        self._stop.set()
        self.sock.close()
