"""rtl_tcp wire protocol: server (SdrGarage capability) and client source.

Port of pebblesdr_tpu/io/rtl_tcp.py (host code, numpy and sockets).

Capability parity with:
  * SdrGarage/SdrServer + RtlTcpProtocol (sdrserver.h:11-42,
    rtltcpprotocol.h:12-70): serve any Source over TCP speaking the rtl_tcp
    protocol — 12-byte "RTL0" header, 5-byte commands (u8 cmd + u32 big-endian
    arg), unsigned-8-bit interleaved IQ stream;
  * RTL2832SDRDevice in RTL_TCP mode (rtl2832sdrdevice.h:103,117-129): the
    client side, usable as a Source feeding the chain from a remote server
    (including real rtl_tcp servers on actual RTL-SDR hardware).

Threaded blocking sockets (one producer thread per client) — the host-side IO
layer; the client decodes the u8 stream with core.iqformat.decode_iq_host.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from pebblesdr_tpu_torch.core import iqformat
from pebblesdr_tpu_torch.io.sources import Source, SourceInfo

MAGIC = b"RTL0"

# rtl_tcp command set (rtltcpprotocol.h:16-18 / rtl-sdr.c)
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08
CMD_SET_DIRECT_SAMPLING = 0x09
CMD_SET_OFFSET_TUNING = 0x0A


class RtlTcpServer:
    """Serve a Source's IQ stream over the rtl_tcp protocol."""

    def __init__(self, source: Source, host: str = "127.0.0.1", port: int = 1234,
                 block: int = 16384):
        self.source = source
        self.host, self.port = host, port
        self.block = block
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(1)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.commands: list[tuple[int, int]] = []

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._serve_client(conn)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._sock.close()
        if self._thread:
            self._thread.join(timeout=2)

    def _serve_client(self, conn: socket.socket) -> None:
        try:
            # header: magic + tuner type + gain count (rtl_tcp dongle_info)
            conn.sendall(MAGIC + struct.pack(">II", 5, 29))
            conn.setblocking(False)
            while not self._stop.is_set():
                # drain pending commands
                try:
                    while True:
                        pkt = conn.recv(5)
                        if not pkt:
                            return
                        if len(pkt) == 5:
                            cmd, arg = pkt[0], struct.unpack(">I", pkt[1:])[0]
                            self._handle_command(cmd, arg)
                except BlockingIOError:
                    pass
                blk = self.source.read_block(self.block)
                if blk is None:
                    return
                payload = iqformat.encode_iq_u8(blk)
                conn.setblocking(True)
                conn.sendall(payload)
                conn.setblocking(False)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            conn.close()

    def _handle_command(self, cmd: int, arg: int) -> None:
        self.commands.append((cmd, arg))
        if cmd == CMD_SET_FREQ:
            self.source.set("center_freq_hz", float(arg))
        elif cmd == CMD_SET_SAMPLE_RATE:
            self.source.set("sample_rate", int(arg))


class RtlTcpSource(Source):
    """Client: connect to an rtl_tcp server, stream u8 IQ as complex64."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1234,
                 sample_rate: int = 2_048_000, center_freq_hz: float = 100e6,
                 timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        hdr = self._recv_exact(12)
        if hdr[:4] != MAGIC:
            raise ConnectionError(f"not an rtl_tcp server (magic {hdr[:4]!r})")
        self.info = SourceInfo(sample_rate=sample_rate,
                               center_freq_hz=center_freq_hz,
                               name=f"rtl_tcp://{host}:{port}")
        self.set_sample_rate(sample_rate)
        self.set_center_freq(center_freq_hz)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rtl_tcp server closed connection")
            buf += chunk
        return buf

    def _send_cmd(self, cmd: int, arg: int) -> None:
        self.sock.sendall(bytes([cmd]) + struct.pack(">I", int(arg)))

    def set_center_freq(self, freq_hz: float) -> None:
        self.info.center_freq_hz = freq_hz
        self._send_cmd(CMD_SET_FREQ, int(freq_hz))

    def set_sample_rate(self, rate: int) -> None:
        self.info.sample_rate = rate
        self._send_cmd(CMD_SET_SAMPLE_RATE, rate)

    def set_gain(self, tenths_db: int) -> None:
        self._send_cmd(CMD_SET_GAIN_MODE, 1)
        self._send_cmd(CMD_SET_GAIN, tenths_db)

    def read_block(self, n: int) -> np.ndarray:
        raw = self._recv_exact(2 * n)
        return iqformat.decode_iq_host(raw, "u8")

    def close(self) -> None:
        self.sock.close()
