"""The port's network sources and servers (pebblesdr_tpu_torch/io/
rtl_tcp.py, sdr_ip.py, hpsdr.py, ghpsdr3.py) and its source registry
(io/registry.py), over loopback with socket timeouts and port 0.

Cross-package wire tests: the port's server against the JAX package's
client and the JAX server against the port's client, each pair's samples
bit-equal to the wire's own quantization of the served source (u8 for
rtl_tcp, int16 for SDR-IP, 24-bit for HPSDR) and the commands landing;
every encoder byte-equal to the JAX package's.  Then the cases of
tests/test_rtl_tcp.py, test_sdr_ip.py, test_hpsdr.py, test_io.py (the
registry) and test_io2.py (ghpsdr3) on the port."""

import importlib.metadata
import socket
import struct
import threading
import time

import numpy as np
import pytest

from pebblesdr_tpu.io import ghpsdr3 as jghpsdr3
from pebblesdr_tpu.io import hpsdr as jhpsdr
from pebblesdr_tpu.io import rtl_tcp as jrtl
from pebblesdr_tpu.io import sdr_ip as jsdr_ip
from pebblesdr_tpu.io import sources as jsources
from pebblesdr_tpu.ops.util_filters import alaw_compress
from pebblesdr_tpu_torch.core import iqformat
from pebblesdr_tpu_torch.io import ghpsdr3, hpsdr, registry, rtl_tcp, sdr_ip
from pebblesdr_tpu_torch.io import sources
from pebblesdr_tpu_torch.io.sources import SyntheticSource

PKGS = {"port": (sources, rtl_tcp, sdr_ip, hpsdr),
        "jax": (jsources, jrtl, jsdr_ip, jhpsdr)}
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]


def served(srcmod, fs: int):
    """The served source: two tones and noise from a seed (the two
    packages' SyntheticSource give the same samples)."""
    return srcmod.SyntheticSource(fs, tones=((fs / 10, 0.4), (-fs / 7, 0.2)),
                                  noise_db=-30.0, seed=11)


def reads(fs: int, block: int, count: int) -> list:
    """The served source's first count reads of block samples, as the
    server makes them (the noise is drawn read by read)."""
    src = served(sources, fs)
    return [src.read_block(block) for _ in range(count)]


def wait_for(cond, seconds: float = 2.0) -> bool:
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < seconds:
        time.sleep(0.01)
    return cond()


# ---- cross-package wire tests ----------------------------------------------

@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_rtl_tcp_across_packages(server_pkg, client_pkg):
    fs = 1_024_000
    src = served(PKGS[server_pkg][0], fs)
    server = PKGS[server_pkg][1].RtlTcpServer(src, port=0, block=4096)
    server.start()
    try:
        client = PKGS[client_pkg][1].RtlTcpSource(
            "127.0.0.1", server.port, sample_rate=fs, center_freq_hz=100e6,
            timeout=5.0)
        got = client.read_block(3 * 4096)
        want = iqformat.decode_iq_host(iqformat.encode_iq_u8(
            np.concatenate(reads(fs, 4096, 3))), "u8")
        np.testing.assert_array_equal(got, want)
        client.set_center_freq(7_000_000.0)
        assert wait_for(lambda: (client.read_block(4096) is not None and
                                 (1, 7_000_000) in server.commands))
        assert src.info.center_freq_hz == 7_000_000.0
        assert (2, fs) in server.commands
        client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("server_pkg,client_pkg,native", [
    ("port", "jax", False), ("jax", "port", False), ("jax", "port", True),
    ("port", "port", False), ("port", "port", True)])
def test_sdr_ip_across_packages(server_pkg, client_pkg, native):
    """The port's client both ways (numpy and its native UDP pump); the
    JAX client on numpy (its native pump is the JAX package's)."""
    fs = 512_000
    src = served(PKGS[server_pkg][0], fs)
    server = PKGS[server_pkg][2].SdrIpServer(src, name="SDR-IP",
                                             serial="XY99")
    server.start()
    try:
        client = PKGS[client_pkg][2].SdrIpSource(
            "127.0.0.1", server.port, sample_rate=fs,
            center_freq_hz=14_100_000.0, timeout=5.0, native=native)
        assert (client.target_name, client.serial) == ("SDR-IP", "XY99")
        assert src.get("center_freq_hz") == 14_100_000.0
        assert src.get("sample_rate") == fs
        client.set_center_freq(7_040_000.0)
        assert src.get("center_freq_hz") == 7_040_000.0
        client.start()
        got = client.read_block(4096)
        client.close()
        want = np.concatenate([sdr_ip.decode_cpx16(sdr_ip.encode_cpx16(b))
                               for b in reads(fs, 256, 16)])
        assert client.dropped_datagrams == 0
        np.testing.assert_array_equal(got, want)
    finally:
        server.stop()


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_hpsdr_across_packages(server_pkg, client_pkg):
    fs = 192_000
    src = served(PKGS[server_pkg][0], fs)
    server = PKGS[server_pkg][3].HpsdrServer(src, fw_version=29,
                                             board_id=0x02)
    server.start()
    try:
        client = PKGS[client_pkg][3].HpsdrSource(
            "127.0.0.1", server.port, sample_rate=fs,
            center_freq_hz=7_040_000.0, timeout=5.0)
        assert (client.fw_version, client.board_id) == (29, 0x02)
        assert wait_for(lambda: src.get("center_freq_hz") == 7_040_000.0)
        client.start(bandscope=True)
        got = client.read_block(4096)
        bs = client.read_bandscope()
        client.close()
        assert client.dropped_datagrams == 0
        n_dg = len(bs) // hpsdr.BANDSCOPE_SAMPLES_PER_DATAGRAM
        blocks = reads(fs, hpsdr.SAMPLES_PER_DATAGRAM,
                       max(n_dg, -(-4096 // hpsdr.SAMPLES_PER_DATAGRAM)))
        want = np.concatenate([hpsdr.decode_frame(hpsdr.encode_frame(
            b[i:i + 63]))[1] for b in blocks for i in (0, 63)])
        np.testing.assert_array_equal(got, want[:4096])
        # the bandscope: each datagram's real part, zero-padded to 512
        # samples, in 16-bit frames
        wide = np.zeros((n_dg, hpsdr.BANDSCOPE_SAMPLES_PER_DATAGRAM),
                        np.float32)
        wide[:, :hpsdr.SAMPLES_PER_DATAGRAM] = np.stack(blocks[:n_dg]).real
        wide = wide.reshape(-1, 256)
        np.testing.assert_array_equal(bs, np.concatenate(
            [hpsdr.decode_bandscope_frame(hpsdr.encode_bandscope_frame(f))
             for f in wide]))
        assert len(bs) >= 4096
    finally:
        server.stop()


def test_wire_encoders_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    iq63 = (rng.uniform(-1.1, 1.1, 63)
            + 1j * rng.uniform(-1.1, 1.1, 63)).astype(np.complex64)
    mic = rng.uniform(-1, 1, 63).astype(np.float32)
    ctrl = bytes([0x00, 0x01, 0x02, 0x03, 0x1d])
    frame = hpsdr.encode_frame(iq63, ctrl, mic)
    assert frame == jhpsdr.encode_frame(iq63, ctrl, mic)
    for a, b in zip(hpsdr.decode_frame(frame), jhpsdr.decode_frame(frame)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    wide = rng.uniform(-1.1, 1.1, 256).astype(np.float32)
    bframe = hpsdr.encode_bandscope_frame(wide)
    assert bframe == jhpsdr.encode_bandscope_frame(wide)
    np.testing.assert_array_equal(hpsdr.decode_bandscope_frame(bframe),
                                  jhpsdr.decode_bandscope_frame(bframe))
    assert hpsdr.command_frame(4, b"\x01\x02\x03\x04") == \
        jhpsdr.command_frame(4, b"\x01\x02\x03\x04")
    assert hpsdr.data_packet(6, 70000, frame, frame) == \
        jhpsdr.data_packet(6, 70000, frame, frame)
    for rate in (40_000, 96_000, 200_000, 500_000):
        assert hpsdr.config_command(rate) == jhpsdr.config_command(rate)
    assert hpsdr.freq_command(14_074_000.4) == jhpsdr.freq_command(14_074_000.4)
    x = (rng.uniform(-1.1, 1.1, 256)
         + 1j * rng.uniform(-1.1, 1.1, 256)).astype(np.complex64)
    for swap in (False, True):
        raw = sdr_ip.encode_cpx16(x, swap)
        assert raw == jsdr_ip.encode_cpx16(x, swap)
        np.testing.assert_array_equal(sdr_ip.decode_cpx16(raw, swap),
                                      jsdr_ip.decode_cpx16(raw, swap))
    assert sdr_ip.pack_frequency(20e6, 1) == jsdr_ip.pack_frequency(20e6, 1)
    for t in range(8):
        assert sdr_ip.pack_item(t, 0x00B8, b"\x00\x01") == \
            jsdr_ip.pack_item(t, 0x00B8, b"\x00\x01")
    server = sdr_ip.SdrIpServer(SyntheticSource(1000), name="NetSDR",
                                serial="AB12")
    try:
        assert server._discover_response() == \
            jsdr_ip.SdrIpServer._discover_response(server)
        for msg_type, item in ((1, 0x0001), (1, 0x0002), (1, 0x0003),
                               (1, 0x0005), (1, 0x0020), (1, 0x00B8),
                               (0, 0x0020)):
            payload = struct.pack("<H", item) + (
                b"\x00" + (7_000_000).to_bytes(5, "little") if msg_type == 0
                else b"")
            assert server._handle(msg_type, payload) == \
                jsdr_ip.SdrIpServer._handle(server, msg_type, payload)
    finally:
        server.stop()


# ---- tests/test_rtl_tcp.py --------------------------------------------------

def test_rtl_tcp_stream_and_commands():
    src = SyntheticSource(1_024_000, tones=((100_000.0, 0.5),), noise_db=None)
    server = rtl_tcp.RtlTcpServer(src, port=0, block=4096)
    server.start()
    try:
        client = rtl_tcp.RtlTcpSource("127.0.0.1", server.port,
                                      sample_rate=1_024_000,
                                      center_freq_hz=100e6)
        blk = client.read_block(8192)
        assert blk.shape == (8192,) and blk.dtype == np.complex64
        assert abs(np.mean(np.abs(blk) ** 2) - 0.25) < 0.01
        f = np.argmax(np.abs(np.fft.fft(blk))) / len(blk) * 1_024_000
        assert abs(f - 100_000.0) < 1_024_000 / 8192 * 2
        client.set_center_freq(7_000_000.0)
        for _ in range(50):
            client.read_block(4096)
            if (rtl_tcp.CMD_SET_FREQ, 7_000_000) in server.commands:
                break
            time.sleep(0.02)
        assert (rtl_tcp.CMD_SET_FREQ, 7_000_000) in server.commands
        assert src.info.center_freq_hz == 7_000_000.0
        client.close()
    finally:
        server.stop()


def test_rtl_tcp_rejects_a_non_rtl_tcp_server():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def answer():
        conn, _ = lsock.accept()
        conn.sendall(b"HTTP/1.0 200")
        conn.close()

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    try:
        with pytest.raises(ConnectionError, match="not an rtl_tcp server"):
            rtl_tcp.RtlTcpSource("127.0.0.1", lsock.getsockname()[1],
                                 timeout=2.0)
    finally:
        t.join(timeout=2)
        lsock.close()


# ---- tests/test_sdr_ip.py ---------------------------------------------------

class TestSdrIpFraming:
    def test_header_roundtrip(self):
        for msg_type in range(8):
            for length in (2, 4, 100, 1028, 8191):
                msg = bytes([length & 0xFF,
                             ((length >> 8) & 0x1F) | (msg_type << 5)])
                assert sdr_ip.unpack_header(msg[0], msg[1]) == (msg_type,
                                                                length)

    def test_pack_frequency(self):
        assert sdr_ip.pack_frequency(20_000_000.0) == bytes(
            [0x0A, 0x00, 0x20, 0x00, 0x00, 0x00, 0x2D, 0x31, 0x01, 0x00])

    def test_pack_msg_rejects_oversize(self):
        with pytest.raises(ValueError):
            sdr_ip.pack_msg(0, b"\x00" * 8190)

    def test_cpx16_roundtrip(self):
        rng = np.random.default_rng(0)
        x = (rng.uniform(-0.9, 0.9, 256)
             + 1j * rng.uniform(-0.9, 0.9, 256)).astype(np.complex64)
        back = sdr_ip.decode_cpx16(sdr_ip.encode_cpx16(x))
        np.testing.assert_allclose(back.real, x.real, atol=1 / 32768)
        np.testing.assert_allclose(back.imag, x.imag, atol=1 / 32768)

    def test_swap_iq_on_wire(self):
        raw = sdr_ip.encode_cpx16(np.asarray([0.5 + 0.25j], np.complex64))
        q, i = struct.unpack("<hh", raw)
        assert i == pytest.approx(0.5 * 32768, abs=1)
        assert q == pytest.approx(0.25 * 32768, abs=1)


@pytest.mark.parametrize("native", [False, True])
def test_sdr_ip_control_and_stream(native):
    fs = 512_000
    src = SyntheticSource(fs, tones=((50_000.0, 0.5),))
    server = sdr_ip.SdrIpServer(src, name="SDR-IP", serial="XY99")
    server.start()
    try:
        client = sdr_ip.SdrIpSource("127.0.0.1", server.port, sample_rate=fs,
                                    center_freq_hz=14_100_000.0,
                                    native=native)
        assert (client._pump is not None) == native
        client.start()
        blk = client.read_block(4096)
        client.close()
        assert blk.shape == (4096,) and blk.dtype == np.complex64
        ref = np.exp(2j * np.pi * 50_000.0 * np.arange(4096) / fs)
        assert np.abs(np.vdot(ref, blk)) / 4096 == pytest.approx(0.5,
                                                                 rel=0.01)
        assert client.dropped_datagrams == 0
    finally:
        server.stop()


def test_sdr_ip_counts_every_datagram_sent(tmp_path):
    """A recording served in real time, read for 128 ms through the native
    pump and closed: the client counts as many datagrams as the server
    sent (the server acknowledges the stop after its last datagram, the
    pump drains its socket on close), none dropped, restarted or
    overrun."""
    from pebblesdr_tpu_torch.io import wav
    fs = 256_000
    path = str(tmp_path / "iq.wav")
    wav.write_iq_wav(path, np.full(fs // 2, 0.25 + 0.25j, np.complex64), fs)
    server = sdr_ip.SdrIpServer(sources.FileSource(path, pace=True))
    server.start()
    try:
        client = sdr_ip.SdrIpSource("127.0.0.1", server.port, sample_rate=fs,
                                    native=True)
        client.start()
        for _ in range(4):
            assert client.read_block(8192).shape == (8192,)
        client.close()
        c = client.counters
        assert c["datagrams"] == server.datagrams_sent >= 128
        assert (c["dropped_datagrams"], c["resyncs"], c["overruns"]) == (
            0, 0, 0)
    finally:
        server.stop()


def test_sdr_ip_native_is_the_automatic_choice():
    server = sdr_ip.SdrIpServer(SyntheticSource(100_000))
    server.start()
    try:
        client = sdr_ip.SdrIpSource("127.0.0.1", server.port,
                                    sample_rate=100_000)
        from pebblesdr_tpu_torch import runtime
        assert (client._pump is not None) == runtime.available()
        client.close()
    finally:
        server.stop()


def test_sdr_ip_discovery():
    server = sdr_ip.SdrIpServer(SyntheticSource(100_000), name="SDR-IP",
                                serial="SN42")
    try:
        server.enable_discovery(port=0)
        port = server._disc_sock.getsockname()[1]
        found = sdr_ip.discover(timeout=1.0, target_host="127.0.0.1",
                                request_port=port)
        assert any(d["name"] == "SDR-IP" and d["serial"] == "SN42"
                   and d["port"] == server.port for d in found)
    finally:
        server.stop()


# ---- tests/test_hpsdr.py ----------------------------------------------------

class TestHpsdrCodec:
    def test_frame_roundtrip(self):
        rng = np.random.default_rng(0)
        iq = (rng.uniform(-0.9, 0.9, 63)
              + 1j * rng.uniform(-0.9, 0.9, 63)).astype(np.complex64)
        mic = rng.uniform(-0.9, 0.9, 63).astype(np.float32)
        ctrl = bytes([0x00, 0x01, 0x02, 0x03, 0x04])
        frame = hpsdr.encode_frame(iq, ctrl, mic)
        assert len(frame) == 512 and frame[:3] == b"\x7f\x7f\x7f"
        c, iq2, mic2 = hpsdr.decode_frame(frame)
        assert c == ctrl
        np.testing.assert_allclose(iq2.real, iq.real, atol=2 / 8388607)
        np.testing.assert_allclose(iq2.imag, iq.imag, atol=2 / 8388607)
        np.testing.assert_allclose(mic2, mic, atol=2 / 32767)

    def test_24bit_sign_extension(self):
        iq = np.full(63, -0.999 - 0.999j, np.complex64)
        _, back, _ = hpsdr.decode_frame(hpsdr.encode_frame(iq))
        assert np.all(back.real < -0.99) and np.all(back.imag < -0.99)

    def test_bad_sync_rejected(self):
        with pytest.raises(ValueError):
            hpsdr.decode_frame(b"\x00" * 512)

    def test_freq_command_wire_format(self):
        c0, c1c4 = hpsdr.freq_command(7_040_000.0)
        assert c0 == 0x04 and struct.unpack(">I", c1c4)[0] == 7_040_000

    def test_config_command_speed_bits(self):
        for rate, speed in ((48_000, 0), (96_000, 1), (192_000, 2),
                            (384_000, 3)):
            c0, c1c4 = hpsdr.config_command(rate)
            assert c0 == 0x00 and c1c4[0] == speed
        assert hpsdr.config_command(48_000)[1][3] & hpsdr.C4_DUPLEX_ON

    def test_bandscope_frame_roundtrip(self):
        s = np.random.default_rng(1).uniform(-0.9, 0.9, 256).astype(
            np.float32)
        back = hpsdr.decode_bandscope_frame(hpsdr.encode_bandscope_frame(s))
        np.testing.assert_allclose(back, s, atol=2 / 32767)


def test_hpsdr_control_and_stream():
    fs = 192_000
    src = SyntheticSource(fs, tones=((21_000.0, 0.5),))
    server = hpsdr.HpsdrServer(src, fw_version=29, board_id=0x02)
    server.start()
    try:
        client = hpsdr.HpsdrSource("127.0.0.1", server.port, sample_rate=fs,
                                   center_freq_hz=7_040_000.0)
        assert client.fw_version == 29 and client.board_id == 0x02
        assert wait_for(lambda: src.get("center_freq_hz") == 7_040_000.0)
        assert src.get("sample_rate") == fs
        client.set_center_freq(14_100_000.0)
        assert wait_for(lambda: src.get("center_freq_hz") == 14_100_000.0)
        client.start()
        blk = client.read_block(4096)
        client.close()
        assert blk.shape == (4096,) and blk.dtype == np.complex64
        ref = np.exp(2j * np.pi * 21_000.0 * np.arange(4096) / fs)
        assert np.abs(np.vdot(ref, blk)) / 4096 == pytest.approx(0.5,
                                                                 rel=0.01)
        assert client.dropped_datagrams == 0
    finally:
        server.stop()


def test_hpsdr_bandscope_stream():
    fs = 192_000
    src = SyntheticSource(fs, tones=((21_000.0, 0.5),))
    server = hpsdr.HpsdrServer(src, pace=False)
    server.start()
    try:
        client = hpsdr.HpsdrSource("127.0.0.1", server.port, sample_rate=fs,
                                   center_freq_hz=7_040_000.0)
        client.start(bandscope=True)
        client.read_block(16384)
        bs = client.read_bandscope()
        client.close()
        assert len(bs) >= 4096 and bs.dtype == np.float32
        spec = hpsdr.bandscope_spectrum(bs, bins=1024)
        assert spec.shape == (1024,)
        peak = int(np.argmax(spec))
        assert abs(peak - round(21_000 / (fs / 2) * 1024)) <= 2
    finally:
        server.stop()


@pytest.mark.parametrize("n", [100, 2048, 5000])
def test_bandscope_spectrum_equals_jax(n):
    s = np.random.default_rng(n).uniform(-0.9, 0.9, n).astype(np.float32)
    np.testing.assert_array_equal(hpsdr.bandscope_spectrum(s, 1024, -3.0),
                                  jhpsdr.bandscope_spectrum(s, 1024, -3.0))


def test_hpsdr_discovery():
    server = hpsdr.HpsdrServer(SyntheticSource(100_000), fw_version=31,
                               board_id=0x05)
    server.start()
    try:
        found = hpsdr.discover(timeout=1.0, target_host="127.0.0.1",
                               port=server.port)
        assert any(d["fw_version"] == 31 and d["board_id"] == 0x05
                   and not d["sending"] for d in found)
    finally:
        server.stop()


# ---- the registry (tests/test_io.py, test_hpsdr.py, test_audio_iq.py) -----

def test_registry_builtin_sources():
    names = registry.available()
    assert {"file", "synthetic", "morsegen", "rtl_tcp", "sdr_ip", "hpsdr",
            "audio"} <= set(names)
    src = registry.create("synthetic", sample_rate=48_000,
                          tones=((1000.0, 0.5),))
    assert src.read_block(128).shape == (128,)


def test_registry_unknown_source():
    with pytest.raises(ValueError, match="unknown source"):
        registry.create("nonexistent")


def test_registry_reads_the_port_entry_point_group(monkeypatch):
    seen = []

    class EP:
        name = "thirdparty"

        @staticmethod
        def load():
            return SyntheticSource

    def entry_points(group):
        seen.append(group)
        return [EP()]

    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    monkeypatch.setattr(registry, "_eps_loaded", False)
    monkeypatch.setitem(registry._REGISTRY, "thirdparty", None)
    assert "thirdparty" in registry.available()
    assert seen == ["pebblesdr_tpu_torch.sources"]
    assert isinstance(registry.create("thirdparty", sample_rate=8000),
                      SyntheticSource)


# ---- ghpsdr3 (tests/test_io2.py) -------------------------------------------

class FakeDspServer:
    """A minimal ghpsdr3 dspserver: answers startaudiostream with a-law
    audio frames (a 440 Hz tone) and getspectrum with a spectrum frame."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.sock.settimeout(5.0)
        self.port = self.sock.getsockname()[1]
        self.commands = []
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self):
        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        t = np.arange(2000) / ghpsdr3.AUDIO_RATE
        tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        payload = alaw_compress(tone).tobytes()
        try:
            while True:
                cmd = conn.recv(64)
                if not cmd:
                    return
                text = cmd.rstrip(b"\0").decode(errors="replace")
                self.commands.append(text)
                if text.startswith("startaudiostream"):
                    for _ in range(4):
                        hdr = bytearray(ghpsdr3.HEADER_LEN)
                        hdr[0] = ghpsdr3.AUDIO_BUFFER
                        hdr[1:3] = struct.pack(">H", len(payload))
                        conn.sendall(bytes(hdr) + payload)
                elif text.startswith("getspectrum"):
                    spec = np.linspace(0, 120, 480).astype(np.uint8).tobytes()
                    hdr = bytearray(ghpsdr3.HEADER_LEN)
                    hdr[0] = ghpsdr3.SPECTRUM_BUFFER
                    hdr[1:3] = struct.pack(">H", len(spec))
                    hdr[9:13] = struct.pack(">I", 48000)
                    conn.sendall(bytes(hdr) + spec)
        except OSError:
            pass


def ghpsdr3_session(client_cls):
    srv = FakeDspServer()
    cli = client_cls("127.0.0.1", srv.port)
    cli.set_frequency(7_100_000)
    cli.set_mode("LSB")
    cli.set_filter(-2700, -300)
    cli.start_audio()
    audio = cli.read_audio(4000)
    cli.get_spectrum(480)
    assert wait_for(lambda: cli.last_spectrum is not None)
    spectrum, rate = cli.last_spectrum, cli.sample_rate
    cli.close()
    return srv, audio, spectrum, rate


def test_ghpsdr3_audio_roundtrip():
    srv, audio, spectrum, rate = ghpsdr3_session(ghpsdr3.Ghpsdr3Client)
    assert audio.shape == (4000,)
    tt = np.arange(4000) / ghpsdr3.AUDIO_RATE
    basis = np.stack([np.cos(2 * np.pi * 440 * tt),
                      np.sin(2 * np.pi * 440 * tt)])
    coef, *_ = np.linalg.lstsq(basis.T, audio, rcond=None)
    assert np.hypot(*coef) == pytest.approx(0.5, rel=0.05)
    assert any(c.startswith("attachreceiver") for c in srv.commands)
    assert "setfrequency 7100000" in srv.commands
    assert "setmode 0" in srv.commands and "setfilter -2700 -300" in \
        srv.commands
    assert spectrum.shape == (480,) and rate == 48000


def test_ghpsdr3_client_equals_jax():
    _, audio, spectrum, rate = ghpsdr3_session(ghpsdr3.Ghpsdr3Client)
    jsrv, jaudio, jspectrum, jrate = ghpsdr3_session(jghpsdr3.Ghpsdr3Client)
    np.testing.assert_array_equal(audio, jaudio)
    np.testing.assert_array_equal(spectrum, jspectrum)
    assert rate == jrate
