"""The port's native host runtime (pebblesdr_tpu_torch/runtime, built from
pebblesdr_tpu_torch/csrc/ring.cpp by kernels/build.py with the host's
g++): the library lies under build/kernels/ with a hashed name and flags
without -march=native, the JAX package's prebuilt library is never
loaded, a failed build raises with the compiler's stderr (also from
SdrIpSource(native=True)); the native decoders bit-equal to numpy and to
core.iqformat; then the cases of tests/test_runtime.py (ring semantics,
wire decode, the UDP pump) on the port.  Skips only where no g++ exists."""

import os
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from pebblesdr_tpu_torch import runtime
from pebblesdr_tpu_torch.core import iqformat
from pebblesdr_tpu_torch.kernels import build

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ on this machine")
REPO = str(Path(__file__).resolve().parents[1])


def raw_samples(fmt: str, n: int = 1000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if fmt == "f32":
        return rng.normal(size=2 * n).astype(np.float32)
    info = np.iinfo({"u8": np.uint8, "i8": np.int8, "u16": np.uint16,
                     "i16": np.int16}[fmt])
    return rng.integers(info.min, info.max, 2 * n, endpoint=True,
                        dtype=info.dtype)


# ---- the build -------------------------------------------------------------

def test_library_is_built_under_build_kernels():
    assert runtime.available()
    path = Path(runtime.library_path())
    assert path.parent == build.BUILD_DIR and path.exists()
    assert path.name.startswith("libring_") and path.suffix == ".so"
    assert path == build.host_library_path("ring")
    assert "-march=native" not in build.CXX_FLAGS
    assert path.parent.parts[-2:] == ("build", "kernels")


def test_the_jax_package_library_is_never_loaded():
    """In a fresh interpreter, the port's runtime maps its own library and
    not pebblesdr_tpu/runtime/libpebble_runtime.so."""
    code = ("from pebblesdr_tpu_torch import runtime\n"
            "ring = runtime.NativeRing(2, 4)\n"
            "assert ring.write(b'abcd', timeout_ms=10)\n"
            "print(runtime.library_path())\n"
            "print(open('/proc/self/maps').read())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lib, maps = proc.stdout.split("\n", 1)
    assert lib in maps and "libpebble_runtime" not in maps
    assert "pebblesdr_tpu/runtime" not in maps


@pytest.fixture
def broken_source(tmp_path, monkeypatch):
    """csrc/ring.cpp with a syntax error, the runtime unloaded."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    (copy / "ring.cpp").write_text((copy / "ring.cpp").read_text()
                                   + "\nthis is not C++;\n")
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_path", None)


def test_a_failed_build_raises_with_the_compiler_stderr(broken_source):
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for ring.cpp") as e:
        runtime.load()
    assert "this is not C++" in str(e.value) or "error" in str(e.value)
    assert not runtime.available()
    # the decoders fall back to numpy where the library cannot be built
    raw = raw_samples("i16")
    np.testing.assert_array_equal(
        runtime.decode_iq_planes(raw.tobytes(), "i16")[0],
        iqformat.decode_iq_host(raw.tobytes(), "i16").real)


def test_native_sdr_ip_source_raises_when_the_build_fails(broken_source):
    from pebblesdr_tpu_torch.io import sdr_ip
    from pebblesdr_tpu_torch.io.sources import SyntheticSource
    server = sdr_ip.SdrIpServer(SyntheticSource(100_000))
    server.start()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            sdr_ip.SdrIpSource("127.0.0.1", server.port, sample_rate=100_000,
                               native=True, timeout=2.0)
    finally:
        server.stop()


# ---- native decode against numpy ------------------------------------------

@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("fmt", ["u8", "i8", "i16", "u16", "f32"])
def test_native_decode_bit_equal_to_core_iqformat(fmt, swap):
    raw = raw_samples(fmt, 4096, seed=3).tobytes()
    planes = runtime.decode_iq_planes(raw, fmt, swap_iq=swap)
    ref = iqformat.decode_iq_host(raw, fmt, swap_iq=swap)
    np.testing.assert_array_equal(planes[0], ref.real)
    np.testing.assert_array_equal(planes[1], ref.imag)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("fmt", ["i16", "i8", "u8"])
def test_native_deint_i16_bit_equal_to_numpy(fmt, swap):
    raw = raw_samples(fmt, 4096, seed=4)
    x = raw.astype(np.int16)
    if fmt == "i8":
        x = x << 8
    elif fmt == "u8":
        x = (x - 128) << 8
    i, q = (x[1::2], x[0::2]) if swap else (x[0::2], x[1::2])
    np.testing.assert_array_equal(
        runtime.deint_iq_planes_i16(raw.tobytes(), fmt, swap_iq=swap),
        np.stack([i, q]))


# ---- tests/test_runtime.py on the port -------------------------------------

class TestNativeRing:
    def test_produce_consume_order(self):
        ring = runtime.NativeRing(4, 16)
        for i in range(4):
            assert ring.write(bytes([i] * 16), timeout_ms=100)
        assert ring.filled == 4
        for i in range(4):
            assert ring.read(timeout_ms=100) == bytes([i] * 16)
        assert ring.filled == 0

    def test_overrun_drops_oldest(self):
        ring = runtime.NativeRing(2, 4)
        assert ring.write(b"aaaa", timeout_ms=50)
        assert ring.write(b"bbbb", timeout_ms=50)
        assert ring.write(b"cccc", timeout_ms=50, drop_oldest=True)
        assert ring.overruns == 1
        assert ring.read(timeout_ms=50) == b"bbbb"
        assert ring.read(timeout_ms=50) == b"cccc"

    def test_read_timeout(self):
        assert runtime.NativeRing(2, 4).read(timeout_ms=30) is None

    def test_threaded_stream(self):
        ring = runtime.NativeRing(8, 8)
        n = 200
        got = []

        def producer():
            for i in range(n):
                ring.write(i.to_bytes(8, "little"), timeout_ms=-1,
                           drop_oldest=False)

        def consumer():
            for _ in range(n):
                got.append(int.from_bytes(ring.read(timeout_ms=2000),
                                          "little"))

        tp = threading.Thread(target=producer)
        tc = threading.Thread(target=consumer)
        tp.start()
        tc.start()
        tp.join(timeout=10)
        tc.join(timeout=10)
        assert got == list(range(n))
        assert ring.overruns == 0


class TestNativeDecode:
    @pytest.mark.parametrize("fmt", ["u8", "i8", "i16", "u16", "f32"])
    def test_matches_python_decoder(self, fmt):
        raw = raw_samples(fmt)
        planes = runtime.decode_iq_planes(raw.tobytes(), fmt)
        ref = iqformat.decode_iq_host(raw.tobytes(), fmt)
        np.testing.assert_allclose(planes[0], ref.real, atol=1e-6)
        np.testing.assert_allclose(planes[1], ref.imag, atol=1e-6)

    def test_swap_iq(self):
        raw = np.array([100, -200, 300, -400], dtype=np.int16)
        planes = runtime.decode_iq_planes(raw.tobytes(), "i16", swap_iq=True)
        np.testing.assert_allclose(planes[0] * 32768.0, [-200, -400])
        np.testing.assert_allclose(planes[1] * 32768.0, [100, 300])

    @pytest.mark.parametrize("fmt", ["i16", "i8", "u8"])
    def test_i16_passthrough_deinterleave(self, fmt):
        raw = raw_samples(fmt, seed=1)
        planes = runtime.deint_iq_planes_i16(raw.tobytes(), fmt)
        assert planes.dtype == np.int16 and planes.shape == (2, 1000)
        ref = runtime.decode_iq_planes(raw.tobytes(), fmt)
        np.testing.assert_allclose(planes.astype(np.float32) / 32768.0,
                                   ref, atol=1e-6)
        sw = runtime.deint_iq_planes_i16(raw.tobytes(), fmt, swap_iq=True)
        np.testing.assert_array_equal(sw[0], planes[1])

    def test_i16_passthrough_rejects_float(self):
        with pytest.raises(ValueError):
            runtime.deint_iq_planes_i16(b"\x00" * 8, "f32")


def send_datagram(port: int, seq: int, payload_i16: np.ndarray) -> None:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.sendto(bytes([0x04, 0x84]) + struct.pack("<H", seq & 0xFFFF)
             + payload_i16.astype("<i2").tobytes(), ("127.0.0.1", port))
    s.close()


class TestNativeUdpPump:
    def test_blocks_and_decode(self):
        pump = runtime.NativeUdpPump(port=0, header_bytes=4,
                                     seq_le16_offset=2, fmt="i16",
                                     block_samples=256, ring_buffers=8)
        try:
            vals = (np.arange(512) - 256).astype(np.int16)
            send_datagram(pump.port, 0, vals)
            planes = pump.read_planes(timeout_ms=3000)
            assert planes is not None and planes.shape == (2, 256)
            np.testing.assert_array_equal(
                planes[0], vals[0::2].astype(np.float32) / 32768.0)
            np.testing.assert_array_equal(
                planes[1], vals[1::2].astype(np.float32) / 32768.0)
            assert pump.counters["datagrams"] == 1
        finally:
            pump.close()

    def test_sequence_gap_zero_fill(self):
        pump = runtime.NativeUdpPump(port=0, header_bytes=4,
                                     seq_le16_offset=2, fmt="i16",
                                     block_samples=256, ring_buffers=16)
        try:
            ones = np.full(512, 16384, np.int16)
            send_datagram(pump.port, 0, ones)
            send_datagram(pump.port, 3, ones)  # drops seq 1, 2
            blocks = []
            for _ in range(4):
                b = pump.read_planes(timeout_ms=3000)
                assert b is not None
                blocks.append(b)
            assert pump.counters["dropped_datagrams"] == 2
            assert np.all(np.abs(blocks[0][0] - 0.5) < 1e-3)
            assert np.all(blocks[1][0] == 0.0)
            assert np.all(blocks[2][0] == 0.0)
            assert np.all(np.abs(blocks[3][0] - 0.5) < 1e-3)
        finally:
            pump.close()

    def test_sequence_restart_counted(self):
        """A gap of 1024 or more is a restart: counted in resyncs, neither
        zero-filled nor counted as dropped."""
        pump = runtime.NativeUdpPump(port=0, header_bytes=4,
                                     seq_le16_offset=2, fmt="i16",
                                     block_samples=256, ring_buffers=16)
        try:
            ones = np.full(512, 16384, np.int16)
            send_datagram(pump.port, 10, ones)
            send_datagram(pump.port, 10 + 1025, ones)   # 1024 missing
            assert all(pump.read_planes(timeout_ms=3000) is not None
                       for _ in range(2))
            assert pump.read_planes(timeout_ms=100) is None
            c = pump.counters
            assert (c["datagrams"], c["dropped_datagrams"], c["resyncs"]) \
                == (2, 0, 1)
        finally:
            pump.close()

    def test_close_drains_the_socket(self):
        """Datagrams sent before close() are all counted, read or not, and
        the counters stay readable after it."""
        pump = runtime.NativeUdpPump(port=0, header_bytes=4,
                                     seq_le16_offset=2, fmt="i16",
                                     block_samples=256, ring_buffers=64)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        payload = np.zeros(512, "<i2").tobytes()
        for seq in range(40):
            s.sendto(bytes([0x04, 0x84]) + struct.pack("<H", seq) + payload,
                     ("127.0.0.1", pump.port))
        s.close()
        pump.close()
        c = pump.counters
        assert (c["datagrams"], c["dropped_datagrams"], c["resyncs"]) \
            == (40, 0, 0)

    def test_stop_on_a_full_ring_counts_the_discarded_blocks(self):
        """No consumer: the ring's 4 slots fill, the pump waits for a free
        one (backpressure), and close() stops it there.  The block it held
        and the blocks of the datagrams drained after the stop find no
        slot: each is counted in 'discarded', so blocks in the ring +
        discarded = blocks sent."""
        pump = runtime.NativeUdpPump(port=0, header_bytes=4,
                                     seq_le16_offset=2, fmt="i16",
                                     block_samples=256, ring_buffers=4)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        payload = np.zeros(512, "<i2").tobytes()    # one block a datagram
        for seq in range(10):
            s.sendto(bytes([0x04, 0x84]) + struct.pack("<H", seq) + payload,
                     ("127.0.0.1", pump.port))
        s.close()
        time.sleep(0.3)          # the pump fills the ring and waits
        pump.close()
        c = pump.counters
        assert (c["datagrams"], c["dropped_datagrams"], c["overruns"]) \
            == (10, 0, 0)
        assert c["discarded"] == 10 - 4

    def test_throughput_headroom(self):
        """The pump drains loopback datagrams far faster than SDR-IP's
        2 Msps (~8 k datagrams/s): 2000 sent as fast as the loopback
        allows all arrive (no socket-buffer loss at an 8 MB rcvbuf)."""
        pump = runtime.NativeUdpPump(port=0, header_bytes=4,
                                     seq_le16_offset=2, fmt="i16",
                                     block_samples=4096, ring_buffers=256)
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            payload = np.zeros(512, "<i2").tobytes()
            n_dg = 2000
            t0 = time.perf_counter()
            for seq in range(n_dg):
                s.sendto(bytes([0x04, 0x84]) + struct.pack("<H", seq & 0xFFFF)
                         + payload, ("127.0.0.1", pump.port))
            send_dt = time.perf_counter() - t0
            s.close()
            got = 0
            while got < n_dg * 256 // 4096:
                if pump.read_planes(timeout_ms=2000) is None:
                    break
                got += 1
            c = pump.counters
            assert c["datagrams"] + c["dropped_datagrams"] >= n_dg * 0.99, c
            assert n_dg / send_dt > 8000
        finally:
            pump.close()
