"""The port's audio sinks (pebblesdr_tpu_torch/io/audio_out.py: null,
WAV, pipe, the ctypes PortAudio sink, PacedOutput's latency, underrun and
overrun accounting, the factory) and the soundcard IQ source (io/
audio_iq.py: AudioIqSource over a WavStream, the PortAudio input stream):
the WAV and pipe bytes and the IQ blocks equal to the JAX package's for
the same input, then the cases of tests/test_audio_out.py, test_io2.py
(the sinks) and test_audio_iq.py on the port, the last one demodulating
the soundcard stream with the port's Receiver on the CPU."""

import ctypes.util
import json
import time

import numpy as np
import pytest
import torch

from pebblesdr_tpu.io import audio_iq as jaudio_iq
from pebblesdr_tpu.io import audio_out as jaudio_out
from pebblesdr_tpu_torch.io import audio_out, registry
from pebblesdr_tpu_torch.io.audio_iq import AudioIqSource, WavStream

HAS_PORTAUDIO = ctypes.util.find_library("portaudio") is not None


def tone_frames(fs=96000, f=12000.0, secs=0.25, phase=0.0):
    t = np.arange(int(fs * secs)) / fs
    return np.stack([np.cos(2 * np.pi * f * t + phase),
                     np.sin(2 * np.pi * f * t + phase)], axis=1).astype(
        np.float32)


def peak_freq(iq, fs):
    sp = np.abs(np.fft.fft(iq * np.hanning(len(iq))))
    return np.fft.fftfreq(len(iq), 1 / fs)[np.argmax(sp)]


# ---- parity with the JAX package -------------------------------------------

def test_wav_sink_bytes_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    blocks = [rng.uniform(-1, 1, 480).astype(np.float32) for _ in range(3)]
    for mod, name in ((audio_out, "t.wav"), (jaudio_out, "j.wav")):
        out = mod.factory("wav", path=str(tmp_path / name))
        out.start(48000)
        out.send(blocks[0], gain=0.5)
        out.send(blocks[1], mute=True)
        out.send(blocks[2])
        out.stop()
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("channels", [1, 2])
def test_pipe_sink_bytes_equal_to_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (480,) if channels == 1 else (2, 480)
    blocks = [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(3)]
    for mod, name in ((audio_out, "t.raw"), (jaudio_out, "j.raw")):
        out = mod.factory("pipe", command=["dd", f"of={tmp_path / name}",
                                           "status=none"])
        out.start(48000, channels)
        out.send(blocks[0], gain=0.25)
        out.send(blocks[1], mute=True)
        out.send(blocks[2])
        out.stop()
    t, j = (tmp_path / "t.raw").read_bytes(), (tmp_path / "j.raw").read_bytes()
    assert t == j and len(t) == 3 * 480 * channels * 4


@pytest.mark.parametrize("order", ["iq", "qi", "i", "q"])
@pytest.mark.parametrize("balance", [False, True])
def test_audio_iq_blocks_equal_to_jax(order, balance):
    rng = np.random.default_rng(5)
    frames = rng.uniform(-1, 1, (5000, 2)).astype(np.float32)
    kw = dict(sample_rate=48000, order=order, gain=0.7, balance_gain=1.05,
              balance_phase=-0.02, apply_balance=balance)
    ours = AudioIqSource(stream_factory=lambda: WavStream(frames), **kw)
    theirs = jaudio_iq.AudioIqSource(
        stream_factory=lambda: jaudio_iq.WavStream(frames), **kw)
    for n in (1000, 3000, 2500):
        np.testing.assert_array_equal(ours.read_block(n),
                                      theirs.read_block(n))


def test_wavstream_equals_jax_at_the_end():
    frames = np.arange(200, dtype=np.float32).reshape(100, 2)
    ours, theirs = WavStream(frames, loop=False), jaudio_iq.WavStream(
        frames, loop=False)
    for n in (64, 64, 64):
        a, b = ours.read(n), theirs.read(n)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ---- tests/test_audio_out.py on the port -----------------------------------

class TestPacedOutput:
    def test_drains_at_the_audio_clock(self):
        inner = audio_out.NullOutput()
        out = audio_out.PacedOutput(inner, max_latency_s=1.0, chunk_s=0.02)
        out.start(48000)
        try:
            out.send(np.zeros(12000, np.float32))  # 0.25 s of audio
            t0 = time.monotonic()
            while out.latency_s > 0 and time.monotonic() - t0 < 2.0:
                time.sleep(0.01)
            drained = time.monotonic() - t0
            assert 0.1 < drained < 0.6, drained
            assert inner.samples_sent >= 12000
            assert out.overruns == 0
        finally:
            out.stop()

    def test_underruns_counted_and_clock_keeps_running(self):
        inner = audio_out.NullOutput()
        out = audio_out.PacedOutput(inner, chunk_s=0.02)
        out.start(48000)
        try:
            time.sleep(0.15)  # starve the consumer
            assert out.underruns >= 3
            assert inner.samples_sent > 0  # silence kept the clock running
        finally:
            out.stop()

    def test_overrun_drops_oldest(self):
        inner = audio_out.NullOutput()
        out = audio_out.PacedOutput(inner, max_latency_s=0.1, chunk_s=0.02)
        out.start(48000)
        try:
            for _ in range(10):  # 10 x 0.1 s >> the 0.1 s latency bound
                out.send(np.zeros(4800, np.float32))
            assert out.overruns > 0
            assert out.latency_s <= 0.15
        finally:
            out.stop()

    def test_stereo_underrun_silence_keeps_the_frame_layout(self):
        inner = audio_out.NullOutput()
        out = audio_out.PacedOutput(inner, chunk_s=0.02)
        out.start(48000, channels=2)
        try:
            out.send(np.ones((2, 480), np.float32))
            time.sleep(0.1)
            assert out.underruns >= 1 and inner.samples_sent >= 480
        finally:
            out.stop()

    def test_factory_paced(self):
        out = audio_out.factory("null", paced=True)
        assert isinstance(out, audio_out.PacedOutput)
        out.start(48000)
        out.send(np.zeros(480, np.float32))
        out.stop()
        assert out.inner.samples_sent >= 480


class TestPortAudioOutput:
    def test_factory_builds_device_sink(self):
        assert isinstance(audio_out.factory("device"),
                          audio_out.PortAudioOutput)

    def test_device_sink(self):
        """With libportaudio: open, write and close the default stream.
        Without it: a clear RuntimeError naming the alternatives."""
        out = audio_out.PortAudioOutput()
        if HAS_PORTAUDIO:
            out.start(48000)
            out.send(np.zeros(4800, np.float32))
            out.stop()
        else:
            with pytest.raises(RuntimeError, match="libportaudio"):
                out.start(48000)


def test_cli_pipe_sink_streams_pcm(tmp_path, capsys):
    """--audio-out pipe:<cmd>: the port's CLI streams float32 PCM through
    the paced consumer into the command's stdin."""
    from pebblesdr_tpu_torch.serve.cli import main

    sink = tmp_path / "pcm.raw"
    rc = main(["--synthetic", "am", "--mode", "AM", "--tune", "250000",
               "--seconds", "0.3", "--frames", "8192", "--json",
               "--device", "cpu",
               "--audio-out", f"pipe:dd of={sink} status=none"])
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["audio_sink"]["kind"].startswith("pipe:")
    assert metrics["audio_sink"]["overruns"] == 0
    data = np.frombuffer(sink.read_bytes(), "<f4")
    assert len(data) > 4800 and np.abs(data).max() > 0.01


# ---- tests/test_io2.py TestAudioOut on the port ---------------------------

def test_wav_sink(tmp_path):
    p = str(tmp_path / "out.wav")
    out = audio_out.factory("wav", path=p)
    out.start(48000)
    out.send(np.ones(480, np.float32) * 0.25)
    out.send(np.ones(480, np.float32), mute=True)
    out.stop()
    with open(p, "rb") as f:
        assert f.read(4) == b"RIFF"


def test_null_sink_counts():
    out = audio_out.factory("null")
    out.start(48000)
    out.send(np.zeros(100, np.float32))
    assert out.samples_sent == 100


def test_factory_rejects_unknown():
    with pytest.raises(ValueError):
        audio_out.factory("bogus")


# ---- tests/test_audio_iq.py on the port ------------------------------------

class TestAudioIqSource:
    def test_tone_loopback(self):
        fs, f = 96000, 12000.0
        src = AudioIqSource(sample_rate=fs, stream_factory=lambda: WavStream(
            tone_frames(fs, f)))
        blk = src.read_block(8192)
        assert blk.dtype == np.complex64 and len(blk) == 8192
        assert abs(peak_freq(blk, fs) - f) < fs / 8192 * 2
        assert abs(np.abs(blk).mean() - 1.0) < 1e-3

    def test_order_swap_mirrors_spectrum(self):
        fs, f = 96000, 12000.0
        src = AudioIqSource(sample_rate=fs, order="qi",
                            stream_factory=lambda: WavStream(
                                tone_frames(fs, f)))
        assert abs(peak_freq(src.read_block(8192), fs) + f) < fs / 8192 * 2

    def test_i_only_and_q_only(self):
        frames = tone_frames(96000, 8000.0)
        for order in ("i", "q"):
            src = AudioIqSource(sample_rate=96000, order=order,
                                stream_factory=lambda: WavStream(frames))
            blk = src.read_block(4096)
            assert np.allclose(blk.real, blk.imag)

    def test_gain_and_balance(self):
        fs = 96000
        src = AudioIqSource(sample_rate=fs, gain=0.5, balance_gain=1.1,
                            balance_phase=0.02, apply_balance=True,
                            stream_factory=lambda: WavStream(
                                tone_frames(fs, 5000.0)))
        blk = src.read_block(4096)
        raw = tone_frames(fs, 5000.0)[:4096] * 0.5
        np.testing.assert_allclose(blk.real, raw[:, 0], atol=1e-6)
        np.testing.assert_allclose(blk.imag, raw[:, 1] * 1.1
                                   + raw[:, 0] * 0.02, atol=1e-6)

    def test_standard_keys_surface(self):
        src = AudioIqSource(sample_rate=48000, stream_factory=lambda:
                            WavStream(np.zeros((64, 2), np.float32)))
        assert src.get("iq_order") == "iq"
        src.set("iq_balance_gain", 1.05)
        src.set("iq_balance_phase", -0.01)
        assert src.get("iq_balance_gain") == 1.05
        assert src.get("iq_balance_phase") == -0.01
        with pytest.raises(ValueError):
            src.set("iq_order", "bogus")

    def test_registry_create(self):
        src = registry.create("audio", sample_rate=48000,
                              stream_factory=lambda: WavStream(
                                  np.zeros((256, 2), np.float32)))
        assert isinstance(src, AudioIqSource)
        assert "audio" in registry.available()

    def test_wavstream_end_of_stream(self):
        src = AudioIqSource(sample_rate=48000, stream_factory=lambda:
                            WavStream(np.ones((100, 2), np.float32),
                                      loop=False))
        assert len(src.read_block(64)) == 64
        b2 = src.read_block(64)  # only 36 left
        assert b2 is None or len(b2) <= 36
        assert src.read_block(64) is None

    def test_missing_portaudio_is_clear(self):
        if HAS_PORTAUDIO:
            pytest.skip("libportaudio present on this host")
        with pytest.raises(RuntimeError, match="portaudio"):
            AudioIqSource(sample_rate=48000)

    def test_chain_demodulates_audio_iq(self):
        """An AM station synthesized as the stereo capture stream
        demodulates end to end through the port's Receiver on the CPU."""
        from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
        from pebblesdr_tpu_torch.demod.modes import DemodMode

        fs = 256_000
        t = np.arange(fs) / fs
        env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
        iq = 0.5 * env * np.exp(2j * np.pi * 40_000.0 * t)
        frames = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
        src = AudioIqSource(sample_rate=fs,
                            stream_factory=lambda: WavStream(frames))
        cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=16384,
                             mode=DemodMode.AM, agc_mode="off")
        rx = Receiver(cfg, "cpu")
        state, params = rx.init_state(), rx.default_params(40_000.0)
        outs = []
        for blk in src.blocks(16384, max_blocks=12):
            plane = torch.from_numpy(np.stack([blk.real, blk.imag], axis=1))
            state, out = rx.step(state, params, plane)
            outs.append(out["audio"][0].numpy())
        audio = np.concatenate(outs, axis=-1)
        tail = audio[len(audio) // 2:]
        tt = np.arange(len(tail)) / cfg.audio_rate
        a = np.stack([np.sin(2 * np.pi * 1000 * tt),
                      np.cos(2 * np.pi * 1000 * tt)], 1)
        c, *_ = np.linalg.lstsq(a, tail, rcond=None)
        assert np.hypot(c[0], c[1]) > 0.15
