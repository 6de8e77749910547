"""The port's host modules against their JAX package originals, on the CPU:
io/wav.py and io/sources.py give bit-equal output on the same numpy input,
utils/settings.py reads the same station list and presets, and
utils/perform.py keeps the JAX package's statistics."""

import dataclasses

import numpy as np
import pytest

from pebblesdr_tpu.io import sources as jsources
from pebblesdr_tpu.io import wav as jwav
from pebblesdr_tpu.utils import perform as jperform
from pebblesdr_tpu.utils import settings as jsettings
from pebblesdr_tpu_torch.io import sources, wav
from pebblesdr_tpu_torch.utils import perform, settings


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("fmt", ["f32", "i16"])
def test_iq_wav_bytes_and_read_match_jax(tmp_path, fmt):
    iq = _iq(5001, 1)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    jwav.write_iq_wav(str(a), iq, 2_048_000, fmt=fmt, center_freq_hz=1.5e6,
                      demod_mode="AM")
    wav.write_iq_wav(str(b), iq, 2_048_000, fmt=fmt, center_freq_hz=1.5e6,
                     demod_mode="AM")
    assert a.read_bytes() == b.read_bytes()
    ja, ji = jwav.read_iq_wav(str(a))
    ta, ti = wav.read_iq_wav(str(a))
    assert np.array_equal(ja, ta) and ja.dtype == ta.dtype
    assert dataclasses.asdict(ji) == dataclasses.asdict(ti)
    assert ti.center_freq_hz == 1.5e6 and ti.demod_mode == "AM"


@pytest.mark.parametrize("shape", [(3001,), (2, 3001)])
def test_audio_wav_bytes_match_jax(tmp_path, shape):
    audio = np.random.default_rng(2).uniform(-1.2, 1.2, shape).astype(
        np.float32)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    jwav.write_audio_wav(str(a), audio, 48000)
    wav.write_audio_wav(str(b), audio, 48000)
    assert a.read_bytes() == b.read_bytes()


def test_u8_wav_reads_like_jax(tmp_path):
    """An 8-bit unsigned IQ file (written by hand): both readers agree."""
    import struct
    raw = np.random.default_rng(3).integers(0, 256, 2 * 777, np.uint8)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16)
            + struct.pack("<HHIIHH", 1, 2, 250000, 500000, 2, 8)
            + b"data" + struct.pack("<I", raw.size) + raw.tobytes())
    p = tmp_path / "u8.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    (ja, ji), (ta, ti) = jwav.read_iq_wav(str(p)), wav.read_iq_wav(str(p))
    assert np.array_equal(ja, ta) and ti.fmt == ji.fmt == "u8"


def _blocks(src, ns):
    return [src.read_block(n) for n in ns]


@pytest.mark.parametrize("make", [
    lambda m, fs: m.SyntheticSource(fs, tones=((1e5, 0.5), (-2e5, 0.2)),
                                    noise_db=-40.0, seed=4),
    lambda m, fs: m.SyntheticSource(fs),
    lambda m, fs: m.MorseGenSource(fs, noise_db=-50.0),
    lambda m, fs: m.MorseGenSource.from_scenario("fading", fs, seed=2),
    lambda m, fs: m.MorseGenSource.from_scenario("ladder", fs)],
    ids=["synthetic", "synthetic-default", "morsegen", "fading", "ladder"])
def test_sources_match_jax(make):
    fs = 250_000
    ns = (4096, 1000, 8192)
    for a, b in zip(_blocks(make(jsources, fs), ns),
                    _blocks(make(sources, fs), ns)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_morse_envelope_matches_jax():
    a = jsources.morse_envelope("cq de pebble 73 ?", 25.0, 8000.0)
    b = sources.morse_envelope("cq de pebble 73 ?", 25.0, 8000.0)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("pace", [False, True])
def test_file_source_matches_jax(tmp_path, pace):
    """Playback loops over the end of the file, as the JAX source does."""
    p = str(tmp_path / "x.wav")
    wav.write_iq_wav(p, _iq(3000, 5), 8_000_000, center_freq_hz=7.1e6,
                     demod_mode="LSB")
    js = jsources.FileSource(p, pace=pace)
    ts = sources.FileSource(p, pace=pace)
    assert dataclasses.asdict(js.info) == dataclasses.asdict(ts.info)
    for n in (1000, 2500, 7000, 10):
        assert np.array_equal(js.read_block(n), ts.read_block(n))
    once = sources.FileSource(p, loop=False)
    assert once.read_block(2000) is not None and once.read_block(2000) is None


def test_station_list_and_presets_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PEBBLESDR_STATIONS", str(tmp_path / "none.csv"))
    ja, ta = jsettings.load_stations(), settings.load_stations()
    assert [dataclasses.asdict(p) for p in ja] == \
        [dataclasses.asdict(p) for p in ta]
    assert len(ta) > 10
    near_j = jsettings.stations_near(ja, 10e6, 2e6)
    near_t = settings.stations_near(ta, 10e6, 2e6)
    assert [p.name for p in near_j] == [p.name for p in near_t]
    path = str(tmp_path / "p.csv")
    settings.save_presets_csv(path, ta[:5])
    assert [dataclasses.asdict(p) for p in jsettings.load_presets_csv(path)] \
        == [dataclasses.asdict(p) for p in settings.load_presets_csv(path)]


def test_settings_round_trip(tmp_path):
    path = str(tmp_path / "s" / "settings.json")
    s = settings.Settings(path)
    s.set("last_mode", "USB")
    s.device_settings("file")["pace"] = True
    s.write()
    assert jsettings.Settings(path).get("last_mode") == "USB"
    assert settings.Settings(path).device_settings("file") == {"pace": True}


def test_perform_stats_match_jax():
    jp, tp_ = jperform.Perform(), perform.Perform("cpu")
    for xs in ([0.002, 0.004, 0.003, 0.005],):
        jp.samples["step"] = list(xs)
        tp_.samples["step"] = list(xs)
    assert jp.stats("step") == tp_.stats("step")
    assert jp.report() == tp_.report()
    with tp_.measure("x"):
        pass
    assert tp_.stats("x")["n"] == 1
