"""The port's terminal display (pebblesdr_tpu_torch/serve/display.py) and
the helpers it rests on (ops/spectrum.py power_spectrum, map_to_screen,
Waterfall; core/db.py) against the JAX package's on the CPU: map_to_screen,
the Waterfall image and TerminalDisplay.frame equal on the same numpy row
(a max: no rounding); the dB helpers within float32 rounding;
power_spectrum's overload flags equal and its dB within 1e-3 over the bins
within 60 dB of the peak (over 100 dB the two packages' float32 DFT
matmuls round apart by 0.15 dB, and each is held to a float64 DFT within
0.2 dB there).  Then the cases of tests/test_display.py and test_io.py's
TestWaterfall on the port."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.core import db as jdb
from pebblesdr_tpu.ops import spectrum as jspectrum
from pebblesdr_tpu.serve import display as jdisplay
from pebblesdr_tpu_torch.core import db
from pebblesdr_tpu_torch.ops import spectrum
from pebblesdr_tpu_torch.serve import display


def db_rows(c: int, bins: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (-120.0 + 100.0 * rng.random((c, bins))).astype(np.float32)


def spectrum_input(n: int, seed: int) -> np.ndarray:
    """A tone 6 dB below full scale, noise near -70 dB, and one channel
    past full scale (the overload flag)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.5 * np.exp(2j * np.pi * 0.1 * t)[None] + 1e-3 * (
        rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    x[2, 5] = 1.5
    return x.astype(np.complex64)


# ---- parity with the JAX package -------------------------------------------

@pytest.mark.parametrize("bins,pixels", [(2048, 128), (2048, 64),
                                         (1024, 96), (96, 96)])
def test_map_to_screen_equals_jax(bins, pixels):
    if bins % pixels:
        pixels = display.pick_width(bins, pixels)
    rows = db_rows(3, bins, bins)
    np.testing.assert_array_equal(
        spectrum.map_to_screen(torch.from_numpy(rows), pixels).numpy(),
        np.asarray(jspectrum.map_to_screen(jnp.asarray(rows), pixels)))


def test_waterfall_image_equals_jax():
    ours, theirs = spectrum.Waterfall(64, depth=8), jspectrum.Waterfall(
        64, depth=8)
    for i, row in enumerate(db_rows(5, 2048, 1)):
        ours.push(torch.from_numpy(row) if i % 2 else row)
        theirs.push(row)
    np.testing.assert_array_equal(ours.image, theirs.image)


@pytest.mark.parametrize("mode", ["waterfall", "spectrum"])
@pytest.mark.parametrize("color", [False, True])
def test_terminal_display_frames_equal_jax(mode, color):
    kw = dict(mode=mode, width=96, height=8, color=color)
    ours, theirs = display.TerminalDisplay(**kw), jdisplay.TerminalDisplay(**kw)
    sm = {"signal_db": -61.3, "snr_db": 27.5}
    for i, row in enumerate(db_rows(3, 2048, 2)):
        a = ours.frame(row, sm if i else None, center_hz=7.1e6,
                       span_hz=2.048e6)
        b = theirs.frame(row, sm if i else None, center_hz=7.1e6,
                         span_hz=2.048e6)
        assert a == b


@pytest.mark.parametrize("n", [2048, 8192])
def test_power_spectrum_matches_jax(n):
    x = spectrum_input(n, n)
    w, cg = spectrum.make_window(n)
    got, over = spectrum.power_spectrum(torch.from_numpy(x),
                                        torch.from_numpy(w), cg, -3.0)
    want, jover = jspectrum.power_spectrum(jnp.asarray(x), jnp.asarray(w),
                                           cg, -3.0)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    assert over.numpy().tolist() == [False, False, True]
    near = want > want.max(-1, keepdims=True) - 60.0
    assert np.abs(got - want)[near].max() <= 1e-3
    # over 100 dB: each package against a float64 DFT
    xw = x.astype(np.complex128) * w
    ref = 10 * np.log10(np.fft.fftshift(np.abs(np.fft.fft(xw)) ** 2, -1)
                        / (n * cg) ** 2) - 3.0
    wide = want > want.max(-1, keepdims=True) - 100.0
    for ours in (got, want):
        assert np.abs(ours - ref)[wide].max() <= 0.2


def test_db_helpers_match_jax():
    v = np.array([-250.0, -130.0, -73.0, -12.5, 0.0, 3.0], np.float32)
    amp = np.array([0.0, 1e-12, -0.5, 0.5, 2.0], np.float32)
    pairs = ((db.db_to_power(v), jdb.db_to_power(v)),
             (db.db_to_amplitude(v), jdb.db_to_amplitude(v)),
             (db.amplitude_to_db(amp), jdb.amplitude_to_db(amp)),
             (db.clip_db(v), jdb.clip_db(v)),
             (db.clip_db(v, -100.0, -20.0), jdb.clip_db(v, -100.0, -20.0)),
             (db.power_to_db(torch.from_numpy(np.abs(amp))),
              jdb.power_to_db(np.abs(amp))))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for s in (-127.0, -73.0, -13.0):
        assert db.db_to_s_units(s) == float(jdb.db_to_s_units(s))
    assert (db.S9_DBM, db.DB_PER_S_UNIT) == (jdb.S9_DBM, jdb.DB_PER_S_UNIT)


# ---- tests/test_display.py on the port -------------------------------------

def test_pick_width():
    assert display.pick_width(2048, 128) == 128
    assert display.pick_width(2048, 100) == 64
    assert display.pick_width(100, 128) == 100
    assert display.pick_width(7, 4) == 1


def test_waterfall_row_mono():
    row = display.waterfall_row(np.linspace(-130, -20, 64), color=False)
    assert len(row) == 64 and row[0] == " " and row[-1] == "@"


def test_waterfall_row_ansi():
    row = display.waterfall_row(np.full(8, -75.0), color=True)
    assert row.count("\x1b[48;5;") == 8 and row.endswith("\x1b[0m")


def test_spectrum_panel_shape_and_peak():
    db_row = np.full(32, -130.0)
    db_row[10] = -20.0
    rows = display.spectrum_panel(db_row, height=8)
    assert len(rows) == 8 and all(len(r) == 32 for r in rows)
    assert rows[0][10] == "█" and rows[0][0] == " "


def test_smeter_labels():
    assert display.smeter_bar(-73.0).startswith("S9")
    assert display.smeter_bar(-73.0 + 20.0).startswith("S9+20")
    assert display.smeter_bar(-73.0 - 12.0).startswith("S7")
    assert "SNR  12.0 dB" in display.smeter_bar(-73.0, 12.0)


def test_freq_axis():
    ax = display.freq_axis(100e6, 2e6, 80)
    assert "99MHz" in ax and "101MHz" in ax


def test_terminal_display_frames():
    d = display.TerminalDisplay(mode="spectrum", width=64, height=6,
                                color=False)
    row = np.full(2048, -120.0)
    first = d.frame(row, {"signal_db": -60.0, "snr_db": 30.0},
                    center_hz=1e6, span_hz=2e6)
    assert "\x1b[" not in first.split("\n")[0]
    assert d.frame(row, None).startswith("\x1b[")


def test_terminal_display_waterfall_axis_once():
    d = display.TerminalDisplay(mode="waterfall", width=64, color=False)
    row = np.full(1024, -100.0)
    f1 = d.frame(row, None, center_hz=0.0, span_hz=1e6)
    f2 = d.frame(row, None, center_hz=0.0, span_hz=1e6)
    assert "kHz" in f1 and "kHz" not in f2


def test_terminal_display_takes_a_tensor_row():
    d1 = display.TerminalDisplay(mode="waterfall", width=64, color=False)
    d2 = display.TerminalDisplay(mode="waterfall", width=64, color=False)
    row = db_rows(1, 2048, 3)[0]
    assert d1.frame(torch.from_numpy(row)) == d2.frame(row)


def test_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        display.TerminalDisplay(mode="oscilloscope")


def test_cli_waterfall_smoke(capsys):
    from pebblesdr_tpu_torch.serve.cli import main

    rc = main(["--synthetic", "am", "--mode", "AM", "--tune", "250000",
               "--seconds", "0.1", "--frames", "8192", "--display",
               "waterfall", "--json", "--device", "cpu"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln]
    json.loads(lines[-1])
    assert any("MHz" in ln or "kHz" in ln for ln in lines)


# ---- tests/test_io.py TestWaterfall on the port ----------------------------

def test_waterfall_rolls():
    wf = spectrum.Waterfall(n_pixels=64, depth=4)
    for level in [-100.0, -50.0, -20.0]:
        wf.push(np.full(2048, level, np.float32))
    img = wf.image
    assert img.shape == (4, 64)
    assert img[-1, 0] == -20.0 and img[-2, 0] == -50.0
    assert img[0, 0] == -160.0  # unfilled
