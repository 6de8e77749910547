"""The port's control surface (pebblesdr_tpu_torch/serve/control.py) on
the port's Receiver, on the CPU: the same key script (tune, step, m, a,
[ / ], s, g, space, p, n / N with presets, z, q) driven through the port's
ControlSurface and the JAX package's, the events, tune, bandpass, every
RxParams field and the levels equal after each key, and the port's
parameter updates tensors on the receiver's device, a mode or AGC change
a new Receiver there.  Then the cases of tests/test_control.py on the
port (its CLI runs with --device cpu)."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from pebblesdr_tpu.chain.receiver import Receiver as JReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JReceiverConfig
from pebblesdr_tpu.demod.modes import DemodMode as JDemodMode
from pebblesdr_tpu.serve import control as jcontrol
from pebblesdr_tpu.utils.settings import Preset as JPreset
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.serve.control import (ControlSurface, ScriptedKeys,
                                               TtyKeys, parse_keys)
from pebblesdr_tpu_torch.utils.settings import Preset

FS, N = 2_048_000, 32768
# tune, step, bandwidth, squelch, gain, mute, snap, presets (one with a
# mode change), display cycle, mode and AGC rebuilds, quit
SCRIPT = ("\x1b[C\x1b[C\x1b[A\x1b[D\x1b[B[[]ssSgGg  pnnnNzzz"
          "maM]\x1b[Cq")
PRESETS = (("alpha", 100_000.0, "AM"), ("bravo", 300_000.0, "USB"),
           ("charlie", -150_000.0, ""))


def make_surface(mode=DemodMode.AM, tune=250_000.0, fs=FS, n=N, **kw):
    rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                 mode=mode), "cpu")
    return ControlSurface(rx, rx.default_params(tune), tune, **kw)


def params_equal(tp, jp) -> None:
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(getattr(tp, f.name).numpy(),
                                      np.asarray(getattr(jp, f.name)),
                                      err_msg=f.name)


def test_key_script_matches_jax():
    fs, n = 512_000, 8192
    rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                 mode=DemodMode.AM), "cpu")
    jrx = JReceiver(JReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                    mode=JDemodMode.AM))
    ours = ControlSurface(rx, rx.default_params(50_000.0), 50_000.0,
                          squelch_db=-20.0, gain=0.5,
                          presets=[Preset(*p) for p in PRESETS])
    theirs = jcontrol.ControlSurface(
        jrx, jrx.default_params(50_000.0), 50_000.0, squelch_db=-20.0,
        gain=0.5, presets=[JPreset(*p) for p in PRESETS])
    row = np.full(2048, -120.0, np.float32)
    row[300] = -30.0          # a station at -181 kHz for 'p'
    ours.note_spectrum(torch.from_numpy(row))
    theirs.note_spectrum(row)
    resets = 0
    for key in parse_keys(SCRIPT):
        assert ours.handle(key) == theirs.handle(key), key
        r = ours.take_reset()
        assert r == theirs.take_reset(), key
        resets += r
        assert (ours.tune, ours.step, ours.mode.value, ours.agc,
                ours.squelch_db, ours.gain, ours.mute, ours.display,
                ours.bp_lo, ours.bp_hi, ours.quit) == (
            theirs.tune, theirs.step, theirs.mode.value, theirs.agc,
            theirs.squelch_db, theirs.gain, theirs.mute, theirs.display,
            theirs.bp_lo, theirs.bp_hi, theirs.quit), key
        params_equal(ours.params, theirs.params)
        assert all(t.device == ours.rx.device for t in
                   dataclasses.astuple(ours.params))
        assert ours.rx.cfg.mode.value == theirs.rx.cfg.mode.value
    assert ours.events == theirs.events and ours.quit and resets == 5
    assert any(e.startswith("SNAP") for e in ours.events)
    assert any(e.startswith("PRESET bravo") for e in ours.events)


def test_rebuild_keeps_the_device_and_the_cli_overrides():
    s = make_surface(fs=512_000, n=8192, iq_static=(1.05, 0.02),
                     bandpass=(-3000.0, 3000.0), squelch_db=-10.0)
    s.handle("m")
    assert s.take_reset() and s.rx.device == torch.device("cpu")
    assert isinstance(s.rx, Receiver) and s.rx.cfg.mode == DemodMode.SAM
    assert float(s.params.iq_gain) == pytest.approx(1.05)
    assert float(s.params.iq_phase) == pytest.approx(0.02)
    assert float(s.params.squelch_db) == -10.0
    assert (s.bp_lo, s.bp_hi) == (-3000.0, 3000.0)
    torch.testing.assert_close(s.params.bp_mask,
                               s.rx.make_bandpass(-3000.0, 3000.0)[0])


def test_note_spectrum_takes_the_one_row():
    s = make_surface(fs=512_000, n=8192)
    row = torch.linspace(-120.0, -60.0, 2048)
    s.note_spectrum(row)
    np.testing.assert_array_equal(s._last_spectrum, row.numpy())


# ---- tests/test_control.py on the port -------------------------------------

class TestKeyParsing:
    def test_arrows_and_chars(self):
        assert parse_keys("\x1b[C\x1b[Dmq \x1b[A") == [
            "right", "left", "m", "q", " ", "up"]

    def test_scripted_source_paces(self):
        src = ScriptedKeys("ab", per_poll=1)
        assert src.poll() == ["a"]
        assert src.poll() == ["b"]
        assert src.poll() == []

    def test_tty_keys_stops_at_the_end_of_input(self):
        """poll() returns what was typed and stops at the end of input (the
        JAX package's TtyKeys loops forever there: select reports a closed
        stream readable and read(1) returns '')."""
        import os
        r, w = os.pipe()
        with os.fdopen(r) as rf:
            os.write(w, b"m\x1b[C")
            os.close(w)
            keys = TtyKeys(rf)
            assert keys.poll() == ["m", "right"]
            assert keys.poll() == []


class TestControlSurface:
    def test_arrow_retune_is_params_only(self):
        s = make_surface()
        rx0 = s.rx
        hi0 = s.params.tune_hi.clone()
        assert s.handle("right") == "TUNE 251.000 kHz"
        assert s.rx is rx0 and not s.take_reset()
        assert not torch.equal(s.params.tune_hi, hi0)
        s.handle("up")
        s.handle("left")
        assert s.tune == pytest.approx(241_000.0)

    def test_bandpass_key_redesigns_mask(self):
        s = make_surface()
        mask0 = s.params.bp_mask.clone()
        assert s.handle("[").startswith("BW ")
        assert not s.take_reset()
        assert not torch.equal(s.params.bp_mask, mask0)

    def test_squelch_gain_mute_params_only(self):
        s = make_surface()
        s.handle("s")
        assert float(s.params.squelch_db) == -10.0
        s.handle("g")
        assert float(s.params.gain) > 1.0
        s.handle(" ")
        assert bool(s.params.mute)
        s.handle(" ")
        assert not bool(s.params.mute)
        assert not s.take_reset()

    def test_mode_key_swaps_chain(self):
        s = make_surface(DemodMode.AM)
        rx0 = s.rx
        assert s.handle("m") == "MODE SAM"
        assert s.rx is not rx0 and s.rx.cfg.mode == DemodMode.SAM
        assert s.take_reset()
        s.handle("M")
        assert s.rx.cfg.mode == DemodMode.AM and s.take_reset()

    def test_agc_key_swaps_chain(self):
        s = make_surface()
        assert s.handle("a").startswith("AGC ")
        assert s.take_reset()

    def test_device_lo_handoff(self):
        class FakeRadio:
            def __init__(self):
                self.lo = []

            def set_center_freq(self, hz):
                self.lo.append(hz)

        radio = FakeRadio()
        s = make_surface(tune=900_000.0, source=radio,
                         center_hz=100_000_000.0)
        s.step = 100_000.0
        assert s.handle("right").startswith("LO ")
        assert radio.lo == [101_000_000.0] and s.tune == 0.0
        s2 = make_surface(tune=900_000.0, source=object(), center_hz=0.0)
        s2.step = 1_000_000.0
        assert s2.handle("right").startswith("TUNE")
        assert abs(s2.tune) <= FS / 2

    def test_retune_moves_off_station_mid_stream(self):
        s = make_surface(DemodMode.AM, tune=250_000.0)
        t = np.arange(4 * N) / FS
        env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
        iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)).astype(
            np.complex64)
        state = s.rx.init_state()
        snrs = []
        for k in range(4):
            if k == 2:
                s.step = 100_000.0
                s.handle("right")   # 250 kHz -> 350 kHz: off the station
            blk = iq[k * N:(k + 1) * N]
            plane = torch.from_numpy(np.stack([blk.real, blk.imag], axis=1))
            state, out = s.rx.step(state, s.params, plane)
            snrs.append(float(out["smeter"]["snr_db"][0]))
        assert snrs[1] > 30.0
        assert snrs[3] < snrs[1] - 20.0


class TestCliScriptedKeys:
    def run(self, argv, capsys) -> dict:
        from pebblesdr_tpu_torch.serve.cli import main
        assert main(argv + ["--device", "cpu", "--json"]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    def test_keys_retune_between_dispatches(self, capsys):
        m = self.run(["--synthetic", "tone", "--mode", "USB", "--tune",
                      "400000", "--seconds", "0.4", "--frames", "8192",
                      "--blocks-per-dispatch", "1", "--keys",
                      "\x1b[C\x1b[C\x1b[C"], capsys)
        assert m["tune_hz"] == pytest.approx(403_000.0)
        assert [e for e in m["control_events"] if e.startswith("TUNE")] == [
            "TUNE 401.000 kHz", "TUNE 402.000 kHz", "TUNE 403.000 kHz"]

    def test_keys_mode_swap(self, capsys):
        m = self.run(["--synthetic", "am", "--mode", "AM", "--tune", "250000",
                      "--seconds", "0.1", "--frames", "8192",
                      "--blocks-per-dispatch", "1", "--keys", "m"], capsys)
        assert m["final_mode"] == "SAM" and "MODE SAM" in m["control_events"]

    def test_quit_key_stops_early(self, capsys):
        m = self.run(["--synthetic", "am", "--mode", "AM", "--tune", "250000",
                      "--seconds", "2.0", "--frames", "8192",
                      "--blocks-per-dispatch", "1", "--keys", "xq"], capsys)
        assert m["blocks"] <= 2

    def test_keys_help_prints_the_key_map(self, capsys):
        from pebblesdr_tpu_torch.serve.cli import main
        assert main(["--keys", "help", "--device", "cpu"]) == 0
        err = capsys.readouterr().err
        assert err.startswith("Key map") and "snap-tune" in err


class TestDisplayCycle:
    def test_z_cycles_display_sources(self):
        s = make_surface(fs=512_000, n=8192, tune=0.0)
        assert s.display == "wide"
        assert s.handle("z") == "DISPLAY zoom"
        assert s.handle("z") == "DISPLAY split"
        assert s.handle("z") == "DISPLAY wide"

    def test_p_snaps_to_spectrum_peak(self):
        """'p' retunes to the strongest wideband peak outside the current
        station's guard band; stepping the same Receiver then recovers the
        snapped station's 1 kHz program."""
        fs, n = 512_000, 8192
        rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                     mode=DemodMode.AM, agc_mode="off"),
                      "cpu")
        s = ControlSurface(rx, rx.default_params(50_000.0), 50_000.0)
        assert s.handle("p") is None            # no spectrum seen yet
        t = np.arange(16 * n) / fs
        weak = 0.05 * (1 + 0.5 * np.cos(2 * np.pi * 600.0 * t)) / 2 \
            * np.exp(2j * np.pi * 50_000.0 * t)
        strong = 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2 \
            * np.exp(2j * np.pi * -120_000.0 * t)
        iq = (weak + strong).astype(np.complex64)
        planes = [torch.from_numpy(np.stack(
            [iq[i * n:(i + 1) * n].real, iq[i * n:(i + 1) * n].imag], 1))
            for i in range(16)]
        state = rx.init_state()
        for i in range(4):
            state, out = rx.step(state, s.params, planes[i])
        s.note_spectrum(out["spectrum"][0].numpy())
        ev = s.handle("p")
        assert ev is not None and ev.startswith("SNAP ")
        assert abs(s.tune - (-120_000.0)) < 5_000.0, s.tune
        state = rx.init_state()
        audio = []
        for i in range(16):
            state, out = rx.step(state, s.params, planes[i])
            audio.append(out["audio"][0].numpy())
        a = np.concatenate(audio)[rx.cfg.audio_rate // 8:]
        spec = np.abs(np.fft.rfft(a - a.mean()))
        freqs = np.fft.rfftfreq(len(a), 1.0 / rx.cfg.audio_rate)
        assert abs(freqs[int(np.argmax(spec))] - 1000.0) < 50.0


class TestPeakSnapEdgeCases:
    def test_snap_guard_covers_capture_returns_none(self):
        s = make_surface(DemodMode.FMM, tune=0.0, fs=512_000, n=8192)
        s.bp_lo, s.bp_hi = -256_000.0, 256_000.0
        s.note_spectrum(np.linspace(-120.0, -60.0, 2048))
        assert s.handle("p") is None and s.tune == 0.0

    def test_snap_excludes_own_passband_asymmetric(self):
        s = make_surface(DemodMode.USB, tune=100_000.0, fs=512_000, n=8192)
        row = np.full(2048, -120.0)
        freqs = (np.arange(2048) / 2048 - 0.5) * 512_000.0
        row[np.argmin(np.abs(freqs - 102_000.0))] = -30.0
        row[np.argmin(np.abs(freqs - (-150_000.0)))] = -50.0
        s.note_spectrum(row)
        ev = s.handle("p")
        assert ev is not None and ev.startswith("SNAP")
        assert abs(s.tune - (-150_000.0)) < 1_000.0

    def test_snap_hands_off_to_device_lo(self):
        class FakeRadio:
            def __init__(self):
                self.lo = []

            def set_center_freq(self, hz):
                self.lo.append(hz)

        radio = FakeRadio()
        s = make_surface(tune=0.0, fs=512_000, n=8192, source=radio,
                         center_hz=100_000_000.0)
        row = np.full(2048, -120.0)
        freqs = (np.arange(2048) / 2048 - 0.5) * 512_000.0
        row[np.argmin(np.abs(freqs - 240_000.0))] = -30.0
        s.note_spectrum(row)
        ev = s.handle("p")
        assert ev is not None and ev.startswith("LO ")
        assert len(radio.lo) == 1 and abs(radio.lo[0] - 100_240_000.0) < 1e3
        assert s.tune == 0.0


class TestPresetStepping:
    def test_n_steps_through_presets_and_swaps_mode(self):
        presets = [Preset(name="alpha", freq_hz=100_000.0, mode="AM"),
                   Preset(name="bravo", freq_hz=200_000.0, mode="USB"),
                   Preset(name="charlie", freq_hz=-150_000.0, mode="AM")]
        s = make_surface(tune=0.0, fs=512_000, n=8192, presets=presets)
        assert s.handle("n") == "PRESET alpha 0.1000 MHz"
        assert s.tune == 100_000.0 and not s.take_reset()
        assert s.handle("n") == "PRESET bravo 0.2000 MHz"
        assert s.mode == DemodMode.USB and s.take_reset()
        assert s.handle("n").startswith("PRESET charlie")
        assert s.tune == -150_000.0 and s.mode == DemodMode.AM
        assert s.take_reset()
        assert s.handle("N").startswith("PRESET bravo")
        assert make_surface(tune=0.0, fs=512_000, n=8192).handle("n") is None

    def test_cli_presets_keys(self, tmp_path):
        from pebblesdr_tpu_torch.serve.cli import main

        csv = tmp_path / "presets.csv"
        csv.write_text("# name,freq_hz,mode\nstation-a,250000,AM\n"
                       "station-b,-100000,AM\n")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--synthetic", "am", "--mode", "AM", "--tune",
                       "250000", "--seconds", "0.1", "--frames", "8192",
                       "--blocks-per-dispatch", "1", "--json", "--device",
                       "cpu", "--presets", str(csv), "--keys", "Nn"])
        assert rc == 0
        m = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert m["control_events"] == ["PRESET station-b -0.1000 MHz",
                                       "PRESET station-a 0.2500 MHz"]
        assert m["tune_hz"] == 250000.0
