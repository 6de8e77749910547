"""The port's command-line receiver (pebblesdr_tpu_torch/serve/cli.py, run
with --device cpu) against the JAX package's (pebblesdr_tpu/serve/cli.py),
in-process with the same arguments, at the sizes of tests/test_cli.py:
synthetic USB, an AM --wav round trip, FM stereo with --wfm-hq, FM stereo
at 2.88 Msps (the stereo tail without K2), the noise blanker and the
dense bank (--stations).  The synthetic sources carry noise at -60 dB, so
the S-meter reads a real noise floor rather than float rounding.

The JAX CLI on the CPU runs its per-block path (staged front, one block
per scan step); the port its batched graph behind the fused front, with
the per-block decimation grid where the tail block is not a multiple of
audio_decim (2.88 Msps).  Bounds: the audio WAVs sample by sample (int16 /
32767) within 2e-4, FM stereo within the stereo tail's 5e-4 (tests/
test_chain_pallas.py:190, the JAX suite's fused-vs-staged FMS bound); the
JSON keys equal (the port's "split_ms" and a network source's
"source_counters" aside); blocks, input_samples, audio_rate and
squelch_open equal;
smeter_db and snr_db within 0.2 dB (the CLIs round them to 0.1 dB);
audio_rms within 1e-3.  --decode cw|rtty|wwv|dtmf (the modems, cw / rtty
on the staged front's post_bp tap) against the JAX CLI with the same
arguments: the decoded text, time or digits equal, and the cw, rtty and
dtmf decodes right.  --checkpoint / --checkpoint-every / --resume: the
round trip of tests/test_cli.py:24-40, the supervisor's snapshots and the
"health" JSON against the JAX CLI's, and a resumed run's audio against
the JAX CLI's resumed run (each from its own checkpoint) within 2e-4.
The live shell: --source rtl_tcp (each CLI reading its own package's
server, which serves the same recording) and --source hpsdr --bandscope
--display waterfall against the JAX CLI (audio within 2e-4, the JSON keys
equal, bandscope_frames equal; the JAX CLI never sends the HPSDR start
command, so its registry's hpsdr factory is wrapped to send it, while the
port's CLI sends it itself); --keys with --display spectrum against the
JAX CLI (control_events and tune_hz equal); --source sdr_ip on the port's
native pump; --audio-out pipe:dd carrying the 1 kHz tone.  --assign
(mixed-mode channels through parallel/expert.py) against the JAX CLI at
tests/test_cli_assign.py's arguments, and with --squelch, --gain and
--bandpass: the channels' modes, tunes, SNRs and audio_rms, and each
channel's WAV within 2e-4.
"""

import json
import struct

import numpy as np
import pytest

from pebblesdr_tpu.serve import cli as jcli
from pebblesdr_tpu_torch.io import wav
from pebblesdr_tpu_torch.serve import cli

TIMING = ("wall_s", "msps", "realtime_factor", "step_ms", "split_ms")
# the port's JSON keys beyond the JAX CLI's: the per-dispatch split, and a
# network source's counters
PORT_KEYS = {"split_ms", "source_counters"}


def read_audio(path: str) -> np.ndarray:
    """The int16 samples of an audio WAV scaled back by 1/32767, [n, ch]."""
    buf = open(path, "rb").read()
    ch = struct.unpack_from("<H", buf, buf.index(b"fmt ") + 10)[0]
    i = buf.index(b"data")
    n = struct.unpack_from("<I", buf, i + 4)[0]
    pcm = np.frombuffer(buf[i + 8:i + 8 + n], "<i2").astype(np.float64)
    return pcm.reshape(-1, ch) / 32767.0


def fm_wav(path: str, fs: int, seconds: float) -> str:
    """An FM stereo IQ recording at fs, the station at +250 kHz (L 1 kHz,
    R 400 Hz, the 19 kHz pilot, 75 kHz deviation), noise at 1e-2."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    lt, rt = np.sin(2 * np.pi * 1000.0 * t), np.sin(2 * np.pi * 400.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * (lt + rt) / 2 + 0.1 * np.sin(th) \
        + 0.45 * (lt - rt) / 2 * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
    rng = np.random.default_rng(7)
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph)) + 1e-2 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    wav.write_iq_wav(path, iq.astype(np.complex64), fs, demod_mode="FMS")
    return path


def am_wav(path: str) -> str:
    """tests/test_cli.py's AM round trip: 1 kHz at 80 % on +250 kHz."""
    fs = 2_048_000
    t = np.arange(fs // 4) / fs
    rng = np.random.default_rng(3)
    iq = (0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000 * t))
          * np.exp(2j * np.pi * 250_000 * t)
          + 1e-3 * (rng.standard_normal(t.size)
                    + 1j * rng.standard_normal(t.size)))
    wav.write_iq_wav(path, iq.astype(np.complex64), fs, center_freq_hz=0.0,
                     demod_mode="AM")
    return path


def run(main, argv, capsys) -> dict:
    rc = main(argv)
    assert rc in (0, None)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def check_metrics(jm: dict, tm: dict) -> None:
    assert set(jm) == set(tm) - PORT_KEYS
    assert ("split_ms" in tm) == ("step_ms" in jm)  # a run's, not a row's
    for key in jm:
        if key in TIMING:
            continue
        if key in ("smeter_db", "snr_db"):
            assert abs(jm[key] - tm[key]) <= 0.2 + 1e-9, (key, jm[key],
                                                          tm[key])
        elif key == "audio_rms":
            assert abs(jm[key] - tm[key]) < 1e-3, (jm[key], tm[key])
        elif key != "rows":
            assert jm[key] == tm[key], key


CASES = {
    "usb": (["--synthetic", "tone", "--mode", "USB", "--tune", "400000",
             "--seconds", "0.3", "--noise-db", "-60"], 2e-4),
    "am_wav": (["--wav", "{am}", "--mode", "AM", "--tune", "250000",
                "--seconds", "0.2"], 2e-4),
    "fms_hq": (["--wav", "{fm}", "--mode", "FM-Stereo", "--tune", "250000",
                "--seconds", "0.15", "--wfm-hq"], 5e-4),
    "fms_2m88": (["--wav", "{fm288}", "--sample-rate", "2880000", "--mode",
                  "FM-Stereo", "--tune", "250000", "--seconds", "0.15"],
                 5e-4),
    "nb": (["--synthetic", "am", "--mode", "AM", "--tune", "250000",
            "--seconds", "0.2", "--noise-blanker", "--noise-db", "-60"],
           2e-4),
}


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    d = tmp_path_factory.mktemp("iq")
    return {"am": am_wav(str(d / "am.wav")),
            "fm": fm_wav(str(d / "fm.wav"), 2_048_000, 0.15),
            "fm288": fm_wav(str(d / "fm288.wav"), 2_880_000, 0.15)}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(case, recordings, tmp_path, capsys):
    argv, tol = CASES[case]
    argv = [a.format(**recordings) for a in argv] + ["--json"]
    jm = run(jcli.main, argv + ["--audio-out", str(tmp_path / "j.wav")],
             capsys)
    tm = run(cli.main, argv + ["--audio-out", str(tmp_path / "t.wav"),
                               "--device", "cpu"], capsys)
    check_metrics(jm, tm)
    a, b = read_audio(str(tmp_path / "j.wav")), read_audio(str(tmp_path /
                                                               "t.wav"))
    assert a.shape == b.shape
    assert a.shape[1] == (2 if case.startswith("fms") else 1)
    assert np.abs(a - b).max() < tol, np.abs(a - b).max()
    assert np.abs(b).max() > 0.05


def test_cli_stations_match_jax(tmp_path, capsys):
    argv = ["--synthetic", "am", "--tune", "250000", "--stations",
            "250000,-300000", "--seconds", "0.2", "--noise-db", "-60",
            "--json"]
    jm = run(jcli.main, argv + ["--audio-out", str(tmp_path / "j.wav")],
             capsys)
    tm = run(cli.main, argv + ["--audio-out", str(tmp_path / "t.wav"),
                               "--device", "cpu"], capsys)
    check_metrics(jm, tm)
    assert len(jm["rows"]) == len(tm["rows"]) == 2
    for jr, tr in zip(jm["rows"], tm["rows"]):
        check_metrics(jr, tr)
    for i in range(2):
        a = read_audio(str(tmp_path / f"j.st{i}.wav"))
        b = read_audio(str(tmp_path / f"t.st{i}.wav"))
        assert a.shape == b.shape and np.abs(a - b).max() < 2e-4


def dtmf_wav(path: str) -> str:
    """tests/test_cli.py:83-110's dial: "911" as dual tones of 80 ms with
    80 ms gaps, FM at 3 kHz deviation on +30 kHz of a 256 kHz capture,
    noise at 1e-3 (a noiseless S-meter SNR is rounding noise)."""
    from pebblesdr_tpu_torch.modem import dtmf
    fs, seconds = 256_000, 2.2
    dial = dtmf.encode_dtmf("911", 48000.0, tone_ms=80, gap_ms=80)
    n = int(fs * seconds)
    afull = np.zeros(int(seconds * 48000) + 1, np.float32)
    afull[2000:2000 + len(dial)] = dial
    a_dev = np.interp(np.arange(n) / fs, np.arange(len(afull)) / 48000.0,
                      afull)
    ph = 2 * np.pi * np.cumsum(3000.0 * a_dev) / fs
    rng = np.random.default_rng(13)
    iq = 0.5 * np.exp(1j * (2 * np.pi * 30_000.0 * np.arange(n) / fs + ph)) \
        + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    wav.write_iq_wav(path, iq.astype(np.complex64), fs,
                     center_freq_hz=30_000.0, demod_mode="FMN")
    return path


def rtty_wav(path: str) -> str:
    """"RYRY CQ" as 45.45 baud, 170 Hz shift FSK (mark 2125 Hz above the
    carrier) on +30 kHz of a 256 kHz capture, noise at 1e-3."""
    from pebblesdr_tpu_torch.modem import rtty
    fs = 256_000
    fsk = rtty.encode_rtty("RYRY CQ", fs, amplitude=0.3)
    t = np.arange(len(fsk)) / fs
    rng = np.random.default_rng(11)
    iq = fsk * np.exp(2j * np.pi * 30_000.0 * t) + 1e-3 * (
        rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)))
    wav.write_iq_wav(path, iq.astype(np.complex64), fs,
                     center_freq_hz=30_000.0, demod_mode="USB")
    return path


DECODE_CASES = {
    "cw": (["--synthetic", "morse", "--mode", "CWU", "--tune", "100000",
            "--seconds", "3.2", "--noise-db", "-60"], "decoded_text", "cq"),
    "rtty": (["--wav", "{rtty}", "--mode", "USB", "--tune", "30000",
              "--sample-rate", "256000", "--seconds", "1.6"],
             "decoded_text", "RYRY"),
    "wwv": (["--synthetic", "am", "--mode", "AM", "--tune", "250000",
             "--seconds", "0.2", "--noise-db", "-60"], "decoded_time", None),
    "dtmf": (["--wav", "{dtmf}", "--mode", "FMN", "--tune", "30000",
              "--sample-rate", "256000", "--frames", "32768", "--seconds",
              "1.5"], "decoded_digits", "911"),
}


@pytest.fixture(scope="module")
def decode_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode")
    return {"rtty": rtty_wav(str(d / "rtty.wav")),
            "dtmf": dtmf_wav(str(d / "dtmf.wav"))}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_cli_decode_matches_jax(case, decode_inputs, capsys):
    """--decode on --device cpu against the JAX CLI: the JSON keys and the
    decoded text, time or digits equal; cw decodes "cq...", rtty "RYRY",
    dtmf "911", wwv (0.2 s, no whole minute) None."""
    argv, key, want = DECODE_CASES[case]
    argv = [a.format(**decode_inputs) for a in argv] + ["--decode", case,
                                                        "--json"]
    jm = run(jcli.main, argv, capsys)
    tm = run(cli.main, argv + ["--device", "cpu"], capsys)
    check_metrics(jm, tm)
    assert key in tm and tm[key] == jm[key]
    if want is None:
        assert tm[key] is None
    else:
        assert tm[key].lower().startswith(want.lower()), tm[key]


def test_cli_gain_scales_the_audio(capsys):
    """--gain sets the Receiver's audio gain (the JAX CLI hands it only to
    its control surface and --assign)."""
    argv = ["--synthetic", "tone", "--mode", "USB", "--tune", "400000",
            "--seconds", "0.05", "--frames", "8192", "--device", "cpu",
            "--json"]
    one = run(cli.main, argv, capsys)
    half = run(cli.main, argv + ["--gain", "0.5"], capsys)
    assert half["audio_rms"] == pytest.approx(one["audio_rms"] / 2, abs=2e-4)


def test_cli_records_iq(tmp_path, capsys):
    """--iq-record writes the blocks read, with the tune and mode."""
    rec = str(tmp_path / "rec.wav")
    run(cli.main, ["--synthetic", "tone", "--mode", "USB", "--tune",
                   "100000", "--seconds", "0.02", "--frames", "8192",
                   "--device", "cpu", "--json", "--iq-record", rec], capsys)
    iq, info = wav.read_iq_wav(rec)
    assert iq.shape == (5 * 8192,)              # 0.02 s: 5 blocks
    assert (info.center_freq_hz, info.demod_mode) == (100000.0, "USB")


ASSIGN = ["--synthetic", "am", "--sample-rate", "512000", "--tune", "100000",
          "--frames", "8192", "--assign", "AM@100000,USB@100000",
          "--seconds", "0.4", "--noise-db", "-60", "--json"]


@pytest.mark.parametrize("extra", [
    [], ["--squelch", "10"],
    ["--squelch", "10", "--gain", "0.5", "--bandpass=-4000,4000"]],
    ids=["assign", "assign_squelch", "assign_squelch_gain_bandpass"])
def test_assign_matches_jax_cli(extra, tmp_path, capsys):
    """tests/test_cli_assign.py's run (AM and USB experts on one AM
    station); with --squelch 10 the USB channel (-5.6 dB) closes; with
    --bandpass -4000,4000 it opens again (both channels near 67 dB) and
    --gain 0.5 halves the AM audio: the port's JSON and per-channel WAVs
    against the JAX CLI's for the same arguments."""
    jm = run(jcli.main, ASSIGN + extra + ["--audio-out",
                                          str(tmp_path / "j.wav")], capsys)
    tm = run(cli.main, ASSIGN + extra + ["--audio-out", str(tmp_path / "t.wav"),
                                         "--device", "cpu"], capsys)
    assert set(jm) == set(tm) - PORT_KEYS
    assert jm["blocks"] == tm["blocks"] >= 20
    assert [c["mode"] for c in tm["channels"]] == ["AM", "USB"]
    for jc, tc in zip(jm["channels"], tm["channels"]):
        assert (jc["channel"], jc["mode"], jc["tune_hz"]) == (
            tc["channel"], tc["mode"], tc["tune_hz"])
        assert abs(jc["snr_db"] - tc["snr_db"]) <= 0.2 + 1e-9
        assert abs(jc["audio_rms"] - tc["audio_rms"]) < 1e-3
    am, usb = tm["channels"]
    assert am["snr_db"] > 10 and am["audio_rms"] > 0.01
    if len(extra) == 2:                         # --squelch alone
        assert usb["snr_db"] < 10 and usb["audio_rms"] == 0.0
    elif extra:                                 # the wide bandpass, gain
        assert usb["snr_db"] > 10 and usb["audio_rms"] > 0.01
        assert am["audio_rms"] == pytest.approx(0.2716 / 2, abs=2e-3)
    for ch in (0, 1):
        a = read_audio(str(tmp_path / f"t.ch{ch}.wav"))
        b = read_audio(str(tmp_path / f"j.ch{ch}.wav"))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_cli_wav_roundtrip_with_checkpoint(tmp_path, capsys):
    """tests/test_cli.py:24-40 on the port: a run that saves its state at
    exit, then a run that resumes from it; the file holds the receiver's
    state (it loads into the configuration's init_state) and the blocks
    run."""
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.utils import checkpoint
    fs = 2_048_000
    t = np.arange(fs // 4) / fs
    iq = (0.4 * (1 + 0.5 * np.cos(2 * np.pi * 1000 * t)) / 2
          * np.exp(2j * np.pi * 300_000 * t)).astype(np.complex64)
    p = str(tmp_path / "in.wav")
    wav.write_iq_wav(p, iq, fs, center_freq_hz=300_000.0, demod_mode="AM")
    ck = str(tmp_path / "state.npz")
    first = run(cli.main, ["--wav", p, "--mode", "AM", "--seconds", "0.2",
                           "--checkpoint", ck, "--json", "--device", "cpu"],
                capsys)
    rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=32768,
                                 mode=DemodMode.AM), "cpu")
    _, extra = checkpoint.load_state(ck, rx.init_state())
    # 0.2 s is 12.5 blocks: two dispatches of 8
    assert extra == {"blocks": first["blocks"]} and first["blocks"] == 16
    second = run(cli.main, ["--wav", p, "--mode", "AM", "--seconds", "0.1",
                            "--resume", ck, "--json", "--device", "cpu"],
                 capsys)
    assert second["blocks"] == 6 and "health" not in second


def test_cli_checkpoint_every_matches_jax_health(recordings, tmp_path,
                                                 capsys):
    """--checkpoint-every 4: the supervisor's snapshots (a "checkpoint"
    event every 4 blocks, at the path) and the JSON's "health" with the
    JAX CLI's keys and values (the real-time factor is a timing); the file
    at exit holds the last state with the blocks run."""
    argv = ["--wav", recordings["am"], "--mode", "AM", "--tune", "250000",
            "--seconds", "0.2", "--json", "--checkpoint-every", "4"]
    jm = run(jcli.main, argv + ["--checkpoint", str(tmp_path / "j.npz")],
             capsys)
    tck = str(tmp_path / "t.npz")
    tm = run(cli.main, argv + ["--checkpoint", tck, "--device", "cpu"],
             capsys)
    jh, th = jm.pop("health"), tm.pop("health")
    check_metrics(jm, tm)
    assert set(jh) == set(th)
    for key in ("blocks", "dropped_blocks", "feeder_overruns"):
        assert jh[key] == th[key], key
    assert th["blocks"] == tm["blocks"] == 16       # two dispatches of 8
    assert [(e["kind"], e["block"]) for e in jh["events"]] == [
        (e["kind"], e["block"]) for e in th["events"]] == [
        ("checkpoint", b) for b in (4, 8, 12, 16)]
    assert all(e["path"] == tck for e in th["events"])
    assert isinstance(th["healthy"], bool)
    assert th["realtime_factor"] >= 0.0
    with np.load(tck) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
    assert meta["extra"] == {"blocks": 16}


def test_cli_resumed_run_matches_jax(recordings, tmp_path, capsys):
    """Each CLI runs 0.2 s saving its state, then resumes from its own file
    for 0.1 s more: the resumed runs' audio within the CLI bound (2e-4),
    and the port's resumed audio is not a fresh start's."""
    argv = ["--wav", recordings["am"], "--mode", "AM", "--tune", "250000",
            "--json"]
    audio = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", cli.main, ["--device", "cpu"])):
        ck = str(tmp_path / f"{name}.npz")
        run(main, argv + ["--seconds", "0.2", "--checkpoint", ck] + extra,
            capsys)
        out = str(tmp_path / f"{name}.wav")
        m = run(main, argv + ["--seconds", "0.1", "--resume", ck,
                              "--audio-out", out] + extra, capsys)
        assert m["blocks"] == 6
        audio[name] = read_audio(out)
    a, b = audio["j"], audio["t"]
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 2e-4, np.abs(a - b).max()
    fresh = str(tmp_path / "fresh.wav")
    run(cli.main, argv + ["--seconds", "0.1", "--audio-out", fresh,
                          "--device", "cpu"], capsys)
    assert np.abs(read_audio(fresh) - b).max() > 1e-2


def test_cuda_without_a_card_is_an_error(capsys, monkeypatch):
    """No fallback: --device cuda (the default) with no CUDA device exits 2
    and says so."""
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--synthetic", "tone", "--seconds", "0.01"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_ctcss_requires_fmn():
    with pytest.raises(ValueError):
        cli.main(["--synthetic", "am", "--mode", "AM", "--tune", "250000",
                  "--seconds", "0.1", "--ctcss", "123.0", "--device", "cpu"])


# ---- the live shell --------------------------------------------------------

@pytest.fixture
def served_am(recordings):
    """The AM recording served over rtl_tcp by each package's server
    (unpaced: TCP carries every sample)."""
    from pebblesdr_tpu.io import rtl_tcp as jrtl
    from pebblesdr_tpu.io import sources as jsources
    from pebblesdr_tpu_torch.io import rtl_tcp, sources
    servers = {
        "jax": jrtl.RtlTcpServer(jsources.FileSource(recordings["am"]),
                                 port=0, block=16384),
        "port": rtl_tcp.RtlTcpServer(sources.FileSource(recordings["am"]),
                                     port=0, block=16384)}
    for srv in servers.values():
        srv.start()
    yield {k: srv.port for k, srv in servers.items()}
    for srv in servers.values():
        srv.stop()


def test_cli_rtl_tcp_matches_jax(served_am, tmp_path, capsys):
    argv = ["--source", "rtl_tcp", "--mode", "AM", "--tune", "250000",
            "--seconds", "0.2", "--json"]
    jm = run(jcli.main, argv + ["--port", str(served_am["jax"]),
                                "--audio-out", str(tmp_path / "j.wav")],
             capsys)
    tm = run(cli.main, argv + ["--port", str(served_am["port"]),
                               "--audio-out", str(tmp_path / "t.wav"),
                               "--device", "cpu"], capsys)
    check_metrics(jm, tm)
    a, b = read_audio(str(tmp_path / "j.wav")), read_audio(str(tmp_path /
                                                               "t.wav"))
    assert a.shape == b.shape and np.abs(a - b).max() < 2e-4
    assert np.abs(b).max() > 0.05


def started_hpsdr(factory):
    """The JAX registry's hpsdr factory, plus the start command (IQ and
    the bandscope) that the JAX CLI never sends."""
    def make(**kw):
        src = factory(**kw)
        src.start(bandscope=True)
        return src
    return make


def test_cli_hpsdr_bandscope_matches_jax(tmp_path, capsys, monkeypatch):
    from pebblesdr_tpu.io import hpsdr as jhpsdr
    from pebblesdr_tpu.io import registry as jregistry
    from pebblesdr_tpu.io import sources as jsources
    from pebblesdr_tpu_torch.io import hpsdr, sources
    fs = 192_000

    def tones(mod):
        return mod.SyntheticSource(fs, tones=((20_000.0, 0.25),
                                              (21_000.0, 0.1),
                                              (19_000.0, 0.1)),
                                   noise_db=-60.0)

    monkeypatch.setitem(jregistry._REGISTRY, "hpsdr",
                        started_hpsdr(jregistry._REGISTRY["hpsdr"]))
    argv = ["--source", "hpsdr", "--sample-rate", str(fs), "--mode", "AM",
            "--tune", "20000", "--seconds", "0.2", "--frames", "8192",
            "--blocks-per-dispatch", "2", "--bandscope", "--display",
            "waterfall", "--json"]
    runs = {}
    for name, main, srv, extra in (
            ("jax", jcli.main, jhpsdr.HpsdrServer(tones(jsources)), []),
            ("port", cli.main, hpsdr.HpsdrServer(tones(sources)),
             ["--device", "cpu"])):
        srv.start()
        try:
            rc = main(argv + ["--port", str(srv.port), "--audio-out",
                              str(tmp_path / f"{name}.wav")] + extra)
            out = capsys.readouterr().out.strip().splitlines()
        finally:
            srv.stop()
        assert rc in (0, None)
        runs[name] = (json.loads(out[-1]), out)
    (jm, jout), (tm, tout) = runs["jax"], runs["port"]
    check_metrics(jm, tm)
    assert tm["bandscope_frames"] == jm["bandscope_frames"] == 2
    assert sum(ln.startswith("BS ") for ln in tout) == 2
    a, b = read_audio(str(tmp_path / "jax.wav")), read_audio(
        str(tmp_path / "port.wav"))
    assert a.shape == b.shape and np.abs(a - b).max() < 2e-4


def test_cli_sdr_ip_on_the_native_pump(tmp_path, capsys):
    """The port's CLI starts the SDR-IP stream itself and reads it through
    the native UDP pump (0.1 s at 256 ksps: inside the pump's ring)."""
    from pebblesdr_tpu_torch import runtime
    from pebblesdr_tpu_torch.io import sdr_ip, sources
    fs = 256_000
    srv = sdr_ip.SdrIpServer(sources.SyntheticSource(
        fs, tones=((40_000.0, 0.25), (41_000.0, 0.1), (39_000.0, 0.1)),
        noise_db=-60.0))
    srv.start()
    try:
        m = run(cli.main, ["--source", "sdr_ip", "--port", str(srv.port),
                           "--sample-rate", str(fs), "--mode", "AM",
                           "--tune", "40000", "--seconds", "0.1",
                           "--frames", "8192", "--json", "--device", "cpu",
                           "--audio-out", str(tmp_path / "a.wav")], capsys)
    finally:
        srv.stop()
    assert runtime.available() and m["blocks"] == 3
    c = m["source_counters"]
    assert set(c) == {"datagrams", "dropped_datagrams", "overruns", "bytes",
                      "resyncs", "discarded"} \
        and c["datagrams"] >= 3 * 8192 // 256
    assert any(item == sdr_ip.ITEM_RECEIVER_STATE and params[1] ==
               sdr_ip.STATE_RUN for item, params in srv.commands)
    a = read_audio(str(tmp_path / "a.wav"))[:, 0]
    spec = np.abs(np.fft.rfft(a[len(a) // 3:]))
    f = np.fft.rfftfreq(len(a) - len(a) // 3, 1 / m["audio_rate"])
    assert abs(f[np.argmax(spec[1:]) + 1] - 1000.0) < 60.0


def test_cli_keys_with_the_spectrum_display_match_jax(capsys):
    argv = ["--synthetic", "am", "--mode", "AM", "--tune", "250000",
            "--seconds", "0.2", "--frames", "8192",
            "--blocks-per-dispatch", "1", "--noise-db", "-60", "--json",
            "--display", "spectrum", "--keys",
            "\x1b[C\x1b[A\x1b[D[s gzpm"]
    jm = run(jcli.main, argv, capsys)
    tm = run(cli.main, argv + ["--device", "cpu"], capsys)
    check_metrics(jm, tm)
    assert tm["control_events"] == jm["control_events"]
    assert tm["tune_hz"] == jm["tune_hz"]
    assert tm["final_mode"] == jm["final_mode"] == "SAM"
    assert any(e.startswith("SNAP") for e in tm["control_events"])


def test_cli_pipe_sink_carries_the_tone(tmp_path, capsys):
    sink = tmp_path / "pcm.raw"
    m = run(cli.main, ["--synthetic", "am", "--mode", "AM", "--tune",
                       "250000", "--seconds", "0.4", "--frames", "8192",
                       "--noise-db", "-60", "--json", "--device", "cpu",
                       "--audio-out", f"pipe:dd of={sink} status=none"],
            capsys)
    assert m["audio_sink"] == {"kind": f"pipe:dd of={sink} status=none",
                               "underruns": m["audio_sink"]["underruns"],
                               "overruns": 0}
    pcm = np.frombuffer(sink.read_bytes(), "<f4")
    live = pcm[np.abs(pcm) > 0][4800:]     # past the start-up transient
    assert len(live) > 9600
    spec = np.abs(np.fft.rfft(live * np.hanning(len(live))))
    f = np.fft.rfftfreq(len(live), 1 / 48000.0)
    peak = np.argmax(spec[5:]) + 5
    assert abs(f[peak] - 1000.0) < 20.0
    tone = spec[peak - 3:peak + 4] ** 2
    assert 10 * np.log10(tone.sum() / (np.sum(spec[5:] ** 2)
                                       - tone.sum())) > 30.0
