"""The port's modems (pebblesdr_tpu_torch/modem/) against the JAX package's
(pebblesdr_tpu/modem/) on the CPU, on the JAX package's own fixture
signals (its sources and encoders).

Device halves: the Morse modem's marks (Goertzel detector in the peak,
compare and noise threshold modes; the matched detector) and the RTTY
modem's marks equal, on signals whose decision margins are asserted
(ops/goertzel.py ook_margin >= 1e-5 for the OOK decisions, mark vs space
powers 1e-5 apart for RTTY); the DTMF and WWV powers within 1e-6 of their
largest (one float32 complex product per bin, summed in another order);
the 433 MHz OOK decisions equal.  Host halves (copies): the text, digits,
time and messages each package's decoder makes of its own modem's output
equal, and right.  The port's encoders (copies) give the JAX encoders'
samples exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.io import sources as jsources
from pebblesdr_tpu.modem import dtmf as jdtmf
from pebblesdr_tpu.modem import morse as jmorse
from pebblesdr_tpu.modem import ook433 as jook
from pebblesdr_tpu.modem import rtty as jrtty
from pebblesdr_tpu.modem import wwv as jwwv
from pebblesdr_tpu_torch.modem import dtmf, morse, ook433, rtty, wwv
from pebblesdr_tpu_torch.ops import goertzel

MARGIN = 1e-5


def _morse_run(jm, tm, blocks):
    """Both modems and decoders over the same blocks: (JAX marks, port
    marks, JAX text, port text, the smallest OOK margin of the port's
    Goertzel powers)."""
    jst, tst = jm.init_state(1), tm.init_state(1, "cpu")
    jdec = jmorse.MorseDecoder(frame_rate=jm.frame_rate)
    tdec = morse.MorseDecoder(frame_rate=tm.frame_rate)
    jall, tall, margin = [], [], np.inf
    for x in blocks:
        xt = torch.from_numpy(x[None])
        if tm.detector == "goertzel":
            p = goertzel.goertzel_power(goertzel.frame_stream(xt, tm.frame),
                                        tm.basis)
            margin = min(margin, goertzel.ook_margin(
                tm.ook_cfg, tst, p[:, :, 0], p[:, :, 1], p[:, :, 2]))
        jst, jmk = jm.detect(jst, jnp.asarray(x[None]))
        tst, tmk = tm.detect(tst, xt)
        jall.append(np.asarray(jmk)[0])
        tall.append(tmk[0].numpy())
        jdec.feed(np.asarray(jmk)[0])
        tdec.feed(tmk[0].numpy())
    jdec.flush()
    tdec.flush()
    return (np.concatenate(jall), np.concatenate(tall), jdec.text,
            tdec.text, margin)


MORSE = {
    # name: (source kwargs or scenario, modem kwargs, text expected)
    "peak": (dict(generators=(("cq cq de n1ddy", 20.0, 1000.0, 1.0),),
                  noise_db=-20.0, seed=3),
             dict(tone_hz=1000.0, wpm_hint=20.0), "cq cq de n1ddy"),
    "compare pileup": ("pileup", dict(tone_hz=1000.0, wpm_hint=22.0,
                                      bandwidth_hz=75.0,
                                      threshold_mode="compare"), "de p1 k"),
    "noise fading": (dict(generators=(("paris paris paris", 20.0, 1000.0,
                                       1.0, True),),
                          noise_db=-30.0, seed=5, fade_hz=0.25,
                          fade_depth_db=20.0),
                     dict(tone_hz=1000.0, wpm_hint=20.0,
                          threshold_mode="noise"), "paris paris"),
}


@pytest.mark.parametrize("case", list(MORSE))
def test_morse_goertzel_matches_jax(case):
    src_kw, modem_kw, want = MORSE[case]
    fs = 8000
    src = (jsources.MorseGenSource.from_scenario(src_kw, fs, seed=2)
           if isinstance(src_kw, str) else
           jsources.MorseGenSource(fs, **src_kw))
    jm, tm = jmorse.MorseModem(fs, **modem_kw), morse.MorseModem(fs,
                                                                 **modem_kw)
    assert tm.frame == jm.frame
    blocks = [src.read_block(40 * tm.frame) for _ in range(45)]
    jmk, tmk, jtext, ttext, margin = _morse_run(jm, tm, blocks)
    assert margin >= MARGIN
    assert np.array_equal(jmk, tmk)
    assert ttext == jtext and want in ttext, (ttext, jtext)


def test_morse_matched_detector_matches_jax():
    """The matched detector (NCO mix, decimating low-pass, OOK) on a 700 Hz
    keyed tone at 6 dB SNR (tests/test_morse_detectors.py's fixture): the
    marks and the text equal."""
    fs, tone, wpm = 8000.0, 700.0, 20.0
    from test_morse_detectors import _synth
    sig = _synth("cq test de pebble", 6.0, seed=1)
    kw = dict(tone_hz=tone, wpm_hint=wpm, detector="matched")
    jm, tm = jmorse.MorseModem(fs, **kw), morse.MorseModem(fs, **kw)
    assert np.array_equal(tm.mf_taps, jm.mf_taps)
    blk = 40 * tm.frame
    blocks = [sig[i:i + blk] for i in range(0, len(sig) - blk + 1, blk)]
    jmk, tmk, jtext, ttext, _ = _morse_run(jm, tm, blocks)
    assert np.array_equal(jmk, tmk)
    assert ttext == jtext and "cq test" in ttext, (ttext, jtext)


def test_rtty_matches_jax():
    fs = 8000.0
    sig = jrtty.encode_rtty("RYRY ABC 123 XYZ", fs)
    assert np.array_equal(rtty.encode_rtty("RYRY ABC 123 XYZ", fs), sig)
    jm, tm = jrtty.RttyModem(fs), rtty.RttyModem(fs)
    n = (len(sig) // tm.frame) * tm.frame
    x = torch.from_numpy(sig[None, :n])
    p = goertzel.goertzel_power(goertzel.frame_stream(x, tm.frame),
                                tm.basis).double()
    gap = (p[..., 0] - p[..., 1]).abs() / p.amax(-1)
    assert float(gap.min()) >= MARGIN
    jmk = np.asarray(jm.detect(jnp.asarray(sig[None, :n])))
    tmk = tm.detect(x)
    assert np.array_equal(jmk, tmk.numpy())
    jdec = jrtty.RttyDecoder(frames_per_bit=jm.frames_per_bit)
    tdec = rtty.RttyDecoder(frames_per_bit=tm.frames_per_bit)
    jdec.feed(jmk[0])
    tdec.feed(tmk[0].numpy())
    assert tdec.text == jdec.text and "ABC 123 XYZ" in tdec.text


def test_dtmf_matches_jax():
    fs = 8000.0
    keys = "123A456B789C*0#D"
    audio = jdtmf.encode_dtmf(keys, fs)
    assert np.array_equal(dtmf.encode_dtmf(keys, fs), audio)
    rng = np.random.default_rng(7)
    audio = (audio + 0.02 * rng.standard_normal(len(audio))).astype(
        np.float32)
    jm, tm = jdtmf.DtmfModem(fs), dtmf.DtmfModem(fs)
    n = (len(audio) // tm.frame) * tm.frame
    jp = np.asarray(jm.detect(jnp.asarray(audio[None, :n])))
    tp = tm.detect(torch.from_numpy(audio[None, :n]))
    assert tp.shape == jp.shape == (1, n // tm.frame, 8)
    assert float(np.abs(jp - tp.numpy()).max()) <= 1e-6 * jp.max()
    jdec, tdec = jdtmf.DtmfDecoder(), dtmf.DtmfDecoder()
    jdec.feed(jp[0])
    tdec.feed(tp[0].numpy())
    assert tdec.digits == jdec.digits == keys


def test_wwv_matches_jax():
    fs = 4000.0
    frame = jwwv.WwvFrame(minutes=37, hours=14, day_of_year=123, year=26,
                          dst1=True, leap=True, dut1=-0.3)
    audio = jwwv.encode_wwv_frame(frame, fs, seconds=130, start_second=17)
    tframe = wwv.WwvFrame(**dataclasses.asdict(frame))
    assert np.array_equal(wwv.encode_wwv_frame(tframe, fs, seconds=130,
                                               start_second=17), audio)
    assert wwv.WWV_LAYOUT == jwwv.WWV_LAYOUT
    jm, tm = jwwv.WwvModem(fs), wwv.WwvModem(fs)
    jdec, tdec = jwwv.WwvDecoder(), wwv.WwvDecoder()
    blk = 100 * tm.frame
    worst, scale = 0.0, 0.0
    for i in range(0, (len(audio) // blk) * blk, blk):
        jp = np.asarray(jm.detect(jnp.asarray(audio[None, i:i + blk])))
        tp = tm.detect(torch.from_numpy(audio[None, i:i + blk])).numpy()
        worst = max(worst, float(np.abs(jp - tp).max()))
        scale = max(scale, float(jp.max()))
        jdec.feed(jp[0])
        tdec.feed(tp[0])
    assert worst <= 1e-6 * scale
    assert jdec.frame is not None and tdec.frame == wwv.WwvFrame(
        **dataclasses.asdict(jdec.frame))
    assert (tdec.minutes, tdec.hours, tdec.day_of_year) == (38, 14, 123)


@pytest.mark.parametrize("temp", [23.4, -7.5])
def test_ook433_matches_jax(temp):
    fs = 32768.0
    burst = jook.encode_osv2(0x1D20, 1, temp, fs)
    assert np.array_equal(ook433.encode_osv2(0x1D20, 1, temp, fs), burst)
    sig = np.concatenate([np.zeros(2048, np.complex64), burst,
                          np.zeros(2048, np.complex64)])
    jm, tm = jook.OokDemod(fs), ook433.OokDemod(fs)
    n = (len(sig) // tm.frame) * tm.frame
    jon = np.asarray(jm.detect(jnp.asarray(sig[None, :n])))
    ton = tm.detect(torch.from_numpy(sig[None, :n])).numpy()
    assert np.array_equal(jon, ton)
    jdec = jook.OsV2Decoder(frame_rate=jm.frame_rate)
    tdec = ook433.OsV2Decoder(frame_rate=tm.frame_rate)
    jdec.feed(jon[0])
    tdec.feed(ton[0])
    assert tdec.messages == jdec.messages
    assert tdec.messages[0]["temperature_c"] == temp
    assert tdec.messages[0]["checksum_ok"]
