"""IQ sample sources, host side: file playback and the synthetic devices.

A copy of the file and synthetic sources of pebblesdr_tpu/io/sources.py
(numpy only; tests/test_torch_io.py holds the two to the same samples):
Source (read_block(n) -> complex64 [n], None at the end of the stream),
FileSource (IQ WAV playback, looping, optional real-time pacing),
SyntheticSource (tones plus calibrated noise), morse_envelope and
MorseGenSource (up to five Morse generators with optional QSB fades, and
the named scenarios of MORSE_SCENARIOS).  The network and soundcard
sources are io/rtl_tcp.py, io/sdr_ip.py, io/hpsdr.py and io/audio_iq.py;
io/registry.py creates any of them by name.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np

from pebblesdr_tpu_torch.io import wav


@dataclasses.dataclass
class SourceInfo:
    sample_rate: int
    center_freq_hz: float = 0.0
    demod_mode: str = ""
    name: str = ""


class Source:
    """Base source: read_block(n) -> complex64 [n]; None at end of stream."""

    info: SourceInfo

    def read_block(self, n: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def blocks(self, n: int, max_blocks: int | None = None) -> Iterator[np.ndarray]:
        count = 0
        while max_blocks is None or count < max_blocks:
            b = self.read_block(n)
            if b is None:
                return
            yield b
            count += 1

    # StandardKeys-ish surface (device_interfaces.h:46-111 analog)
    def get(self, key: str):
        return getattr(self.info, key)

    def set(self, key: str, value) -> None:
        setattr(self.info, key, value)


class FileSource(Source):
    """IQ WAV playback (FileSDRDevice capability): loops the file, exposes the
    recorded center frequency / demod mode, optional real-time pacing."""

    def __init__(self, path: str, loop: bool = True, pace: bool = False):
        self.iq, winfo = wav.read_iq_wav(path)
        self.info = SourceInfo(sample_rate=winfo.sample_rate,
                               center_freq_hz=winfo.center_freq_hz,
                               demod_mode=winfo.demod_mode, name=path)
        self.loop = loop
        self.pace = pace
        self.pos = 0
        self._t0 = None
        self._sent = 0

    def read_block(self, n: int) -> Optional[np.ndarray]:
        if self.pos + n > len(self.iq):
            if not self.loop:
                return None
            reps = [self.iq[self.pos:]]
            need = n - (len(self.iq) - self.pos)
            while need > len(self.iq):
                reps.append(self.iq)
                need -= len(self.iq)
            reps.append(self.iq[:need])
            out = np.concatenate(reps)
            self.pos = need
        else:
            out = self.iq[self.pos:self.pos + n]
            self.pos += n
        if self.pace:
            if self._t0 is None:
                self._t0 = time.monotonic()
            self._sent += n
            due = self._t0 + self._sent / self.info.sample_rate
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        return out


class SyntheticSource(Source):
    """Tone(s) + calibrated noise generator (ExampleSDRDevice / TestBench
    injection capability).  tones: list of (freq_hz, amplitude)."""

    def __init__(self, sample_rate: int, tones=((100_000.0, 0.5),),
                 noise_db: float | None = None, seed: int = 0):
        self.info = SourceInfo(sample_rate=sample_rate, name="synthetic")
        self.tones = list(tones)
        self.noise_db = noise_db
        self.rng = np.random.default_rng(seed)
        self.n_sent = 0

    def read_block(self, n: int) -> np.ndarray:
        t = (self.n_sent + np.arange(n)) / self.info.sample_rate
        out = np.zeros(n, np.complex64)
        for f, a in self.tones:
            out += (a * np.exp(2j * np.pi * f * t)).astype(np.complex64)
        if self.noise_db is not None:
            amp = 10.0 ** (self.noise_db / 20.0) / np.sqrt(2.0)
            out += amp * (self.rng.standard_normal(n)
                          + 1j * self.rng.standard_normal(n)).astype(np.complex64)
        self.n_sent += n
        return out


# Morse timing: dot=1 unit, dash=3, intra-char gap=1, char gap=3, word gap=7
_MORSE = {
    "a": ".-", "b": "-...", "c": "-.-.", "d": "-..", "e": ".", "f": "..-.",
    "g": "--.", "h": "....", "i": "..", "j": ".---", "k": "-.-", "l": ".-..",
    "m": "--", "n": "-.", "o": "---", "p": ".--.", "q": "--.-", "r": ".-.",
    "s": "...", "t": "-", "u": "..-", "v": "...-", "w": ".--", "x": "-..-",
    "y": "-.--", "z": "--..", "0": "-----", "1": ".----", "2": "..---",
    "3": "...--", "4": "....-", "5": ".....", "6": "-....", "7": "--...",
    "8": "---..", "9": "----.", ".": ".-.-.-", ",": "--..--", "?": "..--..",
    "/": "-..-.", "=": "-...-",
}


def morse_envelope(text: str, wpm: float, sample_rate: float) -> np.ndarray:
    """On/off keying envelope for text at wpm (PARIS timing: unit = 1.2/wpm s)."""
    unit = int(round(1.2 / wpm * sample_rate))
    env = []
    for word in text.lower().split():
        for ch in word:
            code = _MORSE.get(ch)
            if code is None:
                continue
            for sym in code:
                env.append(np.ones(unit * (3 if sym == "-" else 1), np.float32))
                env.append(np.zeros(unit, np.float32))
            env.append(np.zeros(2 * unit, np.float32))  # char gap (1+2=3)
        env.append(np.zeros(4 * unit, np.float32))      # word gap (3+4=7)
    return np.concatenate(env) if env else np.zeros(0, np.float32)


# Preset scenarios (MorseGenDevice's 5 preset slots, morsegendevice.cpp:114-160;
# the reference's defaults are the 5-generator 1-5 kHz ladder).  Each entry:
# (generators, noise_db) with generator = (text, wpm, freq_hz, amplitude,
# fade) — fade=True applies slow QSB to that generator.
MORSE_SCENARIOS = {
    # the reference's default generator ladder (morsegendevice.h:120-124:
    # 1-5 kHz, 10-50 wpm, -40 dB each)
    "ladder": ((("cq cq cq de gen1 gen1 k", 10.0, 1000.0, 0.01, False),
                ("cq cq cq de gen2 gen2 k", 20.0, 2000.0, 0.01, False),
                ("cq cq cq de gen3 gen3 k", 30.0, 3000.0, 0.01, False),
                ("cq cq cq de gen4 gen4 k", 40.0, 4000.0, 0.01, False),
                ("cq cq cq de gen5 gen5 k", 50.0, 5000.0, 0.01, False)),
               -60.0),
    # one strong steady station: clean-decode smoke test
    "single": ((("cq cq cq de pebble tpu", 20.0, 1000.0, 0.5, False),),
               -60.0),
    # QSB: stations fading through the noise — exercises adaptive thresholds
    "fading": ((("cq cq cq de qsb1 k", 15.0, 1000.0, 0.05, True),
                ("cq cq cq de qsb2 k", 25.0, 2500.0, 0.05, True)),
               -50.0),
    # weak signals near the noise floor
    "weak": ((("cq cq cq de weak k", 20.0, 1500.0, 0.003, False),),
             -55.0),
    # crowded band: close spacing stresses the compare-bin selectivity
    "pileup": ((("cq dx de p1 k", 22.0, 1000.0, 0.02, False),
                ("cq dx de p2 k", 28.0, 1150.0, 0.02, False),
                ("cq dx de p3 k", 18.0, 1300.0, 0.02, False)),
               -55.0),
}


class MorseGenSource(Source):
    """Synthetic CW test device (MorseGenDevice capability,
    morsegendevice.h:88-142): up to 5 parallel Morse generators at distinct
    frequencies/WPM/amplitudes plus calibrated noise; loops its message.

    Per-generator ``fade`` applies slow QSB: a raised-cosine amplitude swing
    of fade_depth_db at fade_hz with a random phase per generator (a smooth
    ionospheric-fade model; the reference's fade is per-sample random
    attenuation over a dB range, morsegendevice.cpp:1016-1021 — same
    capability, kinder statistics).  ``from_scenario`` loads a named preset
    (the reference's 5 preset slots)."""

    def __init__(self, sample_rate: int,
                 generators=(("cq cq cq de pebble tpu", 20.0, 10_000.0, 0.5),),
                 noise_db: float | None = -60.0, seed: int = 1,
                 fade_hz: float = 0.25, fade_depth_db: float = 30.0):
        # generators: (text, wpm, freq_hz, amplitude[, fade])
        self.info = SourceInfo(sample_rate=sample_rate, name="morsegen",
                               demod_mode="CWU")
        self.envs = []
        self.freqs = []
        self.amps = []
        self.fades = []
        rng = np.random.default_rng(seed)
        for gen in generators:
            text, wpm, freq, amp = gen[:4]
            self.envs.append(morse_envelope(text, wpm, sample_rate))
            self.freqs.append(freq)
            self.amps.append(amp)
            self.fades.append(bool(gen[4]) if len(gen) > 4 else False)
        self.fade_hz = fade_hz
        self.fade_depth_db = fade_depth_db
        self.fade_phases = rng.uniform(0, 2 * np.pi, size=len(self.envs))
        self.noise_db = noise_db
        self.rng = rng
        self.n_sent = 0

    @classmethod
    def from_scenario(cls, name: str, sample_rate: int, seed: int = 1,
                      **kwargs) -> "MorseGenSource":
        if name not in MORSE_SCENARIOS:
            raise KeyError(f"unknown scenario {name!r}; have "
                           f"{sorted(MORSE_SCENARIOS)}")
        gens, noise_db = MORSE_SCENARIOS[name]
        kwargs.setdefault("noise_db", noise_db)
        return cls(sample_rate, generators=gens, seed=seed, **kwargs)

    def read_block(self, n: int) -> np.ndarray:
        t = (self.n_sent + np.arange(n)) / self.info.sample_rate
        out = np.zeros(n, np.complex64)
        for g, (env, f, a) in enumerate(zip(self.envs, self.freqs, self.amps)):
            if len(env) == 0:
                continue
            idx = (self.n_sent + np.arange(n)) % len(env)
            amp = a * env[idx]
            if self.fades[g]:
                # raised-cosine dB swing: 0 dB at crest, -depth in the trough
                swing = 0.5 * (1.0 - np.cos(2 * np.pi * self.fade_hz * t
                                            + self.fade_phases[g]))
                amp = amp * 10.0 ** (-self.fade_depth_db * swing / 20.0)
            out += (amp * np.exp(2j * np.pi * f * t)).astype(np.complex64)
        if self.noise_db is not None:
            amp = 10.0 ** (self.noise_db / 20.0) / np.sqrt(2.0)
            out += amp * (self.rng.standard_normal(n)
                          + 1j * self.rng.standard_normal(n)).astype(np.complex64)
        self.n_sent += n
        return out
