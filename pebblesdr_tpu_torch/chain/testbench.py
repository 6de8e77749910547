"""TestBench: calibrated signal injection and tap capture on a live chain
(port of pebblesdr_tpu/chain/testbench.py).

Injects a tone, noise or sweep generator (core/siggen.py) into the IQ
stream before the chain and records the Receiver's named taps (raw_iq,
post_mixer, post_bp, post_demod; ReceiverConfig(taps=True)) and its audio
on the host, block by block: inject a known signal at a known dB, capture
every stage, assert or export.  The generators run on the Receiver's
device (the sweep as csrc/recur.cu's K7 on a card); the noise draws from a
torch.Generator seeded by `seed`.

Usage:
    tb = TestBench(rx, inject=("tone", {"freq_hz": 1e5, "db": -50.0}))
    state, out = tb.step(rx.init_state(), params, iq)   # taps recorded
    tb.history["post_bp"]   # deque of [C, n] numpy arrays
    tb.save("taps.npz")

TriggeredCapture is the oscilloscope-style triggered capture over a tap
stream (host numpy, a copy of the JAX package's).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver
from pebblesdr_tpu_torch.core import siggen


class TestBench:
    __test__ = False  # not a pytest class despite the name

    def __init__(self, rx: Receiver, inject: tuple[str, dict] | None = None,
                 history_depth: int = 64, seed: int = 0):
        if not rx.cfg.taps:
            raise ValueError("build the Receiver with "
                             "ReceiverConfig(taps=True)")
        self.rx = rx
        self.inject = inject
        self.history: dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=history_depth))
        self._tone_state = siggen.tone_init(rx.device)
        self._sweep_state = None
        self._gen = torch.Generator(device=rx.device)
        self._gen.manual_seed(seed)
        self.blocks = 0

    # ------------------------------------------------------------- injection

    def _injection(self, n: int) -> torch.Tensor | None:
        if self.inject is None:
            return None
        kind, p = self.inject
        amp = 10.0 ** (p.get("db", 0.0) / 20.0)
        if kind == "tone":
            self._tone_state, sig = siggen.tone(
                self._tone_state, n, p["freq_hz"], self.rx.cfg.sample_rate,
                amplitude=amp)
        elif kind == "noise":
            sig = siggen.noise(self._gen, n, db_level=p.get("db", 0.0))
        elif kind == "sweep":
            if self._sweep_state is None:
                self._sweep_state = siggen.sweep_init(p["start_hz"],
                                                      self.rx.device)
            self._sweep_state, sig = siggen.sweep(
                self._sweep_state, n, p["start_hz"], p["stop_hz"],
                p.get("rate_hz_per_sec", 1e5), self.rx.cfg.sample_rate,
                amplitude=amp,
                pulse_on_samples=p.get("pulse_on_samples", 0),
                pulse_period_samples=p.get("pulse_period_samples", 0))
        else:
            raise ValueError(kind)
        return sig[None, :]

    # ------------------------------------------------------------------ step

    def step(self, state, params, iq: torch.Tensor):
        """One block: iq [C, N] complex64 on the Receiver's device, the
        injection added to every channel."""
        sig = self._injection(iq.shape[-1])
        if sig is not None:
            iq = iq + sig
        state, out = self.rx.step(state, params, iq)
        for name, buf in out.get("taps", {}).items():
            self.history[name].append(buf.cpu().numpy())
        self.history["audio"].append(out["audio"].cpu().numpy())
        self.blocks += 1
        return state, out

    # ------------------------------------------------------------- analysis

    def tap(self, name: str) -> np.ndarray:
        """Concatenate the recorded history of one tap along time."""
        return np.concatenate(list(self.history[name]), axis=-1)

    def tap_spectrum_db(self, name: str,
                        sample_rate: float) -> tuple[np.ndarray, np.ndarray]:
        """(freqs, dB) averaged power spectrum of a recorded tap (channel
        0)."""
        x = self.tap(name)[0]
        n = 1 << int(np.floor(np.log2(min(len(x), 65536))))
        segs = x[: (len(x) // n) * n].reshape(-1, n)
        w = np.hanning(n)
        p = np.mean(np.abs(np.fft.fftshift(np.fft.fft(segs * w, axis=-1),
                                           axes=-1)) ** 2, axis=0)
        p /= (n * np.mean(w)) ** 2
        freqs = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / sample_rate))
        return freqs, 10 * np.log10(p + 1e-20)

    def save(self, path: str) -> None:
        arrays = {}
        for name in self.history:
            arr = self.tap(name)
            if np.iscomplexobj(arr):
                arrays[f"{name}_re"] = arr.real
                arrays[f"{name}_im"] = arr.imag
            else:
                arrays[name] = arr
        np.savez(path, **arrays)


class TriggeredCapture:
    """Oscilloscope-style triggered time capture over a tap stream
    (application/testbench.h:79-233: FREE_RUN / NORMAL / SINGLE with a
    positive or negative edge trigger): feed blocks, and armed captures
    fire when the signal crosses `level` with the configured slope,
    recording `n_pre` samples before and `n_post` after the trigger.

    modes: "free" (every feed yields a capture window), "normal" (re-arms
    after each trigger), "single" (fires once until rearm()).  Complex taps
    trigger on the real part."""

    def __init__(self, mode: str = "normal", level: float = 0.0,
                 slope: str = "rising", n_pre: int = 256,
                 n_post: int = 1024):
        if mode not in ("free", "normal", "single"):
            raise ValueError(f"trigger mode {mode!r}")
        if slope not in ("rising", "falling"):
            raise ValueError(f"trigger slope {slope!r}")
        self.mode, self.level, self.slope = mode, float(level), slope
        self.n_pre, self.n_post = int(n_pre), int(n_post)
        self.captures: list[np.ndarray] = []
        self._armed = True
        self._hist = np.zeros(0, np.complex64)
        self._pending: list[int] = []  # trigger offsets relative to buf END

    def rearm(self) -> None:
        self._armed = True

    def _crossings(self, sig: np.ndarray, start: int) -> np.ndarray:
        above = sig >= self.level
        if self.slope == "rising":
            hits = (~above[:-1]) & above[1:]
        else:
            hits = above[:-1] & (~above[1:])
        t = np.nonzero(hits)[0] + 1
        return t[t >= start]  # new samples only (history was scanned before)

    def feed(self, block: np.ndarray) -> int:
        """Feed one tap block ([n] or [C, n]: channel 0 is used).  Returns
        the number of captures fired by this block."""
        x = np.asarray(block)
        if x.ndim == 2:
            x = x[0]
        buf = np.concatenate([self._hist, x])
        new_start = len(self._hist)
        fired = 0
        if self.mode == "free":
            if len(x) >= self.n_pre + self.n_post:
                self.captures.append(x[:self.n_pre + self.n_post].copy())
                fired = 1
        else:
            sig = buf.real if np.iscomplexobj(buf) else buf
            # crossings carried over from the last feed (their post-window
            # had not arrived yet): offsets are relative to the previous
            # buffer's end, this buffer's history end (new_start)
            todo = [new_start + t for t in self._pending]
            self._pending = []
            if self._armed:
                todo += list(self._crossings(sig, max(new_start, 1)))
            for t in todo:
                if t < self.n_pre:
                    continue  # not enough pre-history at stream start
                if t + self.n_post > len(buf):
                    self._pending.append(t - len(buf))  # wait for more
                    continue
                if not self._armed and self.mode == "single":
                    continue
                self.captures.append(buf[t - self.n_pre:
                                         t + self.n_post].copy())
                fired += 1
                if self.mode == "single":
                    self._armed = False
        keep = max(self.n_pre + self.n_post, 1)
        self._hist = buf[-keep:]
        return fired
