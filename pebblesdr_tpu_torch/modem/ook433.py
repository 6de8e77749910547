"""433 MHz weather-sensor OOK decoder, Oregon Scientific v2.1 style (port
of pebblesdr_tpu/modem/ook433.py).

Manchester-coded OOK bursts from ISM-band sensors: preamble sync, nibble
assembly, sensor id, channel, temperature, checksum.  OokDemod is the
device half: the envelope |x| averaged over short frames and held to the
midpoint of its min and max (no scan); OsV2Decoder (edge timing ->
Manchester half-bits -> the OSv2 frame) and encode_osv2 are host copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

OSV2_BAUD = 1024.0  # half-bit rate of the Manchester stream


class OokDemod:
    """[C, N] complex -> on/off envelope decisions per frame."""

    def __init__(self, sample_rate: float, frame: int | None = None):
        self.sample_rate = sample_rate
        # ~8 frames per half-bit for edge resolution
        self.frame = frame or max(1, int(sample_rate / OSV2_BAUD / 8))
        self.frame_rate = sample_rate / self.frame

    def detect(self, x: torch.Tensor) -> torch.Tensor:
        c, n = x.shape
        f = n // self.frame
        env = x[:, :f * self.frame].abs().reshape(c, f, self.frame).mean(-1)
        thresh = 0.5 * (env.amax(-1, keepdim=True)
                        + env.amin(-1, keepdim=True))
        return env > thresh


@dataclasses.dataclass
class OsV2Decoder:
    """on/off frames -> Manchester half-bits -> OSv2 message fields."""

    frame_rate: float
    messages: list = dataclasses.field(default_factory=list)

    def feed(self, on: np.ndarray) -> None:
        on = np.asarray(on).astype(bool).ravel()
        half = self.frame_rate / OSV2_BAUD  # frames per half-bit
        # run-length encode
        runs = []
        cur, cnt = on[0], 0
        for v in on:
            if v == cur:
                cnt += 1
            else:
                runs.append((cur, cnt))
                cur, cnt = v, 1
        runs.append((cur, cnt))
        # Manchester: each run is 1 or 2 half-bit periods
        halves = []
        for level, n in runs:
            k = int(round(n / half))
            if k <= 0 or k > 2:
                if halves:
                    self._parse(halves)
                halves = []
                continue
            halves.extend([level] * k)
        if halves:
            self._parse(halves)

    def _parse(self, halves: list) -> None:
        # Manchester decode: a transition low->high = 1, high->low = 0 (OSv2
        # convention).  The first half-bit can be swallowed by preceding
        # silence (same level), so try both phase offsets.
        for phase in (0, 1):
            if self._parse_phase(halves[phase:]):
                return

    def _parse_phase(self, halves: list) -> bool:
        bits = []
        i = 0
        while i + 1 < len(halves):
            a, b = halves[i], halves[i + 1]
            if a == b:  # phase slip — resync by dropping one half
                i += 1
                continue
            bits.append(1 if (not a and b) else 0)
            i += 2
        if len(bits) < 40:
            return False
        logical = bits
        # hunt for the sync nibble 0101 after a >=12-one preamble
        ones = 0
        for j in range(len(logical) - 24):
            if logical[j] == 1:
                ones += 1
                continue
            if ones >= 12 and logical[j:j + 4] == [0, 1, 0, 1]:
                self._parse_payload(logical[j + 4:])
                return True
            ones = 0
        return False

    def _parse_payload(self, bits: list) -> None:
        # nibbles LSB-first
        nibbles = []
        for k in range(0, len(bits) - 3, 4):
            nib = bits[k] | (bits[k + 1] << 1) | (bits[k + 2] << 2) | (bits[k + 3] << 3)
            nibbles.append(nib)
        if len(nibbles) < 11:  # id(4) + ch(1) + temp(3) + sign(1) + ck(2)
            return
        sensor_id = (nibbles[0] << 12) | (nibbles[1] << 8) | (nibbles[2] << 4) | nibbles[3]
        channel = nibbles[4]
        # temperature BCD: t = sign * (n7*10 + n6 + n5/10)
        temp = nibbles[7] * 10.0 + nibbles[6] + nibbles[5] / 10.0
        if nibbles[8] & 0x8:
            temp = -temp
        checksum = (nibbles[9] << 4) | nibbles[10] if len(nibbles) > 10 else None
        calc = sum(nibbles[:9]) & 0xFF
        self.messages.append({
            "sensor_id": sensor_id,
            "channel": channel,
            "temperature_c": round(temp, 1),
            "checksum_ok": checksum == calc,
        })


def encode_osv2(sensor_id: int, channel: int, temperature_c: float,
                sample_rate: float, carrier_offset_hz: float = 0.0,
                amplitude: float = 1.0) -> np.ndarray:
    """Fixture: build an OSv2-style OOK burst as complex baseband."""
    nibbles = [
        (sensor_id >> 12) & 0xF, (sensor_id >> 8) & 0xF,
        (sensor_id >> 4) & 0xF, sensor_id & 0xF,
        channel & 0xF,
    ]
    t10 = abs(temperature_c)
    nibbles += [int(round(t10 * 10)) % 10, int(t10) % 10, int(t10 // 10) % 10]
    nibbles += [0x8 if temperature_c < 0 else 0x0]
    ck = sum(nibbles[:9]) & 0xFF
    nibbles += [(ck >> 4) & 0xF, ck & 0xF, 0, 0]
    bits = [1] * 16 + [0, 1, 0, 1]
    for nib in nibbles:
        bits += [(nib >> b) & 1 for b in range(4)]
    # Manchester: 1 -> (low, high), 0 -> (high, low)
    halves = []
    for b in bits:
        halves += ([0, 1] if b else [1, 0])
    n_half = int(round(sample_rate / OSV2_BAUD))
    env = np.repeat(np.asarray(halves, np.float32), n_half)
    t = np.arange(len(env)) / sample_rate
    osc = np.exp(2j * np.pi * carrier_offset_hz * t) if carrier_offset_hz else 1.0
    return (amplitude * env * osc).astype(np.complex64)
