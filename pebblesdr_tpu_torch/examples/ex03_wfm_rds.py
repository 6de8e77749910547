"""WFM stereo + RDS: a synthesized broadcast FM station (stereo pilot and
the RDS PS name) demodulated, its stereo separation and decoded name.

Port of examples/03_wfm_rds.py: L 1 kHz and R 3 kHz, the pilot, and RDS
groups 0A carrying "TPU FM  " under PI 0x54A8, at +300 kHz of a 2.048 Msps
capture; 30 blocks through the FMS Receiver with the RDS tap, block by
block, the soft symbols fed to the host decoder.

    python -m pebblesdr_tpu_torch.examples.ex03_wfm_rds [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

FS, N, NB = 2_048_000, 32768, 30
PS = "TPU FM  "


def amp(x: np.ndarray, f: float, rate: float = 48000.0) -> float:
    tt = np.arange(x.shape[-1]) / rate
    b = np.stack([np.cos(2 * np.pi * f * tt), np.sin(2 * np.pi * f * tt)])
    c, *_ = np.linalg.lstsq(b.T, x, rcond=None)
    return float(np.hypot(*c))


def main(argv=None) -> dict:
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod import rds
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.examples import parse_args

    args = parse_args(__doc__, argv)
    # RDS bitstream: PS name on PI 0x54A8 (-> callsign WAAA)
    bits = []
    for _ in range(20):
        for seg in range(4):
            b = (0 << 12) | (5 << 5) | seg
            d = (ord(PS[2 * seg]) << 8) | ord(PS[2 * seg + 1])
            bits.extend(rds.encode_group(0x54A8, b, 0xE0E0, d))
    diff, last = [], 0
    for b in bits:
        last ^= b
        diff.append(last)
    sym = np.asarray(diff, np.float64) * 2 - 1

    t = np.arange(NB * N) / FS
    sidx = np.minimum((t * rds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    frac = t * rds.RDS_BAUD - sidx
    biphase = sym[sidx] * np.where(frac < 0.5, 1.0, -1.0)
    left = np.sin(2 * np.pi * 1000.0 * t)
    right = np.sin(2 * np.pi * 3000.0 * t)
    comp = (0.4 * (left + right) / 2
            + 0.4 * (left - right) / 2 * np.sin(2 * 2 * np.pi * 19000.0 * t)
            + 0.09 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.05 * biphase * np.cos(2 * np.pi * 57000.0 * t))
    phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))
          ).astype(np.complex64)

    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                 mode=DemodMode.FMS, rds=True), args.device)
    state = rx.init_state()
    params = rx.default_params(300_000.0)
    block_dec = rds.RdsBlockDecoder()
    x = torch.from_numpy(iq).to(rx.device)
    audio = []
    for i in range(NB):
        state, out = rx.step(state, params, x[None, i * N:(i + 1) * N])
        audio.append(out["audio"][0].cpu().numpy())
        block_dec.feed_symbols(out["rds_soft"][0].cpu().numpy())

    a = np.concatenate(audio, axis=-1)[:, 10 * rx.audio_blk:]
    locked = bool(out["pilot_locked"][0])
    levels = {f"{ch}{f // 1000}k": amp(a[i], f)
              for i, ch in enumerate("LR") for f in (1000, 3000)}
    sep = 20 * np.log10(levels["L1k"] / max(levels["R1k"], 1e-9))
    print(f"pilot locked: {locked}")
    print(f"L: 1k={levels['L1k']:.3f} 3k={levels['L3k']:.3f}   "
          f"R: 1k={levels['R1k']:.3f} 3k={levels['R3k']:.3f}")
    print(f"stereo separation: {sep:.1f} dB")
    g = rds.RdsGroupDecoder()
    for grp in block_dec.groups:
        g.decode(grp)
    print(f"RDS: PS={g.ps_name!r} PI=0x{g.pi:04X} callsign={g.callsign} "
          f"({block_dec.blocks_ok} blocks, {block_dec.block_errors} errors)")
    return dict(pilot_locked=locked, levels=levels, separation_db=float(sep),
                ps=g.ps_name, pi=g.pi, callsign=g.callsign,
                blocks_ok=block_dec.blocks_ok,
                block_errors=block_dec.block_errors)


def check(res: dict) -> None:
    """Pilot locked, separation >= 30 dB, the PS name decoded without a
    block error."""
    if not (res["pilot_locked"] and res["separation_db"] >= 30.0
            and res["ps"] == PS and res["callsign"] == "WAAA"
            and res["blocks_ok"] > 0 and res["block_errors"] == 0):
        raise RuntimeError(f"WFM/RDS outcome {res}")


if __name__ == "__main__":
    main()
