"""Sustained-stream soak of the PyTorch port: WFM stereo + RDS at 64
channels, the state carried across every dispatch, the host RDS decode
running; watches for NaNs, pilot-lock dropouts, RDS sync loss and drift.
The port of tools/soak.py (its signal, checks and JSON line).

    python -m pebblesdr_tpu_torch.tools.soak [--device cuda|cpu]

Environment: SOAK_SECONDS (default 120) of wall clock, SOAK_CHANNELS (64),
SOAK_BLOCKS (32 blocks of 32768 frames per dispatch), SOAK_HQ (0; 1 for
the hq geometry).  Runs on the card unless --device says otherwise (no
fallback: --device cuda without a CUDA device is an error).  Prints one
JSON line: the JAX soak's keys and the device's name.  At least one
dispatch is checked, whatever SOAK_SECONDS says.

The fixture loops every dispatch (0.512 s at K = 32) and 104-bit groups
do not divide the loop, so every seam corrupts a block or two and forces a
resync: the reported BLER is dominated by that deliberate adversity.  The
pass criteria are zero bad dispatches (non-finite audio or a pilot not
locked), sync held and the PS name decoded: the port's gate after a
kernel change.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

N = 32768
FS = 2_048_000


def ps_group_bits() -> list[int]:
    """24 repeats of the four 0A groups (PTY 5, no AF codes) that carry the
    PS name "PEBBLES " under PI 0x54A8 (tests/test_rds.py make_ps_groups),
    from the port's demod/rds.py encode_group."""
    from pebblesdr_tpu_torch.demod import rds
    bits = []
    for _ in range(24):
        for seg in range(4):
            d = (ord("PEBBLES "[2 * seg]) << 8) | ord("PEBBLES "[2 * seg + 1])
            bits += rds.encode_group(0x54A8, (5 << 5) | seg, 0xE0E0, d)
    return bits


def rds_biphase(t: np.ndarray) -> np.ndarray:
    """The PS groups (ps_group_bits) differentially encoded, as biphase
    symbols at 1187.5 baud sampled at times t (the last symbol held past
    the end)."""
    from pebblesdr_tpu_torch.demod import rds
    sym = np.cumsum(ps_group_bits()) % 2 * 2.0 - 1.0
    idx = np.minimum((t * rds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    return sym[idx] * np.where(t * rds.RDS_BAUD - idx < 0.5, 1.0, -1.0)


def soak_plane(channels: int, blocks: int) -> np.ndarray:
    """One dispatch's [blocks * N, 2C] float32 lane-packed plane: broadcast
    FM at +250 kHz (1 kHz mono at 0.3, the pilot at 0.1, RDS at 0.06 on 57
    kHz, 75 kHz deviation) on every channel."""
    t = np.arange(blocks * N) / FS
    comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.06 * rds_biphase(t) * np.cos(2 * np.pi * 57000.0 * t))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
          ).astype(np.complex64)
    return np.concatenate(
        [np.broadcast_to(iq.real.astype(np.float32)[:, None],
                         (blocks * N, channels)),
         np.broadcast_to(iq.imag.astype(np.float32)[:, None],
                         (blocks * N, channels))], axis=1)


def run(seconds: float, channels: int, blocks: int, hq: bool,
        device) -> dict:
    """The soak: one warm-up dispatch, then dispatches for `seconds` of
    wall clock (at least one), each checked (finite audio, the pilot
    locked on every channel at the last block, the audio's peak) and its
    channel-0 RDS symbols decoded on the host.  Returns the JSON line's
    fields."""
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod import rds as rds_mod
    from pebblesdr_tpu_torch.demod.modes import DemodMode

    device = torch.device(device)
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                         channels=channels, mode=DemodMode.FMS, rds=True,
                         agc_stride=16, wfm_hq=hq)
    rx = Receiver(cfg, device)
    state = rx.init_state()
    params = rx.default_params(250_000.0)
    iq = torch.from_numpy(soak_plane(channels, blocks)).to(device)

    state, out = rx.step_many(state, params, iq, spectra=False)
    float(out["audio"].abs().sum())                   # wait for the warm-up
    dec = rds_mod.RdsBlockDecoder()
    grp = rds_mod.RdsGroupDecoder()
    dispatches = bad = 0
    peak = 0.0
    t0 = time.perf_counter()
    while dispatches == 0 or time.perf_counter() - t0 < seconds:
        state, out = rx.step_many(state, params, iq, spectra=False)
        audio = out["audio"]
        fin, locked, mx = torch.stack([
            torch.isfinite(audio).all().float(),
            out["pilot_locked"][-1].all().float(),
            audio.abs().max()]).tolist()
        if not (fin and locked):
            bad += 1
        peak = max(peak, mx)
        dec.feed_symbols(out["rds_soft"][:, 0].reshape(-1).cpu().numpy())
        for g in dec.groups:
            grp.decode(g)
        dec.groups.clear()
        dispatches += 1
    wall = time.perf_counter() - t0
    samples = dispatches * blocks * N * channels
    total_blocks = dec.blocks_ok + dec.block_errors
    return {
        "seconds": round(wall, 1),
        "dispatches": dispatches,
        "blocks": dispatches * blocks,
        "msps_sustained": round(samples / wall / 1e6, 1),
        "bad_dispatches": bad,
        "audio_peak": round(peak, 3),
        "rds_blocks_ok": dec.blocks_ok,
        "rds_block_errors": dec.block_errors,
        "rds_bler": round(dec.block_errors / max(1, total_blocks), 4),
        "rds_ps": grp.ps_name,
        "rds_synced": dec.synced,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the default), 'cuda:N' or "
                        "'cpu'")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device (pass --device "
                f"cpu to run on the CPU)")
    res = run(float(os.environ.get("SOAK_SECONDS", "120")),
              int(os.environ.get("SOAK_CHANNELS", "64")),
              int(os.environ.get("SOAK_BLOCKS", "32")),
              bool(int(os.environ.get("SOAK_HQ", "0"))), args.device)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
