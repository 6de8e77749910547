"""64-channel channelizer: one wideband capture -> 64 concurrent AM demods.

Port of examples/02_channelizer.py (BASELINE.json config #4): 8 AM
stations across +-800 kHz of a 2.048 Msps capture, 64 channels tuned
evenly across the band, each with its own tune, the whole bank one
Receiver step over [channels, block]; 4 blocks.  The channels on a station
are those whose tune is nearest one: 0, 9, ..., 63 (the stations sit 9
watcher steps apart; the JAX example prints "near multiples of 8").

    python -m pebblesdr_tpu_torch.examples.ex02_channelizer [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

FS, N, C = 2_048_000, 32768, 64
LEVEL_DB = -60.0   # a channel on a station reads above this


def main(argv=None) -> dict:
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.examples import parse_args

    args = parse_args(__doc__, argv)
    # one capture with 8 AM stations; all 64 channels watch different slots
    t = np.arange(4 * N) / FS
    capture = np.zeros(4 * N, np.complex64)
    station_freqs = np.linspace(-800_000, 800_000, 8)
    for i, f in enumerate(station_freqs):
        env = (1 + 0.8 * np.cos(2 * np.pi * (500 + 200 * i) * t)) / 2
        capture += (0.2 * env * np.exp(2j * np.pi * f * t)
                    ).astype(np.complex64)

    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                 channels=C, mode=DemodMode.AM), args.device)
    state = rx.init_state()
    tunes = np.linspace(-800_000, 800_000, C)  # 64 watchers across the band
    params = rx.default_params(tunes)
    x = torch.from_numpy(capture).to(rx.device)
    for i in range(4):
        state, out = rx.step(state, params,
                             x[i * N:(i + 1) * N].expand(C, N))

    sm = out["smeter"]["signal_db"].cpu().numpy()
    print("per-channel signal levels (dB):")
    for c in range(0, C, 8):
        row = " ".join(f"{sm[k]:6.1f}" for k in range(c, c + 8))
        print(f"  ch{c:02d}+ {row}")
    hot = [int(k) for k in np.flatnonzero(sm > LEVEL_DB)]
    nearest = sorted({int(np.argmin(np.abs(tunes - f)))
                      for f in station_freqs})
    print(f"channels on a station: {hot} (the nearest to each station: "
          f"{nearest})")
    return dict(signal_db=sm.tolist(), hot=hot, nearest=nearest)


def check(res: dict) -> None:
    """The channels on a station are the nearest watchers, and only they."""
    if res["hot"] != res["nearest"] or len(res["hot"]) != 8:
        raise RuntimeError(f"channels on a station {res['hot']}, expected "
                           f"{res['nearest']}")


if __name__ == "__main__":
    main()
