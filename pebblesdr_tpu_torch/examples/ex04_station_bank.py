"""Dense-bank monitoring: one wideband capture -> many stations at once.

Port of examples/04_station_bank.py: the polyphase filterbank front
(chain/pfb_bank.py) channelizes the whole capture in one pass and every
station gets the full receive chain (fine tune, bandpass, AGC, demod,
S-meter, squelch) at the low channel rate; the shipped station database
picks the tunes (the stations within 90 % of a 2.048 Msps capture centred
on 10 MHz).  A modulated carrier on the first station, 4 blocks in one
dispatch through the batched bank tail.

    python -m pebblesdr_tpu_torch.examples.ex04_station_bank [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

FS = 2_048_000
FRAMES = 32768
CENTER = 10_000_000.0  # capture centred on 10 MHz (31 m broadcast band)


def main(argv=None) -> dict:
    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.examples import parse_args
    from pebblesdr_tpu_torch.utils import settings

    args = parse_args(__doc__, argv)
    # 1. stations inside the capture window, from the shipped DB
    stations = settings.stations_near(settings.load_stations(), CENTER,
                                      FS * 0.9)
    tunes = np.array([p.freq_hz - CENTER for p in stations])
    print(f"{len(stations)} DB stations inside the {FS/1e6:.3f} MHz window:")
    for p in stations:
        print(f"  {p.name:>18s}  {p.freq_hz/1e6:9.4f} MHz  {p.mode}")

    # 2. the bank: oversample=2 keeps edge-station sidebands intact
    bank = PfbBankReceiver(FS, FRAMES, tunes, mode=DemodMode.AM,
                           oversample=2, agc_mode="med", device=args.device)
    state = bank.init_state()

    # 3. a capture with a modulated carrier on the first station
    t = np.arange(4 * FRAMES) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 600.0 * t)) / 2
    iq = (0.5 * env * np.exp(2j * np.pi * tunes[0] * t)).astype(np.complex64)
    rng = np.random.default_rng(0)
    iq += 1e-4 * (rng.standard_normal(len(t))
                  + 1j * rng.standard_normal(len(t))).astype(np.complex64)

    # 4. run: K blocks per dispatch through the batched bank tail
    state, out = bank.step_many(state, torch.from_numpy(
        np.stack([iq.real, iq.imag], axis=1)).to(bank.device))
    snr = out["smeter"]["snr_db"][-1].cpu().numpy()
    audio = out["audio"].cpu().numpy()          # [K, C, M]
    rms = np.sqrt(np.mean(audio ** 2, axis=(0, 2)))
    print("\nper-station SNR / audio RMS after 4 blocks:")
    for i, p in enumerate(stations):
        mark = "  <-- active" if i == 0 else ""
        print(f"  {p.name:>18s}  {snr[i]:7.1f} dB  rms {rms[i]:.4f}{mark}")
    return dict(stations=[p.name for p in stations], tunes=tunes.tolist(),
                snr_db=snr.tolist(), rms=rms.tolist())


def check(res: dict) -> None:
    """The database's stations in the window, the first one active: its
    S-meter SNR >= 60 dB and its audio the loudest by 20 dB."""
    from pebblesdr_tpu_torch.utils import settings
    want = [p.name for p in settings.stations_near(
        settings.load_stations(), CENTER, FS * 0.9)]
    rms = np.asarray(res["rms"])
    if (res["stations"] != want or res["snr_db"][0] < 60.0
            or rms[0] < 10.0 * np.delete(rms, 0).max()):
        raise RuntimeError(f"bank outcome {res}")


if __name__ == "__main__":
    main()
