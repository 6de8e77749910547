"""Play a recorded IQ WAV through the receive chain and write its audio.

Port of examples/01_file_playback.py (the reference's FileSDRDevice +
Receiver power-on flow): the recording, or without one a synthesized 1 s
AM fixture at +250 kHz, through the AM Receiver block by block, the
S-meter of each block, the audio written as a 48 kHz WAV.

    python -m pebblesdr_tpu_torch.examples.ex01_file_playback [IQ.wav] \\
        [--device cpu] [--out DIR]
"""

from __future__ import annotations

import os

import numpy as np
import torch

N = 32768


def main(argv=None) -> dict:
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.examples import parse_args
    from pebblesdr_tpu_torch.io import sources, wav

    def add(p):
        p.add_argument("path", nargs="?", help="IQ WAV (default: synthesize)")
        p.add_argument("--out", default="build/examples",
                       help="directory for the fixture and the audio")

    args = parse_args(__doc__, argv, add)
    os.makedirs(args.out, exist_ok=True)
    path = args.path
    if path is None:
        path = os.path.join(args.out, "example_am.wav")
        fs = 2_048_000
        t = np.arange(fs) / fs
        env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
        iq = (0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
              ).astype(np.complex64)
        wav.write_iq_wav(path, iq, fs, center_freq_hz=250_000.0,
                         demod_mode="AM")
        print(f"synthesized fixture {path}")

    src = sources.FileSource(path, loop=False)
    rx = Receiver(ReceiverConfig(sample_rate=src.info.sample_rate,
                                 frames_per_buffer=N, mode=DemodMode.AM),
                  args.device)
    state = rx.init_state()
    params = rx.default_params(src.info.center_freq_hz)
    audio, signal_db, snr_db = [], [], []
    for blk in src.blocks(N):
        state, out = rx.step(state, params, torch.from_numpy(
            np.ascontiguousarray(blk[None], np.complex64)).to(rx.device))
        audio.append(out["audio"][0].cpu().numpy())
        signal_db.append(float(out["smeter"]["signal_db"][0]))
        snr_db.append(float(out["smeter"]["snr_db"][0]))
        print(f"S-meter {signal_db[-1]:6.1f} dB  SNR {snr_db[-1]:5.1f} dB",
              end="\r")
    audio_path = os.path.join(args.out, "example_audio.wav")
    samples = np.concatenate(audio)
    wav.write_audio_wav(audio_path, samples, rx.cfg.audio_rate)
    print(f"\naudio -> {audio_path} ({len(samples)} samples)")
    return dict(audio_path=audio_path, samples=len(samples),
                audio_rate=rx.cfg.audio_rate, signal_db=signal_db,
                snr_db=snr_db)


def check(res: dict) -> None:
    """The outcome of the synthesized fixture: 62 blocks of audio in the
    WAV, a steady S-meter from the second block on and its SNR >= 60 dB."""
    size = os.path.getsize(res["audio_path"])
    sig = np.asarray(res["signal_db"][1:])
    if res["samples"] != 62 * 768 or size != 44 + 2 * res["samples"]:
        raise RuntimeError(f"audio: {res['samples']} samples, {size} bytes")
    if np.ptp(sig) > 0.1 or min(res["snr_db"][1:]) < 60.0:
        raise RuntimeError(f"S-meter {sig.min():.2f}..{sig.max():.2f} dB, "
                           f"SNR from {min(res['snr_db'][1:]):.1f} dB")


if __name__ == "__main__":
    main()
