"""The noise blanker, the CTCSS tone squelch, the DTMF dial decoder over
the NFM chain, and the live control surface driven by scripted keys.

Port of examples/05_interactive_and_decoders.py: an NFM station at +300
kHz of a 2.048 Msps capture carrying a 123.0 Hz CTCSS access tone and the
dial string "2468", with impulse noise for the blanker; 80 blocks through
the FMN Receiver with NB1 (in the fused front end) and the CTCSS squelch,
the squelch nudged twice by the control surface on block 10 (params only:
the same Receiver keeps stepping), the audio through the DTMF modem and
decoder.

    python -m pebblesdr_tpu_torch.examples.ex05_interactive_and_decoders \\
        [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

FS, N = 2_048_000, 32768
BLOCKS = 80


def main(argv=None) -> dict:
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.examples import parse_args
    from pebblesdr_tpu_torch.modem import dtmf
    from pebblesdr_tpu_torch.serve.control import ControlSurface

    args = parse_args(__doc__, argv)
    # the station: CTCSS 123.0 Hz, the dial string half a second in, and
    # impulse noise for the blanker to eat
    t = np.arange(BLOCKS * N) / FS
    dial = dtmf.encode_dtmf("2468", 48000.0, tone_ms=80, gap_ms=80)
    afull = np.zeros(int(BLOCKS * N / FS * 48000) + 1, np.float32)
    afull[24000:24000 + len(dial)] = dial
    voice = np.interp(t, np.arange(len(afull)) / 48000.0, afull)
    dev = 2500.0 * voice + 500.0 * np.sin(2 * np.pi * 123.0 * t)
    phase = 2 * np.pi * np.cumsum(dev) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + phase))
          ).astype(np.complex64)
    rng = np.random.default_rng(0)
    spikes = rng.choice(len(iq), 200, replace=False)
    iq[spikes] += 8.0 - 8.0j

    # FMN + noise blanker (inside the fused front end) + CTCSS squelch
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                 mode=DemodMode.FMN,
                                 enable_noise_blanker=True, ctcss_tone=123.0),
                  args.device)
    state = rx.init_state()
    surface = ControlSurface(rx, rx.default_params(300_000.0), 300_000.0)

    modem = dtmf.DtmfModem(48000.0)
    dec = dtmf.DtmfDecoder()
    x = torch.from_numpy(iq).to(rx.device)
    audio, opens = [], []
    for i in range(BLOCKS):
        if i == 10:
            for key in ("s", "s"):          # squelch -10 dB, then -7 dB
                print("*", surface.handle(key))
        state, out = rx.step(state, surface.params, x[None, i * N:(i + 1) * N])
        opens.append(bool(out["ctcss_open"][0]))
        audio.append(out["audio"][0])
    audio_buf = torch.cat(audio)
    n_use = (len(audio_buf) // modem.frame) * modem.frame
    dec.feed(modem.detect(audio_buf[None, :n_use])[0].cpu().numpy())

    first_open = opens.index(True) if any(opens) else None
    print(f"CTCSS opened on block {first_open} (coherent-EWMA integration)"
          if first_open is not None else "CTCSS never opened")
    print(f"decoded dial string: {dec.digits!r}")
    return dict(ctcss_first_open=first_open, ctcss_open_blocks=sum(opens),
                digits=dec.digits, events=list(surface.events))


def check(res: dict) -> None:
    """The dial string decoded, the CTCSS squelch open, the two squelch
    keys applied."""
    if (res["digits"] != "2468" or res["ctcss_first_open"] is None
            or res["events"] != ["SQL -10 dB", "SQL -7 dB"]):
        raise RuntimeError(f"decoder outcome {res}")


if __name__ == "__main__":
    main()
