"""Command-line receiver of the PyTorch port: file/synthetic IQ in ->
demodulated audio WAV out, on the card (``--device cuda``, the default) or
the CPU (``--device cpu``).

Port of pebblesdr_tpu/serve/cli.py (make_source, _run_stations and main):
select a source, configure the chain, run it K blocks per dispatch through
the port's Receiver.step_many (or the dense filterbank bank with
--stations), write the audio and print Perform-style metrics (Msamples/s,
real-time factor) under the JAX CLI's JSON keys.  Each dispatch ships one
unfolded [K*N, 2C] float32 plane (the JAX CLI's time-fold is a TPU layout);
the audio is fetched inside the timed region.  The device's name goes to
stderr.  There is no fallback: --device cuda without a CUDA device is an
error.

Examples:
  python -m pebblesdr_tpu_torch.serve.cli --wav capture.wav --mode AM \\
      --tune 250000 --seconds 5 --audio-out audio.wav
  python -m pebblesdr_tpu_torch.serve.cli --synthetic tone --mode USB \\
      --tune 400000 --seconds 0.3 --audio-out /tmp/a.wav --json --device cpu

--decode cw|rtty runs the modem (modem/morse.py, modem/rtty.py) on
channel 0's post_bp tap (ReceiverConfig(taps=True): the staged front),
re-framed to whole modem frames on the device; --decode wwv|dtmf on the
demodulated audio of channel 0.  The decoded text, time or digits go
under the JAX CLI's JSON keys (decoded_text, decoded_time,
decoded_digits).

--checkpoint PATH saves the receiver's state to PATH (utils/checkpoint.py,
the JAX package's .npz format) at exit; with --checkpoint-every K the
stream-recovery supervisor (utils/recovery.py) also snapshots it every K
blocks and the JSON gains "health" (its report: blocks, drops, overruns,
real-time factor and events); --resume PATH restores a saved state before
the first block, so a stopped run continues bit for bit.

Flags whose modules are not ported yet (--display, --display-zoomed,
--keys, --presets, --bandscope, --assign, --source
rtl_tcp|sdr_ip|hpsdr|audio, --audio-out device:...|pipe:...) exit with
code 2 and name the module.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import modes as modes_mod
from pebblesdr_tpu_torch.io import sources, wav
from pebblesdr_tpu_torch.utils import checkpoint as ckpt
from pebblesdr_tpu_torch.utils.perform import Perform
from pebblesdr_tpu_torch.utils.recovery import StreamSupervisor

# what each deferred option waits for (the JAX package's modules)
_DEFERRED = {
    "display": "pebblesdr_tpu/serve/display.py",
    "display_zoomed": "pebblesdr_tpu/serve/display.py",
    "keys": "pebblesdr_tpu/serve/control.py",
    "presets": "pebblesdr_tpu/serve/control.py",
    "bandscope": "pebblesdr_tpu/io/hpsdr.py and serve/display.py",
    "assign": "pebblesdr_tpu/parallel/expert.py",
}
_NET_SOURCES = {"rtl_tcp": "pebblesdr_tpu/io/rtl_tcp.py",
                "sdr_ip": "pebblesdr_tpu/io/sdr_ip.py",
                "hpsdr": "pebblesdr_tpu/io/hpsdr.py",
                "audio": "pebblesdr_tpu/io/audio_iq.py"}


def make_source(args) -> sources.Source:
    if args.source:
        name = args.source.lower()
        if name == "file":
            return sources.FileSource(args.wav or args.path, pace=args.pace)
        if name == "synthetic":
            return sources.SyntheticSource(args.sample_rate)
        if name == "morsegen":
            return sources.MorseGenSource(args.sample_rate)
        raise ValueError(f"unknown source {args.source!r}; available: file, "
                         f"morsegen, synthetic")
    if args.wav:
        return sources.FileSource(args.wav, loop=True, pace=args.pace)
    fs = args.sample_rate
    kind = args.synthetic or "am"
    if kind == "am":
        # AM station at the tune offset, 1 kHz 80% modulation: two sidebands
        return sources.SyntheticSource(
            fs, tones=((args.tune, 0.25), (args.tune + 1000.0, 0.1),
                       (args.tune - 1000.0, 0.1)), noise_db=args.noise_db)
    if kind == "tone":
        return sources.SyntheticSource(fs, tones=((args.tune + 1000.0, 0.5),),
                                       noise_db=args.noise_db)
    if kind == "morse":
        return sources.MorseGenSource(
            fs, generators=(("cq cq cq de pebble tpu", 20.0, args.tune + 1000.0,
                             0.5),),
            noise_db=args.noise_db)
    raise SystemExit(f"unknown synthetic source {kind!r}")


def _read_dispatch(source, frames: int, kdisp: int):
    """Up to kdisp blocks of the source, zero-padded to kdisp (the same
    dispatch shape; the padded blocks are trimmed after): (blocks read,
    [kdisp * frames] complex64), or (0, None) at the end of the stream."""
    blks = []
    for _ in range(kdisp):
        blk = source.read_block(frames)
        if blk is None:
            break
        blks.append(blk)
    if not blks:
        return 0, None
    k_real = len(blks)
    blks.extend(np.zeros(frames, np.complex64) for _ in range(kdisp - k_real))
    return k_real, np.concatenate(blks)


def _run_stations(args, source, device) -> int:
    """Dense-bank monitoring: one wideband capture -> many stations through
    the shared polyphase filterbank (chain/pfb_bank.py).  --stations takes
    a comma list of Hz offsets from the capture centre, or 'db' for every
    station-DB entry inside the capture window around --center."""
    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver

    fs = source.info.sample_rate
    if args.stations.strip().lower() == "db":
        from pebblesdr_tpu_torch.utils import settings as settings_mod

        center = args.center or source.info.center_freq_hz
        near = settings_mod.stations_near(settings_mod.load_stations(),
                                          center, fs * 0.9)
        if not near:
            print(f"no DB stations within {fs * 0.9 / 1e6:.3f} MHz of "
                  f"{center / 1e6:.3f} MHz", file=sys.stderr)
            return 1
        tunes = [p.freq_hz - center for p in near]
        names = [p.name for p in near]
    else:
        tunes = [float(v) for v in args.stations.split(",")]
        names = [f"st{i}" for i in range(len(tunes))]
    mode = modes_mod.from_string(args.mode or "AM")
    bank = PfbBankReceiver(fs, args.frames, tunes, mode=mode,
                           n_bank=args.pfb_bank or None,
                           oversample=args.pfb_oversample,
                           agc_mode=args.agc, device=device)
    state = bank.init_state()
    n_blocks = max(1, int(args.seconds * fs / args.frames))
    kdisp = max(1, min(args.blocks_per_dispatch, n_blocks))
    audio = []
    perform = Perform(device)
    last = None
    n_done = 0
    t_start = time.perf_counter()
    while n_done < n_blocks:
        k_real, cat = _read_dispatch(source, args.frames, kdisp)
        if cat is None:
            break
        plane = np.stack([cat.real, cat.imag], axis=1).astype(np.float32)
        with perform.measure("step"):
            state, out = bank.step_many(state,
                                        torch.from_numpy(plane).to(device))
            audio.extend(out["audio"][:k_real].cpu().numpy())  # [K, C, M]
        n_done += k_real
        last = (out, k_real)
        if k_real < kdisp:
            break
    wall = time.perf_counter() - t_start
    if last is None:
        print("no IQ blocks read from the source", file=sys.stderr)
        return 1
    out, k_real = last
    aud = np.concatenate(audio, axis=-1)
    snr = out["smeter"]["snr_db"][k_real - 1].cpu().numpy()
    rows = [{
        "station": names[i], "tune_hz": float(tunes[i]),
        "channel": int(bank.chan_idx[i]),
        "residual_hz": round(float(bank.residuals[i]), 1),
        "snr_db": round(float(snr[i]), 1),
        "audio_rms": round(float(np.sqrt(np.mean(aud[i] ** 2))), 4),
    } for i in range(len(tunes))]
    if args.audio_out:
        stem, dot, ext = args.audio_out.rpartition(".")
        for i in range(min(len(tunes), 16)):  # cap the file spray
            path = f"{stem or ext}.st{i}.{ext if stem else 'wav'}"
            wav.write_audio_wav(path, aud[i], bank.rx.cfg.audio_rate)
    metrics = {
        "stations": len(tunes),
        "bank": bank.n_bank,
        "oversample": bank.pfb_plan.os,
        "channel_rate": bank.ch_rate,
        "blocks": len(audio),
        "wall_s": round(wall, 3),
        "msps": round(len(audio) * args.frames * len(tunes) / wall / 1e6, 2),
        "realtime_factor": round(len(audio) * args.frames / fs / wall, 2),
        "rows": rows,
        "step_ms": perform.stats("step"),
    }
    print(json.dumps(metrics) if args.json else
          "\n".join(f"{k:>16}: {v}" for k, v in metrics.items()))
    return 0


class _Decode:
    """--decode: the modem and its host decoder.  cw / rtty read channel
    0's post_bp tap of each dispatch ([K, C, n] views of the staged front's
    stream), kept on the device and re-framed to whole modem frames (no
    sample dropped); wwv / dtmf read channel 0's demodulated audio."""

    def __init__(self, kind: str | None, rx: Receiver, channels: int,
                 device: torch.device):
        self.kind, self.modem, self.decoder = kind, None, None
        if kind == "cw":
            from pebblesdr_tpu_torch.modem.morse import (MorseDecoder,
                                                         MorseModem)
            self.modem = MorseModem(rx.demod_rate,
                                    tone_hz=abs(rx.info.cw_offset) or 1000.0)
            self.decoder = MorseDecoder(frame_rate=self.modem.frame_rate)
            self.state = self.modem.init_state(channels, device)
        elif kind == "rtty":
            from pebblesdr_tpu_torch.modem.rtty import RttyDecoder, RttyModem
            self.modem = RttyModem(rx.demod_rate)
            self.decoder = RttyDecoder(
                frames_per_bit=self.modem.frames_per_bit)
        elif kind == "wwv":
            from pebblesdr_tpu_torch.modem.wwv import WwvDecoder, WwvModem
            self.modem = WwvModem(rx.cfg.audio_rate)
            self.decoder = WwvDecoder()
        elif kind == "dtmf":
            from pebblesdr_tpu_torch.modem.dtmf import DtmfDecoder, DtmfModem
            self.modem = DtmfModem(rx.cfg.audio_rate)
            self.decoder = DtmfDecoder()
        self.device = device
        self.buf = (torch.zeros(channels, 0, dtype=torch.complex64,
                                device=device) if kind in ("cw", "rtty")
                    else np.zeros(0, np.float32))

    def feed(self, out: dict, audio_np: np.ndarray, k_real: int) -> None:
        if self.modem is None:
            return
        frame = self.modem.frame
        if self.kind in ("cw", "rtty"):
            taps_k = out["taps"]["post_bp"][:k_real]           # [K, C, n]
            self.buf = torch.cat([self.buf, taps_k.transpose(0, 1).reshape(
                taps_k.shape[1], -1)], dim=-1)
            n_use = (self.buf.shape[-1] // frame) * frame
            if not n_use:
                return
            chunk = self.buf[:, :n_use].contiguous()
            self.buf = self.buf[:, n_use:]
            if self.kind == "cw":
                self.state, marks = self.modem.detect(self.state, chunk)
            else:
                marks = self.modem.detect(chunk)
            text = self.decoder.feed(marks[0].cpu().numpy())
            if text:
                print(text, end="", flush=True)
            return
        # wwv / dtmf: the demodulated audio of channel 0, like a listener
        # patched into the speaker feed
        a_cat = np.concatenate([np.asarray(a[0], np.float32).reshape(-1)
                                for a in audio_np], axis=-1)
        self.buf = np.concatenate([self.buf, a_cat])
        n_use = (len(self.buf) // frame) * frame
        if n_use:
            chunk, self.buf = self.buf[:n_use], self.buf[n_use:]
            pw = self.modem.detect(torch.from_numpy(chunk[None])
                                   .to(self.device))
            self.decoder.feed(pw[0].cpu().numpy())

    def metrics(self) -> dict:
        if self.kind in ("cw", "rtty"):
            print()  # newline after the streamed decode text
            return {"decoded_text": self.decoder.text}
        if self.kind == "wwv":
            fr = self.decoder.frame
            return {"decoded_time": None if fr is None else {
                "hours": fr.hours, "minutes": fr.minutes,
                "day_of_year": fr.day_of_year, "year": fr.year,
                "dst1": fr.dst1, "dst2": fr.dst2, "leap": fr.leap,
                "dut1": fr.dut1}}
        if self.kind == "dtmf":
            return {"decoded_digits": self.decoder.digits}
        return {}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--wav", help="IQ wav file input")
    src.add_argument("--synthetic", choices=["am", "tone", "morse"],
                     help="synthetic test source")
    src.add_argument("--source", help="source by name (file/synthetic/"
                     "morsegen; the network and soundcard sources are not "
                     "ported yet)")
    p.add_argument("--path", help="wav path for --source file")
    p.add_argument("--device", default="cuda",
                   help="torch device the chain runs on: 'cuda' (the "
                        "default; an error without a CUDA device), "
                        "'cuda:N' or 'cpu'")
    p.add_argument("--sample-rate", type=int, default=2_048_000,
                   help="sample rate for synthetic sources")
    p.add_argument("--assign", default=None,
                   help="mixed-mode channels 'MODE@HZ,...' (not ported yet)")
    p.add_argument("--presets", default=None,
                   help="preset stations for the n/N live keys (not ported "
                        "yet)")
    p.add_argument("--stations", default=None,
                   help="dense-bank monitoring (PFB): comma list of Hz "
                        "offsets, or 'db' for every station-DB entry in the "
                        "capture window; one shared --mode")
    p.add_argument("--pfb-bank", type=int, default=0,
                   help="filterbank size M (0 = auto from sample rate)")
    p.add_argument("--pfb-oversample", type=int, default=1, choices=[1, 2],
                   help="2 = 2x oversampled bank: edge stations keep their "
                        "sidebands (critical banks alias them)")
    p.add_argument("--center", type=float, default=0.0,
                   help="capture center frequency Hz (for --stations db)")
    p.add_argument("--mode", default="AM",
                   help="demod mode (AM/SAM/FMN/FM-Mono/FM-Stereo/LSB/USB/"
                        "CWL/CWU/...); FM-Stereo runs the ~256 kHz composite "
                        "geometry, --wfm-hq the full +-200 kHz one")
    p.add_argument("--wfm-hq", action="store_true",
                   help="FM: protect the full +-200 kHz composite")
    p.add_argument("--tune", type=float, default=0.0,
                   help="offset from capture center, Hz")
    p.add_argument("--bandpass", type=str, default=None,
                   help="lo,hi cut in Hz (default: mode preset)")
    p.add_argument("--agc", default=None,
                   choices=["off", "fast", "med", "slow", "long"])
    p.add_argument("--squelch", type=float, default=None,
                   help="squelch SNR dB")
    p.add_argument("--ctcss", type=float, default=None, metavar="HZ",
                   help="FMN only: CTCSS tone squelch qualifier (a table "
                        "tone, e.g. 123.0)")
    p.add_argument("--noise-blanker", nargs="?", const="blank", default=None,
                   choices=["blank", "average"],
                   help="impulse noise blanker at full rate ('blank' = NB1, "
                        "'average' = NB2)")
    p.add_argument("--iq-balance", default=None, metavar="AUTO|GAIN,PHASE",
                   help="'auto' runs the adaptive image-reject loop; "
                        "'gain,phase' applies a static correction")
    p.add_argument("--gain", type=float, default=1.0, help="audio gain")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="how long to run")
    p.add_argument("--frames", type=int, default=32768, help="block size")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--blocks-per-dispatch", type=int, default=8,
                   help="blocks batched into one step_many dispatch")
    p.add_argument("--audio-out", default=None,
                   help="demod audio to this .wav path (the live 'device' "
                        "and 'pipe' sinks are not ported yet)")
    p.add_argument("--iq-record", default=None,
                   help="record the input IQ to wav")
    p.add_argument("--pace", action="store_true", help="real-time pacing")
    p.add_argument("--noise-db", type=float, default=None)
    p.add_argument("--json", action="store_true",
                   help="print metrics as JSON")
    p.add_argument("--display", choices=["waterfall", "spectrum"],
                   default=None, help="live terminal display (not ported "
                                      "yet)")
    p.add_argument("--keys", default=None, metavar="TOKENS",
                   help="scripted control keys (not ported yet)")
    p.add_argument("--display-zoomed", action="store_true",
                   help="display the demod-rate spectrum (not ported yet)")
    p.add_argument("--bandscope", action="store_true",
                   help="the HPSDR bandscope waterfall (not ported yet)")
    p.add_argument("--decode", choices=["cw", "rtty", "wwv", "dtmf"],
                   default=None,
                   help="run a digital modem on the channel and print text: "
                        "cw/rtty demodulate the pre-detector channel taps; "
                        "wwv (AM mode) decodes the NIST time code and dtmf "
                        "(FMN mode) dial digits from the demodulated audio")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS (FM-Stereo mode) and print PS/RadioText")
    p.add_argument("--checkpoint", default=None,
                   help="save chain state to this .npz at exit")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="with --checkpoint: also snapshot every K blocks "
                        "(the stream-recovery supervisor; a killed run "
                        "resumes bit-exactly with --resume)")
    p.add_argument("--resume", default=None,
                   help="restore chain state from a .npz before starting")
    return p


def _refuse_deferred(p: argparse.ArgumentParser, args) -> None:
    """Exit 2 (argparse's usage error) naming the module a deferred option
    waits for."""
    for opt, module in _DEFERRED.items():
        if getattr(args, opt):
            p.error(f"--{opt.replace('_', '-')} needs {module}, which is not "
                    f"ported to pebblesdr_tpu_torch yet")
    if args.source and args.source.lower() in _NET_SOURCES:
        p.error(f"--source {args.source} needs "
                f"{_NET_SOURCES[args.source.lower()]}, which is not ported "
                f"to pebblesdr_tpu_torch yet")
    if args.audio_out and args.audio_out.startswith(("device", "pipe")):
        p.error(f"--audio-out {args.audio_out} (a live sink) needs "
                f"pebblesdr_tpu/io/audio_out.py, which is not ported to "
                f"pebblesdr_tpu_torch yet")


def _device(p: argparse.ArgumentParser, name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            p.error(f"--device {name}: no CUDA device (pass --device cpu to "
                    f"run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    else:
        print(f"device: {dev}", file=sys.stderr)
    return dev


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    _refuse_deferred(p, args)
    device = _device(p, args.device)

    source = make_source(args)
    if args.stations:
        return _run_stations(args, source, device)
    fs = source.info.sample_rate
    mode = modes_mod.from_string(args.mode or source.info.demod_mode or "AM")

    iqbal = False
    if args.iq_balance:
        iqbal = "auto" if args.iq_balance.lower() == "auto" else True
    cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=args.frames,
                         channels=args.channels, mode=mode,
                         agc_mode=args.agc, rds=args.rds,
                         taps=args.decode in ("cw", "rtty"),
                         enable_iq_balance=iqbal, wfm_hq=args.wfm_hq,
                         ctcss_tone=args.ctcss,
                         enable_noise_blanker=(
                             args.noise_blanker
                             if args.noise_blanker == "average"
                             else bool(args.noise_blanker)))
    rx = Receiver(cfg, device)
    state = rx.init_state()
    if args.resume:
        state, _ = ckpt.load_state(args.resume, state)

    rds_block = rds_groups = None
    if args.rds:
        from pebblesdr_tpu_torch.demod import rds as rds_mod

        rds_block = rds_mod.RdsBlockDecoder()
        rds_groups = rds_mod.RdsGroupDecoder()
    decode = _Decode(args.decode, rx, args.channels, device)
    tune = args.tune or source.info.center_freq_hz
    params = rx.default_params(tune)
    if args.bandpass:
        lo, hi = (float(v) for v in args.bandpass.split(","))
        params = rx.set_bandpass(params, lo, hi)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    if args.squelch is not None:
        params = dataclasses.replace(params, squelch_db=scalar(args.squelch))
    if args.gain != 1.0:
        params = dataclasses.replace(params, gain=scalar(args.gain))
    if args.iq_balance and args.iq_balance.lower() != "auto":
        g, ph = (float(v) for v in args.iq_balance.split(","))
        params = dataclasses.replace(params, iq_gain=scalar(g),
                                     iq_phase=scalar(ph))

    n_blocks = max(1, int(args.seconds * fs / args.frames))
    kdisp = max(1, min(args.blocks_per_dispatch, n_blocks))
    supervisor = None
    if args.checkpoint and args.checkpoint_every:
        supervisor = StreamSupervisor(rx, params,
                                      checkpoint_path=args.checkpoint,
                                      checkpoint_every=args.checkpoint_every)
    c = args.channels
    audio_chunks = []
    perform = Perform(device)
    rec = [] if args.iq_record else None
    n_done = 0
    last_out = None

    t_start = time.perf_counter()
    while n_done < n_blocks:
        # K blocks as ONE [K*N, 2C] plane through step_many; a short
        # trailing batch is zero-padded and trimmed after
        k_real, cat = _read_dispatch(source, args.frames, kdisp)
        if cat is None:
            break
        if rec is not None:
            rec.append(cat[:k_real * args.frames].copy())
        if n_done == 0:
            print("building the receive chain (the first dispatch on the "
                  "card compiles its kernels with nvcc) ...",
                  file=sys.stderr, flush=True)
            t_build0 = time.perf_counter()
        plane = np.concatenate(
            [np.broadcast_to(cat.real.astype(np.float32)[:, None],
                             (len(cat), c)),
             np.broadcast_to(cat.imag.astype(np.float32)[:, None],
                             (len(cat), c))], axis=1)
        with perform.measure("step"):
            state, out = rx.step_many(state, params,
                                      torch.from_numpy(plane).to(device))
            # fetch inside the timed region
            audio_np = out["audio"][:k_real].cpu().numpy()  # [K, C, (2,) M]
        if n_done == 0:
            print(f"chain ready in {time.perf_counter() - t_build0:.1f}s",
                  file=sys.stderr, flush=True)
        audio_chunks.extend(audio_np)
        n_done += k_real
        if supervisor is not None:
            for _ in range(k_real):
                supervisor.block_done(state)
        last_out = (out, k_real)
        decode.feed(out, audio_np, k_real)
        if rds_block is not None and "rds_soft" in out:
            for soft_k in out["rds_soft"][:k_real].cpu().numpy():
                rds_block.feed_symbols(soft_k[0])
            for grp in rds_block.groups:
                rds_groups.decode(grp)
            rds_block.groups.clear()
        if k_real < kdisp:
            break
    wall = time.perf_counter() - t_start

    if last_out is None:
        print("no IQ blocks read from the source", file=sys.stderr)
        return 1
    audio = (np.concatenate(audio_chunks, axis=-1) if audio_chunks
             else np.zeros((args.channels, 1), np.float32))
    n_in = n_done * args.frames
    out, k_real = last_out
    sm = {k: float(v[k_real - 1, 0]) for k, v in out["smeter"].items()}
    metrics = {
        "blocks": n_done,
        "input_samples": n_in,
        "wall_s": round(wall, 3),
        "msps": round(n_in * args.channels / wall / 1e6, 2),
        "realtime_factor": round(n_in / fs / wall, 2),
        "audio_rate": rx.cfg.audio_rate,
        "smeter_db": round(sm["signal_db"], 1),
        "snr_db": round(sm["snr_db"], 1),
        "squelch_open": bool(out["squelch_open"][k_real - 1, 0]),
        "audio_rms": round(float(np.sqrt(np.mean(audio[0] ** 2))), 4),
        "step_ms": perform.stats("step"),
    }
    if supervisor is not None:
        metrics["health"] = supervisor.report()
    metrics.update(decode.metrics())
    if rds_groups is not None:
        metrics["rds"] = {
            "pi": f"0x{rds_groups.pi:04X}", "ps": rds_groups.ps_name,
            "radiotext": rds_groups.radiotext, "pty": rds_groups.pty_name,
            "callsign": rds_groups.callsign,
            "blocks_ok": rds_block.blocks_ok,
            "block_errors": rds_block.block_errors,
        }
    if args.json:
        print(json.dumps(metrics))
    else:
        for k, v in metrics.items():
            print(f"{k:>16}: {v}")
    if args.checkpoint:
        ckpt.save_state(args.checkpoint, state,
                        extra={"blocks": len(audio_chunks)})
        print(f"state checkpointed to {args.checkpoint}", file=sys.stderr)

    if args.audio_out:
        wav.write_audio_wav(args.audio_out, audio[0], cfg.audio_rate)
        print(f"audio written to {args.audio_out}", file=sys.stderr)
    if rec:
        wav.write_iq_wav(args.iq_record, np.concatenate(rec), fs,
                         center_freq_hz=tune, demod_mode=mode.value)
        print(f"IQ recorded to {args.iq_record}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
