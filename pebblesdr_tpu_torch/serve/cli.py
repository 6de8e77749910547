"""Command-line receiver of the PyTorch port: file, synthetic, network or
soundcard IQ in -> demodulated audio out (a WAV, a live soundcard or a
pipe), on the card (``--device cuda``, the default) or the CPU (``--device
cpu``).

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
  # live: serve a recording (or a radio) over rtl_tcp, receive it here
  python -m pebblesdr_tpu_torch.serve.server --source file \\
      --path capture.wav --port 1234 &
  python -m pebblesdr_tpu_torch.serve.cli --source rtl_tcp --port 1234 \\
      --mode AM --tune 250000 --seconds 10 --display waterfall \\
      --audio-out pipe

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

--source rtl_tcp|sdr_ip|hpsdr|audio (with --host/--port, or --center for
the soundcard) goes through io/registry.py.  A network source is opened
only once the chain is built and warmed by one dispatch of zeros (on the
card the first dispatch loads kernels and plans; a stream would queue
behind it and then flood the paced sink), the SDR-IP and HPSDR start
command goes just before the first read, and the source's counters
(datagrams, drops, restarts; the native pump's overruns) go under
"source_counters"; --audio-out device[:name] | pipe[:command] streams
channel 0 through the paced sink (io/audio_out.py PacedOutput,
its latency bound two dispatches of audio; its underruns and overruns go
under "audio_sink");
--display waterfall|spectrum draws the terminal display (serve/display.py)
from one spectrum row per dispatch, sliced on the device and fetched;
--bandscope draws the HPSDR's wideband EP4 stream as a second waterfall;
--keys TOKENS (or the live keyboard with --display on a terminal) drives
serve/control.py: params-only retunes, and a mode or AGC change rebuilds
the Receiver on the same device.  "split_ms" holds the per-dispatch
split (min / max / avg over the dispatches after the first): read (the
source's read and decode), plane (the [K*N, 2C] plane's build in a host
buffer kept across dispatches, pinned for a CUDA device), copy (host to
device), step (the copy, the dispatch and the audio's fetch), dispatch
(the whole loop pass: keys, read, plane, step, sinks, display, decoders)
and work (the pass less its read: what must stay under K*N/fs of signal
when the source paces the run).

--assign 'MODE@HZ,...' runs mixed-mode monitoring (parallel/expert.py):
one capture, each channel routed to its mode's expert Receiver on the same
device, K blocks per dispatch of one shared [K*N, 2] capture plane (the
experts gather their channels' lanes on the device); --squelch, --gain,
--bandpass and --agc go to every expert; per-channel WAVs
<stem>.ch<i>.<ext>, and the JAX CLI's JSON keys (channels: channel, mode,
tune_hz, snr_db, audio_rms).
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

# the sources that stream from a network radio
_NETWORK = ("rtl_tcp", "sdr_ip", "hpsdr")

def make_source(args) -> sources.Source:
    if args.source:
        from pebblesdr_tpu_torch.io import registry

        kwargs = {}
        if args.source == "file":
            kwargs = {"path": args.wav or args.path, "pace": args.pace}
        elif args.source in _NETWORK:
            kwargs = {"host": args.host, "port": args.port,
                      "sample_rate": args.sample_rate}
        elif args.source in ("synthetic", "morsegen"):
            kwargs = {"sample_rate": args.sample_rate}
        elif args.source == "audio":
            # soundcard audio-IQ front end (FunCube/SoftRock class)
            kwargs = {"sample_rate": args.sample_rate}
            if args.center:
                kwargs["center_freq_hz"] = args.center
        return registry.create(args.source, **kwargs)
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


def _start_stream(args, source) -> None:
    """Send a network radio its start command (the JAX CLI never sends it,
    so its --source sdr_ip|hpsdr reads time out): called once the chain is
    built, so no datagram waits in the socket through the build."""
    if args.source == "hpsdr":
        source.start(bandscope=args.bandscope)
    elif args.source == "sdr_ip":
        source.start()


class _Plane:
    """The [K*N, 2C] float32 entry plane of a dispatch (channel c's I in
    column c, its Q in column C + c), built on the host in one buffer kept
    across dispatches: pinned for a CUDA device (no page faults on the 512
    MiB of a full-width plane, a DMA copy), and copied to a new device
    tensor each dispatch."""

    def __init__(self, rows: int, channels: int, device: torch.device):
        self.host = torch.empty((rows, 2, channels), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.device = device

    def fill(self, cat: np.ndarray) -> None:
        iq = torch.from_numpy(
            np.ascontiguousarray(cat, np.complex64).view(np.float32)
            .reshape(-1, 2))
        self.host.copy_(iq[:, :, None].expand(self.host.shape))

    def to_device(self) -> torch.Tensor:
        return self.host.reshape(len(self.host), -1).to(self.device,
                                                        copy=True)


def _warm(rx: Receiver, plane: _Plane) -> None:
    """One dispatch of zeros through a throwaway state: on the card the
    first dispatch loads the kernels and sets up their plans, which a live
    stream would otherwise queue behind (and then flood the paced sink
    with a burst of late audio)."""
    plane.host.zero_()
    _, out = rx.step_many(rx.init_state(), rx.default_params(0.0),
                          plane.to_device())
    out["audio"].cpu()


def _read_dispatch(source, frames: int, kdisp: int, limit: int | None = None):
    """Up to kdisp blocks of the source (at most limit), zero-padded to
    kdisp (the same dispatch shape; the padded blocks are trimmed after):
    (blocks read, [kdisp * frames] complex64), or (0, None) at the end of
    the stream."""
    blks = []
    for _ in range(kdisp if limit is None else min(kdisp, limit)):
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
    _start_stream(args, source)
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
        "split_ms": perform.report(),
    }
    print(json.dumps(metrics) if args.json else
          "\n".join(f"{k:>16}: {v}" for k, v in metrics.items()))
    return 0


def _run_assign(args, source, device) -> int:
    """Mixed-mode monitoring: one capture -> channels routed to per-mode
    expert chains (parallel/expert.py).  --assign 'AM@250000,FMN@-50000'
    demodulates an AM station at +250 kHz and an NFM station at -50 kHz at
    once.  Each dispatch ships one shared [K*N, 2] capture plane."""
    from pebblesdr_tpu_torch.parallel import expert

    fs = source.info.sample_rate
    assignments = []
    for spec in args.assign.split(","):
        mode_s, _, hz_s = spec.partition("@")
        assignments.append(expert.ChannelAssignment(
            modes_mod.from_string(mode_s.strip().upper()),
            float(hz_s or 0.0)))
    ch = expert.ModeExpertChannelizer(fs, args.frames, assignments,
                                      device=device, agc_mode=args.agc)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def configure(rx, p):
        # --bandpass overrides each expert's mode-preset cuts; --squelch
        # and --gain apply to every expert (as in the single-mode path)
        if args.bandpass:
            lo, hi = (float(v) for v in args.bandpass.split(","))
            p = rx.set_bandpass(p, lo, hi)
        if args.squelch is not None:
            p = dataclasses.replace(p, squelch_db=scalar(args.squelch))
        if args.gain != 1.0:
            p = dataclasses.replace(p, gain=scalar(args.gain))
        return p

    for e in range(ch.n_experts):
        ch.set_params(e, configure)
    states = ch.init_states()
    n_blocks = max(1, int(args.seconds * fs / args.frames))
    kdisp = max(1, min(args.blocks_per_dispatch, n_blocks))
    plane = _Plane(kdisp * args.frames, 1, device)
    audio = {i: [] for i in range(len(assignments))}
    perform = Perform(device)
    last = None
    n_done = 0
    _start_stream(args, source)
    t_start = time.perf_counter()
    while n_done < n_blocks:
        k_real, cat = _read_dispatch(source, args.frames, kdisp,
                                     n_blocks - n_done)
        if cat is None:
            break
        plane.fill(cat)
        with perform.measure("step"):
            states, outs = ch.step_many(states, plane.to_device())
            by_ch = ch.audio_by_channel(outs, many=True, blocks=k_real)
        for i, a in by_ch.items():
            audio[i].append(a)
        n_done += k_real
        last = (outs, k_real)
        if cat is None or n_done >= n_blocks:
            break
    wall = time.perf_counter() - t_start
    if last is None:
        print("no IQ blocks read from the source", file=sys.stderr)
        return 1
    outs, k_real = last
    chans = []
    for e, g in enumerate(ch.groups):
        sm = outs[e]["smeter"]["snr_db"][k_real - 1].cpu().numpy()
        rate = ch.receivers[e][0].cfg.audio_rate
        for slot, cid in enumerate(g.channel_ids):
            a = np.concatenate(audio[cid], axis=-1)
            chans.append({
                "channel": cid, "mode": g.mode.value,
                "tune_hz": float(g.tunes[slot]),
                "snr_db": round(float(sm[slot]), 1),
                "audio_rms": round(float(np.sqrt(np.mean(a ** 2))), 4),
            })
            if args.audio_out:
                stem, dot, ext = args.audio_out.rpartition(".")
                path = f"{stem or ext}.ch{cid}.{ext if stem else 'wav'}"
                wav.write_audio_wav(path, a, rate)
    metrics = {
        "blocks": n_done,
        "wall_s": round(wall, 3),
        "msps": round(n_done * args.frames * len(assignments) / wall / 1e6,
                      2),
        "realtime_factor": round(n_done * args.frames / fs / wall, 2),
        "channels": sorted(chans, key=lambda c: c["channel"]),
        "step_ms": perform.stats("step"),
        "split_ms": perform.report(),
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
    src.add_argument("--source", help="registered source by name "
                     "(file/synthetic/morsegen/rtl_tcp/sdr_ip/hpsdr/audio)")
    p.add_argument("--path", help="wav path for --source file")
    p.add_argument("--host", default="127.0.0.1",
                   help="rtl_tcp / SDR-IP / HPSDR host")
    p.add_argument("--port", type=int, default=1234,
                   help="rtl_tcp / SDR-IP / HPSDR port")
    p.add_argument("--device", default="cuda",
                   help="torch device the chain runs on: 'cuda' (the "
                        "default; an error without a CUDA device), "
                        "'cuda:N' or 'cpu'")
    p.add_argument("--sample-rate", type=int, default=2_048_000,
                   help="sample rate for synthetic sources")
    p.add_argument("--assign", default=None,
                   help="mixed-mode channels 'MODE@HZ,...': each routed "
                        "to its mode's expert chain")
    p.add_argument("--presets", default=None,
                   help="preset stations for the n/N live keys: a CSV path "
                        "(name,freq_hz,mode) or 'db' for the shipped "
                        "station database")
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
                   help="capture center frequency Hz (for --stations db and "
                        "the soundcard source)")
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
                   help="demod audio sink: a .wav path, 'device[:name]' for "
                        "the PortAudio soundcard (live, paced, with underrun "
                        "counters), or 'pipe[:command]' to stream float32 "
                        "PCM into a player")
    p.add_argument("--iq-record", default=None,
                   help="record the input IQ to wav")
    p.add_argument("--pace", action="store_true", help="real-time pacing")
    p.add_argument("--noise-db", type=float, default=None)
    p.add_argument("--json", action="store_true",
                   help="print metrics as JSON")
    p.add_argument("--display", choices=["waterfall", "spectrum"],
                   default=None, help="live terminal spectrum display")
    p.add_argument("--keys", default=None, metavar="TOKENS",
                   help="scripted control keys, one per dispatch (arrows "
                        "spelled as ESC sequences; 'help' prints the key "
                        "map).  With --display on a terminal the live "
                        "keyboard drives the same control surface")
    p.add_argument("--display-zoomed", action="store_true",
                   help="display the demod-rate spectrum instead of the "
                        "device-rate one")
    p.add_argument("--bandscope", action="store_true",
                   help="draw the device's wideband bandscope stream as a "
                        "second waterfall (HPSDR EP4)")
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


def resolve_device(p: argparse.ArgumentParser, name: str) -> torch.device:
    """--device NAME as a torch.device; without a CUDA device a CUDA name
    is a usage error (exit 2), never a fall back to the CPU."""
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


def _controls(args, rx, params, tune, source):
    """The control surface and its key source (--keys, or the live keyboard
    when --display runs on a terminal), or (None, None)."""
    if args.keys is None and not (args.display and sys.stdin.isatty()):
        return None, None
    from pebblesdr_tpu_torch.serve.control import (ControlSurface,
                                                   ScriptedKeys, TtyKeys)

    iq_static = None
    if args.iq_balance and args.iq_balance.lower() != "auto":
        iq_static = tuple(float(v) for v in args.iq_balance.split(","))
    bp_static = None
    if args.bandpass:
        bp_static = tuple(float(v) for v in args.bandpass.split(","))
    preset_list = None
    if args.presets:
        from pebblesdr_tpu_torch.utils import settings as settings_mod

        preset_list = (settings_mod.load_stations()
                       if args.presets.strip().lower() == "db"
                       else settings_mod.load_presets_csv(args.presets))
    controls = ControlSurface(rx, params, tune, squelch_db=args.squelch,
                              gain=args.gain, source=source,
                              center_hz=source.info.center_freq_hz,
                              iq_static=iq_static, bandpass=bp_static,
                              presets=preset_list)
    if args.display_zoomed:
        controls.display = "zoom"
    keys = (ScriptedKeys(args.keys) if args.keys is not None
            else TtyKeys().__enter__())
    return controls, keys


def _live_audio(args, dispatch_s: float):
    """The paced live sink for --audio-out device[:name] | pipe[:command]
    (not started yet), or None.  A dispatch hands the sink dispatch_s of
    audio at once, so the sink's latency bound holds two dispatches (a
    bound under one dispatch drops audio on every dispatch)."""
    if not (args.audio_out and args.audio_out.startswith(("device", "pipe"))):
        return None
    from pebblesdr_tpu_torch.io import audio_out as ao

    kind, _, rest = args.audio_out.partition(":")
    kw = {}
    if kind == "device" and rest and rest != "default":
        kw["device"] = rest
    if kind == "pipe" and rest:
        kw["command"] = rest.split()
    sink = ao.factory(kind, paced=True, **kw)
    sink.max_latency_s = max(sink.max_latency_s, 2.0 * dispatch_s)
    return sink


def _show(args, display, controls, out, k_real, rx, fs, tune) -> None:
    """One display frame per dispatch: channel 0's rows of the last block,
    sliced on the device and fetched ('z' cycles wide / zoom / split)."""
    dmode = controls.display if controls is not None else (
        "zoom" if args.display_zoomed else "wide")
    panes = {"wide": [("spectrum", fs)],
             "zoom": [("zoomed", rx.demod_rate)],
             "split": [("spectrum", fs), ("zoomed", rx.demod_rate)]}[dmode]
    sm = {k: float(v[k_real - 1, 0]) for k, v in out["smeter"].items()}
    for key, span in panes:
        if key in out:
            row = out[key][k_real - 1, 0].cpu().numpy()
            pre = "Z " if (dmode == "split" and key == "zoomed") else ""
            print(pre + display.frame(row, sm, center_hz=tune, span_hz=span),
                  flush=True)


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    if args.keys == "help":
        # print the key map (the control module docstring's table) and exit
        # before any chain build: the letters of "help" are not live keys
        import pebblesdr_tpu_torch.serve.control as control_mod

        doc = control_mod.__doc__ or ""
        start = doc.find("Key map")
        print(doc[start:] if start >= 0 else doc, file=sys.stderr)
        return 0
    device = resolve_device(p, args.device)

    # a network radio streams from its connection (rtl_tcp) or its start
    # command on: it is opened once the chain is built and warm
    live = args.source in _NETWORK and not (args.stations or args.assign)
    source = None if live else make_source(args)
    if args.stations:
        return _run_stations(args, source, device)
    if args.assign:
        return _run_assign(args, source, device)
    fs = args.sample_rate if live else source.info.sample_rate
    mode = modes_mod.from_string(
        args.mode or (None if live else source.info.demod_mode) or "AM")

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
    n_blocks = max(1, int(args.seconds * fs / args.frames))
    kdisp = max(1, min(args.blocks_per_dispatch, n_blocks))
    plane = _Plane(kdisp * args.frames, args.channels, device)
    if live:
        _warm(rx, plane)
        source = make_source(args)
        if source.info.sample_rate != fs:
            print(f"--source {args.source}: the radio runs at "
                  f"{source.info.sample_rate} sps, not --sample-rate {fs}",
                  file=sys.stderr)
            return 1

    display = None
    if args.display:
        from pebblesdr_tpu_torch.serve.display import TerminalDisplay

        display = TerminalDisplay(mode=args.display,
                                  color=sys.stdout.isatty())
    bs_display = None
    bs_frames = 0
    if args.bandscope:
        if not hasattr(source, "read_bandscope"):
            print("--bandscope: source has no bandscope stream (HPSDR EP4 "
                  "only); ignoring", file=sys.stderr)
        else:
            from pebblesdr_tpu_torch.io.hpsdr import bandscope_spectrum
            from pebblesdr_tpu_torch.serve.display import TerminalDisplay

            bs_display = TerminalDisplay(mode="waterfall",
                                         color=sys.stdout.isatty())
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
    # interactive runtime control (receiverwidget.h:28-140 capability)
    controls, key_source = _controls(args, rx, params, tune, source)

    supervisor = None
    if args.checkpoint and args.checkpoint_every:
        supervisor = StreamSupervisor(rx, params,
                                      checkpoint_path=args.checkpoint,
                                      checkpoint_every=args.checkpoint_every)
    # live audio sink, wrapped in the paced consumer so latency, underruns
    # and overruns are accounted
    live_audio = _live_audio(args, kdisp * args.frames / fs)
    live_channels = 2 if mode == modes_mod.DemodMode.FMS else 1
    if live_audio is not None:
        live_audio.start(cfg.audio_rate, channels=live_channels)
    audio_chunks = []
    perform = Perform(device)
    rec = [] if args.iq_record else None
    n_done = 0
    last_out = None

    _start_stream(args, source)
    t_start = time.perf_counter()
    while n_done < n_blocks:
        t_pass = time.perf_counter()
        if controls is not None:
            # params-only events keep the same Receiver; a mode or AGC
            # event rebuilds it (on the same device) and restarts its state
            for key in key_source.poll():
                ev = controls.handle(key)
                if ev:
                    print(f"* {ev}", file=sys.stderr, flush=True)
            if controls.take_reset():
                rx = controls.rx
                mode = rx.cfg.mode
                state = rx.init_state()
                audio_chunks = []  # new chain geometry: new audio segment
                if live_audio is not None:
                    # the live sink's frame layout is fixed at open time:
                    # an FMS <-> mono switch reopens it at the new count
                    want = 2 if mode == modes_mod.DemodMode.FMS else 1
                    if want != live_channels:
                        live_audio.stop()
                        live_audio.start(cfg.audio_rate, channels=want)
                        live_channels = want
            params = controls.params
            tune = controls.tune
            if controls.quit:
                break
        # K blocks as ONE [K*N, 2C] plane through step_many; a short
        # trailing batch is zero-padded and trimmed after
        with perform.measure("read"):
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
        with perform.measure("plane"):
            plane.fill(cat)
        with perform.measure("step"):
            with perform.measure("copy"):
                x = plane.to_device()
            state, out = rx.step_many(state, params, x)
            # fetch inside the timed region
            audio_np = out["audio"][:k_real].cpu().numpy()  # [K, C, (2,) M]
        if n_done == 0:
            print(f"chain ready in {time.perf_counter() - t_build0:.1f}s",
                  file=sys.stderr, flush=True)
        audio_chunks.extend(audio_np)
        if live_audio is not None:
            for a_blk in audio_np:      # [C, M] or [C, 2, M]: channel 0
                live_audio.send(a_blk[0])
        n_done += k_real
        if supervisor is not None:
            for _ in range(k_real):
                supervisor.block_done(state)
        last_out = (out, k_real)
        if controls is not None and "spectrum" in out:
            # the latest wide spectrum feeds the 'p' peak-snap key: one row
            # sliced on the device and fetched
            controls.note_spectrum(out["spectrum"][k_real - 1, 0].cpu()
                                   .numpy())
        if display is not None:
            _show(args, display, controls, out, k_real, rx, fs, tune)
        if bs_display is not None:
            # the raw EP4 samples become one windowed dB row per update
            bs = source.read_bandscope()
            if len(bs) >= 2048:
                bs_frames += 1
                print("BS " + bs_display.frame(bandscope_spectrum(
                    bs, bins=2048)), flush=True)
        decode.feed(out, audio_np, k_real)
        if rds_block is not None and "rds_soft" in out:
            for soft_k in out["rds_soft"][:k_real].cpu().numpy():
                rds_block.feed_symbols(soft_k[0])
            for grp in rds_block.groups:
                rds_groups.decode(grp)
            rds_block.groups.clear()
        t_pass = time.perf_counter() - t_pass
        perform.samples["dispatch"].append(t_pass)
        perform.samples["work"].append(t_pass - perform.samples["read"][-1])
        if k_real < kdisp:
            break
    wall = time.perf_counter() - t_start
    if key_source is not None and hasattr(key_source, "__exit__"):
        key_source.__exit__(None, None, None)
    if hasattr(source, "close"):
        source.close()      # a network source's socket, a soundcard stream
    source_counters = getattr(source, "counters", None)

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
        "split_ms": perform.report(),
    }
    if source_counters is not None:
        metrics["source_counters"] = dict(source_counters)
    if controls is not None:
        metrics["control_events"] = controls.events
        metrics["tune_hz"] = controls.tune
        metrics["final_mode"] = rx.cfg.mode.value
    if live_audio is not None:
        live_audio.stop()
        inner = getattr(live_audio, "inner", live_audio)
        metrics["audio_sink"] = {
            "kind": args.audio_out,
            "underruns": (getattr(live_audio, "underruns", 0)
                          + getattr(inner, "underruns", 0)),
            "overruns": getattr(live_audio, "overruns", 0),
        }
    if supervisor is not None:
        metrics["health"] = supervisor.report()
    if bs_display is not None:
        metrics["bandscope_frames"] = bs_frames
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

    if args.audio_out and live_audio is None:
        wav.write_audio_wav(args.audio_out, audio[0], cfg.audio_rate)
        print(f"audio written to {args.audio_out}", file=sys.stderr)
    if rec:
        wav.write_iq_wav(args.iq_record, np.concatenate(rec), fs,
                         center_freq_hz=tune, demod_mode=mode.value)
        print(f"IQ recorded to {args.iq_record}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
