"""The quality row of the PyTorch port: bench.py bench_quality's
measurements on the port's Receiver.

    python -m pebblesdr_tpu_torch.tools.quality [--device cuda]
        [--channels 64] [--blocks B] [--json]

The row: stereo separation of an L-only 700 Hz program at the default and
at the hq geometry and through a 15 us / -10 dB two-ray channel; the RDS
block-error rate at 20, 14 and 17 dB IQ SNR with a 4 Hz carrier offset and
the PS name "PEBBLES " decoded; AM audio SNR clean, beside a -20 dB
neighbour 30 kHz away and with a -50 dB CW spur inside the passband; the
parallel AGC's hang against the sample-exact scan AGC on a carrier
dropout.  The fixtures and metrics are bench_quality's, copied.

With one channel each capture runs block by block through Receiver.step
with bench_quality's block counts (20 for the stereo program, 40 for RDS,
16 for the impairments).  With C channels it runs through
Receiver.step_many at 32 blocks a dispatch, channel c on its own columns
c and C + c of the [K*N, 2C] plane carrying its own capture: channel c's
RDS noise comes from default_rng(11 + c) and AGC row c's from
default_rng(5 + c) (channel 0's are bench_quality's).  Each value of the
row is the worst over channels (the least separation or SNR, the largest
BLER, delta or hang; the PS name decoded on every channel); with more
than one channel the range over channels is under "<key>_range".
--blocks B shortens every Receiver capture to B blocks.

Runs on the card unless --device says otherwise: --device cuda without a
CUDA device is an error (pass --device cpu), never a fall back.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import rds as rds_mod
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import agc as agc_mod
from pebblesdr_tpu_torch.tools import soak
from pebblesdr_tpu_torch.utils import precision

FS = 2_048_000
N = 32768
K = 32                      # blocks a dispatch with more than one channel
BLOCKS = dict(stereo=20, rds=40, impair=16)     # bench_quality's counts
STEREO_HZ = 250_000.0
RDS_HZ, RDS_TUNE_HZ = 300_004.0, 300_000.0
RDS_SNRS_DB = (20.0, 14.0, 17.0)
RDS_SEED = 11
AM_HZ = 250_000.0
AGC_FS = 8000.0
AGC_SEED = 5
AGC_BLOCK = 2048
PS = "PEBBLES "

# bench_quality's keys, in its order
ROW_KEYS = ("config", "stereo_sep_db", "stereo_sep_hq_db", "rds_bler_20db",
            "rds_ps_decoded", "rds_snr_db", "rds_bler_14db", "rds_bler_17db",
            "stereo_sep_multipath_db", "am_audio_snr_db",
            "am_adj_channel_snr_delta_db", "am_cw50_snr_delta_db",
            "agc_hang_par_vs_scan_db")
# each numeric key: (the worst over channels, the row's rounding)
WORST = {"stereo_sep_db": (np.min, 1), "stereo_sep_hq_db": (np.min, 1),
         "rds_bler_20db": (np.max, 3), "rds_bler_14db": (np.max, 3),
         "rds_bler_17db": (np.max, 3), "stereo_sep_multipath_db": (np.min, 1),
         "am_audio_snr_db": (np.min, 1),
         "am_adj_channel_snr_delta_db": (np.max, 2),
         "am_cw50_snr_delta_db": (np.max, 2),
         "agc_hang_par_vs_scan_db": (np.max, 2)}


# ------------------------------------------------------------------ fixtures

def times(n: int) -> np.ndarray:
    return np.arange(n) / FS


def stereo_program(n: int) -> np.ndarray:
    """The L-only 700 Hz FM stereo program at +250 kHz, complex128 [n]
    (bench.py:318-327 before its cast to complex64)."""
    t = times(n)
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    return 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))


def two_ray(iq: np.ndarray) -> np.ndarray:
    """iq plus its 15 us echo at -10 dB and 2.1 rad (bench.py:423-433),
    complex128."""
    d = int(15e-6 * FS)
    echo = (np.concatenate([np.zeros(d, complex), iq[:-d]])
            * 10 ** (-10 / 20) * np.exp(1j * 2.1))
    return iq + echo


def am_station(n: int) -> np.ndarray:
    """AM at +250 kHz, a 1 kHz tone at m = 0.8, complex128 (bench.py:
    455-456)."""
    t = times(n)
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    return 0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)


def am_neighbour(n: int) -> np.ndarray:
    """The -20 dB AM neighbour 30 kHz away (700 Hz tone; bench.py:457-458)."""
    t = times(n)
    nb_env = (1 + 0.8 * np.cos(2 * np.pi * 700.0 * t)) / 2
    return 0.05 * nb_env * np.exp(2j * np.pi * 280_000.0 * t)


def cw_spur(n: int) -> np.ndarray:
    """The -50 dB CW spur at +2.5 kHz inside the AM passband (bench.py:459)."""
    t = times(n)
    return 10 ** (-50 / 20) * 0.5 * np.exp(2j * np.pi * 252_500.0 * t)


def rds_carrier(n: int) -> np.ndarray:
    """FM at +300.004 kHz carrying 1 kHz mono at 0.3, the pilot at 0.1 and
    the PS groups' biphase at 0.06 on 57 kHz, complex128 (bench.py:344-355;
    the biphase from tools/soak.py, equal to tests/test_rds.py's groups)."""
    t = times(n)
    comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.06 * soak.rds_biphase(t) * np.cos(2 * np.pi * 57000.0 * t))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    return 0.5 * np.exp(1j * (2 * np.pi * RDS_HZ * t + ph))


def rds_sigma(snr_db: float) -> float:
    return np.sqrt(0.25 / 10 ** (snr_db / 10) / 2)


def rds_noisy(carrier: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    """carrier + complex noise at snr_db from default_rng(seed), complex64
    (bench.py:358-361)."""
    rng = np.random.default_rng(seed)
    n = len(carrier)
    return (carrier + rds_sigma(snr_db) * (rng.normal(size=n)
                                           + 1j * rng.normal(size=n))
            ).astype(np.complex64)


def agc_dropout(seed: int = AGC_SEED) -> np.ndarray:
    """A 500 Hz carrier at 8 kHz for 4.5 s that drops to 0.01 from 3.5 to
    4.0 s, with noise from default_rng(seed), complex64, cut to whole
    2048-sample blocks (bench.py:469-485)."""
    fs_a = AGC_FS
    n_a = int(fs_a * 4.5)
    ta = np.arange(n_a) / fs_a
    env = np.ones(n_a)
    env[int(3.5 * fs_a):int(4.0 * fs_a)] = 0.01
    rng_a = np.random.default_rng(seed)
    xa = ((env * np.exp(2j * np.pi * 500.0 * ta)
           + 2e-3 * (rng_a.standard_normal(n_a)
                     + 1j * rng_a.standard_normal(n_a)))
          .astype(np.complex64))
    return xa[:(n_a // AGC_BLOCK) * AGC_BLOCK]


def three_stations(n: int, stations=(-700_000.0, 0.0, 700_000.0),
                   tones=(800.0, 1500.0, 2500.0)) -> np.ndarray:
    """Three FM stations (tone at 0.45, pilot at 0.1, amplitude 0.4) in one
    capture, complex64 (tests/test_robustness.py:15-30)."""
    t = times(n)
    capture = np.zeros(n, np.complex64)
    for f0, tone in zip(stations, tones):
        comp = (0.45 * np.sin(2 * np.pi * tone * t)
                + 0.1 * np.sin(2 * np.pi * 19000.0 * t))
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        capture += (0.4 * np.exp(1j * (2 * np.pi * f0 * t + phase))
                    ).astype(np.complex64)
    return capture


def am_long(t: np.ndarray, f: float = 123_456.0) -> np.ndarray:
    """The long run's AM station at f (700 Hz at m = 0.5) at times t,
    complex64 (tests/test_robustness.py:67-70)."""
    env = (1 + 0.5 * np.cos(2 * np.pi * 700.0 * t)) / 2
    return (0.5 * env * np.exp(2j * np.pi * f * t)).astype(np.complex64)


def build_plane(column, chans, rows: int) -> np.ndarray:
    """The [rows, 2C] float32 lane-packed plane whose columns c and C + c
    hold the real and imaginary parts of column(chans[c]) (complex64
    [rows]), each written straight into the plane, columns built in
    threads."""
    c = len(chans)
    plane = np.empty((rows, 2 * c), np.float32)

    def one(i):
        z = column(chans[i])
        plane[:, i] = z.real
        plane[:, c + i] = z.imag

    with concurrent.futures.ThreadPoolExecutor(
            min(c, os.cpu_count() or 1)) as pool:
        list(pool.map(one, range(c)))
    return plane


# ------------------------------------------------------------------- metrics

def tone_amp(audio: np.ndarray, f_tone: float, rate: float) -> float:
    """Amplitude of a least-squares sin / cos / DC fit at f_tone
    (bench.py:309-315)."""
    n = len(audio)
    tt = np.arange(n) / rate
    a = np.stack([np.sin(2 * np.pi * f_tone * tt),
                  np.cos(2 * np.pi * f_tone * tt), np.ones(n)], 1)
    coef, *_ = np.linalg.lstsq(a, audio, rcond=None)
    return float(np.hypot(coef[0], coef[1]))


def station_amp(x: np.ndarray, f: float, rate: float) -> float:
    """The tone's amplitude by a cos / sin least-squares fit with no DC
    term, the three-station capture's metric (tests/test_robustness.py:
    46-51)."""
    tt = np.arange(x.shape[-1]) / rate
    b = np.stack([np.cos(2 * np.pi * f * tt), np.sin(2 * np.pi * f * tt)])
    coef, *_ = np.linalg.lstsq(b.T, x, rcond=None)
    return float(np.hypot(*coef))


def separation_db(lr: np.ndarray, rate: float) -> float:
    """Stereo separation of [2, M] audio (left, right): the 700 Hz tone's
    amplitude on L over R, over the second half."""
    half = lr.shape[-1] // 2
    al = tone_amp(lr[0, half:], 700.0, rate)
    ar = tone_amp(lr[1, half:], 700.0, rate)
    return float(20 * np.log10(al / max(ar, 1e-12)))


def am_audio_snr(audio: np.ndarray, rate: float) -> float:
    """The 1 kHz tone's SNR over the second half: its least-squares fit
    against the residual with the bins below 150 Hz zeroed (bench.py:
    441-453)."""
    tail = audio[len(audio) // 2:]
    tt = np.arange(len(tail)) / rate
    a = np.stack([np.sin(2 * np.pi * 1000 * tt),
                  np.cos(2 * np.pi * 1000 * tt), np.ones(len(tail))], 1)
    coef, *_ = np.linalg.lstsq(a, tail, rcond=None)
    amp = np.hypot(coef[0], coef[1])
    resid = tail - a @ coef
    sp = np.fft.rfft(resid)
    fr = np.fft.rfftfreq(len(resid), 1 / rate)
    sp[fr < 150] = 0
    res = np.fft.irfft(sp, len(resid))
    return float(10 * np.log10((amp ** 2 / 2) / np.mean(res ** 2)))


def bler(dec: rds_mod.RdsBlockDecoder) -> float:
    return dec.block_errors / max(1, dec.blocks_ok + dec.block_errors)


def hang_db(y_par: np.ndarray, y_scan: np.ndarray) -> float:
    """Largest |dB| between the parallel and the scan AGC's 25 ms RMS
    segments after the 8th (bench.py:494-500)."""
    seg = int(0.025 * AGC_FS)
    n_seg = len(y_scan) // seg
    rms = [np.sqrt(np.mean(np.abs(v[:n_seg * seg].reshape(n_seg, seg)) ** 2,
                           axis=1)) for v in (y_par, y_scan)]
    d_db = 20 * np.log10((rms[0] + 1e-9) / (rms[1] + 1e-9))
    return float(np.max(np.abs(d_db[8:])))


# -------------------------------------------------------------------- chains

def run_chain(device, planes, tunes, batched: bool, spectra: bool = False,
              n: int = N, fs: int = FS, **cfg_kw):
    """A fresh Receiver (channels = len(tunes), channel c tuned to
    tunes[c]) over planes, an iterable of [rows, 2C] float32 planes (numpy
    or torch, rows a multiple of n) in time order: each plane one
    Receiver.step_many dispatch (batched), or its n-row blocks in turn
    through Receiver.step.  Returns (Receiver, state', outputs of each
    call: step's with a leading axis of one block)."""
    tunes = np.atleast_1d(np.asarray(tunes, np.float64))
    rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                 channels=len(tunes), **cfg_kw), device)
    state = rx.init_state()
    params = rx.default_params(tunes)
    outs = []
    for x in planes:
        x = torch.as_tensor(x).to(rx.device)
        if batched:
            state, out = rx.step_many(state, params, x, spectra=spectra)
            outs.append(out)
            continue
        for b0 in range(0, x.shape[0], n):
            state, out = rx.step(state, params, x[b0:b0 + n],
                                 spectra=spectra)
            outs.append(tree_map(lambda v: v[None], out))
    return rx, state, outs


def tree_map(fn, out):
    """fn applied to every tensor of a Receiver output (nested dicts)."""
    if isinstance(out, dict):
        return {key: tree_map(fn, v) for key, v in out.items()}
    return fn(out) if isinstance(out, torch.Tensor) else out


def audio_of(outs: list) -> np.ndarray:
    """The calls' audio joined in time: float64 [C, M] ([C, 2, M] for FM
    stereo) on the host."""
    parts = [o["audio"].movedim(0, -2).reshape(*o["audio"].shape[1:-1], -1)
             for o in outs]
    return torch.cat(parts, dim=-1).cpu().numpy().astype(np.float64)


def rds_decode(outs: list, chans: int):
    """Per channel, the block decoder fed every call's soft symbols and the
    group decoder fed its groups: [(RdsBlockDecoder, RdsGroupDecoder)]."""
    soft = torch.cat([o["rds_soft"] for o in outs], dim=0)     # [B, C, S]
    soft = soft.transpose(0, 1).reshape(chans, -1).cpu().numpy()
    res = []
    for c in range(chans):
        dec = rds_mod.RdsBlockDecoder()
        dec.feed_symbols(soft[c])
        grp = rds_mod.RdsGroupDecoder()
        for g in dec.groups:
            grp.decode(g)
        res.append((dec, grp))
    return res


def agc_pair(device, chans=(0,)) -> dict:
    """agc_apply with algorithm "parallel" and "scan" (mode "long", -40 dB
    knee, 8 kHz; the scan's smoother is K4 on a CUDA tensor) in
    2048-sample calls over the dropout rows of chans (row c's noise from
    default_rng(5 + c)): {"parallel", "scan"} -> complex64 [R, M]."""
    x = np.stack([agc_dropout(AGC_SEED + ch) for ch in chans])
    outs = {}
    for alg in ("parallel", "scan"):
        cfg = agc_mod.AGCConfig.make(AGC_FS, mode="long", threshold_db=-40.0,
                                     algorithm=alg)
        st = agc_mod.agc_init(cfg, x.shape[0], device)
        ys = []
        for b in range(x.shape[-1] // AGC_BLOCK):
            xb = np.ascontiguousarray(x[:, b * AGC_BLOCK:(b + 1) * AGC_BLOCK])
            st, y = agc_mod.agc_apply(cfg, st, torch.from_numpy(xb).to(device))
            ys.append(y)
        outs[alg] = torch.cat(ys, dim=-1).cpu().numpy()
    return outs


def agc_hangs(ys: dict) -> np.ndarray:
    """The parallel AGC's hang against the scan's on each row of agc_pair's
    outputs: float64 [R]."""
    return np.array([hang_db(p, s) for p, s in zip(ys["parallel"],
                                                   ys["scan"])])


# ----------------------------------------------------------------------- row

def receiver_metrics(device, chans=(0,), blocks: int | None = None) -> dict:
    """bench_quality's Receiver measurements for each channel of chans, each
    its own capture (channel c's RDS noise from default_rng(11 + c)):
    {key: float64 [len(chans)]}, "rds_ps_decoded" bool.  blocks: every
    capture's length (default bench_quality's counts).  One channel runs
    through Receiver.step, more through Receiver.step_many at K blocks a
    dispatch."""
    chans = list(chans)
    c = len(chans)
    nblk = {key: blocks or v for key, v in BLOCKS.items()}
    res = {}

    def run(plane, tunes, nb, **kw):
        # the first nb blocks in K-block dispatches, the last one shorter
        planes = [plane[b0 * N:min(b0 + K, nb) * N]
                  for b0 in range(0, nb, K)]
        return run_chain(device, planes, tunes, c > 1, **kw)

    # stereo separation, clean (default and hq geometry) and two-ray
    rows = nblk["stereo"] * N
    prog = stereo_program(rows).astype(np.complex64)
    plane = build_plane(lambda _: prog, chans, rows)
    for key, hq in (("stereo_sep_db", False), ("stereo_sep_hq_db", True)):
        rx, _, outs = run(plane, [STEREO_HZ] * c, nblk["stereo"],
                          mode=DemodMode.FMS, wfm_hq=hq)
        aud = audio_of(outs)
        res[key] = np.array([separation_db(a, rx.cfg.audio_rate)
                             for a in aud])
    rows = nblk["impair"] * N
    echoed = two_ray(stereo_program(rows)).astype(np.complex64)
    plane = build_plane(lambda _: echoed, chans, rows)
    rx, _, outs = run(plane, [STEREO_HZ] * c, nblk["impair"],
                      mode=DemodMode.FMS, agc_mode="off")
    res["stereo_sep_multipath_db"] = np.array(
        [separation_db(a, rx.cfg.audio_rate) for a in audio_of(outs)])

    # RDS at 20, 14 and 17 dB
    rows = nblk["rds"] * N
    carrier = rds_carrier(rows)
    for snr in RDS_SNRS_DB:
        plane = build_plane(
            lambda ch: rds_noisy(carrier, snr, RDS_SEED + ch), chans, rows)
        _, _, outs = run(plane, [RDS_TUNE_HZ] * c, nblk["rds"],
                         mode=DemodMode.FMS, rds=True)
        decs = rds_decode(outs, c)
        res[f"rds_bler_{int(snr)}db"] = np.array([bler(d) for d, _ in decs])
        if snr == RDS_SNRS_DB[0]:
            res["rds_ps_decoded"] = np.array([g.ps_name == PS
                                              for _, g in decs])

    # AM audio SNR: clean, with the neighbour, with the CW spur
    rows = nblk["impair"] * N
    base = am_station(rows)
    snrs = {}
    for name, sig in (("clean", base), ("adj", base + am_neighbour(rows)),
                      ("cw", base + cw_spur(rows))):
        z = sig.astype(np.complex64)
        plane = build_plane(lambda _: z, chans, rows)
        rx, _, outs = run(plane, [AM_HZ] * c, nblk["impair"],
                          mode=DemodMode.AM, agc_mode="off")
        snrs[name] = np.array([am_audio_snr(a, rx.cfg.audio_rate)
                               for a in audio_of(outs)])
    res["am_audio_snr_db"] = snrs["clean"]
    res["am_adj_channel_snr_delta_db"] = snrs["clean"] - snrs["adj"]
    res["am_cw50_snr_delta_db"] = snrs["clean"] - snrs["cw"]
    return res


def channel_metrics(device, chans=(0,), blocks: int | None = None) -> dict:
    """receiver_metrics and agc_hangs ("agc_hang_par_vs_scan_db") for each
    channel of chans."""
    return dict(receiver_metrics(device, chans, blocks),
                agc_hang_par_vs_scan_db=agc_hangs(agc_pair(device, chans)))


def row_of(metrics: dict) -> dict:
    """bench_quality's row from channel_metrics: each value the worst over
    channels, rounded as bench_quality rounds it; with more than one
    channel each numeric key's [min, max] over channels under
    "<key>_range"."""
    c = len(metrics["rds_ps_decoded"])
    row = {}
    for key in ROW_KEYS:
        if key == "config":
            row[key] = "quality"
        elif key == "rds_snr_db":
            row[key] = RDS_SNRS_DB[0]
        elif key == "rds_ps_decoded":
            row[key] = bool(np.all(metrics[key]))
        else:
            worst, digits = WORST[key]
            row[key] = round(float(worst(metrics[key])), digits)
    if c > 1:
        for key, (_, digits) in WORST.items():
            v = metrics[key]
            row[f"{key}_range"] = [round(float(v.min()), digits),
                                   round(float(v.max()), digits)]
    return row


def quality_row(device, channels: int = 1, blocks: int | None = None) -> dict:
    """bench_quality's row on the port at `channels` channels (one:
    Receiver.step per block; more: Receiver.step_many at K blocks a
    dispatch, each channel its own capture).  See the module docstring."""
    return row_of(channel_metrics(device, range(channels), blocks))


# ---------------------------------------------------------------------- main

def main(argv=None) -> int:
    from pebblesdr_tpu_torch.serve.cli import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the default; an error "
                        "without a CUDA device), 'cuda:N' or 'cpu'")
    p.add_argument("--channels", type=int, default=1,
                   help="channels, each its own capture (more than one: "
                        "Receiver.step_many)")
    p.add_argument("--blocks", type=int, default=None,
                   help="blocks of every Receiver capture (default: "
                        "bench_quality's 20 / 40 / 16)")
    p.add_argument("--json", action="store_true",
                   help="print the row as one JSON line")
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)
    with precision.ieee_float32():
        row = quality_row(device, args.channels, args.blocks)
    if args.json:
        print(json.dumps(row))
    else:
        for key, v in row.items():
            print(f"{key:32s} {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
