"""The gloo worlds of the parallel/ tests: a launcher for the test process
and the cases each rank runs.

A test file starts one world for all of its cases (``World``): `world`
subprocesses of this script (``python tests/torch_dist.py CASE RANK WORLD
PORT OUTDIR``), each joining a CPU gloo world at tcp://127.0.0.1:PORT and
running CASE, which writes the rank's results to OUTDIR/RANK.npz.  The
processes are plain subprocesses (not torch.multiprocessing.spawn, whose
child bootstrap does not mix with pytest-xdist's workers).  The test
process computes its JAX references while the world runs, then reads the
ranks' files.  Workers import torch, numpy and the port only.

The signals are made here, from numpy seeds, so the test process and the
ranks build the same inputs.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ launcher

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class World:
    """A gloo world of `world` ranks running `case`, started at once; the
    ranks' results (one dict of arrays per rank) on the first results()."""

    def __init__(self, case: str, world: int, outdir: str,
                 env: dict | None = None, timeout: float = 240.0):
        self.outdir, self.world, self.timeout = str(outdir), world, timeout
        port = str(_free_port())
        e = dict(os.environ)
        e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
        e.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
        e.update(env or {})
        self.t0 = time.perf_counter()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r),
             str(world), port, self.outdir], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._res = None

    def results(self) -> list[dict]:
        if self._res is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=self.timeout)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
            self.seconds = time.perf_counter() - self.t0
            self._res = []
            for r in range(self.world):
                with np.load(os.path.join(self.outdir, f"{r}.npz")) as z:
                    self._res.append({k: z[k] for k in z.files})
        return self._res


def by_channel(res: list[dict], key: str, axis: int = 0) -> np.ndarray:
    """Assemble a channel-split result: the time-index-0 rank of each
    channel group (its '<key>/c0' start), concatenated along axis; every
    time replica must hold the same array."""
    rows = {}
    for r in res:
        if key + "/c0" not in r:
            continue
        c0 = int(r[key + "/c0"])
        if c0 in rows:
            np.testing.assert_array_equal(rows[c0], r[key])
        else:
            rows[c0] = r[key]
    return np.concatenate([rows[c] for c in sorted(rows)], axis=axis)


def by_time(res: list[dict], key: str, axis: int = -1) -> np.ndarray:
    """Assemble a time-split result in rank (= time index) order."""
    return np.concatenate([r[key] for r in res if key in r], axis=axis)


# ------------------------------------------------------------------- signals

def am_tones(c: int, n: int, fs: float, dc: float = 0.0) -> np.ndarray:
    """tests/test_parallel.py's capture: a 400 Hz offset tone at each of c
    tunes across +-150 kHz, [c, n] complex64 (every row the capture)."""
    t = np.arange(n) / fs
    tones = np.linspace(-150_000, 150_000, c)
    cap = sum(0.2 * np.exp(2j * np.pi * (f + 400.0) * t) for f in tones) + dc
    return np.broadcast_to(cap.astype(np.complex64), (c, n)).copy()


def am_broadcast(c: int, n: int, fs: float) -> np.ndarray:
    """tests/test_parallel.py:158-161: one AM station at +100 kHz on every
    row, [c, n] complex64."""
    t = np.arange(n) / fs
    sig = ((1 + 0.5 * np.cos(2 * np.pi * 400 * t)) / 2
           * np.exp(2j * np.pi * 100_000 * t)).astype(np.complex64)
    return np.broadcast_to(sig, (c, n)).copy()


def noisy_dc(c: int, n: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n)))
            + 0.05).astype(np.complex64)


def fm_stereo(c: int, n: int, fs: float) -> np.ndarray:
    """tests/test_parallel.py:301-307: FM at +300 kHz (1 kHz, pilot)."""
    t = np.arange(n) / fs
    comp = (0.45 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
    iq = 0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + ph))
    return np.broadcast_to(iq.astype(np.complex64), (c, n)).copy()


def cplx(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def packed(iq: np.ndarray) -> np.ndarray:
    """[C, N] complex -> the [N, 2C] float32 plane."""
    return np.concatenate([iq.real.T, iq.imag.T], axis=1).astype(np.float32)


# Sizes of the cases (shared with the test files)
CH = dict(fs=512_000, n=8192)            # tests/test_parallel.py:154,183,223
WFM = dict(fs=2_048_000, n=32768, c=4, blocks=4)
MANY = dict(c=8, k=4, dispatches=2)      # the port's dispatch contract
FIR = dict(c=2, n=8192, blocks=3)
BANK = dict(fs=1_024_000, frames=16384, m=32, blocks=3,
            channels=(1, 5, 9, 13, 17, 21, 25, 29),
            offsets=(0.0, 1000.0, -500.0, 0.0, 700.0, -1200.0, 300.0, 0.0))
FFT_SHAPES = ((64, 128), (128, 64), (8, 1024))
PIPE = dict(fs=512_000, n=8192, c=2)


def pipe_blocks(t_blocks: int, seed: int = 3) -> np.ndarray:
    """tests/test_pipeline.py:30-43: [T, 2C, N] float32 packed AM planes."""
    c, n, fs = PIPE["c"], PIPE["n"], PIPE["fs"]
    rng = np.random.default_rng(seed)
    t = np.arange(t_blocks * n) / fs
    env = (1 + 0.5 * np.cos(2 * np.pi * 800.0 * t)) / 2
    iq = (env * np.exp(2j * np.pi * 100_000.0 * t)
          + 0.01 * (rng.normal(size=t_blocks * n)
                    + 1j * rng.normal(size=t_blocks * n))).astype(
        np.complex64)
    return np.stack([
        np.concatenate([np.broadcast_to(b.real, (c, n)),
                        np.broadcast_to(b.imag, (c, n))], 0)
        for b in iq.reshape(t_blocks, n)]).astype(np.float32)


# --------------------------------------------------------------------- cases

def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def case_comm(rank: int) -> dict:
    import torch

    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.parallel import (channelizer, comm, multihost,
                                              scaling)
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    out = {}
    m = mesh_mod.make_mesh(1, 4, "cpu")
    x = torch.tensor([[float(m.index("time"))]])
    out["shift_right"] = comm.ring_shift_right(x, m, "time")
    out["shift_left"] = comm.ring_shift_left(x, m, "time")
    out["rotate"] = comm.ring_rotate(x, m, "time", 1)
    out["sum"] = comm.all_sum(x, m, "time")
    out["max"] = comm.all_max(x, m, "time")
    out["mean"] = comm.all_mean(x, m, "time")
    out["gather"] = comm.gather_axis(x, m, "time", 0)
    out["gather1"] = comm.gather_axis(x.expand(2, 3), m, "time", 1)
    out["bcast"] = comm.broadcast_from(x, m, "time", 3)
    out["rs"] = comm.reduce_scatter_sum(torch.ones(16, 4), m, "time", 0)
    a = torch.arange(32.0).reshape(4, 8) + 100.0 * m.index("time")
    out["a2a"] = comm.all_to_all(a, m, "time", 1, 0)
    z = torch.from_numpy(cplx((3, 5), m.index("time")))
    out["cgather"] = comm.gather_axis(z, m, "time", 1)
    out["cshift"] = comm.ring_shift_right(z, m, "time")
    out["index"] = comm.axis_index(m, "time")
    comm.reset_counters()
    comm.all_sum(torch.ones(10), m, "time")
    comm.gather_axis(torch.ones(2, 3), m, "time", 0)
    out["counts"] = [comm.counters["calls"]["all_reduce"],
                     comm.counters["bytes"]["all_reduce"],
                     comm.counters["calls"]["all_gather"],
                     comm.counters["bytes"]["all_gather"],
                     comm.counters["hops"]]
    cs = scaling.collective_stats(lambda: comm.ring_shift_right(
        torch.ones(3, 2), m, "time"))
    out["cstats"] = [cs["collective_count"], cs["collective_bytes"],
                     cs["collective_ops"]["ppermute"], cs["host_hops"]]
    # multihost: two "nodes" of two ranks (LOCAL_WORLD_SIZE=2)
    gm = multihost.global_mesh(device_type="cpu")
    out["gm_shape"] = [gm.size("channel"), gm.size("time")]
    node = comm.rank() // 2
    local = np.random.default_rng(node).normal(size=(2, 2, 256)).astype(
        np.float32)
    out["node_block"] = local
    out["dist"] = multihost.distribute_host_blocks(gm, torch.from_numpy(
        local))

    def step(state, params, iq):
        return state + 1, (iq[:, 0] ** 2 + iq[:, 1] ** 2).sum()

    rep = multihost.scaling_report(step, torch.zeros(()), None,
                                   torch.ones(2, 2, 128), steps=3, mesh=gm)
    out["rep"] = [rep["devices"], rep["hosts"], rep["samples_per_s"],
                  rep["msps_per_device"], rep["wall_s"]]
    # local slices of a global state, block and plane on the (2, 2) mesh
    rx = Receiver(ReceiverConfig(sample_rate=512_000, frames_per_buffer=8192,
                                 channels=4, mode=DemodMode.FMS), "cpu")
    full = channelizer.init_state(rx)
    full = dataclasses_map(full, lambda i, a: a + 1e4 * i + torch.arange(
        a.numel()).reshape(a.shape).to(a.dtype))
    mine = mesh_mod.shard_state(full, gm, 4)
    out["state_full"] = leaves_of(full)
    out["state_mine"] = leaves_of(mine)
    out["rx_blk"] = rx.blk
    iq = torch.from_numpy(cplx((4, 64), 11))
    out["block"] = mesh_mod.local_block(iq, gm)
    out["plane"] = mesh_mod.local_plane(torch.from_numpy(packed(_np(iq))),
                                        gm)
    out["coord"] = [gm.index("channel"), gm.index("time")]
    return out


def leaves_of(state) -> np.ndarray:
    """A state's leaves, flattened and joined (a fingerprint)."""
    from pebblesdr_tpu_torch.utils import convert
    return np.concatenate([np.asarray(_np(a)).astype(np.complex128).ravel()
                           for a in convert.leaves(state)])


def dataclasses_map(state, fn):
    """fn(i, leaf) over a state's leaves, i the leaf's index."""
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    count = [0]

    def f(a):
        count[0] += 1
        return fn(count[0], a)
    return mesh_mod.tree_map(f, state)


def case_time_shard(rank: int) -> dict:
    import torch

    from pebblesdr_tpu_torch.ops import decimator, fastfir, fir
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    from pebblesdr_tpu_torch.parallel import time_shard
    out = {}
    m = mesh_mod.make_mesh(1, 8, "cpu")
    t0, t1 = mesh_mod.time_range(m, FIR["n"])
    # FIR: three streaming blocks
    taps = np.asarray(fir.design_halfband(23, 0.182), np.float32)
    rng = np.random.default_rng(0)
    c, n = FIR["c"], FIR["n"]
    blocks = [(rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n))
               ).astype(np.complex64) for _ in range(FIR["blocks"])]
    carry = fir.fir_tail_init(c, len(taps), "cpu")
    for i, b in enumerate(blocks):
        y, carry = time_shard.sharded_fir_decimate(
            torch.from_numpy(b[:, t0:t1]), taps, carry, 2, m)
        out[f"fir{i}"] = y
    out["fir_carry"] = carry
    # the cascade
    plan = decimator.build_plan(1_024_000, 20_000)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(1, 1 << 14)) + 1j * rng.normal(size=(1, 1 << 14))
         ).astype(np.complex64)
    s0, s1 = mesh_mod.time_range(m, 1 << 14)
    _, y = time_shard.sharded_decimator_apply(
        plan, decimator.state_init(plan, 1, "cpu"),
        torch.from_numpy(x[:, s0:s1]), m)
    out["cascade"] = y
    # the mix
    from pebblesdr_tpu_torch.ops import mixer
    hi, lo = mixer.split_freq(123_456.0, 1_024_000.0)
    rng = np.random.default_rng(2)
    xm = (rng.normal(size=(2, 8192)) + 1j * rng.normal(size=(2, 8192))
          ).astype(np.complex64)
    ph, y = time_shard.sharded_mix(torch.zeros(2), torch.from_numpy(
        xm[:, t0:t1]), float(hi), float(lo), m)
    out["mix"], out["mix_phase"] = y, ph
    # overlap-save: one round of 512 per shard
    mask = torch.from_numpy(fastfir.design_mask(-3000.0, 3000.0, 16000.0,
                                                512))
    rng = np.random.default_rng(3)
    xo = (rng.normal(size=(1, 4096)) + 1j * rng.normal(size=(1, 4096))
          ).astype(np.complex64)
    o0, o1 = mesh_mod.time_range(m, 4096)
    st, y = time_shard.sharded_overlap_save(
        fastfir.state_init(1, 512, "cpu"), torch.from_numpy(xo[:, o0:o1]),
        mask, m)
    out["ols"], out["ols_state"] = y, st
    # the DC chunks: DC-offset noise, a carried estimate
    xd = noisy_dc(3, 8 * 4096, 5)
    d0, d1 = mesh_mod.time_range(m, xd.shape[1])
    dc0 = torch.tensor([0.01 + 0.02j, -0.03j, 0.05], dtype=torch.complex64)
    ms, mall, ndc = time_shard.sharded_dc_chunks(
        torch.from_numpy(xd[:, d0:d1]), dc0, 0.9999, m)
    out["dc_start"], out["dc_all"], out["dc_new"] = ms, mall, ndc
    ndc2, z = time_shard.sharded_dc_removal(torch.from_numpy(xd[:, d0:d1]),
                                            dc0, 0.9999, m)
    out["dc_z"], out["dc_new2"] = z, ndc2
    # the composed front: two streaming blocks
    plan = decimator.build_plan(2_048_000, 30_000.0)
    h = decimator.compose_response(plan)
    xs = noisy_dc(2, 2 * 16384, 9)
    carry = torch.zeros(2, len(h) - 1, dtype=torch.complex64)
    phase = torch.zeros(2)
    hi, lo = mixer.split_freq(250_000.0, 2_048_000.0)
    for i in range(2):
        blk = xs[:, i * 16384:(i + 1) * 16384]
        b0, b1 = mesh_mod.time_range(m, 16384)
        phase, carry, y = time_shard.sharded_composed_front(
            torch.from_numpy(blk[:, b0:b1]), phase, float(hi), float(lo),
            carry, h, plan.factor, m)
        out[f"composed{i}"] = y
    out["composed_phase"], out["composed_carry"] = phase, carry
    return out


def _sharded_run(m, rx, params, blocks, fused, tag, out, many=False):
    """Run the sharded step over `blocks` ([C, n] complex global blocks, or
    with many [K*N, 2C] planes) on the mesh; store the rank's audio (and
    with many the S-meter SNR) under tag, with its channel start."""
    import torch

    from pebblesdr_tpu_torch.parallel import channelizer
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    if not m.member:
        return
    step = channelizer.build_sharded_step(rx, m, fused=fused)
    st = step.init_state()
    got, snr = [], []
    for b in blocks:
        if many:
            st, o = step.step_many(st, params, mesh_mod.local_plane(
                torch.from_numpy(b), m))
            got.append(o["audio"])
            snr.append(o["smeter"]["snr_db"])
        else:
            st, a = step(st, params, mesh_mod.local_block(
                torch.from_numpy(b), m))
            got.append(a)
    out[tag] = torch.cat(got, 0 if many else -1)
    out[tag + "/c0"] = step.c0
    if many:
        out[tag + "_snr"] = torch.cat(snr, 0)
        out[tag + "_snr/c0"] = step.c0


def case_channelizer(rank: int) -> dict:
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    out = {}
    fs, n = CH["fs"], CH["n"]

    def am(c):
        return Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                       channels=c, mode=DemodMode.AM,
                                       agc_mode="off"), "cpu")
    # (8, 1): the channel-parallel step
    rx = am(8)
    m = mesh_mod.make_mesh(8, 1, "cpu")
    _sharded_run(m, rx, rx.default_params(100_000.0),
                 [am_broadcast(8, n, fs)], None, "cp", out)
    # (4, 2): the staged front, two blocks
    iq = am_tones(8, 2 * n, fs)
    m = mesh_mod.make_mesh(4, 2, "cpu")
    _sharded_run(m, rx, rx.default_params(np.linspace(-150_000, 150_000, 8)),
                 [iq[:, :n], iq[:, n:]], False, "staged42", out)
    # (2, 4): the fused front (K1's plain version per shard), DC offset
    rx4 = am(4)
    iq = am_tones(4, 3 * n, fs, dc=0.03)
    m = mesh_mod.make_mesh(2, 4, "cpu")
    _sharded_run(m, rx4, rx4.default_params(np.linspace(-150_000, 150_000,
                                                        4)),
                 [iq[:, i * n:(i + 1) * n] for i in range(3)], True,
                 "fused24", out)
    # (2, 2): fused and staged on the same mesh
    rx2 = am(2)
    iq = noisy_dc(2, 2 * n)
    m = mesh_mod.make_mesh(2, 2, "cpu")
    p2 = rx2.default_params(np.array([50_000.0, -75_000.0]))
    for fused in (False, True):
        _sharded_run(m, rx2, p2, [iq[:, :n], iq[:, n:]], fused,
                     f"pair22_{int(fused)}", out)
    # (4, 2): WFM stereo, staged and fused
    w = WFM
    rxw = Receiver(ReceiverConfig(sample_rate=w["fs"],
                                  frames_per_buffer=w["n"], channels=w["c"],
                                  mode=DemodMode.FMS), "cpu")
    iq = fm_stereo(w["c"], w["blocks"] * w["n"], w["fs"])
    m = mesh_mod.make_mesh(4, 2, "cpu")
    for fused in (False, True):
        _sharded_run(m, rxw, rxw.default_params(300_000.0),
                     [iq[:, i * w["n"]:(i + 1) * w["n"]]
                      for i in range(w["blocks"])], fused,
                     f"wfm42_{int(fused)}", out)
    # (4, 2): the port's dispatch contract, K blocks per dispatch
    c, k = MANY["c"], MANY["k"]
    iq = am_tones(c, MANY["dispatches"] * k * n, fs, dc=0.02)
    planes = [packed(iq[:, i * k * n:(i + 1) * k * n])
              for i in range(MANY["dispatches"])]
    _sharded_run(m, rx, rx.default_params(np.linspace(-150_000, 150_000, c)),
                 planes, True, "many42", out, many=True)
    return out


def case_pfb(rank: int) -> dict:
    import torch

    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.ops import pfb
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    from pebblesdr_tpu_torch.parallel.pfb_shard import build_sharded_bank_step
    b = BANK
    plan = pfb.plan(b["fs"], b["m"])
    tunes = pfb.channel_freqs(plan)[list(b["channels"])] + np.array(
        b["offsets"])
    bank = PfbBankReceiver(b["fs"], b["frames"], tunes, mode=DemodMode.AM,
                           n_bank=b["m"], agc_mode="off", device="cpu")
    x = bank_capture()
    m = mesh_mod.make_mesh(2, 4, "cpu")
    step = build_sharded_bank_step(bank, m)
    st = step.init_state()
    got = []
    for i in range(b["blocks"]):
        blk = x[i * b["frames"]:(i + 1) * b["frames"]]
        t0, t1 = mesh_mod.time_range(m, b["frames"])
        st, o = step(st, None, torch.from_numpy(blk[t0:t1].copy()))
        got.append(o["audio"][0])
    return {"audio": torch.cat(got, -1), "s0": step.s0, "s1": step.s1}


def bank_capture() -> np.ndarray:
    b = BANK
    rng = np.random.default_rng(3)
    n = b["blocks"] * b["frames"]
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def case_dist_fft(rank: int) -> dict:
    import torch

    from pebblesdr_tpu_torch.core import windows
    from pebblesdr_tpu_torch.parallel import dist_fft
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    out = {}
    m = mesh_mod.make_mesh(1, 8, "cpu")
    for n1, n2 in FFT_SHAPES:
        x = cplx(n1 * n2, 0).reshape(n1, n2)
        out[f"fft_{n1}_{n2}"] = dist_fft.fft_sharded(torch.from_numpy(x), m)
    try:
        dist_fft.fft_sharded(torch.zeros(12, 128, dtype=torch.complex64), m)
        out["indivisible"] = ""
    except ValueError as e:
        out["indivisible"] = str(e)
    n1, n2 = 64, 256
    k0 = 3000
    t = np.arange(n1 * n2)
    tone = np.exp(2j * np.pi * k0 * t / (n1 * n2)).astype(np.complex64)
    out["tone"] = dist_fft.power_spectrum_sharded(
        torch.from_numpy(tone.reshape(n1, n2)), m)
    n1, n2 = 64, 128
    x = cplx(n1 * n2, 5)
    w = windows.window(windows.WindowType.HANNING, n1 * n2)
    r0, r1 = mesh_mod.time_range(m, n1)
    out["windowed"] = dist_fft.power_spectrum_sharded(
        torch.from_numpy(x.reshape(n1, n2)[r0:r1].copy()), m, window=w,
        local=True)
    return out


def case_pipeline(rank: int) -> dict:
    import torch

    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.parallel import pipeline
    out = {}
    rx = Receiver(ReceiverConfig(sample_rate=PIPE["fs"],
                                 frames_per_buffer=PIPE["n"],
                                 channels=PIPE["c"], mode=DemodMode.AM,
                                 taps=True), "cpu")
    params = rx.default_params(100_000.0)
    stages, init = pipeline.am_chain_stages(rx, params)
    mesh = pipeline.stage_mesh(len(stages), "cpu")
    pipe = pipeline.RingPipeline(stages, mesh)
    xs = torch.from_numpy(pipe_blocks(6))
    # the sequential composition on this rank
    sts, ref = list(init), []
    for xb in xs:
        b = xb
        for i, stg in enumerate(stages):
            sts[i], b = stg.fn(sts[i], b)
        ref.append(b)
    out["seq"] = torch.stack(ref)
    new_states, ys = pipe.run(pipeline.am_chain_stages(rx, params)[1], xs)
    out["ys"] = ys
    out["states"] = leaves_of(tuple(new_states))
    out["seq_states"] = leaves_of(tuple(sts))
    # streaming across runs: one 4-block run vs two 2-block runs
    x4 = torch.from_numpy(pipe_blocks(4))
    _, once = pipe.run(pipeline.am_chain_stages(rx, params)[1], x4)
    st, y1 = pipe.run(pipeline.am_chain_stages(rx, params)[1], x4[:2])
    _, y2 = pipe.run(st, x4[2:])
    out["once"], out["twice"] = once, torch.cat([y1, y2])
    # against the monolithic staged Receiver
    x5 = torch.from_numpy(pipe_blocks(5))
    _, y5 = pipe.run(pipeline.am_chain_stages(rx, params)[1], x5)
    out["y5"] = y5
    st = rx.init_state()
    ref = []
    c = PIPE["c"]
    for xb in x5:
        st, o = rx.step(st, params, torch.complex(xb[:c], xb[c:]),
                        spectra=False)
        ref.append(o["audio"])
    out["rx5"] = torch.stack(ref)
    # a mesh of the wrong size
    try:
        pipeline.RingPipeline(stages, pipeline.stage_mesh(2, "cpu"))
        out["size_check"] = ""
    except ValueError as e:
        out["size_check"] = str(e)
    return out


CASES = {"comm": case_comm, "time_shard": case_time_shard,
         "channelizer": case_channelizer, "pfb": case_pfb,
         "dist_fft": case_dist_fft, "pipeline": case_pipeline}


def main() -> None:
    case, rank, world, port, outdir = sys.argv[1:6]
    import torch
    torch.set_num_threads(1)
    from pebblesdr_tpu_torch.parallel import comm
    comm.init_world(int(world), int(rank), "cpu", f"tcp://127.0.0.1:{port}")
    res = CASES[case](int(rank))
    np.savez(os.path.join(outdir, f"{rank}.npz"),
             **{k: _np(v) for k, v in res.items()})
    comm.destroy_world()


if __name__ == "__main__":
    main()
