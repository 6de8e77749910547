"""Checkpoint/resume, stream recovery, health and the feeder of the PyTorch
port (utils/checkpoint.py, utils/recovery.py, utils/health.py,
io/feeder.py) on the CPU, mirroring the JAX package's tests of the same
modules against its own receiver:

  * tests/test_recovery.py: a gap of dropped blocks resynced (the tone
    phase-coherent again two blocks after it, the NCO phase equal to the
    JAX package's resync_state bit for bit), the report's structure, a
    killed stream resumed bit for bit through the supervisor, and the
    carries of the noise blanker, CTCSS, ANF (on the fused and on the
    staged front) and RDS resumed bit for bit;
  * tests/test_chain.py:262 TestStateResume (the state through the host
    and back);
  * tests/test_modem2.py TestFeeder and TestHealth (the feeder's packed
    blocks, equal to the JAX feeder's, and its overrun count; drops and
    the real-time factor; the metrics' export);
  * the file format both ways: a checkpoint that the JAX package's
    save_state writes resumes in the port within tests/torch_parity.py's
    bounds, and one that the port writes loads in the JAX package's
    load_state with every leaf equal.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu.ops.mixer import MixerState as JaxMixerState
from pebblesdr_tpu.utils import checkpoint as jckpt
from pebblesdr_tpu.utils import recovery as jrecovery
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.io.feeder import Feeder
from pebblesdr_tpu_torch.io.sources import SyntheticSource
from pebblesdr_tpu_torch.ops.mixer import MixerState
from pebblesdr_tpu_torch.utils import checkpoint as ckpt
from pebblesdr_tpu_torch.utils import convert, recovery
from pebblesdr_tpu_torch.utils.health import HealthMonitor, Metrics
from pebblesdr_tpu_torch.utils.perform import Perform

FS = 512_000
N = 8192
F0 = 250_013.0  # per-block mixer phase advance deliberately non-integer


def _rx():
    return Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                   channels=1, mode=DemodMode.USB,
                                   agc_mode="off"), "cpu")


def _blocks(n_blocks):
    t = np.arange(n_blocks * N) / FS
    iq = (0.5 * np.exp(2j * np.pi * (F0 + 1000.0) * t)).astype(np.complex64)
    return [iq[None, i * N:(i + 1) * N] for i in range(n_blocks)]


def _run(rx, params, blocks, seqs, supervisor=None):
    state = rx.init_state()
    audio = {}
    for seq, blk in zip(seqs, blocks):
        if supervisor is not None:
            state = supervisor.observe(state, seq)
        state, out = rx.step(state, params, torch.from_numpy(blk),
                             spectra=False)
        if supervisor is not None:
            supervisor.block_done(state)
        audio[seq] = out["audio"][0].numpy()
    return state, audio


# ---- tests/test_recovery.py

def test_phase_coherent_after_gap():
    """Drop 3 blocks mid-stream: with resync the post-gap audio matches
    the uninterrupted run (phase-coherent USB tone) after a bounded
    transient; without resync it stays phase-rotated."""
    rx = _rx()
    params = rx.default_params(F0)
    n_blocks = 20
    blocks = _blocks(n_blocks)
    _, ref = _run(rx, params, blocks, range(n_blocks))

    keep = [s for s in range(n_blocks) if not 10 <= s <= 12]
    sup = recovery.StreamSupervisor(rx, params)
    _, got = _run(rx, params, [blocks[s] for s in keep], keep,
                  supervisor=sup)

    assert sup.monitor.dropped_blocks == 3
    assert "gap" in [e.kind for e in sup.events]
    for s in (15, 16, 19):
        np.testing.assert_allclose(got[s], ref[s], atol=2e-4)
    np.testing.assert_allclose(got[9], ref[9], atol=1e-6)

    _, bad = _run(rx, params, [blocks[s] for s in keep], keep,
                  supervisor=None)
    assert np.max(np.abs(bad[19] - ref[19])) > 0.05


@pytest.mark.parametrize("gap", [1, 3, 8192, 3 * 8192 + 5, 2 ** 20 + 17])
def test_resync_phase_matches_jax(gap):
    """The resynced NCO phase, from the same phases and tune words, equals
    the JAX package's resync_state bit for bit (float32 remainders as
    jnp.mod takes them)."""
    cfg = dict(sample_rate=FS, frames_per_buffer=N, channels=4,
               mode="USB", agc_mode="off")
    jrx = JaxReceiver(JaxConfig(**{**cfg, "mode": JaxMode.USB}))
    trx = Receiver(ReceiverConfig(**{**cfg, "mode": DemodMode.USB}), "cpu")
    tunes = np.array([F0, -123_456.7, 7.25, 255_999.0])
    jp = jrx.default_params(tunes)
    tparams = convert.params_from_numpy(trx, tp.jleaves(jp))
    ph = np.array([0.0, 0.99999994, 0.5, 0.123456], np.float32)
    jst = dataclasses.replace(jrx.init_state(),
                              mixer=JaxMixerState(phase=jnp.asarray(ph)))
    tst = dataclasses.replace(trx.init_state(),
                              mixer=MixerState(phase=torch.from_numpy(ph)))
    want = np.asarray(jrecovery.resync_state(jrx, jst, jp, gap).mixer.phase)
    got = recovery.resync_state(trx, tst, tparams, gap).mixer.phase.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_report_structure():
    rx = _rx()
    params = rx.default_params(F0)
    sup = recovery.StreamSupervisor(rx, params)
    blocks = _blocks(6)
    keep = [0, 1, 4, 5]
    _run(rx, params, [blocks[s] for s in keep], keep, supervisor=sup)
    rep = sup.report()
    assert rep["dropped_blocks"] == 2
    gap_events = [e for e in rep["events"] if e["kind"] == "gap"]
    assert gap_events and gap_events[0]["gap_blocks"] == 2
    assert set(rep) == {"blocks", "dropped_blocks", "feeder_overruns",
                        "realtime_factor", "healthy", "events"}
    json.dumps(rep)


def test_resume_bit_exact(tmp_path):
    """Checkpoint every 4 blocks, 'crash' after block 9, restore into a
    fresh receiver, replay from the checkpointed sequence: the outputs
    equal the uninterrupted run's bit for bit."""
    rx = _rx()
    params = rx.default_params(F0)
    n_blocks = 14
    blocks = _blocks(n_blocks)
    _, ref = _run(rx, params, blocks, range(n_blocks))

    path = str(tmp_path / "chain.npz")
    sup = recovery.StreamSupervisor(rx, params, checkpoint_path=path,
                                    checkpoint_every=4)
    state = rx.init_state()
    for seq in range(10):
        state = sup.observe(state, seq)
        state, _ = rx.step(state, params, torch.from_numpy(blocks[seq]),
                           spectra=False)
        sup.block_done(state)
    assert any(e.kind == "checkpoint" for e in sup.events)

    rx2 = _rx()
    sup2 = recovery.StreamSupervisor(rx2, params, checkpoint_path=path,
                                     checkpoint_every=4)
    state2, meta = sup2.restore(rx2.init_state())
    assert meta["seq"] == 8 and meta["blocks"] == 8
    assert sup2.events[-1].kind == "restore"
    for seq in range(meta["seq"], n_blocks):
        state2 = sup2.observe(state2, seq)
        state2, out = rx2.step(state2, params, torch.from_numpy(blocks[seq]),
                               spectra=False)
        sup2.block_done(state2)
        np.testing.assert_array_equal(out["audio"][0].numpy(), ref[seq])


def _fmn_iq(n_blocks: int, n: int, fs: int) -> np.ndarray:
    """tests/test_recovery.py's FMN signal: 2.5 kHz deviation at 1 kHz and
    the 123 Hz CTCSS tone at 500 Hz on +300 kHz, 8+8j impulses every
    100000 samples, on 2 channels."""
    t = np.arange(n_blocks * n) / fs
    dev = 2500.0 * np.sin(2 * np.pi * 1000.0 * t) \
        + 500.0 * np.sin(2 * np.pi * 123.0 * t)
    ph = 2 * np.pi * np.cumsum(dev) / fs
    iq = (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + ph))
          ).astype(np.complex64)
    iq[5000::100000] += 8.0 + 8.0j
    return iq[None, :] * np.ones((2, 1), np.float32)


def _am_iq(n_blocks: int, n: int, fs: int) -> np.ndarray:
    """AM (1 kHz at 80 %) on +300 kHz through the IQ imbalance of
    tests/test_chain.py:204-236, 2 channels."""
    t = np.arange(n_blocks * n) / fs
    z = 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(
        2j * np.pi * 300_000.0 * t)
    x = 1.06 * z.real + 1j * (z.imag + 0.08 * z.real)
    return (x[None, :] * np.ones((2, 1))).astype(np.complex64)


def _wfm_iq(n_blocks: int, n: int, fs: int) -> np.ndarray:
    t = np.arange(n_blocks * n) / fs
    comp = 0.3 * np.sin(2 * np.pi * 1000.0 * t) \
        + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
    return (0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + ph))
            ).astype(np.complex64)[None]


# (mode, receiver options, the output compared, frames, blocks, signal)
CARRIES = {
    "fmn_nb_anf_ctcss": (DemodMode.FMN, dict(
        channels=2, enable_noise_blanker=True, enable_anf=True,
        ctcss_tone=123.0), "audio", 32768, 8, _fmn_iq),
    "fms_rds": (DemodMode.FMS, dict(channels=1, rds=True), "rds_soft", 32768,
                6, _wfm_iq),
    "am_staged_anf": (DemodMode.AM, dict(
        channels=2, enable_iq_balance="auto", enable_anf=True), "audio",
        8192, 8, _am_iq),
}


@pytest.mark.parametrize("case", list(CARRIES))
def test_resume_bit_exact_carried_states(case, tmp_path):
    """The carries of the in-kernel noise blanker (avg, spike tail), the
    CTCSS detector, the ANF's weights and history (the fused front's once
    per block; the staged front's every 16 samples, beside the adaptive
    IQ weight) and the RDS carrier and timing: saved mid-stream, restored
    into a fresh receiver, the blocks after equal bit for bit."""
    mode, opts, key, n, n_blocks, signal = CARRIES[case]
    fs = 2_048_000
    cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=n, mode=mode,
                         **opts)
    rx = Receiver(cfg, "cpu")
    params = rx.default_params(300_000.0)
    iq = signal(n_blocks, n, fs)
    half = n_blocks // 2
    path = str(tmp_path / "mid.npz")
    st = rx.init_state()
    outs = []
    for b in range(n_blocks):
        if b == half:
            ckpt.save_state(path, st)
        st, o = rx.step(st, params, torch.from_numpy(iq[:, b * n:(b + 1) * n]),
                        spectra=False)
        outs.append(o[key].numpy())
    rx2 = Receiver(cfg, "cpu")
    st2, extra = ckpt.load_state(path, rx2.init_state())
    assert extra == {}
    for b in range(half, n_blocks):
        st2, o2 = rx2.step(st2, params,
                           torch.from_numpy(iq[:, b * n:(b + 1) * n]),
                           spectra=False)
        np.testing.assert_array_equal(o2[key].numpy(), outs[b])
    if cfg.enable_anf:
        assert float(st2.anf.weights.abs().max()) > 1e-3   # it adapted


def test_load_refuses_another_configuration(tmp_path):
    """A checkpoint of one configuration does not load into another: the
    leaf count (the ANF's two leaves) or a leaf's shape (channels)."""
    kw = dict(sample_rate=FS, frames_per_buffer=N, mode=DemodMode.AM)
    path = str(tmp_path / "ck.npz")
    ckpt.save_state(path, Receiver(ReceiverConfig(**kw), "cpu").init_state())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_state(path, Receiver(ReceiverConfig(enable_anf=True, **kw),
                                       "cpu").init_state())
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_state(path, Receiver(ReceiverConfig(channels=2, **kw),
                                       "cpu").init_state())


# ---- tests/test_chain.py:262 TestStateResume

def test_checkpoint_resume_bitexact():
    """The state through the host and back (its leaves as numpy, rebuilt
    into the structure): the outputs after it identical."""
    fs, n = 2_048_000, 32768
    rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                 mode=DemodMode.AM), "cpu")
    nb = 6
    t = np.arange(nb * n) / fs
    iq = (0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
          * np.exp(2j * np.pi * 250_000.0 * t)).astype(np.complex64)[None]
    params = rx.default_params(250_000.0)
    state = rx.init_state()
    for i in range(3):
        state, _ = rx.step(state, params,
                           torch.from_numpy(iq[:, i * n:(i + 1) * n]))
    restored = convert.from_numpy(rx.init_state(),
                                  convert.state_to_numpy(state), "cpu")
    sa, sb = state, restored
    for i in range(3, nb):
        blk = torch.from_numpy(iq[:, i * n:(i + 1) * n])
        sa, oa = rx.step(sa, params, blk)
        sb, ob = rx.step(sb, params, blk)
        assert torch.equal(oa["audio"], ob["audio"])


# ---- tests/test_modem2.py TestFeeder and TestHealth

class FiveBlocks:
    """The first five blocks of a source, then the end of the stream."""

    def __init__(self, source):
        self.source, self.left = source, 5

    def read_block(self, n: int):
        if self.left == 0:
            return None
        self.left -= 1
        return self.source.read_block(n)


def test_feeder_overlapped_reads():
    """The feeder's [N, 2C] lane-packed float32 blocks, equal to the JAX
    package's feeder's from its own synthetic source.  The queue holds the
    whole five-block stream and its end, so no scheduling of the consumer
    can make the producer drop a block (the drop-oldest path is the next
    test's)."""
    from pebblesdr_tpu.io.feeder import Feeder as JaxFeeder
    from pebblesdr_tpu.io.sources import SyntheticSource as JaxSource

    got = {}
    for name, feeder_cls, src in (
            ("port", Feeder, SyntheticSource(48_000, tones=((1000.0, 0.5),))),
            ("jax", JaxFeeder, JaxSource(48_000, tones=((1000.0, 0.5),)))):
        f = feeder_cls(FiveBlocks(src), block=4800, channels=2,
                       depth=6).start()
        blocks = list(f)
        f.stop()
        assert not f._thread.is_alive()
        assert f.overruns == 0 and len(blocks) == 5
        got[name] = blocks
    assert got["port"][0].shape == (4800, 4)
    assert got["port"][0].dtype == np.float32
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)


def test_feeder_counts_overruns_and_drops_the_oldest():
    """A consumer that stalls: the producer drops the oldest block of a
    full queue and counts an overrun each time; the blocks kept are the
    newest, in order."""
    src = SyntheticSource(48_000, tones=((1000.0, 0.5),))
    f = Feeder(src, block=480, channels=1, depth=2).start()
    deadline = time.monotonic() + 10.0
    while f.overruns < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    f._stop.set()
    f._thread.join(timeout=5)
    assert not f._thread.is_alive()
    assert f.overruns >= 3
    kept = [f.q.get_nowait() for _ in range(f.q.qsize())]
    assert 1 <= len(kept) <= 2
    assert f.blocks_read == f.overruns + len(kept)


def test_feeder_ends_with_the_source():
    """A finite source: iteration stops at its end (None from the queue)."""
    class Three(SyntheticSource):
        def __init__(self):
            super().__init__(48_000)
            self.n = 0

        def read_block(self, n):
            self.n += 1
            return super().read_block(n) if self.n <= 3 else None

    f = Feeder(Three(), block=256).start()
    assert len(list(f)) == 3
    f.stop()
    assert not f._thread.is_alive()


def test_monitor_tracks_drops_and_rtf():
    hm = HealthMonitor(sample_rate=48_000, frames_per_buffer=4800)
    for seq in [0, 1, 2, 5, 6]:  # blocks 3, 4 dropped
        hm.block_done(seq=seq)
        time.sleep(0.01)
    rep = hm.report()
    assert rep["dropped_blocks"] == 2
    assert not rep["healthy"]
    assert rep["realtime_factor"] > 1.0


def test_metrics_export():
    m = Metrics(host_id=3)
    m.count("blocks", 5)
    m.gauge("snr_db", 42.5)
    p = Perform("cpu")
    with p.measure("step"):
        pass
    out = m.export(p)
    assert out["host"] == 3
    assert out["counters"]["blocks"] == 5.0
    assert out["gauges"]["snr_db"] == 42.5
    assert "step" in out["stages_ms"]
    json.loads(m.export_json())


# ---- the file format both ways

K = 3


@pytest.fixture(scope="module")
def format_runs(tmp_path_factory):
    """The AM receiver of tests/torch_parity.py (4 channels, 8192 frames,
    the JAX Receiver with use_pallas=True): one JAX step and a dispatch of
    K, its state saved by the JAX package's save_state; the port loads it
    and runs the next dispatch beside JAX; the port's state after that
    saved by the port's save_state."""
    d = tmp_path_factory.mktemp("ckpt")
    jrx, trx, jp, tparams = tp.receivers(DemodMode.AM, tp.KW)
    step_many = jax.jit(jrx._step_many_impl)
    jst, _ = jax.jit(jrx.step)(jrx.init_state(), jp,
                               jnp.asarray(tp.tone_plane(1, 7, 0.0, am=True)))
    jst, _ = step_many(jst, jp, jnp.asarray(tp.tone_plane(K, 0, 0.0, am=True)))
    jpath = str(d / "jax.npz")
    jckpt.save_state(jpath, jst, extra={"blocks": 1 + K})
    tst, extra = ckpt.load_state(jpath, trx.init_state())
    x = tp.tone_plane(K, 1, 0.0, am=True)
    jst, jo = step_many(jst, jp, jnp.asarray(x))
    tst, to = trx.step_many(tst, tparams, torch.from_numpy(x))
    tpath = str(d / "port.npz")
    ckpt.save_state(tpath, tst, extra={"blocks": 1 + 2 * K})
    return dict(jrx=jrx, extra=extra, jo=jo, to=to, js=tp.jleaves(jst),
                ts=convert.state_to_numpy(tst), tpath=tpath)


def test_jax_checkpoint_resumes_in_the_port(format_runs):
    r = format_runs
    assert r["extra"] == {"blocks": 1 + K}
    tp.check_audio(r["jo"], r["to"])
    tp.check_spectra(r["jo"], r["to"])
    tp.check_smeter_and_squelch(r["jo"], r["to"])
    tp.check_state(r["js"], r["ts"])


def test_port_checkpoint_loads_in_jax(format_runs):
    r = format_runs
    jst, extra = jckpt.load_state(r["tpath"], r["jrx"].init_state())
    assert extra == {"blocks": 1 + 2 * K}
    got = tp.jleaves(jst)
    assert len(got) == len(r["ts"])
    for a, b in zip(got, r["ts"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
