"""The stereo tail without K2 of the PyTorch port against the JAX package on
the CPU.

  * demod/wfm.py wfm_demod in stereo on channel-major IQ against the JAX
    wfm_demod with pallas_tail False (its XLA tail), over two streaming
    calls of two blocks: the open and the "pll" pilot (the Q=500 bandpass,
    then the chunked loop K3c, or with pilot_chunk 0 the per-sample loop
    K3), with and without the pilot notch, at the default and the hq
    (comp_decim 2) geometry;
  * the fused-tail route with the notch (wfm_demod_tm, K2's plain version)
    against the JAX wfm_demod_tm (the Pallas tail in interpret mode;
    tm_notch_parity, run by tests/test_torch_nfm.py);
  * the port's Receiver in FMS where K2 cannot run, through the harness of
    torch_parity.py: 2.88 Msps (tail_sub == 0, audio_decim 5, which does
    not divide the 4096- or 1024-sample tail block), 1.536 Msps at 24576
    frames (audio_decim 6), and on the staged front (enable_iq_balance=
    "auto");
  * the carried state converted both ways, and stereo separation on an
    L-only program at 2.88 Msps.

At 2.88 Msps each block keeps its own decimation grid (block // 5 audio
samples from its first sample), as the JAX package's per-block path
(_step_impl: its CLI on the CPU, and use_pallas=False) runs it; its
batched graph decimates across the block seams instead, which changes the
samples and cannot form K >= 5 blocks (K * 4096 // 5 is then no multiple
of K).  So the 2.88 Msps Receiver is held to the JAX Receiver's per-block
path (batched_many=False) with the fused front.

Bounds: the stereo tail's audio 5e-4 absolute (tests/test_chain_pallas.py:
190) at module level; the receivers those of tests/test_chain_batched.py:
58-69 (audio 2e-4, spectra and S-meter 0.1 dB, squelch and pilot lock
equal, every state leaf 1e-4, phases on the circle); separation >= 30 dB
(tests/test_chain.py:415 asks 40 of the hq geometry, the default one
reads ~35).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.demod import wfm as jwfm
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import wfm
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import pll
from pebblesdr_tpu_torch.utils import convert

RATE = 256_000.0
FS_288 = 2_880_000


def stereo_iq(n: int, c: int, seed: int, fs: float, offset: float = 0.0,
              left_hz: float = 1000.0, right_hz: float = 400.0,
              right: float = 1.0) -> np.ndarray:
    """[C, n] complex64 FM stereo at `offset` Hz from the centre of an fs
    capture (75 kHz deviation; L = sin(left_hz), R = right * sin(right_hz),
    the 19 kHz pilot at 0.1, L-R on 38 kHz), channel i at level 0.3 + 0.4
    i / C and phase pi/4 + i pi/2, complex noise at 1e-2."""
    t = seed * 0.37 + np.arange(n) / fs
    lt = np.sin(2 * np.pi * left_hz * t)
    rt = right * np.sin(2 * np.pi * right_hz * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * (lt + rt) / 2 + 0.1 * np.sin(th) \
        + 0.45 * (lt - rt) / 2 * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
    x = np.stack([(0.3 + 0.4 * i / c)
                  * np.exp(1j * (2 * np.pi * offset * t + ph + np.pi / 4
                                 + i * np.pi / 2)) for i in range(c)])
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def stereo_plane(fs: float, n: int, c: int):
    """plane(k, seed) for torch_parity: [k*n, 2C] float32, the station at
    the harness's tune."""
    def plane(k, seed):
        x = stereo_iq(k * n, c, seed, fs, offset=tp.TUNE)
        return np.concatenate([x.real.T, x.imag.T], axis=1).astype(
            np.float32)
    return plane


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def pilot_phase_leaves(state: wfm.WFMState) -> tuple:
    """Indices, in the flatten order, of the pilot's phase leaves (compared
    on the circle)."""
    pp = state.pilot_pll
    i = len(convert.leaves(state.last)) + len(convert.leaves(state.pilot_bq))
    names = [f.name for f in dataclasses.fields(pp)]
    return tuple(i + names.index(n) for n in ("phase", "psi", "base")
                 if n in names)


def lmr_history_leaf(state: wfm.WFMState) -> int:
    """The index of lp_tail_lmr, the L-R low-pass's input history, in the
    flatten order."""
    i = 0
    for f in dataclasses.fields(state):
        if f.name == "lp_tail_lmr":
            return i
        i += len(convert.leaves(getattr(state, f.name)))
    raise KeyError("lp_tail_lmr")


def check_leaves(js, ts, angles=(), signals=()):
    """Every leaf within 1e-4 (angles on the circle); the leaves `signals`
    (demuxed L-R samples) within the stereo tail's audio bound 5e-4."""
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
        if i in angles:
            d = np.abs(np.angle(np.exp(1j * (a.astype(np.float64)
                                              - b.astype(np.float64)))))
        assert d.max(initial=0.0) < (5e-4 if i in signals else 1e-4), \
            (i, d.max())


def check_wfm_state(jst, tst: wfm.WFMState, cfg: wfm.WFMConfig):
    """check_leaves on a WFMState.  With the "pll" pilot the demux
    multiplies the composite by 2 sin(2 phase), where phase is the chunked
    loop's absolute ramp (up to ~2e3 rad within a call: a float32 ulp is
    1.2e-4 rad there, and the JAX package states ~1e-3 rad for its own
    blockwise loop, pebblesdr_tpu/demod/wfm.py:399-400), so the carried L-R
    samples are held to the audio bound."""
    check_leaves(jleaves(jst), convert.state_to_numpy(tst),
                 pilot_phase_leaves(tst),
                 (lmr_history_leaf(tst),) if cfg.pilot_alg == "pll" else ())


# ------------------------------------------------------------ module level

def test_config_designs_match_jax():
    """The "pll" pilot's designs: the bandpass biquad, the loop gains, the
    chunk; the hq composite taps."""
    for kw in (dict(), dict(pilot_alg="pll"), dict(comp_decim=2)):
        j, t = jwfm.WFMConfig.make(RATE, **kw), wfm.WFMConfig.make(RATE, **kw)
        assert dataclasses.asdict(j.pilot_bp) == dataclasses.asdict(t.pilot_bp)
        assert dataclasses.asdict(j.pilot_pll) == \
            dataclasses.asdict(t.pilot_pll)
        assert (j.pilot_chunk, j.pilot_alg, j.notch_needed) == \
            (t.pilot_chunk, t.pilot_alg, t.notch_needed)
        if kw.get("comp_decim"):
            assert np.array_equal(np.asarray(j.comp_taps), t.comp_taps)


def _wfm_pair(rate: float, notch: bool, **make):
    jcfg = jwfm.WFMConfig.make(rate, **make)
    tcfg = wfm.WFMConfig.make(rate, **make)
    if notch:
        jcfg = dataclasses.replace(jcfg, notch_needed=True)
        tcfg = dataclasses.replace(tcfg, notch_needed=True)
    return jcfg, tcfg


def wfm_demod_parity(rate: float, notch: bool = False, c: int = 2,
                     n_block: int = 2048, **make) -> dict:
    """Two streaming calls of wfm_demod over 2 blocks of n_block input
    samples each, JAX (XLA tail) against the port; every bound checked.
    Returns the port's last outputs."""
    jcfg, tcfg = _wfm_pair(rate, notch, **make)
    assert tcfg.tail_sub == 0 and not jcfg.pallas_tail
    fs_in = tcfg.input_rate
    jst = jwfm.wfm_init(jcfg, c)
    tst = convert.from_numpy(wfm.wfm_init(tcfg, c, "cpu"), jleaves(jst),
                             "cpu")
    jdemod = jax.jit(lambda s, x: jwfm.wfm_demod(jcfg, s, x, n_block=n_block))
    for call in range(2):
        x = stereo_iq(2 * n_block, c, call, fs_in)
        jst, jo = jdemod(jst, jnp.asarray(x))
        tst, to = wfm.wfm_demod(tcfg, tst, torch.from_numpy(x), n_block)
        for key in ("left", "right"):
            a, b = np.asarray(jo[key]), to[key].numpy()
            assert a.shape == b.shape, key
            assert np.abs(a - b).max() < 5e-4, (key, np.abs(a - b).max())
        assert np.array_equal(np.asarray(jo["pilot_locked"]),
                              to["pilot_locked"].numpy())
        check_wfm_state(jst, tst, tcfg)
    assert np.abs(to["left"].numpy()).max() > 0.1
    return to


@pytest.mark.parametrize("pilot,notch", [("open", False), ("open", True),
                                         ("pll", False), ("pll", True)])
def test_wfm_demod_stereo_matches_jax(pilot, notch):
    to = wfm_demod_parity(RATE, notch=notch, pilot_alg=pilot)
    assert bool(to["pilot_locked"].all())


def test_wfm_demod_pll_per_sample_loop_matches_jax():
    """pilot_chunk 0: the per-sample loop pll.pll_run (K3's plain version)."""
    jcfg, tcfg = _wfm_pair(RATE, False, pilot_alg="pll")
    c, n_block = 2, 1024
    jcfg = dataclasses.replace(jcfg, pilot_chunk=0)
    tcfg = dataclasses.replace(tcfg, pilot_chunk=0)
    jst = jwfm.wfm_init(jcfg, c)
    tst = wfm.wfm_init(tcfg, c, "cpu")
    x = stereo_iq(2 * n_block, c, 3, RATE)
    jst, jo = jax.jit(lambda s, x: jwfm.wfm_demod(jcfg, s, x,
                                                  n_block=n_block))(
        jst, jnp.asarray(x))
    tst, to = wfm.wfm_demod(tcfg, tst, torch.from_numpy(x), n_block)
    for key in ("left", "right"):
        assert np.abs(np.asarray(jo[key]) - to[key].numpy()).max() < 5e-4
    check_wfm_state(jst, tst, tcfg)


def test_wfm_demod_hq_pll_matches_jax():
    """The hq geometry (discriminator at 512 kHz, composite decimated by 2)
    with the "pll" pilot."""
    wfm_demod_parity(RATE, pilot_alg="pll", comp_decim=2, n_block=4096)


def tm_notch_parity():
    """The fused-tail route with the notch: K2's plain version, then the
    notch on stacked L/R, against JAX's wfm_demod_tm (Pallas tail in
    interpret mode), two streaming calls of 2 blocks (tests/test_torch_nfm.
    py's "nfm pll" case)."""
    c, n_block, sub = 2, 2048, 1024
    jcfg = dataclasses.replace(jwfm.WFMConfig.make(RATE), pallas_tail=True,
                               pallas_interpret=True, tail_sub=sub,
                               notch_needed=True)
    tcfg = dataclasses.replace(wfm.WFMConfig.make(RATE), tail_sub=sub,
                               notch_needed=True)
    plan = wfm.tail_plan(tcfg, n_block, "cpu")
    jst = jwfm.wfm_init(jcfg, c)
    tst = wfm.wfm_init(tcfg, c, "cpu")
    last = np.zeros(c, np.complex64)
    for call in range(2):
        x = stereo_iq(2 * n_block + 1, c, call, RATE)
        raw = np.angle(x[:, 1:] * np.conj(x[:, :-1])) * (
            RATE / (2 * np.pi * 75000.0))
        raw_t = np.ascontiguousarray(raw.T).astype(np.float32)
        jst, jo = jwfm.wfm_demod_tm(jcfg, jst, jnp.asarray(raw_t),
                                    jnp.asarray(last), n_block=n_block)
        tst, to = wfm.wfm_demod_tm(tcfg, plan, tst, torch.from_numpy(raw_t),
                                   torch.from_numpy(last), n_block)
        for key in ("left", "right"):
            assert np.abs(np.asarray(jo[key]) - to[key].numpy()).max() < 5e-4
        assert np.array_equal(np.asarray(jo["pilot_locked"]),
                              to["pilot_locked"].numpy())
        check_wfm_state(jst, tst, tcfg)
    assert np.abs(to["left"].numpy()).max() > 0.1
    assert bool(to["pilot_locked"].all())


def test_pilot_open_run_is_the_chunk_ramp():
    """pilot_open_run's per-sample phase is p0 + wf t within each chunk."""
    raw = torch.randn(3, 2048)
    cfg = pll.make_pilot_open_config(RATE)
    st = pll.pilot_open_init(3, "cpu")
    _, phases, lv = pll.pilot_open_run(cfg, st, raw)
    _, (p0, wf, t_in), lv2 = pll.pilot_open_core(cfg, st, raw)
    want = p0[:, :, None] + wf[:, :, None] * t_in
    assert torch.equal(phases, want.reshape(3, -1))
    assert torch.equal(lv, lv2)


# ------------------------------------------------------------- receivers

def receiver_parity(fs: int, frames: int, ks=(3,), c: int = 2,
                    jcfg=None, **cfg) -> dict:
    """torch_parity.check_run for FMS at fs with C channels and
    `frames`-frame blocks, the station at the harness's tune; the pilot
    lock must agree and hold in the last dispatch."""
    res = tp.check_run(DemodMode.FMS, stereo_plane(fs, frames, c), ks=ks,
                       kw=dict(tp.KW, sample_rate=fs, frames_per_buffer=frames,
                               channels=c), jcfg=jcfg, **cfg)
    for key in ("step", *ks):
        jo, to, _, _ = res[key]
        assert np.array_equal(np.asarray(jo["pilot_locked"]),
                              to["pilot_locked"].numpy())
        assert to["audio"].shape[-2] == 2
    assert bool(res[ks[-1]][1]["pilot_locked"].all())
    return res


def test_receiver_fms_2m88_matches_jax():
    rx = Receiver(ReceiverConfig(sample_rate=FS_288, frames_per_buffer=8192,
                                 channels=2, mode=DemodMode.FMS), "cpu")
    assert rx.wfm_cfg.tail_sub == 0 and rx.wfm_tail is None
    assert (rx.wfm_cfg.audio_decim, rx.blk) == (5, 1024)
    receiver_parity(FS_288, 8192, jcfg=dict(batched_many=False))


def test_receiver_fms_2m88_state_converts_both_ways():
    """The [C, T-1] FIR tails and the open pilot's state: JAX -> port ->
    JAX leaves are the same arrays, and the port's layout is JAX's."""
    kw = dict(sample_rate=FS_288, frames_per_buffer=8192, channels=3)
    jrx, trx, _, _ = tp.receivers(DemodMode.FMS, dict(kw))
    js = jleaves(jrx.init_state())
    rng = np.random.default_rng(5)
    js = [(rng.standard_normal(a.shape) + (1j * rng.standard_normal(a.shape)
                                           if np.iscomplexobj(a) else 0))
          .astype(a.dtype) if a.dtype != bool else a for a in js]
    back = convert.state_to_numpy(convert.state_from_numpy(trx, js))
    assert all(np.array_equal(a, b) for a, b in zip(js, back))
    t = len(trx.wfm_cfg.audio_taps)
    st = trx.init_state().demod
    assert st.lp_tail_mono.shape == st.lp_tail_lmr.shape == (3, t - 1)


def test_receiver_fms_2m88_separation():
    """L-only 700 Hz at 2.88 Msps, C = 1, 12 blocks of 32768 in two
    dispatches: R's 700 Hz tone, on the second dispatch, >= 30 dB below
    L's."""
    frames, k = 32768, 6
    rx = Receiver(ReceiverConfig(sample_rate=FS_288, frames_per_buffer=frames,
                                 channels=1, mode=DemodMode.FMS), "cpu")
    st, p = rx.init_state(), rx.default_params(300_000.0)
    x = stereo_iq(2 * k * frames, 1, 0, FS_288, offset=300_000.0,
                  left_hz=700.0, right=0.0)[0]
    plane = torch.from_numpy(np.stack([x.real, x.imag], 1).astype(np.float32))
    for call in range(2):
        st, out = rx.step_many(st, p, plane[call * k * frames:
                                            (call + 1) * k * frames],
                               spectra=False)
    assert bool(out["pilot_locked"][-1].all())
    aud = out["audio"][:, 0].permute(1, 0, 2).reshape(2, -1).double().numpy()
    amp = [tp.tone_fit(a, 700.0, rx.cfg.audio_rate)[0] for a in aud]
    assert 20 * np.log10(amp[0] / max(amp[1], 1e-12)) >= 30.0


def test_receiver_fms_staged_matches_jax():
    """FMS stereo on the staged front (adaptive IQ balance, K5's plain
    version) against the JAX package's per-block staged path."""
    rx = Receiver(ReceiverConfig(**tp.KW, mode=DemodMode.FMS,
                                 enable_iq_balance="auto"), "cpu")
    assert rx.staged and rx.wfm_cfg.stereo and rx.wfm_tail is None
    receiver_parity(tp.FS, tp.N, c=tp.C, enable_iq_balance="auto")
