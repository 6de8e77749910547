"""The RDS subchain of the PyTorch port against the JAX package.

On the CPU, with inputs made from numpy seeds:

  * the scan-free squaring loop pll.costas_open_run (and its square=False
    form) at C=8 over two streaming calls;
  * the premix decimation fir.fir_apply_real_signal_pair;
  * rds_process at C=8 on the same real composite over two streaming calls;
  * rds_process with the premix=False inputs, composed and staged (C=3,
    two streaming calls), with the "open" and the "scan" carrier;
  * the RDS Receiver at C=4 with 32768-frame blocks (the shortest block
    whose 19 kHz stream holds whole symbols), at the default and the hq
    geometry: a JAX dispatch of 3 blocks whose state is carried into the
    port, then one more of 3 blocks through both (step_many against JAX's
    _step_many_impl at the same K: the symbol-timing EWMA updates once per
    call, pebblesdr_tpu/demod/rds.py:151-156);
  * the host decoders fed the same soft symbols as JAX's;
  * the port's CPU chain decoding the PS name "PEBBLES " (5 dispatches of 8
    blocks, as tests/test_chain_batched.py:299-345 does).

Bounds: soft symbols 1e-3 of their scale; timing equal; audio 2e-4; state
1e-4 absolute (the carrier phases psi and ang are sums over a dispatch's
chunks, up to 2 pi, and differ by float32 accumulation order, ~1e-5 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rds import differential_encode, make_ps_groups

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod import rds as jrds
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu.ops import fir as jfir
from pebblesdr_tpu.ops import pll as jpll
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import rds as trds
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import fir as tfir
from pebblesdr_tpu_torch.ops import pll as tpll
from pebblesdr_tpu_torch.utils import convert

FS, N = 2_048_000, 32768
RATE = 256_000.0


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def biphase(t: np.ndarray) -> np.ndarray:
    """The PS groups of "PEBBLES " (PI 0x54A8) as differential biphase
    symbols at 1187.5 baud, sampled at times t."""
    bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
    sym = np.asarray(differential_encode(bits), np.float64) * 2 - 1
    idx = np.minimum((t * jrds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    frac = t * jrds.RDS_BAUD - idx
    return sym[idx] * np.where(frac < 0.5, 1.0, -1.0)


def composite(t: np.ndarray) -> np.ndarray:
    """FM-stereo composite with RDS: 1 kHz mono, pilot, 57 kHz BPSK."""
    return (0.3 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.06 * biphase(t) * np.cos(2 * np.pi * 57000.0 * t))


def rds_plane(c: int, rows: int, seed: int, t0: float = 0.0) -> np.ndarray:
    """[rows, 2C] packed plane of the composite FM-modulated at 250 kHz;
    channel i at level 0.3 + 0.4 i / C and phase i, noise at 1e-2."""
    t = t0 + np.arange(rows) / FS
    ph = 2 * np.pi * np.cumsum(75000.0 * composite(t)) / FS
    x = np.stack([(0.3 + 0.4 * i / c)
                  * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph + i))
                  for i in range(c)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


def real_composite(c: int, n: int, seed: int, t0: float) -> np.ndarray:
    """[C, n] discriminator-scaled composite at 256 kHz, per-channel delay
    and noise."""
    rng = np.random.default_rng(seed)
    t = t0 + np.arange(n) / RATE
    gain = 2 * np.pi * 75000.0 / RATE * 0.54
    return np.stack([gain * composite(t - 1e-4 * i)
                     + 0.01 * rng.standard_normal(n)
                     for i in range(c)]).astype(np.float32)


def close(a, b, tol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    d = np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max() \
        if a.size else 0.0
    assert d < tol, (what, d)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("square", [True, False])
def test_costas_open_run_matches_jax_streaming(square):
    """A BPSK (or plain) carrier 35 Hz off at 19 kHz with noise, C=8."""
    c, n, chunk = 8, 4864, 16
    cfg_j = jpll.make_costas_open_config(19000.0, square=square)
    cfg_t = tpll.make_costas_open_config(19000.0, square=square)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    sj, st = jpll.costas_open_init(c), tpll.costas_open_init(c, "cpu")
    rng = np.random.default_rng(4 if square else 5)
    for call in range(2):
        t = (call * n + np.arange(n)) / 19000.0
        data = np.sign(rng.standard_normal((c, n // 16))).repeat(16, 1) \
            if square else 1.0
        x = (data * np.exp(1j * (2 * np.pi * 35.0 * t
                                 + np.arange(c)[:, None]))
             + 0.05 * (rng.standard_normal((c, n))
                       + 1j * rng.standard_normal((c, n)))
             ).astype(np.complex64)
        sj, pj, lj = jpll.costas_open_run(cfg_j, sj, jnp.asarray(x),
                                          chunk=chunk, square=square)
        st, pt, lt = tpll.costas_open_run(cfg_t, st, torch.from_numpy(x),
                                          chunk=chunk, square=square)
        # phases grow to ~2 pi 35 Hz x 0.5 s: float32 association
        close(pj, pt, 1e-4, "phases")
        close(lj, lt, 1e-5, "level")
        for f in dataclasses.fields(st):
            close(getattr(sj, f.name), getattr(st, f.name), 1e-4, f.name)
    assert float(lt[:, -1].min()) > 0.5       # the carrier is tracked


def test_costas_open_run_rejects_partial_chunks():
    cfg = tpll.make_costas_open_config(19000.0)
    with pytest.raises(ValueError):
        tpll.costas_open_run(cfg, tpll.costas_open_init(2, "cpu"),
                             torch.zeros(2, 100, dtype=torch.complex64),
                             chunk=16)


@pytest.mark.parametrize("n", [12288, 1024, 768])
def test_fir_apply_real_signal_pair_matches_jax(n):
    """The premix tap pair at the 256 kHz RDS plan (decimation by 16), on
    the windowed (n = 3 blocks) and the whole-block banded paths."""
    cfg = trds.RdsConfig.make(RATE, 4096)
    rng = np.random.default_rng(n)
    t = len(cfg.h_mix_re)
    tail = rng.standard_normal((3, t - 1)).astype(np.float32)
    x = rng.standard_normal((3, n)).astype(np.float32)
    ja, jb, jt = jfir.fir_apply_real_signal_pair(
        jnp.asarray(x), jnp.asarray(tail), cfg.h_mix_re, cfg.h_mix_im,
        decim=16)
    ta, tb, tt = tfir.fir_apply_real_signal_pair(
        torch.from_numpy(x), torch.from_numpy(tail), cfg.h_mix_re,
        cfg.h_mix_im, decim=16)
    close(ja, ta, 1e-5, "a")
    close(jb, tb, 1e-5, "b")
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_rds_process_matches_jax_streaming():
    c, blk, k = 8, 4096, 3
    jcfg = jrds.RdsConfig.make(RATE, blk)
    tcfg = trds.RdsConfig.make(RATE, blk)
    sj, st = jrds.rds_init(jcfg, c), trds.rds_init(tcfg, c, "cpu")
    for call in range(2):
        x = real_composite(c, k * blk, call, call * k * blk / RATE)
        sj, softj, timj = jrds.rds_process(jcfg, sj, jnp.asarray(x))
        st, softt, timt = trds.rds_process(tcfg, st, torch.from_numpy(x))
        assert softt.shape == (c, k * tcfg.n_sym) == (c, 57)
        scale = float(np.abs(np.asarray(softj)).max())
        assert scale > 1e-3
        close(softj, softt, 1e-3 * scale, "soft")
        assert np.array_equal(np.asarray(timj), timt.numpy())
        jl, tl = jleaves(sj), convert.state_to_numpy(st)
        assert len(jl) == len(tl) == 10
        for i, (a, b) in enumerate(zip(jl, tl)):
            close(a, b, 1e-4, i)


# the scan carrier and the premix=False inputs run now: both cases are held
# to the JAX package, in the composed and the staged (composed=False) form
# (the ids keep the cases' names)
@pytest.mark.parametrize("change,what", [
    (dict(alg="scan", premix=False), "premix=False"),
    (dict(premix=False), "premix=False"),
], ids=["change0-scan", "change1-premix=False"])
def test_unported_rds_options_named(change, what):
    """Both forms of the premix=False input, composed and staged
    (composed=False): rds_init lays the history out as JAX does ([2C,
    len(h) - 1] float32 composed, one [C, T-1] complex64 tail per halfband
    stage staged); two streaming calls of 3 blocks match JAX's
    rds_process."""
    c, blk, k = 3, 4096, 3
    for composed in (True, False):
        kw = dict(change, composed=composed)
        jcfg = dataclasses.replace(jrds.RdsConfig.make(RATE, blk), **kw)
        tcfg = dataclasses.replace(trds.RdsConfig.make(RATE, blk), **kw)
        sj, st = jrds.rds_init(jcfg, c), trds.rds_init(tcfg, c, "cpu")
        jl, tl = jleaves(sj), convert.state_to_numpy(st)
        assert [a.shape for a in jl] == [b.shape for b in tl]
        assert [a.dtype for a in jl] == [b.dtype for b in tl]
        for call in range(2):
            x = real_composite(c, k * blk, call, call * k * blk / RATE)
            sj, softj, timj = jrds.rds_process(jcfg, sj, jnp.asarray(x))
            st, softt, timt = trds.rds_process(tcfg, st, torch.from_numpy(x))
            scale = float(np.abs(np.asarray(softj)).max())
            assert scale > 1e-3 and softt.shape == (c, 57)
            close(softj, softt, 1e-3 * scale, what)
            assert np.array_equal(np.asarray(timj), timt.numpy())
            for i, (a, b) in enumerate(zip(jleaves(sj),
                                           convert.state_to_numpy(st))):
                close(a, b, 1e-4, (composed, i))


def test_rds_refuses_a_complex_baseband():
    """A complex baseband takes the composed input, whose [2C, ...]
    history a premix state does not have (JAX fails there too)."""
    cfg = trds.RdsConfig.make(RATE, 4096)
    st = trds.rds_init(cfg, 2, "cpu")
    with pytest.raises(ValueError, match="complex"):
        trds.rds_process(cfg, st, torch.zeros(2, 4096, dtype=torch.complex64))


def test_rds_needs_whole_symbols_per_block():
    """A 1024-sample tail block gives 76 samples at 19 kHz (JAX raises too)."""
    with pytest.raises(ValueError, match="whole symbols"):
        jrds.RdsConfig.make(RATE, 1024)
    with pytest.raises(ValueError, match="whole symbols"):
        trds.RdsConfig.make(RATE, 1024)
    with pytest.raises(ValueError, match="whole symbols"):
        Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=8192,
                                channels=2, mode=DemodMode.FMS, rds=True),
                 "cpu")


# ----------------------------------------------------------- the Receiver

@pytest.fixture(scope="module")
def rx_runs():
    res = {}
    c, k = 4, 3
    for hq in (False, True):
        kw = dict(sample_rate=FS, frames_per_buffer=N, channels=c, rds=True,
                  wfm_hq=hq)
        jrx = JaxReceiver(JaxConfig(use_pallas=True, mode=JaxMode.FMS, **kw))
        trx = Receiver(ReceiverConfig(mode=DemodMode.FMS, **kw), "cpu")
        jp = jrx.default_params(250_000.0)
        tp = convert.params_from_numpy(trx, jleaves(jp))
        jst, _ = jrx._step_many_impl(jrx.init_state(), jp,
                                     jnp.asarray(rds_plane(c, k * N, 1)))
        tst = convert.state_from_numpy(trx, jleaves(jst))
        x = rds_plane(c, k * N, 2, t0=k * N / FS)
        jst, jo = jrx._step_many_impl(jst, jp, jnp.asarray(x))
        tst, to = trx.step_many(tst, tp, torch.from_numpy(x))
        rds_leaves = len(convert.leaves(tst.rds))
        res[hq] = (jo, to, jleaves(jst), convert.state_to_numpy(tst),
                   rds_leaves, trx)
    return res


@pytest.mark.parametrize("hq", [False, True], ids=["default", "hq"])
def test_rds_receiver_soft_symbols_and_timing(rx_runs, hq):
    jo, to, _, _, _, trx = rx_runs[hq]
    soft_j, soft_t = np.asarray(jo["rds_soft"]), to["rds_soft"].numpy()
    assert soft_t.shape == (3, 4, trx.rds_cfg.n_sym) == (3, 4, 19)
    scale = float(np.abs(soft_j).max())
    assert scale > 1e-3
    close(soft_j, soft_t, 1e-3 * scale, "rds_soft")
    assert np.array_equal(np.asarray(jo["rds_timing"]),
                          to["rds_timing"].numpy())
    assert to["rds_timing"].dtype == torch.int32
    close(jo["audio"], to["audio"], 2e-4, "audio")
    assert np.array_equal(np.asarray(jo["pilot_locked"]),
                          to["pilot_locked"].numpy())


@pytest.mark.parametrize("hq", [False, True], ids=["default", "hq"])
def test_rds_receiver_state(rx_runs, hq):
    """Every RdsState leaf (and the rest of the state) after the dispatch;
    the JAX XLA route's packed low-pass history is compared on its last
    T-1 rows (tests/test_torch_receiver_wfm.py)."""
    _, _, js, ts, n_rds, trx = rx_runs[hq]
    assert len(js) == len(ts)
    st = trx.init_state()
    lp = next(i for i, leaf in enumerate(convert.leaves(st))
              if leaf is st.demod.lp_tail_mono)
    first_rds = next(i for i, leaf in enumerate(convert.leaves(st))
                     if leaf is st.rds.decim)
    assert n_rds == 10
    for i, (a, b) in enumerate(zip(js, ts)):
        if i == lp:
            a, b = a[-234:], b[-234:]
        close(a, b, 1e-4, ("rds " if first_rds <= i < first_rds + n_rds
                           else "") + str(i))


def test_host_decoders_match_jax():
    """The same soft symbols (a PS stream with burst errors and a slipped
    bit) through both packages' block and group decoders."""
    bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=6)
    sym = np.asarray(differential_encode([0] * 37 + bits), np.float64) * 2 - 1
    rng = np.random.default_rng(3)
    soft = sym * (0.5 + rng.uniform(0, 1, sym.shape))
    for start in (400, 900, 1500):            # bursts of 2-4 flipped symbols
        soft[start:start + rng.integers(2, 5)] *= -1
    soft = np.concatenate([soft[:2000], soft[2001:]])   # a lost symbol
    dj, dt = jrds.RdsBlockDecoder(), trds.RdsBlockDecoder()
    for chunk in np.array_split(soft, 7):
        dj.feed_symbols(chunk)
        dt.feed_symbols(chunk)
    assert dj.groups == dt.groups and len(dt.groups) > 4
    for key in ("block_errors", "blocks_ok", "bits_corrected", "synced"):
        assert getattr(dj, key) == getattr(dt, key), key
    assert dt.block_errors > 0 and dt.bits_corrected > 0
    gj, gt = jrds.RdsGroupDecoder(), trds.RdsGroupDecoder()
    for g in dt.groups:
        gj.decode(g)
        gt.decode(g)
    assert (gj.pi, gj.pty, gj.ps_name, gj.pty_name, gj.callsign) == (
        gt.pi, gt.pty, gt.ps_name, gt.pty_name, gt.callsign)
    assert gt.callsign == "WAAA"


def test_group_decoder_radiotext_and_pin_match_jax():
    groups = [(0x54A8, (2 << 12) | (9 << 5) | s,
               (ord("AB"[0]) << 8) | ord("C"), (ord("D") << 8) | ord("E"))
              for s in range(3)]
    groups += [(0x54A8, (2 << 12) | (1 << 11) | 4, 0, 0x4647),
               (0x54A8, 1 << 12, 0x00E1, 0x1234),
               (0x1234, 0, 0, 0x4142)]
    gj, gt = jrds.RdsGroupDecoder(), trds.RdsGroupDecoder()
    for g in groups:
        gj.decode(g)
        gt.decode(g)
        assert (gj.radiotext, gj.ecc, gj.pin, gj.ps_name, gj.pty) == (
            gt.radiotext, gt.ecc, gt.pin, gt.ps_name, gt.pty)


def test_encode_group_matches_jax():
    for args in ((0x54A8, 0x0408, 0xE0E0, 0x4142), (0x1234, 0x2800, 1, 2)):
        for vb in (False, True):
            assert jrds.encode_group(*args, version_b=vb) == \
                trds.encode_group(*args, version_b=vb)


def test_cpu_chain_decodes_ps():
    """5 dispatches of 8 blocks at C=1 through the port's CPU Receiver: the
    host decoders sync and read "PEBBLES " (tests/test_chain_batched.py:
    299-345 with the port)."""
    n_disp, kb = 5, 8
    n_total = n_disp * kb * N
    t = np.arange(n_total) / FS
    ph = 2 * np.pi * np.cumsum(75000.0 * composite(t)) / FS
    iq = 0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + ph))
    x = torch.from_numpy(np.stack([iq.real, iq.imag], 1).astype(np.float32))
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                 channels=1, mode=DemodMode.FMS, rds=True),
                  "cpu")
    st, p = rx.init_state(), rx.default_params(300_000.0)
    dec = trds.RdsBlockDecoder()
    for d in range(n_disp):
        st, out = rx.step_many(st, p, x[d * kb * N:(d + 1) * kb * N],
                               spectra=False)
        assert out["rds_soft"].shape == (kb, 1, 19)
        assert out["rds_timing"].shape == (kb, 1)
        dec.feed_symbols(out["rds_soft"][:, 0].reshape(-1).numpy())
    assert dec.synced
    assert len(dec.groups) >= 4, (dec.blocks_ok, dec.block_errors)
    g = trds.RdsGroupDecoder()
    for grp in dec.groups:
        g.decode(grp)
    assert g.ps_name == "PEBBLES "
    assert g.callsign == "WAAA"
