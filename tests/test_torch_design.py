"""Host-side design arrays of the PyTorch port == the JAX package's.

The port copies the numpy/scipy design code instead of importing it; these
tests hold every copied array to the original: identical (np.array_equal),
or within 1e-7 where a float64 -> float32 cast is involved.
"""

import dataclasses

import jax
import numpy as np
import pytest

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.core import windows as jwin
from pebblesdr_tpu.demod import am as jam
from pebblesdr_tpu.demod import modes as jmodes
from pebblesdr_tpu.demod import nfm as jnfm
from pebblesdr_tpu.demod import rds as jrds
from pebblesdr_tpu.demod import sam as jsam
from pebblesdr_tpu.demod import wfm as jwfm
from pebblesdr_tpu.ops import agc as jagc
from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import fastfir as jff
from pebblesdr_tpu.ops import fir as jfir
from pebblesdr_tpu.ops import goertzel as jgz
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as jpk
from pebblesdr_tpu.ops import pll as jpll
from pebblesdr_tpu.ops import resampler as jrs
from pebblesdr_tpu.ops import scanops as jscan
from pebblesdr_tpu.ops import signalstrength as jss
from pebblesdr_tpu.ops import spectrum as jspec
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.core import windows as twin
from pebblesdr_tpu_torch.demod import am as tam
from pebblesdr_tpu_torch.demod import modes as tmodes
from pebblesdr_tpu_torch.demod import nfm as tnfm
from pebblesdr_tpu_torch.demod import rds as trds
from pebblesdr_tpu_torch.demod import sam as tsam
from pebblesdr_tpu_torch.demod import wfm as twfm
from pebblesdr_tpu_torch.ops import agc as tagc
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import fastfir as tff
from pebblesdr_tpu_torch.ops import fir as tfir
from pebblesdr_tpu_torch.ops import goertzel as tgz
from pebblesdr_tpu_torch.ops import mixer as tmix
from pebblesdr_tpu_torch.ops import pll as tpll
from pebblesdr_tpu_torch.ops import resampler as trs
from pebblesdr_tpu_torch.ops import scanops as tscan
from pebblesdr_tpu_torch.ops import signalstrength as tss
from pebblesdr_tpu_torch.ops import spectrum as tspec
from pebblesdr_tpu_torch.utils import convert

FS = 2_048_000


@pytest.mark.parametrize("kind", list(jwin.WindowType), ids=lambda k: k.value)
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_identical(kind, periodic):
    a = jwin.window(kind, 257, periodic=periodic)
    b = twin.window(twin.WindowType(kind.value), 257, periodic=periodic)
    assert np.array_equal(a, b)
    assert jwin.coherent_gain(a) == twin.coherent_gain(b)


@pytest.mark.parametrize("kind", list(jwin.WindowType), ids=lambda k: k.value)
@pytest.mark.parametrize("n", [64, 2048])
def test_enbw_identical(kind, n):
    w = jwin.window(kind, n)
    assert jwin.enbw(w) == twin.enbw(twin.window(twin.WindowType(kind.value),
                                                 n))


@pytest.mark.parametrize("ntaps,wpass", jdec.HALFBAND_SPECS[1:])
def test_halfband_taps_identical(ntaps, wpass):
    assert np.array_equal(jfir.design_halfband(ntaps, wpass),
                          tfir.design_halfband(ntaps, wpass))


@pytest.mark.parametrize("fs,protect", [(FS, 30_000.0), (FS, 200_000.0),
                                        (1_024_000, 30_000.0),
                                        (2_500_000, 20_000.0),
                                        (FS, 20_000.0), (FS, 48_000.0)])
def test_plan_and_composed_response_identical(fs, protect):
    jp = jdec.build_plan(fs, protect)
    tp = tdec.build_plan(fs, protect)
    assert [s.name for s in jp.stages] == [s.name for s in tp.stages]
    for a, b in zip(jp.stages, tp.stages):
        assert np.array_equal(a.taps, b.taps)
    assert (jp.rate_out, jp.factor) == (tp.rate_out, tp.factor)
    h = jdec.compose_response(jp)
    assert np.array_equal(h, tdec.compose_response(tp))
    d = len(h) - 1
    d_rows = ((d + 7) // 8) * 8
    assert np.array_equal(jpk.build_composed_w(h, jp.factor, 2048, d_rows - d),
                          tdec.build_composed_w(h, tp.factor, 2048, d_rows - d))


@pytest.mark.parametrize("lo,hi,block", [(-6000.0, 6000.0, 1024),
                                         (-6000.0, 6000.0, 256),
                                         (300.0, 3000.0, 512)])
def test_fastfir_mask_identical(lo, hi, block):
    assert np.array_equal(jff.design_mask(lo, hi, 64000.0, block),
                          tff.design_mask(lo, hi, 64000.0, block))


@pytest.mark.parametrize("n_in", [1024, 256, 2048])
def test_resampler_plan_identical(n_in):
    a = jrs.plan(64000, 48000, n_in)
    b = trs.plan(64000, 48000, n_in)
    assert (a.n_out, a.taps) == (b.n_out, b.taps)
    assert np.array_equal(a.dense, b.dense)


@pytest.mark.parametrize("n_bins", [256, 1024])
def test_band_masks_identical(n_bins):
    for a, b in zip(jss.band_masks(-6000.0, 6000.0, 64000.0, n_bins),
                    tss.band_masks(-6000.0, 6000.0, 64000.0, n_bins)):
        assert np.array_equal(a, b)
    assert (jss.band_bins(-6000.0, 6000.0, 64000.0, n_bins)
            == tss.band_bins(-6000.0, 6000.0, 64000.0, n_bins))


def test_am_taps_and_banded_operator_identical():
    ja = jam.AMConfig.make(64000.0, 12000.0)
    ta = tam.AMConfig.make(64000.0, 12000.0)
    assert np.array_equal(ja.taps, ta.taps)
    taps32 = np.asarray(ta.taps, np.float32)
    for n, decim in ((256, 1), (768, 1), (512, 4)):
        assert np.array_equal(np.asarray(jfir.banded_fir_matrix(taps32, n, decim)),
                              tfir.banded_fir_matrix(taps32, n, decim))
        assert jfir._banded_seg(n * 9, 127, decim) == tfir._banded_seg(n * 9, 127, decim)
    assert np.array_equal(
        jfir.design_lowpass_kaiser(4000.0, 48000.0),
        tfir.design_lowpass_kaiser(4000.0, 48000.0))


@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_spectrum_window_and_dft_identical(n):
    wa, ga = jspec.make_window(n)
    wb, gb = tspec.make_window(n)
    assert np.array_equal(wa, wb) and ga == gb
    fa = [np.asarray(m) for m in jspec._dft_mats(n)]
    fb = tspec.dft_mats_np(n)
    assert np.array_equal(fa[0], fb[0]) and np.array_equal(fa[1], fb[1])


@pytest.mark.parametrize("freq", [250_000.0, -123_456.7, 0.0, 1_000_001.0])
def test_split_freq_identical(freq):
    assert jmix.split_freq(freq, FS) == tmix.split_freq(freq, FS)


@pytest.mark.parametrize("stride", [1, 16])
def test_agc_config_and_init_identical(stride):
    ja = jagc.AGCConfig.make(64000.0, "med", stride=stride)
    ta = tagc.AGCConfig.make(64000.0, "med", stride=stride)
    assert (ja.window, ja.delay, ja.stride) == (ta.window, ta.delay, ta.stride)
    js = jax.tree_util.tree_leaves(jagc.agc_init(ja, 3))
    ts = convert.leaves(tagc.agc_init(ta, 3, "cpu"))
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_headline_geometry():
    """The AM headline plan: facts the port's kernel and tail are sized by."""
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=32768, channels=64,
                         agc_stride=16)
    rx = Receiver(cfg, "cpu")
    assert [s.name for s in rx.plan.stages] == ["hb11", "hb11", "hb15",
                                                "hb19", "hb31"]
    assert rx.plan.factor == 32 and rx.demod_rate == 64000 and rx.blk == 1024
    assert rx.front.h.numel() - 1 == 710 and rx.front.d_rows == 712
    assert rx.zoom_bins == 1024
    assert (rx.rs_plan.n_in, rx.rs_plan.n_out, rx.rs_plan.taps) == (1024, 768, 32)
    assert (rx.agc_cfg.window, rx.agc_cfg.delay, rx.agc_cfg.stride) == (1152, 960, 16)
    assert len(rx.am_cfg.taps) == 127


def test_params_and_init_state_match_jax():
    """default_params / retune / init_state: same leaves as the JAX Receiver
    (use_pallas=True: the fused-front state layout)."""
    kw = dict(sample_rate=FS, frames_per_buffer=8192, channels=3, agc_stride=16)
    jrx = JaxReceiver(JaxConfig(use_pallas=True, **kw))
    trx = Receiver(ReceiverConfig(**kw), "cpu")
    tunes = np.array([250_000.0, 100_000.0, -3_000.5])
    jl = jax.tree_util.tree_leaves(jrx.retune(jrx.default_params(0.0), tunes))
    tl = convert.leaves(trx.retune(trx.default_params(0.0), tunes))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a), b.numpy())
    js = jax.tree_util.tree_leaves(jrx.init_state())
    ts = convert.state_to_numpy(trx.init_state())
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("mode", list(jmodes.DemodMode), ids=lambda m: m.name)
def test_mode_table_identical(mode):
    """The port's copy of the mode table (demod/modes.py) == the JAX one."""
    tmode = tmodes.DemodMode[mode.name]
    assert tmode.value == mode.value
    a, b = jmodes.MODE_INFO[mode], tmodes.MODE_INFO[tmode]
    assert dataclasses.astuple(a)[1:] == dataclasses.astuple(b)[1:]
    assert b.mode is tmode
    assert tmodes.from_string(mode.value) is tmode
    assert tmodes.is_wfm(tmode) == jmodes.is_wfm(mode)
    assert len(tmodes.DemodMode) == len(jmodes.DemodMode)


def test_comp_taps_identical():
    """The hq composite decimator: 31-tap remez design at 512 kHz, unit
    DC gain (pebblesdr_tpu/demod/wfm.py:116-130)."""
    a = jwfm.WFMConfig.make(256_000.0, comp_decim=2)
    b = twfm.WFMConfig.make(256_000.0, comp_decim=2)
    assert np.array_equal(np.asarray(a.comp_taps), b.comp_taps)
    assert len(b.comp_taps) == 31 and (b.comp_decim, a.comp_decim) == (2, 2)
    assert jwfm.WFMConfig.make(256_000.0).comp_taps is None
    assert twfm.WFMConfig.make(256_000.0).comp_taps is None


@pytest.mark.parametrize("rate,block", [(256_000.0, 4096), (256_000.0, 8192)])
def test_rds_config_identical(rate, block):
    """RdsConfig.make: the decimator plan to 16 kHz and its composed
    response, the premix tap pair, the matched filter, the 16 -> 19 kHz
    resampler's dense operator, the chunk and twiddle advance, the carrier
    configurations."""
    a = jrds.RdsConfig.make(rate, block)
    b = trds.RdsConfig.make(rate, block)
    assert [s.name for s in a.plan.stages] == [s.name for s in b.plan.stages]
    assert (a.plan.factor, a.plan.rate_out) == (b.plan.factor, b.plan.rate_out)
    for key in ("h_composed", "h_mix_re", "h_mix_im", "mf_taps"):
        x, y = np.asarray(getattr(a, key)), getattr(b, key)
        assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert (a.rs_plan.n_in, a.rs_plan.n_out, a.rs_plan.taps) == (
        b.rs_plan.n_in, b.rs_plan.n_out, b.rs_plan.taps)
    assert np.array_equal(a.rs_plan.dense, b.rs_plan.dense)
    assert (a.n_sym, a.chunk19, a.mix_adv16, a.alg, a.premix, a.composed) == (
        b.n_sym, b.chunk19, b.mix_adv16, b.alg, b.premix, b.composed)
    assert dataclasses.asdict(a.costas_open) == dataclasses.asdict(
        b.costas_open)
    assert dataclasses.asdict(a.pll) == dataclasses.asdict(b.pll)


@pytest.mark.parametrize("kw", [dict(), dict(square=False),
                                dict(range_hz=2000.0, chunk=128),
                                dict(sample_rate=48000.0, bw_hz=10.0)])
def test_costas_open_config_identical(kw):
    kw = {"sample_rate": 19000.0, **kw}
    assert dataclasses.asdict(jpll.make_costas_open_config(**kw)) == \
        dataclasses.asdict(tpll.make_costas_open_config(**kw))


def test_rds_burst_table_and_offsets_identical():
    assert jrds._BURST_TABLE == trds._BURST_TABLE
    assert jrds._OFFSETS == trds._OFFSETS and jrds._G == trds._G
    assert jrds._PTY_NAMES_RBDS == trds._PTY_NAMES_RBDS
    rng = np.random.default_rng(0)
    for block in rng.integers(0, 1 << 26, 200):
        assert jrds._syndrome(int(block)) == trds._syndrome(int(block))
        for use_fec in (False, True):
            assert jrds.check_block(int(block), jrds._OFFSETS["B"], use_fec) \
                == trds.check_block(int(block), trds._OFFSETS["B"], use_fec)


@pytest.mark.parametrize("ntaps,center,bw,rate", [(61, 3000.0, 6000.0, 64000.0),
                                                  (61, 2500.0, 5000.0, 32000.0),
                                                  (31, 19000.0, 4000.0,
                                                   256000.0)])
def test_hilbert_taps_identical(ntaps, center, bw, rate):
    assert np.array_equal(jfir.design_hilbert(ntaps, center, bw, rate),
                          tfir.design_hilbert(ntaps, center, bw, rate))


@pytest.mark.parametrize("astop,fpass,fstop,rate", [(40.0, 4500.0, 5500.0,
                                                     64000.0),
                                                    (60.0, 4500.0, 5500.0,
                                                     32000.0),
                                                    (20.0, 1000.0, 3000.0,
                                                     48000.0)])
def test_cfir_kaiser_and_rail_pair_identical(astop, fpass, fstop, rate):
    h = jfir.design_cfir_kaiser_lp(astop, fpass, fstop, rate)
    assert np.array_equal(h, tfir.design_cfir_kaiser_lp(astop, fpass, fstop,
                                                        rate))
    for a, b in zip(jfir.design_rail_pair(h, 5000.0, rate),
                    tfir.design_rail_pair(h, 5000.0, rate)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("sideband", ["analytic", "rails"])
@pytest.mark.parametrize("rate,bw", [(64000.0, 12000.0), (32000.0, 10000.0)])
def test_sam_config_identical(rate, bw, sideband):
    """SAMConfig.make: the PLL and open-track configurations, the Hilbert
    taps and the rail pair; sam_init's leaves (in the JAX flatten order)."""
    a = jsam.SAMConfig.make(rate, bw, sideband=sideband)
    b = tsam.SAMConfig.make(rate, bw, sideband=sideband)
    assert dataclasses.asdict(a.pll) == dataclasses.asdict(b.pll)
    assert dataclasses.asdict(a.open_track) == dataclasses.asdict(
        b.open_track)
    for key in ("hilbert_taps", "rail_taps_i", "rail_taps_q"):
        x, y = np.asarray(getattr(a, key)), getattr(b, key)
        assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert (a.algorithm, a.smooth, a.sideband) == (
        b.algorithm, b.smooth, b.sideband)
    js = jax.tree_util.tree_leaves(jsam.sam_init(a, 3))
    ts = convert.state_to_numpy(tsam.sam_init(b, 3, "cpu"))
    assert len(js) == len(ts)
    for x, y in zip(js, ts):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert np.array_equal(np.asarray(x), y)


@pytest.mark.parametrize("mode", ["SAM", "USB", "NONE"])
def test_narrowband_init_state_matches_jax(mode):
    """init_state of the narrowband modes (SAMState; None for the stateless
    demods) flattens to the JAX Receiver's leaves."""
    kw = dict(sample_rate=FS, frames_per_buffer=8192, channels=3,
              agc_stride=16)
    jrx = JaxReceiver(JaxConfig(use_pallas=True,
                                mode=jmodes.DemodMode[mode], **kw))
    trx = Receiver(ReceiverConfig(mode=tmodes.DemodMode[mode], **kw), "cpu")
    js = jax.tree_util.tree_leaves(jrx.init_state())
    ts = convert.state_to_numpy(trx.init_state())
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)


def test_ctcss_tones_and_anf_constants_identical():
    assert tgz.CTCSS_TONES == jgz.CTCSS_TONES and len(tgz.CTCSS_TONES) == 39
    assert (tscan.ANF_TAPS, tscan.ANF_DELAY, tscan.ANF_RATE,
            tscan.ANF_LEAK) == (jscan.ANF_TAPS, jscan.ANF_DELAY,
                                jscan.ANF_RATE, jscan.ANF_LEAK)


@pytest.mark.parametrize("rate", [64000.0, 48000.0])
def test_nfm_voice_taps_and_pll_config_identical(rate):
    a, b = jnfm.NFMConfig.make(rate), tnfm.NFMConfig.make(rate)
    assert np.array_equal(a.voice_taps, b.voice_taps)
    assert dataclasses.astuple(a.pll) == dataclasses.astuple(b.pll)
    assert (a.max_deviation, a.algorithm) == (b.max_deviation, b.algorithm)


@pytest.mark.parametrize("rate,comp_decim", [(256_000.0, 1), (256_000.0, 2),
                                             (128_000.0, 1)])
def test_mono_wfm_design_identical(rate, comp_decim):
    """Mono's wide-transition audio low-pass and the 75 kHz pre-
    discriminator biquad (at rate * comp_decim; none below 150 kHz)."""
    a = jwfm.WFMConfig.make(rate, stereo=False, comp_decim=comp_decim,
                            audio_decim=max(1, int(rate) // 64000))
    b = twfm.WFMConfig.make(rate, stereo=False, comp_decim=comp_decim,
                            audio_decim=max(1, int(rate) // 64000))
    assert np.array_equal(a.audio_taps, b.audio_taps)
    assert a.input_rate == b.input_rate
    if a.mono_pre_lp is None:
        assert b.mono_pre_lp is None and rate * comp_decim < 150_000
    else:
        assert dataclasses.astuple(a.mono_pre_lp) == dataclasses.astuple(
            b.mono_pre_lp)
    assert (a.comp_taps is None) == (b.comp_taps is None)


@pytest.mark.parametrize("kw", [
    dict(mode="FMN"), dict(mode="FMN", ctcss_tone=123.0), dict(mode="FMM"),
    dict(mode="FMM", wfm_hq=True), dict(mode="FMS", stereo=False),
    dict(mode="AM", enable_anf=True, agc_mode="long"),
    dict(mode="USB", agc_mode="long", agc_stride=1)],
    ids=["fmn", "fmn_ctcss", "fmm", "fmm_hq", "fms_mono", "am_anf_long",
         "usb_long_stride1"])
def test_new_configs_init_state_matches_jax(kw):
    """init_state of NFM (+ CTCSS), mono WFM, the ANF and AGC "long"
    flattens to the JAX Receiver's leaves, shape, dtype and value."""
    base = dict(sample_rate=FS, frames_per_buffer=8192, channels=3,
                agc_stride=16)
    mode = kw.pop("mode")
    base.update(kw)
    jrx = JaxReceiver(JaxConfig(use_pallas=True,
                                mode=jmodes.DemodMode[mode], **base))
    trx = Receiver(ReceiverConfig(mode=tmodes.DemodMode[mode], **base),
                   "cpu")
    js = jax.tree_util.tree_leaves(jrx.init_state())
    ts = convert.state_to_numpy(trx.init_state())
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)
    # and back: every leaf round-trips through utils/convert.py
    back = convert.state_to_numpy(convert.state_from_numpy(trx, ts))
    assert all(np.array_equal(a, b) for a, b in zip(ts, back))
