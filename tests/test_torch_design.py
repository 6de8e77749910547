"""Host-side design arrays of the PyTorch port == the JAX package's.

The port copies the numpy/scipy design code instead of importing it; these
tests hold every copied array to the original: identical (np.array_equal),
or within 1e-7 where a float64 -> float32 cast is involved.
"""

import jax
import numpy as np
import pytest

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.core import windows as jwin
from pebblesdr_tpu.demod import am as jam
from pebblesdr_tpu.ops import agc as jagc
from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import fastfir as jff
from pebblesdr_tpu.ops import fir as jfir
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as jpk
from pebblesdr_tpu.ops import resampler as jrs
from pebblesdr_tpu.ops import signalstrength as jss
from pebblesdr_tpu.ops import spectrum as jspec
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.core import windows as twin
from pebblesdr_tpu_torch.demod import am as tam
from pebblesdr_tpu_torch.ops import agc as tagc
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import fastfir as tff
from pebblesdr_tpu_torch.ops import fir as tfir
from pebblesdr_tpu_torch.ops import mixer as tmix
from pebblesdr_tpu_torch.ops import resampler as trs
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


@pytest.mark.parametrize("ntaps,wpass", jdec.HALFBAND_SPECS[1:])
def test_halfband_taps_identical(ntaps, wpass):
    assert np.array_equal(jfir.design_halfband(ntaps, wpass),
                          tfir.design_halfband(ntaps, wpass))


@pytest.mark.parametrize("fs,protect", [(FS, 30_000.0), (FS, 200_000.0),
                                        (1_024_000, 30_000.0),
                                        (2_500_000, 20_000.0)])
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
