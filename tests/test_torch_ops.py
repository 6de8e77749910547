"""Ops of the PyTorch port against the JAX package on the CPU.

Each test feeds the same numpy input (np.random.default_rng) to the JAX
function and its port and bounds the relative max error |a - b| / max|a| at
1e-5 (float32 work in a different operation order), unless a tighter or
looser bound of the JAX test it mirrors is named.  Stateful ops run two
consecutive calls so the carried state is exercised too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.core import db as jdb
from pebblesdr_tpu.demod import am as jam
from pebblesdr_tpu.ops import agc as jagc
from pebblesdr_tpu.ops import fastfir as jff
from pebblesdr_tpu.ops import fir as jfir
from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import resampler as jrs
from pebblesdr_tpu.ops import signalstrength as jss
from pebblesdr_tpu.ops import spectrum as jspec
from pebblesdr_tpu_torch.core import db as tdb
from pebblesdr_tpu_torch.demod import am as tam
from pebblesdr_tpu_torch.ops import agc as tagc
from pebblesdr_tpu_torch.ops import fastfir as tff
from pebblesdr_tpu_torch.ops import fir as tfir
from pebblesdr_tpu_torch.ops import iir as tiir
from pebblesdr_tpu_torch.ops import mixer as tmix
from pebblesdr_tpu_torch.ops import resampler as trs
from pebblesdr_tpu_torch.ops import signalstrength as tss
from pebblesdr_tpu_torch.ops import spectrum as tspec
from pebblesdr_tpu_torch.utils import convert

RTOL = 1e-5


def rel_err(ref, got) -> float:
    ref = np.asarray(ref).astype(np.complex128)
    got = np.asarray(got).astype(np.complex128)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def cplx(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [4096, 1000])
def test_mix(n):
    rng = np.random.default_rng(0)
    c = 4
    splits = [jmix.split_freq(f, 2_048_000) for f in (250e3, -3e3, 1.5e5, 7.0)]
    hi = np.array([s[0] for s in splits])
    lo = np.array([s[1] for s in splits])
    js, ts = jmix.mixer_init(c), tmix.mixer_init(c, "cpu")
    for _ in range(2):
        x = cplx(rng, c, n)
        js, jy = jmix.mix(js, jnp.asarray(x), jnp.asarray(hi), jnp.asarray(lo))
        ts, ty = tmix.mix(ts, t(x), t(hi), t(lo))
        assert rel_err(jy, ty) < RTOL
        assert np.abs(np.asarray(js.phase) - ts.phase.numpy()).max() < 1e-6


@pytest.mark.parametrize("complex_input", [True, False])
def test_dc_removal_chunked(complex_input):
    rng = np.random.default_rng(1)
    c, n = 3, 8192
    y0 = np.zeros(c, np.complex64 if complex_input else np.float32)
    jm, tm = jnp.asarray(y0), t(y0)
    for _ in range(2):
        x = (cplx(rng, c, n) + 0.3 if complex_input
             else rng.standard_normal((c, n)).astype(np.float32) + 0.3)
        jm, jy = jiir.dc_removal_chunked(jm, jnp.asarray(x), alpha=0.9999)
        tm, ty = tiir.dc_removal_chunked(tm, t(x), alpha=0.9999)
        assert rel_err(jy, ty) < RTOL
        assert rel_err(jm, tm) < RTOL


@pytest.mark.parametrize("a,n", [(0.999, 512),    # closed form: n(1-a) < 10
                                 (0.9, 1024),     # chunked matmul
                                 (0.9, 144)])     # log-step scan
def test_first_order_apply_branches(a, n):
    rng = np.random.default_rng(2)
    c = 3
    jy0 = jnp.asarray(rng.standard_normal(c).astype(np.float32))
    ty0 = t(np.asarray(jy0))
    for _ in range(2):
        x = rng.standard_normal((c, n)).astype(np.float32)
        jy0, jy = jiir.first_order_apply(jy0, jnp.asarray(x), a, 1.0 - a)
        ty0, ty = tiir.first_order_apply(ty0, t(x), a, 1.0 - a)
        assert rel_err(jy, ty) < RTOL
        assert rel_err(jy0, ty0) < RTOL


@pytest.mark.parametrize("k", [3, 9])
def test_fastfir_apply_many(k):
    """K=3: 50% pairing; K=9: the seg_mult=8 long-segment branch."""
    rng = np.random.default_rng(3)
    c, b = 3, 256
    mask = jff.design_mask(-6000.0, 6000.0, 64000.0, b)
    jst, tst = jnp.zeros((c, b), jnp.complex64), tff.state_init(c, b, "cpu")
    for _ in range(2):
        x = cplx(rng, c, k * b)
        jst, jy = jff.apply_many(jst, jnp.asarray(x), jnp.asarray(mask), b)
        tst, ty = tff.apply_many(tst, t(x), t(mask), b)
        assert rel_err(jy, ty) < RTOL
        assert rel_err(jst, tst) == 0.0


def test_fastfir_apply():
    rng = np.random.default_rng(4)
    c, b = 2, 512
    mask = jff.design_mask(300.0, 3000.0, 64000.0, b)
    jst, tst = jnp.zeros((c, b), jnp.complex64), tff.state_init(c, b, "cpu")
    for _ in range(2):
        x = cplx(rng, c, b)
        jst, jy = jff.apply(jst, jnp.asarray(x), jnp.asarray(mask))
        tst, ty = tff.apply(tst, t(x), t(mask))
        assert rel_err(jy, ty) < RTOL


@pytest.mark.parametrize("stride", [16, 1])
@pytest.mark.parametrize("k", [3, 9])
def test_agc_parallel(stride, k):
    rng = np.random.default_rng(5)
    c, n = 3, 256 * k
    jcfg = jagc.AGCConfig.make(64000.0, "med", stride=stride)
    tcfg = tagc.AGCConfig.make(64000.0, "med", stride=stride)
    jst, tst = jagc.agc_init(jcfg, c), tagc.agc_init(tcfg, c, "cpu")
    for i in range(3):
        # a level step between calls exercises attack and release
        x = cplx(rng, c, n, scale=0.3 if i % 2 else 0.01)
        jst, jy = jagc.agc_apply(jcfg, jst, jnp.asarray(x))
        tst, ty = tagc.agc_apply(tcfg, tst, t(x))
        assert rel_err(jy, ty) < RTOL
        for a, b in zip(jax.tree_util.tree_leaves(jst), convert.leaves(tst)):
            assert rel_err(a, b) < RTOL


def test_agc_kernels():
    rng = np.random.default_rng(6)
    ext = rng.standard_normal((3, 300)).astype(np.float32)
    assert np.array_equal(np.asarray(jagc._windowed_max(jnp.asarray(ext), 72)),
                          tagc._windowed_max(t(ext), 72).numpy())
    p = rng.standard_normal((3, 200)).astype(np.float32)
    carry = rng.standard_normal(3).astype(np.float32)
    je, jenv = jagc._decaying_max(jnp.asarray(carry), jnp.asarray(p), 0.01)
    te, tenv = tagc._decaying_max(t(carry), t(p), 0.01)
    assert rel_err(jenv, tenv) < RTOL and rel_err(je, te) < RTOL


@pytest.mark.parametrize("k", [3, 9])
def test_am_demod(k):
    """K=3 (768 samples): whole-block banded LP; K=9: segmented LP."""
    rng = np.random.default_rng(7)
    c, n = 3, 256 * k
    jcfg = jam.AMConfig.make(64000.0, 12000.0)
    tcfg = tam.AMConfig.make(64000.0, 12000.0)
    jst, tst = jam.am_init(jcfg, c), tam.am_init(tcfg, c, "cpu")
    for _ in range(2):
        x = cplx(rng, c, n) + 0.5
        jst, jy = jam.am_demod(jcfg, jst, jnp.asarray(x))
        tst, ty = tam.am_demod(tcfg, tst, t(x))
        assert rel_err(jy, ty) < RTOL
        assert rel_err(jst.lp_tail, tst.lp_tail) < RTOL


@pytest.mark.parametrize("n", [768, 2304])
def test_fir_apply_real_signal(n):
    rng = np.random.default_rng(8)
    taps = jam.AMConfig.make(64000.0).taps
    c = 2
    jt = jnp.zeros((c, len(taps) - 1), jnp.float32)
    tt = torch.zeros(c, len(taps) - 1)
    for _ in range(2):
        x = rng.standard_normal((c, n)).astype(np.float32)
        jy, jt = jfir.fir_apply_real_signal(jnp.asarray(x), None, jt,
                                            taps_np=taps)
        ty, tt = tfir.fir_apply_real_signal(t(x), tt, taps)
        assert rel_err(jy, ty) < RTOL


@pytest.mark.parametrize("k", [1, 3, 9])
def test_resampler(k):
    rng = np.random.default_rng(9)
    c = 3
    jp, tp = jrs.plan(64000, 48000, 256), trs.plan(64000, 48000, 256)
    jst, tst = jrs.state_init(jp, c), trs.state_init(tp, c, "cpu")
    for _ in range(2):
        x = rng.standard_normal((c, 256 * k)).astype(np.float32)
        if k == 1:
            jst, jy = jrs.apply(jp, jst, jnp.asarray(x))
            tst, ty = trs.apply(tp, tst, t(x))
        else:
            jst, jy = jrs.apply_many(jp, jst, jnp.asarray(x))
            tst, ty = trs.apply_many(tp, tst, t(x))
        assert rel_err(jy, ty) < RTOL
        assert rel_err(jst, tst) == 0.0


@pytest.mark.parametrize("n", [256, 2048, 8192])
def test_shifted_power(n):
    """DFT-by-matmul (Karatsuba) up to 4096 bins, FFT above."""
    rng = np.random.default_rng(10)
    x = cplx(rng, 3, n)
    assert rel_err(jspec._shifted_power(jnp.asarray(x)),
                   tspec.shifted_power(t(x))) < RTOL


def test_averaged_spectrum_and_db():
    rng = np.random.default_rng(11)
    x = cplx(rng, 2, 1024, scale=0.7)
    w, cg = jspec.make_window(1024)
    jst = jspec.state_init(2, 1024)
    tst = tspec.state_init(2, 1024, "cpu")
    for _ in range(2):
        jst, jdb_, jov = jspec.averaged_spectrum(jst, jnp.asarray(x), jnp.asarray(w),
                                                 cg, smoothing=0.5, db_offset=1.5)
        tst, tdb_, tov = tspec.averaged_spectrum(tst, t(x), t(w), cg,
                                                 smoothing=0.5, db_offset=1.5)
        assert np.abs(np.asarray(jdb_) - tdb_.numpy()).max() < 1e-3
        assert np.array_equal(np.asarray(jov), tov.numpy())
    p = np.array([0.0, 1e-25, 1e-3, 2.0], np.float32)
    assert np.abs(np.asarray(jdb.power_to_db(jnp.asarray(p)))
                  - tdb.power_to_db(t(p)).numpy()).max() < 1e-5


def test_fd_estimate_masked():
    rng = np.random.default_rng(12)
    p = rng.exponential(size=(5, 256)).astype(np.float32) * 1e-4
    band, noise = jss.band_masks(-6000.0, 6000.0, 64000.0, 256)
    ja = jss.fd_estimate_masked(jnp.asarray(p), jnp.asarray(band),
                                jnp.asarray(noise))
    ta = tss.fd_estimate_masked(t(p), t(band), t(noise))
    assert set(ja) == set(ta)
    for key in ja:
        assert np.abs(np.asarray(ja[key]) - ta[key].numpy()).max() < 1e-4
