"""The staged front's ops of the PyTorch port against the JAX package on the
CPU: the halfband stage's conv form (ops/fir.py, against the JAX package's
conv and its even/odd polyphase stage), the halfband cascade
(ops/decimator.py), the static and adaptive IQ balance and the
chunked noise blanker (ops/scanops.py), the DC blocker's per-sample form
on blocks that are not a multiple of its chunk (ops/iir.py) and the
per-block mix (ops/mixer.py).

The same seeded numpy input goes through both; stateful ops run several
consecutive calls so the carried state is exercised.  Bounds: relative max
error |a - b| / max|a| <= 1e-5 (float32 work in another operation order)
unless stated; the adaptive IQ balance's plain version (moment form:
group sums, then the chain) against JAX's direct form within 1e-5 of the
output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import fir as jfir
from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import scanops as jscan
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import fir as tfir
from pebblesdr_tpu_torch.ops import iir as tiir
from pebblesdr_tpu_torch.ops import mixer as tmix
from pebblesdr_tpu_torch.ops import scanops as tscan
from pebblesdr_tpu_torch.utils import roofline

RTOL = 1e-5
FS = 2_048_000


def cplx(rng, c, n, scale=1.0):
    return (scale * (rng.standard_normal((c, n))
                     + 1j * rng.standard_normal((c, n)))).astype(np.complex64)


def rel_err(a, b) -> float:
    a = np.asarray(a).astype(np.complex128)
    b = (b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
         ).astype(np.complex128)
    assert a.shape == b.shape
    return float(np.abs(a - b).max(initial=0.0)
                 / max(np.abs(a).max(initial=0.0), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x))


def imbalanced_tone(n: int, f0: float, t0: float = 0.0, fs: float = FS):
    """tests/test_chain.py:204-236's capture: a 0.5 tone at f0, I gain
    1.06, 0.08 of I leaked into Q."""
    tt = t0 + np.arange(n) / fs
    clean = 0.5 * np.exp(2j * np.pi * f0 * tt)
    return (clean.real * 1.06 + 1j * (clean.imag + 0.08 * clean.real)
            ).astype(np.complex64)


@pytest.mark.parametrize("stage", [0, 2, 4])
def test_fir_decimate2_polyphase_streaming(stage):
    """The AM plan's hb11 / hb15 / hb31 stages over two calls: the port's
    conv form (fir_apply, decim 2) against the JAX package's polyphase
    stage, y to float32 rounding, the tail equal."""
    taps = jdec.build_plan(FS, 30_000).stages[stage].taps.astype(np.float32)
    rng = np.random.default_rng(stage)
    c, n = 3, 4096
    jt = jnp.zeros((c, len(taps) - 1), jnp.complex64)
    tt = torch.zeros(c, len(taps) - 1, dtype=torch.complex64)
    for _ in range(2):
        x = cplx(rng, c, n)
        jy, jt = jfir.fir_decimate2_polyphase(jnp.asarray(x), taps, jt)
        ty, tt = tfir.fir_apply(t(x), taps, tt, 2)
        assert rel_err(jy, ty) < RTOL
        assert np.array_equal(np.asarray(jt), tt.numpy())


@pytest.mark.parametrize("decim", [1, 2, 4])
def test_fir_apply_streaming(decim):
    """The conv form (strided conv1d, IEEE float32) over two calls."""
    taps = np.hanning(23).astype(np.float32)
    taps /= taps.sum()
    rng = np.random.default_rng(decim)
    c, n = 3, 2048
    jt = jnp.asarray(cplx(rng, c, len(taps) - 1))
    tt = t(np.asarray(jt))
    for _ in range(2):
        x = cplx(rng, c, n)
        jy, jt = jfir.fir_apply(jnp.asarray(x), jnp.asarray(taps), jt, decim)
        ty, tt = tfir.fir_apply(t(x), taps, tt, decim)
        assert ty.shape == (c, n // decim)
        assert rel_err(jy, ty) < RTOL
        assert np.array_equal(np.asarray(jt), tt.numpy())


@pytest.mark.parametrize("allow", [True, False])
def test_fir_apply_leaves_the_tf32_setting(allow):
    """fir_apply keeps TF32 off only for its own convolution: the caller's
    cuDNN setting holds after it, and a one-tap filter passes x through
    exactly (the tail empty)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        x = t(cplx(np.random.default_rng(9), 2, 1024))
        y, tail = tfir.fir_apply(x, np.ones(1, np.float32),
                                 torch.zeros(2, 0, dtype=torch.complex64))
        assert torch.backends.cudnn.allow_tf32 == allow
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.equal(y, x) and tail.shape == (2, 0)


@pytest.mark.parametrize("protect,rate", [(30_000.0, FS),        # AM: 5 stages
                                          (100_000.0, FS),       # WFM: 3
                                          (4_800.0, 256_000.0)])  # RDS: 4
def test_decimator_apply_streaming(protect, rate):
    jp = jdec.build_plan(rate, protect)
    tp = tdec.build_plan(rate, protect)
    assert [s.name for s in jp.stages] == [s.name for s in tp.stages]
    rng = np.random.default_rng(int(protect))
    c, n = 3, 8192
    js, ts = jdec.state_init(jp, c), tdec.state_init(tp, c, "cpu")
    assert [tuple(a.shape) for a in js] == [tuple(b.shape) for b in ts]
    for _ in range(2):
        x = cplx(rng, c, n)
        js, jy = jdec.apply(jp, js, jnp.asarray(x))
        ts, ty = tdec.apply(tp, ts, t(x))
        assert ty.shape == (c, n // tp.factor)
        assert rel_err(jy, ty) < RTOL
        for a, b in zip(js, ts):
            assert rel_err(a, b) < RTOL


def test_iq_balance_static():
    rng = np.random.default_rng(3)
    x = cplx(rng, 4, 1024)
    jy = jscan.iq_balance(jnp.asarray(x), 1.05, 0.02)
    ty = tscan.iq_balance(t(x), torch.tensor(1.05), torch.tensor(0.02))
    assert rel_err(jy, ty) < RTOL


@pytest.mark.parametrize("mode", ["blank", "average"])
def test_noise_blanker_chunked_streaming(mode):
    """NB1 / NB2 over three calls on a noise floor with impulses at chunk
    seams and inside chunks: the same samples blanked, y and the carry
    within 1e-5."""
    rng = np.random.default_rng(11)
    c, n = 3, 4096
    js = jscan.noise_blanker_chunked_init(c)
    ts = tscan.noise_blanker_chunked_init(c, "cpu")
    blanked = 0
    for call in range(3):
        x = cplx(rng, c, n, 0.05)
        x[:, [511, 512, 1000 + call, 4095]] += 3.0 + 2.0j
        js, jy = jscan.noise_blanker_chunked(js, jnp.asarray(x), mode=mode)
        ts, ty = tscan.noise_blanker_chunked(ts, t(x), mode=mode)
        assert rel_err(jy, ty) < RTOL
        jb = np.asarray(jy) != x
        assert np.array_equal(jb, ty.numpy() != x)
        blanked += int(jb.sum())
        assert rel_err(js.mag_avg, ts.mag_avg) < RTOL
        assert np.array_equal(np.asarray(js.spike_tail), ts.spike_tail.numpy())
    assert blanked > 3 * c * 4 * 6      # each impulse blanks its window


def test_auto_iq_balance_streaming():
    """y and w over three calls of 4096 samples (64 groups each) from a
    zero weight, the plain version (CPU) against JAX's lax.scan."""
    c, n = 3, 4096
    js = jscan.auto_iq_balance_init(c)
    ts = tscan.auto_iq_balance_init(c, "cpu")
    rng = np.random.default_rng(4)
    for call in range(3):
        x = np.stack([imbalanced_tone(n, f, call * n / FS)
                      for f in (300e3, -120e3, 45e3)])
        x = (x + 0.01 * cplx(rng, c, n)).astype(np.complex64)
        js, jy = jscan.auto_iq_balance(js, jnp.asarray(x))
        ts, ty = tscan.auto_iq_balance(ts, t(x))
        assert tscan.auto_iq_balance.launches == 0      # CPU: never counts
        assert rel_err(jy, ty) < RTOL
        assert rel_err(js.w, ts.w) < RTOL
    assert float(ts.w.abs().min()) > 1e-3               # the weight moved


def test_iq_lms_scan_plain_is_the_group_loop():
    """The plain version step by step: group g's y uses the weight before
    its update, and the update is w - mu mean(y^2) of that group."""
    rng = np.random.default_rng(5)
    x = t(cplx(rng, 2, 256, 0.3))
    w0 = torch.tensor([0.01 + 0.02j, -0.03j], dtype=torch.complex64)
    y, w = tscan.iq_lms_scan_plain(x, w0)
    wg = w0.to(torch.complex128)
    for g in range(4):
        xb = x[:, 64 * g:64 * (g + 1)].to(torch.complex128)
        yb = xb + wg[:, None] * xb.conj()
        assert float((y[:, 64 * g:64 * (g + 1)] - yb).abs().max()) < 1e-6
        wg = wg - tscan.IQ_MU * (yb * yb).mean(dim=1)
    assert float((w - wg).abs().max()) < 1e-7


def test_auto_iq_balance_deepens_image_rejection():
    """tests/test_ops_scans.py:42-63 and tests/test_chain.py:204-236 at
    module level: 12 blocks of the imbalanced tone, the image rejection of
    each block's output deepens by >= 20 dB and ends above 60 dB."""
    n, f0 = 32768, 300_000.0
    st = tscan.auto_iq_balance_init(1, "cpu")
    freqs = np.fft.fftfreq(n, 1.0 / FS)
    rej = []
    for b in range(12):
        x = imbalanced_tone(n, f0, b * n / FS)[None]
        st, y = tscan.auto_iq_balance(st, t(x))
        spec = np.abs(np.fft.fft(y.numpy()[0]))
        rej.append(20 * np.log10(spec[np.argmin(np.abs(freqs - f0))]
                                 / max(spec[np.argmin(np.abs(freqs + f0))],
                                       1e-12)))
    assert rej[-1] > rej[0] + 20, rej
    assert rej[-1] > 60, rej


@pytest.mark.parametrize("n", [256, 3840])
def test_dc_removal_chunked_takes_the_per_sample_form(n):
    """A block that is not a multiple of the 512-sample chunk (the bank's
    256-sample channel blocks) takes the per-sample blocker, as in JAX."""
    rng = np.random.default_rng(n)
    c = 3
    jm = jnp.zeros(c, jnp.complex64)
    tm = torch.zeros(c, dtype=torch.complex64)
    for _ in range(3):
        x = cplx(rng, c, n) + 0.3
        jm, jy = jiir.dc_removal_chunked(jm, jnp.asarray(x), alpha=0.9999)
        tm, ty = tiir.dc_removal_chunked(tm, t(x), alpha=0.9999)
        assert rel_err(jy, ty) < RTOL
        assert rel_err(jm, tm) < RTOL
    _, ya = tiir.dc_removal_apply(torch.zeros(c, dtype=torch.complex64), t(x))
    _, yc = tiir.dc_removal_chunked(torch.zeros(c, dtype=torch.complex64),
                                    t(x))
    assert torch.equal(ya, yc)


@pytest.mark.parametrize("n,k", [(8192, 4), (32768, 17), (256, 32)])
def test_mix_blocks_is_k_calls_of_mix(n, k):
    """K blocks mixed in one pass against K calls of JAX's mix: each
    block's ramp starts at the phase the calls carry."""
    rng = np.random.default_rng(k)
    c = 4
    sp = [jmix.split_freq(f, FS) for f in (250e3, -3e3, 150_000.3, 7.0)]
    hi = np.array([s[0] for s in sp])
    lo = np.array([s[1] for s in sp])
    phase = np.array([0.1, 0.5, 0.9, 0.0], np.float32)
    js = jmix.MixerState(phase=jnp.asarray(phase))
    x = cplx(rng, c, k * n)
    ys = []
    for b in range(k):
        js, y = jmix.mix(js, jnp.asarray(x[:, b * n:(b + 1) * n]),
                         jnp.asarray(hi), jnp.asarray(lo))
        ys.append(np.asarray(y))
    ts, ty = tmix.mix_blocks(tmix.MixerState(phase=t(phase)), t(x), t(hi),
                             t(lo), n)
    assert rel_err(np.concatenate(ys, axis=1), ty) < RTOL
    d = np.asarray(js.phase, np.float64) - ts.phase.numpy()
    assert np.abs((d + 0.5) % 1.0 - 0.5).max() < 1e-5


def test_iq_lms_bound():
    """K5's bound: x read and y written once at 3.35 TB/s against the
    serial floor of N/64 chain steps."""
    b = roofline.iq_lms_bound(64, 1 << 20, 10.0)
    assert b["bytes"] == 2 * 64 * (1 << 20) * 8 + 2 * 64 * 8
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.3205) < 1e-3
    b = roofline.iq_lms_bound(64, 1 << 20, 40.0)
    assert b["bound_by"] == "operations"
    assert abs(b["serial_ms"] - 16384 * 40e-6) < 1e-9
