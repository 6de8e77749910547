"""The port's polyphase filterbank (ops/pfb.py) against the JAX package on
the CPU, mirroring tests/test_pfb.py: the plan (prototype, hop, rate), the
PFB identity against the direct mix + low-pass + decimate form, streaming
exactness over three calls, the channel mapping and adjacent-channel
rejection, the oversampled (os=2) form and its frame-pair rule, at M = 16,
128 and 256 (the JAX package's dense-DFT path below 129 channels, its FFT
path above; the port takes the FFT and the fixed phase at every M).

Bounds: against JAX 1e-5 of the output's scale (float32, another order of
the branch sum and the transform); against the direct form 2e-5 absolute
(3e-5 at M = 256), as tests/test_pfb.py; streaming 1e-6 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from pebblesdr_tpu.ops import pfb as jpfb
from pebblesdr_tpu_torch.ops import pfb as tpfb

FS = 1_024_000
MS = (16, 128, 256)


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _direct(x, p, m):
    """Channel m: e^{2 pi i m (M-1)/M} lowpass(x e^{-2 pi i m t/M}) at t =
    (k+1) hop - 1."""
    mm = p.n_chan
    t = np.arange(len(x))
    lp = sps.lfilter(p.h.astype(np.float64), [1.0],
                     x * np.exp(-2j * np.pi * m * t / mm))
    return lp[np.arange(p.hop - 1, len(x), p.hop)] * np.exp(
        2j * np.pi * m * (mm - 1) / mm)


def _apply(p, x, state=None):
    st = tpfb.init_state(p, 1, "cpu") if state is None else state
    st, y = tpfb.apply(p, st, torch.from_numpy(x[None, :]))
    return st, y.numpy()[0]


@pytest.mark.parametrize("os", [1, 2])
@pytest.mark.parametrize("m", MS)
def test_plan_matches_jax(m, os):
    jp, tp = jpfb.plan(FS, m, os=os), tpfb.plan(FS, m, os=os)
    assert np.array_equal(jp.h, tp.h)
    assert (jp.hop, jp.state_len, jp.fs_out, jp.taps_per_branch) == \
        (tp.hop, tp.state_len, tp.fs_out, tp.taps_per_branch)
    assert np.array_equal(jpfb.channel_freqs(jp), tpfb.channel_freqs(tp))
    assert tpfb.init_state(tp, 1, "cpu").shape == (1, tp.state_len)


@pytest.mark.parametrize("os", [1, 2])
@pytest.mark.parametrize("m", MS)
def test_apply_matches_jax_streaming(m, os):
    """Three calls of 16 frames of two rows each, state carried."""
    t = {16: 12, 128: 12, 256: 6}[m]
    jp = jpfb.plan(FS, m, taps_per_branch=t, os=os)
    tp = tpfb.plan(FS, m, taps_per_branch=t, os=os)
    js = jpfb.init_state(jp, 2)
    ts = tpfb.init_state(tp, 2, "cpu")
    for call in range(3):
        x = np.stack([_rand(16 * tp.hop, 10 * call + r) for r in range(2)])
        js, jy = jpfb.apply(jp, js, jnp.asarray(x))
        ts, ty = tpfb.apply(tp, ts, torch.from_numpy(x))
        jy = np.asarray(jy)
        assert ty.shape == jy.shape == (2, m, 16)
        assert np.abs(jy - ty.numpy()).max() < 1e-5 * np.abs(jy).max()
        assert np.array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("m", MS)
def test_all_channels_match_direct(m):
    t = {16: 8, 128: 8, 256: 6}[m]
    p = tpfb.plan(FS, m, taps_per_branch=t)
    n = m * 24
    x = _rand(n, m)
    _, y = _apply(p, x)
    assert y.shape == (m, n // m)
    for ch in sorted({0, 1, m // 3, m - 1}):
        np.testing.assert_allclose(y[ch], _direct(x.astype(np.complex128),
                                                  p, ch),
                                   atol=3e-5 if m > 128 else 2e-5)


@pytest.mark.parametrize("os", [1, 2])
@pytest.mark.parametrize("m", MS)
def test_streaming_exact(m, os):
    p = tpfb.plan(FS, m, os=os)
    n = 8 * m
    x = _rand(3 * n, m + os)
    st, chunks = None, []
    for b in range(3):
        st, y = _apply(p, x[b * n:(b + 1) * n], st)
        chunks.append(y)
    _, ref = _apply(p, x)
    np.testing.assert_allclose(np.concatenate(chunks, axis=-1), ref,
                               atol=1e-6)


@pytest.mark.parametrize("m", MS)
def test_tone_lands_in_its_channel(m):
    """A tone 0.1 channel off centre lands in its channel, at least 40 dB
    above every other (the Kaiser prototype's rejection)."""
    p = tpfb.plan(FS, m, taps_per_branch=12)
    freqs = tpfb.channel_freqs(p)
    n = 512 * m
    tt = np.arange(n) / FS
    for ch in (1, m // 2 + 3, m - 1):
        x = np.exp(2j * np.pi * (freqs[ch] + 0.1 * p.fs_out) * tt
                   ).astype(np.complex64)
        _, y = _apply(p, x)
        power = np.mean(np.abs(y) ** 2, axis=-1)
        assert np.argmax(power) == ch
        assert 10 * np.log10(power[ch] / np.max(np.delete(power, ch))) > 40


def test_channel_baseband_frequency():
    p = tpfb.plan(FS, 16)
    freqs = tpfb.channel_freqs(p)
    n = 16384
    tt = np.arange(n) / FS
    x = np.exp(2j * np.pi * (freqs[2] + 3000.0) * tt).astype(np.complex64)
    _, y = _apply(p, x)
    tail = y[2][y.shape[1] // 2:]
    spec = np.fft.fftshift(np.fft.fft(tail))
    fbin = np.fft.fftshift(np.fft.fftfreq(len(tail), 1.0 / p.fs_out))
    assert abs(fbin[np.argmax(np.abs(spec))] - 3000.0) < 2 * p.fs_out / len(
        tail)


@pytest.mark.parametrize("m", MS)
def test_os2_matches_direct(m):
    p = tpfb.plan(FS, m, taps_per_branch=8, os=2)
    assert p.hop == m // 2 and p.fs_out == FS / (m // 2)
    n = m * 16
    x = _rand(n, 2)
    _, y = _apply(p, x)
    assert y.shape == (m, n // p.hop)
    for ch in sorted({0, 1, m // 3, m - 1}):
        np.testing.assert_allclose(y[ch], _direct(x.astype(np.complex128),
                                                  p, ch), atol=2e-5)


def test_os2_edge_station_keeps_sidebands():
    """tests/test_pfb.py's edge station: only the oversampled prototype
    keeps both sidebands of a DSB station between channel centres."""
    m = 64
    n = m * 512
    tt = np.arange(n) / FS
    x = ((1.0 + 0.8 * np.cos(2 * np.pi * 5000.0 * tt))
         * np.exp(2j * np.pi * FS / m / 2.0 * tt)).astype(np.complex64)
    power = {}
    for os in (1, 2):
        p = tpfb.plan(FS, m, os=os)
        _, y = _apply(p, x)
        env = np.abs(y[0][m:])
        spec = np.abs(np.fft.rfft(env - env.mean()))
        fbin = np.fft.rfftfreq(len(env), 1.0 / p.fs_out)
        power[os] = spec[np.argmin(np.abs(fbin - 5000.0))] / len(env)
    assert power[2] > 0.35 and power[1] < 0.25 and power[2] > 2 * power[1]


def test_guards():
    p = tpfb.plan(FS, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tpfb.apply(p, tpfb.init_state(p, 1, "cpu"),
                   torch.zeros(1, 100, dtype=torch.complex64))
    p2 = tpfb.plan(FS, 16, os=2)
    with pytest.raises(ValueError, match="frame pairs"):
        tpfb.apply(p2, tpfb.init_state(p2, 1, "cpu"),
                   torch.zeros(1, 3 * p2.hop, dtype=torch.complex64))
    with pytest.raises(ValueError, match="os=3"):
        tpfb.plan(FS, 16, os=3)
