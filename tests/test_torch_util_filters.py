"""The port's DSP utilities (pebblesdr_tpu_torch/ops/util_filters.py) against
the JAX package's (pebblesdr_tpu/ops/util_filters.py) on the CPU, inputs
from a numpy seed: a-law both ways, median_filter and delay_line exact;
moving_avg and moving_variance within 1e-6 of scale of a float64 reference,
and within 1e-6 of scale of the JAX package beyond the JAX package's own
distance from that reference (its cumsum difference cancels: up to 7e-6 of
scale for a mean, 3.5e-5 for a std, where the port's one convolution stays
within 7e-7); butterworth_apply within 1e-5 of scale (a narrow bandpass,
ill-conditioned in float32, held to a float64 sosfilt instead).  Then the
cases of tests/test_util_filters.py on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu.ops import util_filters as juf
from pebblesdr_tpu_torch.ops import iir
from pebblesdr_tpu_torch.ops import util_filters as uf


def signal(c: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(c, n)).astype(np.float32)


def scale_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ---- parity with the JAX package -------------------------------------------

def f64_moving(x: np.ndarray, window: int, tail: np.ndarray | None = None):
    """The trailing-window mean, variance and std in float64 (variance as
    the mean square less the squared mean, clipped at 0)."""
    if tail is None:
        tail = np.zeros((x.shape[0], window - 1))
    ext = np.concatenate([tail, x], axis=-1).astype(np.float64)
    fr = np.lib.stride_tricks.sliding_window_view(ext, window, axis=-1)
    m = fr.mean(-1)
    v = np.maximum((fr * fr).mean(-1) - m * m, 0.0)
    return m, v, np.sqrt(v)


def assert_near_jax(got, jax_out, ref) -> None:
    """Within 1e-6 of scale of the float64 reference, and of the JAX
    package's output beyond that output's own distance from it."""
    sc = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-6 * sc
    jax_err = np.abs(np.asarray(jax_out) - ref).max()
    assert np.abs(got - np.asarray(jax_out)).max() <= jax_err + 1e-6 * sc


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 4096, 40001])
def test_moving_avg_matches_float64(n):
    x = signal(3, n, n)
    for window in (2, 64):
        y, _ = uf.moving_avg(torch.from_numpy(x), window)
        ref = f64_moving(x, window)[0]
        assert np.abs(y.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("window", [2, 8, 100, 257])
def test_moving_avg_matches_jax(window):
    x = signal(3, 4000, 0)
    tail = signal(3, window - 1, 1)
    y, t = uf.moving_avg(torch.from_numpy(x), window, torch.from_numpy(tail))
    jy, jt = juf.moving_avg(jnp.asarray(x), window, jnp.asarray(tail))
    assert_near_jax(y.numpy(), jy, f64_moving(x, window, tail)[0])
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_weighted_moving_avg_matches_jax():
    x = signal(2, 1000, 2)
    w = np.array([1.0, 2.0, 3.0, 4.0, 0.5], np.float32)
    y, _ = uf.moving_avg(torch.from_numpy(x), 5, weights=torch.from_numpy(w))
    jy, _ = juf.moving_avg(jnp.asarray(x), 5, weights=jnp.asarray(w))
    assert scale_err(y.numpy(), jy) <= 1e-6


@pytest.mark.parametrize("window", [8, 100])
def test_moving_variance_matches_jax(window):
    x = signal(3, 4000, 3)
    for got, want, ref in zip(uf.moving_variance(torch.from_numpy(x), window),
                              juf.moving_variance(jnp.asarray(x), window),
                              f64_moving(x, window)):
        assert_near_jax(got.numpy(), want, ref)


@pytest.mark.parametrize("window", [3, 5, 6, 9])
def test_median_filter_equals_jax(window):
    x = signal(3, 300, 4)
    np.testing.assert_array_equal(
        uf.median_filter(torch.from_numpy(x), window).numpy(),
        np.asarray(juf.median_filter(jnp.asarray(x), window)))


def test_delay_line_equals_jax():
    x = signal(2, 100, 5)
    y, t = uf.delay_line(torch.from_numpy(x[:, :60]), 7)
    jy, jt = juf.delay_line(jnp.asarray(x[:, :60]), 7)
    y2, t2 = uf.delay_line(torch.from_numpy(x[:, 60:]), 7, t)
    jy2, jt2 = juf.delay_line(jnp.asarray(x[:, 60:]), 7, jt)
    for got, want in ((y, jy), (t, jt), (y2, jy2), (t2, jt2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,cut", [("lowpass", 1000.0),
                                      ("highpass", 3000.0),
                                      ("bandpass", (2000.0, 8000.0))])
def test_butterworth_matches_jax(kind, cut):
    coefs = uf.design_butterworth(4, cut, 48000.0, kind)
    jcoefs = juf.design_butterworth(4, cut, 48000.0, kind)
    assert [tuple(vars(c).values()) for c in coefs] == \
        [tuple(vars(c).values()) for c in jcoefs]
    x = signal(2, 2048, 6)
    states, y = uf.butterworth_apply(
        [iir.biquad_state_init(2, "cpu") for _ in coefs],
        torch.from_numpy(x), coefs)
    jstates, jy = juf.butterworth_apply(
        [jiir.biquad_state_init(2) for _ in jcoefs], jnp.asarray(x), jcoefs)
    assert scale_err(y.numpy(), jy) <= 1e-5
    for s, js in zip(states, jstates):
        assert scale_err(s.numpy(), js) <= 1e-5


def test_narrow_butterworth_bandpass_holds_float64():
    """An order-4 800-2400 Hz bandpass at 48 kHz is ill-conditioned in
    float32: the JAX package's cascade lies 2.3e-5 of scale from a float64
    sosfilt and the port's 4.4e-7, so the port is held to float64 here
    (within 1e-5 of scale) rather than to the JAX package."""
    cut = (800.0, 2400.0)
    coefs = uf.design_butterworth(4, cut, 48000.0, "bandpass")
    x = signal(2, 2048, 6)
    _, y = uf.butterworth_apply(
        [iir.biquad_state_init(2, "cpu") for _ in coefs],
        torch.from_numpy(x), coefs)
    sos = scipy.signal.butter(4, cut, btype="bandpass", fs=48000.0,
                              output="sos")
    ref = scipy.signal.sosfilt(sos, x.astype(np.float64), axis=1)
    assert scale_err(y.numpy(), ref) <= 1e-5


def test_alaw_equals_jax():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-1.1, 1.1, 4000),
                        np.linspace(-1, 1, 513)]).astype(np.float32)
    enc = uf.alaw_compress(x)
    np.testing.assert_array_equal(enc, juf.alaw_compress(x))
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(uf.alaw_expand(every),
                                  juf.alaw_expand(every))
    np.testing.assert_array_equal(uf.alaw_expand(enc), juf.alaw_expand(enc))


# ---- tests/test_util_filters.py on the port --------------------------------

def test_uniform_matches_numpy():
    x = signal(1, 200, 0)
    y, _ = uf.moving_avg(torch.from_numpy(x), 8)
    ext = np.concatenate([np.zeros((1, 7), np.float32), x], axis=1)
    ref = np.stack([np.convolve(ext[0], np.ones(8) / 8, mode="valid")])
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5)


def test_weighted():
    y, _ = uf.moving_avg(torch.ones(1, 16), 3,
                         weights=torch.tensor([1.0, 2.0, 3.0]))
    assert float(y[0, -1]) == pytest.approx(1.0, abs=1e-6)


def test_variance():
    x = np.random.default_rng(1).normal(size=(1, 500)).astype(np.float32)
    m, var, std = uf.moving_variance(torch.from_numpy(x), 100)
    assert float(var[0, -1]) == pytest.approx(np.var(x[0, -100:]), rel=0.05)


def test_impulse_rejected():
    x = torch.zeros(1, 64)
    x[0, 30] = 10.0
    assert float(uf.median_filter(x, 5).abs().max()) == 0.0


def test_preserves_step():
    x = torch.cat([torch.zeros(32), torch.ones(32)])[None]
    y = uf.median_filter(x, 5)[0]
    assert float(y[10]) == 0.0 and float(y[50]) == 1.0


def test_delay():
    x = torch.arange(16, dtype=torch.float32)[None]
    y, tail = uf.delay_line(x, 4)
    np.testing.assert_array_equal(y[0, 4:].numpy(), np.arange(12))
    np.testing.assert_array_equal(y[0, :4].numpy(), 0)
    y2, _ = uf.delay_line(x + 16, 4, tail)
    np.testing.assert_array_equal(y2[0, :4].numpy(), [12, 13, 14, 15])


def test_butterworth_matches_scipy():
    coefs = uf.design_butterworth(4, 1000.0, 48000.0)
    x = signal(1, 2048, 2)
    states = [iir.biquad_state_init(1, "cpu") for _ in coefs]
    _, y = uf.butterworth_apply(states, torch.from_numpy(x), coefs)
    sos = scipy.signal.butter(4, 1000.0, fs=48000.0, output="sos")
    ref = scipy.signal.sosfilt(sos, x, axis=1)
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-3)


def test_alaw_roundtrip_snr():
    t = np.linspace(0, 1, 8000, endpoint=False)
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    err = uf.alaw_expand(uf.alaw_compress(x)) - x
    assert 10 * np.log10(np.mean(x ** 2) / np.mean(err ** 2)) > 30


def test_alaw_silence():
    z = uf.alaw_expand(uf.alaw_compress(np.zeros(10, np.float32)))
    assert np.abs(z).max() < 1e-3


def test_sample_clock():
    clk = uf.SampleClock(48000.0)
    clk.tick(48000)
    assert clk.seconds == pytest.approx(1.0)
    mark = clk.count
    clk.tick(24000)
    assert clk.duration(mark) == pytest.approx(0.5)
