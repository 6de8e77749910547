"""The JAX package's last helpers in the port, each against the original on
the CPU on the same seeded inputs: scanops.ewma and the per-sample noise
blanker (NB1 and NB2 over two calls, the state carried), mixer.mix_simple,
resampler.apply_gather, signalstrength.fd_estimate / td_estimate and the
constants spectrum.MIN_BINS / MAX_BINS and agc.MAX_AMPLITUDE.
(windows.enbw is in tests/test_torch_design.py with the other copies.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import agc as jagc
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import resampler as jrs
from pebblesdr_tpu.ops import scanops as jscan
from pebblesdr_tpu.ops import signalstrength as jss
from pebblesdr_tpu.ops import spectrum as jspec
from pebblesdr_tpu_torch.ops import agc as tagc
from pebblesdr_tpu_torch.ops import mixer as tmix
from pebblesdr_tpu_torch.ops import resampler as trs
from pebblesdr_tpu_torch.ops import scanops as tscan
from pebblesdr_tpu_torch.ops import signalstrength as tss
from pebblesdr_tpu_torch.ops import spectrum as tspec

NB_THRESHOLD = 3.3


def close(got, want, tol):
    """max |got - want| within tol of max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def complex_noise(c: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n))
            + 1j * rng.standard_normal((c, n))).astype(np.complex64)


# first_order_apply's forms: closed (n alpha < 10), chunked (512-sample
# chunks), the log-step scan (no chunk divides n)
@pytest.mark.parametrize("n,alpha", [(4096, 0.001), (16384, 0.001),
                                     (4096, 0.05), (2000, 0.05)])
def test_ewma_matches_jax(n, alpha):
    x = np.abs(complex_noise(3, n, 0))
    carry = np.array([0.0, 0.5, 2.0], np.float32)
    jl, jy = jscan.ewma(jnp.asarray(carry), jnp.asarray(x), alpha)
    tl, ty = tscan.ewma(torch.from_numpy(carry), torch.from_numpy(x), alpha)
    close(ty, jy, 3e-5)
    close(tl, jl, 3e-5)


def blanker_input(c: int, n: int, calls: int, seed: int) -> np.ndarray:
    """calls x [C, n] complex64: a 0.5 carrier with 1e-3 noise and 8+8j
    impulses (blank windows at block seams and near each other)."""
    t = np.arange(calls * n) / 64_000.0
    x = (0.5 * np.exp(2j * np.pi * 1500.0 * t)[None].repeat(c, 0)
         + 1e-3 * complex_noise(c, calls * n, seed))
    for k, row in enumerate([400, 1000, 1003, n - 2, n + 1, 2 * n - 3]):
        x[k % c, row % (calls * n)] += 8 + 8j
    return x.astype(np.complex64).reshape(c, calls, n).transpose(1, 0, 2)


def nb_margin(x: np.ndarray, avg0: np.ndarray, alpha: float) -> float:
    """The least |mag / (threshold avg) - 1| over the samples, in float64:
    the spike decisions are far from the threshold where it is large."""
    mag = np.abs(x.astype(np.complex128))
    avg = np.empty_like(mag)
    a = avg0.astype(np.float64)
    for i in range(mag.shape[1]):
        a = (1 - alpha) * a + alpha * mag[:, i]
        avg[:, i] = a
    ratio = mag / (NB_THRESHOLD * np.maximum(avg, 1e-9))
    return float(np.abs(ratio - 1).min())


@pytest.mark.parametrize("mode", ["blank", "average"])
@pytest.mark.parametrize("n,width", [(8192, 7), (16384, 6)])
def test_noise_blanker_matches_jax_over_two_calls(mode, n, width):
    """NB1 / NB2 per sample, two calls with the average carried; blank
    windows of odd and even width (the even one pads one more sample
    after the spike, as "SAME" does)."""
    alpha = 0.001
    blocks = blanker_input(3, n, 2, 4)
    js = jscan.noise_blanker_init(3)
    ts = tscan.noise_blanker_init(3, "cpu")
    avg = np.zeros(3)
    for x in blocks:
        assert nb_margin(x, avg, alpha) > 1e-4
        js, jy = jscan.noise_blanker(js, jnp.asarray(x), NB_THRESHOLD, width,
                                     alpha, mode)
        ts, ty = tscan.noise_blanker(ts, torch.from_numpy(x), NB_THRESHOLD,
                                     width, alpha, mode)
        assert ty.dtype == torch.complex64
        assert np.array_equal(np.asarray(jy) == 0, ty.numpy() == 0)
        close(ty, jy, 1e-5)
        close(ts.mag_avg, js.mag_avg, 1e-5)
        avg = np.asarray(js.mag_avg, np.float64)
        assert int((ty.numpy() != x).sum()) >= width


@pytest.mark.parametrize("freq", [250_000.7, -1_234.5,
                                  np.array([1e3, -3.3e5, 7.77e5])])
def test_mix_simple_matches_jax(freq):
    x = complex_noise(3, 4096, 5)
    js, ts = jmix.mixer_init(3), tmix.mixer_init(3, "cpu")
    for _ in range(2):
        js, jy = jmix.mix_simple(js, jnp.asarray(x), freq, 2_048_000)
        ts, ty = tmix.mix_simple(ts, torch.from_numpy(x), freq, 2_048_000)
        close(ty, jy, 1e-5)
        close(ts.phase, js.phase, 1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_apply_gather_matches_jax_and_the_dense_form(dtype):
    jp = jrs.plan(64_000, 48_000, 1024)
    tp = trs.plan(64_000, 48_000, 1024)
    assert np.array_equal(jp.gather_idx, tp.gather_idx)
    assert np.array_equal(jp.coefs, tp.coefs)
    x = complex_noise(2, 2048, 6)
    x = (x.real if dtype == np.float32 else x).astype(dtype)
    jst = jnp.zeros((2, jp.taps), dtype)
    tst = torch.zeros(2, tp.taps, dtype=torch.from_numpy(x).dtype)
    for blk in (x[:, :1024], x[:, 1024:]):
        jst, jy = jrs.apply_gather(jp, jst, jnp.asarray(blk))
        _, ty_dense = trs.apply(tp, tst, torch.from_numpy(blk))
        tst, ty = trs.apply_gather(tp, tst, torch.from_numpy(blk))
        close(ty, jy, 1e-6)
        close(ty, ty_dense.numpy(), 1e-6)
        close(tst, jst, 0.0)


@pytest.mark.parametrize("start,stop", [(900, 1100), (0, 40), (2000, 2048),
                                        (100, 101)])
def test_fd_estimate_matches_jax(start, stop):
    rng = np.random.default_rng(7)
    p = (rng.exponential(1e-6, (3, 2048))).astype(np.float32)
    p[:, 1000:1010] += 1e-2
    want = jss.fd_estimate(jnp.asarray(p), start, stop)
    got = tss.fd_estimate(torch.from_numpy(p), start, stop)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4)


def test_td_estimate_matches_jax():
    x = complex_noise(4, 4096, 8) * np.array([[1e-3], [1.0], [10.0], [0.1]],
                                             np.float32)
    want = jss.td_estimate(jnp.asarray(x))
    got = tss.td_estimate(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4)


def test_constants_match_jax():
    assert (tspec.MIN_BINS, tspec.MAX_BINS) == (jspec.MIN_BINS, jspec.MAX_BINS)
    assert tagc.MAX_AMPLITUDE == jagc.MAX_AMPLITUDE
