"""The port's sharded four-step FFT (pebblesdr_tpu_torch/parallel/
dist_fft.py) in one 8-rank gloo world on the CPU, a (1, 8) mesh, mirroring
tests/test_dist_fft.py: each rank's frequency rows joined in rank order
against numpy's dense FFT (2e-5 of scale), and at the first shape the JAX
package's fft_sharded on 8 forced CPU devices; each rank holds a
contiguous span of N2/8 rows; an indivisible block raises; the power
spectrum puts a tone in its bin (1.0 within 1e-3, sidelobes below 1e-6);
the windowed spectrum, each rank windowing its own rows, within 1e-7 of
the dense one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist as td
from pebblesdr_tpu.core import windows
from pebblesdr_tpu.parallel import dist_fft as jfft
from pebblesdr_tpu.parallel import mesh as jmesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return td.World("dist_fft", 8, tmp_path_factory.mktemp("dist_fft"))


@pytest.mark.parametrize("n1,n2", td.FFT_SHAPES)
def test_matches_dense_fft(world, n1, n2):
    x = td.cplx(n1 * n2, 0)
    res = world.results()
    got = td.by_time(res, f"fft_{n1}_{n2}", axis=0)
    assert got.shape == (n2, n1)
    ref = np.fft.fft(x)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got.reshape(-1) / scale, ref / scale,
                               atol=2e-5)
    if (n1, n2) == td.FFT_SHAPES[0]:      # and JAX's sharded FFT, once
        m = jmesh.make_mesh(channel=1, time=8)
        x2d = jax.device_put(jnp.asarray(x.reshape(n1, n2)),
                             NamedSharding(m, P("time", None)))
        jk = np.asarray(jfft.fft_sharded(x2d, m))
        np.testing.assert_allclose(got / scale, jk / scale, atol=2e-5)
    # each rank: a contiguous frequency span of N2/8 rows
    for r in res:
        assert r[f"fft_{n1}_{n2}"].shape == (n2 // 8, n1)


def test_indivisible_raises(world):
    for r in world.results():
        assert "not divisible" in str(r["indivisible"])


def test_tone_lands_in_right_bin(world):
    n1, n2, k0 = 64, 256, 3000
    p = td.by_time(world.results(), "tone", axis=0)
    assert p.shape == (n1 * n2,)
    assert np.argmax(p) == k0
    assert p[k0] == pytest.approx(1.0, rel=1e-3)
    assert np.max(np.delete(p, k0)) < 1e-6


def test_windowed_matches_dense(world):
    n1, n2 = 64, 128
    n = n1 * n2
    x = td.cplx(n, 5)
    w = windows.window(windows.WindowType.HANNING, n)
    ref = np.abs(np.fft.fft(x * w)) ** 2 / n ** 2
    np.testing.assert_allclose(td.by_time(world.results(), "windowed",
                                          axis=0), ref, atol=1e-7)
