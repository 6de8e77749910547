"""The ANF's block LMS (ops/scanops.py anf) of the PyTorch port against the
JAX package on the CPU, and the parts of its CUDA kernel K8 (csrc/recur.cu
anf_scan) that the CPU reaches.

  * anf_plain, K8's plain version, against pebblesdr_tpu/ops/scanops.py
    anf at update_every 1, 16 and 256 on real and complex input, over two
    calls carrying the state, within 1e-5 absolute
    (tests/test_torch_agc_anf.py holds the entry point the same way);
  * the wrapper's row layout: complex x runs as the 2C rows [re; im] with
    real weights, and a CPU tensor takes anf_plain (anf_scan refuses it);
  * utils/roofline.py anf_scan_bound's arithmetic.

The kernel itself runs only on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import scanops as jscan
from pebblesdr_tpu_torch.ops import scanops
from pebblesdr_tpu_torch.utils import roofline

RATE, C = 64_000.0, 3


def anf_input(n: int, seed: int, cplx: bool) -> np.ndarray:
    """[C, n]: two tones (800 and 2100 Hz at 64 kHz) in noise at 0.3."""
    t = np.arange(n) / RATE + seed
    rng = np.random.default_rng(seed)
    x = (0.5 * np.cos(2 * np.pi * 800.0 * t)[None]
         + 0.3 * np.cos(2 * np.pi * 2100.0 * t + np.arange(C)[:, None])
         + 0.3 * rng.standard_normal((C, n)))
    if cplx:
        x = x + 1j * (0.5 * np.sin(2 * np.pi * 800.0 * t)[None]
                      + 0.3 * rng.standard_normal((C, n)))
        return x.astype(np.complex64)
    return x.astype(np.float32)


@pytest.mark.parametrize("every,n", [(1, 512), (16, 2048), (256, 2048)])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_anf_plain_matches_jax_streaming(cplx, every, n):
    """Two calls carrying the state: the predictions, weights and history
    within 1e-5 of the JAX package's lax.scan."""
    dt = jnp.complex64 if cplx else jnp.float32
    js = jscan.anf_init(C, dtype=dt)
    ts = scanops.anf_init(C, "cpu",
                          dtype=torch.complex64 if cplx else torch.float32)
    for call in range(2):
        x = anf_input(n, call + 10 * every, cplx)
        js, jy = jscan.anf(js, jnp.asarray(x), update_every=every)
        ts, ty = scanops.anf(ts, torch.from_numpy(x), update_every=every)
        jy = np.asarray(jy)
        assert ty.shape == jy.shape and ty.numpy().dtype == jy.dtype
        assert np.abs(jy - ty.numpy()).max() < 1e-5
        for a, b in zip((js.weights, js.delay), (ts.weights, ts.delay)):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
            assert np.abs(a - b.numpy()).max() < 1e-5
    assert float(ts.weights.abs().max()) > 1e-3     # it adapted


def test_complex_runs_as_stacked_rows():
    """anf on complex64 [C, N] equals anf_plain on the real rows [re; im]
    (2C of them) with the state stacked the same way, bit for bit."""
    x = torch.from_numpy(anf_input(1024, 3, True))
    st = scanops.anf_init(C, "cpu", dtype=torch.complex64)
    st, _ = scanops.anf(st, x)                      # a state that adapted
    w = torch.cat([st.weights.real, st.weights.imag])
    h = torch.cat([st.delay.real, st.delay.imag])
    x2 = torch.from_numpy(anf_input(1024, 4, True))
    st2, y = scanops.anf(st, x2)
    y_r, w_r, h_r = scanops.anf_plain(torch.cat([x2.real, x2.imag]), w, h)
    assert y_r.shape == (2 * C, 1024) and w_r.shape == (2 * C, 45)
    assert torch.equal(y, torch.complex(y_r[:C], y_r[C:]))
    assert torch.equal(st2.weights, torch.complex(w_r[:C], w_r[C:]))
    assert torch.equal(st2.delay, torch.complex(h_r[:C], h_r[C:]))


def test_real_weights_tile_over_complex_rows():
    """A real state with complex input: both row halves start from the
    same weights and history (the JAX package's jnp.tile)."""
    x = torch.from_numpy(anf_input(256, 5, True))
    st = scanops.anf_init(C, "cpu")
    st = scanops.ANFState(weights=st.weights + 0.01, delay=st.delay + 0.1)
    st2, y = scanops.anf(st, x)
    y_r, w_r, h_r = scanops.anf_plain(torch.cat([x.real, x.imag]),
                                      st.weights.repeat(2, 1),
                                      st.delay.repeat(2, 1))
    assert torch.equal(y, torch.complex(y_r[:C], y_r[C:]))
    assert torch.equal(st2.weights, torch.complex(w_r[:C], w_r[C:]))


def test_history_shorter_than_the_history_length():
    """N < delay + taps - 1: the new history is the old one's tail then
    x, as the JAX package takes full[:, -H:]."""
    st = scanops.anf_init(2, "cpu")
    h0 = torch.arange(2 * 108, dtype=torch.float32).reshape(2, 108)
    x = torch.ones(2, 32)
    _, _, h = scanops.anf_plain(x, st.weights, h0)
    assert torch.equal(h, torch.cat([h0[:, 32:], x], dim=1))


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    before = scanops.anf_scan.launches
    st = scanops.anf_init(2, "cpu")
    scanops.anf(st, torch.zeros(2, 64))
    assert scanops.anf_scan.launches == before
    with pytest.raises(ValueError):
        scanops.anf_scan(torch.zeros(2, 64), st.weights, st.delay)


def test_anf_scan_bound_arithmetic():
    """[128, 32768] at U = 16: x and y once (2 x 16 MiB) and the state
    twice; 4 taps + 1 operations per sample and 3 taps per update; 2048
    updates at the probe's ns each."""
    b = roofline.anf_scan_bound(128, 32768, 16, 300.0)
    assert b["bytes"] == 2 * 128 * 32768 * 4 + 2 * 128 * (45 + 108) * 4
    assert b["ops"] == 128 * (32768 * 181 + 2048 * 135)
    assert b["serial_ms"] == pytest.approx(2048 * 300e-6)
    assert b["bound_ms"] == pytest.approx(0.6144)
    assert b["bound_by"] == "operations"
    # U = 1024: 32 updates; the operations over 67 TFLOP/s bound it
    b = roofline.anf_scan_bound(128, 32768, 1024, 300.0)
    t_o = 128 * (32768 * 181 + 32 * 135) / 67e12 * 1e3
    assert b["bound_ms"] == pytest.approx(max(t_o, b["bytes"] / 3.35e9,
                                              32 * 300e-6))
    # a slow chain on few samples: still its updates' serial floor
    assert roofline.anf_scan_bound(2, 64, 1, 100.0)["bound_ms"] == (
        pytest.approx(64 * 100e-6))


def test_no_samples_keeps_the_state():
    """N = 0: no update; the weights and the history pass through (the
    kernel takes N = 0 too)."""
    st = scanops.anf_init(2, "cpu")
    w = st.weights + 0.5
    y, w2, h2 = scanops.anf_plain(torch.zeros(2, 0), w, st.delay + 1.0)
    assert y.shape == (2, 0)
    assert torch.equal(w2, w) and torch.equal(h2, st.delay + 1.0)
