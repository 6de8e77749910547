"""The AGC hang mode ("long") and the ANF of the PyTorch port against the
JAX package on the CPU.

  * agc_apply in mode "long" at stride 1 and 16 (64 kHz, C = 3) over three
    streaming calls of 1.02 s (the 2 s hold, then the fast release), with
    hang_tail carried, against pebblesdr_tpu/ops/agc.py's parallel path;
  * anf (block LMS) on real and complex input, updating every 16 samples
    and once per 256-sample block, over two streaming calls;
  * the AM Receiver with the ANF and AGC "long", and the USB Receiver with
    AGC "long", through the harness of torch_parity.py (one step() warm-up,
    the state carried across, dispatches of K = 3 and 9 blocks of 8192
    frames).

Bounds: AGC output 1e-5 of its scale and state 1e-4 (log10 units); the ANF
1e-5 absolute (tests/test_chain_batched.py:274); the Receivers those of
tests/test_torch_receiver.py:77-115.  The Receivers' first block is
compared for spectra, S-meter and squelch only: the JAX package's
per-block step() updates the ANF every 16 samples where its batched
step_many (and the port) update once per block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.ops import agc as jagc
from pebblesdr_tpu.ops import scanops as jscan
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import agc, scanops
from pebblesdr_tpu_torch.utils import convert

RATE, C = 64_000.0, 3
KS = (3, 9)


def bursts(n: int, seed: int, n0: int = 0) -> np.ndarray:
    """[C, n] complex64 from sample n0: a 1.5 kHz tone whose level steps
    0.5 -> 0.02 -> 0.2 at 0.3 s and 1.5 s (channel i 0.2 s later), with
    noise at 1e-3."""
    t = (n0 + np.arange(n)) / RATE
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(C):
        ti = t - 0.2 * i
        lvl = np.where(ti < 0.3, 0.5, np.where(ti < 1.5, 0.02, 0.2))
        rows.append(lvl * np.exp(2j * np.pi * 1500.0 * t + 1j * i))
    x = np.stack(rows)
    x = x + 1e-3 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


@pytest.mark.parametrize("stride", [1, 16])
def test_agc_long_matches_jax_streaming(stride):
    jc = jagc.AGCConfig.make(RATE, "long", stride=stride)
    tc = agc.AGCConfig.make(RATE, "long", stride=stride)
    assert agc.hang_window(tc) == jagc.hang_window(jc) == 128_000 // stride
    js, ts = jagc.agc_init(jc, C), agc.agc_init(tc, C, "cpu")
    assert ts.hang_tail.shape == (C, 128_000 // stride - 1)
    n = 65_536
    for call in range(3):
        x = bursts(n, call, n0=call * n)
        js, jy = jagc.agc_apply(jc, js, jnp.asarray(x))
        ts, ty = agc.agc_apply(tc, ts, torch.from_numpy(x))
        jy = np.asarray(jy)
        assert ty.dtype == torch.complex64 and ty.shape == jy.shape
        assert np.abs(jy - ty.numpy()).max() < 1e-5 * np.abs(jy).max()
        jl = jax.tree_util.tree_leaves(js)
        tl = convert.state_to_numpy(ts)
        assert len(jl) == len(tl) == 7
        for a, b in zip(jl, tl):
            a = np.asarray(a)
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.abs(a.astype(np.complex128)
                          - b.astype(np.complex128)).max() < 1e-4


def test_agc_long_holds_then_releases():
    """The hang: after the 0.5 -> 0.02 step the gain stays put for the
    2 s hold, then rises within the fast release."""
    tc = agc.AGCConfig.make(RATE, "long", stride=16)
    st, n = agc.agc_init(tc, 1, "cpu"), 16_384
    gains = []
    for call in range(12):
        t = (call * n + np.arange(n)) / RATE
        x = torch.from_numpy(np.where(t < 0.3, 0.5, 0.02).astype(
            np.complex64)[None])
        st, y = agc.agc_apply(tc, st, x)
        gains.append((y.abs() / x.abs()).numpy()[0])
    g = np.concatenate(gains)
    t = np.arange(len(g)) / RATE
    held = g[(t > 0.6) & (t < 2.2)]
    assert held.max() / held.min() < 1.01
    assert np.allclose(held, 0.7 / 0.5, rtol=1e-3)   # the 0.5 peak's gain
    # released: 0.02 lies below the knee, so the gain is the most it gets,
    # AGC_OUTSCALE x 10^(-threshold_db / 20)
    assert np.allclose(g[t > 2.9], 0.7 * 10.0, rtol=1e-3)


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


@pytest.mark.parametrize("every", [16, 256])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_anf_matches_jax_streaming(cplx, every):
    dt = jnp.complex64 if cplx else jnp.float32
    js = jscan.anf_init(C, dtype=dt)
    ts = scanops.anf_init(C, "cpu",
                          dtype=torch.complex64 if cplx else torch.float32)
    assert (scanops.ANF_TAPS, scanops.ANF_DELAY) == (jscan.ANF_TAPS,
                                                     jscan.ANF_DELAY)
    for call in range(2):
        x = anf_input(2048, call, cplx)
        js, jy = jscan.anf(js, jnp.asarray(x), update_every=every)
        ts, ty = scanops.anf(ts, torch.from_numpy(x), update_every=every)
        jy = np.asarray(jy)
        assert ty.shape == jy.shape and ty.numpy().dtype == jy.dtype
        assert np.abs(jy - ty.numpy()).max() < 1e-5
        for a, b in zip((js.weights, js.delay), (ts.weights, ts.delay)):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype
            assert np.abs(a - b.numpy()).max() < 1e-5
    assert float(ts.weights.abs().max()) > 1e-3     # it adapted


@pytest.fixture(scope="module")
def am_runs():
    return tp.run(DemodMode.AM, lambda k, s: tp.tone_plane(k, s, 0.0, am=True),
                  KS, jit=True, enable_anf=True, agc_mode="long")


@pytest.fixture(scope="module")
def usb_runs():
    return tp.run(DemodMode.USB, lambda k, s: tp.tone_plane(k, s, 1500.0),
                  KS, jit=True, agc_mode="long")


@pytest.mark.parametrize("run", ["step", *KS])
@pytest.mark.parametrize("which", ["am_anf_long", "usb_long"])
def test_receiver_outputs(am_runs, usb_runs, which, run):
    res = am_runs if which == "am_anf_long" else usb_runs
    jo, to, _, _ = res[run]
    if run != "step" or which == "usb_long":
        tp.check_audio(jo, to)
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    if run == 9:
        assert float(to["audio"].abs().max()) > 0.3


@pytest.mark.parametrize("run", KS)
@pytest.mark.parametrize("which", ["am_anf_long", "usb_long"])
def test_receiver_state(am_runs, usb_runs, which, run):
    res = am_runs if which == "am_anf_long" else usb_runs
    _, _, js, ts = res[run]
    tp.check_state(js, ts)
