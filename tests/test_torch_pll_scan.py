"""The port's closed carrier loops against the JAX package, on the CPU (the
plain versions of the recurrence kernels of csrc/recur.cu).

  * pll_run, each detector (atan2, cross, costas, pilot), at C=3 over two
    streaming calls of 4096 samples: phases compared on the circle (the
    angle of e^{j(a - b)}: the wrap to [-pi, pi) may round across +-pi on
    different steps), freqs and the state;
  * pll_run_blockwise for the pilot and atan2 detectors at chunks 8 and 256
    (the chunk phasors an IEEE float32 product in both packages);
  * pll_run_aimed with its chunked-loop stage 2 (smooth_cfg None, SAM's
    smooth="loop") over logical blocks;
  * the lock tests of tests/test_ops_kernels.py:330-355 on the port;
  * the wrappers: the plain path counts no launch, unknown detectors and
    partial chunks raise, empty inputs pass through.

Bounds: phases 2e-5 rad (float32 rounding differences of sin/cos/atan2
between the packages, integrated over the loop; measured ~2e-6), fdev
1e-7 rad/sample, freqs (which add the centre) 3e-7 (two float32 ulps at a
19 kHz centre), amp 1e-6; the blockwise phases carry the unwrapped centre
ramp (up to ~1e3 rad, a float32 ulp of 6e-5), so they are held to 2e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import pll as jpll
from pebblesdr_tpu_torch.ops import pll as tpll
from torch_parity import circ

C, N = 3, 4096


def carrier(det: str, fs: float, f0: float, call: int, seed: int,
            n: int = N) -> np.ndarray:
    """[C, n] complex64: a carrier at f0 (pilot: a real sine; costas: BPSK
    at 16 samples per symbol), channel i at phase i, plus noise."""
    rng = np.random.default_rng(seed)
    t = (call * n + np.arange(n)) / fs
    ph = 2 * np.pi * f0 * t + np.arange(C)[:, None]
    if det == "pilot":
        x = 0.1 * np.sin(ph) + 0.01 * rng.standard_normal((C, n))
    else:
        data = (np.sign(rng.standard_normal((C, n // 16))).repeat(16, 1)
                if det == "costas" else 1.0)
        x = (0.5 * data * np.exp(1j * ph)
             + 0.02 * (rng.standard_normal((C, n))
                       + 1j * rng.standard_normal((C, n))))
    return x.astype(np.complex64)


def state_close(sj, st, phase_tol=2e-5):
    assert circ(sj.phase, st.phase) < phase_tol
    assert np.abs(np.asarray(sj.fdev) - st.fdev.numpy()).max() < 1e-7
    assert np.abs(np.asarray(sj.amp) - st.amp.numpy()).max() < 1e-6
    for f in dataclasses.fields(st):
        assert getattr(st, f.name).dtype == torch.float32


@pytest.mark.parametrize("det", tpll.DETECTORS)
def test_pll_run_matches_jax_streaming(det):
    fs = 64000.0
    kw = dict(center_hz=19000.0 if det == "pilot" else 300.0,
              range_hz=200.0, detector=det)
    cfg_j = jpll.make_pll_config(fs, 100.0, **kw)
    cfg_t = tpll.make_pll_config(fs, 100.0, **kw)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    sj, st = jpll.pll_init(cfg_j, C), tpll.pll_init(cfg_t, C, "cpu")
    f0 = 19010.0 if det == "pilot" else 340.0
    before = tpll.pll_scan.launches
    for call in range(2):
        x = carrier(det, fs, f0, call, 10 * call + len(det))
        sj, pj, fj = jpll.pll_run(cfg_j, sj, jnp.asarray(x))
        st, pt, ft = tpll.pll_run(cfg_t, st, torch.from_numpy(x))
        assert pt.shape == ft.shape == (C, N) and pt.dtype == torch.float32
        assert circ(pj, pt) < 2e-5
        assert np.abs(np.asarray(fj) - ft.numpy()).max() < 3e-7
        state_close(sj, st)
    assert tpll.pll_scan.launches == before      # the plain path on the CPU
    # locked: the loop frequency reads the 40 Hz (pilot 10 Hz) offset
    f_hat = float(ft[:, -512:].mean()) * fs / (2 * np.pi)
    assert f_hat == pytest.approx(f0, abs=3.0)


@pytest.mark.parametrize("det,chunk", [("pilot", 8), ("pilot", 256),
                                       ("atan2", 8), ("atan2", 256)])
def test_pll_run_blockwise_matches_jax(det, chunk):
    fs = 512000.0 if det == "pilot" else 32000.0
    kw = dict(center_hz=19000.0 if det == "pilot" else 300.0,
              range_hz=100.0, detector=det)
    cfg_j = jpll.make_pll_config(fs, 10.0, **kw)
    cfg_t = tpll.make_pll_config(fs, 10.0, **kw)
    sj, st = jpll.pll_init(cfg_j, C), tpll.pll_init(cfg_t, C, "cpu")
    f0 = 19005.0 if det == "pilot" else 310.0
    for call in range(2):
        x = carrier(det, fs, f0, call, 3 + call)
        sj, pj, fj = jpll.pll_run_blockwise(cfg_j, sj, jnp.asarray(x),
                                            chunk=chunk)
        st, pt, ft = tpll.pll_run_blockwise(cfg_t, st, torch.from_numpy(x),
                                            chunk=chunk)
        assert pt.shape == (C, N)
        assert circ(pj, pt) < 2e-4
        assert np.abs(np.asarray(fj) - ft.numpy()).max() < 3e-7
        state_close(sj, st)


def test_pll_run_aimed_chunked_loop_matches_jax():
    """SAM's loop (smooth="loop"): the aim per 1024-sample logical block,
    then pll_run_blockwise at chunk 8 around a zero centre; an AM carrier
    420 Hz off, two calls of 4 blocks."""
    from pebblesdr_tpu.demod import sam as jsam
    fs, blk, k = 64000.0, 1024, 4
    cfg_j = jsam.SAMConfig.make(fs).pll
    cfg_t = tpll.make_pll_config(fs, 100.0, zeta=0.707, range_hz=1000.0,
                                 detector="atan2")
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    sj, st = jpll.pll_init(cfg_j, C), tpll.pll_init(cfg_t, C, "cpu")
    aj, at = jnp.zeros(C), torch.zeros(C)
    rng = np.random.default_rng(8)
    for call in range(2):
        t = (call * k * blk + np.arange(k * blk)) / fs
        x = (0.5 * (1 + 0.5 * np.cos(2 * np.pi * 700 * t))
             * np.exp(1j * (2 * np.pi * 420 * t + np.arange(C)[:, None]))
             + 0.01 * rng.standard_normal((C, k * blk))).astype(np.complex64)
        sj, aj, pj, fj = jpll.pll_run_aimed(cfg_j, sj, aj, jnp.asarray(x),
                                            chunk=8, n_block=blk)
        st, at, pt, ft = tpll.pll_run_aimed(cfg_t, st, at,
                                            torch.from_numpy(x), chunk=8,
                                            n_block=blk)
        assert circ(pj, pt) < 1e-4
        assert circ(aj, at) < 1e-4
        assert np.abs(np.asarray(fj) - ft.numpy()).max() < 1e-6
        state_close(sj, st, phase_tol=1e-4)
    assert isinstance(st, tpll.PLLState)


def _tone(n: int, f: float, fs: float) -> np.ndarray:
    return np.exp(2j * np.pi * f * np.arange(n) / fs).astype(np.complex64)


def test_port_locks_to_offset_tone():
    """tests/test_ops_kernels.py:330-340 on the port."""
    fs, offset = 8000.0, 234.0
    cfg = tpll.make_pll_config(fs, bw_hz=100.0, range_hz=1000.0)
    st = tpll.pll_init(cfg, 1, "cpu")
    x = torch.from_numpy(_tone(8000, offset, fs))[None]
    st, phases, freqs = tpll.pll_run(cfg, st, x)
    f_hat = float(freqs[0, -500:].mean()) * fs / (2 * np.pi)
    assert f_hat == pytest.approx(offset, abs=5.0)


def test_port_carrier_removal():
    """tests/test_ops_kernels.py:342-350 on the port: after lock, x
    e^{-j phase} has near-zero residual phase drift."""
    fs = 8000.0
    cfg = tpll.make_pll_config(fs, bw_hz=200.0, range_hz=500.0)
    x = _tone(16000, 100.0, fs)
    st, phases, _ = tpll.pll_run(cfg, tpll.pll_init(cfg, 1, "cpu"),
                                 torch.from_numpy(x)[None])
    z = x[8000:] * np.exp(-1j * phases[0, 8000:].numpy())
    assert np.std(np.angle(z)) < 0.1


def test_loop_wrappers_take_edges_and_refuse_bad_arguments():
    cfg = tpll.make_pll_config(8000.0, 100.0)
    st = tpll.pll_init(cfg, 2, "cpu")
    # an empty call returns the state unchanged and [C, 0] outputs
    empty = torch.zeros(2, 0, dtype=torch.complex64)
    st2, ph, fr = tpll.pll_run(cfg, st, empty)
    assert ph.shape == fr.shape == (2, 0)
    assert all(torch.equal(getattr(st, f.name), getattr(st2, f.name))
               for f in dataclasses.fields(st))
    # a real input is taken as its complex form
    x = torch.from_numpy(np.cos(0.3 * np.arange(64)).astype(np.float32))
    a = tpll.pll_run(cfg, st, x[None].expand(2, 64))
    b = tpll.pll_run(cfg, st, x[None].expand(2, 64).to(torch.complex64))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    with pytest.raises(ValueError, match="detector"):
        tpll.pll_scan(torch.zeros(2, 4, dtype=torch.complex64), st.phase,
                      st.fdev, st.amp, "square", 0.1, 0.01, 0.0, -1.0, 1.0)
    with pytest.raises(ValueError, match="chunks"):
        tpll.pll_run_blockwise(cfg, st, torch.zeros(2, 100,
                                                    dtype=torch.complex64),
                               chunk=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpll.pll_scan(torch.zeros(2, 4, dtype=torch.complex64,
                                  device="meta"), st.phase, st.fdev, st.amp,
                      "atan2", 0.1, 0.01, 0.0, -1.0, 1.0)
