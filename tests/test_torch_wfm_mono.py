"""Mono WFM of the PyTorch port against the JAX package on the CPU.

  * iir.biquad_apply, the streaming DF2 biquad, against JAX's on the
    chunked path (N a multiple of 512) and the fallback scan (N with no
    chunk), over two streaming calls, with the mono pre-discriminator
    low-pass (75 kHz, Q 1) at the default (256 kHz) and the hq (512 kHz)
    input rate, on real and complex input;
  * the FMM Receiver (default and hq geometry) and FMS with stereo=False
    (which the JAX package builds as FMM) through the harness of
    torch_parity.py: one step() warm-up, the state carried across, then
    dispatches of K = 3 and 9 blocks of 8192 frames at C = 4;
  * FMM with the RDS tap (default and hq) at 32768-frame blocks (the
    shortest whose 19 kHz stream holds whole symbols), K = 3.

Bounds: the biquad 1e-5 of the output's scale; the receivers those of
tests/test_torch_receiver.py:77-115 (audio 2e-4 absolute, spectra and
S-meter 0.1 dB, squelch and pilot lock equal, every state leaf 1e-4), RDS
soft symbols 1e-3 of their scale and timing equal (tests/test_torch_rds.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import wfm
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import iir

KS = (3, 9)
FS = tp.FS


def fm_plane(k: int, seed: int, n: int = tp.N, rds: bool = False):
    """[k*n, 2C] packed plane: broadcast FM at the tune frequency (75 kHz
    deviation; 1 kHz program at 0.45 and the 19 kHz pilot at 0.1, with
    rds the RDS stream on 57 kHz too), channel i at level 0.3 + 0.4 i / C
    and phase pi/4 + i pi/2, complex noise at 1e-2."""
    t = seed * 0.37 + np.arange(k * n) / FS
    comp = (0.45 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t))
    if rds:
        from test_torch_rds import biphase
        comp = comp + 0.06 * biphase(t - seed * 0.37) * np.cos(
            2 * np.pi * 57000.0 * t)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    c = tp.C
    x = np.stack([(0.3 + 0.4 * i / c)
                  * np.exp(1j * (2 * np.pi * tp.TUNE * t + ph + np.pi / 4
                                 + i * np.pi / 2)) for i in range(c)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


# ------------------------------------------------------------- the biquad

@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("n", [4096, 1000], ids=["chunked", "fallback"])
@pytest.mark.parametrize("fs_in", [256_000.0, 512_000.0])
def test_biquad_apply_matches_jax_streaming(fs_in, n, cplx):
    coef = wfm.WFMConfig.make(fs_in / (2 if fs_in > 256_000 else 1),
                              stereo=False,
                              comp_decim=2 if fs_in > 256_000 else 1
                              ).mono_pre_lp
    jcoef = jiir.design_biquad("lowpass", 75000.0, fs_in, q=1.0)
    assert (iir._biquad_pick_chunk(n) is None) == (n == 1000)
    rng = np.random.default_rng(int(fs_in) + n)
    c = 6
    js, ts = jnp.zeros((c, 2)), torch.zeros(c, 2)
    if cplx:
        js, ts = js.astype(jnp.complex64), ts.to(torch.complex64)
    japply = jax.jit(lambda s, x: jiir.biquad_apply(s, x, jcoef))
    for _ in range(2):
        x = rng.standard_normal((c, n)).astype(np.float32)
        if cplx:
            x = (x + 1j * rng.standard_normal((c, n))).astype(np.complex64)
        js, jy = japply(js, jnp.asarray(x))
        ts, ty = iir.biquad_apply(ts, torch.from_numpy(x), coef)
        scale = float(np.abs(np.asarray(jy)).max())
        assert ty.shape == jy.shape and ty.numpy().dtype == jy.dtype
        assert np.abs(np.asarray(jy) - ty.numpy()).max() < 1e-5 * scale
        assert np.abs(np.asarray(js) - ts.numpy()).max() < 1e-5 * scale


def test_biquad_chunked_equals_its_scan():
    """The two forms are one recurrence: a 4096-sample call against the
    same samples split into calls of 1000 and 3096 (the scan form)."""
    coef = iir.design_biquad("lowpass", 75000.0, 256_000.0, q=1.0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 4096)).astype(np.float32))
    s0 = torch.zeros(3, 2)
    s1, y1 = iir.biquad_apply(s0, x, coef)
    sa, ya = iir.biquad_apply(s0, x[:, :1000], coef)
    sb, yb = iir.biquad_apply(sa, x[:, 1000:], coef)
    assert torch.allclose(torch.cat([ya, yb], 1), y1, atol=1e-5)
    assert torch.allclose(sb, s1, atol=1e-5)


# ---------------------------------------------------------- the receivers

TWIN = "fms_mono"


@pytest.fixture(scope="module", params=[False, True], ids=["default", "hq"])
def runs(request):
    hq = request.param
    return hq, tp.run(DemodMode.FMM, fm_plane, KS, jit=True, wfm_hq=hq, twins={
        TWIN: (DemodMode.FMS, dict(stereo=False, wfm_hq=hq))})


def _check(jo, to, audio: bool = True):
    if audio:
        tp.check_audio(jo, to)
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    assert np.array_equal(np.asarray(jo["pilot_locked"]),
                          to["pilot_locked"].numpy())
    assert not to["pilot_locked"].any()


@pytest.mark.parametrize("port", ["FMM", TWIN])
@pytest.mark.parametrize("run", ["step", *KS])
def test_mono_receiver_outputs(runs, run, port):
    hq, res = runs
    jo, to, _, _ = (res if port == "FMM" else res[TWIN])[run]
    _check(jo, to)
    assert to["audio"].shape == ((tp.C, 192) if run == "step"
                                 else (run, tp.C, 192))
    if run == 9:
        assert float(to["audio"].abs().max()) > 0.1


@pytest.mark.parametrize("port", ["FMM", TWIN])
@pytest.mark.parametrize("run", KS)
def test_mono_receiver_state(runs, run, port):
    hq, res = runs
    _, _, js, ts = (res if port == "FMM" else res[TWIN])[run]
    tp.check_state(js, ts)


def test_mono_layout_and_front_form():
    """Mono runs K1 in its base form (no discriminator in the front end)
    at the WFM plans: factor 8, or 4 at hq with the composite decimated
    by 2 in demod/wfm.py; its state has the JAX package's mono layout."""
    for hq, factor in ((False, 8), (True, 4)):
        rx = Receiver(ReceiverConfig(**tp.KW, mode=DemodMode.FMM,
                                     wfm_hq=hq), "cpu")
        assert rx.plan.factor == factor and rx.wfm_tail is None
        assert rx.wfm_cfg.comp_decim == (2 if hq else 1)
        st = rx.init_state().demod
        t = len(rx.wfm_cfg.audio_taps)
        assert st.lp_tail_mono.shape == st.lp_tail_lmr.shape == (tp.C, t - 1)
        assert st.mono_lp_bq.shape == (2 * tp.C, 2)
        assert rx.init_state().resamp is not None


# ------------------------------------------------------------- with RDS

@pytest.fixture(scope="module", params=[False, True], ids=["default", "hq"])
def rds_runs(request):
    n = 32768
    return tp.run(DemodMode.FMM,
                  lambda k, s: fm_plane(k, s, n=n, rds=True), (3,),
                  kw=dict(tp.KW, frames_per_buffer=n), jit=True, rds=True,
                  wfm_hq=request.param)


def test_mono_rds_receiver(rds_runs):
    jo, to, js, ts = rds_runs[3]
    _check(jo, to)
    soft_j, soft_t = np.asarray(jo["rds_soft"]), to["rds_soft"].numpy()
    assert soft_t.shape == (3, tp.C, 19)
    scale = float(np.abs(soft_j).max())
    assert scale > 1e-3
    assert np.abs(soft_j - soft_t).max() < 1e-3 * scale
    assert np.array_equal(np.asarray(jo["rds_timing"]),
                          to["rds_timing"].numpy())
    tp.check_state(js, ts)
