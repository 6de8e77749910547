"""The port's SAM (demod/sam.py and what it runs: ops/fir.py
fir_apply_complex, ops/iir.py dc_removal_apply, ops/pll.py pll_run_aimed)
against the JAX package on the CPU, and the SAM Receiver in both sideband
splits against the JAX Receiver (the harness of torch_parity.py, with the
PLL-mode audio bound of tests/test_chain_batched.py:114-118: 2e-3 of the
audio's scale).  The DSB Receiver runs here too (audio 2e-4 absolute):
it shares SAM's front response, which the JAX Receiver then compiles
once for both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.demod import sam as jsam
from pebblesdr_tpu.ops import fir as jfir
from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu.ops import pll as jpll
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import nfm, sam
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import fir, iir, pll
from pebblesdr_tpu_torch.utils import convert

RATE, BLK, C = 64_000.0, 256, 4


def carrier(k: int, seed: int, offset_hz: float = 230.0) -> np.ndarray:
    """[C, k BLK] complex64: an AM carrier (1 kHz, m = 0.5) at offset_hz
    with a per-channel phase and level, plus noise at 1e-2."""
    t = np.arange(k * BLK) / RATE
    env = 1 + 0.5 * np.cos(2 * np.pi * 1000.0 * t)
    x = np.stack([(0.3 + 0.1 * i) * env
                  * np.exp(1j * (2 * np.pi * offset_hz * t + 0.7 * i))
                  for i in range(C)])
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def wrapped(a, b) -> float:
    return float(np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64)
                                             - np.asarray(b, np.float64)))
                                 )).max())


def test_fir_apply_complex_matches_jax():
    cfg = jsam.SAMConfig.make(RATE, 12000.0)
    taps = cfg.hilbert_taps
    x = carrier(3, 1)
    rng = np.random.default_rng(2)
    tail = (rng.standard_normal((C, len(taps) - 1))
            + 1j * rng.standard_normal((C, len(taps) - 1))).astype(np.complex64)
    jy, jt = jfir.fir_apply_complex(jnp.asarray(x), jnp.asarray(
        taps, jnp.complex64), jnp.asarray(tail), taps_np=taps)
    ty, tt = fir.fir_apply_complex(torch.from_numpy(x), None,
                                   torch.from_numpy(tail), taps_np=taps)
    assert ty.dtype == torch.complex64 and tt.dtype == torch.complex64
    scale = float(np.abs(np.asarray(jy)).max())
    assert np.abs(np.asarray(jy) - ty.numpy()).max() < 1e-5 * scale
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_dc_removal_apply_matches_jax():
    rng = np.random.default_rng(3)
    x = (0.2 + rng.standard_normal((2 * C, 3 * BLK))).astype(np.float32)
    prev = rng.standard_normal(2 * C).astype(np.float32)
    for alpha in (0.999, 0.9999):
        jm, jy = jiir.dc_removal_apply(jnp.asarray(prev), jnp.asarray(x),
                                       alpha=alpha)
        tm, ty = iir.dc_removal_apply(torch.from_numpy(prev),
                                      torch.from_numpy(x), alpha=alpha)
        assert np.abs(np.asarray(jy) - ty.numpy()).max() < 1e-6
        assert np.abs(np.asarray(jm) - tm.numpy()).max() < 1e-6


@pytest.mark.parametrize("k", [1, 3])
def test_pll_run_aimed_matches_jax(k):
    """The aimed loop with the open smoother over k concatenated blocks,
    twice (the state and aim carried): phases and aim' within 1e-4 rad
    modulo 2 pi, the smoother's state within 1e-4."""
    jcfg = jsam.SAMConfig.make(RATE, 12000.0)
    tcfg = sam.SAMConfig.make(RATE, 12000.0)
    jst, jaim = jpll.costas_open_init(C), jnp.zeros(C, jnp.float32)
    tst = pll.costas_open_init(C, "cpu")
    taim = torch.zeros(C)
    for seed in (4, 5):
        x = carrier(k, seed)
        jst, jaim, jph, jfr = jpll.pll_run_aimed(
            jcfg.pll, jst, jaim, jnp.asarray(x), n_block=BLK,
            smooth_cfg=jcfg.open_track)
        tst, taim, tph, tfr = pll.pll_run_aimed(
            tcfg.pll, tst, taim, torch.from_numpy(x), n_block=BLK,
            smooth_cfg=tcfg.open_track)
        assert wrapped(jph, tph.numpy()) < 1e-4
        assert wrapped(jaim, taim.numpy()) < 1e-4
        assert np.abs(np.asarray(jfr) - tfr.numpy()).max() < 1e-6
        for a, b in zip(tp.jleaves(jst), convert.state_to_numpy(tst)):
            assert np.abs(a.astype(np.complex128)
                          - b.astype(np.complex128)).max() < 1e-4


@pytest.mark.parametrize("sideband", ["analytic", "rails"])
def test_sam_demod_stereo_matches_jax(sideband):
    """mono, left and right within 1e-4 of their scale over two calls of
    three blocks, and the carried state."""
    jcfg = jsam.SAMConfig.make(RATE, 12000.0, sideband=sideband)
    tcfg = sam.SAMConfig.make(RATE, 12000.0, sideband=sideband)
    jst, tst = jsam.sam_init(jcfg, C), sam.sam_init(tcfg, C, "cpu")
    for seed in (6, 7):
        x = carrier(3, seed)
        jst, *jout = jsam.sam_demod_stereo(jcfg, jst, jnp.asarray(x),
                                           n_block=BLK)
        tst, *tout = sam.sam_demod_stereo(tcfg, tst, torch.from_numpy(x),
                                          n_block=BLK)
        for a, b in zip(jout, tout):
            a = np.asarray(a)
            assert b.dtype == torch.float32 and a.shape == tuple(b.shape)
            scale = max(float(np.abs(a).max()), 1e-6)
            assert np.abs(a - b.numpy()).max() < 1e-4 * scale
    aim = tp.leaf_index(tst, "aim")
    tp.check_state(tp.jleaves(jst), convert.state_to_numpy(tst), (aim,))


KS = (3, 9)


# (mode, receiver options, carrier offset Hz)
RECEIVERS = {"analytic": (DemodMode.SAM, dict(sam_sideband="analytic"), 230.0),
             "rails": (DemodMode.SAM, dict(sam_sideband="rails"), 230.0),
             "dsb": (DemodMode.DSB, {}, 0.0)}


@pytest.fixture(scope="module", params=list(RECEIVERS))
def runs(request):
    mode, opts, offset = RECEIVERS[request.param]
    res = tp.run(mode, lambda k, s: tp.tone_plane(k, s, offset, am=True), KS,
                 **opts)
    return mode, res


@pytest.mark.parametrize("run", ["step", *KS])
def test_receiver_audio(runs, run):
    mode, res = runs
    scale = (tp.check_audio(*res[run][:2], tol=2e-3, rel=True)
             if mode == DemodMode.SAM else tp.check_audio(*res[run][:2]))
    if run == 9:
        assert scale > 0.1       # the compared audio is not all delay


@pytest.mark.parametrize("run", ["step", *KS])
def test_receiver_spectra_smeter_and_squelch(runs, run):
    jo, to, _, _ = runs[1][run]
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)


@pytest.mark.parametrize("run", KS)
def test_receiver_carried_state(runs, run):
    mode, res = runs
    _, _, js, ts = res[run]
    angles = ()
    if mode == DemodMode.SAM:    # SAM's carried aim, modulo 2 pi
        rx = Receiver(ReceiverConfig(mode=mode, **tp.KW), "cpu")
        angles = (tp.leaf_index(rx.init_state(), "demod", "aim"),)
    tp.check_state(js, ts, angles)


def test_refusals_name_what_is_not_ported():
    """SAM's scan, its loop and its short blocks, FMN's "pll" and adaptive
    IQ balance run now (tests/test_torch_sam_scan.py,
    tests/test_torch_nfm_pll.py, tests/test_torch_receiver_staged.py; SAM
    at 2048 frames with "auto" takes the staged front and is held to JAX
    in tests/test_torch_receiver.py case kw0): what is still refused is an
    unknown carrier algorithm, smoother or sideband split, and the
    decimating complex FIR."""
    rx = Receiver(ReceiverConfig(**{**tp.KW, "frames_per_buffer": 2048},
                                 mode=DemodMode.SAM,
                                 enable_iq_balance="auto"), "cpu")
    assert rx.staged and rx.blk == 64
    with pytest.raises(ValueError, match="smoother"):
        sam.SAMConfig.make(RATE, smooth="chunked")
    with pytest.raises(ValueError, match="carrier algorithm"):
        sam.SAMConfig.make(RATE, algorithm="costas")
    with pytest.raises(ValueError, match="sideband"):
        sam.SAMConfig.make(RATE, sideband="upper")
    cfg = sam.SAMConfig.make(RATE)
    with pytest.raises(ValueError, match="decim > 1"):
        fir.fir_apply_complex(torch.from_numpy(carrier(1, 0)), None,
                              torch.zeros(C, 60, dtype=torch.complex64),
                              decim=2, taps_np=cfg.hilbert_taps)
    with pytest.raises(ValueError, match="unknown NFM algorithm"):
        nfm.NFMConfig.make(RATE, algorithm="quadrature")
