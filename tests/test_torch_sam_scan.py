"""SAM's per-sample and chunked carrier loops on the port against the JAX
package, on the CPU (the plain versions of csrc/recur.cu pll_scan and
pll_chunk_scan).

  * sam_demod_stereo with algorithm="scan" (pll.pll_run over the whole
    stream) and with smooth="loop" (the aimed loop's chunked stage 2,
    pll_run_blockwise at chunk 8), both sideband splits, over two calls of
    three 256-sample blocks: mono, left and right within 2e-3 of their
    scale (the PLL-mode bound of tests/test_chain_batched.py:114-118), the
    state within 1e-4 (phases modulo 2 pi);
  * the SAM Receiver at frames_per_buffer=2048, whose 64-sample demod
    blocks the aim cannot fold (so SAM runs its per-sample loop), in both
    sideband splits, against JAX's step_many, which scans its blocks
    (pebblesdr_tpu/chain/receiver.py:526-541): a first dispatch of 33
    blocks (the 15 ms AGC delay line and the loop's lock), then 3 and 9
    blocks; every stage of the tail at that block (zoom window of 64, AGC
    stride 16, the resampler's 64 -> 48 plan, the spectra) is compared:
    audio, spectra, S-meter, squelch and state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.demod import sam as jsam
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import sam
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.utils import convert
from test_torch_sam import BLK, RATE, C, carrier

SHORT = 2048     # frames per buffer: 64-sample demod blocks at 2.048 Msps


@pytest.mark.parametrize("sideband", ["analytic", "rails"])
@pytest.mark.parametrize("form", ["scan", "loop"])
def test_sam_demod_loops_match_jax(form, sideband):
    kw = (dict(algorithm="scan") if form == "scan" else dict(smooth="loop"))
    jcfg = jsam.SAMConfig.make(RATE, 12000.0, sideband=sideband, **kw)
    tcfg = sam.SAMConfig.make(RATE, 12000.0, sideband=sideband, **kw)
    assert (jcfg.pll_chunk, jcfg.algorithm, jcfg.smooth) == \
        (tcfg.pll_chunk, tcfg.algorithm, tcfg.smooth)
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
            assert np.abs(a - b.numpy()).max() < 2e-3 * scale
    angles = (tp.leaf_index(tst, "aim"), tp.leaf_index(tst, "pll", "phase"))
    tp.check_state(tp.jleaves(jst), convert.state_to_numpy(tst), angles)
    # the loop moved its own state, not the open smoother's
    assert float(tst.pll.amp.sub(1.0).abs().max()) > 1e-3
    assert float(tst.track.r.abs().max()) == 0.0


def short_plane(k: int, seed: int) -> np.ndarray:
    """[k SHORT, 2C] packed plane: an AM carrier (1 kHz, m = 0.8) 400 Hz
    above the tune, per-channel level, plus noise; continuous in time
    across dispatches (seed is the dispatch's index)."""
    t0 = {7: 0, 0: 1, 1: 34, 2: 37}[seed] * SHORT
    t = (t0 + np.arange(k * SHORT)) / tp.FS
    sig = (np.exp(2j * np.pi * (tp.TUNE + 400.0) * t)
           * 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2)
    x = np.stack([sig * (0.5 + 0.2 * i) for i in range(C)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


KS = (33, 3, 9)


@pytest.fixture(scope="module", params=["analytic", "rails"])
def runs(request):
    kw = {**tp.KW, "frames_per_buffer": SHORT}
    res = tp.run(DemodMode.SAM, short_plane, KS, kw=kw, jit=True,
                 sam_sideband=request.param)
    return request.param, res


def test_short_block_receiver_geometry():
    rx = Receiver(ReceiverConfig(**{**tp.KW, "frames_per_buffer": SHORT},
                                 mode=DemodMode.SAM), "cpu")
    assert (rx.blk, rx.zoom_bins, rx.agc_cfg.stride, rx.audio_blk) == \
        (64, 64, 16, 48)
    assert rx.blk % sam.AIM_BLOCK and rx.sam_cfg.algorithm == "aimed"


@pytest.mark.parametrize("run", KS)
def test_short_block_receiver_audio(runs, run):
    scale = tp.check_audio(*runs[1][run][:2], tol=2e-3, rel=True)
    assert scale > 0.1           # the compared audio is not all delay


@pytest.mark.parametrize("run", KS)
def test_short_block_receiver_spectra_smeter_and_squelch(runs, run):
    jo, to, _, _ = runs[1][run]
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)


@pytest.mark.parametrize("run", KS)
def test_short_block_receiver_state(runs, run):
    _, _, js, ts = runs[1][run]
    rx = Receiver(ReceiverConfig(mode=DemodMode.SAM, **tp.KW), "cpu")
    st = rx.init_state()
    angles = (tp.leaf_index(st, "demod", "aim"),
              tp.leaf_index(st, "demod", "pll", "phase"))
    tp.check_state(js, ts, angles)
