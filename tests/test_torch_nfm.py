"""NFM of the PyTorch port against the JAX package on the CPU.

  * nfm_demod with the conj-product and the derivative discriminator, C = 4,
    over two streaming calls (the carried sample, DC tracker and voice
    low-pass history), against pebblesdr_tpu/demod/nfm.py;
  * the FMN Receiver through the harness of torch_parity.py (one step()
    warm-up, the state carried across, dispatches of K = 3 and 9 blocks of
    8192 frames): K1 in its base form at AM's plan (factor 32, 711 taps);
  * what once was refused by name and runs now held to the JAX package:
    RDS premix=False, a complex RDS baseband, adaptive IQ balance in AM
    and SAM, the "pll" pilot (at the hq composite too), the pilot notch on
    the fused tail, and the stereo receiver at 1.536 Msps (tail_sub == 0;
    test_torch_wfm_stereo_tail.py's helpers and bounds).

Bounds: nfm_demod 1e-5 of the audio's scale, state 1e-5; the Receiver those
of tests/test_torch_receiver.py:77-115.  The first block's audio is not
compared: from a zero state it discriminates the front FIR's fill (|y| ~
1e-6), whose angles are rounding noise in either package (the spectra,
S-meter and squelch of that block are compared; the dispatches after it
start from JAX's state).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_wfm_stereo_tail as stail
import torch_parity as tp
from pebblesdr_tpu.demod import nfm as jnfm
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import nfm, rds
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.utils import convert

KS = (3, 9)
RATE, C = 64_000.0, 4


def nfm_iq(n: int, seed: int, t0: float = 0.0) -> np.ndarray:
    """[C, n] complex64 at 64 kHz: NFM (1 kHz at 3 kHz deviation, 123 Hz at
    500 Hz) on a carrier 300 Hz off, per-channel level and phase, noise."""
    t = t0 + np.arange(n) / RATE
    f = (3000.0 * np.sin(2 * np.pi * 1000.0 * t)
         + 500.0 * np.sin(2 * np.pi * 123.0 * t) + 300.0)
    ph = 2 * np.pi * np.cumsum(f) / RATE
    x = np.stack([(0.2 + 0.1 * i) * np.exp(1j * (ph + 0.9 * i))
                  for i in range(C)])
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def fm_plane(k: int, seed: int) -> np.ndarray:
    """[k*N, 2C] packed plane: the NFM voice signal of nfm_iq at the tune
    frequency, complex noise at 1e-2."""
    t = seed * 0.29 + np.arange(k * tp.N) / tp.FS
    f = (3000.0 * np.sin(2 * np.pi * 1000.0 * t)
         + 500.0 * np.sin(2 * np.pi * 123.0 * t))
    ph = 2 * np.pi * np.cumsum(f) / tp.FS
    x = np.stack([(0.2 + 0.1 * i)
                  * np.exp(1j * (2 * np.pi * tp.TUNE * t + ph + 0.9 * i))
                  for i in range(C)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


@pytest.mark.parametrize("algorithm", ["conj", "derivative"])
def test_nfm_demod_matches_jax_streaming(algorithm):
    jc = jnfm.NFMConfig.make(RATE, algorithm=algorithm)
    tc = nfm.NFMConfig.make(RATE, algorithm=algorithm)
    assert np.array_equal(jc.voice_taps, tc.voice_taps)
    js, ts = jnfm.nfm_init(jc, C), nfm.nfm_init(tc, C, "cpu")
    for call in range(2):
        x = nfm_iq(1024, call, t0=call * 1024 / RATE)
        js, ja = jnfm.nfm_demod(jc, js, jnp.asarray(x))
        ts, ta = nfm.nfm_demod(tc, ts, torch.from_numpy(x))
        ja = np.asarray(ja)
        scale = float(np.abs(ja).max())
        assert scale > 0.3                      # 3 kHz of 5 kHz deviation
        assert ta.dtype == torch.float32 and ta.shape == ja.shape
        assert np.abs(ja - ta.numpy()).max() < 1e-5 * scale
        jl, tl = tp.jleaves(js), convert.state_to_numpy(ts)
        assert len(jl) == len(tl) == 6
        for a, b in zip(jl, tl):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.abs(a.astype(np.complex128)
                          - b.astype(np.complex128)).max() < 1e-5


@pytest.fixture(scope="module")
def runs():
    return tp.run(DemodMode.FMN, fm_plane, KS, jit=True)


@pytest.mark.parametrize("run", ["step", *KS])
def test_fmn_receiver_outputs(runs, run):
    jo, to, _, _ = runs[run]
    if run != "step":
        tp.check_audio(jo, to)
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    if run == 9:
        assert float(to["audio"].abs().max()) > 0.3
    assert "ctcss_open" not in to


@pytest.mark.parametrize("run", KS)
def test_fmn_receiver_state(runs, run):
    _, _, js, ts = runs[run]
    tp.check_state(js, ts)


def test_fmn_receiver_geometry():
    """FMN runs K1's base form at AM's plan, its AGC off by default."""
    rx = Receiver(ReceiverConfig(**tp.KW, mode=DemodMode.FMN), "cpu")
    assert (rx.plan.factor, rx.front.h.numel()) == (32, 711)
    assert rx.agc_cfg.mode == "off" and rx.nfm_cfg.algorithm == "conj"
    assert isinstance(rx.init_state().demod, nfm.NFMState)


def _rds_parity(alg: str, change: dict, complex_input: bool = False):
    """RDS's premix=False inputs (composed, or staged with composed=False)
    against JAX's rds_process over two calls: soft symbols 1e-3 of their
    scale, timing equal, the state 1e-4 (tests/test_torch_rds.py)."""
    import jax
    from pebblesdr_tpu.demod import rds as jrds
    jc = dataclasses.replace(jrds.RdsConfig.make(256_000.0, 4096, alg=alg),
                             **change)
    tc = dataclasses.replace(rds.RdsConfig.make(256_000.0, 4096, alg=alg),
                             **change)
    init = dict(change, premix=False)      # the composed / staged history
    sj = jrds.rds_init(dataclasses.replace(jc, **init), 2)
    st = rds.rds_init(dataclasses.replace(tc, **init), 2, "cpu")
    rng = np.random.default_rng(3)
    for call in range(2):
        t = (call * 3 * 4096 + np.arange(3 * 4096)) / 256_000.0
        x = (0.05 * np.sign(np.sin(np.pi * 1187.5 * t))
             * np.cos(2 * np.pi * 57000.0 * t) + 0.3 * np.sin(
                 2 * np.pi * 1000.0 * t)) * np.ones((2, 1))
        x = x + 0.01 * rng.standard_normal(x.shape)
        if complex_input:
            x = (x * np.exp(-2j * np.pi * 57000.0 * t)).astype(np.complex64)
        else:
            x = x.astype(np.float32)
        sj, soft_j, tim_j = jrds.rds_process(jc, sj, jnp.asarray(x))
        st, soft_t, tim_t = rds.rds_process(tc, st, torch.from_numpy(x))
        scale = float(np.abs(np.asarray(soft_j)).max())
        assert scale > 1e-3
        assert np.abs(np.asarray(soft_j) - soft_t.numpy()).max() < 1e-3 * scale
        assert np.array_equal(np.asarray(tim_j), tim_t.numpy())
        tp.check_state(tp.jleaves(sj), convert.state_to_numpy(st))


def _auto_receiver(mode):
    """A Receiver with enable_iq_balance="auto" held to the JAX Receiver."""
    rx = Receiver(ReceiverConfig(**tp.KW, mode=mode,
                                 enable_iq_balance="auto"), "cpu")
    assert rx.staged
    tp.check_run(mode, lambda k, s: tp.tone_plane(k, s, 300.0, am=True),
                 enable_iq_balance="auto")


def _complex_rds():
    """A complex pre-mixed baseband takes the composed input: it runs with
    a composed history and is refused, by name, with a premix one."""
    cfg = rds.RdsConfig.make(256_000.0, 4096, alg="scan")
    with pytest.raises(ValueError, match="complex"):
        rds.rds_process(cfg, rds.rds_init(cfg, 2, "cpu"),
                        torch.zeros(2, 4096, dtype=torch.complex64))
    _rds_parity("scan", {}, complex_input=True)


# NFM "pll", the scan RDS carrier and AGC, SAM's scan, loop and non-128
# forms, RDS premix=False, adaptive IQ balance and the stereo tail without
# K2 run now: every case is held to the JAX package (match None; the ids
# keep the cases' names): "nfm pll" the notch on the fused tail, "pll
# pilot" and "agc scan" the "pll" pilot (at the hq composite: 512 kHz,
# comp_decim 2), "sam scan" the 1.536 Msps stereo receiver (one dispatch
# of one block; test_torch_receiver_wfm.py runs K = 3)
@pytest.mark.parametrize("what,make,match", [
    ("nfm pll", lambda: stail.tm_notch_parity(), None),
    ("pll pilot", lambda: stail.wfm_demod_parity(256_000.0,
                                                 pilot_alg="pll"), None),
    ("rds scan", lambda: _rds_parity("scan", dict(premix=False)), None),
    ("agc scan", lambda: stail.wfm_demod_parity(
        512_000.0, pilot_alg="pll", comp_decim=2, n_block=4096), None),
    ("iq auto", lambda: _auto_receiver(DemodMode.AM), None),
    ("sam scan", lambda: stail.receiver_parity(1_536_000, 24576, ks=(1,)),
     None),
    ("sam loop", lambda: _auto_receiver(DemodMode.SAM), None),
    ("sam non-128", _complex_rds, None)],
    ids=["nfm pll--pll\\.pll_run", "pll pilot--'pll' pilot",
         "rds scan--scan", "agc scan--scan", "iq auto--auto",
         "sam scan--scan", "sam loop--loop", "sam non-128--128"])
def test_per_sample_loops_refused_by_name(what, make, match):
    if match is None:
        make()
        return
    with pytest.raises(ValueError, match=match):
        make()
