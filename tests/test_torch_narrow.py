"""The port's NONE receiver against the JAX Receiver on the CPU (the
harness of torch_parity.py: one step() warm-up, the state carried across,
dispatches of K = 3 and 9, the bounds of tests/test_chain_batched.py:
58-69).  NONE's composed front response (factor 32, 1159 taps) is one the
CUDA front_fir runs on items of 4 channels.  DSB, which shares AM's
response (factor 32, 711 taps), runs in test_torch_sam.py beside SAM,
whose JAX Receiver has compiled that front already."""

import pytest

import torch_parity as tp
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode

KS = (3, 9)
@pytest.fixture(scope="module")
def runs():
    return tp.run(DemodMode.NONE, lambda k, s: tp.tone_plane(k, s, 5000.0),
                  KS)


@pytest.mark.parametrize("run", ["step", *KS])
def test_audio(runs, run):
    scale = tp.check_audio(*runs[run][:2])
    if run == 9:
        assert scale > 0.1       # the compared audio is not all delay


@pytest.mark.parametrize("run", ["step", *KS])
def test_spectra_smeter_and_squelch(runs, run):
    jo, to, _, _ = runs[run]
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)


@pytest.mark.parametrize("run", KS)
def test_carried_state(runs, run):
    _, _, js, ts = runs[run]
    tp.check_state(js, ts)


@pytest.mark.parametrize("mode,factor,taps", [(DemodMode.DSB, 32, 711),
                                              (DemodMode.NONE, 32, 1159)])
def test_front_response(mode, factor, taps):
    rx = Receiver(ReceiverConfig(**tp.KW, mode=mode), "cpu")
    assert (rx.plan.factor, rx.front.h.numel()) == (factor, taps)
    assert rx.init_state().demod is None
