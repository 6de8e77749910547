"""The port's Receiver with TestBench's taps (ReceiverConfig(taps=True))
against the JAX Receiver's on the CPU.

taps=True takes the staged front in both packages (the JAX package's
front_ok fails), and the JAX step_many scans _step_impl over the blocks:
out["taps"] holds raw_iq (after DC removal), post_mixer (after the
decimation), post_bp (the FastFIR output), post_demod (the demod's output
before the resampler; WFM's left channel) and, with the WFM RDS tap,
rds_baseband, each [C, n] per step and [K, C, n] per dispatch.  The port's
dispatch taps are views of its [C, K*n] streams.  Through the harness of
torch_parity.py at C = 4 (one step, then a dispatch of 3 blocks): AM, CWU,
USB and FMN at 8192-frame blocks, FMS with RDS at 32768 (whole symbols per
block).  Bounds: those of tests/test_torch_receiver_staged.py (audio 2e-4,
spectra and S-meter 0.1 dB, squelch equal, state 1e-4), and every tap
within 2e-4 (the staged audio bound) of JAX's; FMN's first step
discriminates the front FIR's fill from a zero state (rounding noise in
either package), so its step audio and post_demod are not compared.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from test_torch_wfm_mono import fm_plane

TAP_TOL = 2e-4
NARROW = ("raw_iq", "post_mixer", "post_bp", "post_demod")
CASES = {
    "AM": (DemodMode.AM, lambda k, s: tp.tone_plane(k, s, 300.0, am=True),
           tp.KW, {}),
    "CWU": (DemodMode.CWU, lambda k, s: tp.tone_plane(k, s, 1000.0), tp.KW,
            {}),
    "USB": (DemodMode.USB, lambda k, s: tp.tone_plane(k, s, 1500.0), tp.KW,
            {}),
    "FMN": (DemodMode.FMN, lambda k, s: tp.tone_plane(k, s, 1500.0), tp.KW,
            {}),
    "FMS rds": (DemodMode.FMS,
                lambda k, s: fm_plane(k, s, n=32768, rds=True),
                dict(tp.KW, frames_per_buffer=32768), dict(rds=True)),
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    mode, plane, kw, opts = CASES[request.param]
    return request.param, tp.run(mode, plane, (3,), kw=kw, jit=True,
                                 taps=True, **opts)


@pytest.mark.parametrize("run", ["step", 3])
def test_taps_match_jax(runs, run):
    name, res = runs
    jo, to, js, ts = res[run]
    keys = NARROW if name != "FMS rds" else (
        "raw_iq", "post_mixer", "post_demod", "rds_baseband")
    assert set(jo["taps"]) == set(to["taps"]) == set(keys)
    for key in keys:
        a, b = np.asarray(jo["taps"][key]), to["taps"][key].numpy()
        assert a.shape == b.shape, key
        if run == 3:
            assert a.shape[:2] == (3, tp.C), key
        if name == "FMN" and run == "step" and key == "post_demod":
            continue
        assert np.abs(a - b).max() < TAP_TOL, (key, np.abs(a - b).max())
        assert np.abs(b).max() > 0 or key == "post_demod", key
    if not (name == "FMN" and run == "step"):
        tp.check_audio(jo, to)
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    if js is not None:
        tp.check_state(js, ts)
    if name == "FMS rds" and run == 3:
        soft_j, soft_t = np.asarray(jo["rds_soft"]), to["rds_soft"].numpy()
        assert np.abs(soft_j - soft_t).max() < 1e-3 * np.abs(soft_j).max()


def test_dispatch_taps_are_views_of_the_streams():
    """A dispatch's taps are [K, C, n] views of the [C, K*n] streams (no
    copy: their [C, K, n] transpose is contiguous), the taps take the
    staged front, and a Receiver without taps returns none."""
    rx = Receiver(ReceiverConfig(mode=DemodMode.USB, taps=True, **tp.KW),
                  "cpu")
    assert rx.staged
    _, out = rx.step_many(rx.init_state(), rx.default_params(tp.TUNE),
                          torch.from_numpy(
                              tp.tone_plane(3, 0, 1500.0)))
    for key in ("raw_iq", "post_mixer", "post_bp"):
        v = out["taps"][key]
        assert v.shape[:2] == (3, tp.C) and not v.is_contiguous()
        assert v.transpose(0, 1).is_contiguous(), key
    assert out["taps"]["raw_iq"].shape[-1] == tp.N
    assert out["taps"]["post_bp"].shape[-1] == rx.blk
    plain = Receiver(ReceiverConfig(mode=DemodMode.USB, **tp.KW), "cpu")
    assert not plain.staged
    _, out = plain.step_many(plain.init_state(),
                             plain.default_params(tp.TUNE),
                             torch.from_numpy(
                                 tp.tone_plane(3, 0, 1500.0)))
    assert "taps" not in out
