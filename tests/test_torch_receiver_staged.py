"""The port's Receiver on the staged front against the JAX package on the
CPU.

The JAX Receiver drops its fused front where adaptive IQ balance
(enable_iq_balance="auto"), enable_dc_removal=False or an empty decimation
plan asks for the staged front, and its step_many then scans _step_impl
over the blocks: dc_removal_chunked -> iq_balance / auto_iq_balance ->
noise_blanker_chunked -> mixer.mix -> decimator.apply per block.  The port
runs each op once over the dispatch's concatenated stream and feeds its
batched tail.  Through the harness of torch_parity.py: one step() warm-up,
the state carried across with utils.convert, then dispatches of K = 3 and
5 blocks at C = 4 on an imbalanced capture (I gain 1.06, 0.08 of I in Q).

Configurations: "auto" in AM, USB, SAM, FMN and FMM + RDS;
enable_dc_removal=False; "auto" + NB1 and NB2; frames_per_buffer 3840 (not
a multiple of 512: the DC blocker's per-sample form); "auto" with the ANF
(updated every 16 samples, as JAX's per-block path does); int16 and
complex entry.  Bounds: tests/test_chain_batched.py:58-69 (audio 2e-4 absolute,
SAM 2e-3 of its scale; spectra and S-meter 0.1 dB; squelch equal; every
state leaf 1e-4, phases modulo 2 pi), RDS soft symbols 1e-3 of their scale
and timing equal (tests/test_torch_rds.py).  FMN's step() audio is not
compared (its first block discriminates the front FIR's fill from a zero
state: rounding noise in either package).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import scanops
from test_torch_wfm_mono import fm_plane

KS = (3, 5)
AUTO = dict(enable_iq_balance="auto")


def imbalance(plane: np.ndarray) -> np.ndarray:
    """A receiver-style IQ imbalance on a packed plane: I x 1.06, 0.08 of
    I leaked into Q."""
    c = plane.shape[1] // 2
    i = plane[:, :c].copy()
    plane[:, :c] = 1.06 * i
    plane[:, c:] += 0.08 * i
    return plane


def am_plane(n: int):
    def plane(k, seed):
        t = np.arange(k * n) / tp.FS
        sig = (np.exp(2j * np.pi * (tp.TUNE + 300.0) * t) * 0.5
               * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2)
        x = np.stack([sig * (0.5 + 0.2 * i) for i in range(tp.C)], axis=1)
        rng = np.random.default_rng(seed)
        x = x + 1e-2 * (rng.standard_normal(x.shape)
                        + 1j * rng.standard_normal(x.shape))
        return imbalance(np.concatenate([x.real, x.imag], axis=1)
                         .astype(np.float32))
    return plane


def tone_plane(k, seed):
    return imbalance(tp.tone_plane(k, seed, 1500.0))


# name -> (mode, receiver options, plane(k, seed), frames)
CASES = {
    "am auto": (DemodMode.AM, AUTO, am_plane(tp.N), tp.N),
    "usb auto": (DemodMode.USB, AUTO, tone_plane, tp.N),
    "sam auto": (DemodMode.SAM, AUTO, am_plane(tp.N), tp.N),
    "fmn auto": (DemodMode.FMN, AUTO, tone_plane, tp.N),
    "am dc off": (DemodMode.AM, dict(enable_dc_removal=False),
                  am_plane(tp.N), tp.N),
    "am auto nb1": (DemodMode.AM, dict(AUTO, enable_noise_blanker=True),
                    am_plane(tp.N), tp.N),
    "usb auto nb2": (DemodMode.USB, dict(AUTO,
                                         enable_noise_blanker="average"),
                     tone_plane, tp.N),
    "am auto 3840": (DemodMode.AM, AUTO, am_plane(3840), 3840),
    "am auto anf": (DemodMode.AM, dict(AUTO, enable_anf=True),
                    am_plane(tp.N), tp.N),
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    mode, opts, plane, n = CASES[request.param]
    res = tp.run(mode, plane, KS, kw=dict(tp.KW, frames_per_buffer=n),
                 jit=True, **opts)
    return request.param, mode, opts, n, res


def _angles(mode, opts, n):
    if mode != DemodMode.SAM:
        return ()
    rx = Receiver(ReceiverConfig(mode=mode, **dict(tp.KW,
                                                  frames_per_buffer=n),
                                 **opts), "cpu")
    return (tp.leaf_index(rx.init_state(), "demod", "aim"),)


@pytest.mark.parametrize("run", ["step", *KS])
def test_staged_receiver_outputs(runs, run):
    name, mode, opts, n, res = runs
    jo, to, _, _ = res[run]
    if not (mode == DemodMode.FMN and run == "step"):
        tp.check_audio(jo, to, **(dict(tol=2e-3, rel=True)
                                  if mode == DemodMode.SAM else {}))
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    if run == KS[-1]:
        assert float(to["audio"].abs().max()) > 1e-3, name


@pytest.mark.parametrize("run", KS)
def test_staged_receiver_state(runs, run):
    name, mode, opts, n, res = runs
    _, _, js, ts = res[run]
    tp.check_state(js, ts, _angles(mode, opts, n))


def test_staged_state_layout():
    """JAX's staged layout: dc [C] complex64, decim one [C, T-1] complex64
    tail per halfband stage, nb a NoiseBlankerChunkedState, iqbal.w [C]
    complex64; the fused layout where JAX's front_ok holds."""
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **tp.KW, **AUTO,
                                 enable_noise_blanker=True), "cpu")
    assert rx.staged and rx.front is None
    st = rx.init_state()
    assert st.dc.shape == (tp.C,) and st.dc.dtype == torch.complex64
    assert [tuple(d.shape) for d in st.decim] == [
        (tp.C, len(s.taps) - 1) for s in rx.plan.stages]
    assert isinstance(st.nb, scanops.NoiseBlankerChunkedState)
    assert st.nb.spike_tail.shape == (tp.C, 6)
    assert st.iqbal.w.shape == (tp.C,) and st.iqbal.w.dtype == torch.complex64
    for opts in (dict(enable_iq_balance=True), dict(enable_noise_blanker=True),
                 {}):
        fused = Receiver(ReceiverConfig(mode=DemodMode.AM, **tp.KW, **opts),
                         "cpu")
        assert not fused.staged and fused.init_state().iqbal is None
    assert Receiver(ReceiverConfig(mode=DemodMode.AM, **tp.KW,
                                   enable_dc_removal=False), "cpu").staged


@pytest.mark.parametrize("entry", ["int16", "complex"])
def test_staged_entry_forms(entry):
    """The staged front takes an int16 plane (read as x 2^-15) and [K, C,
    N] / [C, K*N] complex64 as the packed float32 plane."""
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **tp.KW, **AUTO), "cpu")
    p = rx.default_params(tp.TUNE)
    plane = am_plane(tp.N)(3, 1)
    if entry == "int16":
        q = np.clip(np.round(plane * 16384.0), -32768, 32767).astype(np.int16)
        ref_in = torch.from_numpy(q.astype(np.float32) / 32768.0)
        forms = [torch.from_numpy(q)]
    else:
        ref_in = torch.from_numpy(plane)
        z = torch.complex(ref_in[:, :tp.C].T, ref_in[:, tp.C:].T)  # [C, KN]
        forms = [z, z.reshape(tp.C, 3, tp.N).transpose(0, 1)]
    _, ref = rx.step_many(rx.init_state(), p, ref_in)
    for x in forms:
        _, out = rx.step_many(rx.init_state(), p, x)
        for key in ("audio", "spectrum", "zoomed"):
            assert torch.equal(out[key], ref[key]), (entry, key)


# FMM + RDS at 32768-frame blocks (whole symbols per block), K = 3

@pytest.fixture(scope="module")
def rds_run():
    n = 32768
    return tp.run(DemodMode.FMM,
                  lambda k, s: imbalance(fm_plane(k, s, n=n, rds=True)),
                  (3,), kw=dict(tp.KW, frames_per_buffer=n), jit=True,
                  rds=True, **AUTO)


def test_staged_fmm_rds(rds_run):
    """The RDS symbol timing updates per block, as JAX's per-block path."""
    jo, to, js, ts = rds_run[3]
    tp.check_audio(jo, to)
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    soft_j, soft_t = np.asarray(jo["rds_soft"]), to["rds_soft"].numpy()
    assert soft_t.shape == (3, tp.C, 19)
    scale = float(np.abs(soft_j).max())
    assert scale > 1e-3
    assert np.abs(soft_j - soft_t).max() < 1e-3 * scale
    assert np.array_equal(np.asarray(jo["rds_timing"]),
                          to["rds_timing"].numpy())
    tp.check_state(js, ts)


# FMS stereo on the staged front and taps=True run now (the stereo tail
# without K2; TestBench's taps): their cases are held to the JAX package's
# per-block staged path (match None; the ids keep the cases' names)
@pytest.mark.parametrize("kw,match", [
    (dict(mode=DemodMode.FMS, **AUTO), None),
    (dict(mode=DemodMode.AM, taps=True), None),
    (dict(mode=DemodMode.AM, frames_per_buffer=8192 + 32, **AUTO),
     "multiple"),
    (dict(mode=DemodMode.AM, frames_per_buffer=3840, **AUTO,
          enable_noise_blanker=True), "chunks")],
    ids=["kw0-FMS stereo on the staged front", "kw1-taps=True",
         "kw2-multiple", "kw3-chunks"])
def test_staged_refusals_named(kw, match):
    if match is None and kw.get("taps"):
        # the staged taps against JAX's, within this file's bounds
        res = tp.check_run(DemodMode.AM, am_plane(tp.N), (3,), taps=True)
        for key in ("step", 3):
            jo, to = res[key][:2]
            assert set(jo["taps"]) == set(to["taps"]) == {
                "raw_iq", "post_mixer", "post_bp", "post_demod"}
            for name, a in jo["taps"].items():
                a, b = np.asarray(a), to["taps"][name].numpy()
                assert a.shape == b.shape and np.abs(a - b).max() < 2e-4, name
        return
    if match is None:
        import test_torch_wfm_stereo_tail as stail
        stail.test_receiver_fms_staged_matches_jax()
        return
    with pytest.raises(ValueError, match=match):
        Receiver(ReceiverConfig(**{**tp.KW, **kw}), "cpu")


def test_staged_refuses_folded_planes():
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **tp.KW, **AUTO), "cpu")
    with pytest.raises(ValueError, match="folded"):
        rx.step_many(rx.init_state(), rx.default_params(),
                     torch.zeros(tp.N, 4 * tp.C))
