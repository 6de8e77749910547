"""Shared harness of the receiver parity tests (test_torch_ssb.py,
test_torch_sam.py, test_torch_narrow.py, test_torch_nfm.py,
test_torch_ctcss.py, test_torch_agc_anf.py, test_torch_wfm_mono.py,
test_torch_sam_scan.py, test_torch_rds_scan.py, test_torch_pll_scan.py,
test_torch_nfm_pll.py, test_torch_wfm_stereo_tail.py): the
port's CPU Receiver against the JAX Receiver built with use_pallas=True (the
fused front in interpret mode, batched step_many), as
tests/test_chain_batched.py does.  One JAX step() warms the chain up
(compared with the port's step()), its state is carried into the port with
utils.convert, then dispatches of K blocks (odd K keeps the JAX time-fold
at 1 for C = 4) are compared with the bounds of
tests/test_chain_batched.py:58-69."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.utils import convert

FS, N, C = 2_048_000, 8192, 4
TUNE = 250_000.0
KW = dict(sample_rate=FS, frames_per_buffer=N, channels=C, agc_stride=16)


def tone_plane(k: int, seed: int, offset_hz: float, am: bool = False,
               noise: float = 1e-2) -> np.ndarray:
    """[k*N, 2C] packed plane: a tone at TUNE + offset_hz (am: a carrier
    there with 1 kHz AM, m = 0.8, instead), per-channel level, plus complex
    white noise."""
    t = np.arange(k * N) / FS
    sig = np.exp(2j * np.pi * (TUNE + offset_hz) * t)
    if am:
        sig = sig * 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    else:
        sig = 0.3 * sig
    x = np.stack([sig * (0.5 + 0.2 * i) for i in range(C)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + noise * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def receivers(mode: DemodMode, kw: dict):
    """The JAX Receiver (use_pallas=True) and the port's CPU Receiver of one
    configuration, with the JAX default params tuned to TUNE and the
    port's params carried from them: (jrx, trx, jax params, port
    params)."""
    jrx = JaxReceiver(JaxConfig(mode=JaxMode[mode.name], use_pallas=True,
                                **kw))
    trx = Receiver(ReceiverConfig(mode=mode, **kw), "cpu")
    jp = jrx.default_params(TUNE)
    return jrx, trx, jp, convert.params_from_numpy(trx, jleaves(jp))


def circ(a, b) -> float:
    """Largest angle between two phase arrays on the circle (the angle of
    e^{j(a - b)}: a wrap to [-pi, pi) may round across +-pi on different
    steps in the two packages)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.abs(np.angle(np.exp(1j * d))).max(initial=0.0))


def run(mode: DemodMode, plane, ks=(3,), twins=None, kw=None,
        jit: bool = False, jcfg=None, **cfg):
    """{"step": (jax out, port out, None, None), K: (jax out, port out,
    jax state leaves, port state leaves)} for the mode, plane(k, seed)
    giving each dispatch's input.  twins: {name: (mode, cfg)} of further
    port receivers that the JAX package builds the same as this one (FMS
    with stereo=False and FMM); each is fed the same inputs and states and
    its results are under res[name] in the same form.  kw replaces KW.
    jit: run JAX's _step_many_impl jitted (one compile per K, several
    times faster on the CPU than its op-by-op dispatch).  jcfg: options of
    the JAX ReceiverConfig alone (batched_many=False: its per-block
    path)."""
    kw = KW if kw is None else kw
    jrx = JaxReceiver(JaxConfig(mode=JaxMode[mode.name], use_pallas=True,
                                **kw, **cfg, **(jcfg or {})))
    ports = {None: (mode, cfg), **(twins or {})}
    trxs = {name: Receiver(ReceiverConfig(mode=m, **kw, **c), "cpu")
            for name, (m, c) in ports.items()}
    jp = jrx.default_params(TUNE)
    tps = {name: convert.params_from_numpy(trx, jleaves(jp))
           for name, trx in trxs.items()}
    x0 = plane(1, 7)
    jst, jo = jax.jit(jrx.step)(jrx.init_state(), jp, jnp.asarray(x0))
    res = {name: {} for name in ports}
    tst = {}
    for name, trx in trxs.items():
        _, to = trx.step(trx.init_state(), tps[name], torch.from_numpy(x0))
        res[name]["step"] = (jo, to, None, None)
        tst[name] = convert.state_from_numpy(trx, jleaves(jst))
    step_many = jax.jit(jrx._step_many_impl) if jit else jrx._step_many_impl
    for i, k in enumerate(ks):
        x = plane(k, i)
        jst, jo = step_many(jst, jp, jnp.asarray(x))
        for name, trx in trxs.items():
            tst[name], to = trx.step_many(tst[name], tps[name],
                                          torch.from_numpy(x))
            res[name][k] = (jo, to, jleaves(jst),
                            convert.state_to_numpy(tst[name]))
    out = res.pop(None)
    out.update(res)
    return out


def check_audio(jo, to, tol: float = 2e-4, rel: bool = False) -> float:
    """Audio within tol absolute (rel: of the JAX audio's scale); returns
    the scale."""
    a, b = np.asarray(jo["audio"]), to["audio"].numpy()
    assert a.shape == b.shape
    scale = max(float(np.abs(a).max()), 1e-6)
    assert np.abs(a - b).max() < tol * (scale if rel else 1.0)
    return scale


def check_spectra(jo, to) -> None:
    for key in ("spectrum", "zoomed"):
        a, b = np.asarray(jo[key]), to[key].numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 0.1, key
    assert np.array_equal(np.asarray(jo["overload"]), to["overload"].numpy())


def check_smeter_and_squelch(jo, to) -> None:
    assert set(jo["smeter"]) == set(to["smeter"])
    for key in jo["smeter"]:
        assert np.abs(np.asarray(jo["smeter"][key])
                      - to["smeter"][key].numpy()).max() < 0.1, key
    assert np.array_equal(np.asarray(jo["squelch_open"]),
                          to["squelch_open"].numpy())


def leaf_index(state, *path) -> int:
    """The index of the leaf at field path `path` of the port state in the
    flatten order (convert.leaves)."""
    i = 0
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == path[0]:
            return i + (leaf_index(v, *path[1:]) if path[1:] else 0)
        i += len(convert.leaves(v))
    raise KeyError(path)


def check_state(js, ts, angles=()) -> None:
    """Every carried leaf within 1e-4; the leaves at indices `angles`
    (phases) compared modulo 2 pi."""
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
        if i in angles:
            d = np.abs(np.angle(np.exp(1j * (a.astype(np.float64)
                                              - b.astype(np.float64)))))
        assert d.max(initial=0.0) < 1e-4, (i, d.max())


def tone_fit(x: np.ndarray, f: float, fs: float):
    """Least-squares amplitude of a tone at f in x, and the residual."""
    t = np.arange(len(x)) / fs
    m = np.stack([np.cos(2 * np.pi * f * t), np.sin(2 * np.pi * f * t),
                  np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(m, x, rcond=None)
    return float(np.hypot(coef[0], coef[1])), x - m @ coef


def check_run(mode: DemodMode, plane, ks=(3,), kw=None, jcfg=None,
              **cfg) -> dict:
    """run() and every bound of tests/test_chain_batched.py:58-69 on each
    dispatch: audio 2e-4 (SAM 2e-3 of its scale; FMN's step() audio, the
    front FIR's fill from a zero state, not compared), spectra and S-meter
    0.1 dB, squelch equal, every state leaf 1e-4 (SAM's aim phase on the
    circle).  jcfg: run()'s.  Returns run()'s results."""
    res = run(mode, plane, ks, kw=kw, jit=True, jcfg=jcfg, **cfg)
    sam = mode == DemodMode.SAM
    angles = ()
    if sam:
        trx = Receiver(ReceiverConfig(mode=mode, **(KW if kw is None else kw),
                                      **cfg), "cpu")
        angles = (leaf_index(trx.init_state(), "demod", "aim"),)
    for key in ("step", *ks):
        jo, to, js, ts = res[key]
        if not (mode == DemodMode.FMN and key == "step"):
            check_audio(jo, to, **(dict(tol=2e-3, rel=True) if sam else {}))
        check_spectra(jo, to)
        check_smeter_and_squelch(jo, to)
        if js is not None:
            check_state(js, ts, angles)
    return res
