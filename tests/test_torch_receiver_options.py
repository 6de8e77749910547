"""The port's Receiver with the front-end options on, against the JAX
Receiver(use_pallas=True) on the CPU: NB1 + static IQ balance and NB2 on AM,
NB1 on FM stereo, int16 and time-folded entry planes.

As in tests/test_torch_receiver.py, one JAX step() block warms the chain up
(compared against the port's step()), its state (the blanker's carried
average and spike tail included) is carried into the port with
utils.convert, and a dispatch of K=3 blocks is compared with the bounds of
tests/test_chain_batched.py:58-69: audio 2e-4 absolute, spectra and S-meter
0.1 dB, squelch (and pilot lock) equal, every carried state leaf 1e-4
(for FMS the JAX narrow-plane fallback's low-pass history on its last 234
rows, as tests/test_torch_receiver_wfm.py explains).
Before each blanker run the test asserts, from the port's plain front
intermediates, that no sample sits within 0.1 % of the spike threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import front
from pebblesdr_tpu_torch.utils import convert

FS, N, C = 2_048_000, 8192, 4
SPIKES = (100, 511, 2049, 5000, N - 3)


def plane(k, seed, fm=False, c=C, spikes=True, noise=1e-2):
    """[k*N, 2C] packed plane: AM (1 kHz, m=0.8) or FM stereo (L 1 kHz,
    pilot) at 250 kHz, per-channel level, complex noise, and 8+8j impulses
    at chunk and block seams of every block."""
    t = np.arange(k * N) / FS + seed
    if fm:
        lt = np.sin(2 * np.pi * 1000.0 * t)
        th = 2 * np.pi * 19000.0 * t
        comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
        iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t
                                + 2 * np.pi * np.cumsum(75000.0 * comp) / FS))
    else:
        env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
        iq = 0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
    x = np.stack([iq * (0.5 + 0.2 * i) for i in range(c)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + noise * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
    if spikes:
        for b in range(k):
            x[[b * N + p for p in SPIKES]] += 8.0 + 8.0j
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def assert_margin(rx, state, params, x):
    """No sample of this dispatch within 0.1 % of the spike threshold."""
    iq = ((params.iq_gain, params.iq_phase) if rx.cfg.enable_iq_balance
          else (None, None))
    _, z = front.dc_iq_reference(rx.front, front.dequantize(x), state.dc, *iq)
    fl = front.nb_flags(z, rx.nb_params, *state.nb)
    thr2 = np.float32(rx.nb_params[0] ** 2)
    ratio = fl.mag2 / (thr2 * fl.avg.clamp(min=1e-18))
    assert not bool(((ratio >= 0.999) & (ratio <= 1.001)).any())
    assert bool(fl.widened.any())


CASES = {
    "am_nb1_iq": dict(mode="AM", nb=True, iq=True),
    "am_nb2": dict(mode="AM", nb="average"),
    "fms_nb1": dict(mode="FMS", nb=True),
}


def configs(case, **extra):
    opt = CASES[case]
    kw = dict(sample_rate=FS, frames_per_buffer=N, channels=C,
              enable_noise_blanker=opt["nb"],
              enable_iq_balance=opt.get("iq", False), **extra)
    if opt["mode"] == "AM":
        kw["agc_mode"] = "off"   # audio from the first block on
    return (JaxConfig(mode=JaxMode[opt["mode"]], use_pallas=True, **kw),
            ReceiverConfig(mode=DemodMode[opt["mode"]], **kw))


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    case = request.param
    fm = CASES[case]["mode"] == "FMS"
    jcfg, tcfg = configs(case)
    jrx, trx = JaxReceiver(jcfg), Receiver(tcfg, "cpu")
    jp = jrx.default_params(250_000.0)
    if CASES[case].get("iq"):
        jp = dataclasses.replace(jp, iq_gain=jnp.float32(1.04),
                                 iq_phase=jnp.float32(0.015))
    tp = convert.params_from_numpy(trx, jleaves(jp))
    x0 = plane(1, 7, fm)
    assert_margin(trx, trx.init_state(), tp, torch.from_numpy(x0))
    jst, jo = jax.jit(jrx.step)(jrx.init_state(), jp, jnp.asarray(x0))
    tst, to = trx.step(trx.init_state(), tp, torch.from_numpy(x0))
    res = {"step": (jo, to, None, None)}
    tst = convert.state_from_numpy(trx, jleaves(jst))
    x = plane(3, 0, fm)
    assert_margin(trx, tst, tp, torch.from_numpy(x))
    jst, jo = jrx._step_many_impl(jst, jp, jnp.asarray(x))
    tst, to = trx.step_many(tst, tp, torch.from_numpy(x))
    res[3] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))
    return case, res


@pytest.mark.parametrize("run", ["step", 3])
def test_options_match_jax(runs, run):
    case, res = runs
    jo, to, _, _ = res[run]
    a, b = np.asarray(jo["audio"]), to["audio"].numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 2e-4
    assert np.abs(a).max() > 0.05
    for key in ("spectrum", "zoomed"):
        assert np.abs(np.asarray(jo[key]) - to[key].numpy()).max() < 0.1
    assert np.array_equal(np.asarray(jo["overload"]), to["overload"].numpy())
    for key in jo["smeter"]:
        assert np.abs(np.asarray(jo["smeter"][key])
                      - to["smeter"][key].numpy()).max() < 0.1, key
    for key in ("squelch_open", "pilot_locked"):
        if key in jo:
            assert np.array_equal(np.asarray(jo[key]), to[key].numpy())


def test_nb_state_carried_across(runs):
    """The JAX state's nb leaves (avg [1, 2C], spike tail [16, 2C]) land on
    the port's ReceiverState.nb in flatten order, and the dispatch after the
    carry leaves every state leaf, the blanker's included, within 1e-4."""
    case, res = runs
    _, _, js, ts = res[3]
    assert len(js) == len(ts)
    shapes = [a.shape for a in js]
    i = shapes.index((16, 2 * C))
    assert shapes[i - 1] == (1, 2 * C)
    assert np.array_equal(js[i], ts[i])           # undilated flags: exact
    assert js[i].any()
    for n, (a, b) in enumerate(zip(js, ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, n
        if CASES[case]["mode"] == "FMS" and a.shape == (240, 2 * C):
            a, b = a[-234:], b[-234:]         # lp_tail_mono, see docstring
        if a.size:
            d = np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max()
            assert d < 1e-4, (n, d)


def test_int16_entry():
    """int16 planes: the port equals the float32 plane of the same
    dequantised values (tests/test_chain_batched.py:197-227 bounds: audio
    1e-6, spectrum 1e-3 dB), and the JAX Receiver fed the same int16
    plane within the usual bounds."""
    kw = dict(sample_rate=FS, frames_per_buffer=N, channels=C, agc_stride=16)
    x16 = np.clip(np.round(plane(3, 5) * 32768.0 / 8.0), -32768,
                  32767).astype(np.int16)
    xdq = x16.astype(np.float32) / 32768.0
    trx = Receiver(ReceiverConfig(**kw), "cpu")
    tp = trx.default_params(250_000.0)
    _, oi = trx.step_many(trx.init_state(), tp, torch.from_numpy(x16))
    _, of = trx.step_many(trx.init_state(), tp, torch.from_numpy(xdq))
    assert np.abs(oi["audio"].numpy() - of["audio"].numpy()).max() < 1e-6
    assert np.abs(oi["spectrum"].numpy() - of["spectrum"].numpy()).max() < 1e-3
    jrx = JaxReceiver(JaxConfig(mode=JaxMode.AM, use_pallas=True, **kw))
    _, jo = jrx._step_many_impl(jrx.init_state(),
                                jrx.default_params(250_000.0),
                                jnp.asarray(x16))
    assert np.abs(np.asarray(jo["audio"]) - oi["audio"].numpy()).max() < 2e-4
    assert np.abs(np.asarray(jo["spectrum"])
                  - oi["spectrum"].numpy()).max() < 0.1
    _, o1 = trx.step(trx.init_state(), tp, torch.from_numpy(x16[:N]))
    _, o2 = trx.step(trx.init_state(), tp, torch.from_numpy(xdq[:N]))
    assert np.abs(o1["audio"].numpy() - o2["audio"].numpy()).max() < 1e-6


def test_folded_entry_plane():
    """A plane folded by G=4 at C=2 (pallas_kernels.fold_plane_np, what TPU
    feeders ship) gives the unfolded plane's results, and the JAX Receiver's
    for the same folded plane (tests/test_chain_batched.py:181-194)."""
    c, k = 2, 4
    kw = dict(sample_rate=FS, frames_per_buffer=N, channels=c, agc_stride=16)
    x = plane(k, 6, c=c, spikes=False)
    xf = pk.fold_plane_np(x, 4)
    assert xf.shape == (N, 16)
    trx = Receiver(ReceiverConfig(**kw), "cpu")
    tp = trx.default_params(250_000.0)
    st_f, of = trx.step_many(trx.init_state(), tp, torch.from_numpy(xf))
    st_u, ou = trx.step_many(trx.init_state(), tp, torch.from_numpy(x))
    for key in ("audio", "spectrum", "zoomed"):
        assert torch.equal(of[key], ou[key])
    for a, b in zip(convert.state_to_numpy(st_f), convert.state_to_numpy(st_u)):
        assert np.array_equal(a, b)
    jrx = JaxReceiver(JaxConfig(mode=JaxMode.AM, use_pallas=True, **kw))
    _, jo = jrx._step_many_impl(jrx.init_state(),
                                jrx.default_params(250_000.0), jnp.asarray(xf))
    a = np.asarray(jo["audio"])
    assert a.shape == tuple(of["audio"].shape)
    assert np.abs(a - of["audio"].numpy()).max() < 2e-4
    for key in ("spectrum", "zoomed"):
        assert np.abs(np.asarray(jo[key]) - of[key].numpy()).max() < 0.1


def test_adaptive_iq_balance_raises():
    """enable_iq_balance="auto" no longer raises: the adaptive loop runs on
    the staged front (K5 on a card, its plain version here) and matches
    the JAX Receiver's per-block path (torch_parity.check_run's bounds)."""
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                 channels=C, enable_iq_balance="auto"), "cpu")
    assert rx.staged and rx.init_state().iqbal is not None
    tp.check_run(DemodMode.AM, lambda k, s: tp.tone_plane(k, s, 300.0,
                                                           am=True),
                 enable_iq_balance="auto")


def test_blanker_brings_audio_closer_to_clean():
    """NB-on audio is much closer to the spike-free chain's audio than
    NB-off audio (tests/test_chain_pallas.py:73-105); block 0 is skipped,
    since the blanker's average starts at zero and blanks its first chunk."""
    c, k = 2, 4
    kw = dict(sample_rate=FS, frames_per_buffer=N, channels=c, agc_mode="off")
    res = {}
    for name, nb_on, spikes in (("clean", False, False), ("spiky", False, True),
                                ("nb", True, True)):
        rx = Receiver(ReceiverConfig(enable_noise_blanker=nb_on, **kw), "cpu")
        x = torch.from_numpy(plane(k, 2, c=c, spikes=spikes, noise=1e-3))
        _, out = rx.step_many(rx.init_state(), rx.default_params(250_000.0), x)
        res[name] = out["audio"][1:].numpy()
    err_nb = np.sqrt(np.mean((res["nb"] - res["clean"]) ** 2))
    err_off = np.sqrt(np.mean((res["spiky"] - res["clean"]) ** 2))
    assert err_nb < 0.5 * err_off, (err_nb, err_off)
