"""The WFM-stereo receiver of the PyTorch port against the JAX Receiver on the
CPU.

The JAX reference is built with use_pallas=True, so both carry the fused
front's and the fused stereo tail's state layout.  Two geometries:

  * C=4 (N=8192): one step() block warms the chain up and its state is
    carried into the port, then dispatches of K=3 and K=9 blocks.  Here the
    JAX Receiver takes its narrow-plane fallback (the XLA discriminator and
    the XLA low-pass, pebblesdr_tpu/demod/wfm.py:533-562); the port runs its
    one path.  That fallback keeps only the last T-1 = 234 rows of the
    packed low-pass history and leaves the 6 rows above them zero (they have
    zero weight in the filter), so lp_tail_mono is compared on its last 234
    rows.
  * C=64 (N=8192): one dispatch of K=2 blocks from the initial state.  Here
    the JAX Receiver runs the time-major path through the front end's
    discriminator and y-tail switches and the fused stereo tail (the Pallas
    kernels in interpret mode, about 13 s), and every leaf is compared.

Bounds of tests/test_chain_batched.py:58-69: audio 2e-4 absolute; spectra,
zoomed and S-meter 0.1 dB; squelch and pilot_locked equal; state 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.utils import convert

FS, N = 2_048_000, 8192
LP_TAIL_LEAF = 20          # WFMState.lp_tail_mono in the flattened state
LP_TAPS = 235


def kw(c):
    return dict(sample_rate=FS, frames_per_buffer=N, channels=c,
                mode=DemodMode.FMS)


def jkw(c):
    """kw(c) for the JAX Receiver, which takes its own mode enum."""
    return dict(kw(c), mode=JaxMode.FMS)


def fm_plane(c: int, k: int, seed: int) -> np.ndarray:
    """[k*N, 2C] packed plane: FM stereo at 250 kHz (L 1 kHz, R 400 Hz,
    pilot), per-channel level 0.3..0.7, complex white noise at 1e-2."""
    t = np.arange(k * N) / FS + seed
    lt, rt = np.sin(2 * np.pi * 1000.0 * t), np.sin(2 * np.pi * 400.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = (0.45 * (lt + rt) / 2 + 0.1 * np.sin(th)
            + 0.45 * (lt - rt) / 2 * np.sin(2 * th))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
    x = np.stack([iq * (0.3 + 0.4 * i / c) for i in range(c)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def runs():
    res = {}
    jrx = JaxReceiver(JaxConfig(use_pallas=True, **jkw(4)))
    trx = Receiver(ReceiverConfig(**kw(4)), "cpu")
    jp = jrx.default_params(250_000.0)
    tp = convert.params_from_numpy(trx, jleaves(jp))
    x0 = fm_plane(4, 1, 7)
    jst, jo = jax.jit(jrx.step)(jrx.init_state(), jp, jnp.asarray(x0))
    tst, to = trx.step(trx.init_state(), tp, torch.from_numpy(x0))
    res["step"] = (jo, to, None, None)
    tst = convert.state_from_numpy(trx, jleaves(jst))
    for k, seed in ((3, 0), (9, 1)):
        x = fm_plane(4, k, seed)
        jst, jo = jrx._step_many_impl(jst, jp, jnp.asarray(x))
        tst, to = trx.step_many(tst, tp, torch.from_numpy(x))
        res[k] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))

    jrx = JaxReceiver(JaxConfig(use_pallas=True, **jkw(64)))
    trx = Receiver(ReceiverConfig(**kw(64)), "cpu")
    jp = jrx.default_params(250_000.0)
    tp = convert.params_from_numpy(trx, jleaves(jp))
    x = fm_plane(64, 2, 3)
    jst, jo = jrx._step_many_impl(jrx.init_state(), jp, jnp.asarray(x))
    tst, to = trx.step_many(trx.init_state(), tp, torch.from_numpy(x))
    res["c64"] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))
    return res


RUNS = ["step", 3, 9, "c64"]


@pytest.mark.parametrize("run", RUNS)
def test_audio(runs, run):
    jo, to, _, _ = runs[run]
    a, b = np.asarray(jo["audio"]), to["audio"].numpy()
    assert a.shape == b.shape
    assert a.shape[-2] == 2                 # left, right
    assert np.abs(a - b).max() < 2e-4
    assert np.abs(a).max() > 0.1            # the compared audio is not silence


@pytest.mark.parametrize("key", ["spectrum", "zoomed"])
@pytest.mark.parametrize("run", RUNS)
def test_spectra(runs, run, key):
    jo, to, _, _ = runs[run]
    a, b = np.asarray(jo[key]), to[key].numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 0.1
    assert np.array_equal(np.asarray(jo["overload"]), to["overload"].numpy())


@pytest.mark.parametrize("run", RUNS)
def test_smeter_squelch_and_pilot(runs, run):
    jo, to, _, _ = runs[run]
    assert set(jo["smeter"]) == set(to["smeter"])
    for key in jo["smeter"]:
        assert np.abs(np.asarray(jo["smeter"][key])
                      - to["smeter"][key].numpy()).max() < 0.1, key
    assert np.array_equal(np.asarray(jo["squelch_open"]),
                          to["squelch_open"].numpy())
    locked = np.asarray(jo["pilot_locked"])
    assert np.array_equal(locked, to["pilot_locked"].numpy())
    assert locked.all()


@pytest.mark.parametrize("run", [3, 9, "c64"])
def test_carried_state(runs, run):
    _, _, js, ts = runs[run]
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if i == LP_TAIL_LEAF and run != "c64":
            # the JAX fallback's packed history: only the last T-1 rows
            # carry weight (see the module docstring)
            a, b = a[-(LP_TAPS - 1):], b[-(LP_TAPS - 1):]
        d = np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max() \
            if a.size else 0.0
        assert d < 1e-4, (i, d)


def test_lp_tail_leaf_is_the_packed_history(runs):
    _, _, js, ts = runs["c64"]
    assert js[LP_TAIL_LEAF].shape == ts[LP_TAIL_LEAF].shape == (240, 128)


def test_receiver_matches_single_blocks():
    """step_many over K blocks == K step() calls (streaming-exact)."""
    c = 2
    rx = Receiver(ReceiverConfig(**kw(c)), "cpu")
    p = rx.default_params(250_000.0)
    x = torch.from_numpy(fm_plane(c, 3, 11))
    st_a, out_a = rx.step_many(rx.init_state(), p, x)
    st_b = rx.init_state()
    for i in range(3):
        st_b, ob = rx.step(st_b, p, x[i * N:(i + 1) * N])
        assert torch.allclose(ob["audio"], out_a["audio"][i], atol=1e-5,
                              rtol=0)
        assert torch.equal(ob["pilot_locked"], out_a["pilot_locked"][i])
    for a, b in zip(convert.state_to_numpy(st_a), convert.state_to_numpy(st_b)):
        assert a.shape == b.shape
        if a.size:
            assert np.abs(a.astype(np.complex128)
                          - b.astype(np.complex128)).max() < 1e-4


def test_squelch_gates_stereo_audio():
    rx = Receiver(ReceiverConfig(**kw(2)), "cpu")
    p = rx.default_params(250_000.0)
    x = torch.from_numpy(fm_plane(2, 2, 4))
    shut = type(p)(**{**p.__dict__, "squelch_db": torch.tensor(200.0)})
    _, out = rx.step_many(rx.init_state(), shut, x)
    assert not bool(out["squelch_open"].any())
    assert out["audio"].shape == (2, 2, 2, rx.audio_blk)
    assert float(out["audio"].abs().max()) == 0.0


# mono WFM, FMM, FMN, the scan RDS carrier and adaptive IQ balance run
# now: change1 and change3 (mono with the scan carrier and "auto", on the
# staged front) are held to the JAX Receiver (what None), the others hold
# what those receivers still refuse, stereo on the staged front among them
# (the ids keep the cases' names)
@pytest.mark.parametrize("change,what", [
    (dict(rds=True, rds_alg="scan", frames_per_buffer=32768,
          enable_iq_balance="auto"), "FMS stereo on the staged front"),
    (dict(wfm_hq=True, stereo=False, rds=True, rds_alg="scan",
          frames_per_buffer=32768, enable_iq_balance="auto"), None),
    (dict(stereo=False, ctcss_tone=123.0), "requires mode=FMN"),
    (dict(mode=DemodMode.FMM, rds=True, rds_alg="scan",
          frames_per_buffer=32768, enable_iq_balance="auto"), None),
    (dict(mode=DemodMode.FMN, ctcss_tone=120.0), "not a CTCSS table tone"),
    (dict(sample_rate=1_536_000, frames_per_buffer=24576), "tail_sub == 0"),
], ids=["change0-scan", "change1-mono", "change2-mono", "change3-FMM",
        "change4-FMN", "change5-tail_sub == 0"])
def test_unported_wfm_configs_named(change, what):
    if what is None:
        # the staged front's mono receiver against JAX's per-block path:
        # one dispatch of 3 blocks (torch_parity.check_run's bounds), the
        # RDS soft symbols 1e-3 of their scale and the timing equal
        import torch_parity as tp
        from test_torch_receiver_staged import imbalance
        from test_torch_wfm_mono import fm_plane
        change = dict(change)
        mode = change.pop("mode", DemodMode.FMS)
        n = change.pop("frames_per_buffer")
        rx = Receiver(ReceiverConfig(**{**kw(2), **change, "mode": mode,
                                        "frames_per_buffer": n}), "cpu")
        assert rx.staged and not rx.wfm_cfg.stereo
        res = tp.check_run(
            mode, lambda k, s: imbalance(fm_plane(k, s, n=n, rds=True)),
            ks=(3,), kw=dict(tp.KW, frames_per_buffer=n), **change)
        jo, to, _, _ = res[3]
        soft_j, soft_t = np.asarray(jo["rds_soft"]), to["rds_soft"].numpy()
        scale = float(np.abs(soft_j).max())
        assert scale > 1e-3
        assert np.abs(soft_j - soft_t).max() < 1e-3 * scale
        assert np.array_equal(np.asarray(jo["rds_timing"]),
                              to["rds_timing"].numpy())
        return
    with pytest.raises(ValueError, match=what):
        Receiver(ReceiverConfig(**{**kw(2), **change}), "cpu")


def test_wfm_geometry_of_the_bench_row():
    """The wfm row of bench.py: factor 8 to 256 kHz, a 283-tap composed
    response, blocks of 4096, zoom 2048, low-pass 235 taps decimating by 4,
    pilot chunk 256, tail sub-block 2048, 768 audio samples per block."""
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=32768,
                                 channels=64, mode=DemodMode.FMS), "cpu")
    assert (rx.plan.factor, rx.front.h.numel(), rx.blk, rx.zoom_bins) == \
        (8, 283, 4096, 2048)
    assert (rx.wfm_tail.factor, rx.wfm_tail.h.numel(), rx.wfm_tail.d_rows,
            rx.wfm_tail.ell, rx.wfm_tail.sub) == (4, 235, 240, 256, 2048)
    assert not rx.wfm_cfg.notch_needed
    assert rx.audio_blk == 768
    assert 0 < rx.front.smem_bytes <= 232448
