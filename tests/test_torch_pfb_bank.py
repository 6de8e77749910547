"""The port's dense filterbank bank (chain/pfb_bank.py) against the JAX
package on the CPU, mirroring tests/test_pfb_bank.py:44-248 (without its
sharded form): the bank size, the trivial front (the JAX package's batched
path: filterbank once over the dispatch, channel gather, residual mix,
the batched tail) and the non-trivial fronts (the JAX package's per-block
path: oversample=2, whose channel rate still decimates; DC removal on;
adaptive IQ balance), all through the tail Receiver's staged front, FMM
with RDS on the trivial front (its symbol timing once per call, as the
JAX package's batched tail), plane input against complex input, retune
(same Receiver, new channels and residuals), the residual bound, and
step_many against steps.

Each dispatch: 3 (then 5) blocks of 16384 samples at 1.024 Msps, AM
stations on bank channels and one off the grid, in complex noise at 1e-2
(the display spectra's lowest bins then sit ~90 dB down, where float32
rounding in another association order moves them far less than 0.1 dB).
Bounds: tests/test_chain_batched.py:58-69 (audio 2e-4 absolute, spectra
and S-meter 0.1 dB, squelch equal, every state leaf 1e-4, the JAX state
carried into the port with utils.convert between dispatches); steps
against step_many 1e-5 (tests/test_pfb_bank.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.chain.pfb_bank import PfbBankReceiver as JaxBank
from pebblesdr_tpu.chain.pfb_bank import pick_bank_size as jax_pick
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver, pick_bank_size
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import pfb
from pebblesdr_tpu_torch.utils import convert

FS, FRAMES = 1_024_000, 16384


def capture(tunes, n, seed, t0=0.0):
    """AM stations (1 kHz, m = 0.8) at tunes, in complex noise at 1e-2."""
    t = t0 + np.arange(n) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = sum(0.4 * env * np.exp(2j * np.pi * f * t) for f in tunes)
    rng = np.random.default_rng(seed)
    iq = iq + 1e-2 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64)


def banks(m, tunes, **kw):
    jb = JaxBank(FS, FRAMES, tunes, mode=JaxMode.AM, n_bank=m, **kw)
    tb = PfbBankReceiver(FS, FRAMES, tunes, mode=DemodMode.AM, n_bank=m,
                         device="cpu", **kw)
    return jb, tb


def compare(jo, to, jl, ts):
    """Outputs and every state leaf (jl: the JAX state's leaves)."""
    tp.check_audio(jo, to)
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    tp.check_state(jl, convert.state_to_numpy(ts))


@pytest.mark.parametrize("fs", [2_048_000, 512_000, 8_192_000, 1_024_000])
def test_pick_bank_size(fs):
    assert pick_bank_size(fs) == jax_pick(fs)
    assert 16000 <= fs / pick_bank_size(fs) <= 64000


# name -> (bank size, station channels, receiver options, RDS per call)
CASES = {
    "trivial": (64, [3, 10, 59], {}, True),
    "oversample2": (16, [3, 7], dict(oversample=2), False),
    "dc removal": (64, [2, 6], dict(enable_dc_removal=True), False),
    "iq auto": (64, [5, 40], dict(enable_iq_balance="auto"), False),
}


@pytest.fixture(scope="module", params=list(CASES))
def bank_runs(request):
    m, chans, kw, per_call = CASES[request.param]
    centers = pfb.channel_freqs(pfb.plan(FS, m, os=kw.get("oversample", 1)))
    tunes = centers[chans] + np.r_[0.0, 1000.0, -500.0][:len(chans)]
    jb, tb = banks(m, tunes, agc_stride=16, **kw)
    assert tb.rds_per_call == per_call
    js, ts = jb.init_state(), tb.init_state()
    res, t0 = [], 0.0
    for i, k in enumerate((3, 5)):
        x = capture(tunes, k * FRAMES, i, t0)
        t0 += k * FRAMES / FS
        js, jo = jb.step_many(js, jnp.asarray(x))
        ts, to = tb.step_many(ts, torch.from_numpy(x))
        # JAX donates the state to the next dispatch: keep its leaves
        jl = tp.jleaves(js)
        res.append((k, jax.tree_util.tree_map(np.asarray, jo), to, jl, ts))
        # carry JAX's state into the port for the next dispatch
        ts = convert.state_from_numpy(tb, jl)
    return request.param, tb, res


@pytest.mark.parametrize("dispatch", [0, 1])
def test_bank_matches_jax(bank_runs, dispatch):
    name, tb, res = bank_runs
    k, jo, to, js, ts = res[dispatch]
    assert to["audio"].shape == (k, len(tb.chan_idx), tb.rx.audio_blk)
    compare(jo, to, js, ts)
    if dispatch:
        assert float(to["audio"].abs().max()) > 0.05, name


def test_trivial_bank_takes_the_batched_tail():
    """The trivial front: the tail Receiver at 16 kHz has no decimation
    stage and no DC blocker, runs on the staged front (nothing of it but
    the residual mix) into the batched tail, with the JAX package's batched
    cadence (RDS timing once per call)."""
    _, tb = banks(64, pfb.channel_freqs(pfb.plan(FS, 64))[[3]])
    assert tb.ch_rate == 16000 and tb.rx.cfg.frames_per_buffer == 256
    assert tb.rx.staged and len(tb.rx.plan.stages) == 0
    assert not tb.rx.cfg.enable_dc_removal and tb.rds_per_call
    assert tb.rx.cfg.spectrum_bins == 256


def test_step_many_matches_steps():
    tunes = np.array([100_000.0, -200_000.0])
    _, tb = banks(64, tunes, agc_mode="off")
    x = torch.from_numpy(capture(tunes, 4 * FRAMES, 3))
    st, seq = tb.init_state(), []
    for i in range(4):
        st, out = tb.step(st, x[i * FRAMES:(i + 1) * FRAMES], spectra=False)
        seq.append(out["audio"])
    _, outs = tb.step_many(tb.init_state(), x, spectra=False)
    assert float((outs["audio"] - torch.stack(seq)).abs().max()) < 1e-5


def test_plane_input_matches_complex():
    tunes = np.array([100_000.0])
    _, tb = banks(64, tunes, agc_mode="off")
    iq = capture(tunes, FRAMES, 4)
    _, out_c = tb.step(tb.init_state(), torch.from_numpy(iq))
    plane = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    _, out_p = tb.step(tb.init_state(), torch.from_numpy(plane))
    for key in ("audio", "spectrum", "zoomed"):
        assert torch.equal(out_p[key], out_c[key])


def test_retune_keeps_the_receiver_and_matches_jax():
    """retune: new channels and residuals, the same tail Receiver; the next
    dispatch matches the JAX bank retuned the same way."""
    tunes = np.array([100_000.0, -200_000.0])
    jb, tb = banks(64, tunes, agc_mode="off")
    rx = tb.rx
    x = capture(tunes, 2 * FRAMES, 5)
    js, _ = jb.step_many(jb.init_state(), jnp.asarray(x))
    ts, _ = tb.step_many(tb.init_state(), torch.from_numpy(x))
    new = np.array([250_000.0, -400_000.0])
    jb.retune(new)
    tb.retune(new)
    assert tb.rx is rx
    assert np.array_equal(tb.chan_idx, jb.chan_idx)
    assert np.allclose(tb.residuals, jb.residuals)
    x = capture(new, 2 * FRAMES, 6, 2 * FRAMES / FS)
    js, jo = jb.step_many(js, jnp.asarray(x))
    ts, to = tb.step_many(ts, torch.from_numpy(x))
    compare(jo, to, tp.jleaves(js), ts)
    with pytest.raises(ValueError, match="stations"):
        tb.retune(np.array([1000.0]))


def test_residual_bound():
    tunes = np.array([123_456.0, -7_777.0, 511_000.0])
    _, tb = banks(64, tunes)
    assert np.all(np.abs(tb.residuals) <= FS / (2 * 64) + 1e-6)
    centers = pfb.channel_freqs(tb.pfb_plan)
    back = (centers[tb.chan_idx] + tb.residuals + FS / 2) % FS - FS / 2
    assert np.allclose(back, (tunes + FS / 2) % FS - FS / 2)


def test_fmm_rds_bank_matches_jax():
    """FMM with RDS at 2.048 Msps through an 8-channel bank (256 kHz
    channels, an empty plan: the trivial front), two FM stations with a
    1 kHz tone and a 57 kHz biphase subcarrier, dispatches of 2 then 3
    blocks of 32768: the bounds above, and the RDS soft symbols within
    1e-3 of their scale and the symbol timing equal (the JAX package's
    batched tail updates it once per call)."""
    fs, n, m = 2_048_000, 32768, 8
    tunes = pfb.channel_freqs(pfb.plan(fs, m))[[1, 3]] + np.r_[0.0, 5000.0]
    kw = dict(n_bank=m, rds=True, agc_stride=16)
    jb = JaxBank(fs, n, tunes, mode=JaxMode.FMM, **kw)
    tb = PfbBankReceiver(fs, n, tunes, mode=DemodMode.FMM, device="cpu", **kw)
    assert tb.rds_per_call and len(tb.rx.plan.stages) == 0
    rng = np.random.default_rng(15)
    js, ts, t0 = jb.init_state(), tb.init_state(), 0.0
    for k in (2, 3):
        t = t0 + np.arange(k * n) / fs
        t0 += k * n / fs
        msg = (0.3 * np.sin(2 * np.pi * 1000.0 * t) + 0.05
               * np.cos(2 * np.pi * 57000.0 * t)
               * np.sign(np.sin(2 * np.pi * 1187.5 * t)))
        ph = 2 * np.pi * 75000.0 * np.cumsum(msg) / fs
        x = sum(0.4 * np.exp(1j * (2 * np.pi * f * t + ph)) for f in tunes)
        x = x + 1e-2 * (rng.standard_normal(len(t))
                        + 1j * rng.standard_normal(len(t)))
        x = x.astype(np.complex64)
        js, jo = jb.step_many(js, jnp.asarray(x))
        ts, to = tb.step_many(ts, torch.from_numpy(x))
        jl = tp.jleaves(js)
        jo = jax.tree_util.tree_map(np.asarray, jo)
        compare(jo, to, jl, ts)
        soft_j, soft_t = jo["rds_soft"], to["rds_soft"].numpy()
        assert soft_t.shape == (k, 2, 19)
        scale = float(np.abs(soft_j).max())
        assert scale > 1e-3
        assert np.abs(soft_j - soft_t).max() < 1e-3 * scale
        assert np.array_equal(jo["rds_timing"], to["rds_timing"].numpy())
        ts = convert.state_from_numpy(tb, jl)
