"""The CTCSS tone squelch of the PyTorch port against the JAX package on the
CPU.

  * CtcssConfig's tables (DFT rows, phase steps, EWMA coefficient) equal to
    JAX's, at the table's ends and in its middle;
  * ctcss_update (K single-block calls) and ctcss_update_many (one call)
    against JAX's, from a settled state;
  * the FMN + CTCSS Receiver (C = 4: channels 0 and 1 carry the configured
    123.0 Hz, channels 2 and 3 the 127.3 Hz neighbour): from a zero state
    it opens on its tone and stays closed on the neighbour (as
    tests/test_dtmf_ctcss.py:164-200 holds the JAX Receiver); after a JAX
    warm-up carried across, dispatches of K = 3 and 9 blocks of 8192 frames
    give squelch_open and ctcss_open equal to JAX's, audio and state within
    the bounds of tests/test_torch_receiver.py:77-115;
  * ctcss_tone on any other mode, or off the table, raises.

The decision is a threshold (the tone's power against 4 x the larger
neighbour's), so every compared block's ratio is asserted far from 4
first: above 8 or below 1/2, computed from the pre-gate audio of a twin
receiver without the tone squelch.  iq is held within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu.ops import goertzel as jgz
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import goertzel
from pebblesdr_tpu_torch.utils import convert

TONE, NEIGHBOUR = 123.0, 127.3
C, N = tp.C, tp.N
AUDIO_RATE, BLK = 48_000.0, 192       # the Receiver's audio blocks
WARM = (33,) * 5                      # ~0.66 s: the 0.25 s EWMA settles


def tones(c: int) -> list[float]:
    return [TONE if i < c // 2 else NEIGHBOUR for i in range(c)]


def fm_plane(k: int, t0: float) -> np.ndarray:
    """[k*N, 2C] packed plane from time t0: NFM at the tune frequency, a
    1 kHz voice tone at 2.5 kHz deviation plus each channel's sub-tone at
    500 Hz (tones()), per-channel level and phase, noise at 1e-2."""
    t = t0 + np.arange(k * N) / tp.FS
    x = []
    for i, tone in enumerate(tones(C)):
        f = (2500.0 * np.sin(2 * np.pi * 1000.0 * t)
             + 500.0 * np.sin(2 * np.pi * tone * t))
        ph = 2 * np.pi * np.cumsum(f) / tp.FS
        x.append((0.3 + 0.1 * i)
                 * np.exp(1j * (2 * np.pi * tp.TUNE * t + ph + 0.9 * i)))
    x = np.stack(x, axis=1)
    rng = np.random.default_rng(int(t0 * 1e4))
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


def audio_blocks(k: int, seed: int, k0: int = 0) -> np.ndarray:
    """[k, C, BLK] audio from block k0: each channel's sub-tone at 0.1 over
    a 1 kHz voice tone at 0.5, noise at 1e-2."""
    t = (k0 * BLK + np.arange(k * BLK)) / AUDIO_RATE
    rng = np.random.default_rng(seed)
    a = np.stack([0.1 * np.sin(2 * np.pi * tone * t + i)
                  + 0.5 * np.sin(2 * np.pi * 1000.0 * t)
                  for i, tone in enumerate(tones(C))])
    a = a + 1e-2 * rng.standard_normal(a.shape)
    return a.reshape(C, k, BLK).transpose(1, 0, 2).astype(np.float32)


def ratio(iq: np.ndarray) -> np.ndarray:
    """The tone's power over the larger neighbour's, [..., C]."""
    p = (np.asarray(iq, np.float64) ** 2).sum(-1)
    return p[..., 0] / np.maximum(p[..., 1], p[..., 2])


def assert_margin(r: np.ndarray) -> None:
    assert np.all((r > 8.0) | (r < 0.5)), r


@pytest.mark.parametrize("blk", [BLK, 768])
@pytest.mark.parametrize("tone", [67.0, TONE, 250.3])
def test_ctcss_config_identical(tone, blk):
    assert goertzel.CTCSS_TONES == jgz.CTCSS_TONES
    a = jgz.CtcssConfig.make(tone, AUDIO_RATE, blk)
    b = goertzel.CtcssConfig.make(tone, AUDIO_RATE, blk)
    assert (a.tone_hz, a.alpha, a.nb_ratio, a.min_power) == (
        b.tone_hz, b.alpha, b.nb_ratio, b.min_power)
    for key in ("basis_re", "basis_im", "dphi"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert np.array_equal(jgz.dft_vectors([tone, 100.0], AUDIO_RATE, blk),
                          goertzel.dft_vectors([tone, 100.0], AUDIO_RATE, blk))


def test_ctcss_update_matches_jax():
    """From a state settled by 200 blocks (JAX's, carried across), 12
    blocks as single updates and as one K-block update."""
    jc = jgz.CtcssConfig.make(TONE, AUDIO_RATE, BLK)
    tc = goertzel.CtcssConfig.make(TONE, AUDIO_RATE, BLK)
    js, _ = jgz.ctcss_update_many(jc, jgz.ctcss_init(C),
                                  jnp.asarray(audio_blocks(200, 1)))
    ts0 = goertzel.CtcssState(*(torch.from_numpy(np.array(a)) for a in
                                (js.iq, js.phase)))
    x = audio_blocks(12, 2, k0=200)
    jm, jopen = jgz.ctcss_update_many(jc, js, jnp.asarray(x))
    tm, topen = goertzel.ctcss_update_many(tc, ts0, torch.from_numpy(x))
    ts, seq = ts0, []
    for b in range(12):
        js, jo1 = jgz.ctcss_update(jc, js, jnp.asarray(x[b]))
        ts, to1 = goertzel.ctcss_update(tc, ts, torch.from_numpy(x[b]))
        assert_margin(ratio(np.asarray(js.iq)))
        assert np.abs(np.asarray(js.iq) - ts.iq.numpy()).max() < 1e-6
        assert np.abs(np.asarray(js.phase) - ts.phase.numpy()).max() < 1e-5
        assert np.array_equal(np.asarray(jo1), to1.numpy())
        seq.append(to1)
    assert np.abs(np.asarray(jm.iq) - tm.iq.numpy()).max() < 1e-6
    assert np.abs(np.asarray(jm.phase) - tm.phase.numpy()).max() < 1e-5
    assert np.array_equal(np.asarray(jopen), topen.numpy())
    assert torch.equal(torch.stack(seq), topen)
    assert topen.shape == (12, C) and topen[:, :2].all()
    assert not topen[:, 2:].any()


def test_ctcss_receiver_opens_on_its_tone_only():
    """From a zero state: the tone's channels open once the EWMA has
    settled and stay open, the neighbour's never open after the
    transient, and the gate mutes their audio."""
    rx = Receiver(ReceiverConfig(**tp.KW, mode=DemodMode.FMN,
                                 ctcss_tone=TONE), "cpu")
    st, p, t0, opens, outs = rx.init_state(), rx.default_params(tp.TUNE), \
        0.0, [], None
    for k in WARM:
        st, outs = rx.step_many(st, p, torch.from_numpy(fm_plane(k, t0)))
        t0 += k * N / tp.FS
        opens.append(outs["ctcss_open"])
        assert torch.equal(outs["squelch_open"], outs["ctcss_open"])
    opens = torch.cat(opens)
    assert opens[-40:, :2].all()
    assert not opens[15:, 2:].any()
    assert float(outs["audio"][:, :2].abs().max()) > 0.3
    assert float(outs["audio"][:, 2:].abs().max()) == 0.0


@pytest.fixture(scope="module")
def runs():
    kw = dict(tp.KW, mode=DemodMode.FMN)
    jrx = JaxReceiver(JaxConfig(**{**kw, "mode": JaxMode.FMN},
                                use_pallas=True, ctcss_tone=TONE))
    trx = Receiver(ReceiverConfig(**kw, ctcss_tone=TONE), "cpu")
    plain = Receiver(ReceiverConfig(**kw), "cpu")
    jp = jrx.default_params(tp.TUNE)
    tp_, pp = (convert.params_from_numpy(r, tp.jleaves(jp))
               for r in (trx, plain))
    step_many = jax.jit(jrx._step_many_impl)
    jst, t0 = jrx.init_state(), 0.0
    for k in WARM:
        jst, _ = step_many(jst, jp, jnp.asarray(fm_plane(k, t0)))
        t0 += k * N / tp.FS
    leaves = tp.jleaves(jst)
    tst = convert.state_from_numpy(trx, leaves)
    # the twin without the tone squelch: the same state but the CTCSS
    # leaves (iq, phase: the last field); squelch_db -999 keeps it open
    pst = convert.state_from_numpy(plain, leaves[:-2])
    res = {}
    for k in (3, 9):
        x = fm_plane(k, t0)
        t0 += k * N / tp.FS
        cst = tst.ctcss
        jst, jo = step_many(jst, jp, jnp.asarray(x))
        tst, to = trx.step_many(tst, tp_, torch.from_numpy(x))
        pst, po = plain.step_many(pst, pp, torch.from_numpy(x))
        rs = []
        for b in range(k):
            cst, _ = goertzel.ctcss_update(trx.ctcss_cfg, cst, po["audio"][b])
            rs.append(ratio(cst.iq.numpy()))
        res[k] = (jo, to, tp.jleaves(jst), convert.state_to_numpy(tst),
                  np.stack(rs))
    return res


@pytest.mark.parametrize("k", [3, 9])
def test_ctcss_receiver_matches_jax(runs, k):
    jo, to, js, ts, r = runs[k]
    assert_margin(r)
    for key in ("squelch_open", "ctcss_open"):
        assert np.array_equal(np.asarray(jo[key]), to[key].numpy()), key
    assert to["ctcss_open"][:, :2].all() and not to["ctcss_open"][:, 2:].any()
    tp.check_audio(jo, to)
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)
    tp.check_state(js, ts)
    # the carried squelch is the AND-ed decision of the last block
    assert np.array_equal(js[-3], to["squelch_open"][-1].numpy())


@pytest.mark.parametrize("kw", [dict(mode=DemodMode.AM, ctcss_tone=TONE),
                                dict(mode=DemodMode.FMM, ctcss_tone=TONE),
                                dict(mode=DemodMode.FMN, ctcss_tone=120.0)],
                         ids=["am", "fmm", "off_table"])
def test_ctcss_refused_off_fmn_and_off_table(kw):
    with pytest.raises(ValueError, match="FMN|table"):
        Receiver(ReceiverConfig(**tp.KW, **kw), "cpu")
