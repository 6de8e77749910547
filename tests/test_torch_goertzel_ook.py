"""The port's Goertzel machinery and OOK detector (pebblesdr_tpu_torch/ops/
goertzel.py) against the JAX package's (pebblesdr_tpu/ops/goertzel.py) on
the CPU.

The helpers exactly: DTMF_FREQS, the N estimates, choose_n,
compare_bin_freqs, dft_vectors, frame_stream, THRESHOLD_MODES.
goertzel_power within 1e-6 of the largest power (both take one complex
product per bin in float32: the sums differ in order only).
ook_detect_plain (the plain version of csrc/recur.cu's K6) in all six
threshold modes against ook_detect, jitted: the marks equal on keyed powers
whose decision margins are asserted (ook_margin >= 1e-5: ten times the
state bound), the state within 1e-6 of each leaf's scale (XLA contracts
the envelopes' products and sums into FMAs; the port rounds each), the
counters and decisions equal; two calls across a split equal one call.
"""

import jax
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import goertzel as jg
from pebblesdr_tpu_torch.ops import goertzel
from pebblesdr_tpu_torch.utils import convert

MARGIN = 1e-5
C, F = 8, 480


def keyed_powers(seed: int, c: int = C, f: int = F):
    """(main, low, high) [C, F] float32: keying in runs of 6-14 frames with
    a slow fade on the main bin, a little of the keying on the low compare
    bin, and a noise floor near 1e-3 on all three."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(6, 15, size=(c, f))
    key = np.zeros((c, f), bool)
    for i in range(c):
        t, on = 0, bool(i % 2)
        for r in runs[i]:
            key[i, t:t + r] = on
            t, on = t + r, not on
            if t >= f:
                break
    fade = 1 + 0.5 * np.sin(np.arange(f)[None, :] / 40.0
                            + np.arange(c)[:, None])
    pm = key * 0.4 * fade + 1e-3 * (1 + rng.random((c, f)))
    pl = 0.03 * key + 1e-3 * rng.random((c, f))
    ph = 1e-3 * rng.random((c, f))
    return tuple(a.astype(np.float32) for a in (pm, pl, ph))


def cfgs(mode: str):
    kw = dict(mode=mode, manual_threshold=0.1)
    return jg.OOKConfig.make(**kw), goertzel.OOKConfig.make(**kw)


def jax_ook(jcfg, state, pows):
    return jax.jit(lambda s, a, b, c: jg.ook_detect(jcfg, s, a, b, c))(
        state, *pows)


def jleaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def check_state(js, ts) -> None:
    for a, b in zip(jleaves(js), convert.state_to_numpy(ts)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.float32:
            scale = max(float(np.abs(a).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= 1e-6 * scale
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize("mode", goertzel.THRESHOLD_MODES)
def test_ook_detect_matches_jax(mode):
    jcfg, tcfg = cfgs(mode)
    pows = keyed_powers(list(goertzel.THRESHOLD_MODES).index(mode))
    tp = [torch.from_numpy(a) for a in pows]
    st0 = goertzel.ook_init(C, "cpu")
    assert goertzel.ook_margin(tcfg, st0, *tp) >= MARGIN
    js, jm = jax_ook(jcfg, jg.ook_init(C), pows)
    ts, tm = goertzel.ook_detect_plain(tcfg, st0, *tp)
    assert tm.dtype == torch.bool and tm.shape == (C, F)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert 0.2 < float(tm.float().mean()) < 0.8     # the decisions move
    check_state(js, ts)
    # the entry point runs the plain version on the CPU (no launch)
    before = goertzel.ook_detect.launches
    ts2, tm2 = goertzel.ook_detect(tcfg, st0, *tp)
    assert goertzel.ook_detect.launches == before
    assert torch.equal(tm2, tm)


@pytest.mark.parametrize("mode", ["peak", "noise"])
def test_ook_detect_streams_across_calls(mode):
    """Two calls across a split give one call's marks and state, for the
    port and against JAX's second call started from the carried state."""
    jcfg, tcfg = cfgs(mode)
    pows = keyed_powers(11)
    tp = [torch.from_numpy(a) for a in pows]
    st0 = goertzel.ook_init(C, "cpu")
    ts, tm = goertzel.ook_detect_plain(tcfg, st0, *tp)
    cut = 173
    s1, m1 = goertzel.ook_detect_plain(tcfg, st0, *(a[:, :cut] for a in tp))
    s2, m2 = goertzel.ook_detect_plain(tcfg, s1, *(a[:, cut:] for a in tp))
    assert torch.equal(torch.cat([m1, m2], dim=1), tm)
    for a, b in zip(convert.leaves(s2), convert.leaves(ts)):
        assert torch.equal(a, b)
    js1, _ = jax_ook(jcfg, jg.ook_init(C), [a[:, :cut] for a in pows])
    tst1 = convert.ook_state_from_numpy(jleaves(js1), "cpu")
    js2, jm2 = jax_ook(jcfg, js1, [a[:, cut:] for a in pows])
    ts2, tm2 = goertzel.ook_detect_plain(tcfg, tst1, *(a[:, cut:] for a in tp))
    assert np.array_equal(np.asarray(jm2), tm2.numpy())
    check_state(js2, ts2)


def test_ook_config_and_init():
    assert goertzel.THRESHOLD_MODES == jg.THRESHOLD_MODES
    with pytest.raises(ValueError):
        goertzel.OOKConfig.make(mode="median")
    st = goertzel.ook_init(3, "cpu")
    for a, b in zip(jleaves(jg.ook_init(3)), convert.state_to_numpy(st)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    k = goertzel.OOKConfig.make(decay_alpha=0.03, avg_alpha=0.02).consts()
    assert k["fa"] == np.float32(0.1 * 0.03) and k["keep"] == np.float32(0.98)


def test_helpers_match_jax():
    assert goertzel.DTMF_FREQS == jg.DTMF_FREQS
    for ms, fs in ((10.0, 8000), (2.5, 48000.0), (0.01, 100.0)):
        assert goertzel.est_n_for_shortest_bit(ms, fs) == \
            jg.est_n_for_shortest_bit(ms, fs)
    for bw, fs in ((100.0, 8000), (7.0, 48000.0), (1e9, 8000)):
        assert goertzel.est_n_for_bin_bandwidth(bw, fs) == \
            jg.est_n_for_bin_bandwidth(bw, fs)
    for kw in (dict(ms_shortest_bit=10.0, bandwidth_hz=50.0),
               dict(ms_shortest_bit=40.0, bandwidth_hz=100.0),
               dict(ms_shortest_bit=15.0), dict(bandwidth_hz=75.0)):
        assert goertzel.choose_n(8000, **kw) == jg.choose_n(8000, **kw)
    with pytest.raises(ValueError):
        goertzel.choose_n(8000)
    for args in ((1000.0, 80, 8000.0), (700.0, 480, 32000.0, 1.0)):
        assert goertzel.compare_bin_freqs(*args) == jg.compare_bin_freqs(*args)
    b = goertzel.dft_vectors([697.0, 1000.5], 8000.0, 160)
    assert np.array_equal(b, jg.dft_vectors([697.0, 1000.5], 8000.0, 160))
    x = torch.arange(24.0).reshape(2, 12)
    assert torch.equal(goertzel.frame_stream(x, 4), x.reshape(2, 3, 4))


@pytest.mark.parametrize("real", [False, True])
def test_goertzel_power_matches_jax(real):
    fs, n = 8000.0, 160
    rng = np.random.default_rng(4)
    t = np.arange(6 * n) / fs
    x = np.stack([0.5 * np.exp(2j * np.pi * 1000.0 * t),
                  0.2 * np.exp(2j * np.pi * 697.3 * t)
                  + 0.01 * rng.standard_normal(t.size)])
    x = (x.real if real else x).astype(np.float32 if real else np.complex64)
    basis = goertzel.dft_vectors([1000.0, 697.0, 1209.0, 50.0], fs, n)
    frames = x.reshape(2, 6, n)
    jp = np.asarray(jg.goertzel_power(
        jax.numpy.asarray(frames).astype(np.complex64),
        jax.numpy.asarray(basis)))
    tpw = goertzel.goertzel_power(torch.from_numpy(frames), basis)
    assert tpw.dtype == torch.float32 and tpw.shape == (2, 6, 4)
    assert float(np.abs(jp - tpw.numpy()).max()) <= 1e-6 * jp.max()
    # a unit tone exactly on a bin reads power 1 (real: two halves, 0.25)
    assert abs(float(tpw[0, :, 0].mean()) - (0.0625 if real else 0.25)) < 1e-3
