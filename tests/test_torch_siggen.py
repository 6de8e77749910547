"""The port's test-signal generators (pebblesdr_tpu_torch/core/siggen.py)
against the JAX package's (pebblesdr_tpu/core/siggen.py) on the CPU.

tone within 1e-6 over streaming blocks.  sweep_plain (the plain version of
csrc/recur.cu's K7) against siggen.sweep in every mode, with and without
pulses, at three cases: -100 kHz -> 100 kHz at 1e7 Hz/s (512 kHz, 8192
samples), 100 -> 2000 Hz at 1e5 Hz/s (48 kHz, 32768: the case a float64
recurrence wraps on other samples) and -30 kHz -> 70 kHz at 3.3e6 Hz/s
(2.048 MHz, 32768): the wrap samples equal, the samples within 1e-5, the
state's frequency, direction and pulse count equal and its phase within
1e-6 (the port takes the phase step as XLA compiles it, a fused product
with the rate's reciprocal).  Noise: JAX's random bits cannot be
reproduced, so its power within 0.3 dB of the level asked for, and the same
samples again from a generator with the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.core import siggen as jsig
from pebblesdr_tpu_torch.core import siggen
from pebblesdr_tpu_torch.utils import convert

SWEEPS = {
    "100k 512k": (-100e3, 100e3, 1e7, 512_000.0, 8192),
    "2k 48k": (100.0, 2000.0, 1e5, 48_000.0, 32768),
    "70k 2.048M": (-30e3, 70e3, 3.3e6, 2_048_000.0, 32768),
}
PULSES = {"continuous": (0, 0), "pulsed": (300, 1000)}


def wraps(y: np.ndarray) -> np.ndarray:
    """The samples where the sweep's step jumps (a wrap to the start): the
    phase increment between neighbouring samples changes by more than 1e-2
    rad there (between wraps it moves by < 3e-4 rad a sample); pairs with
    a sample off (pulsed) are left out."""
    on = np.abs(y) > 0
    dp = np.angle(y[1:] * np.conj(y[:-1]))
    ok = on[1:] & on[:-1]
    jump = np.abs(np.diff(dp)) > 1e-2
    return np.nonzero(jump & ok[1:] & ok[:-1])[0]


@pytest.fixture(scope="module", params=list(SWEEPS))
def jax_sweeps(request):
    """{(mode, pulses): (JAX state leaves, samples)} for one case."""
    a, b, rate, fs, n = SWEEPS[request.param]
    out = {}
    for mode in siggen.SWEEP_MODES:
        for pname, (on, per) in PULSES.items():
            st, y = jsig.sweep(jsig.sweep_init(a), n, a, b, rate, fs,
                               amplitude=0.5, mode=mode,
                               pulse_on_samples=on, pulse_period_samples=per)
            out[mode, pname] = ([np.asarray(v) for v in
                                 jax.tree_util.tree_leaves(st)],
                                np.asarray(y))
    return request.param, out


@pytest.mark.parametrize("pulses", list(PULSES))
@pytest.mark.parametrize("mode", siggen.SWEEP_MODES)
def test_sweep_matches_jax(jax_sweeps, mode, pulses):
    case, res = jax_sweeps
    a, b, rate, fs, n = SWEEPS[case]
    on, per = PULSES[pulses]
    jleaves, jy = res[mode, pulses]
    st, y = siggen.sweep_plain(siggen.sweep_init(a, "cpu"), n, a, b, rate,
                               fs, amplitude=0.5, mode=mode,
                               pulse_on_samples=on, pulse_period_samples=per)
    y = y.numpy()
    assert y.shape == jy.shape == (n,) and y.dtype == np.complex64
    assert np.abs(y - jy).max() < 1e-5
    wj, wt = wraps(jy), wraps(y)
    assert np.array_equal(wj, wt)
    if mode == "repeat" and case == "2k 48k":
        assert len(wj) > 10          # the band wraps every ~912 samples
    leaves = convert.state_to_numpy(st)
    assert [v.dtype for v in leaves] == [v.dtype for v in jleaves]
    assert abs(float(leaves[0]) - float(jleaves[0])) < 1e-6   # phase
    for got, want in zip(leaves[1:], jleaves[1:]):
        assert got == want
    if per:
        assert np.count_nonzero(y) == np.count_nonzero(jy)


def test_sweep_streams_across_calls():
    """Two calls carry the state: they give one call's samples, and the
    entry point runs sweep_plain on the CPU (no launch counted)."""
    a, b, rate, fs, _ = SWEEPS["2k 48k"]
    before = siggen.sweep.launches
    st, y = siggen.sweep(siggen.sweep_init(a, "cpu"), 3000, a, b, rate, fs,
                         mode="repeat_reverse", pulse_on_samples=50,
                         pulse_period_samples=70)
    st1, y1 = siggen.sweep(siggen.sweep_init(a, "cpu"), 1234, a, b, rate, fs,
                           mode="repeat_reverse", pulse_on_samples=50,
                           pulse_period_samples=70)
    st2, y2 = siggen.sweep(st1, 3000 - 1234, a, b, rate, fs,
                           mode="repeat_reverse", pulse_on_samples=50,
                           pulse_period_samples=70)
    assert torch.equal(torch.cat([y1, y2]), y)
    for f in ("phase", "freq", "direction", "pulse_count"):
        assert torch.equal(getattr(st2, f), getattr(st, f)), f
    assert siggen.sweep.launches == before
    with pytest.raises(ValueError):
        siggen.sweep(st, 8, a, b, rate, fs, mode="saw")


def test_sweep_state_carries_from_jax():
    """A JAX SweepState's leaves start the port's sweep where JAX's went
    on."""
    a, b, rate, fs, _ = SWEEPS["100k 512k"]
    jst, _ = jsig.sweep(jsig.sweep_init(a), 1000, a, b, rate, fs)
    jst2, jy = jsig.sweep(jst, 500, a, b, rate, fs)
    st = convert.sweep_state_from_numpy(
        [np.asarray(v) for v in jax.tree_util.tree_leaves(jst)], "cpu")
    _, y = siggen.sweep(st, 500, a, b, rate, fs)
    assert np.abs(y.numpy() - np.asarray(jy)).max() < 1e-5


@pytest.mark.parametrize("freq", [100_000.0, -3_333.3, 17.0])
def test_tone_matches_jax(freq):
    fs = 512_000.0
    jst, tst = jsig.tone_init(), siggen.tone_init("cpu")
    for n in (8192, 4096, 8192):
        jst, jy = jsig.tone(jst, n, freq, fs, amplitude=0.25)
        tst, ty = siggen.tone(tst, n, freq, fs, amplitude=0.25)
        assert np.abs(ty.numpy() - np.asarray(jy)).max() < 1e-6
        assert abs(float(tst.phase) - float(jst.phase)) < 1e-6
    st = convert.tone_state_from_numpy([np.asarray(jst.phase)], "cpu")
    assert float(st.phase) == float(jst.phase)


def test_noise_level_and_reproducible():
    g = torch.Generator().manual_seed(5)
    x = siggen.noise(g, 1 << 16, db_level=-60.0)
    assert x.dtype == torch.complex64 and x.shape == (1 << 16,)
    jx = np.asarray(jsig.noise(jax.random.key(5), 1 << 16, db_level=-60.0))
    for y in (x.numpy(), jx):
        assert abs(10 * np.log10(np.mean(np.abs(y) ** 2)) + 60.0) < 0.3
    again = siggen.noise(torch.Generator().manual_seed(5), 1 << 16, -60.0)
    assert torch.equal(x, again)
    assert not torch.equal(x, siggen.noise(g, 1 << 16, -60.0))
    # the phase is uniform: no bias in I against Q
    assert abs(float(x.real.var() / x.imag.var()) - 1.0) < 0.05
    assert jnp.iscomplexobj(jx)
