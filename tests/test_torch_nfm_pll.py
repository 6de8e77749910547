"""NFM's "pll" discriminator (the CuteSDR NCO-PLL: the loop frequency of
pll.pll_run, csrc/recur.cu pll_scan on the card, its plain version here)
on the port against the JAX package, on the CPU.

  * nfm_demod with algorithm="pll" at C=3 and 64 ksps over two streaming
    calls of 4096 samples of a 1 kHz tone at 3 kHz deviation on a carrier
    150 Hz off: audio within 1e-5 absolute (|audio| ~0.6; the loop
    frequency's float32 rounding differences times the discriminator gain
    fs / (2 pi max_deviation) ~2), the state within 1e-4 (the loop phase
    modulo 2 pi), the carried sample unchanged as in JAX;
  * the recovered tone: its amplitude (deviation / max_deviation = 0.6)
    within 2 %, and its SNR above 40 dB.
"""

import jax.numpy as jnp
import numpy as np
import torch

import torch_parity as tp
from pebblesdr_tpu.demod import nfm as jnfm
from pebblesdr_tpu_torch.demod import nfm
from pebblesdr_tpu_torch.utils import convert

RATE, C, N = 64_000.0, 3, 4096


def fm_tone(call: int, seed: int) -> np.ndarray:
    """[C, N] complex64: 1 kHz at 3 kHz deviation on a carrier 150 Hz off,
    channel i at level 0.3 + 0.2 i and phase i, plus noise at 1e-3."""
    t = (call * N + np.arange(N)) / RATE
    ph = (2 * np.pi * 150.0 * t
          + 3000.0 / 1000.0 * np.sin(2 * np.pi * 1000.0 * t))
    x = np.stack([(0.3 + 0.2 * i) * np.exp(1j * (ph + i)) for i in range(C)])
    rng = np.random.default_rng(seed)
    x = x + 1e-3 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def test_nfm_pll_matches_jax_streaming():
    jcfg = jnfm.NFMConfig.make(RATE, algorithm="pll")
    tcfg = nfm.NFMConfig.make(RATE, algorithm="pll")
    assert tcfg.algorithm == "pll"
    assert np.array_equal(jcfg.voice_taps, tcfg.voice_taps)
    jst, tst = jnfm.nfm_init(jcfg, C), nfm.nfm_init(tcfg, C, "cpu")
    audio = []
    for call in range(2):
        x = fm_tone(call, 3 + call)
        jst, ja = jnfm.nfm_demod(jcfg, jst, jnp.asarray(x))
        tst, ta = nfm.nfm_demod(tcfg, tst, torch.from_numpy(x))
        assert ta.shape == (C, N) and ta.dtype == torch.float32
        assert np.abs(np.asarray(ja) - ta.numpy()).max() < 1e-5
        angles = (tp.leaf_index(tst, "pll", "phase"),)
        tp.check_state(tp.jleaves(jst), convert.state_to_numpy(tst), angles)
        assert float(tst.last.abs().max()) == 0.0   # "pll" keeps last as is
        audio.append(ta.numpy())
    tone = audio[1][0, 1024:]
    amp, res = tp.tone_fit(tone, 1000.0, RATE)
    assert abs(amp - 0.6) < 0.012
    assert 20 * np.log10(amp / np.sqrt(2) / res.std()) > 40.0
