"""The robustness suite of tests/test_robustness.py on the PyTorch port,
against the JAX package on the CPU, at that file's sizes: three FM stereo
stations in one capture (3 channels, 16 blocks of 32768 frames at 2.048
Msps), 100 AM blocks of 8192 frames at 512 ksps, and the display
calibration offset (one AM block at 0 and at 10 dB).  Each runs through
Receiver.step per block in both packages on the same numpy input (the
fixtures from pebblesdr_tpu_torch/tools/quality.py).

Bounds: the JAX test's own (own tone > 0.25 and own / other > 10 on every
channel; finite audio, the mixer phase in [0, 1) and the level steady to
1 % over the last 50 blocks; the spectrum peak moved by 10.0 +- 0.1 dB and
the S-meter SNR by at most 0.2 dB); each tone amplitude, block RMS,
spectrum peak and S-meter SNR within 0.1 dB of the JAX value; audio within
2e-4 (tests/test_torch_receiver.py, tests/test_torch_receiver_wfm.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.tools import quality as q

N = q.N
AUDIO_ATOL = 2e-4
DB_TOL = 0.1
STATIONS = (-700_000.0, 0.0, 700_000.0)      # tests/test_robustness.py:21-22
TONES = (800.0, 1500.0, 2500.0)
LONG = dict(fs=512_000, n=8192, blocks=100, tune=123_456.0)


def db(a, b) -> float:
    return float(20 * np.log10(a / b))


class TestMultiChannelWFM:
    def test_three_stereo_channels(self):
        """tests/test_robustness.py:15-55 on the port: each of three
        channels recovers its own station's tone (> 0.25, 10x any other
        station's); the tone amplitudes within 0.1 dB of the JAX
        Receiver's, the audio within 2e-4."""
        c, nb = 3, 16
        capture = q.three_stations(nb * N, STATIONS, TONES)
        iq = np.broadcast_to(capture, (c, nb * N)).copy()
        jrx = JaxReceiver(JaxConfig(sample_rate=q.FS, frames_per_buffer=N,
                                    channels=c, mode=JaxMode.FMS))
        state = jrx.init_state()
        params = jrx.default_params(list(STATIONS))
        outs = []
        for i in range(nb):
            state, out = jrx.step(state, params,
                                  jnp.asarray(iq[:, i * N:(i + 1) * N]))
            outs.append(np.asarray(out["audio"]))
        jaudio = np.concatenate(outs, axis=-1)

        plane = q.build_plane(lambda _: capture, range(c), nb * N)
        rx, _, touts = q.run_chain("cpu", [plane], STATIONS, False,
                                   spectra=True, mode=DemodMode.FMS)
        taudio = q.audio_of(touts)
        assert taudio.shape == jaudio.shape
        assert np.abs(taudio - jaudio).max() < AUDIO_ATOL
        skip = 8 * rx.audio_blk
        rate = rx.cfg.audio_rate

        def amp(x, f):
            return q.station_amp(x, f, rate)

        for ch, tone in enumerate(TONES):
            others = [TONES[(ch + 1) % c], TONES[(ch + 2) % c]]
            own = amp(taudio[ch, 0, skip:], tone)
            other = max(amp(taudio[ch, 0, skip:], f) for f in others)
            assert own > 0.25, f"ch{ch} lost its audio"
            assert own / max(other, 1e-9) > 10, f"ch{ch} cross-talk"
            jown = amp(jaudio[ch, 0, skip:], tone)
            assert abs(db(own, jown)) < DB_TOL, (ch, own, jown)


class TestLongRunStability:
    def test_no_drift_or_nans_over_many_blocks(self):
        """tests/test_robustness.py:59-83 on the port: 100 AM blocks, all
        audio finite, the mixer phase in [0, 1), the level steady to 1 %
        over the last 50 blocks; each block's audio within 2e-4 and its RMS
        within 0.1 dB of the JAX Receiver's, the phase within 1e-6."""
        fs, n, tune = LONG["fs"], LONG["n"], LONG["tune"]
        kw = dict(sample_rate=fs, frames_per_buffer=n, agc_mode="off")
        jrx = JaxReceiver(JaxConfig(mode=JaxMode.AM, **kw))
        jst = jrx.init_state()
        jp = jrx.default_params(tune)
        t0 = np.arange(n) / fs
        blocks = [q.am_long(t0 + i * n / fs, tune)[None]
                  for i in range(LONG["blocks"])]
        jrms, jaudio = [], []
        for x in blocks:
            jst, out = jrx.step(jst, jp, jnp.asarray(x))
            a = np.asarray(out["audio"])
            jaudio.append(a)
            jrms.append(float(np.sqrt(np.mean(a ** 2))))

        plane = np.concatenate(
            [np.stack([x[0].real, x[0].imag], axis=1) for x in blocks]
        ).astype(np.float32)
        _, st, outs = q.run_chain("cpu", [plane], [tune], False,
                                  spectra=True, n=n, fs=fs,
                                  mode=DemodMode.AM, agc_mode="off")
        rms = []
        for i, out in enumerate(outs):
            a = out["audio"][0].numpy()
            assert np.all(np.isfinite(a)), f"NaN at block {i}"
            assert np.abs(a - jaudio[i]).max() < AUDIO_ATOL, i
            rms.append(float(np.sqrt(np.mean(a ** 2))))
        ph = float(st.mixer.phase[0])
        assert 0.0 <= ph < 1.0
        jph = float(np.asarray(jst.mixer.phase)[0])
        assert abs(ph - jph) < 1e-6, (ph, jph)
        tail = np.asarray(rms[50:])
        assert tail.std() / tail.mean() < 0.01
        assert max(abs(db(a, b)) for a, b in zip(rms, jrms)
                   if b > 0) < DB_TOL


class TestDbOffset:
    def test_offset_shifts_spectrum_not_snr(self):
        """tests/test_robustness.py:87-104 on the port: a 10 dB display
        offset moves the spectrum's peak by 10.0 +- 0.1 dB and the S-meter
        SNR by at most 0.2 dB; each peak and SNR within 0.1 dB of the JAX
        Receiver's."""
        fs, n = 512_000, 8192
        iqt = np.exp(2j * np.pi * 100_000.0 * np.arange(n) / fs)
        iq = (0.5 * iqt).astype(np.complex64)
        plane = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
        res = {}
        for off in (0.0, 10.0):
            jrx = JaxReceiver(JaxConfig(sample_rate=fs, frames_per_buffer=n,
                                        mode=JaxMode.AM, db_offset=off))
            _, jout = jrx.step(jrx.init_state(),
                               jrx.default_params(100_000.0),
                               jnp.asarray(iq[None]))
            _, _, outs = q.run_chain("cpu", [plane], [100_000.0], False,
                                     spectra=True, n=n, fs=fs,
                                     mode=DemodMode.AM, db_offset=off)
            res[off] = dict(
                jpeak=float(np.max(np.asarray(jout["spectrum"]))),
                jsnr=float(np.asarray(jout["smeter"]["snr_db"])[0]),
                peak=float(outs[0]["spectrum"].max()),
                snr=float(outs[0]["smeter"]["snr_db"][0, 0]))
        assert res[10.0]["peak"] - res[0.0]["peak"] == pytest.approx(
            10.0, abs=0.1)
        assert res[0.0]["snr"] == pytest.approx(res[10.0]["snr"], abs=0.2)
        for r in res.values():
            assert abs(r["peak"] - r["jpeak"]) < DB_TOL, r
            assert abs(r["snr"] - r["jsnr"]) < DB_TOL, r
