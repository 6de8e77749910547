"""The AM receiver of the PyTorch port against the JAX Receiver on the CPU.

The JAX reference is built with use_pallas=True (the fused front in interpret
mode, batched step_many), as tests/test_chain_batched.py does, so both
carry the fused-front state layout.  One JAX step() block warms the chain up
(compared against the port's step()); its state is carried into the port
with utils.convert, then two dispatches of K=3 and K=9 blocks (odd K keeps
the JAX time-fold at 1 for C=4) are compared with the bounds of
tests/test_chain_batched.py:58-69: audio 2e-4 absolute, spectra and S-meter
SNR 0.1 dB, squelch equal, every carried state leaf 1e-4.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.chain import receiver as trx_mod
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.utils import convert

FS, N, C = 2_048_000, 8192, 4
KW = dict(sample_rate=FS, frames_per_buffer=N, channels=C, agc_stride=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def am_plane(k: int, seed: int) -> np.ndarray:
    """[k*N, 2C] packed plane: AM (1 kHz, m=0.8) at 250 kHz, per-channel
    level, plus complex white noise at 1e-2."""
    t = np.arange(k * N) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = 0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
    x = np.stack([iq * (0.5 + 0.2 * i) for i in range(C)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def runs():
    jrx = JaxReceiver(JaxConfig(mode=JaxMode.AM, use_pallas=True, **KW))
    trx = Receiver(ReceiverConfig(**KW), "cpu")
    jp = jrx.default_params(250_000.0)
    tp = convert.params_from_numpy(trx, jleaves(jp))
    res = {}
    x0 = am_plane(1, 7)
    jst, jo = jax.jit(jrx.step)(jrx.init_state(), jp, jnp.asarray(x0))
    tst, to = trx.step(trx.init_state(), tp, torch.from_numpy(x0))
    res["step"] = (jo, to, None, None)
    tst = convert.state_from_numpy(trx, jleaves(jst))
    for k, seed in ((3, 0), (9, 1)):
        x = am_plane(k, seed)
        jst, jo = jrx._step_many_impl(jst, jp, jnp.asarray(x))
        tst, to = trx.step_many(tst, tp, torch.from_numpy(x))
        res[k] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))
    return res


RUNS = ["step", 3, 9]


@pytest.mark.parametrize("run", RUNS)
def test_audio(runs, run):
    jo, to, _, _ = runs[run]
    a, b = np.asarray(jo["audio"]), to["audio"].numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 2e-4
    if run == 9:
        assert np.abs(a).max() > 0.1  # the compared audio is not all delay


@pytest.mark.parametrize("key", ["spectrum", "zoomed"])
@pytest.mark.parametrize("run", RUNS)
def test_spectra(runs, run, key):
    jo, to, _, _ = runs[run]
    a, b = np.asarray(jo[key]), to[key].numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 0.1
    assert np.array_equal(np.asarray(jo["overload"]), to["overload"].numpy())


@pytest.mark.parametrize("run", RUNS)
def test_smeter_and_squelch(runs, run):
    jo, to, _, _ = runs[run]
    assert set(jo["smeter"]) == set(to["smeter"])
    for key in jo["smeter"]:
        assert np.abs(np.asarray(jo["smeter"][key])
                      - to["smeter"][key].numpy()).max() < 0.1, key
    assert np.array_equal(np.asarray(jo["squelch_open"]),
                          to["squelch_open"].numpy())


@pytest.mark.parametrize("run", [3, 9])
def test_carried_state(runs, run):
    _, _, js, ts = runs[run]
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        d = np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max()
        assert d < 1e-4, (i, d)


def test_squelch_hysteresis_closed_form():
    """The closed form == the sequential recurrence, incl. b without a."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        b = torch.from_numpy(rng.random((7, 5)) < 0.3)
        a = torch.from_numpy(rng.random((7, 5)) < 0.6)
        prev = torch.from_numpy(rng.random(5) < 0.5)
        want, o = [], prev
        for k in range(7):
            o = b[k] | (a[k] & o)
            want.append(o)
        assert torch.equal(trx_mod._squelch_hysteresis(b, a, prev),
                           torch.stack(want))


def test_squelch_gates_audio():
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    p = rx.default_params(250_000.0)
    x = torch.from_numpy(am_plane(3, 4))
    _, open_out = rx.step_many(rx.init_state(), p, x)
    shut = type(p)(**{**p.__dict__, "squelch_db": torch.tensor(200.0)})
    _, shut_out = rx.step_many(rx.init_state(), shut, x)
    assert bool(open_out["squelch_open"].all())
    assert not bool(shut_out["squelch_open"].any())
    assert float(shut_out["audio"].abs().max()) == 0.0


def test_input_layouts_agree():
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    p = rx.default_params(250_000.0)
    x = torch.from_numpy(am_plane(3, 5))
    _, ref = rx.step_many(rx.init_state(), p, x)
    cplx = torch.complex(x[:, :C], x[:, C:]).T.reshape(C, 3, N).transpose(0, 1)
    for iq in (x.reshape(3, N, 2 * C), (x[:, :C], x[:, C:]),
               torch.stack([x[:, :C], x[:, C:]]).reshape(2, 3, N, C),
               cplx.contiguous()):
        _, out = rx.step_many(rx.init_state(), p, iq)
        assert torch.equal(out["audio"], ref["audio"])


@pytest.mark.parametrize("bad", ["packed2d", "packed3d", "complex", "pair"])
def test_channel_count_guards(bad):
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    st, p = rx.init_state(), rx.default_params()
    wrong = C + 1
    iq = {"packed2d": torch.zeros(N, 2 * wrong + 1),
          "packed3d": torch.zeros(1, N, 2 * wrong),
          "complex": torch.zeros(1, wrong, N, dtype=torch.complex64),
          "pair": (torch.zeros(N, wrong), torch.zeros(N, wrong))}[bad]
    with pytest.raises(ValueError):
        rx.step_many(st, p, iq)


@pytest.mark.parametrize("iq", [torch.zeros(N, 2 * (C + 1)),
                                torch.zeros(2, N, C + 1),
                                torch.zeros(C + 1, N, dtype=torch.complex64)])
def test_step_channel_guard(iq):
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    with pytest.raises(ValueError, match="channels"):
        rx.step(rx.init_state(), rx.default_params(), iq)


def test_folded_plane_rejected():
    """A time-folded entry plane is unfolded, except with the noise blanker
    on (no closed-form group seams, as in the JAX package) or when its lane
    groups do not hold whole blocks."""
    rx = Receiver(ReceiverConfig(**KW, enable_noise_blanker=True), "cpu")
    with pytest.raises(ValueError, match="folded"):
        rx.step_many(rx.init_state(), rx.default_params(),
                     torch.zeros(N, 4 * C))
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    with pytest.raises(ValueError, match="folded by 2"):
        rx.step_many(rx.init_state(), rx.default_params(),
                     torch.zeros(N // 2, 4 * C))


# SAM on 64-sample blocks, the scan RDS carrier and adaptive IQ balance run
# now: kw0 (SAM at 2048 frames with "auto") is held to the JAX Receiver,
# kw1-kw3 hold what is still refused (the ids keep the cases' names)
@pytest.mark.parametrize("kw", [dict(mode=DemodMode.SAM,
                                     frames_per_buffer=2048,
                                     enable_iq_balance="auto"),
                                dict(frames_per_buffer=3072),
                                dict(spectrum_bins=4096),
                                dict(mode=DemodMode.FMS,
                                     sample_rate=1_536_000,
                                     frames_per_buffer=24576, rds=True,
                                     rds_alg="scan")],
                         ids=["kw0", "kw1", "kw2", "kw3"])
def test_unported_configs_rejected(kw):
    if kw.get("enable_iq_balance") == "auto":
        n = kw["frames_per_buffer"]
        rx = Receiver(ReceiverConfig(**{**KW, **kw}), "cpu")
        assert rx.staged and rx.blk == 64
        t = np.arange(64 * n) / FS
        sig = (0.25 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t))
               * np.exp(2j * np.pi * 250_300.0 * t))

        def plane(k, seed):
            x = sig[seed * n:(seed + k) * n, None] * np.ones(C)
            x = x + 1e-2 * np.random.default_rng(seed).standard_normal(
                x.shape)
            return np.concatenate([1.06 * x.real, x.imag + 0.08 * x.real],
                                  axis=1).astype(np.float32)

        tp.check_run(DemodMode.SAM, plane, ks=(3, 9),
                     kw=dict(KW, frames_per_buffer=n),
                     enable_iq_balance="auto")
        return
    with pytest.raises(ValueError):
        Receiver(ReceiverConfig(**{**KW, **kw}), "cpu")


def test_convert_round_trip():
    rx = Receiver(ReceiverConfig(**KW), "cpu")
    st, _ = rx.step_many(rx.init_state(), rx.default_params(250_000.0),
                         torch.from_numpy(am_plane(1, 6)))
    arrays = convert.state_to_numpy(st)
    back = convert.state_to_numpy(convert.state_from_numpy(rx, arrays))
    assert len(arrays) == len(back)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        convert.state_from_numpy(rx, arrays + [arrays[0]])


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke load in a fresh interpreter,
    and a CPU step of each ported mode, with the noise blanker and IQ
    balance on (WFM also at the hq geometry), of FMN with a CTCSS tone, of
    AM with the ANF and AGC "long", of the hq RDS receiver, of the scan RDS
    carrier and of SAM on 64-sample blocks, and a call of NFM "pll" and of
    the scan AGC, FMS at 2.88 Msps (the stereo tail without K2), the "pll"
    pilot, a TestBench step with a sweep injected (the taps), the Morse
    modem's detector, the command-line receiver (a CPU run, --decode wwv,
    --checkpoint with --checkpoint-every, --resume and --help, in process
    and as ``python -m``), a checkpoint round trip, the stream supervisor
    across a gap, the feeder and the soak's fixture, and the live shell
    (the runtime's ring, iqformat, util_filters, the registry, an rtl_tcp
    server and the CLI reading it with --display and --keys, the control
    surface, the terminal display, the SDR-IP, HPSDR, ghpsdr3, audio sink
    and soundcard modules, and ``python -m pebblesdr_tpu_torch.serve.server
    --help``), and parallel/ (a one-rank CPU world: the sharded step's
    step_many and JAX-contract call, the mode experts' step_many, and the
    CLI's --assign), the parity harness (a chain run and a golden), an
    example and the quality row (tools/quality.py quality_row on the CPU: 2
    channels, 2-block captures) runs without loading jax or any module of
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys, numpy as np, torch\n"
        "import pebblesdr_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig\n"
        "from pebblesdr_tpu_torch.demod.modes import DemodMode\n"
        "x = torch.from_numpy(np.random.default_rng(0).standard_normal("
        "(8192, 4)).astype(np.float32))\n"
        "for mode, shape, hq in ((DemodMode.AM, (2,), False),\n"
        "                        (DemodMode.SAM, (2,), False),\n"
        "                        (DemodMode.USB, (2,), False),\n"
        "                        (DemodMode.NONE, (2,), False),\n"
        "                        (DemodMode.FMS, (2, 2), False),\n"
        "                        (DemodMode.FMS, (2, 2), True),\n"
        "                        (DemodMode.FMN, (2,), False),\n"
        "                        (DemodMode.FMM, (2,), True)):\n"
        "    rx = Receiver(ReceiverConfig(sample_rate=2048000, "
        "frames_per_buffer=8192, channels=2, mode=mode, wfm_hq=hq, "
        "enable_noise_blanker=True, enable_iq_balance=True), 'cpu')\n"
        "    st, out = rx.step(rx.init_state(), rx.default_params(250000.0), x)\n"
        "    assert out['audio'].shape == shape + (rx.audio_blk,)\n"
        "    assert st.nb[1].shape == (16, 4)\n"
        "for kw in (dict(mode=DemodMode.FMN, ctcss_tone=123.0),\n"
        "           dict(enable_anf=True, agc_mode='long')):\n"
        "    rx = Receiver(ReceiverConfig(sample_rate=2048000, "
        "frames_per_buffer=8192, channels=2, **kw), 'cpu')\n"
        "    st, out = rx.step(rx.init_state(), rx.default_params(250000.0), x)\n"
        "    assert out['audio'].shape == (2, rx.audio_blk)\n"
        "for name in ('nfm', 'goertzel', 'scanops'):\n"
        "    assert any(m.endswith('.' + name) for m in sys.modules), name\n"
        "rx = Receiver(ReceiverConfig(sample_rate=2048000, "
        "frames_per_buffer=32768, channels=1, mode=DemodMode.FMS, rds=True, "
        "wfm_hq=True), 'cpu')\n"
        "st, out = rx.step(rx.init_state(), rx.default_params(250000.0), "
        "torch.zeros(32768, 2))\n"
        "assert out['rds_soft'].shape == (1, 19)\n"
        "assert 'pebblesdr_tpu_torch.demod.rds' in sys.modules\n"
        "rx = Receiver(ReceiverConfig(sample_rate=2048000, "
        "frames_per_buffer=32768, channels=1, mode=DemodMode.FMS, rds=True, "
        "rds_alg='scan'), 'cpu')\n"
        "st, out = rx.step(rx.init_state(), rx.default_params(250000.0), "
        "torch.zeros(32768, 2))\n"
        "assert out['rds_timing'].shape == (1,)\n"
        "rx = Receiver(ReceiverConfig(sample_rate=2048000, "
        "frames_per_buffer=2048, channels=2, mode=DemodMode.SAM), 'cpu')\n"
        "st, out = rx.step(rx.init_state(), rx.default_params(250000.0), "
        "x[:2048])\n"
        "assert out['audio'].shape == (2, 48)\n"
        "from pebblesdr_tpu_torch.demod import nfm\n"
        "from pebblesdr_tpu_torch.ops import agc\n"
        "z = torch.ones(2, 256, dtype=torch.complex64)\n"
        "c = nfm.NFMConfig.make(64000.0, algorithm='pll')\n"
        "assert nfm.nfm_demod(c, nfm.nfm_init(c, 2, 'cpu'), z)[1].shape "
        "== (2, 256)\n"
        "a = agc.AGCConfig.make(64000.0, 'long', stride=16, "
        "algorithm='scan')\n"
        "assert agc.agc_apply(a, agc.agc_init(a, 2, 'cpu'), z)[1].shape "
        "== (2, 256)\n"
        "rx = Receiver(ReceiverConfig(sample_rate=2880000, "
        "frames_per_buffer=8192, channels=2, mode=DemodMode.FMS), 'cpu')\n"
        "st, out = rx.step(rx.init_state(), rx.default_params(250000.0), x)\n"
        "assert out['audio'].shape == (2, 2, rx.audio_blk)\n"
        "from pebblesdr_tpu_torch.demod import wfm\n"
        "c = wfm.WFMConfig.make(256000.0, pilot_alg='pll')\n"
        "assert wfm.wfm_demod(c, wfm.wfm_init(c, 2, 'cpu'), z.repeat(1, 8), "
        "256)[1]['left'].shape == (2, 512)\n"
        "from pebblesdr_tpu_torch.chain.testbench import TestBench\n"
        "rx = Receiver(ReceiverConfig(sample_rate=512000, "
        "frames_per_buffer=8192, channels=1, mode=DemodMode.AM, taps=True), "
        "'cpu')\n"
        "tb = TestBench(rx, inject=('sweep', {'start_hz': -1e5, 'stop_hz': "
        "1e5, 'rate_hz_per_sec': 1e7, 'db': -30.0}))\n"
        "st, out = tb.step(rx.init_state(), rx.default_params(0.0), "
        "torch.zeros(1, 8192, dtype=torch.complex64))\n"
        "assert set(out['taps']) == {'raw_iq', 'post_mixer', 'post_bp', "
        "'post_demod'}\n"
        "from pebblesdr_tpu_torch.modem.morse import MorseModem\n"
        "m = MorseModem(8000.0)\n"
        "assert m.detect(m.init_state(2, 'cpu'), torch.ones(2, 4 * m.frame, "
        "dtype=torch.complex64))[1].shape == (2, 4)\n"
        "import contextlib, io, json, runpy\n"
        "from pebblesdr_tpu_torch.serve import cli\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    assert cli.main(['--synthetic', 'tone', '--mode', 'USB', "
        "'--seconds', '0.01', '--frames', '8192', '--device', 'cpu', "
        "'--json']) == 0\n"
        "assert json.loads(buf.getvalue().splitlines()[-1])['blocks'] == 2\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    assert cli.main(['--synthetic', 'am', '--mode', 'AM', "
        "'--seconds', '0.01', '--frames', '8192', '--device', 'cpu', "
        "'--decode', 'wwv', '--json']) == 0\n"
        "assert json.loads(buf.getvalue().splitlines()[-1])['decoded_time'] "
        "is None\n"
        "sys.argv = ['cli', '--help']\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    try:\n"
        "        runpy.run_module('pebblesdr_tpu_torch.serve.cli', "
        "run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "import os, tempfile\n"
        "from pebblesdr_tpu_torch.utils import checkpoint, health, recovery\n"
        "from pebblesdr_tpu_torch.io import feeder, sources\n"
        "from pebblesdr_tpu_torch.tools import soak\n"
        "rx = Receiver(ReceiverConfig(sample_rate=2048000, "
        "frames_per_buffer=8192, channels=2, enable_anf=True), 'cpu')\n"
        "ck = os.path.join(tempfile.mkdtemp(), 'ck.npz')\n"
        "checkpoint.save_state(ck, rx.init_state(), extra={'blocks': 1})\n"
        "st, extra = checkpoint.load_state(ck, rx.init_state())\n"
        "assert extra == {'blocks': 1}\n"
        "sup = recovery.StreamSupervisor(rx, rx.default_params(250000.0), "
        "checkpoint_path=ck, checkpoint_every=1)\n"
        "st = sup.observe(st, 0)\n"
        "st = sup.observe(st, 3)\n"
        "sup.block_done(st)\n"
        "assert sup.report()['dropped_blocks'] == 2\n"
        "f = feeder.Feeder(sources.SyntheticSource(48000), block=480, "
        "channels=2).start()\n"
        "assert f.next_block().shape == (480, 4)\n"
        "f.stop()\n"
        "assert soak.rds_biphase(np.arange(64) / soak.FS).shape == (64,)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert cli.main(['--synthetic', 'tone', '--mode', 'USB', "
        "'--seconds', '0.01', '--frames', '8192', '--device', 'cpu', "
        "'--checkpoint', ck, '--checkpoint-every', '1', '--json']) == 0\n"
        "    assert cli.main(['--synthetic', 'tone', '--mode', 'USB', "
        "'--seconds', '0.01', '--frames', '8192', '--device', 'cpu', "
        "'--resume', ck, '--json']) == 0\n"
        "from pebblesdr_tpu_torch import runtime\n"
        "from pebblesdr_tpu_torch.core import iqformat\n"
        "from pebblesdr_tpu_torch.ops import spectrum, util_filters\n"
        "from pebblesdr_tpu_torch.io import (audio_iq, audio_out, ghpsdr3, "
        "hpsdr, registry, rtl_tcp, sdr_ip)\n"
        "from pebblesdr_tpu_torch.serve import control, display, server\n"
        "ring = runtime.NativeRing(2, 4)\n"
        "assert ring.write(b'abcd', timeout_ms=10) and ring.read(timeout_ms=10) "
        "== b'abcd'\n"
        "assert iqformat.decode_iq(torch.zeros(4, dtype=torch.int16), 'i16')"
        ".shape == (2,)\n"
        "assert util_filters.moving_avg(torch.ones(1, 32), 4)[0].shape == "
        "(1, 32)\n"
        "assert spectrum.map_to_screen(torch.zeros(1, 64), 8).shape == (1, 8)\n"
        "srv = rtl_tcp.RtlTcpServer(registry.create('synthetic', "
        "sample_rate=2048000, tones=((250000.0, 0.5),)), port=0, block=8192)\n"
        "srv.start()\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    assert cli.main(['--source', 'rtl_tcp', '--port', str(srv.port), "
        "'--mode', 'AM', '--tune', '250000', '--seconds', '0.01', '--frames', "
        "'8192', '--device', 'cpu', '--display', 'waterfall', '--keys', 'm', "
        "'--json']) == 0\n"
        "srv.stop()\n"
        "assert json.loads(buf.getvalue().splitlines()[-1])['final_mode'] == "
        "'SAM'\n"
        "rx = Receiver(ReceiverConfig(sample_rate=512000, "
        "frames_per_buffer=8192), 'cpu')\n"
        "cs = control.ControlSurface(rx, rx.default_params(0.0), 0.0)\n"
        "assert cs.handle('a').startswith('AGC') and cs.take_reset()\n"
        "assert display.TerminalDisplay(color=False).frame(np.zeros(2048))\n"
        "assert audio_out.factory('null', paced=True) and audio_iq.WavStream("
        "np.zeros((4, 2)))\n"
        "assert sdr_ip.pack_frequency(1e6) and hpsdr.freq_command(1e6) and "
        "ghpsdr3.AUDIO_RATE\n"
        "from pebblesdr_tpu_torch.parallel import (channelizer, comm, "
        "expert, mesh as pmesh)\n"
        "rx = Receiver(ReceiverConfig(sample_rate=512000, "
        "frames_per_buffer=8192, channels=2, agc_mode='off'), 'cpu')\n"
        "m = pmesh.make_mesh(1, 1, 'cpu')\n"
        "step = channelizer.build_sharded_step(rx, m, fused=True)\n"
        "p = rx.default_params(100000.0)\n"
        "st, out = step.step_many(step.init_state(), p, x)\n"
        "assert out['audio'].shape == (1, 2, rx.audio_blk)\n"
        "st, a = step(st, p, torch.zeros(2, 8192, dtype=torch.complex64))\n"
        "assert a.shape == (2, rx.audio_blk)\n"
        "comm.destroy_world()\n"
        "ch = expert.ModeExpertChannelizer(512000, 8192, ["
        "expert.ChannelAssignment(DemodMode.AM, 1e5), "
        "expert.ChannelAssignment(DemodMode.USB, 1e5)], device='cpu')\n"
        "_, outs = ch.step_many(ch.init_states(), torch.zeros(16384, 2))\n"
        "assert [tuple(o['audio'].shape[:2]) for o in outs] == [(2, 1)] * 2\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    assert cli.main(['--synthetic', 'am', '--seconds', '0.01', "
        "'--frames', '8192', '--assign', 'AM@100000,USB@100000', "
        "'--device', 'cpu', '--json']) == 0\n"
        "assert len(json.loads(buf.getvalue().splitlines()[-1])['channels']) "
        "== 2\n"
        "from pebblesdr_tpu_torch.tools import parity_harness as ph\n"
        "from pebblesdr_tpu_torch.examples import ex02_channelizer\n"
        "iq = ph.parity_capture(DemodMode.USB, 512000, 16384, [1e5])\n"
        "got, rx = ph.run_chain(iq, 512000, DemodMode.USB, [1e5], 8192, "
        "'cpu', blocks=2, batched=True)\n"
        "assert got.shape == (1, 2 * rx.audio_blk)\n"
        "assert len(ph.golden(iq, 512000, 1e5, rx)) == 2 * rx.audio_blk\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    ex02_channelizer.check(ex02_channelizer.main(['--device', "
        "'cpu']))\n"
        "for name in ('ex01_file_playback', 'ex03_wfm_rds', "
        "'ex04_station_bank', 'ex05_interactive_and_decoders'):\n"
        "    assert 'pebblesdr_tpu_torch.examples.' + name in sys.modules\n"
        "from pebblesdr_tpu_torch.tools import quality\n"
        "row = quality.quality_row('cpu', channels=2, blocks=2)\n"
        "assert list(row)[:len(quality.ROW_KEYS)] == list(quality.ROW_KEYS)\n"
        "assert 'stereo_sep_db_range' in row\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pebblesdr_tpu' or m.startswith('pebblesdr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    # the command-line receiver's entry point, as a user starts it
    proc = subprocess.run([sys.executable, "-m", "pebblesdr_tpu_torch.serve.cli",
                           "--help"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--assign" in proc.stdout
    # the rtl_tcp server's entry point
    proc = subprocess.run([sys.executable, "-m",
                           "pebblesdr_tpu_torch.serve.server", "--help"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--source" in proc.stdout and "rtl_tcp" in proc.stdout
