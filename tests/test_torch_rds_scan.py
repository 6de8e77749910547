"""The RDS "scan" carrier (the per-sample Costas loop, pll.pll_run with the
costas detector: csrc/recur.cu pll_scan on the card, its plain version
here) against the JAX package, on the CPU.

  * rds_process with alg="scan" at C=8 over two streaming calls of three
    4096-sample blocks;
  * rds_process(blocks=K), the per-block symbol timing, against K calls;
  * the state layouts of both carriers (RdsState.pll per alg);
  * the Receiver, FMS stereo and FMS with stereo=False, with the RDS tap
    and rds_alg="scan", at C=4 and 32768-frame blocks (the shortest whose
    19 kHz stream holds whole symbols at 2.048 Msps; 8192 raises in both
    packages): a JAX dispatch of 3 blocks carried into the port, then
    dispatches of 3 and 9 blocks through both, against JAX's step_many,
    which runs this configuration as K per-block steps
    (pebblesdr_tpu/chain/receiver.py:526-541, :631-635), so the symbol
    timing updates once per block in both;
  * the port's CPU chain decoding the PS name "PEBBLES " with the scan
    carrier (5 dispatches of 8 blocks).

Bounds (tests/test_chain_batched.py:58-69 and tests/test_torch_rds.py):
soft symbols 1e-3 of their scale, timing equal, audio 2e-4, spectra and
S-meter 0.1 dB, squelch equal, state 1e-4 (the packed low-pass history of
JAX's narrow-plane XLA route on its last 234 rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rds import composite, jleaves, rds_plane, real_composite

import torch_parity as tp
from pebblesdr_tpu.demod import rds as jrds
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import rds as trds
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import pll as tpll
from pebblesdr_tpu_torch.utils import convert

FS, N = 2_048_000, 32768
RATE = 256_000.0


def close(a, b, tol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    d = np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max() \
        if a.size else 0.0
    assert d < tol, (what, d)


def test_rds_process_scan_matches_jax_streaming():
    c, blk, k = 8, 4096, 3
    jcfg = jrds.RdsConfig.make(RATE, blk, alg="scan")
    tcfg = trds.RdsConfig.make(RATE, blk, alg="scan")
    sj, st = jrds.rds_init(jcfg, c), trds.rds_init(tcfg, c, "cpu")
    assert isinstance(st.pll, tpll.PLLState)
    before = tpll.pll_scan.launches
    for call in range(2):
        x = real_composite(c, k * blk, 10 + call, call * k * blk / RATE)
        sj, softj, timj = jrds.rds_process(jcfg, sj, jnp.asarray(x))
        st, softt, timt = trds.rds_process(tcfg, st, torch.from_numpy(x))
        assert softt.shape == (c, k * tcfg.n_sym) == (c, 57)
        scale = float(np.abs(np.asarray(softj)).max())
        assert scale > 1e-3
        close(softj, softt, 1e-3 * scale, "soft")
        assert np.array_equal(np.asarray(timj), timt.numpy())
        jl, tl = jleaves(sj), convert.state_to_numpy(st)
        assert len(jl) == len(tl) == 8
        for i, (a, b) in enumerate(zip(jl, tl)):
            close(a, b, 1e-4, i)
    assert tpll.pll_scan.launches == before


@pytest.mark.parametrize("alg", ["open", "scan"])
def test_rds_process_per_block_timing_equals_block_calls(alg):
    """blocks=K updates the timing EWMA once per block: the same soft
    symbols, timings and state as K calls of one block."""
    c, blk, k = 3, 4096, 3
    cfg = trds.RdsConfig.make(RATE, blk, alg=alg)
    x = torch.from_numpy(real_composite(c, k * blk, 4, 0.0))
    st0 = trds.rds_init(cfg, c, "cpu")
    st0 = dataclasses.replace(st0, phase_acc=torch.rand(c, trds.SPS) * 0.01)
    sa, soft_a, tim_a = trds.rds_process(cfg, st0, x, blocks=k)
    assert tim_a.shape == (c, k)
    sb, softs, tims = st0, [], []
    for i in range(k):
        sb, s, t = trds.rds_process(cfg, sb, x[:, i * blk:(i + 1) * blk])
        softs.append(s)
        tims.append(t)
    soft_b = torch.cat(softs, dim=1)
    scale = float(soft_b.abs().max())
    assert float((soft_a - soft_b).abs().max()) < 1e-5 * scale
    assert torch.equal(tim_a, torch.stack(tims, dim=1))
    for a, b in zip(convert.leaves(sa), convert.leaves(sb)):
        assert float((a - b).abs().max()) < 1e-5


def test_rds_state_layout_follows_the_carrier():
    for alg in ("open", "scan"):
        jl = jleaves(jrds.rds_init(jrds.RdsConfig.make(RATE, 4096, alg=alg),
                                   2))
        tl = convert.state_to_numpy(
            trds.rds_init(trds.RdsConfig.make(RATE, 4096, alg=alg), 2, "cpu"))
        assert [(a.shape, a.dtype) for a in jl] == \
            [(b.shape, b.dtype) for b in tl]


# ----------------------------------------------------------- the Receiver

RX_CASES = {"stereo": {}, "mono": dict(stereo=False)}


@pytest.fixture(scope="module")
def rx_runs():
    res = {}
    c = 4
    for name, opts in RX_CASES.items():
        kw = dict(sample_rate=FS, frames_per_buffer=N, channels=c, rds=True,
                  rds_alg="scan", **opts)
        jrx, trx, jp, tpar = tp.receivers(DemodMode.FMS, kw)
        assert not jrx.batched_capable        # JAX scans its blocks
        step_many = jax.jit(jrx._step_many_impl)
        jst, _ = step_many(jrx.init_state(), jp,
                           jnp.asarray(rds_plane(c, 3 * N, 1)))
        tst = convert.state_from_numpy(trx, jleaves(jst))
        t0 = 3 * N
        for k in (3, 9):
            x = rds_plane(c, k * N, 2 + k, t0=t0 / FS)
            t0 += k * N
            jst, jo = step_many(jst, jp, jnp.asarray(x))
            tst, to = trx.step_many(tst, tpar, torch.from_numpy(x))
            res[name, k] = (jo, to, jleaves(jst),
                            convert.state_to_numpy(tst), trx)
    return res


RUNS = [(name, k) for name in RX_CASES for k in (3, 9)]
IDS = [f"{name}-K{k}" for name, k in RUNS]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_scan_rds_receiver_soft_symbols_and_timing(rx_runs, run):
    jo, to, _, _, trx = rx_runs[run]
    k = run[1]
    soft_j, soft_t = np.asarray(jo["rds_soft"]), to["rds_soft"].numpy()
    assert soft_t.shape == (k, 4, trx.rds_cfg.n_sym) == (k, 4, 19)
    scale = float(np.abs(soft_j).max())
    assert scale > 1e-3
    close(soft_j, soft_t, 1e-3 * scale, "rds_soft")
    assert to["rds_timing"].shape == (k, 4)
    assert to["rds_timing"].dtype == torch.int32
    assert np.array_equal(np.asarray(jo["rds_timing"]),
                          to["rds_timing"].numpy())


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_scan_rds_receiver_audio_and_meters(rx_runs, run):
    jo, to, _, _, _ = rx_runs[run]
    close(jo["audio"], to["audio"], 2e-4, "audio")
    assert np.array_equal(np.asarray(jo["pilot_locked"]),
                          to["pilot_locked"].numpy())
    tp.check_spectra(jo, to)
    tp.check_smeter_and_squelch(jo, to)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_scan_rds_receiver_state(rx_runs, run):
    _, _, js, ts, trx = rx_runs[run]
    assert len(js) == len(ts)
    st = trx.init_state()
    leaves = convert.leaves(st)
    lp = next(i for i, leaf in enumerate(leaves)
              if leaf is st.demod.lp_tail_mono)
    stereo = trx.wfm_cfg.stereo
    for i, (a, b) in enumerate(zip(js, ts)):
        if i == lp and stereo:
            a, b = a[-234:], b[-234:]
        close(a, b, 1e-4, i)


def test_cpu_chain_decodes_ps_with_the_scan_carrier():
    """5 dispatches of 8 blocks at C=1 through the port's CPU Receiver with
    rds_alg="scan": the host decoders sync and read "PEBBLES "."""
    n_disp, kb = 5, 8
    t = np.arange(n_disp * kb * N) / FS
    ph = 2 * np.pi * np.cumsum(75000.0 * composite(t)) / FS
    iq = 0.5 * np.exp(1j * (2 * np.pi * 300_000.0 * t + ph))
    x = torch.from_numpy(np.stack([iq.real, iq.imag], 1).astype(np.float32))
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                 channels=1, mode=DemodMode.FMS, rds=True,
                                 rds_alg="scan"), "cpu")
    st, p = rx.init_state(), rx.default_params(300_000.0)
    dec = trds.RdsBlockDecoder()
    for d in range(n_disp):
        st, out = rx.step_many(st, p, x[d * kb * N:(d + 1) * kb * N],
                               spectra=False)
        assert out["rds_timing"].shape == (kb, 1)
        dec.feed_symbols(out["rds_soft"][:, 0].reshape(-1).numpy())
    assert dec.synced and len(dec.groups) >= 4
    g = trds.RdsGroupDecoder()
    for grp in dec.groups:
        g.decode(grp)
    assert g.ps_name == "PEBBLES "
