"""The WFM-stereo modules of the PyTorch port against the JAX package.

On the CPU, with inputs made from numpy seeds: the WFM configuration's
designs; the open pilot over two streaming calls; the front end's FM
discriminator and y-tail switches (plain version) against the TPU kernel
pk.fused_front_packed in interpret mode; the fused stereo tail (plain
version) against pk.wfm_tail_packed in interpret mode; and the port's stereo
separation on an L-only program.  The CUDA kernels themselves are held to
the plain versions on the card by tests/test_torch_gpu.py.

Bounds: 3e-5 relative for the front (tests/test_pallas.py); 1e-4 absolute
for the discriminator, whose TPU version evaluates atan2 as a polynomial
(~2e-7 rad) behind a bf16x3 dot (~2^-16 relative, tests/test_pallas.py:286);
audio 5e-4 absolute for the stereo tail (tests/test_chain_pallas.py:190),
state 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.demod import wfm as jwfm
from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu.ops import pll as jpll
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import wfm as twfm
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import front, pll, wfm_tail

FS = 2_048_000
RATE = 256_000.0


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def composite(n: int, c: int, seed: int) -> np.ndarray:
    """[n, c] float32 FM-stereo composite at 256 kHz, discriminator-scaled:
    mono 1 kHz, pilot, L-R 400 Hz on 38 kHz, per-channel noise."""
    t = np.arange(n) / RATE + seed
    comp = (0.45 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.45 * np.sin(2 * np.pi * 400.0 * t)
            * np.sin(2 * np.pi * 38000.0 * t))
    rng = np.random.default_rng(seed)
    gain = 2 * np.pi * 75000.0 / RATE * 0.54
    return (gain * comp[:, None]
            + 0.01 * rng.standard_normal((n, c))).astype(np.float32)


def test_config_designs_match_jax():
    j = jwfm.WFMConfig.make(RATE)
    t = twfm.WFMConfig.make(RATE)
    assert np.array_equal(np.asarray(j.audio_taps), t.audio_taps)
    assert dataclasses.asdict(j.pilot_notch) == \
        dataclasses.asdict(t.pilot_notch)
    po_j, po_t = j.pilot_open, t.pilot_open
    for f in dataclasses.fields(po_t):
        assert getattr(po_j, f.name) == getattr(po_t, f.name), f.name
    assert (j.notch_needed, j.audio_decim, j.audio_rate) == \
        (t.notch_needed, t.audio_decim, t.audio_rate)
    for blk in (1024, 4096, 3072):
        assert jwfm.pilot_chunk_for(j, blk) == twfm.pilot_chunk_for(t, blk)
        assert jwfm.tail_kernel_sub(j, blk) == twfm.tail_kernel_sub(t, blk)


def test_pilot_open_tm_matches_jax_streaming():
    c, n = 4, 8192
    cfg_j = jpll.make_pilot_open_config(RATE)
    cfg_t = pll.make_pilot_open_config(RATE)
    sj, st = jpll.pilot_open_init(c), pll.pilot_open_init(c, "cpu")
    for call in range(2):
        raw = composite(n, c, call)
        sj, (p0j, wfj, _), lvj = jpll.pilot_open_core_tm(
            cfg_j, sj, jnp.asarray(raw), chunk=256)
        st, (p0t, wft, _), lvt = pll.pilot_open_core_tm(
            cfg_t, st, torch.from_numpy(raw), chunk=256)
        # p0 is an absolute phase up to ~10 rad: float32 association
        assert np.abs(np.asarray(p0j) - p0t.numpy()).max() < 1e-4
        assert np.abs(np.asarray(wfj) - wft.numpy()).max() < 1e-6
        assert np.abs(np.asarray(lvj) - lvt.numpy()).max() < 1e-6
        for f in dataclasses.fields(st):
            a = np.asarray(getattr(sj, f.name))
            b = getattr(st, f.name).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.abs(a - b).max() < 1e-4, f.name
    assert float(lvt[:, -1].min()) > 0.002  # the pilot is tracked


def test_pilot_open_tm_equals_channel_major():
    raw = torch.from_numpy(composite(4096, 3, 5))
    cfg = pll.make_pilot_open_config(RATE)
    st = pll.pilot_open_init(3, "cpu")
    a = pll.pilot_open_core_tm(cfg, st, raw)
    b = pll.pilot_open_core(cfg, st, raw.T.contiguous())
    for u, v in ((a[1][0], b[1][0]), (a[1][1], b[1][1]), (a[2], b[2])):
        assert torch.allclose(u, v, atol=1e-5, rtol=0)


def _fm_plane(c: int, rows: int) -> np.ndarray:
    """[rows, 2C] FM at 250 kHz with bounded phase steps (a noise input
    would flip 2 pi on float epsilons at the atan2 branch cut); channel i
    starts at phase i*pi/2 + pi/4, so the first composite samples of the
    channels lie in all four quadrants."""
    t = np.arange(rows) / FS
    mod = np.sin(2 * np.pi * 700.0 * t) + 0.3 * np.sin(2 * np.pi * 5e3 * t)
    phase = 2 * np.pi * np.cumsum(60e3 * mod) / FS
    iq = np.stack([0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + phase
                                      + np.pi / 4 + i * np.pi / 2))
                   for i in range(c)], axis=1)
    return np.concatenate([iq.real, iq.imag], axis=1).astype(np.float32)


def test_front_discriminator_matches_pallas_kernel():
    """Two streaming calls of 2 blocks each from a zero disc_last; the first
    discriminator row (the signed-zero case) is checked on its own."""
    c, nblk, k, sub = 4, 8192, 2, 2048
    jp = jdec.build_plan(FS, 200_000)
    h = jdec.compose_response(jp)
    f = jp.factor
    tp = tdec.build_plan(FS, 200_000)
    plan = front.FrontPlan.make(tdec.compose_response(tp), tp.factor, "cpu")
    d_rows = plan.d_rows
    wt = jnp.asarray(np.ascontiguousarray(
        pk.build_composed_w(h, f, sub, d_rows - (len(h) - 1)).T))
    gain = RATE / (2 * np.pi * 75000.0)
    zt = 2048 // 8
    splits = [jmix.split_freq(250_000.0, FS)] * c
    hi = np.array([s[0] for s in splits])
    lo = np.array([s[1] for s in splits])
    x = _fm_plane(c, 2 * k * nblk)
    js = (jnp.zeros((1, 2 * c)), jnp.zeros((c,)), jnp.zeros((d_rows, 2 * c)),
          jnp.zeros((1, 2 * c)))
    ts = (torch.zeros(1, 2 * c), torch.zeros(c), torch.zeros(d_rows, 2 * c),
          torch.zeros(1, 2 * c))
    for call in range(2):
        xb = x[call * k * nblk:(call + 1) * k * nblk]
        jy, jdc, jtl, jph, jraw, jdisc, jdl = pk.fused_front_packed(
            jnp.asarray(xb), js[0], js[1], jnp.asarray(hi), jnp.asarray(lo),
            js[2], wt, f, d_rows, 0.9999, sub_block=sub, n_block=nblk,
            raw_rows=2048, disc_gain=gain, h_np=h, disc_last=js[3],
            y_tail_rows=zt, interpret=True)
        ty, tdc, ttl, tph, traw, tdisc, tdl = front.fused_front(
            plan, torch.from_numpy(xb), ts[0], ts[1], torch.from_numpy(hi),
            torch.from_numpy(lo), ts[2], n_block=nblk, raw_rows=2048,
            disc_gain=gain, disc_last=ts[3], y_tail_rows=zt)
        assert ty.shape == (k, zt, 2 * c)
        for a, b in ((jy, ty), (jdc, tdc), (jtl, ttl), (jdl, tdl)):
            assert rel_err(a, b) < 3e-5
        assert np.abs(np.asarray(jph) - tph.numpy()).max() < 1e-6
        assert np.array_equal(np.asarray(jraw), traw.numpy())
        assert tdisc.shape == (k * nblk // f, c)
        # while the FIR fills from the zero history (the first D/F rows of
        # the first call) |y| falls to ~1e-6, below the ~1e-5 absolute error
        # of the TPU kernel's bf16x3 dot, and the angle is that error's
        fill = -(-len(h) // f) if call == 0 else 0
        assert np.abs(np.asarray(jdisc)[fill:] - tdisc.numpy()[fill:]).max() \
            < 1e-4
        if call == 0:
            # the zero seed: atan2 of the IEEE products, signed zeros kept
            y0 = np.asarray(front.fused_front_reference(
                plan, torch.from_numpy(xb), ts[0], ts[1], torch.from_numpy(hi),
                torch.from_numpy(lo), ts[2], n_block=nblk)[0][0])
            yr, yi, zero = y0[:c], y0[c:], np.float32(0.0)
            want = np.arctan2(yi * zero - yr * zero,
                              yr * zero + yi * zero) * np.float32(gain)
            assert np.array_equal(tdisc[0].numpy(), want.astype(np.float32))
            assert np.abs(np.asarray(jdisc)[0] - want).max() < 1e-6
            assert np.isclose(np.abs(want).max(), np.pi * gain, rtol=1e-6)
        js = (jdc, jph, jtl, jdl)
        ts = (tdc, tph, ttl, tdl)


def test_front_y_tail_and_disc_stream_like_one_shot():
    c, nblk = 3, 4096
    tp = tdec.build_plan(FS, 200_000)
    plan = front.FrontPlan.make(tdec.compose_response(tp), tp.factor, "cpu")
    x = torch.from_numpy(_fm_plane(c, 4 * nblk))
    hi = torch.full((c,), float(jmix.split_freq(250_000.0, FS)[0]))
    lo = torch.full((c,), float(jmix.split_freq(250_000.0, FS)[1]))
    z = (torch.zeros(1, 2 * c), torch.zeros(c))
    zt, zl = torch.zeros(plan.d_rows, 2 * c), torch.zeros(1, 2 * c)
    kw = dict(n_block=nblk, disc_gain=0.5)
    full = front.fused_front(plan, x, *z, hi, lo, zt, disc_last=zl, **kw)
    a = front.fused_front(plan, x[:2 * nblk], *z, hi, lo, zt, disc_last=zl,
                          y_tail_rows=128, **kw)
    b = front.fused_front(plan, x[2 * nblk:], a[1], a[3], hi, lo, a[2],
                          disc_last=a[6], y_tail_rows=128, **kw)
    m = nblk // plan.factor
    assert torch.equal(torch.cat([a[0], b[0]]),
                       full[0].reshape(4, m, 2 * c)[:, m - 128:])
    assert rel_err(full[5], torch.cat([a[5], b[5]])) < 1e-5
    assert rel_err(full[6], b[6]) < 1e-5


@pytest.mark.parametrize("kw", [dict(disc_gain=0.5),
                                dict(y_tail_rows=128),
                                dict(disc_gain=0.5, disc_last=torch.zeros(1, 2),
                                     y_tail_rows=128)])
def test_front_discriminator_arguments_checked(kw):
    tp = tdec.build_plan(FS, 200_000)
    plan = front.FrontPlan.make(tdec.compose_response(tp), tp.factor, "cpu")
    c = 2
    with pytest.raises(ValueError):
        front.fused_front(plan, torch.zeros(4096, 2 * c),
                          torch.zeros(1, 2 * c), torch.zeros(c),
                          torch.zeros(c), torch.zeros(c),
                          torch.zeros(plan.d_rows, 2 * c), n_block=4096, **kw)


def _tail_inputs(c: int, n: int, ell: int, seed: int):
    rng = np.random.default_rng(seed)
    raw = composite(n, c, seed)
    p0 = rng.uniform(0.0, 10.0, (n // ell, c)).astype(np.float32)
    wf = (2 * np.pi * 19000.0 / RATE
          + 1e-4 * rng.standard_normal((n // ell, c))).astype(np.float32)
    return raw, p0, wf


def test_wfm_tail_matches_pallas_kernel_streaming():
    c, n, ell, sub = 4, 8192, 256, 2048
    cfg = jwfm.WFMConfig.make(RATE)
    d = len(cfg.audio_taps) - 1
    d_rows = ((d + 7) // 8) * 8
    wt = jnp.asarray(np.ascontiguousarray(pk.build_composed_w(
        np.asarray(cfg.audio_taps, np.float64), 4, sub, d_rows - d).T))
    plan = wfm_tail.TailPlan.make(twfm.WFMConfig.make(RATE).audio_taps, 4, ell,
                                  sub, "cpu")
    assert plan.d_rows == d_rows
    hist0 = np.random.default_rng(9).standard_normal(
        (d_rows, 2 * c)).astype(np.float32) * 0.3
    jh, th = jnp.asarray(hist0), torch.from_numpy(hist0)
    for call in range(2):
        raw, p0, wf = _tail_inputs(c, n, ell, call)
        ja, jh = pk.wfm_tail_packed(jnp.asarray(raw), jnp.asarray(p0),
                                    jnp.asarray(wf), jh, wt, 4, d_rows, ell,
                                    sub_block=sub, interpret=True)
        ta, th = wfm_tail.wfm_tail(plan, *(torch.from_numpy(v)
                                           for v in (raw, p0, wf)), th)
        assert ta.shape == (n // 4, 2 * c)
        assert np.abs(np.asarray(ja) - ta.numpy()).max() < 5e-4
        assert np.abs(np.asarray(jh) - th.numpy()).max() < 1e-4
        assert np.abs(ta.numpy()).max() > 0.1


def test_wfm_tail_reference_is_the_fir_definition():
    """audio[o] = sum_j h[j] a[4o - j] over [history | mono, lmr], float64."""
    c, n, ell = 2, 4096, 256
    taps = twfm.WFMConfig.make(RATE).audio_taps
    plan = wfm_tail.TailPlan.make(taps, 4, ell, 2048, "cpu")
    raw, p0, wf = _tail_inputs(c, n, ell, 3)
    hist = np.random.default_rng(4).standard_normal(
        (plan.d_rows, 2 * c)).astype(np.float32)
    y, hist2 = wfm_tail.wfm_tail(plan, *(torch.from_numpy(v)
                                         for v in (raw, p0, wf, hist)))
    lmr = wfm_tail.demux(plan, *(torch.from_numpy(v) for v in (raw, p0, wf)))
    a = np.concatenate([hist, np.concatenate([raw, lmr.numpy()], 1)], 0)
    a = a.astype(np.float64)
    idx = plan.d_rows + 4 * np.arange(n // 4)[:, None] - np.arange(len(taps))
    want = np.einsum("ojc,j->oc", a[idx], np.asarray(taps, np.float32))
    assert np.abs(y.numpy() - want).max() < 1e-5
    assert np.array_equal(hist2.numpy(), a[-plan.d_rows:].astype(np.float32))


def test_wfm_tail_cpu_runs_plain_version_without_counting():
    c, n, ell = 2, 2048, 256
    plan = wfm_tail.TailPlan.make(twfm.WFMConfig.make(RATE).audio_taps, 4, ell,
                                  2048, "cpu")
    args = [torch.from_numpy(v) for v in _tail_inputs(c, n, ell, 6)]
    hist = torch.zeros(plan.d_rows, 2 * c)
    before = wfm_tail.wfm_tail.launches
    a = wfm_tail.wfm_tail(plan, *args, hist)
    b = wfm_tail.wfm_tail_reference(plan, *args, hist)
    assert wfm_tail.wfm_tail.launches == before
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError):
        wfm_tail.wfm_tail(plan, args[0][:1024], *args[1:], hist)


# wfm_init builds every configuration now, and the notch runs on the fused
# tail (what None); wfm_demod_tm, the fused tail's route, still refuses by
# name what runs the stereo tail without K2, wfm_demod (the ids keep the
# cases' names)
@pytest.mark.parametrize("change,what", [
    (dict(rds_tap=True, stereo=False), "mono"),
    (dict(comp_decim=2, pilot_alg="pll"), "'pll' pilot"),
    (dict(stereo=False), "mono"),
    (dict(pilot_alg="pll"), "'pll' pilot"),
    (dict(notch_needed=True), None),
    (dict(tail_sub=0), "tail_sub == 0"),
], ids=["change0-mono", "change1-'pll' pilot", "change2-mono",
        "change3-'pll' pilot", "change4-notch", "change5-tail_sub == 0"])
def test_unported_wfm_options_named(change, what):
    """wfm_demod_tm runs the fused tail (stereo, the open pilot, a tail
    sub-block) with or without the notch, and refuses by name what runs
    the stereo tail without K2 (wfm_demod); wfm_init builds each
    configuration's state."""
    cfg = dataclasses.replace(twfm.WFMConfig.make(RATE), tail_sub=1024)
    bad = dataclasses.replace(cfg, **change)
    if bad.comp_decim > 1:              # the hq composite's taps
        bad = dataclasses.replace(bad, comp_taps=twfm.WFMConfig.make(
            RATE, comp_decim=2).comp_taps)
    twfm.wfm_init(bad, 2, "cpu")
    plan = twfm.tail_plan(cfg, 1024, "cpu")
    st = twfm.wfm_init(cfg, 2, "cpu")
    raw = torch.from_numpy(composite(1024, 2, 3))
    last = torch.zeros(2, dtype=torch.complex64)
    if what is None:
        _, out = twfm.wfm_demod_tm(bad, plan, st, raw, last, 1024)
        assert bool(torch.isfinite(out["left"]).all())
        assert out["left"].shape == (2, 256)
        return
    with pytest.raises(ValueError, match=what):
        twfm.wfm_demod_tm(bad, plan, st, raw, last, 1024)


def test_discriminator_plain_version():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 64)) + 1j * rng.standard_normal((3, 64))
         ).astype(np.complex64)
    last = x[:, 0] * 0.5
    j_last, j_fm = jwfm.discriminator(jnp.asarray(last), jnp.asarray(x), 0.7)
    t_last, t_fm = twfm.discriminator(torch.from_numpy(last),
                                      torch.from_numpy(x), 0.7)
    assert np.array_equal(np.asarray(j_last), t_last.numpy())
    assert np.abs(np.asarray(j_fm) - t_fm.numpy()).max() < 1e-6


def test_stereo_separation_cpu():
    """L-only 700 Hz program (bench.py:318-341) at C=1 over 20 blocks of
    32768: the R channel's 700 Hz tone, measured on the second half, is
    >= 30 dB below L's (the JAX package reads 34.6 dB)."""
    frames, kb = 32768, 20
    t = np.arange(kb * frames) / FS
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
    x = torch.from_numpy(np.stack([iq.real, iq.imag], 1).astype(np.float32))
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=frames,
                                 channels=1, mode=DemodMode.FMS), "cpu")
    st, p = rx.init_state(), rx.default_params(250_000.0)
    outs = []
    for i in range(2):
        st, out = rx.step_many(st, p, x[i * 10 * frames:(i + 1) * 10 * frames],
                               spectra=False)
        outs.append(out["audio"][:, 0])                    # [K, 2, M]
        assert bool(out["pilot_locked"][-1].all())
    aud = torch.cat(outs).permute(1, 0, 2).reshape(2, -1).double().numpy()
    half = aud.shape[-1] // 2
    tt = np.arange(aud.shape[-1] - half) / rx.cfg.audio_rate
    basis = np.stack([np.sin(2 * np.pi * 700.0 * tt),
                      np.cos(2 * np.pi * 700.0 * tt), np.ones_like(tt)], 1)
    amp = [np.hypot(*np.linalg.lstsq(basis, a[half:], rcond=None)[0][:2])
           for a in aud]
    assert 20 * np.log10(amp[0] / max(amp[1], 1e-12)) >= 30.0
