"""The WFM hq geometry of the PyTorch port against the JAX package.

On the CPU, with inputs made from numpy seeds:

  * the front end's composite decimation by 2 (K1e, the comp_taps switch;
    plain version) against the TPU kernel pk.fused_front_packed in
    interpret mode at C=64, two streaming calls of K=2 blocks of 8192
    frames, and against JAX's fir.tm_fir_decimate on JAX's own
    discriminator output;
  * the time-major decimating FIR ops/fir.tm_fir_decimate;
  * the hq Receiver (factor 4 to 512 kHz, the composite decimated to the
    256 kHz tail) at C=4 (K=3 and K=9 after a warm-up block, where JAX
    takes its XLA route, pebblesdr_tpu/demod/wfm.py:424-432) and at C=64
    (K=2, where JAX runs its Pallas K1d/K1e/K1f and K2 in interpret mode).

Bounds: the discriminator 1e-4 absolute (the TPU kernel evaluates atan2 as a
polynomial behind bf16x3 dots, tests/test_pallas.py:286); the other front
outputs and comp_hist' 3e-5 relative; the receiver's those of
tests/test_chain_batched.py:58-69 (audio 2e-4 absolute, spectra and S-meter
0.1 dB, pilot lock equal, state 1e-4).  The CUDA kernel itself is held to
the plain version on the card by tests/test_torch_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod import wfm as jwfm
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import fir as jfir
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import wfm as twfm
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import fir as tfir
from pebblesdr_tpu_torch.ops import front
from pebblesdr_tpu_torch.utils import convert

FS, N = 2_048_000, 8192
HQ_PROTECT = 400_000.0     # 2 x the WFM modes' max_output_bw
LP_TAPS = 235


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def leaf_index(c: int, field: str) -> int:
    """Index of the hq Receiver's WFMState field in the flattened state."""
    st = Receiver(ReceiverConfig(**kw(c)), "cpu").init_state()
    want = getattr(st.demod, field)
    return next(i for i, leaf in enumerate(convert.leaves(st)) if leaf is want)


def fm_plane(c: int, rows: int, seed: int) -> np.ndarray:
    """[rows, 2C] packed plane: FM stereo at 250 kHz (L 1 kHz, R 400 Hz,
    pilot), channel i at level 0.3 + 0.4 i / C and phase i pi/2 + pi/4 (the
    first discriminator rows land in every quadrant), noise at 1e-2."""
    t = np.arange(rows) / FS + seed
    lt, rt = np.sin(2 * np.pi * 1000.0 * t), np.sin(2 * np.pi * 400.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = (0.45 * (lt + rt) / 2 + 0.1 * np.sin(th)
            + 0.45 * (lt - rt) / 2 * np.sin(2 * th))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    x = np.stack([(0.3 + 0.4 * i / c)
                  * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph
                                 + np.pi / 4 + i * np.pi / 2))
                  for i in range(c)], axis=1)
    rng = np.random.default_rng(seed)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


# ------------------------------------------------------------- the front K1e

def _hq_front(c: int):
    jp = jdec.build_plan(FS, HQ_PROTECT)
    tp = tdec.build_plan(FS, HQ_PROTECT)
    plan = front.FrontPlan.make(tdec.compose_response(tp), tp.factor, "cpu")
    return jp, plan


@pytest.fixture(scope="module")
def front_runs():
    """Two streaming calls of K=2 blocks at C=64 through the Pallas kernel
    (interpret mode) with comp_taps, and through the port's plain version;
    plus the Pallas kernel without comp_taps on the same inputs (JAX's own
    full-rate discriminator output)."""
    c, k, sub = 64, 2, 2048
    jp, plan = _hq_front(c)
    h = jdec.compose_response(jp)
    f = jp.factor
    d_rows = plan.d_rows
    wt = jnp.asarray(np.ascontiguousarray(
        pk.build_composed_w(h, f, sub, d_rows - (len(h) - 1)).T))
    gain = 512_000 / (2 * np.pi * 75_000.0)
    taps = jwfm.WFMConfig.make(256_000.0, comp_decim=2).comp_taps
    tc = len(taps)
    hr = front.comp_hist_rows(tc)
    zt = 512
    hi, lo = (np.full(c, v) for v in jmix.split_freq(250_000.0, FS))
    x = fm_plane(c, 2 * k * N, 5)
    hist0 = np.zeros((hr, c), np.float32)
    hist0[hr - (tc - 1):] = 0.01 * np.random.default_rng(2).standard_normal(
        (tc - 1, c))
    js = [jnp.zeros((1, 2 * c)), jnp.zeros((c,)), jnp.zeros((d_rows, 2 * c)),
          jnp.zeros((1, 2 * c)), jnp.asarray(hist0)]
    ts = [torch.zeros(1, 2 * c), torch.zeros(c), torch.zeros(d_rows, 2 * c),
          torch.zeros(1, 2 * c), torch.from_numpy(hist0)]
    jfull_last = js[3]
    calls = []
    for call in range(2):
        xb = x[call * k * N:(call + 1) * k * N]
        kw = dict(sub_block=sub, n_block=N, raw_rows=2048, disc_gain=gain,
                  h_np=h, y_tail_rows=zt, interpret=True)
        jo = pk.fused_front_packed(
            jnp.asarray(xb), js[0], js[1], jnp.asarray(hi), jnp.asarray(lo),
            js[2], wt, f, d_rows, 0.9999, disc_last=js[3], comp_taps=taps,
            comp_hist=js[4], **kw)
        jfull = pk.fused_front_packed(
            jnp.asarray(xb), js[0], js[1], jnp.asarray(hi), jnp.asarray(lo),
            js[2], wt, f, d_rows, 0.9999, disc_last=jfull_last, **kw)
        to = front.fused_front(
            plan, torch.from_numpy(xb), ts[0], ts[1], torch.from_numpy(hi),
            torch.from_numpy(lo), ts[2], n_block=N, raw_rows=2048,
            disc_gain=gain, disc_last=ts[3], y_tail_rows=zt, comp_taps=taps,
            comp_hist=ts[4])
        calls.append((jo, jfull, to, js[4], ts[4]))
        js = [jo[1], jo[3], jo[2], jo[6], jo[7]]
        ts = [to[1], to[3], to[2], to[6], to[7]]
        jfull_last = jfull[6]
    return dict(calls=calls, taps=taps, plan=plan, c=c, k=k, zt=zt,
                fill=-(-len(h) // f), tc=tc, hr=hr)


@pytest.mark.parametrize("call", [0, 1])
def test_front_comp_matches_pallas_kernel(front_runs, call):
    r = front_runs
    jo, _, to, _, _ = r["calls"][call]
    c, k, f = r["c"], r["k"], r["plan"].factor
    assert len(jo) == len(to) == 8
    assert to[0].shape == (k, r["zt"], 2 * c)
    assert to[5].shape == (k * N // (2 * f), c)
    assert to[7].shape == (r["hr"], c)
    for i in (0, 1, 2, 6, 7):       # y-tail, dc', tail', disc_last', comp_hist'
        assert rel_err(jo[i], to[i]) < 3e-5, i
    assert np.abs(np.asarray(jo[3]) - to[3].numpy()).max() < 1e-6
    assert np.array_equal(np.asarray(jo[4]), to[4].numpy())
    # while the front FIR fills from its zero history (the first fill rows
    # of the first call) |y| falls to ~1e-6, below the TPU kernel's ~1e-5
    # bf16x3 error, and the angle is that error's: skip the half-rate
    # outputs those rows reach through the tc-tap decimator
    skip = (r["fill"] + r["tc"]) // 2 + 1 if call == 0 else 0
    d = np.abs(np.asarray(jo[5])[skip:] - to[5].numpy()[skip:]).max()
    assert d < 1e-4, d
    assert np.abs(to[5].numpy()).max() > 0.1


@pytest.mark.parametrize("call", [0, 1])
def test_front_comp_plain_is_tm_fir_decimate_of_jax_disc(front_runs, call):
    """The plain K1e == JAX fir.tm_fir_decimate on the full-rate discriminator
    output of JAX's Pallas kernel (same inputs, same carried history)."""
    r = front_runs
    _, jfull, to, jhist, _ = r["calls"][call]
    tc = r["tc"]
    want, _ = jfir.tm_fir_decimate(jfull[5], np.asarray(r["taps"]),
                                   jhist[r["hr"] - (tc - 1):], 2)
    skip = (r["fill"] + tc) // 2 + 1 if call == 0 else 0
    d = np.abs(np.asarray(want)[skip:] - to[5].numpy()[skip:]).max()
    assert d < 1e-4, d


def test_front_comp_plain_is_the_fir_definition():
    """disc[j] = sum_i ct[i] d[2j - i] over [comp_hist | d], float64, and
    comp_hist' = the last hr rows of d."""
    c = 3
    _, plan = _hq_front(c)
    taps = twfm.WFMConfig.make(256_000.0, comp_decim=2).comp_taps
    tc, hr = len(taps), front.comp_hist_rows(len(taps))
    x = torch.from_numpy(fm_plane(c, 2 * 4096, 8))
    hist = torch.randn(hr, c, generator=torch.Generator().manual_seed(1))
    hi, lo = (torch.full((c,), float(v))
              for v in jmix.split_freq(250_000.0, FS))
    z = (torch.zeros(1, 2 * c), torch.zeros(c), hi, lo,
         torch.zeros(plan.d_rows, 2 * c))
    full = front.fused_front_reference(plan, x, *z, n_block=4096,
                                       disc_gain=0.7,
                                       disc_last=torch.zeros(1, 2 * c))
    half = front.fused_front_reference(plan, x, *z, n_block=4096,
                                       disc_gain=0.7,
                                       disc_last=torch.zeros(1, 2 * c),
                                       comp_taps=taps, comp_hist=hist)
    d = torch.cat([hist, full[5]]).double().numpy()
    m = full[5].shape[0]
    idx = hr + 2 * np.arange(m // 2)[:, None] - np.arange(tc)
    want = np.einsum("jic,i->jc", d[idx], np.asarray(taps, np.float32))
    assert np.abs(half[5].numpy() - want).max() < 1e-5
    assert torch.equal(half[7], torch.cat([hist, full[5]])[-hr:])
    assert torch.equal(half[6], full[6])


@pytest.mark.parametrize("change", [
    dict(disc_gain=0.0),                       # comp_taps needs the discriminator
    dict(comp_hist=torch.zeros(30, 2)),        # hr = 32 rows
    dict(comp_hist=torch.zeros(32, 3)),        # C = 2
    dict(comp_hist=None),
    dict(comp_taps=np.ones(40) / 40),          # more taps than the kernel takes
])
def test_front_comp_arguments_checked(change):
    c = 2
    _, plan = _hq_front(c)
    taps = twfm.WFMConfig.make(256_000.0, comp_decim=2).comp_taps
    kw = dict(n_block=4096, disc_gain=0.7, disc_last=torch.zeros(1, 2 * c),
              comp_taps=taps, comp_hist=torch.zeros(32, c))
    kw.update(change)
    with pytest.raises(ValueError):
        front.fused_front(plan, torch.zeros(8192, 2 * c),
                          torch.zeros(1, 2 * c), torch.zeros(c),
                          torch.zeros(c), torch.zeros(c),
                          torch.zeros(plan.d_rows, 2 * c), **kw)


@pytest.mark.parametrize("m,c,seg", [(8192, 5, 512), (3072, 4, 512),
                                     (1024, 64, 256)])
def test_tm_fir_decimate_matches_jax_streaming(m, c, seg):
    taps = jwfm.WFMConfig.make(256_000.0, comp_decim=2).comp_taps
    rng = np.random.default_rng(m + c)
    jt = np.zeros((len(taps) - 1, c), np.float32)
    tt = torch.from_numpy(jt)
    jt = jnp.asarray(jt)
    for _ in range(2):
        x = rng.standard_normal((m, c)).astype(np.float32)
        jy, jt = jfir.tm_fir_decimate(jnp.asarray(x), np.asarray(taps), jt, 2,
                                      seg=seg)
        ty, tt = tfir.tm_fir_decimate(torch.from_numpy(x), taps, tt, 2,
                                      seg=seg)
        assert ty.shape == (m // 2, c)
        assert np.abs(np.asarray(jy) - ty.numpy()).max() < 1e-5
        assert np.array_equal(np.asarray(jt), tt.numpy())


# ---------------------------------------------------------- the hq Receiver

def kw(c):
    return dict(sample_rate=FS, frames_per_buffer=N, channels=c,
                mode=DemodMode.FMS, wfm_hq=True)


def jkw(c):
    return dict(kw(c), mode=JaxMode.FMS)


@pytest.fixture(scope="module")
def rx_runs():
    res = {}
    jrx = JaxReceiver(JaxConfig(use_pallas=True, **jkw(4)))
    trx = Receiver(ReceiverConfig(**kw(4)), "cpu")
    jp = jrx.default_params(250_000.0)
    tp = convert.params_from_numpy(trx, jleaves(jp))
    x0 = fm_plane(4, N, 7)
    jst, jo = jax.jit(jrx.step)(jrx.init_state(), jp, jnp.asarray(x0))
    tst, to = trx.step(trx.init_state(), tp, torch.from_numpy(x0))
    res["step"] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))
    # the warmed-up JAX state, converted leaf by leaf (comp_tail included)
    tst = convert.state_from_numpy(trx, jleaves(jst))
    for k, seed in ((3, 0), (9, 1)):
        x = fm_plane(4, k * N, seed)
        jst, jo = jrx._step_many_impl(jst, jp, jnp.asarray(x))
        tst, to = trx.step_many(tst, tp, torch.from_numpy(x))
        res[k] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))

    jrx = JaxReceiver(JaxConfig(use_pallas=True, **jkw(64)))
    trx = Receiver(ReceiverConfig(**kw(64)), "cpu")
    assert jrx.pick_fold(2) == 1
    jp = jrx.default_params(250_000.0)
    tp = convert.params_from_numpy(trx, jleaves(jp))
    x = fm_plane(64, 2 * N, 3)
    jst, jo = jrx._step_many_impl(jrx.init_state(), jp, jnp.asarray(x))
    tst, to = trx.step_many(trx.init_state(), tp, torch.from_numpy(x))
    res["c64"] = (jo, to, jleaves(jst), convert.state_to_numpy(tst))
    return res


RUNS = ["step", 3, 9, "c64"]


@pytest.mark.parametrize("run", RUNS)
def test_hq_audio(rx_runs, run):
    jo, to, _, _ = rx_runs[run]
    a, b = np.asarray(jo["audio"]), to["audio"].numpy()
    assert a.shape == b.shape and a.shape[-2] == 2
    assert np.abs(a - b).max() < 2e-4
    assert np.abs(a).max() > 0.1


@pytest.mark.parametrize("key", ["spectrum", "zoomed"])
@pytest.mark.parametrize("run", RUNS)
def test_hq_spectra(rx_runs, run, key):
    jo, to, _, _ = rx_runs[run]
    a, b = np.asarray(jo[key]), to[key].numpy()
    assert a.shape == b.shape
    # at C=64 the 512 kHz zoom window holds noise-floor dips (the floor is
    # near -78 dB) down to -131 dB, where the TPU kernel's bf16x3 dots leave
    # an error floor that moves a bin by 0.1 dB at -115 dB and 0.3 dB at
    # -131 dB: the 0.1 dB bound holds on the bins above -110 dB, which are
    # all but about one in ten thousand
    deep = a < -110.0
    assert deep.mean() < 1e-3
    assert np.abs(a - b)[~deep].max() < 0.1
    assert np.abs(a - b).max() < 1.0
    assert np.array_equal(np.asarray(jo["overload"]), to["overload"].numpy())


@pytest.mark.parametrize("run", RUNS)
def test_hq_smeter_squelch_and_pilot(rx_runs, run):
    jo, to, _, _ = rx_runs[run]
    for key in jo["smeter"]:
        assert np.abs(np.asarray(jo["smeter"][key])
                      - to["smeter"][key].numpy()).max() < 0.1, key
    assert np.array_equal(np.asarray(jo["squelch_open"]),
                          to["squelch_open"].numpy())
    locked = np.asarray(jo["pilot_locked"])
    assert np.array_equal(locked, to["pilot_locked"].numpy())
    assert locked.all()


@pytest.mark.parametrize("run", RUNS)
def test_hq_carried_state(rx_runs, run):
    _, _, js, ts = rx_runs[run]
    assert len(js) == len(ts)
    c = 64 if run == "c64" else 4
    comp_leaf, lp_leaf = leaf_index(c, "comp_tail"), leaf_index(c, "lp_tail_mono")
    assert js[comp_leaf].shape == ts[comp_leaf].shape == (c, 30)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if i == lp_leaf and run != "c64":
            # the JAX XLA route's packed low-pass history: only the last T-1
            # rows carry weight (tests/test_torch_receiver_wfm.py)
            a, b = a[-(LP_TAPS - 1):], b[-(LP_TAPS - 1):]
        d = np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max() \
            if a.size else 0.0
        assert d < 1e-4, (i, d)


def test_hq_geometry_of_the_bench_row():
    """bench.py's wfm_hq row: factor 4 to 512 kHz (135-tap composed
    response), blocks of 8192 at the front and 4096 at the 256 kHz tail, the
    31-tap composite decimator with 32 history rows, zoom 2048, the stereo
    tail as at the default geometry, 768 audio samples per block, the
    discriminator gain at 512 kHz."""
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=32768,
                                 channels=64, mode=DemodMode.FMS,
                                 wfm_hq=True), "cpu")
    assert (rx.plan.factor, rx.demod_rate, rx.front.h.numel(), rx.blk,
            rx.zoom_bins) == (4, 512_000, 135, 8192, 2048)
    assert (rx.wfm_comp_decim, rx.wfm_tail_blk, rx.wfm_cfg.sample_rate,
            len(rx.wfm_cfg.comp_taps)) == (2, 4096, 256_000, 31)
    assert front.comp_hist_rows(31) == 32
    assert (rx.wfm_tail.factor, rx.wfm_tail.h.numel(), rx.wfm_tail.d_rows,
            rx.wfm_tail.ell, rx.wfm_tail.sub) == (4, 235, 240, 256, 2048)
    assert rx.audio_blk == 768
    assert rx.disc_gain == pytest.approx(512_000 / (2 * np.pi * 75_000.0))
    st = rx.init_state()
    assert st.demod.comp_tail.shape == (64, 30)
    jrx = JaxReceiver(JaxConfig(sample_rate=FS, frames_per_buffer=32768,
                                channels=64, mode=JaxMode.FMS, wfm_hq=True,
                                use_pallas=True))
    assert (jrx.plan.factor, jrx.blk, jrx.wfm_tail_blk) == (
        rx.plan.factor, rx.blk, rx.wfm_tail_blk)
    assert np.array_equal(np.asarray(jrx.wfm_cfg.comp_taps),
                          rx.wfm_cfg.comp_taps)


@pytest.mark.parametrize("fs", [1_024_000, 2_048_000])
def test_hq_rates_match_jax(fs):
    """The hq plan, composite decimation and tail block of the JAX Receiver
    at two device rates (both reach 512 kHz, so both decimate by 2)."""
    cfg = dict(sample_rate=fs, frames_per_buffer=8192, channels=2,
               wfm_hq=True)
    rx = Receiver(ReceiverConfig(mode=DemodMode.FMS, **cfg), "cpu")
    jrx = JaxReceiver(JaxConfig(mode=JaxMode.FMS, use_pallas=True, **cfg))
    assert (rx.plan.factor, rx.demod_rate, rx.wfm_comp_decim,
            rx.wfm_tail_blk, rx.audio_blk) == (
        jrx.plan.factor, jrx.demod_rate, jrx.wfm_comp_decim,
        jrx.wfm_tail_blk, jrx.audio_blk)
    assert rx.wfm_comp_decim == 2
    js = jleaves(jrx.init_state())
    ts = convert.state_to_numpy(rx.init_state())
    assert [a.shape for a in js] == [b.shape for b in ts]


def test_hq_demod_needs_the_front_history():
    """At comp_decim > 1 the front end decimates the composite (K1e), so the
    stereo chain takes its carried history and refuses to run without it;
    at comp_decim == 1 it refuses one."""
    for decim, comp_tail_new in ((2, None), (1, torch.zeros(2, 30))):
        cfg = twfm.WFMConfig.make(256_000.0, comp_decim=decim)
        cfg = dataclasses.replace(cfg, tail_sub=1024)
        st = twfm.wfm_init(cfg, 2, "cpu")
        with pytest.raises(ValueError, match="comp_tail_new"):
            twfm.wfm_demod_tm(cfg, twfm.tail_plan(cfg, 1024, "cpu"), st,
                              torch.zeros(1024, 2),
                              torch.zeros(2, dtype=torch.complex64), 1024,
                              comp_tail_new=comp_tail_new)
