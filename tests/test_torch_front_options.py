"""K1's front-end options in the PyTorch port: int16 entry (K1a), static IQ
balance (K1b) and the NB1/NB2 noise blanker (K1c), alone and with the WFM
discriminator, plus the folded entry plane's inverse.

On the CPU: the plain version (fused_front_reference, which the wrapper runs
for CPU tensors) against the TPU kernel pk.fused_front_packed in interpret
mode over three streaming calls (y and the decimator tail' within 3e-5
relative as tests/test_pallas.py:63, nb_avg' within 1e-6 absolute as
tests/test_pallas.py:136, nb_tail' identical), and against the staged JAX
twins (scanops.iq_balance, scanops.noise_blanker_chunked), whose blanked
positions must equal the plain version's.  The blanker's spike test is a
comparison, so every test that compares its outputs first asserts that no
sample's ratio mag2 / (thr^2 max(avg, 1e-18)) lies in [0.999, 1.001].  The
CUDA kernel is held to the plain version on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu.ops import scanops
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import front

FS = 2_048_000
C, N = 4, 8192
RTOL = 3e-5
NB = {"nb1": (3.3, 7, 0.001, "blank"), "nb2": (3.3, 7, 0.001, "average")}
IQ = (1.05, 0.02)
FORMS = {
    "int16": dict(int16=True),
    "iq": dict(iq=True),
    "nb1_iq": dict(iq=True, nb="nb1"),
    "nb2_iq": dict(iq=True, nb="nb2"),
    "nb1_disc": dict(nb="nb1", disc=True),
}


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def impulsive_blocks(c, n, blocks, seed, spikes=True):
    """Complex noise (RMS 0.14) with a DC offset; impulses of 8+8j (80x the
    RMS) at chunk, sub-block and block seams, so the spike tail carries
    across them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(blocks):
        b = (0.1 * (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n)))
             + 0.05 - 0.03j).astype(np.complex64)
        if spikes:
            for pos in (100, 511, 2046, 2049, 4600, n - 3):
                b[:, pos] += 8.0 + 8.0j
        out.append(b)
    return out


def fm_blocks(c, n, blocks, seed):
    """FM at 250 kHz (60 kHz deviation, 700 Hz), channel i offset by i pi/2,
    with 1e-3 noise and the impulses of impulsive_blocks (the WFM form)."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * n) / FS
    ph = 2 * np.pi * np.cumsum(60e3 * np.sin(2 * np.pi * 700.0 * t)) / FS
    iq = np.stack([0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph
                                      + i * np.pi / 2)) for i in range(c)])
    iq = iq + 1e-3 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape))
    out = []
    for k in range(blocks):
        b = iq[:, k * n:(k + 1) * n].astype(np.complex64)
        for pos in (100, 511, 2046, 2049, 4600, n - 3):
            b[:, pos] += 8.0 + 8.0j
        out.append(b)
    return out


def pack(b):
    return np.ascontiguousarray(np.concatenate([b.real.T, b.imag.T], axis=-1))


def to_i16(x):
    return np.clip(np.round(x * 32768.0 / 10.0), -32768, 32767).astype(np.int16)


def tunes(c, one=False):
    splits = [jmix.split_freq(250_000.0 + (0 if one else 1234.5 * i), FS)
              for i in range(c)]
    return (np.array([s[0] for s in splits]), np.array([s[1] for s in splits]))


def plan_for(protect):
    p = tdec.build_plan(FS, protect)
    return p, front.FrontPlan.make(tdec.compose_response(p), p.factor, "cpu")


def assert_nb_margin(plan, x, dc, iq, nb, nb_avg, nb_tail):
    """No sample of this call sits within 0.1 % of the spike threshold, from
    the plain version's own intermediates.  Returns the dilated flags."""
    _, z = front.dc_iq_reference(plan, front.dequantize(x), dc, *iq)
    fl = front.nb_flags(z, nb, nb_avg, nb_tail)
    ratio = fl.mag2 / (np.float32(nb[0] * nb[0]) * fl.avg.clamp(min=1e-18))
    near = ((ratio >= 0.999) & (ratio <= 1.001)).sum()
    assert int(near) == 0, f"{int(near)} samples within 0.1 % of the threshold"
    return fl.widened


@pytest.mark.parametrize("form", list(FORMS))
def test_plain_matches_pallas_kernel_streaming(form):
    opt = FORMS[form]
    disc = opt.get("disc", False)
    protect = 200_000 if disc else 30_000
    jp, plan = plan_for(protect)
    d_rows = plan.d_rows
    h = jdec.compose_response(jp)
    wt = jnp.asarray(np.ascontiguousarray(
        pk.build_composed_w(h, jp.factor, 2048, d_rows - (len(h) - 1)).T))
    hi, lo = tunes(C, one=disc)
    gain = jp.rate_out / (2 * np.pi * 75_000.0) if disc else 0.0
    zt = 512 if disc else 0                   # y-tail rows, two 256-row steps
    nb = NB.get(opt.get("nb"))
    jst = dict(dc=jnp.zeros((1, 2 * C)), ph=jnp.zeros((C,)),
               tl=jnp.zeros((d_rows, 2 * C)), avg=jnp.zeros((1, 2 * C)),
               nbt=jnp.zeros((16, 2 * C)), dl=jnp.zeros((1, 2 * C)))
    tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    iq_j = (jnp.float32(IQ[0]), jnp.float32(IQ[1])) if opt.get("iq") else ()
    iq_t = ((torch.tensor(IQ[0]), torch.tensor(IQ[1])) if opt.get("iq")
            else (None, None))
    saw_blank = 0
    blocks = (fm_blocks(C, N, 3, 1) if disc
              else impulsive_blocks(C, N, 3, 1, spikes=nb is not None))
    for call, b in enumerate(blocks):
        x = pack(b)
        if opt.get("int16"):
            x = to_i16(x)
        kw_j = dict(sub_block=2048, n_block=N, raw_rows=2048, interpret=True)
        kw_t = dict(n_block=N, raw_rows=2048)
        if iq_j:
            kw_j.update(iq_gain=iq_j[0], iq_phase=iq_j[1])
            kw_t.update(iq_gain=iq_t[0], iq_phase=iq_t[1])
        if nb:
            widened = assert_nb_margin(plan, torch.from_numpy(x), tst["dc"],
                                       iq_t, nb, tst["avg"], tst["nbt"])
            saw_blank += int(widened.sum())
            kw_j.update(nb=nb, nb_avg=jst["avg"], nb_tail=jst["nbt"])
            kw_t.update(nb=nb, nb_avg=tst["avg"], nb_tail=tst["nbt"])
        if disc:
            kw_j.update(disc_gain=gain, disc_last=jst["dl"], y_tail_rows=zt,
                        h_np=h)
            kw_t.update(disc_gain=gain, disc_last=tst["dl"], y_tail_rows=zt)
        jo = pk.fused_front_packed(jnp.asarray(x), jst["dc"], jst["ph"],
                                   jnp.asarray(hi), jnp.asarray(lo), jst["tl"],
                                   wt, jp.factor, d_rows, 0.9999, **kw_j)
        to = front.fused_front_reference(
            plan, torch.from_numpy(x), tst["dc"], tst["ph"],
            torch.from_numpy(hi), torch.from_numpy(lo), tst["tl"], **kw_t)
        assert len(jo) == len(to)
        assert rel_err(jo[0], to[0]) < RTOL          # y (or its y-tails)
        assert rel_err(jo[1], to[1]) < RTOL          # dc'
        assert rel_err(jo[2], to[2]) < RTOL          # decimator tail'
        assert np.abs(np.asarray(jo[3]) - to[3].numpy()).max() < 1e-6
        assert np.array_equal(np.asarray(jo[4]), to[4].numpy())   # raw
        pos = 5
        if nb:
            assert np.abs(np.asarray(jo[5]) - to[5].numpy()).max() < 1e-6
            assert np.array_equal(np.asarray(jo[6]), to[6].numpy())
            pos = 7
        if disc:
            # 1e-4 absolute, the TPU kernel's polynomial atan2
            # (tests/test_pallas.py:286); the first call's leading rows see
            # the startup blank (the whole first chunk) and are near zero
            skip = 128 if call == 0 else 0
            assert np.abs(np.asarray(jo[pos])[skip:]
                          - to[pos].numpy()[skip:]).max() < 1e-4
            assert rel_err(jo[pos + 1], to[pos + 1]) < RTOL
        jst.update(dc=jo[1], tl=jo[2], ph=jo[3])
        tst.update(dc=to[1], tl=to[2], ph=to[3])
        if nb:
            jst.update(avg=jo[5], nbt=jo[6])
            tst.update(avg=to[5], nbt=to[6])
        if disc:
            jst["dl"], tst["dl"] = jo[pos + 1], to[pos + 1]
    if nb:
        # the first chunk of a fresh state blanks, and every impulse after it
        assert saw_blank > 512 * 2 * C


@pytest.mark.parametrize("mode", ["nb1", "nb2"])
def test_plain_matches_staged_jax_twins(mode):
    """DC blocker -> scanops.iq_balance -> scanops.noise_blanker_chunked ->
    mix -> decimator, streaming: the same y within 3e-5, the same blanked
    positions, the same carried average."""
    jp, plan = plan_for(30_000)
    nb = NB[mode]
    hi, lo = tunes(C)
    dc, ms, ds = (jnp.zeros((C,), jnp.complex64), jmix.mixer_init(C),
                  jdec.state_init(jp, C))
    nbs = scanops.noise_blanker_chunked_init(C)
    st = dict(dc=torch.zeros(1, 2 * C), ph=torch.zeros(C),
              tl=torch.zeros(plan.d_rows, 2 * C),
              avg=torch.zeros(1, 2 * C), nbt=torch.zeros(16, 2 * C))
    iq = (torch.tensor(IQ[0]), torch.tensor(IQ[1]))
    refs, outs = [], []
    for b in impulsive_blocks(C, N, 3, 2):
        x = torch.from_numpy(pack(b))
        widened = assert_nb_margin(plan, x, st["dc"], iq, nb, st["avg"],
                                   st["nbt"])
        dc, z = jiir.dc_removal_chunked(dc, jnp.asarray(b), alpha=0.9999)
        z = scanops.iq_balance(z, *IQ)
        nbs, zb = scanops.noise_blanker_chunked(
            nbs, z, threshold=nb[0], blank_width=nb[1], alpha=nb[2],
            mode=nb[3])
        blanked = (np.asarray(zb) != np.asarray(z)).T          # [N, C]
        assert np.array_equal(blanked, widened[:, :C].numpy())
        assert np.array_equal(widened[:, :C], widened[:, C:])
        ms, y = jmix.mix(ms, zb, jnp.asarray(hi), jnp.asarray(lo))
        ds, y = jdec.apply(jp, ds, y)
        refs.append(np.asarray(y))
        out = front.fused_front(plan, x, st["dc"], st["ph"],
                                torch.from_numpy(hi), torch.from_numpy(lo),
                                st["tl"], n_block=N, iq_gain=iq[0],
                                iq_phase=iq[1], nb=nb, nb_avg=st["avg"],
                                nb_tail=st["nbt"])
        outs.append((out[0][:, :C].T + 1j * out[0][:, C:].T).numpy())
        st.update(dc=out[1], tl=out[2], ph=out[3], avg=out[5], nbt=out[6])
        np.testing.assert_allclose(out[5][0, :C].numpy(),
                                   np.asarray(nbs.mag_avg), atol=1e-6)
    ref, got = np.concatenate(refs, -1), np.concatenate(outs, -1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < RTOL


def test_int16_plane_equals_its_dequantised_float_plane():
    """The int16 entry is exact: the same results as the float32 plane of
    the dequantised values, bit for bit."""
    _, plan = plan_for(30_000)
    x16 = to_i16(pack(impulsive_blocks(C, N, 1, 3)[0]))
    hi, lo = (torch.from_numpy(a) for a in tunes(C))
    st = (torch.zeros(1, 2 * C), torch.zeros(C), hi, lo,
          torch.zeros(plan.d_rows, 2 * C))
    a = front.fused_front(plan, torch.from_numpy(x16), *st, n_block=N)
    b = front.fused_front(plan, torch.from_numpy(x16.astype(np.float32)
                                                 / 32768.0), *st, n_block=N)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("fold,c", [(4, 2), (2, 3), (8, 1)])
def test_unfold_inverts_fold_plane(fold, c):
    rng = np.random.default_rng(fold)
    x = rng.standard_normal((fold * 4096, 2 * c)).astype(np.float32)
    xf = front.fold_plane_np(x, fold)
    assert np.array_equal(xf, pk.fold_plane_np(x, fold))
    assert xf.shape == (4096, 2 * fold * c)
    assert torch.equal(front.unfold_plane(torch.from_numpy(xf), fold),
                       torch.from_numpy(x))


@pytest.mark.parametrize("bad", [
    dict(nb=(3.3, 7, 0.001, "median")),
    dict(nb=(3.3, 17, 0.001, "blank")),
    dict(nb=(3.3, 7, 0.001, "blank")),                 # no carried state
    dict(iq_gain=torch.tensor(1.0)),                   # no iq_phase
    dict(dtype=torch.float64),                         # neither f32 nor i16
])
def test_option_arguments_checked(bad):
    _, plan = plan_for(30_000)
    c = 2
    bad = dict(bad)
    x = torch.zeros(2048, 2 * c, dtype=bad.pop("dtype", torch.float32))
    with pytest.raises(ValueError):
        front.fused_front(plan, x, torch.zeros(1, 2 * c), torch.zeros(c),
                          torch.zeros(c), torch.zeros(c),
                          torch.zeros(plan.d_rows, 2 * c), **bad)


@pytest.mark.parametrize("ntaps,factor", [(711, 32), (283, 8), (9, 8)])
def test_nb_smem_layout_fits_two_blocks_per_sm(ntaps, factor):
    """The blanker's extra shared memory (the entering averages, 15 flag
    words of context plus one unit's, and one unit's dilated words) sits
    after the base layout's regions, which it leaves as they are; with it
    front_fir still fits one block (232448 bytes) in float32 and int16, and
    the int16 stages take half the float32 stages' bytes."""
    base = front.fir_march_layout(ntaps, factor)
    lay = front.fir_march_layout(ntaps, factor, nb=True)
    unit = max(lay["hist"], lay["step_rows"])
    for key in ("ring_re", "ring_im", "fine", "taps", "red"):
        assert lay[key] == base[key]
    assert lay["smem"] - lay["flags"] >= (15 + unit) * 2 + unit * 2
    assert lay["smem"] > base["smem"]
    i16 = front.fir_march_layout(ntaps, factor, nb=True, elem=2)
    assert 2 * i16["stage_bytes"] == lay["stage_bytes"]
    assert max(lay["smem"], i16["smem"]) <= 232448
    plan = front.FrontPlan.make(np.full(ntaps, 1.0 / ntaps), factor, "cpu")
    assert plan.smem_bytes == base["smem"]


@pytest.mark.parametrize("nb", [False, True])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("protect", [30_000, 200_000, 400_000])
def test_every_port_plan_fits_front_fir(protect, elem, nb):
    """The AM, WFM and hq plans the port runs have a front_fir layout, with
    and without the blanker, on float32 and int16 planes."""
    p = tdec.build_plan(FS, protect)
    h = tdec.compose_response(p)
    lay = front.fir_march_layout(len(h), p.factor, nb=nb, elem=elem)
    assert lay is not None and lay["smem"] <= 232448
    assert lay["dp"] * p.factor >= len(h)


@pytest.mark.parametrize("c,dtype,tma", [(8, torch.float32, True),
                                         (4, torch.float32, True),
                                         (3, torch.float32, False),
                                         (6, torch.float32, False),
                                         (13, torch.float32, False),
                                         (6, torch.int16, False),
                                         (12, torch.int16, False),
                                         (64, torch.int16, True)])
def test_fir_staging_path_follows_the_row_pitch(c, dtype, tma):
    """front_fir stages by tensor-map boxes when the im lanes start on a
    16-byte boundary (float32: C % 4 == 0; int16: C % 8 == 0; the row pitch
    is then a multiple of 16 bytes too), else element by element."""
    assert front.fir_tma(c, dtype) is tma
