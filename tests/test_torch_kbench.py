"""The K1 probes of the PyTorch port (ops/kprobe.py) and its probe bench
(tools/kbench2.py), on the CPU.

The plain copy floors are held bit-equal to the Pallas floors of the JAX
package's tools/kbench2.py, copied here and run in interpret mode.  Each
front variant's plain version is held, over two streaming calls from a
random state, to the TPU kernel the variants are copies of
(pk.fused_front_packed at the same sub_block, interpret mode) and to the
port's own K1 plain version, within the 3e-5 relative bound of
tests/test_pallas.py:63.  The CUDA kernels are held to the plain versions
on the card by tests/test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import front, kprobe
from pebblesdr_tpu_torch.tools import kbench2

FS = 2_048_000
RTOL = 3e-5
C, T = 4, 8192
factor = 32   # the AM plan's, which the copied floors below read


# tools/kbench2.py:82-99, verbatim but for interpret=True (no TPU here)
def floor_kernel(xr_ref, xi_ref, yr_ref, yi_ref):
    m = yr_ref.shape[0]
    yr_ref[:, :] = xr_ref[:m, :]
    yi_ref[:, :] = xi_ref[:m, :]


def floor_call(xr, xi, sub):
    n, c = xr.shape
    nsub = n // sub
    m_sub = sub // factor
    return pl.pallas_call(
        floor_kernel, grid=(nsub,),
        in_specs=[pl.BlockSpec((sub, c), lambda s: (s, 0)),
                  pl.BlockSpec((sub, c), lambda s: (s, 0))],
        out_specs=[pl.BlockSpec((m_sub, c), lambda s: (s, 0)),
                   pl.BlockSpec((m_sub, c), lambda s: (s, 0))],
        out_shape=[jax.ShapeDtypeStruct((nsub * m_sub, c), jnp.float32),
                   jax.ShapeDtypeStruct((nsub * m_sub, c), jnp.float32)],
        interpret=True,
    )(xr, xi)


# tools/kbench2.py:307-321 (main2's fk and its call), verbatim but for
# interpret=True and n, c2 taken from the block
def fk(x_ref, y_ref):
    m = y_ref.shape[0]
    y_ref[:, :] = x_ref[:m, :]


def fk_call(xb, _sub):
    n, c2 = xb.shape
    nsub = n // _sub
    m_sub = _sub // 32
    return pl.pallas_call(
        fk, grid=(nsub,),
        in_specs=[pl.BlockSpec((_sub, c2), lambda s: (s, 0))],
        out_specs=pl.BlockSpec((m_sub, c2), lambda s: (s, 0)),
        out_shape=jax.ShapeDtypeStruct((nsub * m_sub, c2), jnp.float32),
        interpret=True,
    )(xb)


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def plan():
    """The AM plan of the port's Receiver, as the probe bench takes it."""
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=T,
                                 channels=C, mode=DemodMode.AM,
                                 agc_stride=16), "cpu")
    return rx.front


def _tunes(c):
    s = [jmix.split_freq(250_000.0 + 1234.5 * i, FS) for i in range(c)]
    return np.array([v[0] for v in s]), np.array([v[1] for v in s])


@pytest.mark.parametrize("sub", [2048, 4096, 8192])
def test_floors_bit_equal_to_pallas(sub):
    rng = np.random.default_rng(sub)
    xr, xi = (rng.standard_normal((T, C)).astype(np.float32) for _ in range(2))
    jr, ji = floor_call(jnp.asarray(xr), jnp.asarray(xi), sub)
    tr, ti = kprobe.probe_floor((torch.from_numpy(xr), torch.from_numpy(xi)),
                                sub, factor)
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    xb = np.concatenate([xr, xi], 1)
    (ty,) = kprobe.probe_floor((torch.from_numpy(xb),), sub, 32)
    assert np.array_equal(np.asarray(fk_call(jnp.asarray(xb), sub)),
                          ty.numpy())


def _state(variant, plan, rng):
    """A random carried state (packed dc [1, 2C], tail [d_rows, 2C], phase
    [C]) and the same state in the variant's layout."""
    d = plan.d_rows
    dc = (0.05 * rng.standard_normal((1, 2 * C))).astype(np.float32)
    tail = (0.3 * rng.standard_normal((d, 2 * C))).astype(np.float32)
    ph = rng.uniform(0.0, 1.0, C).astype(np.float32)
    x = torch.zeros(T, 2 * C)
    return (dc, tail, ph), kprobe.to_layout(
        variant, x, *(torch.from_numpy(v) for v in (dc, tail, ph)))[1:]


def _packed(variant, y, dc, tail, ph):
    """A variant's (y, dc', tail', phase') in the packed layout of K1."""
    if variant in ("v4", "v5"):
        assert torch.equal(ph[:C], ph[C:])
    return kprobe.from_layout(variant, y, dc, tail, ph)


def _plane(rng):
    x = rng.standard_normal((T, 2 * C)) * 0.5 + 0.2   # a DC offset
    return x.astype(np.float32)


def _variant_input(variant, x):
    return kprobe.to_layout(variant, torch.from_numpy(x), torch.zeros(1, 2 * C),
                            torch.zeros(0, 2 * C), torch.zeros(C))[0]


@pytest.mark.parametrize("sub", [2048, 4096])
@pytest.mark.parametrize("variant,kt", kprobe.FORMS)
def test_front_variant_matches_pallas_kernel(plan, variant, kt, sub):
    """Two streaming calls from a random state against the TPU kernel at
    the same sub_block, its interpret path (which replaces the Mosaic-only
    roll), wt from pk.build_composed_w."""
    rng = np.random.default_rng(11)
    h = plan.h.numpy().astype(np.float64)
    wt = jnp.asarray(np.ascontiguousarray(pk.build_composed_w(
        h, plan.factor, sub, plan.d_rows - (len(h) - 1)).T))
    hi, lo = _tunes(C)
    (jdc, jtl, jph), st = _state(variant, plan, rng)
    jdc, jtl, jph = map(jnp.asarray, (jdc, jtl, jph))
    for _ in range(2):
        x = _plane(rng)
        jy, jdc, jtl, jph, _ = pk.fused_front_packed(
            jnp.asarray(x), jdc, jph, jnp.asarray(hi, jnp.float32),
            jnp.asarray(lo, jnp.float32), jtl, wt, plan.factor, plan.d_rows,
            0.9999, sub_block=sub, interpret=True)
        out = kprobe.probe_front(variant, plan, _variant_input(variant, x),
                                 st[0], st[2], hi, lo, st[1], sub, kt)
        y, dc, tail, ph = _packed(variant, *out)
        assert rel_err(jy, y) < RTOL
        assert rel_err(jdc, dc) < RTOL
        assert rel_err(jtl, tail) < RTOL
        assert rel_err(jph, ph) < RTOL
        st = (out[1], out[2], out[3])


@pytest.mark.parametrize("sub", [2048, 4096])
@pytest.mark.parametrize("variant,kt", kprobe.FORMS)
def test_front_variant_matches_port_k1(plan, variant, kt, sub):
    """The same function as K1's base form: against fused_front_reference
    (its split form at 2048 rows, its fine phasors in float32)."""
    rng = np.random.default_rng(12)
    hi, lo = _tunes(C)
    (dc, tl, ph), st = _state(variant, plan, rng)
    k1 = tuple(torch.from_numpy(v) for v in (dc, ph, tl))
    for _ in range(2):
        x = _plane(rng)
        ry, rdc, rtl, rph, _ = front.fused_front_reference(
            plan, torch.from_numpy(x), k1[0], k1[1],
            torch.from_numpy(hi).float(), torch.from_numpy(lo).float(), k1[2])
        out = kprobe.probe_front_reference(
            variant, plan, _variant_input(variant, x), st[0], st[2], hi, lo,
            st[1], sub, kt)
        y, dc, tail, ph = _packed(variant, *out)
        for a, b in ((ry, y), (rdc, dc), (rtl, tail), (rph, ph)):
            assert rel_err(a, b) < RTOL
        k1, st = (rdc, rph, rtl), (out[1], out[2], out[3])


def test_cpu_wrappers_run_plain_versions_without_counting(plan):
    rng = np.random.default_rng(13)
    x = _plane(rng)
    hi, lo = _tunes(C)
    _, (dc, tail, ph) = _state("v4", plan, rng)
    before = (kprobe.probe_floor.launches, kprobe.probe_front.launches)
    a = kprobe.probe_front("v4", plan, torch.from_numpy(x), dc, ph, hi, lo,
                           tail, 2048)
    b = kprobe.probe_front_reference("v4", plan, torch.from_numpy(x), dc, ph,
                                     hi, lo, tail, 2048)
    f = kprobe.probe_floor((torch.from_numpy(x),), 2048, plan.factor)
    assert (kprobe.probe_floor.launches, kprobe.probe_front.launches) == before
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert f[0].shape == (T // plan.factor, 2 * C)


@pytest.mark.parametrize("variant,sub,kt,product_flops", [
    ("v4", 2048, 1, 723_517_440),
    ("v5", 2048, 2, 455_081_984),
    ("v5", 2048, 4, 320_864_256),
    ("v3", 4096, 1, 1_260_388_352)])
def test_probe_bound_counts_the_product(variant, sub, kt, product_flops):
    """Per 32768-row block at the bench's defaults (the AM plan: factor 32,
    711 taps, d_rows 712; 64 channels): the product's FLOPs, and a bound
    from the function's own work, K1's base form, which the bytes set."""
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=32768,
                                 channels=64, mode=DemodMode.AM,
                                 agc_stride=16), "cpu")
    plan = rx.front
    b = kprobe.probe_bound(variant, sub, kt, 64, 32768, plan.factor,
                           plan.d_rows, plan.h.numel())
    assert b["product_flops"] == product_flops
    assert b["flops"] == (2 * 711 * 1024 * 128 + 2 * 32768 * 128
                          + 6 * 32768 * 64)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bytes"] / 3.35e12 * 1e3
    f = kprobe.probe_bound("floor", sub, 1, 64, 32768, plan.factor)
    assert f["bytes"] == 17_301_504 and f["bound_by"] == "bytes"


@pytest.mark.parametrize("rows,sub,factor_", [
    (8192, 3072, 32),     # sub does not divide T
    (8192, 512, 1024),    # F does not divide sub
    (8192, 256, 32)])     # sub is not a multiple of 512
def test_wrappers_reject_geometry(rows, sub, factor_):
    with pytest.raises(ValueError):
        kprobe.probe_floor((torch.zeros(rows, 8),), sub, factor_)
    plan = front.FrontPlan.make(np.ones(9) / 9, factor_, "cpu")
    with pytest.raises(ValueError):
        kprobe.probe_front("v3", plan, torch.zeros(rows, 8),
                           torch.zeros(1, 8), torch.zeros(4), np.zeros(4),
                           np.zeros(4), torch.zeros(plan.d_rows, 8), sub)


def test_front_rejects_wrong_kt_and_layout(plan):
    x, hi = torch.zeros(T, 2 * C), np.zeros(C)
    st = (torch.zeros(1, 2 * C), torch.zeros(C),
          torch.zeros(plan.d_rows, 2 * C))
    for variant, kt in (("v4", 2), ("v5", 1), ("v9", 1)):
        with pytest.raises(ValueError):
            kprobe.probe_front(variant, plan, x, st[0], st[1], hi, hi, st[2],
                               2048, kt)
    with pytest.raises(ValueError):        # v1 takes [2, T, C] planes
        kprobe.probe_front("v1", plan, x, st[0], st[1], hi, hi, st[2], 2048)


@pytest.mark.parametrize("variant,lines", [
    ("floor", 3), ("v0", 1), ("v1", 2), ("v2", 2), ("floor128", 3),
    ("floorxla", 2), ("v3", 2), ("v4", 6)])
def test_bench_prints_one_line_per_variant_and_sub(monkeypatch, capsys,
                                                   variant, lines):
    for key, v in (("TB_CHANNELS", "4"), ("TB_FRAMES", "8192"),
                   ("TB_BLOCKS", "1"), ("TB_STEPS", "1")):
        monkeypatch.setenv(key, v)
    res = kbench2.main([variant], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("kbench2 on CPU")
    assert len(out) == 1 + lines and len(res) == lines
    assert all("ms/block" in ln and "bound" in ln for ln in out[1:])
    for r in res:       # the plain path launches nothing
        assert not any(r["launches"].values())
        assert r["ms_block"] > 0 and r["bound_ms_block"] > 0


def test_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        kbench2.main(["floor"])
    with pytest.raises(ValueError):
        kbench2.main(["v7"], device="cpu")


# ---- probe_toeplitz's 3xTF32 arithmetic, emulated on the CPU ----

def mm_tf32(e, w, passes=3, chunk=kprobe.CHUNK_ROWS):
    """The product e [..., K] @ w [K, M] as probe_toeplitz runs it on the
    tensor cores: both operands split into TF32 hi + lo (cvt.rna), per k8
    step the passes Wh Eh (then Wh El, Wl Eh when passes == 3), each exact
    8-term sum added to the chunk's float32 accumulator, and each chunk of
    32 rows added to the running float32 sum.  passes == 1 is one plain
    TF32 pass."""
    e, w = e.numpy(), w.numpy()
    eh, el = kprobe.split_tf32(e)
    wh, wl = kprobe.split_tf32(w)
    terms = ((wh, eh), (wh, el), (wl, eh))[:passes]
    k = e.shape[-1]
    total = np.zeros(e.shape[:-1] + (w.shape[1],), np.float32)
    for c0 in range(0, k, chunk):
        part = np.zeros_like(total)
        for k8 in range(c0, min(c0 + chunk, k), 8):
            s = slice(k8, k8 + 8)
            for wa, ea in terms:
                part = (part.astype(np.float64)
                        + ea[..., s].astype(np.float64)
                        @ wa[s].astype(np.float64)).astype(np.float32)
        total = (total + part).astype(np.float32)
    return torch.from_numpy(total)


def test_tf32_split_of_w():
    """The host split of W: hi has 10 explicit mantissa bits (the low 13
    bits of its float32 mantissa are zero), lo too, and hi + lo is W to
    float32 rounding (within 2^-22 of each value); the split is cvt.rna's:
    ties round away from zero."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 1, 4096)
         ).astype(np.float32)
    hi, lo = kprobe.split_tf32(w)
    for v in (hi, lo):
        assert not (v.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs((hi.astype(np.float64) + lo) - w.astype(np.float64))
    assert (err <= np.abs(w.astype(np.float64)) * 2.0 ** -22).all()
    assert (np.abs(hi - w) <= np.abs(w) * 2.0 ** -11).all()
    ties = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                     1.0 + 3 * 2.0 ** -11], np.float32)
    assert kprobe.tf32_round(ties).tolist() == [
        1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9]


def test_tf32_split_in_the_kernel_layout(plan):
    """composed_wt_split: W^T's hi and lo halves in probe_toeplitz's tile
    layout [m/64][kpad/4][64][4], zero past K, back to W^T exactly."""
    for sub in (2048, 4096):
        wt = kprobe.composed_wt(plan, sub).numpy()
        wh, wl, kpad = kprobe.composed_wt_split(plan, sub)
        m, k = wt.shape
        assert kpad % 32 == 0 and kpad >= k + 32
        assert wh.shape == (m // 64, kpad // 4, 64, 4)
        back = [v.numpy().transpose(0, 2, 1, 3).reshape(m, kpad)
                for v in (wh, wl)]
        hi, lo = kprobe.split_tf32(wt)
        assert np.array_equal(back[0][:, :k], hi)
        assert np.array_equal(back[1][:, :k], lo)
        assert not back[0][:, k:].any() and not back[1][:, k:].any()


@pytest.mark.parametrize("sub", [2048, 4096])
@pytest.mark.parametrize("variant,kt", kprobe.FORMS)
def test_front_variant_3xtf32_matches_plain_and_pallas(plan, variant, kt, sub):
    """The 3xTF32 product (mm_tf32) in place of the plain float32 one, over
    two streaming calls from a random state: y within 3e-5 relative of the
    plain probe and of the TPU kernel (pk.fused_front_packed at the same
    sub_block, interpret mode), and one TF32 pass on the same input beyond
    the bound, so that the check tells them apart."""
    rng = np.random.default_rng(14)
    h = plan.h.numpy().astype(np.float64)
    wt = jnp.asarray(np.ascontiguousarray(pk.build_composed_w(
        h, plan.factor, sub, plan.d_rows - (len(h) - 1)).T))
    hi, lo = _tunes(C)
    (jdc, jtl, jph), st = _state(variant, plan, rng)
    jdc, jtl, jph = map(jnp.asarray, (jdc, jtl, jph))
    for call in range(2):
        x = _plane(rng)
        jy = pk.fused_front_packed(
            jnp.asarray(x), jdc, jph, jnp.asarray(hi, jnp.float32),
            jnp.asarray(lo, jnp.float32), jtl, wt, plan.factor, plan.d_rows,
            0.9999, sub_block=sub, interpret=True)
        jdc, jtl, jph = jy[1:4]
        xv = _variant_input(variant, x)
        plain = kprobe.probe_front_reference(variant, plan, xv, st[0], st[2],
                                             hi, lo, st[1], sub, kt)
        out = kprobe.probe_front_reference(variant, plan, xv, st[0], st[2],
                                           hi, lo, st[1], sub, kt,
                                           product=mm_tf32)
        y = _packed(variant, *out)[0]
        assert rel_err(_packed(variant, *plain)[0], y) < RTOL
        assert rel_err(jy[0], y) < RTOL
        if call == 0:
            one = kprobe.probe_front_reference(
                variant, plan, xv, st[0], st[2], hi, lo, st[1], sub, kt,
                product=functools.partial(mm_tf32, passes=1))
            assert rel_err(_packed(variant, *plain)[0],
                           _packed(variant, *one)[0]) > RTOL
        st = (out[1], out[2], out[3])
