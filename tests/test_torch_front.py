"""The fused front end (K1) of the PyTorch port.

On the CPU: the plain version (fused_front_reference, which the wrapper runs
for CPU tensors) against the TPU kernel pk.fused_front_packed in interpret
mode and against the staged JAX pipeline (dc_removal_chunked -> mix ->
decimator.apply), streaming over 3 calls, within the 3e-5 relative bound of
tests/test_pallas.py.  The CUDA kernel itself is held to the plain version
on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu_torch.kernels import build
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import front

FS = 2_048_000
RTOL = 3e-5


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _blocks(c, n, blocks, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n)) + 0.2
             ).astype(np.complex64) for _ in range(blocks)]


def _tunes(c):
    splits = [jmix.split_freq(250_000.0 + 1234.5 * i, FS) for i in range(c)]
    return (np.array([s[0] for s in splits]), np.array([s[1] for s in splits]))


def _plan(device="cpu"):
    p = tdec.build_plan(FS, 30_000)
    return front.FrontPlan.make(tdec.compose_response(p), p.factor, device)


def _pack(b):
    return np.ascontiguousarray(np.concatenate([b.real.T, b.imag.T], axis=-1))


def test_reference_matches_pallas_kernel_streaming():
    c, n = 8, 8192
    jp = jdec.build_plan(FS, 30_000)
    h = jdec.compose_response(jp)
    plan = _plan()
    d_rows = plan.d_rows
    wt = jnp.asarray(np.ascontiguousarray(
        pk.build_composed_w(h, jp.factor, 2048, d_rows - (len(h) - 1)).T))
    hi, lo = _tunes(c)
    jdc, jph, jtl = (jnp.zeros((1, 2 * c)), jnp.zeros((c,)),
                     jnp.zeros((d_rows, 2 * c)))
    tdc, tph, ttl = torch.zeros(1, 2 * c), torch.zeros(c), torch.zeros(d_rows, 2 * c)
    for b in _blocks(c, n, 3, 1):
        x = _pack(b)
        jy, jdc, jtl, jph, jraw = pk.fused_front_packed(
            jnp.asarray(x), jdc, jph, jnp.asarray(hi), jnp.asarray(lo), jtl,
            wt, jp.factor, d_rows, 0.9999, sub_block=2048, raw_rows=2048,
            interpret=True)
        ty, tdc, ttl, tph, traw = front.fused_front_reference(
            plan, torch.from_numpy(x), tdc, tph, torch.from_numpy(hi),
            torch.from_numpy(lo), ttl, n_block=n, raw_rows=2048)
        assert rel_err(jy, ty) < RTOL
        assert rel_err(jdc, tdc) < RTOL
        assert rel_err(jtl, ttl) < RTOL
        assert np.abs(np.asarray(jph) - tph.numpy()).max() < 1e-6
        assert np.array_equal(np.asarray(jraw), traw.numpy())


def test_reference_matches_staged_jax_pipeline():
    c, n = 8, 8192
    jp = jdec.build_plan(FS, 30_000)
    plan = _plan()
    hi, lo = _tunes(c)
    dc, ms, ds = (jnp.zeros((c,), jnp.complex64), jmix.mixer_init(c),
                  jdec.state_init(jp, c))
    tdc, tph = torch.zeros(1, 2 * c), torch.zeros(c)
    ttl = torch.zeros(plan.d_rows, 2 * c)
    refs, outs = [], []
    for b in _blocks(c, n, 3, 2):
        dc, y = jiir.dc_removal_chunked(dc, jnp.asarray(b), alpha=0.9999)
        ms, y = jmix.mix(ms, y, jnp.asarray(hi), jnp.asarray(lo))
        ds, y = jdec.apply(jp, ds, y)
        refs.append(np.asarray(y))
        ty, tdc, ttl, tph, _ = front.fused_front(
            plan, torch.from_numpy(_pack(b)), tdc, tph, torch.from_numpy(hi),
            torch.from_numpy(lo), ttl, n_block=n)
        outs.append((ty[:, :c].T + 1j * ty[:, c:].T).numpy())
    ref, got = np.concatenate(refs, -1), np.concatenate(outs, -1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < RTOL
    assert np.abs(np.asarray(ms.phase) - tph.numpy()).max() < 1e-6


def test_cpu_wrapper_runs_plain_version_without_counting():
    c, n, k = 2, 2048, 3
    plan = _plan()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((k * n, 2 * c)).astype(np.float32))
    hi, lo = (torch.from_numpy(a[:c]) for a in _tunes(c))
    args = (x, torch.zeros(1, 2 * c), torch.zeros(c), hi, lo,
            torch.zeros(plan.d_rows, 2 * c))
    before = front.fused_front.launches
    a = front.fused_front(plan, *args, n_block=n, raw_rows=0)
    b = front.fused_front_reference(plan, *args, n_block=n, raw_rows=0)
    assert front.fused_front.launches == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert a[4].shape == (k, 8, 2 * c)  # raw_rows=0 exports 8 rows


def test_streaming_equals_one_shot():
    """Two dispatches of 2 blocks == one dispatch of 4 blocks."""
    c, n = 3, 4096
    plan = _plan()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4 * n, 2 * c)).astype(np.float32)
                         + 0.1)
    hi, lo = (torch.from_numpy(a[:c]) for a in _tunes(c))
    z = (torch.zeros(1, 2 * c), torch.zeros(c))
    zt = torch.zeros(plan.d_rows, 2 * c)
    y_all, dc_all, tl_all, ph_all, _ = front.fused_front(
        plan, x, *z, hi, lo, zt, n_block=n)
    y1, dc1, tl1, ph1, _ = front.fused_front(plan, x[:2 * n], *z, hi, lo, zt,
                                             n_block=n)
    y2, dc2, tl2, ph2, _ = front.fused_front(plan, x[2 * n:], dc1, ph1, hi, lo,
                                             tl1, n_block=n)
    assert rel_err(y_all, torch.cat([y1, y2])) < 1e-5
    assert rel_err(dc_all, dc2) < 1e-5 and rel_err(tl_all, tl2) < 1e-5
    assert np.abs((ph_all - ph2).numpy()).max() < 1e-6


@pytest.mark.parametrize("n_block,rows", [(3000, 3000), (4096, 6144)])
def test_geometry_rejected(n_block, rows):
    plan = _plan()
    c = 2
    with pytest.raises(ValueError):
        front.fused_front(plan, torch.zeros(rows, 2 * c), torch.zeros(1, 2 * c),
                          torch.zeros(c), torch.zeros(c), torch.zeros(c),
                          torch.zeros(plan.d_rows, 2 * c), n_block=n_block)


def test_phase_split_form_matches_mixer_ramp():
    """The kernel's split-form phase == the mixer's phase ramp (same float32
    arithmetic up to the reassociation of the sub-block offset)."""
    c, n = 4, 8192
    hi, lo = (torch.from_numpy(a[:c]) for a in _tunes(c))
    ph0 = torch.tensor([0.0, 0.25, 0.9, 0.5])
    from pebblesdr_tpu_torch.ops.mixer import phase_ramp
    coarse, fine = front.phase_tables(ph0, hi, lo, n)
    a = torch.remainder(coarse[:, :, None, :] + fine, 1.0).reshape(n, c).T
    b = phase_ramp(ph0, n, hi, lo)
    d = torch.remainder(a - b + 0.5, 1.0) - 0.5        # wrap-aware difference
    assert float(d.abs().max()) < 1e-6


def test_build_is_lazy_and_source_hashed():
    """Importing the port builds nothing; the library name follows the
    source's hash into build/kernels/."""
    so = build.library_path("front")
    assert so.parent == build.BUILD_DIR
    assert so.name.startswith("libfront_") and so.suffix == ".so"
    assert so == build.library_path("front")
    assert "front" not in build._loaded


@pytest.mark.parametrize("ntaps,factor", [(20, 4), (9, 8), (30, 2), (283, 8),
                                          (711, 32)])
def test_fir_smem_holds_staging_and_partial_sums(ntaps, factor):
    """front_fir's u area first stages span input rows, then holds the 16
    groups' partial sums [16][24][16 lanes]: the layout reserves the larger
    (small factors with few taps stage fewer rows than the sums need)."""
    lay = front.fir_smem_layout(ntaps, factor)
    span_floats = lay["span"] * 16
    sums_floats = 16 * 24 * 16
    assert lay["total"] - lay["u"] == max(span_floats, sums_floats)
    if factor <= 4:
        assert span_floats < sums_floats      # the geometry the repair covers
    h = np.full(ntaps, 1.0 / ntaps)
    plan = front.FrontPlan.make(h, factor, "cpu")
    assert plan.smem_bytes == 4 * lay["total"] <= 232448


def test_fir_branch_taps_cover_the_wfm_plan():
    p = tdec.build_plan(FS, 200_000)
    h = tdec.compose_response(p)
    assert (p.factor, len(h)) == (8, 283)
    assert front.fir_smem_layout(len(h), p.factor)["dp"] == 40
    # no instantiation holds 100 taps per branch: the card path refuses it
    assert front.fir_smem_layout(200, 2) is None
    assert front.FrontPlan.make(np.ones(200) / 200, 2, "cpu").smem_bytes == 0
