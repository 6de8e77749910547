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
from pebblesdr_tpu_torch.chain.receiver import (PORTED_MODES, Receiver,
                                                ReceiverConfig)
from pebblesdr_tpu_torch.demod.modes import DemodMode
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
    """front_fir's layout: at least two raw stages of one step (km outputs,
    km F rows x 16 lanes; km = 12 parts, 32 / min(F, 16) parts), a ring of
    mixed rows that holds the history F (DP - 1) and whole steps after it
    (enough that copying the history down never overlaps its source), the
    re and im planes 16 floats apart in the banks, and the groups' partial
    sums [parts][min(F, 16)][12][16] inside the stage the step mixed or in
    a region of their own, all in the block's 232448 bytes."""
    lay = front.fir_march_layout(ntaps, factor)
    km = {32: 24, 8: 48, 4: 96, 2: 192}[factor]
    assert lay["km"] == 12 * front.fir_parts(factor)[1] == km
    assert lay["step_rows"] == km * factor
    assert lay["stages"] >= 2
    assert lay["stage_bytes"] == lay["step_rows"] * 16 * 4
    assert lay["ring_re"] >= 128 + lay["stages"] * lay["stage_bytes"]
    assert lay["hist"] == factor * (lay["dp"] - 1)
    assert lay["dp"] * factor >= ntaps
    steps = lay["ring_rows"] - lay["hist"]
    assert steps >= lay["step_rows"] and steps % lay["step_rows"] == 0
    assert steps >= lay["hist"]
    assert lay["ring_im"] - lay["ring_re"] >= lay["ring_rows"] * 8 * 4
    assert (lay["ring_im"] - lay["ring_re"]) % 128 == 64
    assert lay["red_bytes"] == km * min(factor, 16) * 16 * 4
    if lay["red"] < 0:
        assert lay["stage_bytes"] >= lay["red_bytes"]
    else:
        assert lay["red"] + lay["red_bytes"] <= lay["smem"]
    assert lay["smem"] <= 232448
    h = np.full(ntaps, 1.0 / ntaps)
    plan = front.FrontPlan.make(h, factor, "cpu")
    assert plan.smem_bytes == lay["smem"]


def test_fir_branch_taps_cover_the_wfm_plan():
    p = tdec.build_plan(FS, 200_000)
    h = tdec.compose_response(p)
    assert (p.factor, len(h)) == (8, 283)
    lay = front.fir_march_layout(len(h), p.factor)
    # 36 taps per branch (zero-padded to 40), 8 branch groups x 4 parts
    assert (lay["dp"], lay["busy"], lay["parts"], lay["km"]) == (40, 8, 4, 48)
    # no branch holds 100 taps: the card path refuses it
    assert front.fir_march_layout(200, 2) is None
    assert front.FrontPlan.make(np.ones(200) / 200, 2, "cpu").smem_bytes == 0


# (T, C, F, taps, blank width, bytes per lane) of the cells in PERF.md
# section 4 (wfm_rds_64ch has wfm_64ch's front)
CELL_SHAPES = {
    "am_64ch": (1 << 20, 64, 32, 711, 0, 4),
    "am_nb_64ch": (1 << 20, 64, 32, 711, 7, 4),
    "am_256ch": (1 << 19, 256, 32, 711, 0, 4),
    "am_i16_256ch": (1 << 19, 256, 32, 711, 0, 2),
    "am_16ch": (1 << 21, 16, 32, 711, 0, 4),
    "wfm_64ch": (1 << 20, 64, 8, 283, 0, 4),
    "wfm_hq_64ch": (1 << 20, 64, 4, 135, 0, 4),
    "wfm_16ch": (1 << 21, 16, 8, 283, 0, 4),
}


@pytest.mark.parametrize("cell", list(CELL_SHAPES))
def test_fir_march_plan_covers_every_output_once(cell):
    """Every decimated output of the cell is made by exactly one step of one
    item per channel group, with at least two items per H100 SM, and each
    item mixes F (DP - 1) history rows (+ bw - 1 flag rows) first."""
    t, c, f, ntaps, bw, elem = CELL_SHAPES[cell]
    plan = front.fir_march_plan(t, c, f, ntaps, nb_bw=bw, elem=elem)
    m, km = t // f, plan["step_outputs"]
    assert plan["step_rows"] == km * f >= 384
    count = np.zeros(m, np.int64)
    for (o_s, o_e), steps in zip(plan["segments"], plan["steps"]):
        for j in range(steps):
            o = np.arange(o_s + km * j, o_s + km * (j + 1))
            count[o[o < o_e]] += 1
        assert o_e - o_s <= plan["seg_outputs"]
        assert steps == -(-(o_e - o_s) // km)
    assert (count == 1).all()
    assert plan["items"] == plan["groups"] * len(plan["segments"]) >= 264
    assert plan["groups"] == -(-c // 8)
    lay = plan["layout"]
    assert lay["hist"] == f * (lay["dp"] - 1)
    assert plan["prologue_rows"] == lay["hist"] + max(bw - 1, 0)
    assert plan["smem"] <= 232448


@pytest.mark.parametrize("factor", [32, 8, 4, 2])
def test_fir_branch_part_map_leaves_no_group_idle(factor):
    """front_fir's 32 thread groups split the F branches x the step's
    parts: every group has work, every (branch, part) is run once, and at
    F <= 16 each group runs exactly one item (at F = 32, two branches)."""
    groups = front.fir_group_items(factor)
    busy, parts = front.fir_parts(factor)
    assert (busy, parts) == (min(factor, 16), 32 // min(factor, 16))
    assert len(groups) == 32 and all(groups)
    items = sorted(it for g in groups for it in g)
    assert items == sorted((p, q) for p in range(factor) for q in range(parts))
    assert all(len(g) == (2 if factor == 32 else 1) for g in groups)


@pytest.mark.parametrize("nb", [False, True])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("mode,hq", [(m, False) for m in PORTED_MODES]
                         + [(DemodMode.FMS, True)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_every_ported_mode_has_a_front_fir_layout(mode, hq, elem, nb):
    """Each mode the port's Receiver accepts (and WFM's hq geometry) at
    2.048 Msps: its composed front response has a front_fir layout that
    fits a block, in float32 and int16, with and without the blanker; the
    card would refuse a response without one."""
    rx = Receiver(ReceiverConfig(sample_rate=FS, mode=mode, wfm_hq=hq),
                  "cpu")
    lay = front.fir_march_layout(rx.front.h.numel(), rx.plan.factor, nb=nb,
                                 elem=elem)
    assert lay is not None and lay["smem"] <= 232448
    assert lay["dp"] * rx.plan.factor >= rx.front.h.numel()
    assert rx.front.smem_bytes > 0


@pytest.mark.parametrize("nb", [False, True])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("protect,factor,ntaps,dp", [(20_000, 64, 2007, 32),
                                                      (48_000, 32, 1159, 40)])
def test_long_responses_take_four_channel_items(protect, factor, ntaps, dp,
                                                elem, nb):
    """The factor-64 / 2007-tap (SSB, CW, DIG) and factor-32 / 1159-tap
    (NONE) responses: 8-channel items do not fit (the ring of mixed rows
    would hold F (DP - 1) history rows of 8 channels), so front_fir takes
    items of 4 channels: 64 groups of 8 lanes, every group one branch at
    F = 64 (two parts of 32 at F = 32), a step of 768 rows, the partial sums
    inside the mixed stage, and int16 stages of the 16-byte box (8 lanes)."""
    p = tdec.build_plan(FS, protect)
    assert (p.factor, len(tdec.compose_response(p))) == (factor, ntaps)
    assert front.fir_march_layout(ntaps, factor, nb, elem, cg=8) is None
    lay = front.fir_march_layout(ntaps, factor, nb, elem)
    assert lay == front.fir_march_layout(ntaps, factor, nb, elem, cg=4)
    assert (lay["cg"], lay["dp"], lay["step_rows"]) == (4, dp, 768)
    assert (lay["busy"], lay["parts"]) == (min(factor, 64), 64 // factor)
    assert lay["bw"] == (4 if elem == 4 else 8)
    assert lay["stage_bytes"] == 768 * 2 * lay["bw"] * elem == 24576
    assert lay["red"] == -1 and lay["red_bytes"] <= lay["stage_bytes"]
    assert lay["ring_rows"] - lay["hist"] >= lay["hist"]
    assert lay["ring_im"] - lay["ring_re"] >= lay["ring_rows"] * 4 * 4
    assert (lay["box_rows"] * lay["bw"] * elem) % 128 == 0
    assert lay["smem"] <= 232448


@pytest.mark.parametrize("factor", [64, 32])
def test_four_channel_map_leaves_no_group_idle(factor):
    """At 4 channels a block is 64 groups of 8 lanes: at F = 64 each group
    runs one branch of the step's one part, at F = 32 one branch of one of
    its two parts; every (branch, part) runs once."""
    groups = front.fir_group_items(factor, cg=4)
    busy, parts = front.fir_parts(factor, cg=4)
    assert len(groups) == 64 and all(len(g) == 1 for g in groups)
    items = sorted(it for g in groups for it in g)
    assert items == sorted((p, q) for p in range(factor)
                           for q in range(parts))


@pytest.mark.parametrize("cell", ["usb_64ch", "usb_nb_i16_64ch", "none_64ch"])
def test_four_channel_plan_covers_every_output_once(cell):
    """The plan of 4-channel items at the new cells' shapes: every output
    made once per channel group, 16 groups of 4 channels at 64 channels,
    at least two items per H100 SM."""
    t, c, f, ntaps, bw, elem = {
        "usb_64ch": (1 << 20, 64, 64, 2007, 0, 4),
        "usb_nb_i16_64ch": (1 << 20, 64, 64, 2007, 7, 2),
        "none_64ch": (1 << 20, 64, 32, 1159, 0, 4)}[cell]
    plan = front.fir_march_plan(t, c, f, ntaps, nb_bw=bw, elem=elem)
    m, km = t // f, plan["step_outputs"]
    count = np.zeros(m, np.int64)
    for (o_s, o_e), steps in zip(plan["segments"], plan["steps"]):
        for j in range(steps):
            o = np.arange(o_s + km * j, o_s + km * (j + 1))
            count[o[o < o_e]] += 1
    assert (count == 1).all()
    assert plan["groups"] == 16 and plan["layout"]["cg"] == 4
    assert plan["items"] >= 264
    assert plan["prologue_rows"] == plan["layout"]["hist"] + max(bw - 1, 0)
