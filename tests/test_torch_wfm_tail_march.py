"""The stereo tail's time march (csrc/wfm_tail.cu) as its Python mirrors
describe it: ops/wfm_tail.py tail_march_layout / tail_march_plan.

CPU only (the kernel runs on the card, where tests/test_torch_gpu.py holds
the mirrors to the C exports and the kernel to its plain version): every
output of every channel group is made by exactly one step of one item; an
item's prologue and steps stage every row its outputs read, and the last
segment's ring holds the rows hist' takes; a model that reads only the rows
each item stages, NaN elsewhere, gives the plain version's audio and hist'
within 3e-5; and the shared-memory layout fits at each low-pass the port
accepts.
"""

import numpy as np
import pytest
import torch

from pebblesdr_tpu_torch.demod import wfm
from pebblesdr_tpu_torch.ops import wfm_tail
from pebblesdr_tpu_torch.utils import roofline

RTOL = 3e-5   # K2 vs plain (the kernel sums in another order)
LP = wfm.WFMConfig.make(256_000.0).audio_taps          # 235 taps


def _taps(n):
    return LP if n == len(LP) else (
        np.random.default_rng(n).standard_normal(n) / n).astype(np.float32)


# (T, C, taps, F, ell): the cells' shapes (wfm_64ch and the hq cells after
# K1e; wfm_16ch), then odd channel counts, short planes, other responses
SHAPES = {
    "wfm_64ch": (131072, 64, 235, 4, 256),
    "wfm_16ch": (262144, 16, 235, 4, 256),
    "c3_t2048": (2048, 3, 235, 4, 256),
    "c5_t8192": (8192, 5, 235, 4, 256),
    "c13_t24576": (24576, 13, 235, 4, 128),
    "c16_t8192_f2": (8192, 16, 235, 2, 256),
    "c64_t2048": (2048, 64, 235, 4, 256),
    "c16_t8192_31taps": (8192, 16, 31, 4, 128),
    "c5_t8192_501taps": (8192, 5, 501, 4, 256),
    "c64_t32768_f2_ell128": (32768, 64, 235, 2, 128),
    "c13_t262144_501taps": (262144, 13, 501, 4, 256),
}


def _items(mp):
    """(group, o_s, o_e, steps) of every work item, in item order."""
    return [(g, o_s, o_e, steps)
            for (o_s, o_e), steps in zip(mp["segments"], mp["steps"])
            for g in range(mp["groups"])]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tail_march_plan_covers_every_output_once(shape):
    """Each decimated output of each channel group is made by exactly one
    step of one item; at least two items per H100 SM where the plane has
    that many steps; the segments hold whole steps but their last."""
    t, c, ntaps, f, _ = SHAPES[shape]
    mp = wfm_tail.tail_march_plan(t, c, f, ntaps)
    m, km = t // f, mp["step_outputs"]
    assert mp["step_rows"] == km * f and km == 128
    assert mp["groups"] == -(-c // 16)          # 16 channels per item
    count = np.zeros((mp["groups"], m), np.int64)
    for g, o_s, o_e, steps in _items(mp):
        assert steps == -(-(o_e - o_s) // km)
        assert o_e - o_s <= mp["seg_outputs"]
        for j in range(steps):
            o = np.arange(o_s + km * j, min(o_s + km * (j + 1), o_e))
            count[g, o] += 1
    assert (count == 1).all()
    assert mp["items"] == mp["groups"] * len(mp["segments"])
    assert mp["items"] >= min(264, mp["groups"] * -(-m // km))
    assert mp["grid"] == min(mp["items"], 132)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tail_march_stages_the_rows_the_plain_version_reads(shape):
    """Output o reads rows F o - j, j < F S dps (the padded low-pass): they
    lie in its item's prologue [F o_s - hist, F o_s) and steps; the ring
    keeps the FIR's history and hist''s rows, T - d_rows .. T - 1 (the
    plain version's ext[-d_rows:]), lie inside the last segment's last
    step's span, and the rewind's copy never overlaps its source."""
    t, c, ntaps, f, _ = SHAPES[shape]
    mp = wfm_tail.tail_march_plan(t, c, f, ntaps)
    lay = mp["layout"]
    d_rows = -(-(ntaps - 1) // 8) * 8
    span = f * lay["slices"] * lay["dps"]
    assert span >= ntaps and lay["dps"] * lay["slices"] - -(-ntaps // f) < 8
    assert lay["hist"] >= max(span - 1, d_rows) and lay["hist"] % 128 == 0
    assert mp["prologue_rows"] == lay["hist"] <= lay["stage_rows"]
    assert lay["step_rows"] <= lay["stage_rows"]
    x = lay["ring_rows"] - lay["hist"]
    assert x % lay["step_rows"] == 0 and x >= lay["hist"]
    for g, o_s, o_e, steps in _items(mp):
        lo = f * o_s - lay["hist"]                 # first staged row
        hi = f * o_s + steps * lay["step_rows"]    # past the last one
        assert f * o_s - (span - 1) >= lo and f * (o_e - 1) < hi
        for j in range(steps):                     # each step's window
            o0 = o_s + 128 * j
            assert f * o0 - (span - 1) >= f * o0 - lay["hist"]
            assert f * (o0 + 127) < f * o0 + lay["step_rows"]
        if o_e == t // f:                          # hist' from the ring
            o0 = o_s + 128 * (steps - 1)
            assert f * o0 - lay["hist"] <= t - d_rows
            assert t <= f * o0 + lay["step_rows"]


def _march_model(plan, mp, raw, p0, wf, hist):
    """The march as the kernel indexes it, in float64: each item sees only
    the rows its units stage ([raw | lmr], the carried history before
    t = 0, zeros before that, NaN past T), its outputs summed over the
    padded polyphase response, hist' from the last segment's rows."""
    t, c = raw.shape
    f, lay, d_rows = plan.factor, mp["layout"], plan.d_rows
    lmr = wfm_tail.demux(plan, *(torch.from_numpy(v) for v in (raw, p0, wf)))
    a = np.concatenate([raw, lmr.numpy()], 1).astype(np.float64)
    span = f * lay["slices"] * lay["dps"]
    h = np.zeros(span)
    h[:plan.h.numel()] = plan.h.numpy()
    y = np.full((t // f, 2 * c), np.nan)
    hist_out = np.full((d_rows, 2 * c), np.nan)
    for g, o_s, o_e, steps in _items(mp):
        cols = np.r_[np.arange(16 * g, min(16 * g + 16, c)),
                     c + np.arange(16 * g, min(16 * g + 16, c))]
        lo = f * o_s - lay["hist"]
        rows = np.arange(lo, f * o_s + steps * lay["step_rows"])
        ring = np.full((len(rows), len(cols)), np.nan)
        ins = (rows >= 0) & (rows < t)
        ring[ins] = a[rows[ins]][:, cols]
        old = (rows < 0) & (rows >= -d_rows)
        ring[old] = hist[d_rows + rows[old]][:, cols]
        ring[rows < -d_rows] = 0.0
        o = np.arange(o_s, o_e)
        idx = f * o[:, None] - np.arange(span)[None, :] - lo
        assert idx.min() >= 0
        y[o[:, None], cols[None, :]] = np.einsum("ojl,j->ol", ring[idx], h)
        if o_e == t // f:
            r = np.arange(t - d_rows, t) - lo
            hist_out[:, cols] = ring[r]
    return y, hist_out


@pytest.mark.parametrize("shape", ["c3_t2048", "c5_t8192", "c13_t24576",
                                   "c16_t8192_f2", "c64_t2048",
                                   "c16_t8192_31taps", "c5_t8192_501taps"])
def test_tail_march_model_matches_plain(shape):
    """Reading only what each item stages gives the plain version's audio
    and hist' within 3e-5 relative (NaN would mark a row read that no unit
    staged), over two streaming calls from a random history."""
    t, c, ntaps, f, ell = SHAPES[shape]
    plan = wfm_tail.TailPlan.make(_taps(ntaps), f, ell, 2048, "cpu")
    mp = wfm_tail.tail_march_plan(t, c, f, ntaps)
    rng = np.random.default_rng(11)
    hist_m = hist_r = rng.standard_normal((plan.d_rows, 2 * c)).astype(
        np.float32) * 0.3
    for _ in range(2):
        raw = rng.standard_normal((t, c)).astype(np.float32)
        p0 = rng.uniform(0.0, 10.0, (t // ell, c)).astype(np.float32)
        wf = np.full((t // ell, c), 2 * np.pi * 19000 / 256000, np.float32)
        y, hist_m = _march_model(plan, mp, raw, p0, wf, hist_m)
        ref = wfm_tail.wfm_tail_reference(
            plan, *(torch.from_numpy(v) for v in (raw, p0, wf, hist_r)))
        for got, want in zip((y, hist_m), ref):
            want = want.numpy().astype(np.float64)
            assert np.isfinite(got).all()
            assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
        hist_m, hist_r = hist_m.astype(np.float32), ref[1].numpy()


@pytest.mark.parametrize("ntaps,factor,ell,slices", [
    (235, 4, 256, (1, 60)), (31, 4, 128, (1, 8)), (235, 2, 256, (2, 60)),
    (501, 4, 256, (2, 64))])
def test_tail_march_layout_fits_each_accepted_response(ntaps, factor, ell,
                                                       slices):
    """The port's responses (the receiver's 235 taps at F = 4, and those
    the card test runs) fit one block of 227 KB, each branch padded by at
    most 2 taps; the layout's regions follow one another."""
    lay = wfm_tail.tail_march_layout(ntaps, factor)
    assert lay is not None and (lay["slices"], lay["dps"]) == slices
    assert wfm_tail.tail_slices(ntaps, factor) == slices
    assert lay["slices"] * lay["dps"] - -(-ntaps // factor) <= 2
    assert lay["smem"] <= 232448
    assert lay["ring"] == 128 + lay["stages"] * lay["stage_bytes"]
    assert lay["taps"] == lay["ring"] + lay["ring_rows"] * 32 * 4
    assert lay["smem"] >= lay["taps"] + factor * lay["slices"] * lay["dps"] * 4
    assert 2 <= lay["stages"] <= 4 and lay["stage_bytes"] % 128 == 0


def test_tail_march_refuses_what_does_not_fit():
    """512 taps at F = 4 (2 slices of 64 per branch) is the most one block
    holds; 513 is refused."""
    assert wfm_tail.tail_march_layout(512, 4)["smem"] <= 232448
    assert wfm_tail.tail_march_layout(513, 4) is None
    assert wfm_tail.tail_march_plan(8192, 4, 4, 513) is None
    assert wfm_tail.tail_slices(235, 0) == (0, 0)


@pytest.mark.parametrize("c,tma", [(3, False), (4, True), (5, False),
                                   (13, False), (16, True), (64, True)])
def test_tail_staging_path_follows_the_row_pitch(c, tma):
    """Tensor-map boxes need rows of whole 16 bytes (C % 4 == 0); other
    composites stage element by element."""
    assert wfm_tail.tail_tma(c) is tma


@pytest.mark.parametrize("t,c,ms", [(131072, 64, 0.0324), (262144, 16, 0.0162)])
def test_k2_bound_at_the_cells(t, c, ms):
    """K2 is bound by operations at both cells: 2 x 235 per output lane and
    the demux."""
    plan = wfm_tail.TailPlan.make(LP, 4, 256, 2048, "cpu")
    b = roofline.k2_bound(plan, t, c)
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] - ms) < 0.01 * ms
