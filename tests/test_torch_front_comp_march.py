"""front_comp's work plan in the PyTorch port (ops/front.py
comp_march_plan, the mirror of comp_plan in csrc/front.cu; the card test
test_shared_memory_layouts_match_the_sources holds the two equal).

The hq form's one pass over the y scratch: items of 32 channels x a
segment of half-rate outputs; each forms d of a 32-row prologue, then of
its own rows in steps of 128, writes the y-tails and disc_last of its own
rows, and the item whose segment ends the dispatch writes comp_hist'.
Checked at the hq cells' shapes and the card tests' C = 5, 64, 256.
"""

import numpy as np
import pytest

from pebblesdr_tpu_torch.demod import wfm
from pebblesdr_tpu_torch.ops import front

FS = 2_048_000
# (M decimated rows of y at F = 4, C, blocks per dispatch)
SHAPES = {
    "wfm_hq_64ch": (262144, 64, 32),      # 32 blocks of 32768 frames
    "hq_slice_c4": (6144, 4, 3),          # chip_smoke's hq slice, 3 blocks
    "card_c5": (4096, 5, 2),              # the card test's C = 5, K = 2
    "card_c64": (8192, 64, 4),
    "card_c256": (4096, 256, 2),
    "card_c64_k1": (2048, 64, 1),
}
TC = len(wfm.WFMConfig.make(FS / 4 / 2, comp_decim=2).comp_taps)


@pytest.mark.parametrize("n_sm", [132, 3])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_comp_plan_covers_every_output_once(shape, n_sm):
    """Every half-rate output is made by exactly one step of one item per
    channel group; at least two items per SM where the shape has them."""
    m, c, _ = SHAPES[shape]
    plan = front.comp_march_plan(m, c, n_sm)
    mh, step = m // 2, plan["step_outputs"]
    assert plan["step_rows"] == 2 * step
    count = np.zeros(mh, np.int64)
    for (j_s, j_e), steps in zip(plan["segments"], plan["steps"]):
        assert 0 < j_e - j_s <= plan["seg_outputs"]
        assert steps == -(-(j_e - j_s) // step)
        for s in range(steps):
            j = np.arange(j_s + step * s, j_s + step * (s + 1))
            count[j[j < j_e]] += 1
    assert (count == 1).all()
    assert plan["groups"] == -(-c // 32)
    assert plan["items"] == plan["groups"] * len(plan["segments"])
    assert plan["grid"] == min(plan["items"], n_sm)
    if plan["items"] >= 2 * n_sm:
        assert len(plan["segments"]) >= -(-2 * n_sm // plan["groups"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_comp_prologue_stays_within_comp_hist(shape):
    """An item forms d of the 32 rows before its segment: enough for the
    tc - 1 rows its first outputs read.  The first segment's prologue rows
    are all before t = 0: the ones the FIR reads lie within the carried
    comp_hist (hr rows), the rest have no weight.  At wfm_hq_64ch the
    prologues are at most 6 % of the rows formed."""
    m, c, _ = SHAPES[shape]
    plan = front.comp_march_plan(m, c)
    hr = front.comp_hist_rows(TC)
    pro = plan["prologue_rows"]
    assert TC - 1 <= hr <= pro == plan["layout"]["hist"]
    j_s, _ = plan["segments"][0]
    assert j_s == 0
    first = np.arange(2 * j_s - pro, 2 * j_s)
    assert (first < 0).all()
    read = np.arange(-(TC - 1), 0)              # d rows output 0 reads
    assert np.isin(read, first).all() and (read >= -hr).all()
    if shape == "wfm_hq_64ch":
        assert plan["items"] * pro <= 0.06 * m * plan["groups"]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_one_item_per_group_writes_comp_hist_and_the_windows_once(shape):
    """Exactly one item per channel group (the one whose segment ends at
    M/2) writes comp_hist' and disc_last; its rows hold the last hr rows of
    d within its prologue and steps; the items' own rows cover every row
    of y once, so each y-tail window row is written once."""
    m, c, k = SHAPES[shape]
    plan = front.comp_march_plan(m, c)
    writers = [i for i, w in enumerate(plan["writes_hist"]) if w]
    assert writers == [len(plan["segments"]) - 1]
    hr = front.comp_hist_rows(TC)
    lo, hi = plan["own_rows"][writers[0]]
    assert hi == m and lo - plan["prologue_rows"] <= m - hr
    rows = np.zeros(m, np.int64)
    for lo, hi in plan["own_rows"]:
        rows[lo:hi] += 1
    assert (rows == 1).all()
    mb, zt = m // k, min(m // k, 512)
    window = (np.arange(m) % mb) >= mb - zt
    assert int(rows[window].sum()) == k * zt


def test_comp_layout_fits_a_block():
    """Two stages of one 128-row step (re and im lanes of 32 channels), a
    ring of d rows that keeps the 32-row history and two steps, the taps
    and two rows of y, 128-byte aligned for the tensor-map boxes."""
    lay = front.comp_march_layout()
    assert lay["stages"] >= 2
    assert lay["stage_bytes"] == lay["stage_rows"] * 2 * 32 * 4 == 32768
    assert lay["stage_bytes"] % 128 == 0 and lay["stage"] % 128 == 0
    assert lay["ring_rows"] == lay["hist"] + 2 * lay["step_rows"]
    assert lay["step_rows"] % lay["box_rows"] == 0
    assert lay["hist"] % lay["box_rows"] == 0
    assert lay["ring"] >= 128 + lay["stages"] * lay["stage_bytes"]
    assert lay["taps"] >= lay["ring"] + lay["ring_rows"] * 32 * 4
    assert lay["smem"] <= 232448
