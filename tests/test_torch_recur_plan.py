"""The host side of csrc/recur.cu's short-chain kernel (K4 agc_scan, K6
ook_scan) on the CPU, where the kernel cannot run:

  * ops/short_chain.py short_plan, the Python mirror of the C short_plan
    (tests/test_torch_gpu.py holds the two equal on the card): the form
    ("pass" where the row fits one stage, "ring" above), the stage's
    frames, the staged row's pitch, the output rows' pitch and the shared
    memory, within the H100's 227 KB for every input layout; the blocks
    for C = 1, 7, 64 and 256;
  * K6's input plan (ook_input): the three columns of goertzel_power's
    [C, F, 3] output read in place as 3-float frames, the compare bins
    read in compare mode only; a plane as it lies, a strided one made
    contiguous; separate compare planes packed into the 3-float frames;
    None as zero powers (the plain version against the JAX package's
    zeros);
  * the wrappers' host paths (ook_launch, agc_launch) with a stand-in for
    the C entry that writes the plain version's results where the kernel
    writes them: the views of the state' block and of K4's one output
    allocation, the consts cache (equal to cfg.consts() in every mode) and
    the arguments; the ValueErrors they raise, reached without a card;
  * utils/roofline.py ook_scan_bound's bytes (4 a frame, 12 in compare
    mode, 1 a mark) and the fed chain probes' input patterns;
  * the loop kernel's side (K3 pll_scan, K3c pll_chunk_scan): its plan
    mirror short_chain.loop_plan (the form, the stages, shared memory
    within 227 KB) and blocks for C = 1 to 256; the CUDA path
    pll.loop_launch through a stand-in C entry; the chain-only fed probes'
    patterns run through pll_scan_plain / pll_chunk_scan_plain, where the
    loop tracks each; pll_scan_bound's bytes and serial floor.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import goertzel as jg
from pebblesdr_tpu_torch.ops import agc, goertzel, pll, short_chain
from pebblesdr_tpu_torch.utils import convert, roofline

H100_SMEM = 232448          # bytes a block can use on the H100


# the callers' inputs: K4's envelope plane (4-byte levels); K6's main plane,
# goertzel_power's 3-float frames, or a column of 2-float frames (1-byte
# marks)
LAYOUTS = [(1, 4), (1, 1), (3, 1), (2, 1)]


@pytest.mark.parametrize("fs,esz", LAYOUTS)
@pytest.mark.parametrize("n", [0, 1, 34, 127, 128, 129, 2048, 32768])
def test_short_plan_form_and_layout(n, fs, esz):
    p = short_chain.short_plan(n, fs, esz)
    assert p.form == ("pass" if n <= short_chain.STAGE_FRAMES else "ring")
    assert p.frames == (n if p.form == "pass" else short_chain.STAGE_FRAMES)
    assert p.stages == (0 if n == 0 else 1 if p.form == "pass"
                        else short_chain.STAGES)
    # the row, its float offset in a 16-byte line (<= 3) and a register
    # group read past the segment fit the row's slot; rows = 4 mod 32
    # floats apart start in banks as far apart as 16-byte rows allow
    assert p.pitch % 32 == 4
    assert p.pitch >= (p.frames + short_chain.GROUP) * fs + 3
    if p.form == "pass":
        # the block's output rows are contiguous, as in device memory
        assert p.out_pitch == p.frames * esz
    else:
        # 16-byte rows that do not all start in one bank
        assert p.out_pitch % 16 == 0 and p.out_pitch % 128
        assert p.out_pitch >= p.frames * esz
    assert p.smem <= H100_SMEM
    assert p.smem == (32 + -(-2 * p.stages * 8 // 16) * 16 + p.stages
                      * short_chain.LANES * (4 * p.pitch + p.out_pitch))
    ints = p.as_ints()
    assert len(ints) == 8 and ints[0] == short_chain.FORMS.index(p.form) + 1
    assert ints[-2:] == [16, 64]      # a chain warp of 16 lanes, a copy warp


@pytest.mark.parametrize("c,blocks", [(1, 1), (7, 1), (64, 4), (256, 16)])
def test_short_blocks(c, blocks):
    """16 channels a block: 64 channels on 4 SMs."""
    assert short_chain.blocks(c) == blocks


def test_short_plan_refuses():
    with pytest.raises(ValueError):
        short_chain.short_plan(10, 0, 4)
    with pytest.raises(ValueError):
        short_chain.short_plan(10, -3, 4)
    with pytest.raises(ValueError):
        short_chain.short_plan(-1, 1, 4)
    with pytest.raises(ValueError):
        short_chain.short_plan(10, 1, 2)


@pytest.mark.parametrize("c,f", [(64, 34), (1, 5), (3, 1)])
def test_ook_input_of_goertzel_frames(c, f):
    """goertzel_power's [C, F, 3] columns, read in place: 3-float frames
    (channel stride 3F), the compare bins read in compare mode only."""
    p3 = torch.rand(c, f, 3)
    pm, pl, ph = p3[:, :, 0], p3[:, :, 1], p3[:, :, 2]
    assert short_chain.is_trio(pm, pl, ph)
    for compare in (False, True):
        p, cs, fs, bins = short_chain.ook_input(pm, pl, ph, compare)
        assert p is pm and (cs, bins) == (3 * f, int(compare))
        assert fs == (3 if f > 1 or compare else 1)


def test_ook_input_of_planes():
    """A plane as it lies (a row slice of a wider plane keeps its channel
    stride), a plane of frame stride 2 or 3 in place, one of 4 as a
    contiguous copy; in compare mode separate planes are packed into
    3-float frames (the kernel reads the bins from the frame); None reads
    as zero."""
    wide = torch.rand(8, 50)
    pm, pl, ph = wide[:, :40], torch.rand(8, 40), torch.rand(8, 80)[:, ::2]
    assert not short_chain.is_trio(pm, pl, ph)
    p, cs, fs, bins = short_chain.ook_input(pm, pl, ph, compare=True)
    assert (cs, fs, bins) == (120, 3, 1) and p.stride() == (120, 3)
    p3 = p.as_strided((8, 40, 3), (120, 3, 1))
    for k, v in enumerate((pm, pl, ph)):
        assert torch.equal(p3[:, :, k], v)
    assert short_chain.ook_input(pm, pl, ph, compare=False)[1:] == (50, 1, 0)
    assert short_chain.ook_input(pm, None, None, compare=True)[0] is pm
    assert short_chain.ook_input(ph, None, None, compare=True)[1:] == (
        80, 2, 0)
    pq = torch.rand(8, 160)[:, ::4]
    p, cs, fs, bins = short_chain.ook_input(pq, None, None, compare=True)
    assert p.is_contiguous() and torch.equal(p, pq) and (cs, fs, bins) == (
        40, 1, 0)
    # three columns of a [C, F, 4] tensor are not the 3-float frames
    p4 = torch.rand(8, 40, 4)
    assert not short_chain.is_trio(p4[:, :, 0], p4[:, :, 1], p4[:, :, 2])
    p, cs, fs, bins = short_chain.ook_input(p4[:, :, 0], p4[:, :, 1],
                                            p4[:, :, 2], compare=True)
    assert (cs, fs, bins) == (120, 3, 1) and p.data_ptr() != p4.data_ptr()


@pytest.mark.parametrize("mode", goertzel.THRESHOLD_MODES)
def test_ook_consts_cache(mode):
    """One entry per configuration, equal to cfg.consts(); the structure
    the kernel reads holds the same float32 values and the debounce."""
    cfg = goertzel.OOKConfig.make(mode=mode, attack_frames=3,
                                  decay_frames=5, avg_alpha=0.03)
    idx, st, addr = goertzel.ook_consts(cfg)
    assert goertzel.ook_consts(cfg)[1] is st
    assert idx == goertzel.THRESHOLD_MODES.index(mode)
    ref = cfg.consts()
    assert len(ref) == 6
    for key, v in ref.items():
        assert np.float32(getattr(st, key)) == v
    view = goertzel._OokConsts.from_address(addr)
    assert (view.attack_frames, view.decay_frames) == (3, 5)
    assert np.float32(view.keep) == ref["keep"]


def _powers(c, f, seed):
    rng = np.random.default_rng(seed)
    key = (np.arange(f)[None, :] // 7 + np.arange(c)[:, None]) % 2 == 1
    fade = 1 + 0.1 * np.sin(np.arange(f) / 40.0 + np.arange(c)[:, None])
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        np.where(key, 0.4 * fade, 1e-3 * (1 + 0.5 * rng.random((c, f)))),
        0.03 * key + 2e-3 * (1 + 0.5 * rng.random((c, f))),
        2e-3 * (1 + 0.5 * rng.random((c, f))))]


@pytest.fixture
def no_stream(monkeypatch):
    """The wrappers ask for the current CUDA stream; the stand-ins need
    none."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 0, raising=False)


def _ook_entry(cfg, state, pows, seen):
    """A stand-in for recur_ook_scan on CPU tensors: records its arguments
    and writes ook_detect_plain's results where the kernel writes them (the
    marks; the state' block's six rows of C words: peak, floor, avg,
    attack, decay, the decisions' bytes)."""
    def fn(idx, mode, consts, c, f, p, cs, fs, bins, *rest):
        seen.append(dict(mode=mode, consts=consts, c=c, f=f,
                         input=(p, cs, fs, bins), state=rest[:6],
                         marks=rest[6], words=rest[7]))
        st, marks = goertzel.ook_detect_plain(cfg, state, *pows)
        parts = ((rest[6], marks.to(torch.uint8)),
                 (rest[7], torch.stack([st.peak, st.floor, st.avg])),
                 (rest[7] + 12 * c, torch.stack([st.attack, st.decay])),
                 (rest[7] + 20 * c, st.state.to(torch.uint8)))
        for ptr, t in parts:
            t = t.contiguous()
            ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())
        return 0
    return fn


@pytest.mark.parametrize("layout", ["frames", "planes", "none"])
@pytest.mark.parametrize("mode", ["compare", "peak"])
def test_ook_launch_host_path(no_stream, mode, layout):
    """ook_launch's arguments (mode, consts, the input) and its results:
    the marks and the state' read back from its one block equal the plain
    version's, with its dtypes, shapes and contiguity."""
    c, f = 5, 37
    cfg = goertzel.OOKConfig.make(mode=mode)
    pows = _powers(c, f, 1)
    if layout == "frames":
        p3 = torch.stack(pows, -1)
        pows = [p3[:, :, k] for k in range(3)]
    elif layout == "none":
        pows = [pows[0], None, None]
    state = goertzel.ook_init(c, "cpu")
    seen = []
    before = goertzel.ook_detect.launches
    st, marks = goertzel.ook_launch(_ook_entry(cfg, state, pows, seen), cfg,
                                    state, *pows)
    assert goertzel.ook_detect.launches == before + 1 and len(seen) == 1
    a = seen[0]
    assert (a["mode"], a["c"], a["f"]) == (goertzel.THRESHOLD_MODES.index(
        mode), c, f)
    assert a["consts"] == goertzel.ook_consts(cfg)[2]
    p, cs, fs, bins = a["input"]
    bins_read = mode == "compare" and layout != "none"
    assert bins == int(bins_read)
    if layout == "frames":
        assert (p, cs, fs) == (pows[0].data_ptr(), 3 * f, 3)
    elif bins_read:
        # separate planes packed into 3-float frames for the kernel
        assert p != pows[0].data_ptr() and (cs, fs) == (3 * f, 3)
    else:
        assert (p, cs, fs) == (pows[0].data_ptr(), f, 1)
    assert a["state"] == tuple(v.data_ptr() for v in convert.leaves(state))
    ref_st, ref_m = goertzel.ook_detect_plain(cfg, state, *pows)
    assert marks.dtype == torch.bool and marks.shape == (c, f)
    assert torch.equal(marks, ref_m)
    for x, y in zip(convert.leaves(st), convert.leaves(ref_st)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.is_contiguous() and torch.equal(x, y)
    assert marks.data_ptr() == a["marks"]
    assert st.peak.data_ptr() == a["words"]
    assert st.state.data_ptr() == a["words"] + 20 * c


def test_ook_launch_refusals(no_stream):
    """ook_detect's ValueErrors on the CUDA path, reached through
    ook_launch without a card; the entry is never called."""
    def entry(*args):
        raise AssertionError("launched")

    cfg = goertzel.OOKConfig.make()
    st = goertzel.ook_init(4, "cpu")
    p = torch.zeros(4, 16)
    with pytest.raises(ValueError):             # float64 powers
        goertzel.ook_launch(entry, cfg, st, p.double(), p, p)
    with pytest.raises(ValueError):             # a low power of another shape
        goertzel.ook_launch(entry, cfg, st, p, p[:, :8], p)
    with pytest.raises(ValueError):             # [C, F, 1] powers
        goertzel.ook_launch(entry, cfg, st, p[..., None], None, None)
    with pytest.raises(ValueError):             # a [C, 1] state
        goertzel.ook_launch(entry, cfg, goertzel.OOKState(*(
            v[:, None] for v in convert.leaves(st))), p, p, p)
    with pytest.raises(ValueError):             # a strided state leaf
        goertzel.ook_launch(entry, cfg, goertzel.OOKState(
            torch.zeros(8)[::2], *convert.leaves(st)[1:]), p, p, p)
    with pytest.raises(ValueError):             # an int64 counter
        goertzel.ook_launch(entry, cfg, goertzel.OOKState(
            *convert.leaves(st)[:4], st.attack.long(), st.decay), p, p, p)
    big = torch.zeros(1, 1).expand(2 ** 16, 2 ** 13)
    with pytest.raises(ValueError):             # too large for one launch
        goertzel.ook_launch(entry, cfg, goertzel.ook_init(2 ** 16, "cpu"),
                            big, None, None)
    with pytest.raises(ValueError):             # neither CUDA nor the CPU
        goertzel.ook_detect(cfg, st, p.to("meta"), p.to("meta"),
                            p.to("meta"))


@pytest.mark.parametrize("use_hang", [True, False])
def test_agc_launch_host_path(no_stream, use_hang):
    """agc_launch's arguments and results: the levels and state' read back
    from the one output allocation equal the plain version's."""
    c, m = 3, 50
    rng = np.random.default_rng(2)
    env = torch.from_numpy(rng.normal(-2.0, 0.5, (c, m)).astype(np.float32))
    st = (torch.full((c,), -1.0), torch.full((c,), -1.5),
          torch.tensor([0, 3, 7], dtype=torch.int32))
    args = (0.03, 0.012, 0.002, 0.04, 5, use_hang)
    ref = agc.agc_scan_plain(env, *st, *args)
    seen = []

    def entry(idx, hang, env_p, cc, mm, rise, fall, drise, dfall, hs, a, d,
              h, lv, a2, d2, h2, stream):
        seen.append((hang, env_p, cc, mm, hs, (a, d, h), (lv, a2, d2, h2)))
        for ptr, t in zip((lv, a2, d2, h2), (ref[3], ref[0], ref[1],
                                              ref[2])):
            t = t.contiguous()
            ctypes.memmove(ptr, t.data_ptr(), t.numel() * 4)
        return 0

    before = agc.agc_scan.launches
    got = agc.agc_launch(entry, env, *st, *args)
    assert agc.agc_scan.launches == before + 1
    hang, env_p, cc, mm, hs, ins, outs = seen[0]
    assert (hang, env_p, cc, mm, hs) == (int(use_hang), env.data_ptr(), c, m,
                                         5)
    assert ins == tuple(v.data_ptr() for v in st)
    assert outs[1:] == (outs[0] + 4 * c * m, outs[0] + 4 * c * m + 4 * c,
                        outs[0] + 4 * c * m + 8 * c)
    order = (ref[0], ref[1], ref[2], ref[3])
    for x, y in zip(got, order):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.is_contiguous() and torch.equal(x, y)


def test_agc_launch_refusals(no_stream):
    def entry(*args):
        raise AssertionError("launched")

    env = torch.zeros(4, 64)
    st = (torch.zeros(4), torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    args = (0.1, 0.1, 0.1, 0.1, 10, True)
    with pytest.raises(ValueError):             # a strided envelope
        agc.agc_launch(entry, env.t().contiguous().t(), *st, *args)
    with pytest.raises(ValueError):             # float64
        agc.agc_launch(entry, env.double(), *st, *args)
    with pytest.raises(ValueError):             # a float hang counter
        agc.agc_launch(entry, env, st[0], st[1], st[0], *args)
    with pytest.raises(ValueError):             # a [C + 1] state
        agc.agc_launch(entry, env, torch.zeros(5), st[1], st[2], *args)
    with pytest.raises(ValueError):             # neither CUDA nor the CPU
        agc.agc_scan(env.to("meta"), *(v.to("meta") for v in st), *args)


@pytest.mark.parametrize("mode", ["compare", "peak"])
def test_ook_none_compare_bins_match_jax_zeros(mode):
    """Compare bins given as None read as zero powers: the plain version
    against the JAX package's ook_detect on zeros (the matched detector's
    call)."""
    cfg_j = jg.OOKConfig.make(mode=mode)
    cfg_t = goertzel.OOKConfig.make(mode=mode)
    pm = _powers(6, 90, 3)[0]
    z = np.zeros_like(pm.numpy())
    js, jm = jax.jit(lambda s, a, b, c: jg.ook_detect(cfg_j, s, a, b, c))(
        jg.ook_init(6), pm.numpy(), z, z)
    ts, tm = goertzel.ook_detect(cfg_t, goertzel.ook_init(6, "cpu"), pm)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(js), convert.state_to_numpy(ts)):
        a = np.asarray(a)
        if a.dtype == np.float32:
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(a).max(), 1e-30)
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize("compare", [False, True])
def test_ook_scan_bound_counts_the_bytes_the_mode_reads(compare):
    c, f = 64, 2048
    b = roofline.ook_scan_bound(c, f, 0.0, compare=compare)
    assert b["bytes"] == c * f * ((12 if compare else 4) + 1) + 2 * 21 * c
    assert b["bound_by"] == "bytes"
    s = roofline.ook_scan_bound(c, f, 30.0, compare=compare)
    assert s["serial_ms"] == pytest.approx(f * 30e-6)
    assert s["bound_by"] == "operations"


@pytest.mark.parametrize("form", pll.FED_FORMS)
def test_fed_probe_patterns(form):
    """The fed probes' inputs: a power-of-two length, float32, both states
    of the keying (the AGC's envelope rises and falls past the probe's
    100-sample hang; the OOK powers mark and space); K3's and K3c's
    [re, im, amp', q] frames with q the detector's denominator of amp',
    on which the loop tracks (_loop_tracks)."""
    a = pll.probe_pattern(form)
    assert a.dtype == np.float32 and form in pll.PROBE_FORMS
    n = a.shape[0]
    assert n & (n - 1) == 0
    if form.startswith("agc"):
        on = a > -1.0
        assert a.ndim == 1 and on.any() and (~on).any()
        runs = np.diff(np.flatnonzero(np.diff(on.astype(int))))
        assert runs.max() > 100
    elif form.startswith("ook"):
        assert a.shape == (n, 3) and (a[:, 1:] > 0).all()
        assert (a[:, 0] > 0.3).any() and (a[:, 0] < 0.01).any()
    else:
        assert a.shape == (n, 4) and n % short_chain.LOOP_GROUP == 0
        amp = a[:, 2]
        assert (amp > 0).all()
        if form == "costas":
            assert np.array_equal(a[:, 3], np.maximum(amp * amp,
                                                      np.float32(1e-12)))
        elif form == "pilot":
            assert np.array_equal(a[:, 3], np.maximum(
                np.float32(np.pi / 4) * amp, np.float32(1e-6)))
            assert (a[:, 1] == 0).all()          # a real pilot
        else:
            assert (a[:, 3] == 0).all()
        _loop_tracks(form, a)
    assert np.array_equal(pll.probe_pattern(form), a)
    with pytest.raises(ValueError):
        pll.probe_pattern("sweep single")


def _loop_tracks(form, a):
    """The pattern, four times over, through the plain loop at the probe's
    constants: the loop follows the tone (K3: its frequency over the last
    pass within 2e-4 rad a sample of the tone's, wandering with the noise;
    K3c: fdev follows the drifting tone's frequency, correlation > 0.99)
    and its phase keeps turning over the whole circle: no fixed point."""
    n = a.shape[0]
    x = torch.from_numpy(np.tile(a[:, 0] + 1j * a[:, 1], 4)
                         .astype(np.complex64))[None]
    st = (torch.zeros(1), torch.zeros(1), torch.ones(1))
    if form.startswith("chunk"):
        alpha, beta, _, lo, hi = pll.PROBE_LOOP["chunk"]
        *_, phases, f = pll.pll_chunk_scan_plain(x, *st, form == "chunk pilot",
                                                 alpha, beta, lo, hi)
        k = np.arange(n)
        true = 2 * np.pi * (16 + 20 * np.cos(2 * np.pi * k / n)) / n
        assert np.corrcoef(f[0, -n:].numpy(), true)[0, 1] > 0.99
    else:
        *_, phases, f = pll.pll_scan_plain(x, *st, form,
                                           *pll.PROBE_LOOP["pll"])
        cycles = {"atan2": 7, "cross": 7, "costas": 6, "pilot": 5}[form]
        f = f[0, -n:].numpy()
        assert abs(f.mean() - 2 * np.pi * cycles / n) < 2e-4
        assert f.std() > 0
    ph = phases[0, -n:].numpy()
    assert ph.max() - ph.min() > 6.0 and np.unique(ph).size > n // 2


@pytest.mark.parametrize("n", [0, 1, 3, 128, 4096, 32768])
@pytest.mark.parametrize("c", [1, 7, 16, 64, 256])
def test_loop_plan_form_and_layout(c, n):
    """The loop kernel's plan (csrc/recur.cu loop_plan's mirror; the card
    test holds them equal): the pass form where the row fits one stage,
    the ring above it; room in a staged row for its frames (two floats
    each), its float offset in a 16-byte line and a register group read
    past the segment; rows 4 mod 32 floats apart; a row of denominators
    (1 mod 32 floats apart) and two output rows a stage;
    the shared memory within the H100's 227 KB; one channel a block (a
    chain thread and the copy warp)."""
    p = short_chain.loop_plan(n)
    assert p.form == ("pass" if n <= short_chain.LOOP_STAGE_FRAMES
                      else "ring")
    assert p.frames == (n if p.form == "pass"
                        else short_chain.LOOP_STAGE_FRAMES)
    assert p.stages == (0 if n == 0 else 1 if p.form == "pass"
                        else short_chain.LOOP_STAGES)
    assert p.pitch % 32 == 4
    assert p.pitch >= 2 * (p.frames + short_chain.LOOP_GROUP) + 2
    # q rows in distinct banks, a register group read past the segment
    assert p.qpitch % 32 == 1 and p.qpitch >= p.frames + short_chain.LOOP_GROUP
    if p.form == "pass":
        assert p.out_pitch == 4 * p.frames
    else:
        assert p.out_pitch % 16 == 0 and p.out_pitch % 128
        assert p.out_pitch >= 4 * p.frames
    assert p.smem <= H100_SMEM
    assert p.smem == (32 + -(-3 * p.stages * 8 // 16) * 16 + p.stages
                      * p.rows * (4 * p.pitch + 2 * p.out_pitch)
                      + -(-4 * p.stages * p.rows * p.qpitch // 16) * 16)
    assert (p.rows, p.threads) == (1, 64)
    ints = p.as_ints()
    assert len(ints) == 10 and ints[0] == short_chain.FORMS.index(p.form) + 1
    assert ints[-3:] == [1, 1, 64]
    assert short_chain.loop_blocks(c) == c
    # every channel in one block of the grid, 64 channels on 64 SMs
    assert short_chain.loop_blocks(c) * p.rows >= c > (
        short_chain.loop_blocks(c) - 1) * p.rows


def test_loop_plan_refuses():
    with pytest.raises(ValueError):
        short_chain.loop_plan(-1)


@pytest.mark.parametrize("form", ["atan2", "costas", "chunk", "chunk pilot"])
def test_loop_launch_host_path(no_stream, form):
    """pll.loop_launch (pll_scan's and pll_chunk_scan's CUDA path) through
    a stand-in C entry that writes the plain version's results where the
    kernel writes them: the flag, the constants, the pointers in the
    entry's order, and the five results (state', then the two outputs)."""
    c, n = 3, 40
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((c, n)) + 1j
                          * rng.standard_normal((c, n))).astype(np.complex64))
    st = (torch.tensor([0.1, -2.0, 3.0]), torch.tensor([0.0, 1e-3, -1e-3]),
          torch.ones(c))
    chunk = form.startswith("chunk")
    if chunk:
        flag, consts = int(form == "chunk pilot"), (0.1, 0.01, -0.5, 0.5)
        ref = pll.pll_chunk_scan_plain(x, *st, bool(flag), *consts)
    else:
        flag, consts = pll.DETECTORS.index(form), (0.0139, 9.6e-5, 0.03,
                                                   -0.098, 0.098)
        ref = pll.pll_scan_plain(x, *st, form, *consts)
    seen = []

    def entry(idx, fl, xp, cc, nn, *rest):
        k = len(consts)
        seen.append((fl, xp, cc, nn, rest[:k], rest[k:k + 3]))
        outs, st_out = rest[k + 3:k + 5], rest[k + 5:k + 8]
        for ptr, t in zip(st_out + outs, ref):
            t = t.contiguous()
            ctypes.memmove(ptr, t.data_ptr(), t.numel() * 4)
        return 0

    before = (pll.pll_scan.launches, pll.pll_chunk_scan.launches)
    got = pll.loop_launch(entry, form, x, st, flag, consts)
    # the wrappers count; loop_launch alone does not
    assert (pll.pll_scan.launches, pll.pll_chunk_scan.launches) == before
    fl, xp, cc, nn, k, ins = seen[0]
    assert (fl, xp, cc, nn) == (flag, x.data_ptr(), c, n)
    assert k == consts and ins == tuple(v.data_ptr() for v in st)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.is_contiguous() and torch.equal(a, b)


def test_loop_launch_refusals(no_stream):
    def entry(*args):
        raise AssertionError("launched")

    x = torch.zeros(4, 64, dtype=torch.complex64)
    st = (torch.zeros(4),) * 3
    with pytest.raises(ValueError):             # a strided input
        pll.loop_launch(entry, "t", x.t().contiguous().t(), st, 0,
                        (0.1,) * 5)
    with pytest.raises(ValueError):             # complex128
        pll.loop_launch(entry, "t", x.to(torch.complex128), st, 0,
                        (0.1,) * 5)
    with pytest.raises(ValueError):             # a [C + 1] state leaf
        pll.loop_launch(entry, "t", x, (torch.zeros(5),) + st[1:], 0,
                        (0.1,) * 5)
    with pytest.raises(ValueError):             # a float64 state leaf
        pll.loop_launch(entry, "t", x, st[:2] + (torch.zeros(4).double(),),
                        0, (0.1,) * 5)
    with pytest.raises(ValueError):             # an unknown detector
        pll.pll_scan(x, *st, "pll", 0.1, 0.01, 0.0, -1.0, 1.0)
    with pytest.raises(ValueError):             # neither CUDA nor the CPU
        pll.pll_scan(x.to("meta"), *(v.to("meta") for v in st), "atan2",
                     0.1, 0.01, 0.0, -1.0, 1.0)


def test_pll_scan_bound_is_bytes_or_the_serial_floor():
    """K3 moves 8 bytes in and 8 out a step and channel (x complex64,
    phases and freqs float32) and 24 bytes of state a channel; its serial
    floor is the steps times the fed probe's step."""
    c, n = 64, 32768
    b = roofline.pll_scan_bound(c, n, 0.0)
    assert b["bytes"] == c * n * 16 + 24 * c and b["bound_by"] == "bytes"
    s = roofline.pll_scan_bound(c, n, 200.0)
    assert s["serial_ms"] == pytest.approx(n * 200e-6)
    assert s["bound_ms"] == s["serial_ms"] and s["bound_by"] == "operations"
    assert roofline.pll_chunk_bound(c, 4096, 200.0) == \
        roofline.pll_scan_bound(c, 4096, 200.0)
