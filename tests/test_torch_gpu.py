"""Card-only tests of the PyTorch port: the CUDA kernels (the front end K1
in its AM and WFM forms, its hq form with the composite decimation K1e,
and with its options int16 entry, IQ balance and the NB1/NB2 noise
blanker; its first pass front_means alone; the stereo tail K2; the K1
probes) against their plain PyTorch versions, the wrappers' refusals of
what the kernels do not take (unaligned planes, the floor's lanes % 4),
and the AM, WFM, WFM hq and WFM+RDS receivers on the card against the CPU
(with the front options, int16, folded and unaligned entry planes too),
the narrowband receivers (SSB, CW, DIG, DSB, NONE, SAM), and FMN with
CTCSS, mono WFM, the ANF and AGC "long" on the card against the CPU; the
recurrence kernels of csrc/recur.cu (pll_scan in each detector,
pll_chunk_scan, agc_scan, the chain probe) against their plain versions
(K3 and K3c on the loop kernel bit for bit at C = 1 to 200 and N = 0 to
4099, one kernel a call, its plan equal to ops/short_chain.py loop_plan,
the fed chain-only probe no slower than the kernel),
and the receivers that run them (the scan RDS carrier, SAM on 64-sample
blocks) and the module options (SAM scan and loop, NFM "pll", the scan
AGC) on the card against the CPU; K5 (iq_lms_scan, the adaptive IQ
balance) against its plain version, and the receivers on the staged front
("auto" in AM, USB + NB1, SAM and FMM + RDS; enable_dc_removal=False) and
the PfbBankReceiver (trivial, "auto" and oversample=2 fronts) on the card
against the CPU; the AM Receiver under TF32 ("high") against IEEE; the
stereo tail without K2 (2.88 Msps, the staged front, the "pll" pilot with
its notch) on the card against the CPU; the CLI with --device cuda; K6
(ook_scan, the OOK detector, six threshold modes) and K7 (sweep_scan, the
test generator's sweep) against their plain versions, K4 and K6 on the
short-chain kernel at C = 1, 7, 64, 256 and F = 1, 34, 2048 (one launch
and one kernel a call; ops/short_chain.py's plan equal to the C one; K6's
powers as [C, F, 3] columns, planes or without compare bins), the fed
chain probes, the Receiver's taps
and the TestBench on the card against the CPU, and --decode cw on the
card; K8 (anf_scan, the ANF's block LMS) against its plain version at U =
16, 1024, 1 and others, each of its two forms forced, its bits repeated,
complex rows and its refusals, and the ANF on the staged front on the card
against the CPU.

They skip where CUDA is absent (the kernels have no CPU mode).  This file
imports no jax, so it also runs on a machine that has only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.core import siggen
from pebblesdr_tpu_torch.demod import nfm, rds, sam, wfm
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import (agc, decimator, front, goertzel, kprobe,
                                     pll, scanops, wfm_tail)
from pebblesdr_tpu_torch.ops.mixer import split_freq
from pebblesdr_tpu_torch.utils import convert

pytestmark = pytest.mark.gpu

FS = 2_048_000
RTOL = 3e-5  # K1 vs plain: the TPU kernel's bound (tests/test_pallas.py:63)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _cuda_names(fn, calls: int, done, tries: int = 3) -> list[str]:
    """The names of the CUDA kernels torch.profiler records over `calls`
    calls of fn.  The profiler can lose a record (never add one), so the
    calls are traced again, up to `tries` traces, while done(names) is
    False (chip_smoke.py kernel_times does the same); the last trace's
    names are returned for the caller's assertions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA]
        if done(names):
            break
    return names


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double().cpu(), got.double().cpu()
    return float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))


def _plan(device, protect=30_000):
    p = decimator.build_plan(FS, protect)
    return front.FrontPlan.make(decimator.compose_response(p), p.factor, device)


def _tunes(c, device):
    s = [split_freq(250_000.0 + 1234.5 * i, FS) for i in range(c)]
    return (torch.tensor(np.array([v[0] for v in s]), device=device),
            torch.tensor(np.array([v[1] for v in s]), device=device))


@pytest.mark.parametrize("c,k", [(8, 3), (5, 2), (64, 4)])
def test_front_kernel_matches_plain(cuda, c, k):
    """Two streaming calls; C=5 exercises a partial channel group and lane
    offsets that are not 16-byte aligned."""
    n = 8192
    plan = _plan(cuda)
    hi, lo = _tunes(c, cuda)
    rng = np.random.default_rng(5)
    st_k = st_r = (torch.full((1, 2 * c), 0.01, device=cuda),
                   torch.full((c,), 0.3, device=cuda),
                   torch.randn(plan.d_rows, 2 * c, device=cuda))
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((k * n, 2 * c))
                             .astype(np.float32) + 0.2).to(cuda)
        before = front.fused_front.launches
        got = front.fused_front(plan, x, st_k[0], st_k[1], hi, lo, st_k[2],
                                n_block=n, raw_rows=2048)
        assert front.fused_front.launches == before + 1
        ref = front.fused_front_reference(plan, x, st_r[0], st_r[1], hi, lo,
                                          st_r[2], n_block=n, raw_rows=2048)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            assert rel_err(b, a) < RTOL
        st_k, st_r = (got[1], got[3], got[2]), (ref[1], ref[3], ref[2])


def test_front_kernel_rejects_wrong_inputs(cuda):
    plan = _plan(cuda)
    c, n = 2, 2048
    ok = dict(dc=torch.zeros(1, 2 * c, device=cuda),
              phase0=torch.zeros(c, device=cuda),
              f_hi=torch.zeros(c, device=cuda), f_lo=torch.zeros(c, device=cuda),
              tail=torch.zeros(plan.d_rows, 2 * c, device=cuda))
    x = torch.zeros(n, 2 * c, device=cuda)
    with pytest.raises(ValueError):
        front.fused_front(plan, x.double(), n_block=n, **ok)
    with pytest.raises(ValueError):
        front.fused_front(plan, x, n_block=n, **{**ok, "tail": ok["tail"][:-1]})
    with pytest.raises(ValueError):
        front.fused_front(plan, x.t().contiguous().t(), n_block=n, **ok)
    with pytest.raises(ValueError):
        front.fused_front(plan, x, n_block=n, **{**ok, "dc": ok["dc"].cpu()})


def _am_plane(c, rows, rng):
    t = np.arange(rows) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = 0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
    x = np.stack([iq] * c, axis=1)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return torch.from_numpy(np.concatenate([x.real, x.imag], 1)
                            .astype(np.float32))


def test_receiver_on_card_matches_cpu(cuda):
    """The bounds of tests/test_chain_batched.py:58-69, after a CPU warm-up
    block carried to both."""
    n, c = 8192, 4
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         agc_stride=16)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(8)
    sc, _ = cpu.step_many(cpu.init_state(), pc, _am_plane(c, n, rng))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    before = front.fused_front.launches
    for k in (3, 9):
        x = _am_plane(c, k * n, rng)
        sc, oc = cpu.step_many(sc, pc, x)
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        assert torch.equal(og["squelch_open"].cpu(), oc["squelch_open"])
        for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
            assert np.abs(a.astype(np.complex128)
                          - b.astype(np.complex128)).max() < 1e-4
    assert front.fused_front.launches == before + 2


@pytest.mark.parametrize("mode,opts", [
    (DemodMode.USB, {}), (DemodMode.LSB, {}), (DemodMode.CWU, {}),
    (DemodMode.DIGL, {}), (DemodMode.DSB, {}), (DemodMode.NONE, {}),
    (DemodMode.SAM, dict(sam_sideband="analytic")),
    (DemodMode.SAM, dict(sam_sideband="rails"))],
    ids=["usb", "lsb", "cwu", "digl", "dsb", "none", "sam", "sam_rails"])
def test_narrowband_receivers_on_card_match_cpu(cuda, mode, opts):
    """The narrowband modes on the card against the CPU Receiver: the
    bounds of tests/test_chain_batched.py:58-69 (SAM audio 2e-3 of its
    scale, the PLL-mode bound), after a CPU warm-up block carried to both;
    K1 launches once per dispatch."""
    n, c = 8192, 4
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         agc_stride=16, mode=mode, **opts)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(8)
    sc, _ = cpu.step_many(cpu.init_state(), pc, _am_plane(c, n, rng))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    before = front.fused_front.launches
    for k in (3, 9):
        x = _am_plane(c, k * n, rng)
        sc, oc = cpu.step_many(sc, pc, x)
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        err = float((og["audio"].cpu() - oc["audio"]).abs().max())
        if mode == DemodMode.SAM:
            assert err < 2e-3 * max(float(oc["audio"].abs().max()), 1e-6)
        else:
            assert err < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        assert torch.equal(og["squelch_open"].cpu(), oc["squelch_open"])
        for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
            d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
            if mode == DemodMode.SAM:     # phases compared modulo 2 pi
                d = np.minimum(d, np.abs(d - 2 * np.pi))
            assert d.max(initial=0.0) < 1e-4
    assert front.fused_front.launches == before + 2


def test_matmuls_are_ieee_float32(cuda):
    """The receive chain's matmuls must not run in TF32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_convolutions_are_ieee_float32(cuda):
    """fir_apply's conv1d runs in IEEE float32 with cuDNN's TF32 allowed by
    the caller, whose setting it restores: within 1e-5 of scale of a
    float64 convolution."""
    from pebblesdr_tpu_torch.ops import fir
    rng = np.random.default_rng(7)
    c, n = 4, 8192
    x = (rng.standard_normal((c, n))
         + 1j * rng.standard_normal((c, n))).astype(np.complex64)
    taps = rng.standard_normal(31).astype(np.float32)
    want = np.stack([np.convolve(r.astype(np.complex128),
                                 taps.astype(np.float64))[:n] for r in x])
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y, _ = fir.fir_apply(torch.from_numpy(x).to(cuda), taps,
                             torch.zeros(c, 30, dtype=torch.complex64,
                                         device=cuda))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert np.abs(y.cpu().numpy() - want).max() < 1e-5 * np.abs(want).max()


def test_receiver_under_tf32_matches_ieee(cuda):
    """The AM Receiver (C = 4, K = 3, three dispatches) with the process at
    "high" (cuBLAS TF32 allowed) and cuDNN TF32 on gives a run under
    "highest" within the parity bounds (audio 2e-4, spectra and S-meter 0.1
    dB, squelch equal), and hands both settings back."""
    c, n, k = 4, 8192, 3
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                 channels=c, agc_stride=16), cuda)
    p = rx.default_params(250_000.0)
    rng = np.random.default_rng(11)
    t = np.arange(3 * k * n) / FS
    sig = (0.25 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t))
           * np.exp(2j * np.pi * 250_300.0 * t))
    x = np.stack([sig * (0.5 + 0.2 * i) for i in range(c)], axis=1)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    plane = torch.from_numpy(np.concatenate([x.real, x.imag], axis=1)
                             .astype(np.float32)).to(cuda)

    def run():
        st, outs = rx.init_state(), []
        for i in range(3):
            st, out = rx.step_many(st, p, plane[i * k * n:(i + 1) * k * n])
            outs.append(out)
        return outs

    ref = run()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        got = run()
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = prev_cudnn
    for r, g in zip(ref, got):
        assert float((r["audio"] - g["audio"]).abs().max()) < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((r[key] - g[key]).abs().max()) < 0.1, key
        for key in r["smeter"]:
            assert float((r["smeter"][key] - g["smeter"][key]).abs().max()) \
                < 0.1, key
        assert torch.equal(r["squelch_open"], g["squelch_open"])
    assert float(ref[-1]["audio"].abs().max()) > 0.5


def test_shared_memory_layouts_match_the_sources(cuda):
    """front_fir's and the stereo tail's layouts and work plans mirrored
    in Python (the CPU size and coverage checks) agree with the CUDA
    sources; the tail's block fits for the covered low-passes and is
    refused past the most taps it holds."""
    import ctypes
    lib = front._lib()
    out = (ctypes.c_int * 9)()
    fout = (ctypes.c_int * 10)()
    for ntaps, factor in ((20, 4), (9, 8), (30, 2), (283, 8), (711, 32),
                          (135, 4), (200, 2), (2007, 64), (1159, 32)):
        for nb in (False, True):
            for elem in (4, 2):
                lay = front.fir_march_layout(ntaps, factor, nb, elem)
                assert lib.front_fir_smem_bytes(
                    ntaps, factor, int(nb), int(elem == 2)) == (
                    lay["smem"] if lay else 0)
                for t, c in ((1 << 20, 64), (1 << 19, 256), (1 << 21, 16),
                             (8192, 13)):
                    plan = front.fir_march_plan(t, c, factor, ntaps, 132,
                                                7 if nb else 0, elem)
                    r = lib.front_fir_plan(t, c, ntaps, factor, int(nb),
                                           int(elem == 2), 132, fout)
                    if plan is None:
                        assert r == -1
                        continue
                    lay = plan["layout"]
                    assert r == 0 and list(fout) == [
                        plan["seg_outputs"], len(plan["segments"]),
                        plan["items"], plan["grid"], plan["step_rows"],
                        lay["hist"], lay["ring_rows"], lay["stages"],
                        lay["box_rows"], lay["cg"]]
    tlib = wfm_tail._lib()
    tout = (ctypes.c_int * 11)()
    for ntaps, factor, ell in ((235, 4, 256), (31, 4, 128), (235, 2, 256),
                               (501, 4, 256)):
        smem = tlib.wfm_tail_smem_bytes(ntaps, factor, ell)
        assert 0 < smem <= 232448
        assert smem == wfm_tail.tail_march_layout(ntaps, factor)["smem"]
        for t, c in ((131072, 64), (262144, 16), (2048, 3), (24576, 13)):
            plan = wfm_tail.tail_march_plan(t, c, factor, ntaps, 132)
            lay = plan["layout"]
            assert tlib.wfm_tail_plan(t, c, ntaps, factor, ell, 132,
                                      tout) == 0
            assert list(tout) == [
                plan["seg_outputs"], len(plan["segments"]), plan["items"],
                plan["grid"], plan["step_rows"], lay["hist"],
                lay["ring_rows"], lay["stages"], lay["stage_rows"],
                lay["slices"], lay["dps"]]
    assert tlib.wfm_tail_smem_bytes(600, 4, 256) == 0
    # the most one block holds: 512 taps at F = 4; 513 is refused
    assert 0 < tlib.wfm_tail_smem_bytes(512, 4, 256) <= 232448
    assert tlib.wfm_tail_smem_bytes(513, 4, 256) == 0
    assert wfm_tail.tail_march_layout(513, 4) is None
    assert tlib.wfm_tail_plan(8192, 4, 513, 4, 256, 132, tout) == -1
    # front_comp (the hq form's pass over y) and front_dc_scan
    assert lib.front_comp_smem_bytes() == front.comp_march_layout()["smem"]
    for m, c in ((262144, 64), (4096, 5), (8192, 64), (4096, 256),
                 (2048, 64), (6144, 4), (64, 3)):
        for sms in (132, 3):
            plan = front.comp_march_plan(m, c, sms)
            lay = plan["layout"]
            assert lib.front_comp_plan(m, c, sms, out) == 0
            assert list(out) == [
                plan["seg_outputs"], len(plan["segments"]), plan["items"],
                plan["grid"], plan["step_rows"], lay["hist"],
                lay["ring_rows"], lay["stages"], lay["box_rows"]]
    assert lib.front_comp_plan(4095, 8, 132, out) == -1
    sout = (ctypes.c_int * 6)()
    for nchunk, lanes in ((2048, 128), (4096, 32), (1024, 512), (48, 10),
                          (512, 128), (70_000, 2), (8192, 16)):
        lay = front.dc_scan_layout(nchunk, lanes)
        assert lib.front_dc_scan_plan(nchunk, lanes, sout) == 0
        assert list(sout) == [lay[key] for key in (
            "lanes", "blocks", "threads", "held", "len", "smem")]


# front_fir's seams: (C, blocks of 2048 rows, plan, dtype, blanker); the
# plans: "am" F = 32, "wfm" F = 8, "hq" F = 4, "f2" a 30-tap response at
# F = 2, and on items of 4 channels "usb" F = 64 (2007 taps) and "none"
# F = 32 (1159 taps)
MARCH_CASES = {
    "am_c8_seams": (8, 12, "am", "f32", None),
    "am_c64_short_last": (64, 4, "am", "f32", None),
    "am_c256": (256, 8, "am", "f32", None),
    "am_c3_elements": (3, 8, "am", "f32", None),
    "am_c13_elements": (13, 8, "am", "f32", None),
    "am_i16_c64_tma": (64, 8, "am", "i16", None),
    "am_i16_c6_elements": (6, 8, "am", "i16", None),
    "am_i16_c13_elements": (13, 8, "am", "i16", None),
    "wfm_c64": (64, 16, "wfm", "f32", None),
    "hq_c64": (64, 16, "hq", "f32", None),
    "f2_c8": (8, 8, "f2", "f32", None),
    "am_c16_nb1_seams": (16, 16, "am", "f32", "blank"),
    "wfm_c13_nb2_seams": (13, 16, "wfm", "f32", "average"),
    "am_i16_c8_nb1": (8, 12, "am", "i16", "blank"),
    "usb_c64": (64, 24, "usb", "f32", None),
    "usb_c5_elements": (5, 16, "usb", "f32", None),
    "usb_i16_c64_tma": (64, 16, "usb", "i16", None),
    "usb_i16_c12_elements": (12, 16, "usb", "i16", None),
    "usb_c16_nb1_seams": (16, 24, "usb", "f32", "blank"),
    "usb_i16_c8_nb1": (8, 16, "usb", "i16", "blank"),
    "none_c64": (64, 16, "none", "f32", None),
    "none_c13_nb2_seams": (13, 16, "none", "f32", "average"),
}
MARCH_PROTECT = {"am": 30_000, "wfm": 200_000, "hq": 400_000, "usb": 20_000,
                 "none": 48_000}


@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_front_fir_march_matches_plain_across_seams(cuda, case):
    """front_fir's time march against the plain version over two streaming
    calls with a non-zero carried tail: planes with many segments (their
    seams on and off a 512-row DC chunk boundary), a last segment shorter
    than the history, partial channel groups, the element-by-element
    staging (C = 3, 13; int16 C = 6, 13) and the tensor map (C = 8, 64, 256;
    int16 C = 8, 64), F = 32, 8, 4, 2, and NB1 / NB2 with impulses
    straddling the segment seams (margin asserted, no flag mismatch)."""
    c, blocks, kind, dtype, mode = MARCH_CASES[case]
    n = 2048
    t = blocks * n
    if kind == "f2":
        h = np.random.default_rng(3).standard_normal(30) / 30
        plan = front.FrontPlan.make(h, 2, cuda)
    else:
        plan = _plan(cuda, MARCH_PROTECT[kind])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    bw = 7 if mode else 0
    mp = front.fir_march_plan(t, c, plan.factor, plan.h.numel(), sms, bw,
                              2 if dtype == "i16" else 4)
    starts = [plan.factor * o - plan.factor + 1 for o, _ in mp["segments"]]
    assert len(starts) > 1
    if case == "am_c8_seams":     # seams on and off a DC chunk boundary
        seams = [plan.factor * o for o, _ in mp["segments"][1:]]
        assert any(v % 512 == 0 for v in seams)
        assert any(v % 512 for v in seams)
    if case == "am_c64_short_last":
        o_s, o_e = mp["segments"][-1]
        assert (o_e - o_s) * plan.factor < mp["layout"]["hist"]
    hi, lo = _tunes(c, cuda)
    rng = np.random.default_rng(17)
    nb = (3.3, bw, 0.001, mode) if mode else None
    iq = ((torch.tensor(1.05, device=cuda), torch.tensor(0.02, device=cuda))
          if mode else (None, None))
    z = dict(device=cuda)
    tail = torch.from_numpy(rng.standard_normal((plan.d_rows, 2 * c))
                            .astype(np.float32) * 0.1).to(cuda)
    st_k = st_r = (torch.full((1, 2 * c), 0.02, **z),
                   torch.full((c,), 0.3, **z), tail,
                   torch.full((1, 2 * c), 0.1, **z),
                   torch.zeros(16, 2 * c, **z))
    for _ in range(2):
        x = (_am_plane(c, t, rng).numpy() + 0.04) if mode else (
            rng.standard_normal((t, 2 * c)).astype(np.float32) * 0.3 + 0.1)
        if mode:                  # impulses just before each seam
            for s0 in starts[1:]:
                x[s0 - 3, :] += 8.0
        x = torch.from_numpy(x)
        if dtype == "i16":
            x = torch.clamp(torch.round(x * 3276.8), -32768, 32767
                            ).to(torch.int16)
        x = x.to(cuda)
        kw = dict(n_block=n, raw_rows=512, iq_gain=iq[0], iq_phase=iq[1])
        masks, outs = [], []
        for st, fn in ((st_k, front.fused_front),
                       (st_r, front.fused_front_reference)):
            kws = dict(kw)
            if nb:
                if fn is front.fused_front_reference:
                    _assert_margin(plan, x, st[0], iq, nb, st[3], st[4])
                masks.append(torch.zeros(t, 2 * c, dtype=torch.uint8, **z))
                kws.update(nb=nb, nb_avg=st[3], nb_tail=st[4],
                           nb_mask=masks[-1])
            before = (front.fused_front.launches,
                      front.fused_front.element_launches)
            outs.append(fn(plan, x, st[0], st[1], hi, lo, st[2], **kws))
            if fn is front.fused_front:
                elements = not front.fir_tma(c, x.dtype)
                assert (front.fused_front.launches,
                        front.fused_front.element_launches) == (
                    before[0] + 1, before[1] + elements)
        torch.cuda.synchronize()
        got, ref = outs
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a.shape == b.shape, i
            assert rel_err(b, a) < RTOL, (case, i)
        if nb:
            assert torch.equal(got[6], ref[6])
            assert int((masks[0] != masks[1]).sum()) == 0
            assert int(masks[1].sum()) > 0
        st_k, st_r = [(o[1], o[3], o[2], o[5] if nb else st[3],
                       o[6] if nb else st[4])
                      for o, st in ((got, st_k), (ref, st_r))]


def _fm_plane(c, rows, rng):
    """FM at 250 kHz with bounded phase steps, channel i offset by i*pi/2 +
    pi/4 (the first discriminator row lands in every quadrant), plus noise."""
    t = np.arange(rows) / FS
    mod = np.sin(2 * np.pi * 700.0 * t) + 0.3 * np.sin(2 * np.pi * 5e3 * t)
    ph = 2 * np.pi * np.cumsum(60e3 * mod) / FS
    iq = np.stack([0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph
                                      + np.pi / 4 + i * np.pi / 2))
                   for i in range(c)], axis=1)
    iq = iq + 1e-3 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape))
    return torch.from_numpy(np.concatenate([iq.real, iq.imag], 1)
                            .astype(np.float32))


@pytest.mark.parametrize("c,k", [(4, 3), (5, 2), (64, 4)])
def test_front_wfm_kernel_matches_plain(cuda, c, k):
    """K1 with the discriminator and y-tail switches (factor-8 WFM plan),
    two streaming calls from a zero disc_last."""
    n, zt, gain = 8192, 1024, 256_000 / (2 * np.pi * 75_000)
    plan = _plan(cuda, 200_000)
    # one tune for all channels keeps every phase step well inside (-pi, pi)
    hi, lo = (torch.full((c,), float(v), device=cuda)
              for v in split_freq(250_000.0, FS))
    rng = np.random.default_rng(6)
    zeros = dict(device=cuda)
    st_k = st_r = (torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
                   torch.zeros(plan.d_rows, 2 * c, **zeros),
                   torch.zeros(1, 2 * c, **zeros))
    for call in range(2):
        x = _fm_plane(c, k * n, rng).to(cuda)
        kw = dict(n_block=n, raw_rows=2048, disc_gain=gain, y_tail_rows=zt)
        before = front.fused_front.launches
        got = front.fused_front(plan, x, st_k[0], st_k[1], hi, lo, st_k[2],
                                disc_last=st_k[3], **kw)
        assert front.fused_front.launches == before + 1
        ref = front.fused_front_reference(plan, x, st_r[0], st_r[1], hi, lo,
                                          st_r[2], disc_last=st_r[3], **kw)
        torch.cuda.synchronize()
        assert got[0].shape == (k, zt, 2 * c)
        for i in (0, 1, 2, 3, 4, 6):
            assert got[i].shape == ref[i].shape
            assert rel_err(ref[i], got[i]) < RTOL, i
        assert float((got[5] - ref[5]).abs().max()) < 1e-4
        if call == 0:   # the signed-zero row: atan2(+-0, -0) = +-pi
            assert torch.equal(got[5][0].cpu(), ref[5][0].cpu())
        st_k = (got[1], got[3], got[2], got[6])
        st_r = (ref[1], ref[3], ref[2], ref[6])


# K2's cases: (C, composite rows, taps, F, ell, zero history); the
# receiver's low-pass is 235 taps at F = 4, ell 256
TAIL_CASES = {
    "c4": (4, 16384, 235, 4, 256, False),
    "c5": (5, 16384, 235, 4, 256, False),
    "c64": (64, 16384, 235, 4, 256, False),
    "c3_elements": (3, 16384, 235, 4, 256, False),
    "c13_elements": (13, 16384, 235, 4, 256, False),
    "c16_tma": (16, 16384, 235, 4, 256, False),
    "c16_t2048": (16, 2048, 235, 4, 256, False),
    "wfm_64ch_short_last_segment": (64, 131072, 235, 4, 256, False),
    "wfm_16ch_last_segment_under_a_step": (16, 262144, 235, 4, 256, False),
    "c64_zero_history": (64, 16384, 235, 4, 256, True),
    "c16_31taps_ell128": (16, 16384, 31, 4, 128, False),
    "c16_235taps_f2": (16, 16384, 235, 2, 256, False),
    "c13_501taps": (13, 16384, 501, 4, 256, False),
}


def _tail_taps(ntaps):
    if ntaps == 235:
        return wfm.WFMConfig.make(256_000.0).audio_taps
    return (np.random.default_rng(ntaps).standard_normal(ntaps)
            / ntaps).astype(np.float32)


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_wfm_tail_kernel_matches_plain(cuda, case):
    """K2 against wfm_tail_reference over two streaming calls from a random
    (or zero) history: partial channel groups, the element-by-element
    staging (C = 3, 5, 13) and the tensor map (C = 4, 16, 64), a plane
    shorter than one segment per SM, the cells' shapes (a last segment
    shorter than the rest; one shorter than a step), and the responses
    the port accepts.  One CUDA launch per call."""
    c, n, ntaps, factor, ell, zero = TAIL_CASES[case]
    plan = wfm_tail.TailPlan.make(_tail_taps(ntaps), factor, ell, 2048, cuda)
    mp = wfm_tail.tail_march_plan(n, c, factor, ntaps)
    o_s, o_e = mp["segments"][-1]
    if case == "wfm_64ch_short_last_segment":
        assert o_e - o_s < mp["seg_outputs"] and (o_e - o_s) % 128
    if case == "wfm_16ch_last_segment_under_a_step":
        assert o_e - o_s < 128
    rng = np.random.default_rng(7)
    hist_k = hist_r = (torch.zeros(plan.d_rows, 2 * c, device=cuda) if zero
                       else torch.randn(plan.d_rows, 2 * c, device=cuda) * 0.3)
    for _ in range(2):
        raw = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)
                               ).to(cuda)
        p0 = torch.from_numpy(rng.uniform(0, 10, (n // ell, c))
                              .astype(np.float32)).to(cuda)
        wf = torch.full((n // ell, c), 2 * np.pi * 19000 / 256000,
                        device=cuda)
        before = (wfm_tail.wfm_tail.launches,
                  wfm_tail.wfm_tail.element_launches)
        got = wfm_tail.wfm_tail(plan, raw, p0, wf, hist_k)
        assert (wfm_tail.wfm_tail.launches,
                wfm_tail.wfm_tail.element_launches) == (
            before[0] + 1, before[1] + (c % 4 != 0))
        ref = wfm_tail.wfm_tail_reference(plan, raw, p0, wf, hist_r)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            assert rel_err(b, a) < RTOL
        hist_k, hist_r = got[1], ref[1]


def test_wfm_tail_refuses_an_unaligned_composite(cuda):
    """Tensor-map staging needs a composite that starts on 16 bytes."""
    plan = wfm_tail.TailPlan.make(_tail_taps(235), 4, 256, 2048, cuda)
    c, n = 4, 2048
    raw = torch.zeros(n * c + 1, device=cuda)[1:].view(n, c)
    args = (torch.zeros(n // 256, c, device=cuda),
            torch.zeros(n // 256, c, device=cuda),
            torch.zeros(plan.d_rows, 2 * c, device=cuda))
    with pytest.raises(ValueError, match="16-byte"):
        wfm_tail.wfm_tail(plan, raw, *args)


def test_wfm_tail_is_one_cuda_launch_per_call(cuda):
    """The profiler records one CUDA kernel per wfm_tail call, the march
    (hist' is written by the same launch), and the wrapper counts one
    launch per call."""
    plan = wfm_tail.TailPlan.make(_tail_taps(235), 4, 256, 2048, cuda)
    c, n = 64, 16384
    args = (torch.randn(n, c, device=cuda),
            torch.rand(n // 256, c, device=cuda) * 10,
            torch.full((n // 256, c), 0.466, device=cuda),
            torch.zeros(plan.d_rows, 2 * c, device=cuda))
    wfm_tail.wfm_tail(plan, *args)
    torch.cuda.synchronize()
    before = wfm_tail.wfm_tail.launches

    def tail_names(names):
        return [nm for nm in names if "wfm_tail" in nm]

    names = tail_names(_cuda_names(lambda: wfm_tail.wfm_tail(plan, *args), 3,
                                   lambda nms: len(tail_names(nms)) == 3))
    assert len(names) == 3 and all("wfm_tail_march" in nm for nm in names)
    # the wrapper counted one launch per call of every trace
    assert (wfm_tail.wfm_tail.launches - before) % 3 == 0
    assert wfm_tail.wfm_tail.launches > before


def _stereo_plane(c, rows, rng):
    """Broadcast FM stereo at 250 kHz (L-only 700 Hz program with its
    pilot, bench.py:318-341) on every channel, plus noise."""
    t = np.arange(rows) / FS + rng.uniform(0.0, 1.0)
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = np.repeat((0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph)))
                   [:, None], c, axis=1)
    iq = iq + 1e-2 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape))
    return torch.from_numpy(np.concatenate([iq.real, iq.imag], 1)
                            .astype(np.float32))


def test_wfm_receiver_on_card_matches_cpu(cuda):
    """FMS: the bounds of tests/test_chain_batched.py:58-69 after a CPU
    warm-up block carried to both; K1 and K2 launch once per dispatch."""
    n, c = 8192, 4
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         mode=DemodMode.FMS)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(9)
    sc, _ = cpu.step_many(cpu.init_state(), pc, _stereo_plane(c, n, rng))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    before = (front.fused_front.launches, wfm_tail.wfm_tail.launches)
    for k in (3, 9):
        x = _stereo_plane(c, k * n, rng)
        sc, oc = cpu.step_many(sc, pc, x)
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        assert torch.equal(og["squelch_open"].cpu(), oc["squelch_open"])
        assert torch.equal(og["pilot_locked"].cpu(), oc["pilot_locked"])
        for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
            if a.size:
                assert np.abs(a.astype(np.complex128)
                              - b.astype(np.complex128)).max() < 1e-4
    assert (front.fused_front.launches, wfm_tail.wfm_tail.launches) == (
        before[0] + 2, before[1] + 2)


NB1, NB2 = (3.3, 7, 0.001, "blank"), (3.3, 7, 0.001, "average")
OPTION_FORMS = {
    "iq": dict(iq=True),
    "i16": dict(i16=True),
    "nb1_iq": dict(iq=True, nb=NB1),
    "nb2_iq": dict(iq=True, nb=NB2),
    "i16_nb1_iq": dict(i16=True, iq=True, nb=NB1),
}


def _impulsive_plane(c, rows, rng, fm=False):
    """AM (or FM) at 250 kHz with a DC offset and low noise, plus 8+8j
    impulses (20x and more above the floor) at chunk, sub-block and block
    seams.  A Gaussian floor would put some of millions of samples within
    0.1 % of the threshold; a carrier with low noise keeps them far."""
    x = ((_fm_plane if fm else _am_plane)(c, rows, rng).numpy() + 0.04)
    for pos in (100, 511, 2046, 2049, 8189, 8195, rows - 3):
        x[pos % rows, :] += 8.0
    return torch.from_numpy(x)


def _assert_margin(plan, x, dc, iq, nb, nb_avg, nb_tail):
    """No sample within 0.1 % of the spike threshold (plain intermediates)."""
    _, z = front.dc_iq_reference(plan, front.dequantize(x), dc, *iq)
    fl = front.nb_flags(z, nb, nb_avg, nb_tail)
    ratio = fl.mag2 / (np.float32(nb[0] ** 2) * fl.avg.clamp(min=1e-18))
    assert not bool(((ratio >= 0.999) & (ratio <= 1.001)).any())


def _option_run(cuda, c, opt, protect=30_000, k=3, wfm=False):
    """K1 with the given options against plain, two streaming calls; every
    output within RTOL (the discriminator 1e-4 absolute), nb_tail' and the
    dilated flags of every row equal."""
    n = 8192
    plan = _plan(cuda, protect)
    hi, lo = _tunes(c, cuda)
    if wfm:
        hi, lo = (torch.full((c,), float(v), device=cuda)
                  for v in split_freq(250_000.0, FS))
    rng = np.random.default_rng(11)
    nb = opt.get("nb")
    iq = ((torch.tensor(1.05, device=cuda), torch.tensor(0.02, device=cuda))
          if opt.get("iq") else (None, None))
    z = dict(device=cuda)
    st_k = st_r = (torch.zeros(1, 2 * c, **z), torch.zeros(c, **z),
                   torch.zeros(plan.d_rows, 2 * c, **z),
                   torch.zeros(1, 2 * c, **z), torch.zeros(16, 2 * c, **z),
                   torch.zeros(1, 2 * c, **z))
    for _ in range(2):
        x = _impulsive_plane(c, k * n, rng, fm=wfm)
        if opt.get("i16"):
            x = torch.clamp(torch.round(x * 3276.8), -32768, 32767
                            ).to(torch.int16)
        x = x.to(cuda)
        kw = dict(n_block=n, raw_rows=2048, iq_gain=iq[0], iq_phase=iq[1])
        if wfm:
            kw.update(disc_gain=256_000 / (2 * np.pi * 75_000),
                      y_tail_rows=512)
        masks = []
        outs = []
        for st, fn in ((st_k, front.fused_front),
                       (st_r, front.fused_front_reference)):
            kws = dict(kw, disc_last=st[5] if wfm else None)
            if nb:
                if fn is front.fused_front_reference:
                    _assert_margin(plan, x, st[0], iq, nb, st[3], st[4])
                masks.append(torch.zeros(k * n, 2 * c, dtype=torch.uint8,
                                         device=cuda))
                kws.update(nb=nb, nb_avg=st[3], nb_tail=st[4],
                           nb_mask=masks[-1])
            before = front.fused_front.launches
            outs.append(fn(plan, x, st[0], st[1], hi, lo, st[2], **kws))
            assert front.fused_front.launches == before + (
                fn is front.fused_front)
        torch.cuda.synchronize()
        got, ref = outs
        assert len(got) == len(ref)
        disc_i = len(got) - 2 if wfm else -1
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a.shape == b.shape, i
            if i == disc_i:
                assert float((a - b).abs().max()) < 1e-4
            else:
                assert rel_err(b, a) < RTOL, i
        if nb:
            assert torch.equal(got[6], ref[6])          # nb_tail'
            assert int((masks[0] != masks[1]).sum()) == 0
            assert int(masks[1].sum()) > 0
        nxt = []
        for o, st in ((got, st_k), (ref, st_r)):
            nxt.append((o[1], o[3], o[2], o[5] if nb else st[3],
                        o[6] if nb else st[4], o[-1] if wfm else st[5]))
        st_k, st_r = nxt


@pytest.mark.parametrize("c", [12, 64])
@pytest.mark.parametrize("form", list(OPTION_FORMS))
def test_front_option_kernels_match_plain(cuda, form, c):
    """C=12 leaves a partial 8-channel FIR block."""
    _option_run(cuda, c, OPTION_FORMS[form])


@pytest.mark.parametrize("c", [4, 12])
def test_front_wfm_nb_kernel_matches_plain(cuda, c):
    """NB1 with the discriminator and y-tail switches (factor-8 WFM plan)."""
    _option_run(cuda, c, dict(nb=NB1), protect=200_000, k=2, wfm=True)


def test_front_nb_kernel_rejects_bad_carry(cuda):
    plan = _plan(cuda)
    c, n = 2, 2048
    z = dict(device=cuda)
    args = (torch.zeros(n, 2 * c, **z), torch.zeros(1, 2 * c, **z),
            torch.zeros(c, **z), torch.zeros(c, **z), torch.zeros(c, **z),
            torch.zeros(plan.d_rows, 2 * c, **z))
    with pytest.raises(ValueError):
        front.fused_front(plan, *args, n_block=n, nb=NB1,
                          nb_avg=torch.zeros(1, 2 * c, **z),
                          nb_tail=torch.zeros(8, 2 * c, **z))
    with pytest.raises(ValueError):
        front.fused_front(plan, *args, n_block=n,
                          iq_gain=torch.tensor(1.0),            # on the CPU
                          iq_phase=torch.tensor(0.0, **z))


@pytest.mark.parametrize("entry", ["nb1_iq", "i16", "folded"])
def test_receiver_options_on_card_match_cpu(cuda, entry):
    """AM with NB1 + IQ balance, an int16 plane, a plane folded by 3
    (C=2): the bounds of tests/test_chain_batched.py:58-69 after a CPU
    warm-up block carried to both; K1 launches once per dispatch."""
    n = 8192
    c = 2 if entry == "folded" else 4
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         agc_stride=16,
                         enable_noise_blanker=entry == "nb1_iq",
                         enable_iq_balance=entry == "nb1_iq")
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(12)

    def plane(k):
        x = _am_plane(c, k * n, rng)
        if entry == "nb1_iq":
            x[::4099] += 4.0
        if entry == "i16":
            x = torch.round(x * 16384.0).to(torch.int16)
        if entry == "folded":
            x = torch.from_numpy(front.fold_plane_np(x.numpy(), 3))
        return x

    sc, _ = cpu.step_many(cpu.init_state(), pc, _am_plane(c, n, rng))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    before = front.fused_front.launches
    for k in (3, 9):
        x = plane(k)
        sc, oc = cpu.step_many(sc, pc, x)
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        assert torch.equal(og["squelch_open"].cpu(), oc["squelch_open"])
        for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
            assert np.abs(a.astype(np.complex128)
                          - b.astype(np.complex128)).max() < 1e-4
    assert front.fused_front.launches == before + 2


def _short_last_blocks(c, n, sms):
    """The first dispatch size (blocks of n rows) whose last front_comp
    segment is shorter than a step on a card of `sms` SMs."""
    for k in range(2, 64):
        plan = front.comp_march_plan(k * n // 4, c, sms)
        j_s, j_e = plan["segments"][-1]
        if len(plan["segments"]) > 1 and j_e - j_s < plan["step_outputs"]:
            return k
    raise AssertionError(f"no dispatch of C={c} has a short last segment")


@pytest.mark.parametrize("c,k", [(64, 4), (256, 2), (5, 2), (64, 1),
                                 (16, -1)])
def test_front_comp_kernel_matches_plain(cuda, c, k):
    """K1e: the hq form (factor-4 plan, discriminator, y-tails, comp_taps)
    over two streaming calls from a random comp_hist; C=5 leaves a partial
    channel tile (and stages element by element); K=1 puts the whole
    dispatch in one block of y-tails; k = -1 takes the dispatch whose last
    front_comp segment is shorter than a step on this card.  The planes
    carry a DC offset, so dc' is held to its relative bound on a value away
    from zero (an FM plane alone leaves dc' near 0, where the relative error
    is cancellation).  front_comp is the only pass over y: the profiler
    records no front_disc, and 4 CUDA launches per call."""
    n, zt = 8192, 2048
    gain = 512_000 / (2 * np.pi * 75_000)
    plan = _plan(cuda, 400_000)
    taps = wfm.WFMConfig.make(256_000.0, comp_decim=2).comp_taps
    hr = front.comp_hist_rows(len(taps))
    if k < 0:
        k = _short_last_blocks(
            c, n, torch.cuda.get_device_properties(cuda).multi_processor_count)
    hi, lo = (torch.full((c,), float(v), device=cuda)
              for v in split_freq(250_000.0, FS))
    rng = np.random.default_rng(13)
    zeros = dict(device=cuda)
    st_k = st_r = (torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
                   torch.zeros(plan.d_rows, 2 * c, **zeros),
                   torch.zeros(1, 2 * c, **zeros),
                   torch.randn(hr, c, **zeros) * 0.1)
    for call in range(2):
        x = (_fm_plane(c, k * n, rng) + 0.05 * (call + 1)).to(cuda)
        kw = dict(n_block=n, raw_rows=2048, disc_gain=gain, y_tail_rows=zt,
                  comp_taps=taps)
        before = front.fused_front.launches
        got = front.fused_front(plan, x, st_k[0], st_k[1], hi, lo, st_k[2],
                                disc_last=st_k[3], comp_hist=st_k[4], **kw)
        assert front.fused_front.launches == before + 1
        ref = front.fused_front_reference(plan, x, st_r[0], st_r[1], hi, lo,
                                          st_r[2], disc_last=st_r[3],
                                          comp_hist=st_r[4], **kw)
        torch.cuda.synchronize()
        assert len(got) == len(ref) == 8
        assert got[5].shape == (k * n // 8, c) and got[7].shape == (hr, c)
        for i in (0, 1, 2, 3, 4, 6, 7):
            assert got[i].shape == ref[i].shape
            assert rel_err(ref[i], got[i]) < RTOL, i
        assert float((got[5] - ref[5]).abs().max()) < 1e-4
        st_k = (got[1], got[3], got[2], got[6], got[7])
        st_r = (ref[1], ref[3], ref[2], ref[6], ref[7])
    calls = 3

    def front_names(names):
        return [nm for nm in names if "front_" in nm]

    names = front_names(_cuda_names(
        lambda: front.fused_front(plan, x, st_k[0], st_k[1], hi, lo, st_k[2],
                                  disc_last=st_k[3], comp_hist=st_k[4],
                                  **kw), calls,
        lambda nms: len(set(front_names(nms))) == 4))
    # four kernels (front_fir writes the carried history), each at most
    # once a call (the profiler may lose a record, never add one)
    assert len(set(names)) == 4 and any("front_comp" in nm for nm in names)
    assert all(names.count(nm) <= calls for nm in set(names))
    assert not any("front_disc" in nm for nm in names)


# K1's CUDA kernels per call by form; front_fir's march writes the carried
# history (tail', nb_tail'), so no front_tail launch
K1_FORM_KERNELS = {
    "base": {"front_means": 1, "front_dc_scan": 1, "front_fir": 1},
    "nb": {"front_means": 1, "front_nb_means": 1, "front_dc_scan": 2,
           "front_fir": 1},
    "wfm": {"front_means": 1, "front_dc_scan": 1, "front_fir": 1,
            "front_disc": 1},
    "hq": {"front_means": 1, "front_dc_scan": 1, "front_fir": 1,
           "front_comp": 1},
}


def _k1_form_args(cuda, form, c, k, rng, n=8192):
    """A K1 call of the given form ("base", "nb", "wfm", "hq") on an
    impulsive AM plane of k blocks: (plan, args, kwargs)."""
    protect = {"wfm": 200_000, "hq": 400_000}.get(form, 30_000)
    plan = _plan(cuda, protect)
    hi, lo = _tunes(c, cuda)
    z = dict(device=cuda)
    x = _impulsive_plane(c, k * n, rng).to(cuda)
    tail = torch.from_numpy(rng.standard_normal((plan.d_rows, 2 * c))
                            .astype(np.float32) * 0.1).to(cuda)
    args = (x, torch.full((1, 2 * c), 0.02, **z), torch.full((c,), 0.3, **z),
            hi, lo, tail)
    kw = dict(n_block=n, raw_rows=512)
    if form == "nb":
        kw.update(nb=(3.3, 7, 0.001, "blank"),
                  nb_avg=torch.full((1, 2 * c), 0.1, **z),
                  nb_tail=torch.zeros(16, 2 * c, **z))
    if form in ("wfm", "hq"):
        rate = FS / plan.factor
        kw.update(disc_gain=rate / (2 * np.pi * 75_000),
                  disc_last=torch.zeros(1, 2 * c, **z), y_tail_rows=256)
    if form == "hq":
        taps = wfm.WFMConfig.make(rate / 2, comp_decim=2).comp_taps
        kw.update(comp_taps=taps, comp_hist=torch.zeros(
            front.comp_hist_rows(len(taps)), c, **z))
    return plan, args, kw


@pytest.mark.parametrize("form", list(K1_FORM_KERNELS))
def test_k1_cuda_launches_per_form(cuda, form):
    """The profiler records 3 / 5 / 4 / 4 CUDA kernels per K1 call (base,
    NB1, WFM, hq), each kernel as often as its form launches it, and no
    front_tail: front_fir's march writes tail' and nb_tail'."""
    plan, args, kw = _k1_form_args(cuda, form, 16, 2,
                                   np.random.default_rng(41))
    front.fused_front(plan, *args, **kw)
    torch.cuda.synchronize()
    calls = 5
    want = K1_FORM_KERNELS[form]

    def counted(names):
        got = {}
        for nm in names:
            if "front_" in nm:
                key = next(k for k in ("front_means", "front_nb_means",
                                       "front_dc_scan", "front_fir",
                                       "front_tail", "front_disc",
                                       "front_comp") if k in nm)
                got[key] = got.get(key, 0) + 1
        return got

    before = front.fused_front.launches
    got = counted(_cuda_names(lambda: front.fused_front(plan, *args, **kw),
                              calls, lambda nms: set(counted(nms))
                              == set(want)))
    # the wrapper counted one K1 launch per call of every trace
    assert (front.fused_front.launches - before) % calls == 0
    assert front.fused_front.launches > before
    # each kernel of the form and no other, each at most as often as the
    # form launches it (the profiler may lose a record, never add one)
    assert set(got) == set(want)
    assert all(0 < got[k] <= want[k] * calls for k in want)
    assert sum(want.values()) == {"base": 3, "nb": 5, "wfm": 4, "hq": 4}[form]


def _last_step_full(c, t, plan, sms, nb):
    """Whether front_fir's last step of a [t, 2c] dispatch is full, so
    that no step reaches the rows after its last output."""
    mp = front.fir_march_plan(t, c, plan.factor, plan.h.numel(), sms,
                              7 if nb else 0, 4)
    o_s, o_e = mp["segments"][-1]
    return (o_e - o_s) % mp["layout"]["km"] == 0


@pytest.mark.parametrize("form", ["base", "nb", "wfm", "hq"])
def test_k1_history_at_the_seam_and_k1(cuda, form):
    """K1's carried history from front_fir, over two streaming calls of
    16 channels: at K = 1, at a K whose last march step is full (no step
    reaches the rows after the last output) and at one whose last step is
    not: tail' within RTOL of the plain version, nb_tail' and the dilated
    flags of every row (the blanker's impulses include one 3 rows before
    the end) bit-equal to the plain version's."""
    n, c = 8192, 16
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nb = form == "nb"
    plan = _k1_form_args(cuda, form, c, 1, np.random.default_rng(0))[0]
    kinds = {k: _last_step_full(c, k * n, plan, sms, nb)
             for k in range(2, 13)}
    ks = [1, next(k for k, v in kinds.items() if v),
          next(k for k, v in kinds.items() if not v)]
    for k in ks:
        plan, args, kw = _k1_form_args(cuda, form, c, k,
                                       np.random.default_rng(k))
        st_k = st_r = (args[1], args[5], kw.get("nb_avg"), kw.get("nb_tail"))
        for call in range(2):
            x = args[0] if call == 0 else args[0].flip(0).contiguous()
            outs, masks = [], []
            for st, fn in ((st_k, front.fused_front),
                           (st_r, front.fused_front_reference)):
                kws = dict(kw)
                if nb:
                    masks.append(torch.zeros(k * n, 2 * c, dtype=torch.uint8,
                                             device=cuda))
                    kws.update(nb_avg=st[2], nb_tail=st[3], nb_mask=masks[-1])
                outs.append(fn(plan, x, st[0], *args[2:5], st[1], **kws))
            torch.cuda.synchronize()
            got, ref = outs
            assert rel_err(ref[2], got[2]) < RTOL, (k, call)
            if nb:
                assert torch.equal(got[6], ref[6]), (k, call)
                assert int((masks[0] != masks[1]).sum()) == 0, (k, call)
                if call == 0:       # the impulse 3 rows before the end
                    assert float(ref[6].sum()) > 0
            st_k, st_r = [(o[1], o[2], o[5] if nb else None,
                           o[6] if nb else None) for o in (got, ref)]


@pytest.mark.parametrize("c", [5, 16, 64, 256])
def test_dc_scan_kernel_equals_its_emulation(cuda, c):
    """front_dc_scan alone (front.dc_scan) on chunk means of K1's shapes
    (C = 16: am_16ch's 4096 chunks; 64: am_64ch's 2048; 256: am_256ch's
    1024; 5: a partial lane tile) equals ops/front.py dc_scan_emulate bit
    for bit, m and dc', for the DC blocker's and the blanker's a; and the
    plain version within 3e-5 of max |m|."""
    nchunk = {5: 48, 16: 4096, 64: 2048, 256: 1024}[c]
    rng = np.random.default_rng(c)
    for alpha in (0.9999, 0.999):
        a = alpha ** front.DC_CHUNK
        mu = (rng.standard_normal((nchunk, 2 * c)) * 0.02 + 0.1).astype(
            np.float32)
        dc = (rng.standard_normal((1, 2 * c)) * 0.05).astype(np.float32)
        before = front.dc_scan.launches
        m, d = front.dc_scan(torch.from_numpy(mu).to(cuda),
                             torch.from_numpy(dc).to(cuda), a)
        assert front.dc_scan.launches == before + 1
        em, ed = front.dc_scan_emulate(mu, dc, *front.chunk_ewma(a))
        assert np.array_equal(m.cpu().numpy().view(np.uint32),
                              em.view(np.uint32))
        assert np.array_equal(d.cpu().numpy().view(np.uint32),
                              ed.view(np.uint32))
        ref, _ = front.dc_scan_reference(torch.from_numpy(mu),
                                         torch.from_numpy(dc), a)
        assert float((m.cpu() - ref).abs().max()) <= RTOL * float(
            ref.abs().max())


def _rds_plane(c, rows, rng, t0=0.0):
    """Broadcast FM stereo at 250 kHz with RDS: 1 kHz mono, pilot and the
    PS groups of "PEBBLES " as 57 kHz biphase, channel i at phase i, noise."""
    bits = []
    for _ in range(24):
        for seg in range(4):
            d = (ord("PEBBLES "[2 * seg]) << 8) | ord("PEBBLES "[2 * seg + 1])
            bits += rds.encode_group(0x54A8, (5 << 5) | seg, 0xE0E0, d)
    sym = np.cumsum(bits) % 2 * 2.0 - 1.0             # differential encoding
    t = t0 + np.arange(rows) / FS
    idx = np.minimum((t * rds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    bi = sym[idx] * np.where(t * rds.RDS_BAUD - idx < 0.5, 1.0, -1.0)
    comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.06 * bi * np.cos(2 * np.pi * 57000.0 * t))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = np.stack([0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph + i))
                   for i in range(c)], axis=1)
    iq = iq + 1e-2 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape))
    return torch.from_numpy(np.concatenate([iq.real, iq.imag], 1)
                            .astype(np.float32))


@pytest.mark.parametrize("opts", [dict(wfm_hq=True), dict(rds=True),
                                  dict(rds=True, wfm_hq=True)],
                         ids=["hq", "rds", "hq_rds"])
def test_hq_and_rds_receivers_on_card_match_cpu(cuda, opts):
    """hq (C=4, 8192-frame blocks, K=3 then 9) and RDS (C=4, 32768-frame
    blocks, K=3 twice) after a CPU warm-up dispatch carried to both: the
    bounds of tests/test_chain_batched.py:58-69, rds_soft within 1e-3 of its
    scale, rds_timing equal; K1 and K2 launch once per dispatch."""
    c = 4
    n = 32768 if opts.get("rds") else 8192
    ks = (3, 3) if opts.get("rds") else (3, 9)
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         mode=DemodMode.FMS, **opts)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(14)
    sc, _ = cpu.step_many(cpu.init_state(), pc, _rds_plane(c, n, rng))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    before = (front.fused_front.launches, wfm_tail.wfm_tail.launches)
    t0 = n / FS
    for k in ks:
        x = _rds_plane(c, k * n, rng, t0)
        t0 += k * n / FS
        sc, oc = cpu.step_many(sc, pc, x)
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert torch.equal(og["pilot_locked"].cpu(), oc["pilot_locked"])
        if opts.get("rds"):
            scale = float(oc["rds_soft"].abs().max())
            assert float((og["rds_soft"].cpu() - oc["rds_soft"]).abs().max()
                         ) <= 1e-3 * scale
            assert torch.equal(og["rds_timing"].cpu(), oc["rds_timing"])
        for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
            if a.size:
                assert np.abs(a.astype(np.complex128)
                              - b.astype(np.complex128)).max() < 1e-4
    assert (front.fused_front.launches, wfm_tail.wfm_tail.launches) == (
        before[0] + 2, before[1] + 2)


def _nfm_plane(c, rows, rng, t0=0.0):
    """Narrowband FM at 250 kHz: a 1 kHz voice tone at 3 kHz deviation plus
    a CTCSS sub-tone at 500 Hz, 123.0 Hz on the first half of the channels
    and the 127.3 Hz neighbour on the rest, noise at 1e-2."""
    t = t0 + np.arange(rows) / FS
    x = []
    for i in range(c):
        tone = 123.0 if i < c // 2 else 127.3
        dev = (3000.0 * np.sin(2 * np.pi * 1000.0 * t)
               + 500.0 * np.sin(2 * np.pi * tone * t))
        x.append(0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t
                                    + 2 * np.pi * np.cumsum(dev) / FS + i)))
    iq = np.stack(x, axis=1)
    iq = iq + 1e-2 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape))
    return torch.from_numpy(np.concatenate([iq.real, iq.imag], 1)
                            .astype(np.float32))


NEW_RECEIVERS = {
    "fmn_ctcss": (DemodMode.FMN, dict(ctcss_tone=123.0)),
    "fmn_ctcss_i16": (DemodMode.FMN, dict(ctcss_tone=123.0)),
    "fmm": (DemodMode.FMM, {}),
    "fmm_hq": (DemodMode.FMM, dict(wfm_hq=True)),
    "fms_mono_rds": (DemodMode.FMS, dict(stereo=False, rds=True)),
    "am_anf_long": (DemodMode.AM, dict(enable_anf=True, agc_mode="long")),
    "usb_long": (DemodMode.USB, dict(agc_mode="long")),
}


@pytest.mark.parametrize("case", list(NEW_RECEIVERS))
def test_new_receivers_on_card_match_cpu(cuda, case):
    """FMN with the CTCSS tone squelch (float32 and int16 entry), FMM
    (default and hq), FMS stereo=False with RDS, AM with the ANF and AGC
    "long", USB with AGC "long" on the card against the CPU: C=4, 8192-frame
    blocks, K=3 then 9 (RDS 32768-frame blocks, K=3 twice), after a CPU
    warm-up carried to both (with CTCSS 5 x 33 blocks, so the EWMA has
    settled and its decision is far from the threshold: squelch_open and
    ctcss_open equal, the tone's channels open, the neighbour's closed);
    the bounds of tests/test_chain_batched.py:58-69; K1 once per dispatch,
    K2 never."""
    mode, opts = NEW_RECEIVERS[case]
    c = 4
    n = 32768 if opts.get("rds") else 8192
    ks = (3, 3) if opts.get("rds") else (3, 9)
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         agc_stride=16, mode=mode, **opts)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(15)
    t0 = [0.0]

    def plane(rows):
        if mode == DemodMode.FMN:
            x = _nfm_plane(c, rows, rng, t0[0])
        elif opts.get("rds"):
            x = _rds_plane(c, rows, rng, t0[0])
        elif mode == DemodMode.FMM:
            x = _stereo_plane(c, rows, rng)
        else:
            x = _am_plane(c, rows, rng)
        t0[0] += rows / FS
        if case.endswith("i16"):
            x = torch.round(x * 16384.0).clamp(-32768, 32767).to(torch.int16)
        return x

    sc = cpu.init_state()
    for k in ((33,) * 5 if cpu.ctcss_cfg else (1,)):
        sc, _ = cpu.step_many(sc, pc, plane(k * n))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    before = (front.fused_front.launches, wfm_tail.wfm_tail.launches)
    for k in ks:
        x = plane(k * n)
        sc, oc = cpu.step_many(sc, pc, x)
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        for key in ("squelch_open", "ctcss_open", "pilot_locked",
                    "rds_timing"):
            if key in oc:
                assert torch.equal(og[key].cpu(), oc[key]), key
        if cpu.ctcss_cfg:
            assert oc["ctcss_open"][:, :2].all()
            assert not oc["ctcss_open"][:, 2:].any()
        if opts.get("rds"):
            scale = float(oc["rds_soft"].abs().max())
            assert float((og["rds_soft"].cpu() - oc["rds_soft"]).abs().max()
                         ) <= 1e-3 * scale
        for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
            if a.size:
                assert np.abs(a.astype(np.complex128)
                              - b.astype(np.complex128)).max() < 1e-4
    if opts.get("enable_anf"):
        assert float(sg.anf.weights.abs().max()) > 1e-3
    assert (front.fused_front.launches, wfm_tail.wfm_tail.launches) == (
        before[0] + len(ks), before[1])


# ---- the K1 probes (ops/kprobe.py): tools/kbench2.py's kernels ----------

def _probe_case(device, variant, c, t, rng):
    """An input plane with a DC offset (dc' stays away from 0) and a random
    carried state, in the variant's layouts."""
    d = _plan("cpu").d_rows
    x = torch.from_numpy((rng.standard_normal((t, 2 * c)) * 0.5 + 0.2)
                         .astype(np.float32))
    dc = torch.from_numpy(0.05 * rng.standard_normal((1, 2 * c))).float()
    tail = torch.from_numpy(0.3 * rng.standard_normal((d, 2 * c))).float()
    ph = torch.from_numpy(rng.uniform(0.0, 1.0, c)).float()
    return [v.contiguous().to(device)
            for v in kprobe.to_layout(variant, x, dc, tail, ph)]


@pytest.mark.parametrize("c,t", [(4, 8192), (64, 8 * 32768)])
@pytest.mark.parametrize("sub", [2048, 4096])
@pytest.mark.parametrize("variant,kt", kprobe.FORMS)
def test_probe_front_kernel_matches_plain(cuda, variant, kt, sub, c, t):
    """Two streaming calls: y, dc' and tail' within 3e-5 relative of the
    plain version, phase' equal."""
    plan = _plan(cuda)
    rng = np.random.default_rng(30)
    hi, lo = (v.cpu().numpy().astype(np.float64) for v in _tunes(c, "cpu"))
    x, dc, tail, ph = _probe_case(cuda, variant, c, t, rng)
    st_k = st_r = (dc, tail, ph)
    for call in range(2):
        if call:
            x = x.flip(-2).contiguous()
        before = kprobe.probe_front.launches
        got = kprobe.probe_front(variant, plan, x, st_k[0], st_k[2], hi, lo,
                                 st_k[1], sub, kt)
        assert kprobe.probe_front.launches == before + 1
        ref = kprobe.probe_front_reference(variant, plan, x, st_r[0],
                                           st_r[2], hi, lo, st_r[1], sub, kt)
        torch.cuda.synchronize()
        for a, b in zip(got[:3], ref[:3]):
            assert a.shape == b.shape
            assert rel_err(b, a) < RTOL
        assert torch.equal(got[3], ref[3])
        st_k, st_r = got[1:], ref[1:]


@pytest.mark.parametrize("c,t", [(4, 8192), (64, 8 * 32768)])
@pytest.mark.parametrize("sub", [2048, 4096, 8192])
@pytest.mark.parametrize("planes", [1, 2])
def test_probe_floor_kernel_matches_plain(cuda, planes, sub, c, t):
    """Exact: the copy moves values."""
    g = torch.Generator(device=cuda).manual_seed(sub)
    lanes = 2 * c // planes
    xs = [torch.randn(t, lanes, generator=g, device=cuda)
          for _ in range(planes)]
    before = kprobe.probe_floor.launches
    got = kprobe.probe_floor(xs, sub, 32)
    assert kprobe.probe_floor.launches == before + 1
    ref = kprobe.probe_floor_reference(xs, sub, 32)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant,kt", kprobe.FORMS)
def test_probe_is_one_toeplitz_launch_per_call(cuda, variant, kt):
    """A front probe call is front_means and front_dc_scan per plane and
    one probe_toeplitz, which writes tail' too (no probe_tail): torch.
    profiler over 5 calls, each kernel at most as often as that and
    probe_toeplitz recorded (the profiler may lose a record, never add
    one: a small kernel's records were once all lost); tail' within RTOL
    of the plain version's."""
    c, t = 16, 4 * 8192
    plan = _plan(cuda)
    rng = np.random.default_rng(32)
    hi, lo = (v.cpu().numpy().astype(np.float64) for v in _tunes(c, "cpu"))
    x, dc, tail, ph = _probe_case(cuda, variant, c, t, rng)
    got = kprobe.probe_front(variant, plan, x, dc, ph, hi, lo, tail, 2048, kt)
    ref = kprobe.probe_front_reference(variant, plan, x, dc, ph, hi, lo,
                                       tail, 2048, kt)
    torch.cuda.synchronize()
    assert rel_err(ref[2], got[2]) < RTOL
    calls = 5
    planes = 2 if variant in kprobe.TWO_PLANE else 1
    want = {"front_means": planes, "front_dc_scan": planes,
            "probe_toeplitz": 1}
    names = _cuda_names(
        lambda: kprobe.probe_front(variant, plan, x, dc, ph, hi, lo, tail,
                                   2048, kt), calls,
        lambda nms: all(any(k in nm for nm in nms) for k in want))
    assert not any("probe_tail" in nm for nm in names)
    for k, v in want.items():
        assert sum(k in nm for nm in names) <= v * calls, k
    assert any("probe_toeplitz" in nm for nm in names)


def test_probe_sass_holds_tensor_core_instructions(cuda):
    """The built library's probe_toeplitz instantiations run their product
    on the tensor cores: wgmma (HGMMA) for the dense forms v1-v4, mma.sync
    (HMMA) for v5's span tiles (cuobjdump -sass of build/kernels)."""
    import os
    import re
    import subprocess

    from pebblesdr_tpu_torch.kernels import build
    so = build.build("front")
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for f in re.split(r"\n\s+Function : ", sass)[1:]:
        name = f.split("\n", 1)[0]
        m = re.search(r"probe_toeplitzILi(\d)ELb(\d)E", name)
        if m:
            funcs[(int(m.group(1)), int(m.group(2)))] = f
    assert set(funcs) == {(1, 0), (2, 0), (3, 0), (4, 0), (4, 1)}
    for (form, tiled), body in funcs.items():
        assert ("HMMA" if tiled else "HGMMA") in body, (form, tiled)


def test_probe_front_variants_match_k1(cuda):
    """Every variant computes K1's base form: y within 3e-5 of fused_front
    on the same input and state, at the bench's default shape."""
    c, t = 64, 8 * 32768
    plan = _plan(cuda)
    rng = np.random.default_rng(31)
    hi_t, lo_t = _tunes(c, cuda)
    hi, lo = hi_t.cpu().double().numpy(), lo_t.cpu().double().numpy()
    x, dc, tail, ph = _probe_case(cuda, "v3", c, t, rng)
    k1 = front.fused_front(plan, x, dc, ph, hi_t, lo_t, tail)
    for variant, kt in kprobe.FORMS:
        for sub in (2048, 4096):
            args = kprobe.to_layout(variant, x, dc, tail, ph)
            out = kprobe.probe_front(variant, plan, args[0], args[1], args[3],
                                     hi, lo, args[2], sub, kt)
            y = kprobe.from_layout(variant, *out)[0]
            assert rel_err(k1[0], y) < RTOL, (variant, kt, sub)


# ---- front_means (ops/front.py chunk_means) and the 16-byte plane rule ---

@pytest.mark.parametrize("dtype", ["f32", "i16"])
@pytest.mark.parametrize("c", [1, 5, 64, 256])
def test_chunk_means_kernel_matches_plain(cuda, c, dtype):
    """993 chunks (not a multiple of the persistent grid) in 3 blocks of 331
    chunks, raw tails of 1000 rows: int16 means and every raw tail equal
    the plain version exactly, float32 means within 1e-6 max |x|."""
    n, k = 331 * 512, 3
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(k * n, 2 * c, generator=g, device=cuda) * 0.5 + 0.2
    if dtype == "i16":
        x = (x * 8192.0).round().clamp(-32768, 32767).to(torch.int16)
    before = front.chunk_means.launches
    got = front.chunk_means(x, n, 1000)
    assert front.chunk_means.launches == before + 1
    ref = front.chunk_means_reference(x, n, 1000)
    torch.cuda.synchronize()
    assert got[0].shape == (k * n // 512, 2 * c)
    assert torch.equal(got[1], ref[1])
    if dtype == "i16":
        assert torch.equal(got[0], ref[0])
    else:
        tol = 1e-6 * float(x.abs().max())
        assert float((got[0] - ref[0]).abs().max()) <= tol


def test_chunk_means_kernel_takes_odd_lanes_and_no_raw(cuda):
    """The probes' per-plane call: 5 lanes, the whole plane one block."""
    x = torch.randn(8 * 512, 5, device=cuda)
    means, raw = front.chunk_means(x)
    assert raw.shape == (1, 0, 5)
    assert float((means - x.view(8, 512, 5).mean(1)).abs().max()) <= 1e-6 * \
        float(x.abs().max())


def _unaligned(rows, lanes, device, dtype=torch.float32):
    """A contiguous [rows, lanes] view that starts 1 element (2 or 4 bytes)
    past a 16-byte boundary."""
    base = torch.randn(rows * lanes + 1, device=device).to(dtype)
    x = base[1:].view(rows, lanes)
    assert x.is_contiguous() and x.data_ptr() % 16
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_unaligned_plane_raises(cuda, dtype):
    c, n = 4, 2048
    plan = _plan(cuda)
    hi, lo = _tunes(c, cuda)
    x = _unaligned(n, 2 * c, cuda, dtype)
    with pytest.raises(ValueError, match="aligned"):
        front.fused_front(plan, x, torch.zeros(1, 2 * c, device=cuda),
                          torch.zeros(c, device=cuda), hi, lo,
                          torch.zeros(plan.d_rows, 2 * c, device=cuda),
                          n_block=n)
    with pytest.raises(ValueError, match="aligned"):
        front.chunk_means(x, n, 8)
    if dtype == torch.float32:               # the probes take float32 only
        with pytest.raises(ValueError, match="aligned"):
            kprobe.probe_front("v3", plan, x,
                               torch.zeros(1, 2 * c, device=cuda),
                               torch.zeros(c, device=cuda), hi.cpu().numpy(),
                               lo.cpu().numpy(),
                               torch.zeros(plan.d_rows, 2 * c, device=cuda),
                               2048)
        with pytest.raises(ValueError, match="aligned"):
            kprobe.probe_floor((x,), 2048, 32)


def test_probe_floor_rejects_lanes_not_multiple_of_4(cuda):
    x = torch.zeros(4096, 6, device=cuda)
    with pytest.raises(ValueError, match="lanes % 4"):
        kprobe.probe_floor((x,), 2048, 32)
    with pytest.raises(ValueError, match="lanes % 4"):
        kprobe.probe_floor((x[:, :3].contiguous(), x[:, 3:].contiguous()),
                           2048, 32)


def test_receiver_takes_an_unaligned_view(cuda):
    """A caller's view 4 bytes past a 16-byte boundary: the card Receiver
    copies it once and matches the CPU Receiver on the same samples (the
    bounds of test_receiver_on_card_matches_cpu, after the same CPU warm-up
    block carried to both)."""
    n, c, k = 8192, 4, 3
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         agc_stride=16)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(40)
    sc, _ = cpu.step_many(cpu.init_state(), pc, _am_plane(c, n, rng))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    x = _am_plane(c, k * n, rng)
    big = torch.zeros(x.numel() + 1, device=cuda)
    big[1:] = x.reshape(-1).to(cuda)
    view = big[1:].view(k * n, 2 * c)
    assert view.is_contiguous() and view.data_ptr() % 16
    before = front.fused_front.launches
    sc, oc = cpu.step_many(sc, pc, x)
    sg, og = gpu.step_many(sg, pg, view)
    assert front.fused_front.launches == before + 1
    assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4
    for key in ("spectrum", "zoomed"):
        assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
    assert torch.equal(og["squelch_open"].cpu(), oc["squelch_open"])
    for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
        assert np.abs(a.astype(np.complex128)
                      - b.astype(np.complex128)).max() < 1e-4


# ---- the recurrences (csrc/recur.cu): pll_scan, pll_chunk_scan, agc_scan --

def _circ(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest angle between two phase tensors on the circle."""
    d = (a.double() - b.double()).cpu()
    return float(torch.angle(torch.exp(1j * d)).abs().max()) if d.numel() \
        else 0.0


def _carrier(det, c, n, fs, f0, rng, device):
    t = np.arange(n) / fs
    ph = 2 * np.pi * f0 * t + np.arange(c)[:, None]
    if det == "pilot":
        x = 0.1 * np.sin(ph) + 0.01 * rng.standard_normal((c, n))
    else:
        data = (np.sign(rng.standard_normal((c, n // 16 + 1)))
                .repeat(16, 1)[:, :n] if det == "costas" else 1.0)
        x = (0.5 * data * np.exp(1j * ph)
             + 0.02 * (rng.standard_normal((c, n))
                       + 1j * rng.standard_normal((c, n))))
    return torch.from_numpy(x.astype(np.complex64)).to(device)


@pytest.mark.parametrize("c,n", [(64, 4096), (5, 1000), (3, 0)])
@pytest.mark.parametrize("det", pll.DETECTORS)
def test_pll_scan_kernel_matches_plain(cuda, det, c, n):
    """One launch per call; phases on the circle within 1e-5, freqs and
    the state within 1e-6 (the kernel repeats the plain version's float32
    operations one by one: the two agree bit for bit on the H100), a
    partial block of channels and a partial tile (C=5, N=1000), N=0."""
    fs = 64000.0
    x = _carrier(det, c, n, fs, 340.0, np.random.default_rng(c), cuda)
    st = (torch.rand(c, device=cuda), torch.full((c,), 1e-4, device=cuda),
          torch.ones(c, device=cuda))
    args = (det, 0.0139, 9.6e-5, 2 * np.pi * 300.0 / fs, -0.098, 0.098)
    before = (pll.pll_scan.launches, pll.pll_scan.detector_launches[det])
    got = pll.pll_scan(x, *st, *args)
    assert (pll.pll_scan.launches, pll.pll_scan.detector_launches[det]) == \
        (before[0] + 1, before[1] + 1)
    ref = pll.pll_scan_plain(x, *st, *args)
    torch.cuda.synchronize()
    assert _circ(got[0], ref[0]) < 1e-5 and _circ(got[3], ref[3]) < 1e-5
    for i in (1, 2, 4):
        assert got[i].shape == ref[i].shape
        if got[i].numel():
            assert float((got[i] - ref[i]).abs().max()) < 1e-6


@pytest.mark.parametrize("pilot", [False, True])
def test_pll_chunk_scan_kernel_matches_plain(cuda, pilot):
    c, f = 64, 4096
    rng = np.random.default_rng(3)
    z = torch.from_numpy((0.5 * np.exp(1j * (0.01 * np.arange(f)
                                              + np.arange(c)[:, None]))
                          + 0.01 * rng.standard_normal((c, f)))
                         .astype(np.complex64)).to(cuda)
    st = (torch.rand(c, device=cuda), torch.zeros(c, device=cuda),
          torch.ones(c, device=cuda))
    args = (pilot, 0.11, 0.0077, -0.25, 0.25)
    before = pll.pll_chunk_scan.launches
    got = pll.pll_chunk_scan(z, *st, *args)
    assert pll.pll_chunk_scan.launches == before + 1
    ref = pll.pll_chunk_scan_plain(z, *st, *args)
    torch.cuda.synchronize()
    assert _circ(got[0], ref[0]) < 1e-5 and _circ(got[3], ref[3]) < 1e-5
    for i in (1, 2, 4):
        assert float((got[i] - ref[i]).abs().max()) < 1e-6


@pytest.mark.parametrize("mode", ["long", "med"])
@pytest.mark.parametrize("c,m", [(64, 2048), (5, 1000)])
def test_agc_scan_kernel_matches_plain(cuda, mode, c, m):
    """The smoother's levels and state equal the plain version's (its
    arithmetic is compares, selects and single float32 operations)."""
    rng = np.random.default_rng(m)
    # keyed every 300 samples, the last 300 off: the hang timer runs
    key = np.where(((m - 1 - np.arange(m)) // 300) % 2, 1.0, 0.01)
    env = torch.from_numpy(np.log10(np.abs(0.5 * key + 1e-3 * rng
                                           .standard_normal((c, m))) + 1e-8)
                           .astype(np.float32)).to(cuda)
    k = agc.scan_coefs(agc.AGCConfig.make(64000.0, mode, stride=16,
                                          algorithm="scan"))
    st = (torch.full((c,), -0.5, device=cuda),
          torch.full((c,), -0.5, device=cuda),
          torch.zeros(c, dtype=torch.int32, device=cuda))
    args = (k["rise"], k["fall"], k["drise"], k["dfall"], k["hang_samples"],
            k["hang"])
    before = agc.agc_scan.launches
    got = agc.agc_scan(env, *st, *args)
    assert agc.agc_scan.launches == before + 1
    ref = agc.agc_scan_plain(env, *st, *args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b.cpu())
    if mode == "long":
        assert int(got[2].max()) > 0        # the hang timer ran


def test_recurrences_refuse_what_they_do_not_take(cuda):
    st = (torch.zeros(4, device=cuda),) * 3
    x = torch.zeros(4, 64, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):            # a strided input
        pll.pll_scan(x.t().contiguous().t(), *st, "atan2", 0.1, 0.01, 0.0,
                     -1.0, 1.0)
    with pytest.raises(ValueError):            # a state on another device
        pll.pll_scan(x, st[0].cpu(), st[1], st[2], "atan2", 0.1, 0.01, 0.0,
                     -1.0, 1.0)
    with pytest.raises(ValueError):            # float64 phasors
        pll.pll_chunk_scan(x.to(torch.complex128), *st, False, 0.1, 0.01,
                           -1.0, 1.0)
    with pytest.raises(ValueError):            # a float hang counter
        agc.agc_scan(x.real.contiguous(), st[0], st[1], st[2], 0.1, 0.1,
                     0.1, 0.1, 10, True)


@pytest.mark.parametrize("form", pll.PROBE_FORMS)
def test_chain_probe_runs_every_form(cuda, form):
    out = pll.chain_probe(form, 4096, cuda)
    torch.cuda.synchronize()
    assert out.shape == (1,) and bool(torch.isfinite(out).all())


# ---- K3 and K3c on the loop kernel (csrc/recur.cu recur_loop_kernel) ----

LOOP_FORMS = list(pll.DETECTORS) + ["chunk", "chunk pilot"]


def _loop_case(form, c, n, device):
    """A K3 / K3c call at [c, n]: (wrapper, plain, args), the inputs seeded
    from (c, n): a carrier for each detector (_carrier), drifting chunk
    phasors for K3c; the state off zero (random phases, a small fdev)."""
    rng = np.random.default_rng(100 * c + n)
    st = (torch.from_numpy(rng.uniform(-3, 3, c).astype(np.float32)).to(
        device), torch.full((c,), 1e-4, device=device),
        torch.ones(c, device=device))
    if form.startswith("chunk"):
        k = np.arange(n)
        z = (0.5 * np.exp(1j * (0.01 * k + 2e-6 * k ** 2
                                + np.arange(c)[:, None]))
             + 0.01 * (rng.standard_normal((c, n))
                       + 1j * rng.standard_normal((c, n))))
        z = torch.from_numpy(z.astype(np.complex64)).to(device)
        return (pll.pll_chunk_scan, pll.pll_chunk_scan_plain,
                (z, *st, form == "chunk pilot", 0.11, 0.0077, -0.25, 0.25))
    fs = 64000.0
    x = _carrier(form, c, n, fs, 340.0, rng, device)
    return (pll.pll_scan, pll.pll_scan_plain,
            (x, *st, form, 0.0139, 9.6e-5, 2 * np.pi * 300.0 / fs, -0.098,
             0.098))


@pytest.mark.parametrize("n", [0, 1, 5, 127, 128, 129, 4099])
@pytest.mark.parametrize("c", [1, 7, 17, 64, 200])
@pytest.mark.parametrize("form", LOOP_FORMS)
def test_loop_kernel_equals_plain_bit_for_bit(cuda, form, c, n):
    """K3 in each detector and K3c in both forms on the loop kernel: every
    output and state leaf equal to the plain version's bit for bit (the
    step's float32 arithmetic op for op), at C = 1 to 200 (partial blocks
    of 16 channels, 13 blocks) and N across the pass form (<= 128 frames)
    and the ring (a partial last segment and group, odd N: rows not
    16-byte aligned); one launch per call, counted per detector."""
    fn, plain, args = _loop_case(form, c, n, cuda)
    chunk = form.startswith("chunk")
    before = (pll.pll_chunk_scan.launches if chunk
              else (pll.pll_scan.launches,
                    pll.pll_scan.detector_launches[form]))
    got = fn(*args)
    after = (pll.pll_chunk_scan.launches if chunk
             else (pll.pll_scan.launches,
                   pll.pll_scan.detector_launches[form]))
    assert after == (before + 1 if chunk else (before[0] + 1,
                                              before[1] + 1))
    ref = plain(*args)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", LOOP_FORMS)
def test_loop_call_is_one_kernel(cuda, form):
    """A pll_scan / pll_chunk_scan call puts one device record in a trace:
    the loop kernel of its step; ten calls' records, at most ten (the
    profiler may drop some)."""
    fn, _, args = _loop_case(form, 64, 1000, cuda)
    fn(*args)
    names = _device_records(lambda: fn(*args))
    step = "ChunkStep" if form.startswith("chunk") else "PllStep"
    assert 1 <= len(names) <= 10, names
    assert all(step in nm and "recur_loop_kernel" in nm for nm in names)


def test_loop_plan_matches_the_source(cuda):
    """ops/short_chain.py's mirror of the C loop_plan."""
    import ctypes
    from pebblesdr_tpu_torch.ops import short_chain
    lib = pll._lib()
    for n in (0, 1, 3, 127, 128, 129, 4096, 4099, 32768):
        out = (ctypes.c_int * 10)()
        assert lib.recur_loop_plan(n, out) == 0
        assert list(out) == short_chain.loop_plan(n).as_ints(), n
    assert lib.recur_loop_plan(-1, (ctypes.c_int * 10)()) != 0


@pytest.mark.parametrize("form", LOOP_FORMS)
def test_fed_probe_is_no_slower_than_the_kernel(cuda, form):
    """The chain-only probe fed from memory is a floor: its step (over
    32768 steps) is no slower than the kernel's step at [64, 32768] (a
    launch's time by events, over its steps)."""
    fn, _, args = _loop_case(form, 64, 32768, cuda)
    steps = 32768

    def per_call(f, reps=3):
        f()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    probe = per_call(lambda: pll.chain_probe(form, steps, cuda, fed=True))
    kernel = per_call(lambda: fn(*args))
    assert probe * 1e6 / steps <= kernel * 1e6 / steps, (probe, kernel)


# the receivers and module options that run the recurrences: (mode,
# receiver options, frames, dispatches)
LOOP_RECEIVERS = {
    "rds_scan": (DemodMode.FMS, dict(rds=True, rds_alg="scan"), 32768,
                 (3, 3)),
    "rds_scan_mono": (DemodMode.FMS, dict(stereo=False, rds=True,
                                          rds_alg="scan"), 32768, (3, 3)),
    "sam_short": (DemodMode.SAM, {}, 2048, (3, 9)),
    "sam_short_rails": (DemodMode.SAM, dict(sam_sideband="rails"), 2048,
                        (3, 9)),
}


@pytest.mark.parametrize("case", list(LOOP_RECEIVERS))
def test_loop_receivers_on_card_match_cpu(cuda, case):
    """The scan RDS carrier (FMS stereo and stereo=False) and SAM on
    64-sample blocks (both sideband splits) on the card against the CPU,
    C=4, after a CPU warm-up carried to both (SAM 33 blocks: the AGC delay
    line and the loop's lock); audio 2e-4 (SAM 2e-3 of its scale), soft
    symbols 1e-3 of their scale, timing equal, spectra and S-meter 0.1 dB,
    state 1e-4 with phases modulo 2 pi; pll_scan once per dispatch in the
    receiver's detector."""
    mode, opts, n, ks = LOOP_RECEIVERS[case]
    c = 4
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         agc_stride=16, mode=mode, **opts)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(31)
    t0 = [0.0]
    sam_mode = mode == DemodMode.SAM

    def plane(rows):
        x = (_rds_plane(c, rows, rng, t0[0]) if opts.get("rds")
             else _am_plane(c, rows, rng))
        t0[0] += rows / FS
        return x

    sc = cpu.init_state()
    sc, _ = cpu.step_many(sc, pc, plane((33 if sam_mode else 1) * n))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    det = "atan2" if sam_mode else "costas"
    angles = ({i for i, leaf in enumerate(convert.leaves(sc))
               if leaf is sc.demod.aim or leaf is sc.demod.pll.phase}
              if sam_mode else
              {i for i, leaf in enumerate(convert.leaves(sc))
               if leaf is sc.rds.pll.phase})
    for k in ks:
        x = plane(k * n)
        sc, oc = cpu.step_many(sc, pc, x)
        before = pll.pll_scan.detector_launches[det]
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        torch.cuda.synchronize()
        assert pll.pll_scan.detector_launches[det] == before + 1
        tol = 2e-3 * float(oc["audio"].abs().max()) if sam_mode else 2e-4
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) <= tol
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        for key in ("squelch_open", "pilot_locked", "rds_timing"):
            if key in oc:
                assert torch.equal(og[key].cpu(), oc[key]), key
        if opts.get("rds"):
            scale = float(oc["rds_soft"].abs().max())
            assert float((og["rds_soft"].cpu() - oc["rds_soft"]).abs().max()
                         ) <= 1e-3 * scale
        for i, (a, b) in enumerate(zip(convert.state_to_numpy(sg),
                                       convert.state_to_numpy(sc))):
            if not a.size:
                continue
            d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
            if i in angles:
                d = np.abs(np.angle(np.exp(1j * (a.astype(np.float64)
                                                  - b.astype(np.float64)))))
            assert d.max() < 1e-4, i


def test_loop_module_options_on_card_match_cpu(cuda):
    """SAM algorithm "scan" and smooth "loop", NFM "pll" and the scan AGC
    (stride 16, "long") through their entry points on the card against the
    CPU, two calls each."""
    rng = np.random.default_rng(41)
    c, rate = 8, 64000.0
    t = np.arange(4096) / rate
    xs = [(0.4 * np.exp(1j * (2 * np.pi * 300.0 * t + np.arange(c)[:, None]
                              + 3 * np.sin(2 * np.pi * 1000.0 * t)))
           * (1 + 0.5 * np.cos(2 * np.pi * 700.0 * t))
           + 0.01 * rng.standard_normal((c, 4096))).astype(np.complex64)
          for _ in range(2)]
    cases = []
    for kw in (dict(algorithm="scan"), dict(smooth="loop")):
        cfg = sam.SAMConfig.make(rate, **kw)
        cases.append((lambda st, x, cfg=cfg: sam.sam_demod(cfg, st, x,
                                                           n_block=1024),
                      lambda dev, cfg=cfg: sam.sam_init(cfg, c, dev)))
    ncfg = nfm.NFMConfig.make(rate, algorithm="pll")
    cases.append((lambda st, x: nfm.nfm_demod(ncfg, st, x),
                  lambda dev: nfm.nfm_init(ncfg, c, dev)))
    acfg = agc.AGCConfig.make(rate, "long", stride=16, algorithm="scan")
    cases.append((lambda st, x: agc.agc_apply(acfg, st, x),
                  lambda dev: agc.agc_init(acfg, c, dev)))
    for run, init in cases:
        sc, sg = init("cpu"), init(cuda)
        for x in xs:
            sc, yc = run(sc, torch.from_numpy(x))
            sg, yg = run(sg, torch.from_numpy(x).to(cuda))
            torch.cuda.synchronize()
            scale = float(yc.abs().max())
            assert float((yg.cpu() - yc).abs().max()) <= 1e-4 * scale


# ---- K5: the adaptive IQ balance's LMS loop (csrc/recur.cu iq_lms_scan)

def _imbalanced(c, n, rng, device, gain=1.06, leak=0.08):
    """A tone per channel through an IQ path with I gain `gain` and `leak`
    of I in Q (tests/test_chain.py:204-236's imbalance), in light noise."""
    t = np.arange(n)
    z = (0.5 * np.exp(2j * np.pi * (0.0123 * t + rng.random((c, 1))))
         + 0.01 * (rng.standard_normal((c, n))
                   + 1j * rng.standard_normal((c, n))))
    x = gain * z.real + 1j * (z.imag + leak * z.real)
    return torch.from_numpy(x.astype(np.complex64)).to(device)


@pytest.mark.parametrize("c,n", [(64, 32768), (5, 4096 + 640), (130, 8192),
                                 (3, 0)])
def test_iq_lms_kernel_matches_plain(cuda, c, n):
    """Three streaming calls, one launch each: y and w' within 1e-5 of
    their scale of the plain version (the chain repeats its float32
    operations one by one; the group sums are added in another order), a
    partial tile (N = 4736), more channels than SMs, N = 0."""
    rng = np.random.default_rng(c)
    w_k = scanops.auto_iq_balance_init(c, cuda)
    w_p = w_k.w
    for _ in range(3):
        x = _imbalanced(c, n, rng, cuda)
        before = scanops.auto_iq_balance.launches
        w_k, y_k = scanops.auto_iq_balance(w_k, x)
        assert scanops.auto_iq_balance.launches == before + 1
        y_p, w_p = scanops.iq_lms_scan_plain(x, w_p)
        torch.cuda.synchronize()
        assert y_k.shape == y_p.shape == x.shape
        if n:
            assert float((y_k - y_p).abs().max()) <= 1e-5 * float(
                y_p.abs().max())
        assert float((w_k.w - w_p).abs().max()) <= 1e-5 * max(
            float(w_p.abs().max()), 1e-3)
    if n:
        assert float(w_k.w.abs().min()) > 1e-3      # the weight adapted


def test_iq_lms_kernel_refuses_what_it_does_not_take(cuda):
    st = scanops.auto_iq_balance_init(2, cuda)
    x = torch.zeros(2, 129, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):            # N not a multiple of 64
        scanops.auto_iq_balance(st, x[:, :100].contiguous())
    with pytest.raises(ValueError):            # not 16-byte aligned
        scanops.auto_iq_balance(st, x.reshape(-1)[1:129].reshape(2, 64))
    with pytest.raises(ValueError):            # another group
        scanops.auto_iq_balance(st, x[:, :128].contiguous(), update_every=32)
    with pytest.raises(ValueError):            # the weight on the CPU
        scanops.auto_iq_balance(scanops.auto_iq_balance_init(2, "cpu"),
                                x[:, :128].contiguous())


def _anf_rows(r: int, n: int, rng, device) -> torch.Tensor:
    """[r, n] float32 rows: two tones (800 and 2100 Hz at 64 kHz, a phase
    per row) in noise at 0.3."""
    t = np.arange(n) / 64_000.0 + rng.random()
    x = (0.5 * np.cos(2 * np.pi * 800.0 * t)[None]
         + 0.3 * np.cos(2 * np.pi * 2100.0 * t + np.arange(r)[:, None])
         + 0.3 * rng.standard_normal((r, n)))
    return torch.from_numpy(x.astype(np.float32)).to(device)


# (rows, N, update_every): the staged front's [128, 32768] at U = 16, the
# batched graph's U = 1024, the sample-exact U = 1, N not a multiple of 4
# (4-byte staging), an update of three pieces, more rows than SMs, N = 0;
# the crossover's boundary (U = 32 the chain form's last, U = 33 the wide
# form's first) and an update of two pieces (the wide form's 1024 outputs
# a piece)
ANF_CASES = [(128, 32768, 16), (128, 32768, 1024), (6, 4096, 1),
             (5, 2997, 3), (3, 6144, 3072), (140, 2048, 16), (2, 0, 16),
             (4, 4096, 32), (4, 4224, 33), (4, 8192, 2048)]


@pytest.mark.parametrize("r,n,u", ANF_CASES)
def test_anf_scan_kernel_matches_plain(cuda, r, n, u):
    """Three streaming calls, one K8 launch each: y and w' within 1e-5 of
    their scale of the plain version (the same sums in another order),
    hist' equal."""
    rng = np.random.default_rng(r + n + u)
    st = scanops.anf_init(r, cuda)
    w_p, h_p = st.weights, st.delay
    for _ in range(3):
        x = _anf_rows(r, n, rng, cuda)
        before = scanops.anf_scan.launches
        st, y_k = scanops.anf(st, x, update_every=u)
        assert scanops.anf_scan.launches == before + 1
        y_p, w_p, h_p = scanops.anf_plain(x, w_p, h_p, update_every=u)
        torch.cuda.synchronize()
        assert y_k.shape == y_p.shape == x.shape
        if n:
            assert float((y_k - y_p).abs().max()) <= 1e-5 * float(
                y_p.abs().max())
        assert float((st.weights - w_p).abs().max()) <= 1e-5 * max(
            float(w_p.abs().max()), 1e-3)
        assert torch.equal(st.delay, h_p)
    if n:
        assert float(st.weights.abs().max()) > 1e-3     # it adapted


@pytest.mark.parametrize("form,r,n,u", [
    ("chain", 4, 4096, 32), ("wide", 4, 4096, 32), ("wide", 4, 4096, 16),
    ("wide", 4, 2048, 1), ("chain", 5, 2997, 3), ("wide", 5, 2997, 3),
    ("chain", 130, 8192, 16)])
def test_anf_scan_each_form_matches_plain(cuda, form, r, n, u):
    """Each form forced where the launcher would pick the other (or at the
    boundary): two calls, one launch each, y and w' within 1e-5 of their
    scale of the plain version, hist' equal."""
    rng = np.random.default_rng(r + n + u + len(form))
    st = scanops.anf_init(r, cuda)
    w_k = w_p = st.weights
    h_k = h_p = st.delay
    for _ in range(2):
        x = _anf_rows(r, n, rng, cuda)
        before = scanops.anf_scan.launches
        y_k, w_k, h_k = scanops.anf_scan(x, w_k, h_k, update_every=u,
                                         form=form)
        assert scanops.anf_scan.launches == before + 1
        y_p, w_p, h_p = scanops.anf_plain(x, w_p, h_p.contiguous(),
                                          update_every=u)
        torch.cuda.synchronize()
        assert float((y_k - y_p).abs().max()) <= 1e-5 * float(
            y_p.abs().max())
        assert float((w_k - w_p).abs().max()) <= 1e-5 * max(
            float(w_p.abs().max()), 1e-3)
        assert torch.equal(h_k, h_p)
    assert float(w_k.abs().max()) > 1e-3


@pytest.mark.parametrize("form,r,n,u", [
    ("chain", 8, 4096, 16), ("chain", 6, 2048, 1), ("chain", 5, 2997, 3),
    ("chain", 4, 4096, 32), ("wide", 4, 8192, 1024), ("wide", 4, 4224, 33),
    ("wide", 3, 6144, 3072)])
def test_anf_scan_sums_in_emulates_order(cuda, form, r, n, u):
    """Each form against anf_emulate (its order of summation in torch,
    each fused multiply-add as a float64 product-sum rounded once) on the
    same card: y, w' and hist' equal bit for bit on these inputs, so the
    CPU check of the order (tests/test_torch_anf_order.py) covers the
    kernel."""
    rng = np.random.default_rng(7 * r + n + u)
    st = scanops.anf_init(r, cuda)
    x = _anf_rows(r, n, rng, cuda)
    _, w, h = scanops.anf_plain(_anf_rows(r, n, rng, cuda), st.weights,
                                st.delay, update_every=u)   # adapted
    h = h.contiguous()
    got = scanops.anf_scan(x, w, h, update_every=u, form=form)
    want = scanops.anf_emulate(x, w, h, update_every=u, form=form)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_anf_scan_repeats_its_bits(cuda):
    """No atomics: two launches on the same inputs give the same bits, in
    each form."""
    rng = np.random.default_rng(9)
    x = _anf_rows(8, 8192, rng, cuda)
    st = scanops.anf_init(8, cuda)
    for u in (16, 1024):
        a = scanops.anf_scan(x, st.weights, st.delay, update_every=u)
        b = scanops.anf_scan(x, st.weights, st.delay, update_every=u)
        assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_anf_forms_are_the_launchers(cuda):
    """The form and threads per block that scanops reports are the ones
    csrc/recur.cu's launcher takes."""
    lib = scanops._lib()
    for u in (1, 3, 16, 32, 33, 64, 100, 1024, 3072):
        form = scanops.anf_form(u)
        assert lib.recur_anf_form(u) == scanops.ANF_FORMS.index(form) + 1
        for f in scanops.ANF_FORMS:
            assert lib.recur_anf_threads(scanops.ANF_FORMS.index(f) + 1,
                                         u) == scanops.anf_threads(f, u)


def test_anf_complex_is_one_launch_on_stacked_rows(cuda):
    """Complex x: one K8 launch on the 2C rows (re rows, then im rows),
    the complex state split the same way."""
    rng = np.random.default_rng(5)
    c, n = 4, 4096
    x = torch.complex(_anf_rows(c, n, rng, cuda), _anf_rows(c, n, rng, cuda))
    st = scanops.anf_init(c, cuda, dtype=torch.complex64)
    before = scanops.anf_scan.launches
    st2, y = scanops.anf(st, x)
    assert scanops.anf_scan.launches == before + 1
    rows = torch.cat([x.real, x.imag]).contiguous()
    z = torch.zeros(2 * c, 45, device=cuda)
    y_r, w_r, h_r = scanops.anf_scan(rows, z, torch.zeros(2 * c, 108,
                                                          device=cuda))
    assert torch.equal(y, torch.complex(y_r[:c], y_r[c:]))
    assert torch.equal(st2.weights, torch.complex(w_r[:c], w_r[c:]))
    assert torch.equal(st2.delay, torch.complex(h_r[:c], h_r[c:]))


def test_anf_scan_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 64, device=cuda)
    st = scanops.anf_init(2, cuda)
    with pytest.raises(ValueError):            # N not a multiple of U
        scanops.anf_scan(x[:, :40].contiguous(), st.weights, st.delay)
    with pytest.raises(ValueError):            # float64 rows
        scanops.anf_scan(x.double(), st.weights, st.delay)
    with pytest.raises(ValueError):            # the weights on the CPU
        scanops.anf_scan(x, st.weights.cpu(), st.delay)
    with pytest.raises(ValueError):            # more taps than the kernel's
        scanops.anf_scan(x, torch.zeros(2, 65, device=cuda),
                         torch.zeros(2, 108, device=cuda))
    with pytest.raises(ValueError):            # a CPU tensor
        scanops.anf_scan(x.cpu(), st.weights.cpu(), st.delay.cpu())
    with pytest.raises(ValueError):            # the chain form above U = 32
        scanops.anf_scan(x, st.weights, st.delay, update_every=64,
                         form="chain")
    with pytest.raises(ValueError):            # no such form
        scanops.anf_scan(x, st.weights, st.delay, form="tree")


# ---- the staged front and the dense filterbank bank

def _imbalance(plane: torch.Tensor) -> torch.Tensor:
    """I x 1.06 and 0.08 of I leaked into Q on a packed plane."""
    c = plane.shape[1] // 2
    i = plane[:, :c].clone()
    return torch.cat([1.06 * i, plane[:, c:] + 0.08 * i], dim=1)


# (mode, receiver options, frames, dispatches)
STAGED_RECEIVERS = {
    "am_auto": (DemodMode.AM, dict(enable_iq_balance="auto"), 8192, (3, 9)),
    "usb_auto_nb1": (DemodMode.USB, dict(enable_iq_balance="auto",
                                         enable_noise_blanker=True), 8192,
                     (3, 9)),
    "am_dc_off": (DemodMode.AM, dict(enable_dc_removal=False), 8192, (3, 9)),
    "sam_auto": (DemodMode.SAM, dict(enable_iq_balance="auto"), 8192, (3,)),
    "am_auto_anf": (DemodMode.AM, dict(enable_iq_balance="auto",
                                       enable_anf=True), 8192, (3, 9)),
    "fmm_auto_rds": (DemodMode.FMM, dict(enable_iq_balance="auto", rds=True),
                     32768, (3,)),
}


@pytest.mark.parametrize("case", list(STAGED_RECEIVERS))
def test_staged_receivers_on_card_match_cpu(cuda, case):
    """The staged front on the card against the CPU, C=4, after a CPU
    warm-up block carried to both, on an imbalanced capture: the bounds of
    tests/test_chain_batched.py:58-69 (SAM's audio 2e-3 of its scale, its
    phases modulo 2 pi), RDS soft symbols 1e-3 of their scale; K1 never
    launched, K5 once per dispatch with "auto"."""
    mode, opts, n, ks = STAGED_RECEIVERS[case]
    c = 4
    cfg = ReceiverConfig(sample_rate=FS, frames_per_buffer=n, channels=c,
                         agc_stride=16, mode=mode, **opts)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    assert gpu.staged
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(51)
    t0 = [0.0]

    def plane(rows):
        x = (_rds_plane(c, rows, rng, t0[0]) if opts.get("rds")
             else _am_plane(c, rows, rng))
        t0[0] += rows / FS
        return _imbalance(x)

    sc, _ = cpu.step_many(cpu.init_state(), pc, plane(n))
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    sam_mode = mode == DemodMode.SAM
    angles = ({i for i, leaf in enumerate(convert.leaves(sc))
               if leaf is sc.demod.aim} if sam_mode else set())
    auto = opts.get("enable_iq_balance") == "auto"
    for k in ks:
        x = plane(k * n)
        sc, oc = cpu.step_many(sc, pc, x)
        before = (front.fused_front.launches, scanops.auto_iq_balance.launches)
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        torch.cuda.synchronize()
        assert (front.fused_front.launches - before[0],
                scanops.auto_iq_balance.launches - before[1]) == (0, int(auto))
        tol = 2e-3 * float(oc["audio"].abs().max()) if sam_mode else 2e-4
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) <= tol
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        for key in ("squelch_open", "rds_timing"):
            if key in oc:
                assert torch.equal(og[key].cpu(), oc[key]), key
        if opts.get("rds"):
            scale = float(oc["rds_soft"].abs().max())
            assert float((og["rds_soft"].cpu() - oc["rds_soft"]).abs().max()
                         ) <= 1e-3 * scale
        for i, (a, b) in enumerate(zip(convert.state_to_numpy(sg),
                                       convert.state_to_numpy(sc))):
            if not a.size:
                continue
            d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
            if i in angles:
                d = np.abs(np.angle(np.exp(1j * (a.astype(np.float64)
                                                  - b.astype(np.float64)))))
            assert d.max() < 1e-4, i


@pytest.mark.parametrize("kw", [dict(), dict(enable_iq_balance="auto"),
                                dict(oversample=2)],
                         ids=["trivial", "iq_auto", "oversample2"])
def test_pfb_bank_on_card_matches_cpu(cuda, kw):
    """PfbBankReceiver at M = 16 (1.024 Msps: 64 kHz channels; oversample=2
    128 kHz, whose tail decimates) on the card against the CPU over two
    dispatches of 3 blocks: audio 2e-4, spectra and S-meter 0.1 dB,
    squelch equal, state 1e-4; K5 once per dispatch with "auto"."""
    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu_torch.ops import pfb
    fs, frames, m = 1_024_000, 16384, 16
    centers = pfb.channel_freqs(pfb.plan(fs, m, os=kw.get("oversample", 1)))
    tunes = centers[[2, 5, 11]] + np.array([0.0, 1000.0, -700.0])
    cpu = PfbBankReceiver(fs, frames, tunes, n_bank=m, agc_stride=16,
                          device="cpu", **kw)
    gpu = PfbBankReceiver(fs, frames, tunes, n_bank=m, agc_stride=16,
                          device=cuda, **kw)
    rng = np.random.default_rng(61)
    sc, sg = cpu.init_state(), gpu.init_state()
    for call in range(2):
        t = (call * 3 * frames + np.arange(3 * frames)) / fs
        env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
        x = sum(0.4 * env * np.exp(2j * np.pi * f * t) for f in tunes)
        x = torch.from_numpy((x + 1e-2 * (rng.standard_normal(len(t)) + 1j
                                          * rng.standard_normal(len(t))))
                             .astype(np.complex64))
        sc, oc = cpu.step_many(sc, x)
        before = scanops.auto_iq_balance.launches
        sg, og = gpu.step_many(sg, x.to(cuda))
        torch.cuda.synchronize()
        assert scanops.auto_iq_balance.launches - before == int(
            kw.get("enable_iq_balance") == "auto")
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) <= 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1
        assert torch.equal(og["squelch_open"].cpu(), oc["squelch_open"])
        for a, b in zip(convert.state_to_numpy(sg),
                        convert.state_to_numpy(sc)):
            if a.size:
                assert np.abs(a.astype(np.complex128)
                              - b.astype(np.complex128)).max() < 1e-4


def _left_only_plane(c: int, rows: int, fs: float, t0: float, rng):
    """[rows, 2C] FM stereo at 250 kHz of an fs capture: the L-only 700 Hz
    program, the pilot, channel-dependent level, noise at 1e-2."""
    t = t0 + np.arange(rows) / fs
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt / 2 + 0.1 * np.sin(th) + 0.45 * lt / 2 * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
    x = np.stack([iq * (0.3 + 0.4 * i / c) for i in range(c)], axis=1)
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


@pytest.mark.parametrize("fs,n,opts", [
    (2_880_000, 8192, {}), (FS, 8192, dict(enable_iq_balance="auto"))],
    ids=["2.88 Msps", "staged auto"])
def test_stereo_tail_without_k2_on_card_matches_cpu(cuda, fs, n, opts):
    """FMS where K2 cannot run (tail_sub == 0 at 2.88 Msps; the staged
    front) on the card against the CPU, C = 4, after a CPU warm-up carried
    to both, dispatches of 3 then 9 blocks: audio 2e-4, spectra and
    S-meter 0.1 dB, squelch and pilot lock equal, state 1e-4; K2 never
    launched."""
    c = 4
    cfg = ReceiverConfig(sample_rate=fs, frames_per_buffer=n, channels=c,
                         agc_stride=16, mode=DemodMode.FMS, **opts)
    cpu, gpu = Receiver(cfg, "cpu"), Receiver(cfg, cuda)
    assert gpu.wfm_tail is None and gpu.wfm_cfg.stereo
    pc, pg = cpu.default_params(250_000.0), gpu.default_params(250_000.0)
    rng = np.random.default_rng(61)
    t0 = 0.0
    sc, _ = cpu.step_many(cpu.init_state(), pc, torch.from_numpy(
        _left_only_plane(c, 4 * n, fs, t0, rng)))
    t0 += 4 * n / fs
    sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
    for k in (3, 9):
        x = torch.from_numpy(_left_only_plane(c, k * n, fs, t0, rng))
        t0 += k * n / fs
        sc, oc = cpu.step_many(sc, pc, x)
        before = wfm_tail.wfm_tail.launches
        sg, og = gpu.step_many(sg, pg, x.to(cuda))
        assert wfm_tail.wfm_tail.launches == before
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4
        for key in ("spectrum", "zoomed"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 0.1, key
        assert float((og["smeter"]["snr_db"].cpu()
                      - oc["smeter"]["snr_db"]).abs().max()) < 0.1
        for key in ("squelch_open", "pilot_locked"):
            assert torch.equal(og[key].cpu(), oc[key]), key
        for a, b in zip(convert.state_to_numpy(sg), convert.state_to_numpy(sc)):
            d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
            assert d.max(initial=0.0) < 1e-4
    assert bool(og["pilot_locked"].all())


def test_pll_pilot_with_notch_on_card_matches_cpu(cuda):
    """wfm_demod with WFMConfig(pilot_alg="pll") and the notch: the Q=500
    bandpass, K3c (one launch per call), the demux, the stacked low-pass,
    the notch, over two streaming calls of 4 blocks of 2048 at 256 kHz:
    audio 2e-4, lock equal, the loop's state 1e-4 (its phase on the
    circle)."""
    import dataclasses
    c, nb = 3, 2048
    cfg = dataclasses.replace(wfm.WFMConfig.make(256_000.0, pilot_alg="pll"),
                              notch_needed=True)
    sc, sg = wfm.wfm_init(cfg, c, "cpu"), wfm.wfm_init(cfg, c, cuda)
    rng = np.random.default_rng(62)
    for call in range(2):
        plane = _left_only_plane(c, 4 * nb, 256_000.0, call * 4 * nb / 256e3,
                                 rng)
        x = torch.complex(torch.from_numpy(plane[:, :c].T.copy()),
                          torch.from_numpy(plane[:, c:].T.copy()))
        sc, oc = wfm.wfm_demod(cfg, sc, x, nb)
        before = pll.pll_chunk_scan.launches
        sg, og = wfm.wfm_demod(cfg, sg, x.to(cuda), nb)
        assert pll.pll_chunk_scan.launches == before + 1
        for key in ("left", "right"):
            assert float((og[key].cpu() - oc[key]).abs().max()) < 2e-4, key
        assert torch.equal(og["pilot_locked"].cpu(), oc["pilot_locked"])
        for name in ("phase", "fdev", "amp"):
            d = (getattr(sg.pilot_pll, name).cpu()
                 - getattr(sc.pilot_pll, name)).abs()
            if name == "phase":
                d = torch.minimum(d, (d - 2 * np.pi).abs())
            assert float(d.max()) < 1e-4, name
    assert bool(og["pilot_locked"].all())


def test_cli_on_card_runs_its_kernels(cuda, tmp_path, capsys):
    """The command-line receiver with --device cuda: K1 launches (front_fir
    in its base form) on a synthetic USB run, the JSON as on the CPU."""
    import json
    from pebblesdr_tpu_torch.serve import cli
    before = front.fused_front.launches
    out = str(tmp_path / "a.wav")
    assert cli.main(["--synthetic", "tone", "--mode", "USB", "--tune",
                     "400000", "--seconds", "0.05", "--frames", "8192",
                     "--json", "--audio-out", out]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert front.fused_front.launches > before
    assert m["blocks"] == 16 and m["squelch_open"]


def _ook_powers(c, f, rng, device):
    """(main, low, high) [C, F] float32 bin powers whose decisions sit far
    from every mode's threshold: marks and spaces in runs cycling through
    6, 10, 8, 12 and 7 frames (a 50 % duty, so the average mode's mean
    stays near half the mark level), marks at 0.4 with a +-10 % fade,
    spaces near 1e-3, the compare bins near 2e-3 with a little of the
    keying on the low one."""
    runs = (6, 10, 8, 12, 7)
    key = np.zeros((c, f), bool)
    for i in range(c):
        t, j, on = 0, i, False
        while t < f:
            key[i, t:t + runs[j % 5]] = on
            t, j, on = t + runs[j % 5], j + 1, not on
    fade = 1 + 0.1 * np.sin(np.arange(f) / 40.0 + np.arange(c)[:, None])
    pows = (np.where(key, 0.4 * fade, 1e-3 * (1 + 0.5 * rng.random((c, f)))),
            0.03 * key + 2e-3 * (1 + 0.5 * rng.random((c, f))),
            2e-3 * (1 + 0.5 * rng.random((c, f))))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in pows]


@pytest.mark.parametrize("c,f", [(64, 2048), (5, 300), (3, 0)])
@pytest.mark.parametrize("mode", goertzel.THRESHOLD_MODES)
def test_ook_scan_kernel_matches_plain(cuda, mode, c, f):
    """K6: one launch per call; the marks equal and the state within 1e-6
    of its scale (the kernel repeats the plain version's float32
    operations one by one), on powers whose margins are asserted; a
    partial block of channels and a partial tile (C=5), F=0."""
    cfg = goertzel.OOKConfig.make(mode=mode, manual_threshold=0.1)
    pows = _ook_powers(c, f, np.random.default_rng(f + c), cuda)
    st = goertzel.ook_init(c, cuda)
    if f:
        assert goertzel.ook_margin(cfg, st, *pows) >= 1e-5
    before = goertzel.ook_detect.launches
    got_st, got = goertzel.ook_detect(cfg, st, *pows)
    assert goertzel.ook_detect.launches == before + 1
    ref_st, ref = goertzel.ook_detect_plain(cfg, st, *pows)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got.cpu(), ref.cpu())
    for a, b in zip(convert.leaves(got_st), convert.leaves(ref_st)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            if b.numel():
                scale = max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= 1e-6 * scale
        else:
            assert torch.equal(a.cpu(), b.cpu())


SWEEP_CASES = {
    "100k 512k": (-100e3, 100e3, 1e7, 512_000.0, 8192),
    "2k 48k": (100.0, 2000.0, 1e5, 48_000.0, 32768),
    "odd length": (-30e3, 70e3, 3.3e6, 2_048_000.0, 5000),
}


def _sweep_wraps(y: np.ndarray) -> np.ndarray:
    on = np.abs(y) > 0
    dp = np.angle(y[1:] * np.conj(y[:-1]))
    ok = on[1:] & on[:-1]
    return np.nonzero((np.abs(np.diff(dp)) > 1e-2) & ok[1:] & ok[:-1])[0]


@pytest.mark.parametrize("pulsed", [False, True])
@pytest.mark.parametrize("mode", siggen.SWEEP_MODES)
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_scan_kernel_matches_plain(cuda, case, mode, pulsed):
    """K7: one launch per call; the samples within 1e-5, the wrap samples
    equal, the state's frequency, direction and pulse count equal and its
    phase within 1e-6, over two streaming calls."""
    a, b, rate, fs, n = SWEEP_CASES[case]
    pulse = (300, 1000) if pulsed else (0, 0)
    sg, sp = siggen.sweep_init(a, cuda), siggen.sweep_init(a, cuda)
    for part in (n // 3, n - n // 3):
        before = siggen.sweep.launches
        sg, yg = siggen.sweep(sg, part, a, b, rate, fs, 0.5, mode, *pulse)
        assert siggen.sweep.launches == before + 1
        sp, yp = siggen.sweep_plain(sp, part, a, b, rate, fs, 0.5, mode,
                                    *pulse)
        torch.cuda.synchronize()
        yg, yp = yg.cpu().numpy(), yp.cpu().numpy()
        assert yg.shape == yp.shape == (part,)
        assert np.abs(yg - yp).max() < 1e-5
        assert np.array_equal(_sweep_wraps(yg), _sweep_wraps(yp))
        assert abs(float(sg.phase) - float(sp.phase)) < 1e-6
        for f in ("freq", "direction", "pulse_count"):
            assert torch.equal(getattr(sg, f).cpu(), getattr(sp, f).cpu()), f


def test_ook_and_sweep_refuse_what_they_do_not_take(cuda):
    cfg = goertzel.OOKConfig.make()
    st = goertzel.ook_init(4, cuda)
    p = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError):            # float64 powers
        goertzel.ook_detect(cfg, st, p.double(), p, p)
    with pytest.raises(ValueError):            # a state on the CPU
        goertzel.ook_detect(cfg, goertzel.ook_init(4, "cpu"), p, p, p)
    with pytest.raises(ValueError):            # a [C, 1] state
        goertzel.ook_detect(cfg, goertzel.OOKState(*(
            v[:, None] for v in convert.leaves(st))), p, p, p)
    bad = siggen.SweepState(*(v[None] for v in convert.leaves(
        siggen.sweep_init(0.0, cuda))))
    with pytest.raises(ValueError):            # [1] state tensors
        siggen.sweep(bad, 16, 0.0, 1.0, 1.0, 8.0)


# ---- K4 and K6 on the short-chain kernel (csrc/recur.cu) ----------------

def test_short_plan_matches_the_source(cuda):
    """ops/short_chain.py's mirror of the C short_plan (the form, the
    stage, the pitches, the shared memory)."""
    import ctypes
    from pebblesdr_tpu_torch.ops import short_chain
    lib = pll._lib()
    lib.recur_short_plan.restype = ctypes.c_int
    lib.recur_short_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    for n in (0, 1, 34, 128, 129, 2048, 32768):
        # K4's envelope plane; K6's plane, 3-float frames or a column of
        # 2-float frames
        for fs, esz in ((1, 4), (1, 1), (3, 1), (2, 1)):
            out = (ctypes.c_int * 8)()
            assert lib.recur_short_plan(n, fs, esz, out) == 0
            assert list(out) == short_chain.short_plan(
                n, fs, esz).as_ints(), (n, fs, esz)


def _device_records(fn, calls=10):
    """The device records of `calls` calls of fn under torch.profiler
    (traced again while none was recorded: the profiler drops records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if getattr(ev, "device_type", None) == DeviceType.CUDA]
        if names:
            return names
    return []


SHORT_KINDS = ["agc long", "agc med", "ook peak frames", "ook compare frames",
               "ook compare planes", "ook compare none"]


@pytest.mark.parametrize("kind", SHORT_KINDS)
@pytest.mark.parametrize("f", [1, 34, 2048])
@pytest.mark.parametrize("c", [1, 7, 64, 256])
def test_short_chain_geometry(cuda, c, f, kind):
    """K4 and K6 on the short-chain kernel at C = 1, 7, 64, 256 (1 to 16
    blocks of 16 lanes) and F = 1, 34 (the pass form) and 2048 (the ring):
    one launch per call, the outputs equal to the plain version's (K6's
    state within 1e-6 of scale where the decision margins are asserted),
    K6's powers as goertzel_power's [C, F, 3] columns, as planes (packed
    into the columns' layout in compare mode), or without compare bins;
    two calls streaming the state."""
    _short_chain_case(cuda, c, f, kind)


@pytest.mark.parametrize("kind", SHORT_KINDS + ["ook peak planes"])
@pytest.mark.parametrize("f", [129, 131, 1001, 2051])
@pytest.mark.parametrize("c", [7, 64])
def test_short_chain_partial_segments(cuda, c, f, kind):
    """The ring form's paths that whole 128-frame segments of 16-byte rows
    do not reach: a partial last segment (F = 129, 131, 1001, 2051), its
    last < 4 frames stepped one by one, rows whose segments are not 16-byte
    sized or aligned (copied in and K6's byte marks written out element by
    element where F % 16 != 0; K4's rows where F % 4 != 0), K6 on 3-float
    frames, on a plane and without compare bins; as test_short_chain_
    geometry, against the plain version."""
    _short_chain_case(cuda, c, f, kind)


def _short_chain_case(cuda, c, f, kind):
    if kind.startswith("agc"):
        mode = kind.split()[1]
        rng = np.random.default_rng(c + f)
        key = np.where(((f - 1 - np.arange(f)) // 300) % 2, 1.0, 0.01)
        env = torch.from_numpy(np.log10(np.abs(
            0.5 * key + 1e-3 * rng.standard_normal((c, f))) + 1e-8)
            .astype(np.float32)).to(cuda)
        k = agc.scan_coefs(agc.AGCConfig.make(64000.0, mode, stride=16,
                                              algorithm="scan"))
        st = (torch.full((c,), -0.5, device=cuda),
              torch.full((c,), -0.5, device=cuda),
              torch.zeros(c, dtype=torch.int32, device=cuda))
        args = (k["rise"], k["fall"], k["drise"], k["dfall"],
                k["hang_samples"], k["hang"])
        for _ in range(2):
            before = agc.agc_scan.launches
            got = agc.agc_scan(env, *st, *args)
            assert agc.agc_scan.launches == before + 1
            ref = agc.agc_scan_plain(env, *st, *args)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a.cpu(), b.cpu())
            st = got[:3]
        return
    _, mode, layout = kind.split()
    cfg = goertzel.OOKConfig.make(mode=mode)
    pows = _ook_powers(c, f, np.random.default_rng(7 * c + f), cuda)
    if layout == "frames":
        p3 = torch.stack(pows, -1)
        pows = [p3[:, :, 0], p3[:, :, 1], p3[:, :, 2]]
    elif layout == "none":
        pows = [pows[0], None, None]
    st = goertzel.ook_init(c, cuda)
    for _ in range(2):
        before = goertzel.ook_detect.launches
        got_st, got = goertzel.ook_detect(cfg, st, *pows)
        assert goertzel.ook_detect.launches == before + 1
        ref_st, ref = goertzel.ook_detect_plain(cfg, st, *pows)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got.cpu(), ref.cpu())
        for a, b in zip(convert.leaves(got_st), convert.leaves(ref_st)):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == torch.float32:
                scale = max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= 1e-6 * scale
            else:
                assert torch.equal(a.cpu(), b.cpu())
        st = got_st


@pytest.mark.parametrize("kind", ["agc", "ook"])
def test_short_chain_call_is_one_kernel(cuda, kind):
    """An agc_scan / ook_detect call puts one device record in a trace:
    the short-chain kernel (no stack, copy or compare kernels around it);
    ten calls' records, at most ten (the profiler may drop some)."""
    c, f = 64, 34
    if kind == "agc":
        env = torch.full((c, f), -1.0, device=cuda)
        st = (torch.zeros(c, device=cuda), torch.zeros(c, device=cuda),
              torch.zeros(c, dtype=torch.int32, device=cuda))
        fn = (lambda: agc.agc_scan(env, *st, 0.1, 0.1, 0.01, 0.01, 10,
                                   True))
        step = "AgcStep"
    else:
        p3 = torch.stack(_ook_powers(c, f, np.random.default_rng(1), cuda),
                         -1)
        st = goertzel.ook_init(c, cuda)
        cfg = goertzel.OOKConfig.make(mode="peak")
        fn = (lambda: goertzel.ook_detect(cfg, st, p3[:, :, 0], p3[:, :, 1],
                                          p3[:, :, 2]))
        step = "OokStep"
    fn()
    names = _device_records(fn)
    assert 1 <= len(names) <= 10, names
    assert all(step in nm and "recur_short_kernel" in nm for nm in names)


@pytest.mark.parametrize("form", pll.FED_FORMS)
def test_fed_chain_probe_runs_every_form(cuda, form):
    out = pll.chain_probe(form, 4096, cuda, fed=True)
    torch.cuda.synchronize()
    assert out.shape == (1,) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("mode,opts", [(DemodMode.CWU, {}),
                                       (DemodMode.AM, {}),
                                       (DemodMode.FMS, dict(rds=True))])
def test_taps_on_card_match_cpu(cuda, mode, opts):
    """taps=True on the card (the staged front) against the CPU: every tap
    within 2e-4 and the audio within 2e-4, dispatches of 3 blocks."""
    n = 32768 if opts.get("rds") else 8192
    kw = dict(sample_rate=FS, frames_per_buffer=n, channels=4,
              agc_stride=16, mode=mode, taps=True, **opts)
    rc, rg = Receiver(ReceiverConfig(**kw), "cpu"), Receiver(
        ReceiverConfig(**kw), cuda)
    sc, sg = rc.init_state(), rg.init_state()
    pc, pg = rc.default_params(250_000.0), rg.default_params(250_000.0)
    rng = np.random.default_rng(5)
    for _ in range(2):
        x = (_stereo_plane(4, 3 * n, rng) if mode == DemodMode.FMS
             else _am_plane(4, 3 * n, rng))
        sc, oc = rc.step_many(sc, pc, x)
        sg, og = rg.step_many(sg, pg, x.to(cuda))
        assert set(og["taps"]) == set(oc["taps"])
        for key, v in oc["taps"].items():
            assert float((og["taps"][key].cpu() - v).abs().max()) < 2e-4, key
        assert float((og["audio"].cpu() - oc["audio"]).abs().max()) < 2e-4


def test_testbench_on_card_matches_cpu(cuda):
    """The TestBench with a -40 dB tone and with a pulsed sweep (K7 once
    per block) on the card against the CPU: the taps' histories within
    2e-4; the tone read at -40 +- 1 dB on the card's raw_iq tap."""
    from pebblesdr_tpu_torch.chain.testbench import TestBench
    kw = dict(sample_rate=512_000, frames_per_buffer=8192, mode=DemodMode.AM,
              taps=True, agc_mode="off")
    for inject in (("tone", {"freq_hz": 100_000.0, "db": -40.0}),
                   ("sweep", {"start_hz": 90e3, "stop_hz": 110e3,
                              "rate_hz_per_sec": 4e6, "db": -20.0,
                              "pulse_on_samples": 3000,
                              "pulse_period_samples": 5000})):
        benches = [TestBench(Receiver(ReceiverConfig(**kw), dev),
                             inject=inject) for dev in ("cpu", cuda)]
        for tb in benches:
            st, p = tb.rx.init_state(), tb.rx.default_params(100_000.0)
            before = siggen.sweep.launches
            for _ in range(4):
                st, _ = tb.step(st, p, torch.zeros(
                    1, 8192, dtype=torch.complex64, device=tb.rx.device))
            if tb.rx.device.type == "cuda" and inject[0] == "sweep":
                assert siggen.sweep.launches == before + 4
        for name in benches[0].history:
            a, b = benches[0].tap(name), benches[1].tap(name)
            assert np.abs(a - b).max() < 2e-4, name
        if inject[0] == "tone":
            freqs, db = benches[1].tap_spectrum_db("raw_iq", 512_000)
            assert db[np.argmax(db)] == pytest.approx(-40.0, abs=1.0)


def test_cli_decode_cw_on_card(cuda, capsys):
    """--synthetic morse --decode cw with --device cuda: "cq..." decoded
    through the staged front's taps and K6 (one launch per modem call)."""
    import json
    from pebblesdr_tpu_torch.serve import cli
    before = goertzel.ook_detect.launches
    assert cli.main(["--synthetic", "morse", "--mode", "CWU", "--tune",
                     "100000", "--seconds", "3.2", "--decode", "cw",
                     "--json"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["decoded_text"].lower().startswith("cq")
    assert goertzel.ook_detect.launches > before


def _two_station_capture(n, fs=512_000):
    """tests/test_expert.py:18-28: AM at +100 kHz, NFM at -50 kHz."""
    rng = np.random.default_rng(7)
    t = np.arange(n) / fs
    am = (1 + 0.6 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(
        2j * np.pi * 100_000.0 * t)
    ph = 2 * np.pi * np.cumsum(3000.0 * np.sin(2 * np.pi * 700.0 * t)) / fs
    fm = 0.5 * np.exp(1j * (2 * np.pi * -50_000.0 * t + ph))
    x = am + fm + 0.001 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return np.stack([x.real, x.imag], axis=1).astype(np.float32)


def test_mode_experts_on_card(cuda):
    """The mode experts (parallel/expert.py) on the card: K = 3 blocks of
    one shared [K*N, 2] capture through step_many, two dispatches, each
    expert within 1e-5 of its mode's single-mode Receiver on the card, K1
    launched once per expert per dispatch (the wrapper's counter)."""
    from pebblesdr_tpu_torch.parallel import expert
    n = 8192
    assign = [expert.ChannelAssignment(DemodMode.AM, 100_000.0),
              expert.ChannelAssignment(DemodMode.FMN, -50_000.0),
              expert.ChannelAssignment(DemodMode.AM, 101_000.0)]
    ch = expert.ModeExpertChannelizer(512_000, n, assign, device=cuda)
    iq = torch.from_numpy(_two_station_capture(3 * n)).to(cuda)
    before = front.fused_front.launches
    states = ch.init_states()
    for _ in range(2):
        states, outs = ch.step_many(states, iq)
    torch.cuda.synchronize()
    assert front.fused_front.launches - before == 2 * ch.n_experts
    for e, g in enumerate(ch.groups):
        c = len(g.channel_ids)
        rx = Receiver(ReceiverConfig(sample_rate=512_000,
                                     frames_per_buffer=n, channels=c,
                                     mode=g.mode), cuda)
        p, st = rx.default_params(g.tunes), rx.init_state()
        x = iq[:, [0] * c + [1] * c]
        for _ in range(2):
            st, o = rx.step_many(st, p, x)
        assert float((o["audio"] - outs[e]["audio"]).abs().max()) <= 1e-5


def test_sharded_step_one_rank_nccl_on_card(cuda):
    """A one-rank world on the card: the backend NCCL (every rank has a
    card), the fused front (K1, counted once per dispatch) on the (1, 1)
    mesh, audio within 2e-3 of the unsharded step_many
    (tests/test_parallel.py's bound)."""
    from pebblesdr_tpu_torch.parallel import channelizer, comm
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    if comm.is_initialized():
        pytest.skip("a world is up in this process")
    n, k, c = 8192, 4, 4
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                 channels=c), cuda)
    params = rx.default_params(250_000.0 + 100.0 * np.arange(c))
    x = _am_plane(c, k * n, np.random.default_rng(3)).to(cuda)
    st, ref = rx.init_state(), []
    for _ in range(2):
        st, o = rx.step_many(st, params, x)
        ref.append(o["audio"])
    assert comm.init_world(1, 0, "cuda") == "nccl"
    try:
        m = mesh_mod.make_mesh(1, 1, "cuda")
        step = channelizer.build_sharded_step(rx, m)
        assert step.fused and m.backend == "nccl" and not m.host_hops
        before = front.fused_front.launches
        sst, got = step.init_state(), []
        for _ in range(2):
            sst, o = step.step_many(sst, params, x)
            got.append(o["audio"])
        torch.cuda.synchronize()
        assert front.fused_front.launches - before == 2
    finally:
        comm.destroy_world()
    assert float((torch.cat(got) - torch.cat(ref)).abs().max()) <= 2e-3
