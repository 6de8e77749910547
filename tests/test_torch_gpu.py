"""Card-only tests of the PyTorch port: the CUDA kernels (the front end K1
in its AM and WFM forms, the stereo tail K2) against their plain PyTorch
versions, and the AM and WFM receivers on the card against the CPU.

They skip where CUDA is absent (the kernels have no CPU mode).  This file
imports no jax, so it also runs on a machine that has only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from pebblesdr_tpu.demod.modes import DemodMode
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod import wfm
from pebblesdr_tpu_torch.ops import decimator, front, wfm_tail
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


def test_matmuls_are_ieee_float32(cuda):
    """The receive chain's matmuls must not run in TF32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_shared_memory_layouts_match_the_sources(cuda):
    """front_fir's shared-memory layout mirrored in Python (the CPU size
    check) agrees with the CUDA source; the stereo tail's FIR block fits
    for the covered low-passes and is refused past its largest slice."""
    lib = front._lib()
    for ntaps, factor in ((20, 4), (9, 8), (30, 2), (283, 8), (711, 32),
                          (200, 2)):
        lay = front.fir_smem_layout(ntaps, factor)
        assert lib.front_fir_smem_bytes(ntaps, factor) == (
            4 * lay["total"] if lay else 0)
    tlib = wfm_tail._lib()
    for ntaps, factor, ell in ((235, 4, 256), (31, 4, 128), (235, 2, 256),
                               (501, 4, 256)):
        assert 0 < tlib.wfm_tail_smem_bytes(ntaps, factor, ell) <= 232448
    assert tlib.wfm_tail_smem_bytes(600, 4, 256) == 0


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


@pytest.mark.parametrize("c", [4, 5, 64])
def test_wfm_tail_kernel_matches_plain(cuda, c):
    """K2 against wfm_tail_reference over two streaming calls from a random
    history; C=5 leaves a partial channel group."""
    taps = wfm.WFMConfig.make(256_000.0).audio_taps
    plan = wfm_tail.TailPlan.make(taps, 4, 256, 2048, cuda)
    rng = np.random.default_rng(7)
    hist_k = hist_r = torch.randn(plan.d_rows, 2 * c, device=cuda) * 0.3
    n = 16384
    for _ in range(2):
        raw = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)
                               ).to(cuda)
        p0 = torch.from_numpy(rng.uniform(0, 10, (n // 256, c))
                              .astype(np.float32)).to(cuda)
        wf = torch.full((n // 256, c), 2 * np.pi * 19000 / 256000,
                        device=cuda)
        before = wfm_tail.wfm_tail.launches
        got = wfm_tail.wfm_tail(plan, raw, p0, wf, hist_k)
        assert wfm_tail.wfm_tail.launches == before + 1
        ref = wfm_tail.wfm_tail_reference(plan, raw, p0, wf, hist_r)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            assert rel_err(b, a) < RTOL
        hist_k, hist_r = got[1], ref[1]


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
