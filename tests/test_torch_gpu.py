"""Card-only tests of the PyTorch port: the CUDA kernels against their plain
PyTorch versions, and the AM receiver on the card against the CPU.

They skip where CUDA is absent (the kernels have no CPU mode).  This file
imports no jax, so it also runs on a machine that has only the port:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.ops import decimator, front
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


def _plan(device):
    p = decimator.build_plan(FS, 30_000)
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
