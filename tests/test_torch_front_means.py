"""front_means, K1's first pass, in the PyTorch port: the chunk means of
every lane and each block's raw display tail (ops/front.py chunk_means /
chunk_means_reference).

On the CPU: the plain version against the JAX package (the chunk means of
iir.dc_removal_chunked, whose EWMA with alpha = 0 is the means themselves;
the raw tails of the TPU kernel pk.fused_front_packed in interpret mode),
and the wrapper's CPU path.  The CUDA kernel is held to the plain version
on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import iir as jiir
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import front
from pebblesdr_tpu_torch.utils import roofline

FS = 2_048_000


def _channel_major(c, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n))
            + (0.3 - 0.2j)).astype(np.complex64)


def _pack(b):
    return np.ascontiguousarray(np.concatenate([b.real.T, b.imag.T], axis=-1))


@pytest.mark.parametrize("c", [1, 3, 4, 7])
def test_means_match_jax_dc_removal(c):
    """With alpha = 0 the chunked DC blocker subtracts each chunk's mean:
    x - y at a chunk's first sample is that mean (1e-6 absolute on
    unit-scale input)."""
    n = 4096
    b = _channel_major(c, n, c)
    _, y = jiir.dc_removal_chunked(jnp.zeros((c,), jnp.complex64),
                                   jnp.asarray(b), alpha=0.0)
    d = (b - np.asarray(y))[:, ::front.DC_CHUNK]             # [C, n/512]
    ref = np.concatenate([d.real.T, d.imag.T], axis=1)       # [n/512, 2C]
    means, raw = front.chunk_means_reference(torch.from_numpy(_pack(b)))
    assert means.shape == (n // front.DC_CHUNK, 2 * c)
    assert raw.shape == (1, 0, 2 * c)
    assert np.abs(means.numpy() - ref).max() < 1e-6


def _i16(x):
    return np.clip(np.round(x * 8192.0), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("entry", ["f32", "i16"])
def test_raw_tails_match_pallas_kernel(entry):
    """The raw display tails equal the TPU kernel's (interpret mode) exactly,
    for float32 and int16 (dequantized) planes."""
    c, n, k = 4, 4096, 2
    jp = jdec.build_plan(FS, 30_000)
    h = jdec.compose_response(jp)
    d_rows = ((len(h) - 1 + 7) // 8) * 8
    wt = jnp.asarray(np.ascontiguousarray(
        pk.build_composed_w(h, jp.factor, 2048, d_rows - (len(h) - 1)).T))
    x = _pack(_channel_major(c, k * n, 11))
    if entry == "i16":
        x = _i16(x)
    hi = np.full(c, 0.1220703125)
    out = pk.fused_front_packed(
        jnp.asarray(x), jnp.zeros((1, 2 * c)), jnp.zeros((c,)),
        jnp.asarray(hi), jnp.zeros(c), jnp.zeros((d_rows, 2 * c)), wt,
        jp.factor, d_rows, 0.9999, sub_block=2048, n_block=n, raw_rows=2048,
        interpret=True)
    means, raw = front.chunk_means_reference(torch.from_numpy(x), n, 2048)
    assert raw.shape == (k, 2048, 2 * c)
    assert np.array_equal(np.asarray(out[4]), raw.numpy())
    assert means.shape == (k * n // front.DC_CHUNK, 2 * c)


def test_int16_means_are_exact():
    """Every partial sum of 512 int16 values is exact in float32, so the
    means equal the integer sums scaled by 2^-15 / 512."""
    rng = np.random.default_rng(4)
    x = rng.integers(-32768, 32768, (2048, 6)).astype(np.int16)
    means, _ = front.chunk_means_reference(torch.from_numpy(x))
    sums = x.astype(np.int64).reshape(4, 512, 6).sum(1)
    assert np.array_equal(means.numpy(),
                          (sums * 2.0 ** -24).astype(np.float32))


def test_cpu_wrapper_runs_plain_version_without_counting():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(8192, 10)).astype(np.float32))
    before = front.chunk_means.launches
    got = front.chunk_means(x, 4096, 37)
    ref = front.chunk_means_reference(x, 4096, 37)
    assert front.chunk_means.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[1].shape == (2, 37, 10)
    assert torch.equal(got[1], x.reshape(2, 4096, 10)[:, -37:])


def test_fused_front_reference_takes_its_means_from_chunk_means():
    """dc' of a plane whose DC estimate starts at 0, with a = alpha^512:
    the EWMA of chunk_means' means."""
    c, n = 2, 4096
    p = tdec.build_plan(FS, 30_000)
    plan = front.FrontPlan.make(tdec.compose_response(p), p.factor, "cpu")
    x = torch.from_numpy(_pack(_channel_major(c, n, 6)))
    out = front.fused_front_reference(
        plan, x, torch.zeros(1, 2 * c), torch.zeros(c), torch.zeros(c),
        torch.zeros(c), torch.zeros(plan.d_rows, 2 * c), n_block=n,
        raw_rows=100)
    means, raw = front.chunk_means_reference(x, n, 100)
    a = plan.dc_alpha ** front.DC_CHUNK
    m = np.zeros(2 * c)
    for mu in means.double().numpy():
        m = a * m + (1 - a) * mu
    assert np.abs(out[1].numpy()[0] - m).max() < 1e-6
    assert torch.equal(out[4], raw)


@pytest.mark.parametrize("t,n_block,raw_rows", [(1000, 0, 0), (4096, 1536, 0),
                                                (4096, 2048, 2049),
                                                (4096, 2048, -1)])
def test_bad_geometry_raises(t, n_block, raw_rows):
    x = torch.zeros(t, 4)
    with pytest.raises(ValueError):
        front.chunk_means(x, n_block, raw_rows)


def test_means_bound_at_the_cells():
    """Bytes: the plane once, the means and raw tails written once."""
    cells = {(1_048_576, 128, 4, 32): 0.1705, (524_288, 512, 4, 16): 0.3410,
             (524_288, 512, 2, 16): 0.1809, (2_097_152, 32, 4, 64): 0.0853}
    for (t, lanes, xb, k), ms in cells.items():
        b = roofline.means_bound(t, lanes, xb, k, 2048)
        assert b["bound_by"] == "bytes"
        assert b["bytes"] == (t * lanes * xb + t // 512 * lanes * 4
                              + k * 2048 * lanes * 4)
        assert abs(b["bound_ms"] - ms) < 5e-4


@pytest.mark.parametrize("name,fn,args,ms,by", [
    # front_disc at wfm_64ch (M = 131072 rows of 64 channels, 32 blocks of
    # 2048-row y-tails) and in the hq form at wfm_hq_64ch (M = 262144, only
    # comp_hist's 32 rows of the discriminator written)
    ("disc_wfm_64ch", "disc_bound", (131072, 64, 32, 2048), 0.0401, "bytes"),
    ("disc_hq", "disc_bound", (262144, 64, 32, 2048, 32), 0.0501, "bytes"),
    ("comp_hq", "comp_bound", (262144, 64, 31, 32), 0.0501, "bytes"),
    # front_comp as the hq form's one pass over y: the 32 blocks' 2048-row
    # y-tails written too (y read, disc and the y-tails written: 192 MiB)
    ("comp_hq_one_pass", "comp_bound", (262144, 64, 31, 32, 32, 2048), 0.0601,
     "bytes"),
    ("dc_scan_am_64ch", "scan_bound", (2048, 128), 0.000626, "bytes"),
    ("tail_am_64ch", "front_tail_bound", (712, 64, 4), 0.000435, "bytes"),
])
def test_k1_pass_bounds_at_the_cells(name, fn, args, ms, by):
    """Each K1 pass's bound counts its own bytes and operations; at the
    cells every one is bound by bytes."""
    b = getattr(roofline, fn)(*args)
    assert b["bound_by"] == by
    assert abs(b["bound_ms"] - ms) < 0.01 * ms
