"""front_dc_scan, K1's chunk EWMA m_k = a m_{k-1} + (1 - a) mu_k, in the
PyTorch port.

The kernel keeps a fixed association (32 segments per lane, each
segment's (r, p) serially, the 32 seeds chained from dc_in, each segment
walked from its seed, in float32 FMAs), since y reads the ulps of m.
ops/front.py dc_scan_emulate mirrors that arithmetic in numpy float32,
and the card test (tests/test_torch_gpu.py) holds the kernel to it bit for
bit.  Here, on the CPU, the mirror is held to the plain version (the
float64 closed form _ewma, 3e-5 relative: float32 rounding over up to
4096 chunks) at the cells' chunk counts and to the JAX K1's dc' and
nb_avg' (the Pallas kernel in interpret mode at a small shape, 3e-5
relative, its bound against the plain version in tests/test_pallas.py:63).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import decimator as jdec
from pebblesdr_tpu.ops import mixer as jmix
from pebblesdr_tpu.ops import pallas_kernels as pk
from pebblesdr_tpu_torch.ops import decimator as tdec
from pebblesdr_tpu_torch.ops import front

FS = 2_048_000
RTOL = 3e-5
NB1 = (3.3, 7, 0.001, "blank")
# a of the DC blocker (alpha = 0.9999 per row) and of the blanker's
# average (alpha = 0.001 per row), over a 512-row chunk
A = {"dc": 0.9999 ** front.DC_CHUNK, "blanker": (1.0 - NB1[2]) ** front.DC_CHUNK}


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("which", list(A))
@pytest.mark.parametrize("nchunk", [16, 1024, 2048, 4096])
def test_emulate_matches_plain_ewma(nchunk, which):
    """16 chunks leave most of the 32 segments empty; 1024, 2048 and 4096
    are am_256ch's, am_64ch's and am_16ch's (and wfm_16ch's) dispatches."""
    rng = np.random.default_rng(nchunk)
    lanes = 8
    mu = (rng.standard_normal((nchunk, lanes)) * 0.2 + 0.3).astype(np.float32)
    if which == "blanker":                     # means of |z|^2 are positive
        mu = np.abs(mu)
    dc = (rng.standard_normal((1, lanes)) * 0.1 + 0.2).astype(np.float32)
    a32, b32 = front.chunk_ewma(A[which])
    m, d = front.dc_scan_emulate(mu, dc, a32, b32)
    assert m.dtype == d.dtype == np.float32
    assert m.shape == mu.shape and d.shape == (1, lanes)
    ref, ref_d = front.dc_scan_reference(torch.from_numpy(mu),
                                         torch.from_numpy(dc), A[which])
    assert rel_err(ref.numpy(), m) < RTOL
    assert rel_err(ref_d.numpy(), d) < RTOL


def test_emulate_keeps_the_kernel_association():
    """The mirror is not the sequential recurrence: its segments re-associate
    the sum, which moves m by ulps (the reason the kernel keeps its order);
    with one chunk per segment and a zero seed it is exactly b mu_0 at the
    first chunk."""
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((2048, 4)).astype(np.float32)
    a32, b32 = front.chunk_ewma(A["dc"])
    m, _ = front.dc_scan_emulate(mu, np.zeros(4, np.float32), a32, b32)
    seq = np.zeros(4, np.float32)
    rows = []
    for k in range(mu.shape[0]):
        seq = (np.float32(a32) * seq + np.float32(b32) * mu[k]).astype(
            np.float32)
        rows.append(seq)
    seq = np.stack(rows)
    assert not np.array_equal(m, seq)
    assert rel_err(seq, m) < RTOL
    assert np.array_equal(m[0], np.float32(b32) * mu[0])


def test_fma_mirror_rounds_once():
    """_fma32 rounds x y + z once (the float64 sum's own rounding never
    leaks through): checked against exact rational arithmetic, with ties
    made on purpose."""
    from fractions import Fraction
    rng = np.random.default_rng(9)
    x = rng.standard_normal(400).astype(np.float32)
    y = rng.standard_normal(400).astype(np.float32)
    z = (rng.standard_normal(400) * 1e-3).astype(np.float32)
    # ties: x y exactly on a float32 midpoint, z a tiny nudge either way
    x[:50], y[:50] = np.float32(1.0) + np.float32(2.0 ** -23), np.float32(1.5)
    z[:25], z[25:50] = np.float32(2.0 ** -60), np.float32(-2.0 ** -60)
    got = front._fma32(x, y, z)
    for i in range(len(x)):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) + Fraction(
            float(z[i]))
        c = np.float32(float(exact))
        near = [c, np.nextafter(c, np.float32(np.inf)),
                np.nextafter(c, np.float32(-np.inf))]
        best = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.float32(v).view(np.uint32)) & 1))
        assert got[i] == best, i


def _pack(b):
    return np.ascontiguousarray(np.concatenate([b.real.T, b.imag.T], axis=-1))


@pytest.mark.parametrize("which", list(A))
def test_emulate_matches_jax_k1(which):
    """One dispatch of the JAX K1 (pk.fused_front_packed in interpret mode,
    C = 4, 8192 rows: 16 chunks) from a non-zero carried state: its dc'
    against the mirror over the plane's chunk means, and (the blanker, NB1
    with IQ balance) its nb_avg' against the mirror over the chunk means of
    |z|^2 (z from the plain version's DC removal and IQ balance)."""
    c, n = 4, 8192
    jp = jdec.build_plan(FS, 30_000)
    p = tdec.build_plan(FS, 30_000)
    plan = front.FrontPlan.make(tdec.compose_response(p), p.factor, "cpu")
    h = jdec.compose_response(jp)
    wt = jnp.asarray(np.ascontiguousarray(pk.build_composed_w(
        h, jp.factor, 2048, plan.d_rows - (len(h) - 1)).T))
    rng = np.random.default_rng(31)
    b = (0.1 * (rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n)))
         + 0.05 - 0.03j).astype(np.complex64)
    x = _pack(b)
    splits = [jmix.split_freq(250_000.0 + 1234.5 * i, FS) for i in range(c)]
    hi = np.array([s[0] for s in splits])
    lo = np.array([s[1] for s in splits])
    dc = np.full((1, 2 * c), 0.02, np.float32)
    avg = np.full((1, 2 * c), 0.03, np.float32)
    kw = dict(sub_block=2048, n_block=n, raw_rows=2048, interpret=True)
    if which == "blanker":
        kw.update(iq_gain=jnp.float32(1.05), iq_phase=jnp.float32(0.02),
                  nb=NB1, nb_avg=jnp.asarray(avg),
                  nb_tail=jnp.zeros((16, 2 * c)))
    jo = pk.fused_front_packed(jnp.asarray(x), jnp.asarray(dc),
                               jnp.zeros((c,)), jnp.asarray(hi),
                               jnp.asarray(lo), jnp.zeros((plan.d_rows, 2 * c)),
                               wt, jp.factor, plan.d_rows, 0.9999, **kw)
    xt = torch.from_numpy(x)
    means = front.chunk_means_reference(xt)[0]
    if which == "dc":
        a32, b32 = front.chunk_ewma(A["dc"])
        _, d = front.dc_scan_emulate(means.numpy(), dc, a32, b32)
        assert rel_err(np.asarray(jo[1]), d) < RTOL
        return
    _, z = front.dc_iq_reference(plan, xt, torch.from_numpy(dc),
                                 torch.tensor(1.05), torch.tensor(0.02), means)
    zsw = torch.cat([z[:, c:], z[:, :c]], dim=1)
    mag2 = (z * z + zsw * zsw).reshape(-1, front.DC_CHUNK, 2 * c).mean(dim=1)
    a32, b32 = front.chunk_ewma(A["blanker"])
    _, d = front.dc_scan_emulate(mag2.numpy(), avg, a32, b32)
    assert rel_err(np.asarray(jo[5]), d) < RTOL


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    rng = np.random.default_rng(2)
    mu = torch.from_numpy(rng.standard_normal((64, 6)).astype(np.float32))
    dc = torch.full((1, 6), 0.1)
    before = front.dc_scan.launches
    m, d = front.dc_scan(mu, dc, A["dc"])
    assert front.dc_scan.launches == before
    ref = front.dc_scan_reference(mu, dc, A["dc"])
    assert torch.equal(m, ref[0]) and torch.equal(d, ref[1])


# (nchunk, lanes) K1 gives the scan at the cells
SCAN_CELLS = {"am_64ch": (2048, 128), "am_16ch": (4096, 32),
              "am_256ch": (1024, 512), "probe_bench": (512, 128),
              "card_test_c5": (48, 10)}


@pytest.mark.parametrize("cell", list(SCAN_CELLS))
def test_scan_fetches_each_segment_first_and_spreads_the_lanes(cell):
    """Each thread (one segment of one lane) fetches its whole segment
    before its chains start: up to 64 chunks into registers, a longer
    segment as part of the block's tile in shared memory (32 segments x
    len + 1 chunks x 8 lanes);
    blocks of at most 8 lanes x 32 segments, so even 16 channels (32
    lanes) take four blocks where 32-lane blocks took one."""
    nchunk, lanes = SCAN_CELLS[cell]
    lay = front.dc_scan_layout(nchunk, lanes)
    assert lay["len"] == -(-nchunk // 32)
    if lay["len"] <= 64:
        assert lay["len"] <= lay["held"] <= 64 and lay["smem"] == 0
        assert lay["held"] in (8, 16, 32, 64)
    else:
        assert lay["held"] == 0
        assert lay["smem"] == 32 * (lay["len"] + 1) * 8 * 4 <= 232448 - 8192
    assert lay["blocks"] * lay["lanes"] >= lanes > (lay["blocks"] - 1) * lay[
        "lanes"]
    assert lay["blocks"] >= -(-lanes // 32)
    assert lay["threads"] == 32 * lay["lanes"] <= 256
    if cell == "am_16ch":
        assert lay["blocks"] == 4 > 1 and lay["smem"] == 132096


def test_scan_reads_device_memory_past_a_block():
    lay = front.dc_scan_layout(70_000, 2)
    assert lay["held"] == 0 and lay["len"] == 2188 and lay["smem"] == 0
    assert front.dc_scan_layout(2048, 2)["held"] == 64
    assert front.dc_scan_layout(2049, 2)["held"] == 0
