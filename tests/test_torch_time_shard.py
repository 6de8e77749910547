"""The port's time sharding (pebblesdr_tpu_torch/parallel/time_shard.py) in
one 8-rank gloo world on the CPU (a (1, 8) mesh), each function's shards
joined in time order and held to the JAX package's unsharded op, with the
bounds of tests/test_parallel.py:24-143: the streaming FIR and the halfband
cascade 1e-5, the mix 2e-3 (its phase 1e-4), overlap-save 1e-4 (its state
1e-6); the DC chunks against JAX's own sharded_dc_chunks (run on 8 forced
CPU devices) and the DC removal against ops.iir.dc_removal_chunked, 1e-6;
the composed front against JAX's sharded_composed_front, 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_dist as td
from pebblesdr_tpu.ops import decimator, fastfir, fir, iir, mixer
from pebblesdr_tpu.parallel import mesh as jmesh
from pebblesdr_tpu.parallel import time_shard as jts

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return td.World("time_shard", 8, tmp_path_factory.mktemp("time_shard"))


def test_fir_matches_unsharded_streaming(world):
    taps = np.asarray(fir.design_halfband(23, 0.182), np.float32)
    rng = np.random.default_rng(0)
    c, n = td.FIR["c"], td.FIR["n"]
    blocks = [(rng.normal(size=(c, n)) + 1j * rng.normal(size=(c, n))
               ).astype(np.complex64) for _ in range(td.FIR["blocks"])]
    tail = fir.fir_tail_init(c, len(taps))
    ref = []
    for b in blocks:
        y, tail = fir.fir_apply(jnp.asarray(b), jnp.asarray(taps), tail, 2)
        ref.append(np.asarray(y))
    res = world.results()
    for i in range(td.FIR["blocks"]):
        np.testing.assert_allclose(td.by_time(res, f"fir{i}"), ref[i],
                                   atol=1e-5)
    for r in res:   # the new carry, the same on every shard
        np.testing.assert_allclose(r["fir_carry"], np.asarray(tail),
                                   atol=1e-6)


def test_cascade_matches(world):
    plan = decimator.build_plan(1_024_000, 20_000)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(1, 1 << 14)) + 1j * rng.normal(size=(1, 1 << 14))
         ).astype(np.complex64)
    _, ref = decimator.apply(plan, decimator.state_init(plan, 1),
                             jnp.asarray(x))
    np.testing.assert_allclose(td.by_time(world.results(), "cascade"),
                               np.asarray(ref), atol=1e-5)


def test_mix_matches_unsharded(world):
    hi, lo = mixer.split_freq(123_456.0, 1_024_000.0)
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 8192)) + 1j * rng.normal(size=(2, 8192))
         ).astype(np.complex64)
    st = mixer.mixer_init(2)
    st2, ref = mixer.mix(st, jnp.asarray(x), hi, lo)
    res = world.results()
    np.testing.assert_allclose(td.by_time(res, "mix"), np.asarray(ref),
                               atol=2e-3)
    for r in res:
        np.testing.assert_allclose(r["mix_phase"], np.asarray(st2.phase),
                                   atol=1e-4)


def test_overlap_save_matches_unsharded(world):
    blk = 512
    mask = jnp.asarray(fastfir.design_mask(-3000.0, 3000.0, 16000.0, blk))
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(1, 8 * blk)) + 1j * rng.normal(size=(1, 8 * blk))
         ).astype(np.complex64)
    st = fastfir.state_init(1, blk)
    ref = []
    for i in range(8):
        st, y = fastfir.apply(st, jnp.asarray(x[:, i * blk:(i + 1) * blk]),
                              mask)
        ref.append(np.asarray(y))
    res = world.results()
    np.testing.assert_allclose(td.by_time(res, "ols"),
                               np.concatenate(ref, axis=1), atol=1e-4)
    for r in res:
        np.testing.assert_allclose(r["ols_state"], x[:, -blk:], atol=1e-6)


def _jax_dc():
    xd = td.noisy_dc(3, 8 * 4096, 5)
    dc0 = jnp.asarray(np.array([0.01 + 0.02j, -0.03j, 0.05], np.complex64))
    m = jmesh.make_mesh(channel=1, time=8)
    f = jax.jit(jax.shard_map(
        functools.partial(jts.sharded_dc_chunks, alpha=0.9999,
                          axis_name="time"),
        mesh=m, in_specs=(P(None, "time"), P()),
        out_specs=(P("time"), P(None, "time"), P()), check_vma=False))
    return xd, dc0, [np.asarray(a) for a in f(jnp.asarray(xd), dc0)]


def test_dc_chunks_match_jax_sharded(world):
    """m_start per shard, every chunk's estimate, and the global new_dc."""
    _, _, (m_start, m_all, new_dc) = _jax_dc()
    res = world.results()
    got_start = np.concatenate([r["dc_start"] for r in res])
    np.testing.assert_allclose(got_start, m_start, atol=1e-6)
    np.testing.assert_allclose(td.by_time(res, "dc_all"), m_all, atol=1e-6)
    for r in res:
        np.testing.assert_allclose(r["dc_new"], new_dc, atol=1e-6)


def test_dc_removal_matches_unsharded(world):
    xd, dc0, _ = _jax_dc()
    new_dc, z = iir.dc_removal_chunked(dc0, jnp.asarray(xd), alpha=0.9999)
    res = world.results()
    np.testing.assert_allclose(td.by_time(res, "dc_z"), np.asarray(z),
                               atol=1e-6)
    for r in res:
        np.testing.assert_allclose(r["dc_new2"], np.asarray(new_dc),
                                   atol=1e-6)


def test_composed_front_matches_jax_sharded(world):
    """Two streaming blocks of the composed front against JAX's
    sharded_composed_front on 8 forced CPU devices."""
    plan = decimator.build_plan(2_048_000, 30_000.0)
    h = decimator.compose_response(plan)
    hi, lo = mixer.split_freq(250_000.0, 2_048_000.0)
    xs = td.noisy_dc(2, 2 * 16384, 9)
    m = jmesh.make_mesh(channel=1, time=8)
    f = jax.jit(jax.shard_map(
        lambda x, ph, carry: jts.sharded_composed_front(
            x, ph, hi, lo, carry, h, plan.factor, "time"),
        mesh=m, in_specs=(P(None, "time"), P(), P()),
        out_specs=(P(), P(), P(None, "time")), check_vma=False))
    phase = jnp.zeros(2, jnp.float32)
    carry = jnp.zeros((2, len(h) - 1), jnp.complex64)
    res = world.results()
    for i in range(2):
        phase, carry, y = f(jnp.asarray(xs[:, i * 16384:(i + 1) * 16384]),
                            phase, carry)
        np.testing.assert_allclose(td.by_time(res, f"composed{i}"),
                                   np.asarray(y), atol=1e-5)
    for r in res:
        np.testing.assert_allclose(r["composed_phase"], np.asarray(phase),
                                   atol=1e-6)
        np.testing.assert_allclose(r["composed_carry"], np.asarray(carry),
                                   atol=1e-5)
