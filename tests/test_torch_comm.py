"""The port's collectives (pebblesdr_tpu_torch/parallel/comm.py), mesh
helpers and multi-node plumbing (parallel/multihost.py) in one 4-rank gloo
world on the CPU, against the JAX package's comm functions on a (1, 4)
mesh of the forced CPU devices: tests/test_comm.py, exact.  The world
runs as two "nodes" of two ranks (LOCAL_WORLD_SIZE=2), so global_mesh,
distribute_host_blocks and scaling_report run in a 2 x 2 world: the
tests/test_multiprocess.py analog (each rank keeps its node's channels and
its time piece, with no gather).  The backend choice (gloo on the CPU; a
cuda world without a card raises) is checked in this process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist as td
from pebblesdr_tpu.parallel import comm as jcomm
from pebblesdr_tpu.parallel import mesh as jmesh
from pebblesdr_tpu_torch.parallel import comm, mesh as mesh_mod

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 devices")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return td.World("comm", 4, tmp_path_factory.mktemp("comm"),
                    env={"LOCAL_WORLD_SIZE": "2"})


def jax_time4(fn, x, out_spec=P("time", None)):
    """fn under shard_map on a (1, 4) mesh, x split over 'time'."""
    m = jmesh.make_mesh(channel=1, time=4, devices=jax.devices()[:4])
    f = jax.jit(jax.shard_map(fn, mesh=m, in_specs=(P("time", None),),
                              out_specs=out_spec, check_vma=False))
    return np.asarray(f(x))


X4 = jnp.arange(4.0).reshape(4, 1)   # shard i holds value i


@pytest.mark.parametrize("name,fn", [
    ("shift_right", lambda x: jcomm.ring_shift_right(x, "time")),
    ("shift_left", lambda x: jcomm.ring_shift_left(x, "time")),
    ("rotate", lambda x: jcomm.ring_rotate(x, "time", 1)),
    ("bcast", lambda x: jcomm.broadcast_from(x, "time", 3)),
])
def test_neighbour_exchange_and_broadcast(world, name, fn):
    want = jax_time4(fn, X4).ravel()
    got = np.array([float(r[name].ravel()[0]) for r in world.results()])
    np.testing.assert_array_equal(got, want)


def test_reductions_and_gather(world):
    m = jmesh.make_mesh(channel=1, time=4, devices=jax.devices()[:4])
    f = jax.jit(jax.shard_map(
        lambda x: (jcomm.all_sum(x, "time"), jcomm.all_max(x, "time"),
                   jcomm.all_mean(x, "time"), jcomm.gather_axis(x, "time",
                                                                 0)),
        mesh=m, in_specs=(P("time", None),),
        out_specs=(P(), P(), P(), P(None, None)), check_vma=False))
    s, mx, mean, g = (np.asarray(a) for a in f(X4))
    for r in world.results():
        assert float(r["sum"].ravel()[0]) == float(s.ravel()[0]) == 6.0
        assert float(r["max"].ravel()[0]) == float(mx.ravel()[0]) == 3.0
        assert float(r["mean"].ravel()[0]) == float(mean.ravel()[0]) == 1.5
        np.testing.assert_array_equal(r["gather"].ravel(), g.ravel())
        np.testing.assert_array_equal(
            r["gather1"], np.repeat(np.arange(4.0), 3)[None].repeat(2, 0))


def test_reduce_scatter(world):
    want = jax_time4(lambda x: jcomm.reduce_scatter_sum(x, "time", 0),
                     jnp.ones((64, 4)))
    got = td.by_time(world.results(), "rs", axis=0)
    assert got.shape == (16, 4) and want.shape == (16, 4)
    np.testing.assert_array_equal(got, want)


def test_all_to_all(world):
    """comm.all_to_all = lax.all_to_all(split_axis=1, concat_axis=0)."""
    a = jnp.stack([jnp.arange(32.0).reshape(4, 8) + 100.0 * i
                   for i in range(4)]).reshape(16, 8)
    want = jax_time4(lambda x: jax.lax.all_to_all(x, "time", 1, 0,
                                                  tiled=True), a)
    got = td.by_time(world.results(), "a2a", axis=0)
    np.testing.assert_array_equal(got, want)


def test_complex_payloads(world):
    res = world.results()
    parts = [td.cplx((3, 5), i) for i in range(4)]
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r["cgather"],
                                      np.concatenate(parts, axis=1))
        np.testing.assert_array_equal(
            r["cshift"], parts[i - 1] if i else np.zeros((3, 5)))
        assert int(r["index"]) == i


def test_counters(world):
    """Two collectives counted by kind with their payload bytes, no host
    hop on the CPU."""
    for r in world.results():
        np.testing.assert_array_equal(r["counts"], [1, 40, 1, 24, 0])


def test_collective_stats(world):
    """scaling.collective_stats: one ring shift of 24 bytes, no hop."""
    for r in world.results():
        np.testing.assert_array_equal(r["cstats"], [1, 24, 1, 0])


@pytest.mark.parametrize("mode", ["AM", "USB", "FMS"])
def test_halo_accounting_matches_jax(mode):
    """scaling.halo_accounting equals the JAX package's for the same
    configuration; step_cost's bytes are K1's roofline bytes."""
    from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
    from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
    from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
    from pebblesdr_tpu.parallel import scaling as jscaling
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.parallel import scaling
    from pebblesdr_tpu_torch.utils import roofline
    kw = dict(sample_rate=2_048_000, frames_per_buffer=32768, channels=4)
    rx = Receiver(ReceiverConfig(mode=DemodMode[mode], **kw), "cpu")
    jrx = JaxReceiver(JaxConfig(mode=JaxMode[mode], **kw))
    got = scaling.halo_accounting(rx, 4)
    want = jscaling.halo_accounting(jrx, 4)
    assert {k: got[k] for k in want} == want
    assert got["composed_halo_complex_per_channel"] == rx.front.h.numel() - 1
    cost = scaling.step_cost(rx, 16384, 2)
    assert cost["bound_ms"] == roofline.k1_bound(rx.front, 16384, 2, 4,
                                                 16384, 0)["bound_ms"]
    assert cost["flops"] == roofline.k1_ops(rx.front.h.numel(), 16384, 2,
                                            rx.front.factor)


def test_measure_step():
    from pebblesdr_tpu_torch.parallel import scaling
    seen = []
    t = scaling.measure_step(lambda x: seen.append(x), (1,), steps=2)
    assert t >= 0 and len(seen) == 1 + 3 * 2       # warm-up + 3 x steps


def test_global_mesh_and_host_blocks(world):
    """Two nodes of two ranks: channel = nodes, time = ranks per node;
    each rank keeps its node's channels and its time piece."""
    for rank, r in enumerate(world.results()):
        np.testing.assert_array_equal(r["gm_shape"], [2, 2])
        np.testing.assert_array_equal(r["coord"], [rank // 2, rank % 2])
        t = rank % 2
        np.testing.assert_array_equal(
            r["dist"], r["node_block"][:, :, t * 128:(t + 1) * 128])


def test_scaling_report(world):
    for r in world.results():
        devices, hosts, sps, msps, wall = r["rep"]
        assert (devices, hosts) == (4, 2)
        assert sps > 0 and wall > 0
        assert msps == pytest.approx(sps / 1e6 / 4)
    # every rank reports the same aggregate
    assert len({float(r["rep"][2]) for r in world.results()}) == 1


def test_local_slices(world):
    """local_block / local_plane / shard_state on the (2, 2) mesh: the
    rank's channels and time piece of a global block and plane, its rows
    (and the stacked stereo rails' and lane blocks' rows) of a state."""
    iq = td.cplx((4, 64), 11)
    for rank, r in enumerate(world.results()):
        ci, ti = rank // 2, rank % 2
        mine = iq[2 * ci:2 * ci + 2, 32 * ti:32 * ti + 32]
        np.testing.assert_array_equal(r["block"], mine)
        np.testing.assert_array_equal(r["plane"], td.packed(mine))
        full, got = r["state_full"], r["state_mine"]
        assert got.size * 2 == full.size
        assert np.isin(got, full).all()


def test_cuda_world_needs_a_card():
    """No fallback: a cuda layout on a machine without a card raises; the
    CPU layout is gloo."""
    assert comm.backend_for("cpu", 8) == "gloo"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        comm.backend_for("cuda", 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mesh_mod.device_for("cuda")


def test_mesh_needs_a_world():
    if comm.is_initialized():
        pytest.skip("a world is up in this process")
    with pytest.raises(RuntimeError, match="needs a world"):
        mesh_mod.make_mesh(2, 2, "cpu")


def test_one_rank_mesh_brings_up_its_world():
    """make_mesh(1, 1) in a process with no world: a one-rank gloo world
    (an in-process store), every collective the identity."""
    if comm.is_initialized():
        pytest.skip("a world is up in this process")
    try:
        m = mesh_mod.make_mesh(1, 1, "cpu")
        assert (m.backend, m.member, m.host_hops) == ("gloo", True, False)
        x = torch.arange(6.0).reshape(2, 3)
        torch.testing.assert_close(comm.all_sum(x, m, "time"), x)
        torch.testing.assert_close(comm.gather_axis(x, m, "channel", 1), x)
        torch.testing.assert_close(comm.ring_shift_right(x, m, "time"),
                                   torch.zeros_like(x))
        torch.testing.assert_close(comm.ring_rotate(x, m, "time"), x)
    finally:
        comm.destroy_world()
