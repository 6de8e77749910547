"""Multi-node execution: the world from a launcher, and input distribution.

Port of pebblesdr_tpu/parallel/multihost.py.  A wideband capture split over
N nodes, each feeding its local ranks: time sharded inside a node (its
halos cross the node's own links), channels over nodes (they cross nodes
only at input distribution, never per block).  The device-side sharding
lives in parallel/time_shard.py and parallel/channelizer.py and does not
care how many nodes there are.

``initialize`` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and is a no-op for one rank.
"""

from __future__ import annotations

import os
import time

import torch

from pebblesdr_tpu_torch.parallel import comm
from pebblesdr_tpu_torch.parallel import mesh as mesh_mod


def initialize(device_type: str | None = None) -> None:
    """Bring this process into the launcher's world (torchrun's env://;
    the backend chosen from the layout, comm.backend_for); nothing at world
    size 1 or once a world is up."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or comm.is_initialized():
        return
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    comm.init_world(world, int(os.environ["RANK"]), device_type)


def ranks_per_node() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              comm.world_size() if comm.is_initialized()
                              else 1))


def global_mesh(channel: int | None = None, time: int | None = None,
                device_type: str | None = None):
    """A mesh over every rank of every node.  Defaults: time = ranks per
    node (so time halos stay inside a node), channel = the number of
    nodes."""
    n = comm.world_size() if comm.is_initialized() else 1
    if time is None:
        time = ranks_per_node()
    if channel is None:
        channel = n // time
    return mesh_mod.make_mesh(channel=channel, time=time,
                              device_type=device_type)


def distribute_host_blocks(mesh, local_iq_ri: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the global [C, 2, N] float32 input, from its
    node's block: each node holds the channels of its mesh rows
    (local_iq_ri [C_node, 2, N], node h feeding channels [h C_node, (h+1)
    C_node)); the rank keeps its channels of them and its time piece, on
    its device, with no gather."""
    nodes = max(1, comm.world_size() // ranks_per_node())
    rows_per_node = max(1, mesh.size("channel") // nodes)
    c_rank = local_iq_ri.shape[0] // rows_per_node
    i = mesh.index("channel") % rows_per_node
    t0, t1 = mesh_mod.time_range(mesh, local_iq_ri.shape[2])
    return local_iq_ri[i * c_rank:(i + 1) * c_rank, :, t0:t1].to(
        mesh.device).contiguous()


def scaling_report(step_fn, state, params, iq, steps: int = 10,
                   mesh=None) -> dict:
    """Aggregate samples/s of step_fn(state, params, iq) on this rank's
    shard iq [C_l, 2, N_l] (one warm-up call, then `steps` timed): CUDA
    events on a card, the host clock on the CPU; with a mesh the samples
    summed and the wall time the max over its ranks, so every rank returns
    the same dict."""
    state, out = step_fn(state, params, iq)
    on_card = iq.is_cuda
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, out = step_fn(state, params, iq)
    if on_card:
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        dt = time.perf_counter() - t0
    c, _, n = iq.shape
    samples = torch.tensor([float(c * n * steps)])
    wall = torch.tensor([dt])
    ranks = 1
    if mesh is not None:
        for ax in mesh.names:
            samples = comm.all_sum(samples, mesh, ax)
            wall = comm.all_max(wall, mesh, ax)
            ranks *= mesh.size(ax)
    dt = float(wall[0])
    return {
        "devices": ranks,
        "hosts": max(1, ranks // ranks_per_node()),
        "samples_per_s": float(samples[0]) / dt,
        "msps_per_device": float(samples[0]) / dt / 1e6 / ranks,
        "wall_s": dt,
    }
