"""comm: the one module of the port that calls torch.distributed.

Port of pebblesdr_tpu/parallel/comm.py.  The rest of the package never calls
a collective itself:

  init_world / destroy_world          — the world, its backend chosen from
      the layout (backend_for): NCCL when every rank has a card of its own,
      gloo on the CPU and when ranks share a card
  ring_shift_right / ring_shift_left  — neighbour exchange on
      batch_isend_irecv (the halo of parallel.time_shard); an edge rank
      receives zeros, as from JAX's ppermute
  ring_rotate                         — cyclic rotation
  all_sum / all_max / all_mean        — all_reduce
  gather_axis                         — all_gather_into_tensor, tiled
  broadcast_from, reduce_scatter_sum, all_to_all
  axis_index

Every function takes the mesh (parallel.mesh.Mesh) and the axis name, and
runs on this rank's shard.  Complex payloads travel as their real view.
Where ranks share a card over gloo (mesh.host_hops), each payload is copied
to the host and back here; ``counters`` counts those hops and their bytes,
and every collective by kind with its payload bytes (parallel/scaling.py
reads them).
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

# collectives by kind (calls, payload bytes sent by this rank) and the
# host hops of payloads on a card that cross gloo (count, bytes)
counters = {"calls": {}, "bytes": {}, "hops": 0, "hop_bytes": 0}

_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def reset_counters() -> None:
    counters["calls"].clear()
    counters["bytes"].clear()
    counters["hops"] = counters["hop_bytes"] = 0


# ------------------------------------------------------------------- world

def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size()


def rank() -> int:
    return dist.get_rank()


def backend() -> str:
    return str(dist.get_backend())


def group_ranks(group) -> list[int]:
    return dist.get_process_group_ranks(group)


def backend_for(device_type: str, local_world: int) -> str:
    """The backend of a layout: gloo on the CPU; on the card NCCL when each
    of the node's local_world ranks has a card of its own, else gloo (NCCL
    refuses two ranks on one device)."""
    if device_type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda world needs a CUDA device on every rank; "
                           "this rank has none")
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def init_world(world: int, rank_: int, device_type: str = "cuda",
               addr: str | None = None) -> str:
    """Bring this rank into a world of `world` ranks at addr
    ("tcp://host:port"; None: torchrun's env://, or an in-process store for
    a one-rank world), the backend chosen by backend_for; on the card the
    rank takes its node-local card (LOCAL_RANK, or rank mod the node's
    ranks), or card (rank mod cards) when ranks share cards.  Returns the
    backend and prints it once (rank 0, stderr)."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank_ % local_world))
    be = backend_for(device_type, local_world)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if addr is None and world == 1:
        dist.init_process_group(be, store=dist.HashStore(), world_size=1,
                                rank=0)
    else:
        dist.init_process_group(be, init_method=addr or "env://",
                                world_size=world, rank=rank_)
    if rank_ == 0:
        shared = " (ranks share a card: payloads hop through the host)" \
            if be == "gloo" and device_type == "cuda" else ""
        print(f"world: {world} ranks, {local_world} per node, {device_type}, "
              f"backend {be}{shared}", file=sys.stderr, flush=True)
    return be


def destroy_world() -> None:
    if is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------- payload

def _count(kind: str, x: torch.Tensor) -> None:
    counters["calls"][kind] = counters["calls"].get(kind, 0) + 1
    counters["bytes"][kind] = (counters["bytes"].get(kind, 0)
                               + x.numel() * x.element_size())


def _hop(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    counters["hops"] += 1
    counters["hop_bytes"] += t.numel() * t.element_size()
    return t.to(device)


def _out(mesh, x: torch.Tensor) -> torch.Tensor:
    """x as it crosses the wire: its real view, on the host where ranks
    share a card over gloo."""
    t = torch.view_as_real(x) if x.is_complex() else x
    t = t.contiguous()
    if mesh.host_hops and t.is_cuda:
        t = _hop(t, torch.device("cpu"))
    return t


def _in(mesh, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received wire tensor back in like's dtype, on like's device."""
    if t.device != like.device:
        t = _hop(t, like.device)
    return torch.view_as_complex(t.contiguous()) if like.is_complex() else t


# ---------------------------------------------------------------- collectives

def axis_index(mesh, axis: str) -> int:
    return mesh.index(axis)


def _permute(x: torch.Tensor, mesh, axis: str, pairs: list) -> torch.Tensor:
    """Each (src, dst) pair sends src's x to dst; a rank that receives
    nothing gets zeros (JAX's ppermute)."""
    _count("ppermute", x)
    me = mesh.index(axis)
    group = mesh.group(axis)
    ranks = group_ranks(group)
    t = _out(mesh, x)
    got = torch.zeros_like(t)
    ops = []
    for src, dst in pairs:
        if src == me and dst != me:
            ops.append(dist.P2POp(dist.isend, t, ranks[dst], group))
        if dst == me and src != me:
            ops.append(dist.P2POp(dist.irecv, got, ranks[src], group))
        if src == me and dst == me:
            got = t.clone()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _in(mesh, got, x)


def ring_shift_right(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every shard receives its LEFT neighbour's x (shard 0 receives
    zeros)."""
    n = mesh.size(axis)
    return _permute(x, mesh, axis, [(i, i + 1) for i in range(n - 1)])


def ring_shift_left(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every shard receives its RIGHT neighbour's x (the last shard
    receives zeros)."""
    n = mesh.size(axis)
    return _permute(x, mesh, axis, [(i + 1, i) for i in range(n - 1)])


def ring_rotate(x: torch.Tensor, mesh, axis: str,
                shift: int = 1) -> torch.Tensor:
    """Cyclic rotation: shard i's x goes to shard (i + shift) mod n."""
    n = mesh.size(axis)
    return _permute(x, mesh, axis, [(i, (i + shift) % n) for i in range(n)])


def _reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    _count("all_reduce", x)
    t = _out(mesh, x).clone()
    dist.all_reduce(t, op=op, group=mesh.group(axis))
    return _in(mesh, t, x)


def all_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def all_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return all_sum(x, mesh, axis) / mesh.size(axis)


def gather_axis(x: torch.Tensor, mesh, axis: str, dim: int = 0
                ) -> torch.Tensor:
    """Every shard's x concatenated along dim in axis order (tiled
    all-gather)."""
    _count("all_gather", x)
    s = mesh.size(axis)
    xm = x.reshape(1) if x.dim() == 0 else x.movedim(dim, 0)
    t = _out(mesh, xm)
    out = torch.empty((s * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather(out, t, group=mesh.group(axis))
    g = _in(mesh, out, xm)
    return g if x.dim() == 0 else g.movedim(0, dim)


def broadcast_from(x: torch.Tensor, mesh, axis: str, src: int = 0
                   ) -> torch.Tensor:
    """Every shard gets shard src's x."""
    _count("broadcast", x)
    t = _out(mesh, x).clone()
    dist.broadcast(t, src=mesh.peer(axis, src), group=mesh.group(axis))
    return _in(mesh, t, x)


def reduce_scatter_sum(x: torch.Tensor, mesh, axis: str, dim: int = 0
                       ) -> torch.Tensor:
    """The sum over shards, its dim cut into contiguous pieces, shard i
    keeping piece i."""
    _count("reduce_scatter", x)
    s = mesh.size(axis)
    xm = x.movedim(dim, 0)
    if xm.shape[0] % s:
        raise ValueError(f"reduce_scatter of {xm.shape[0]} rows over {s} "
                         f"shards")
    t = _out(mesh, xm)
    out = torch.empty((t.shape[0] // s,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _reduce_scatter(out, t, group=mesh.group(axis))
    return _in(mesh, out, xm).movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's lax.all_to_all: x cut into n pieces along split_dim, piece j
    sent to shard j, the pieces received concatenated along concat_dim in
    shard order."""
    _count("all_to_all", x)
    s = mesh.size(axis)
    if x.shape[split_dim] % s:
        raise ValueError(f"all_to_all of {x.shape[split_dim]} along dim "
                         f"{split_dim} over {s} shards")
    pieces = torch.stack(x.chunk(s, dim=split_dim))          # [s, ...]
    t = _out(mesh, pieces)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.group(axis))
    got = _in(mesh, out, pieces)
    return torch.cat(list(got.unbind(0)), dim=concat_dim)


def tree_broadcast_from(tree, mesh, axis: str, src: int):
    """broadcast_from over every tensor leaf of a state tree."""
    from pebblesdr_tpu_torch.parallel.mesh import tree_map
    return tree_map(lambda a: broadcast_from(a, mesh, axis, src), tree)
