"""The (channel x time) mesh of ranks, and the local-slice helpers.

Port of pebblesdr_tpu/parallel/mesh.py.  One mesh with named axes

  channel — independent demod chains split over ranks as a pure map
  time    — one continuous IQ stream's time axis split over ranks, with the
            halo exchange of parallel/time_shard.py

built on ``torch.distributed.device_mesh.init_device_mesh`` (or a
``DeviceMesh`` over the first channel x time ranks of a larger world, as
JAX's make_mesh takes the first devices).  A rank runs the body of a JAX
shard_map on its own shard: where JAX places a global array with a
NamedSharding, the port's rank keeps its slice (``local_block``,
``local_plane``, ``shard_state``).

The backend follows the layout and is chosen when the world comes up
(comm.init_world): NCCL when every rank has a card of its own, gloo on the
CPU and when ranks share a card (then comm.py moves each payload to the
host and back itself, and counts those hops).  A mesh whose device is cuda
on a rank without a card raises; nothing falls back to another backend or
to the CPU.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

import torch

from pebblesdr_tpu_torch.parallel import comm

AXES = ("channel", "time")


class Mesh:
    """A named mesh of ranks.  shape: {axis: size}; device: this rank's
    torch device; backend: the world's ("gloo" | "nccl"); host_hops: True
    when payloads on the card cross gloo through the host; member: False on
    a rank of the world outside the mesh (it runs nothing of the mesh)."""

    def __init__(self, dm, names: tuple, sizes: tuple, device: torch.device,
                 backend: str):
        self.dm = dm
        self.names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.device = device
        self.backend = backend
        self.host_hops = backend == "gloo" and device.type == "cuda"
        self.member = dm is not None and dm.get_coordinate() is not None

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along axis (JAX's axis_index)."""
        return self.dm.get_local_rank(axis)

    def group(self, axis: str):
        return self.dm.get_group(axis)

    def peer(self, axis: str, i: int) -> int:
        """The global rank at position i along axis in this rank's group."""
        return comm.group_ranks(self.group(axis))[i]

    def describe(self) -> str:
        hops = " (payloads hop through the host)" if self.host_hops else ""
        return (" x ".join(f"{n} {s}" for n, s in self.shape.items())
                + f" on {self.device}, backend {self.backend}{hops}")


def device_for(device_type: str) -> torch.device:
    """This rank's device: the CPU, or the card comm.init_world gave it."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"mesh device must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device on every rank; "
                           "this rank has none")
    return torch.device("cuda", torch.cuda.current_device())


def _make(names: tuple, sizes: tuple, device_type: str | None) -> Mesh:
    n = 1
    for s in sizes:
        n *= s
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    if not comm.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs a world: call "
                               f"comm.init_world (or multihost.initialize) "
                               f"first")
        comm.init_world(1, 0, device_type)
    world = comm.world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    device = device_for(device_type)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    # the DeviceMesh's own device type only names the kind of its groups:
    # gloo groups are host groups even where the payloads live on a card
    dm_type = "cuda" if comm.backend() == "nccl" else "cpu"
    if world == n:
        dm = init_device_mesh(dm_type, sizes, mesh_dim_names=names)
    else:
        dm = DeviceMesh(dm_type, torch.arange(n).reshape(sizes),
                        mesh_dim_names=names)
    mesh = Mesh(dm, names, sizes, device, comm.backend())
    if comm.rank() == 0:
        print(f"mesh: {mesh.describe()}", file=sys.stderr, flush=True)
    return mesh


def make_mesh(channel: int = 1, time: int = 1,
              device_type: str | None = None) -> Mesh:
    """A (channel, time) mesh over the world's first channel * time ranks
    (the whole world when it has that many); device_type "cuda" (the
    default where a card is present) or "cpu".  Without a world, a one-rank
    mesh brings up a one-rank world itself."""
    return _make(AXES, (channel, time), device_type)


def make_axis_mesh(name: str, n: int, device_type: str | None = None) -> Mesh:
    """A one-axis mesh of n ranks (pipeline.stage_mesh's "stage")."""
    return _make((name,), (n,), device_type)


# ------------------------------------------------------------ local slices

def channel_range(mesh: Mesh, channels: int,
                  axes: tuple = ("channel",)) -> tuple[int, int]:
    """[c0, c1): this rank's channels when `channels` split evenly over the
    given mesh axes (major to minor)."""
    parts, pos = 1, 0
    for ax in axes:
        parts = parts * mesh.size(ax)
        pos = pos * mesh.size(ax) + mesh.index(ax)
    if channels % parts:
        raise ValueError(f"{channels} channels do not split evenly over "
                         f"{parts} ranks of {'/'.join(axes)}")
    per = channels // parts
    return pos * per, (pos + 1) * per


def time_range(mesh: Mesh, n: int, axis: str = "time") -> tuple[int, int]:
    """[t0, t1): this rank's contiguous piece of n samples along axis."""
    s = mesh.size(axis)
    if n % s:
        raise ValueError(f"{n} samples not divisible by the '{axis}' axis "
                         f"size {s}")
    i = mesh.index(axis)
    return i * (n // s), (i + 1) * (n // s)


def local_block(iq: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's [C_l, N_l] piece of a global [C, N] block (channels over
    'channel', time over 'time'), contiguous on the mesh's device."""
    c0, c1 = channel_range(mesh, iq.shape[0])
    t0, t1 = time_range(mesh, iq.shape[1])
    return iq[c0:c1, t0:t1].to(mesh.device).contiguous()


def local_plane(x_pk: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's [R/T, 2C_l] piece of a global lane-packed [R, 2C] plane
    (R rows split into T contiguous pieces, the rank's re and im lanes),
    contiguous on the mesh's device."""
    c = x_pk.shape[1] // 2
    c0, c1 = channel_range(mesh, c)
    t0, t1 = time_range(mesh, x_pk.shape[0])
    rows = x_pk[t0:t1]
    return torch.cat([rows[:, c0:c1], rows[:, c + c0:c + c1]],
                     dim=1).to(mesh.device).contiguous()


def tree_map(fn, tree: Any) -> Any:
    """fn over every tensor leaf of a nested dataclass / tuple / list /
    dict; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_state(state, mesh: Mesh, channels: int):
    """The rank's shard of a chain-state tree over 'channel', on the mesh's
    device.  channels: the global channel count C.  A leaf whose leading
    axis is k C (k <= 8; k = 2: the stacked [L; R] rails of stereo) keeps
    rows [b C + c0, b C + c1) of each of its k blocks; else a 2-D leaf
    whose second axis is k C (a time-major history in lane blocks, [re |
    im] or [mono | L-R]) keeps those lanes of each block; every other leaf
    is replicated.  The rule reads shapes only: a leaf that is not per
    channel but has such a shape would be cut too (none has at C = 1..64
    but the CTCSS squelch's 3-sample phase at C = 3; ShardedStep.init_state
    builds the rank's state directly)."""
    c0, c1 = channel_range(mesh, channels)

    def blocks(n: int) -> int:
        return n // channels if n and n % channels == 0 \
            and n // channels <= 8 else 0

    def place(leaf):
        if leaf.dim() >= 1 and blocks(leaf.shape[0]):
            leaf = torch.cat([leaf[b * channels + c0:b * channels + c1]
                              for b in range(blocks(leaf.shape[0]))])
        elif leaf.dim() == 2 and blocks(leaf.shape[1]):
            leaf = torch.cat([leaf[:, b * channels + c0:b * channels + c1]
                              for b in range(blocks(leaf.shape[1]))], dim=1)
        return leaf.to(mesh.device).contiguous()
    return tree_map(place, state)
