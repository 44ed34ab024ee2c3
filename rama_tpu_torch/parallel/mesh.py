"""The (data, model) grid of ranks — the port of rama_tpu/parallel/mesh.py.

JAX drives a ("data", "model") mesh of local devices from one process with
shard_map. The port runs one process a rank over torch.distributed (the
PyTorch idiom, and the only form that scales: the step is host-bound, so
one Python thread launching every rank's kernels would multiply it by tp).
The world's ranks form a (dp, tp) grid, rank = d * tp + t: replica d's
tensor-parallel shards are ranks d * tp .. d * tp + tp - 1 (its model
group), and shard t of every replica forms a data group. A rank's collectives
run over its two groups only: the model group's all-reduces and the vocab
all-gather inside the forward, the data group's gather of a tick's tokens.

The collectives' backend is chosen once, from the devices (`backend_for`):
NCCL where every rank has a GPU of its own, gloo on the CPU or where ranks
share a card (NCCL refuses two ranks on one GPU). Host-side control
(parallel/distributed.py `broadcast_step`) always rides the default gloo
group.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from rama_tpu_torch.parallel.distributed import group_timeout

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass
class Mesh:
    """This rank's view of the (dp, tp) grid: `ranks` the grid itself (rank
    at [d, t]), this rank's coordinates, its device, and its model and data
    groups (None where the axis has one rank, or outside a process group)."""

    ranks: np.ndarray
    rank: int
    device: torch.device
    backend: str | None
    model_group: object | None
    data_group: object | None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.ranks.shape[0], MODEL_AXIS: self.ranks.shape[1]}

    @property
    def dp(self) -> int:
        return self.ranks.shape[0]

    @property
    def tp(self) -> int:
        return self.ranks.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp


def backend_for(devices) -> str:
    """The model and data groups' backend: NCCL where every rank has a GPU
    of its own, gloo on the CPU or where ranks share a card."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _default_devices(n: int) -> list:
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise ValueError(f"{n} ranks need {n} visible GPUs, one a rank; {visible} are "
                         f"visible (list the devices to share a card or to run on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(tp_size: int | None = None, dp_size: int | None = None, devices=None) -> Mesh:
    """The (dp, tp) grid over the world's ranks, this rank's coordinates,
    device and groups (rama_tpu's make_mesh: by default every rank goes to
    tensor parallelism; pass dp_size to carve replicas).

    `devices`: one torch.device a rank, in rank order, as JAX's `devices`
    is one device a mesh position. By default rank r gets visible GPU r, and
    fewer GPUs than ranks is refused. Ranks share a card, or run on the CPU,
    only when the caller lists them so. Outside a process group the world is
    one rank. Every rank calls this, in the same order (group creation is
    collective). On a GPU the rank's device becomes its current one: the
    kernels launch on the current device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _default_devices(world))
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a world of {world} ranks")
    if tp_size is None:
        tp_size = world // (dp_size or 1)
    if dp_size is None:
        dp_size = world // tp_size
    if dp_size * tp_size != world:
        raise ValueError(f"dp {dp_size} x tp {tp_size} != {world} ranks")
    ranks = np.arange(world).reshape(dp_size, tp_size)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend, model_group, data_group = None, None, None
    if world > 1:
        backend = backend_for(devices)
        for row in ranks:                      # model groups, replica by replica
            g = dist.new_group(row.tolist(), backend=backend, timeout=group_timeout())
            if rank in row:
                model_group = g
        for col in ranks.T:                    # data groups, shard by shard
            g = dist.new_group(col.tolist(), backend=backend, timeout=group_timeout())
            if rank in col:
                data_group = g
        model_group = model_group if tp_size > 1 else None
        data_group = data_group if dp_size > 1 else None
    return Mesh(ranks=ranks, rank=rank, device=device, backend=backend,
                model_group=model_group, data_group=data_group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks, in x's dtype, in place (JAX's
    psum); x itself with no group."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's shards of x joined along `dim` in rank order (JAX's
    all_gather(..., tiled=True)); x itself with no group."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
