"""Process-group set-up and the primary's broadcast — the single-host part of
rama_tpu/parallel/distributed.py.

The serving model is JAX's multi-host one, on one host: rank 0 runs the
HTTP server, tokenization and every scheduling decision; every other rank
runs `Engine.follow()`, replaying the same sequence of device calls. Before
each one rank 0 broadcasts a header and the call's host arrays (tokens,
positions, sampling parameters, slot keys, page tables) with
`broadcast_step`, over the default group, which is gloo on the host even
where the model's collectives use NCCL. Device state (weights, caches)
never crosses ranks outside the model's own collectives. JAX's
`make_global` has no counterpart: each rank slices its own shard
(parallel/tp.py).

A rank that fails ends the job: its peers' next collective raises (a dead
peer at once, a hung one after the group's timeout).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

# every group's timeout: a collective with a hung peer raises after it (a
# dead peer's at once)
GROUP_TIMEOUT_S = 120


def group_timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=GROUP_TIMEOUT_S)


def init_distributed(rank: int, world: int, port: int) -> bool:
    """Join a world of `world` ranks on this host: a TCP store on 127.0.0.1
    at `port` (rank 0 serves it), the default group on gloo, with an
    explicit timeout. Returns True when the world has more than one rank
    (a world of one sets nothing up)."""
    if world <= 1:
        return False
    store = dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0,
                          timeout=group_timeout())
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=group_timeout())
    return True


def shutdown_distributed() -> None:
    """Leave the world: a barrier, so every rank is past its last
    collective, then the groups torn down, also when the barrier raises (a
    peer gone), which it then re-raises. A process that exits with its
    group alive can abort in the store's or gloo's threads (rank 0 serves
    the store). Nothing outside a process group."""
    if dist.is_initialized():
        try:
            dist.barrier()
        finally:
            dist.destroy_process_group()


def is_primary() -> bool:
    """True on the rank that fronts tokenization, scheduling and HTTP."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def broadcast_step(arrays: list[np.ndarray]) -> list[np.ndarray]:
    """Broadcast host arrays from rank 0 to every rank, packed into one byte
    buffer (one collective a call). Every rank passes arrays of the SAME
    shapes and dtypes; the other ranks' values are ignored and their
    returned arrays hold rank 0's. The identity in a world of one rank."""
    if world_size() == 1:
        return arrays
    arrays = [np.ascontiguousarray(a) for a in arrays]
    flat = np.concatenate([a.view(np.uint8).ravel() for a in arrays]) if arrays else \
        np.zeros(0, np.uint8)
    buf = torch.from_numpy(flat)
    dist.broadcast(buf, src=0)
    if dist.get_rank() == 0:
        return arrays
    out, off = [], 0
    raw = buf.numpy()
    for a in arrays:
        out.append(raw[off:off + a.nbytes].view(a.dtype).reshape(a.shape).copy())
        off += a.nbytes
    return out
