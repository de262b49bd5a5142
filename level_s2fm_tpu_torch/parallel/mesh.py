"""The active data group and the row sharding.

Counterpart of ``level_s2fm_tpu/parallel/mesh.py``. The JAX package
shards ray and track batches over a 1-D ``('data',)`` device mesh and
lets XLA insert the gradient all-reduce; here each rank is a process
(``distributed.launch``) or a thread (``distributed.launch_threads``)
that holds a ``DataGroup`` and keeps its own rows of a batch
(``shard_rows``). The active group is held per thread, as
``_ACTIVE_MESH`` / ``use_mesh`` hold the mesh, so that ranks can run as
threads of one process. With no active group every helper here is the
identity, and the one-rank path is the plain one bit for bit.

The collectives run on the group's backend: NCCL takes CUDA tensors;
gloo is for the CPU and for ranks that share one card, and a CUDA tensor
handed to it is staged through the host (copied out, reduced on the
host, copied back), on that backend only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the data-parallel group."""
    rank: int
    world: int
    pg: object                   # a torch.distributed ProcessGroup
    backend: str                 # "nccl" or "gloo"
    device: torch.device


_ACTIVE = threading.local()


def set_group(group: Optional[DataGroup]):
    _ACTIVE.group = group


def get_group() -> Optional[DataGroup]:
    return getattr(_ACTIVE, "group", None)


@contextlib.contextmanager
def use_group(group: Optional[DataGroup]):
    prev = get_group()
    set_group(group)
    try:
        yield group
    finally:
        set_group(prev)


def world_size() -> int:
    g = get_group()
    return 1 if g is None else g.world


# ----------------------------------------------------------------- collectives

#: gloo's pinned staging buffer, one per (rank, dtype), grown to the
#: largest tensor of 1 MiB or more staged so far (a fresh pageable copy of
#: the 64 MiB hash table gradient costs more than the copies themselves);
#: a collective uses it only until it returns
_HOST_BUFFERS = {}


def _staged(group: DataGroup, t: torch.Tensor):
    """(the tensor the backend reduces, whether it is a host copy)."""
    if group.backend != "gloo" or not t.is_cuda:
        return t, False
    if t.numel() * t.element_size() < 2 ** 20:
        return t.cpu(), True
    key = (group.rank, t.dtype)
    if key not in _HOST_BUFFERS or _HOST_BUFFERS[key].numel() < t.numel():
        _HOST_BUFFERS[key] = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
    host = _HOST_BUFFERS[key][:t.numel()].view(t.shape)
    host.copy_(t)
    return host, True


def all_reduce_(t: torch.Tensor, group: Optional[DataGroup] = None,
                op=None) -> torch.Tensor:
    """Reduce ``t`` over the ranks (a sum, or ``op``), in place; every
    rank gets the same bits."""
    import torch.distributed as dist
    group = group or get_group()
    if group is None:
        return t
    work, staged = _staged(group, t)
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM if op is None else op
    group.pg.allreduce([work], opts).wait()
    if staged:
        t.copy_(work)
    return t


def broadcast_(t: torch.Tensor, group: Optional[DataGroup] = None) -> torch.Tensor:
    """Overwrite ``t`` with rank 0's, in place."""
    group = group or get_group()
    if group is None:
        return t
    work, staged = _staged(group, t)
    group.pg.broadcast([work]).wait()
    if staged:
        t.copy_(work)
    return t


def all_gather(t: torch.Tensor, group: Optional[DataGroup] = None) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in rank order."""
    group = group or get_group()
    if group is None:
        return [t]
    work, staged = _staged(group, t.contiguous())
    outs = [torch.empty_like(work) for _ in range(group.world)]
    group.pg.allgather([outs], [work]).wait()
    return [o.to(t.device) for o in outs] if staged else outs


# ----------------------------------------------------------------- rows

def pad_rows(x: torch.Tensor, axis: int, n_pad: int) -> torch.Tensor:
    """The rows that pad ``x`` along ``axis``: copies of its last row.
    What they hold never matters (they are masked out of every sum and
    count); the tests replace this function by one that writes garbage."""
    last = x.narrow(axis, x.shape[axis] - 1, 1)
    shape = list(x.shape)
    shape[axis] = n_pad
    return last.expand(shape)


def shard_rows(x: torch.Tensor, axis: int = 0
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's rows of ``x`` along ``axis`` and their validity [rows]
    (False on the rows that pad the count up to a multiple of the world).
    Rank r keeps the r-th of ``world`` equal blocks. No active group:
    ``(x, None)``."""
    group = get_group()
    if group is None:
        return x, None
    n = x.shape[axis]
    per = -(-n // group.world)
    n_pad = per * group.world - n
    if n_pad:
        x = torch.cat([x, pad_rows(x, axis, n_pad).to(x.dtype)], dim=axis)
    lo = group.rank * per
    ok = torch.arange(lo, lo + per, device=x.device) < n
    return x.narrow(axis, lo, per), ok


@torch.no_grad()
def replicate(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Overwrite every tensor with rank 0's (one batched broadcast per
    dtype). No active group: unchanged."""
    group = get_group()
    if group is None or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        broadcast_(flat, group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors
