"""Collectives, host broadcasts and the rank launcher.

Counterpart of ``level_s2fm_tpu/parallel/distributed.py``. The design:
one rank per device, each with a full replica of the fields and poses;
ray and track rows are sharded over the ranks (``mesh.shard_rows``); each
loss term is a rank's local sum over the global count, and the gradients
are summed over the ranks (``all_reduce_grads``) before the optimizer
step, so that every rank applies the same update and the replicas stay
equal bit for bit. Host-side decisions (RANSAC, point acceptance,
pruning, the next view) are made on rank 0 and broadcast
(``broadcast_object`` / ``on_primary``); only rank 0 writes files.

Ranks are started by ``launch`` (one spawned process per entry of
``devices``, NCCL across cards, gloo on the CPU or for ranks that share
a card), by torchrun (``initialize_multihost`` reads its environment), or,
in the tests, by ``launch_threads`` (gloo ranks as threads of one
process). With no active group every function here is the identity.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import sys
import threading
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import mesh as pmesh

#: how long a collective may wait for the other ranks
TIMEOUT = datetime.timedelta(seconds=1800)


def _cpu_or_device(group: pmesh.DataGroup) -> torch.device:
    """Where a host value is staged for this backend's collectives."""
    return group.device if group.backend == "nccl" else torch.device("cpu")


def _new_group(rank: int, world: int, device, backend: str,
               init_method: str = "env://") -> pmesh.DataGroup:
    import torch.distributed as dist
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return pmesh.DataGroup(rank=rank, world=world, pg=dist.group.WORLD,
                           backend=backend, device=device)


def default_backend(devices: Sequence) -> str:
    """NCCL for one rank per card; gloo on the CPU and for ranks that
    share a card (NCCL refuses two ranks on one GPU)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def initialize_multihost(cpu: bool = False) -> Optional[pmesh.DataGroup]:
    """Join the group that torchrun's environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), where the JAX package reads
    ``JAX_COORDINATOR_ADDRESS``. Returns the group (not yet active), or
    None without that environment or with a world of 1."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    device = (torch.device("cpu") if cpu else
              torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))))
    return _new_group(rank, world, device, default_backend(
        [device] if cpu else [torch.device("cuda", i) for i in range(world)]))


def is_primary() -> bool:
    g = pmesh.get_group()
    return g is None or g.rank == 0


def rays_per_chip(global_rays: int) -> int:
    """The global ray batch divided over the ranks."""
    return max(global_rays // pmesh.world_size(), 1)


def barrier():
    g = pmesh.get_group()
    if g is not None:
        pmesh.all_reduce_(torch.zeros(1, device=_cpu_or_device(g)), g)


# ----------------------------------------------------------------- device values

def global_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over the ranks of detached tensors of one dtype, in ONE
    all-reduce. No active group: the tensors, detached."""
    tensors = [t.detach() for t in tensors]
    g = pmesh.get_group()
    if g is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pmesh.all_reduce_(flat, g)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def all_reduce_grads(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum gradients over the ranks: one all-reduce per dtype."""
    if pmesh.get_group() is None:
        return grads
    out = list(grads)
    by_dtype = {}
    for i, t in enumerate(grads):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        for i, s in zip(idx, global_sum([grads[i] for i in idx])):
            out[i] = s
    return out


def fetch_host(x: torch.Tensor, n: Optional[int] = None) -> np.ndarray:
    """The whole of a row-sharded tensor (``mesh.shard_rows`` along axis
    0) on the host, the padding dropped: an all-gather of every rank's
    rows. ``n`` is the unpadded row count. No active group:
    ``x[:n]`` as numpy."""
    if pmesh.get_group() is not None:
        x = torch.cat(pmesh.all_gather(x.detach()), 0)
    return x.detach().cpu().numpy()[:n]


# ----------------------------------------------------------------- host values

def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    g = pmesh.get_group()
    if g is None:
        return obj
    dev = _cpu_or_device(g)
    if g.rank == 0:
        buf = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        data = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(dev)
        size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    pmesh.broadcast_(size, g)
    if g.rank != 0:
        data = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    pmesh.broadcast_(data, g)
    if g.rank == 0:
        return obj
    return pickle.loads(data.cpu().numpy().tobytes())


def broadcast_host_array(x: np.ndarray) -> np.ndarray:
    """Rank 0's host array (poses, point updates) on every rank."""
    return np.asarray(broadcast_object(np.asarray(x)))


def on_primary(fn: Callable):
    """``fn()`` run on rank 0 only, its result broadcast to every rank.
    ``fn`` must run no collective."""
    return broadcast_object(fn() if is_primary() else None)


# ----------------------------------------------------------------- launchers

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, device, backend, port, fn, args, kwargs, results):
    import torch.distributed as dist
    if rank:
        # only rank 0 prints
        sys.stdout = open(os.devnull, "w")
    if torch.device(device).type == "cpu":
        # CPU ranks share the threads one process would take
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        group = _new_group(rank, world, device, backend,
                           f"tcp://127.0.0.1:{port}")
        with pmesh.use_group(group):
            out = fn(*args, **kwargs)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, backend: Optional[str] = None,
           args=(), kwargs=None) -> list:
    """Run ``fn(*args, **kwargs)`` in one spawned process per entry of
    ``devices`` (``"cuda:0"``, ``"cpu"``, ...), rank i on ``devices[i]``
    under its active group, and return every rank's result, in rank
    order. ``fn`` and its results must pickle. A rank that raises (or
    dies) stops every rank, and its traceback is raised here."""
    import multiprocessing as mp
    devices = [str(torch.device(d)) for d in devices]
    backend = backend or default_backend(devices)
    if backend == "nccl" and len(set(devices)) < len(devices):
        raise ValueError("NCCL runs one rank per GPU; ranks that share a "
                         "card need backend='gloo'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, len(devices), d, backend, port, fn, tuple(args),
                               dict(kwargs or {}), results))
             for r, d in enumerate(devices)]
    for p in procs:
        p.start()
    out: List = [None] * len(devices)
    done = set()
    try:
        while len(done) < len(devices):
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
            done.add(rank)
    finally:
        for p in procs:
            if len(done) < len(devices) and p.is_alive():
                p.terminate()
            p.join()
    return out


def launch_threads(fn: Callable, world: int, device="cpu",
                   timeout_s: float = 120.0) -> list:
    """Run ``fn(rank)`` in ``world`` threads of this process, each under
    its own gloo rank over one in-memory store; returns the results in
    rank order and raises the first failure. For the CPU tests: the
    ranks share the process, its imports and its compiled code."""
    import torch.distributed as dist
    store = dist.HashStore()
    timeout = datetime.timedelta(seconds=timeout_s)
    out: List = [None] * world
    errs: List = [None] * world

    def run(rank):
        try:
            pg = dist.ProcessGroupGloo(store, rank, world, timeout)
            group = pmesh.DataGroup(rank=rank, world=world, pg=pg,
                                    backend="gloo", device=torch.device(device))
            with pmesh.use_group(group):
                out[rank] = fn(rank)
        except BaseException as e:  # re-raised in the caller
            errs[rank] = e

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        if e is not None:
            raise e
    return out
