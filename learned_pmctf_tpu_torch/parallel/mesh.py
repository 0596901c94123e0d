"""Data parallelism over the ranks of torch.distributed.

Counterpart of learned_pmctf_tpu/parallel/mesh.py's "data" axis. There,
one process places a batch on a mesh and XLA's SPMD partitioner adds the
gradient all-reduce; here each rank is a process with its own device,
owns a contiguous block of the batch's rows (as ``P("data")`` splits axis
0), and the callers reduce explicitly: the train step all-reduces its
gradients as one flat bucket (``mean_over_ranks_``), the q-batched eval
gathers host floats to rank 0 (``gather_to_rank0``).

A group is started here (``spawn``: one process a rank, over
``tcp://127.0.0.1``), or joined where ``torchrun``
(``python -m torch.distributed.run``) has set one up in the environment.
CUDA ranks talk over NCCL, CPU ranks over gloo. The mesh's "spatial" axis
(width-sharded frames with halo exchanges) is not ported: ROADMAP.md
item A.17.
"""

from __future__ import annotations

import os
import socket
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

SPATIAL_ITEM = "A.17"


class DataMesh(NamedTuple):
    """The data axis (torch.distributed's default group) as this rank
    sees it."""

    rank: int
    world: int
    device: torch.device


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched_by_torchrun() -> bool:
    """Whether a launcher has set up this process's rank in the
    environment (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank_device(device="cuda", share: bool = False) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (made current), or the
    CPU. share: ranks beyond the visible cards share them round robin
    (only a group that never reduces over NCCL may share: NCCL refuses
    two ranks on one card); otherwise that raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    n, lr = torch.cuda.device_count(), local_rank()
    if lr >= n and not share:
        raise RuntimeError(f"local rank {lr} has no card: {n} visible")
    dev = torch.device("cuda", lr % n)
    torch.cuda.set_device(dev)
    return dev


def init_process_group(device="cuda", rank: Optional[int] = None,
                       world: Optional[int] = None, port: Optional[int] = None,
                       backend: Optional[str] = None) -> None:
    """Join the launcher's group (no rank given), or start rank `rank` of
    `world` at ``tcp://127.0.0.1:<port>``. backend: NCCL for CUDA, gloo
    for the CPU, unless given."""
    backend = backend or backend_for(device)
    if rank is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)


def make_mesh(spatial: int = 1, device="cuda", share: bool = False) -> DataMesh:
    """The data mesh of the joined group (a single rank outside one) on
    this rank's device (rank_device); spatial > 1 is not ported."""
    if spatial != 1:
        raise NotImplementedError(
            f"width-sharded spatial parallelism is not ported: ROADMAP.md item "
            f"{SPATIAL_ITEM}")
    return DataMesh(rank(), world_size(), rank_device(device, share))


def data_rows(n: int, rank: int, world: int) -> slice:
    """The contiguous block of a batch axis of `n` rows that `rank` of
    `world` owns; n must divide by world, as JAX's ``P("data")`` asks."""
    if n % world:
        raise ValueError(f"a batch of {n} rows does not divide over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, port, device, backend, args):
    init_process_group(device, rank, world, port, backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: Sequence = (), device="cuda",
          backend: Optional[str] = None) -> None:
    """Run ``fn(*args)`` in `nprocs` new processes, each a rank of one
    group at a free local port; returns when all have ended, and raises if
    one of them failed (torch.multiprocessing stops the others). `fn`
    must be picklable: a module-level function."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_entry, args=(fn, nprocs, free_port(), str(device), backend,
                                tuple(args)), nprocs=nprocs, join=True)


@torch.no_grad()
def _bucketed_(tensors: List[torch.Tensor], collective, group, divisor: int = 1):
    """Run `collective` (in place on one tensor) once a dtype over the
    tensors flattened into one bucket, and write the bucket, over
    `divisor`, back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if flat.is_cuda and dist.get_backend(group) == "gloo":
            host = flat.cpu()  # gloo reduces host memory
            collective(host, group=group)
            flat.copy_(host)
        else:
            collective(flat, group=group)
        if divisor != 1:
            flat /= divisor
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def mean_over_ranks_(tensors: List[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the group's ranks, in place,
    with one all-reduce a dtype."""
    _bucketed_(tensors, dist.all_reduce, group, dist.get_world_size(group))


def broadcast_from_rank0_(tensors: List[torch.Tensor], group=None) -> None:
    """Overwrite each tensor with rank 0's, in place, with one broadcast a
    dtype."""
    _bucketed_(tensors, lambda t, group: dist.broadcast(t, src=0, group=group), group)


def gather_to_rank0(obj, group=None) -> Optional[list]:
    """Every rank's picklable `obj`, in rank order, on rank 0; None on the
    other ranks."""
    world = dist.get_world_size(group)
    out = [None] * world if dist.get_rank(group) == 0 else None
    dist.gather_object(obj, out, dst=0, group=group)
    return out
