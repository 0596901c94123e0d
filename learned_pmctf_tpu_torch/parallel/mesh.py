"""The (data x spatial) mesh over the ranks of torch.distributed.

Counterpart of learned_pmctf_tpu/parallel/mesh.py. There, one process
places a batch on a mesh and XLA's SPMD partitioner adds the collectives;
here each rank is a process with its own device. Along "data" a rank owns
a contiguous block of the batch's rows (as ``P("data")`` splits axis 0),
and the callers reduce explicitly: the train step all-reduces its
gradients as one flat bucket (``mean_over_ranks_``), the q-batched eval
gathers host floats to rank 0 (``gather_to_rank0``). Along "spatial" a
rank owns a contiguous block of a frame's columns (``frame_columns``, as
``P(..., "spatial")`` splits the width), and the models exchange halos
on the spatial group by hand (parallel/halo.py).

A group is started here (``spawn``: one process a rank, over
``tcp://127.0.0.1``), or joined where ``torchrun``
(``python -m torch.distributed.run``) has set one up in the environment.
CUDA ranks talk over NCCL, CPU ranks over gloo. The W ranks of a group
form a (W / S) x S grid in rank order, as JAX's
``np.asarray(devices).reshape(W // S, S)``: rank r sits at data index
r // S and spatial index r % S.
"""

from __future__ import annotations

import os
import socket
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

class DataMesh(NamedTuple):
    """The (data x spatial) mesh as this rank sees it: its rank and the
    group's size, its device, the spatial axis' size and the groups of
    the rank's row (data) and column (spatial) of the grid. With
    spatial 1 the data axis is the whole group (data_group None: the
    default group)."""

    rank: int
    world: int
    device: torch.device
    spatial: int = 1
    data_group: object = None
    spatial_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def data_size(self) -> int:
        return self.world // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial


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
    """The (data x spatial) mesh of the joined group (a single rank
    outside one) on this rank's device (rank_device). With spatial > 1
    every rank creates every row and column group, in the same order, as
    ``dist.new_group`` asks; the group's size must divide by `spatial`."""
    r, w = rank(), world_size()
    if spatial < 1 or w % spatial:
        raise ValueError(f"a group of {w} ranks does not divide over a spatial axis of "
                         f"{spatial}")
    data_group = spatial_group = None
    if spatial > 1:
        for d in range(w // spatial):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if r // spatial == d:
                spatial_group = g
        for s in range(spatial):
            g = dist.new_group(list(range(s, w, spatial)))
            if r % spatial == s:
                data_group = g
    return DataMesh(r, w, rank_device(device, share), spatial, data_group, spatial_group)


def data_rows(n: int, rank: int, world: int) -> slice:
    """The contiguous block of a batch axis of `n` rows that `rank` of
    `world` owns; n must divide by world, as JAX's ``P("data")`` asks."""
    if n % world:
        raise ValueError(f"a batch of {n} rows does not divide over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def frame_columns(width: int, index: int, spatial: int, align: int = 1) -> slice:
    """The contiguous block of a frame `width` columns wide that spatial
    index `index` of `spatial` owns (the width's counterpart of
    data_rows); every block's width must divide by `align`, the
    alignment of the model's subsampling (PMCTF.spatial_align)."""
    if width % spatial or (width // spatial) % align:
        raise ValueError(f"a frame {width} wide over {spatial} ranks gives blocks of "
                         f"{width / spatial:g} columns, which do not divide by the "
                         f"alignment {align}")
    per = width // spatial
    return slice(index * per, (index + 1) * per)


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
