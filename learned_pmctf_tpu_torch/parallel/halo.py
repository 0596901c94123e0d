"""Width-sharded spatial parallelism: the halo exchanges, written by hand.

Counterpart of the "spatial" axis of learned_pmctf_tpu/parallel/mesh.py.
There, ``P(..., "spatial")`` splits a frame's width over devices and
XLA's SPMD partitioner inserts a halo exchange before every stencil.
Here each rank of a spatial group holds one contiguous block of columns,
all blocks of one width, and the models exchange halos explicitly: one
exchange a call of a width-coupled sub-network, at that sub-network's
receptive-field radius (``halo_call``):

1. widen the rank's block with ``r`` real neighbour columns on each
   inner side (none at a frame edge);
2. run the sub-network unchanged, with its own zero or reflect padding;
3. crop the ``r`` columns again, scaled to each output's resolution.

Only halo columns see the padding at an inner edge, so the kept columns
are exact; the overlap is computed twice. The rates are summed over the
group (``sum_over_width``), and what has no bound (the exact warp's
reference, SpyNet's pyramid) is gathered at full width
(``gather_width``). The radii and alignments of the port's sub-networks
are listed in README.md ("Spatial parallelism").

A tensor's place in the frame follows from its width alone: every rank
holds ``w`` of its columns, so at that resolution the frame is ``S * w``
wide and the rank's first column is ``index * w``. Subsampled planes
(subbands, MV latents, chroma) therefore need no bookkeeping, as long as
every resolution divides (``check_columns``).

Outside a ``spatial_shard`` scope every helper is the identity. Inside a
sub-network's call the scope is suspended, so nested helpers are too.
The exchange is one ``all_gather`` of every rank's edge strips on the
spatial group: the same call on every rank, so it cannot deadlock; a
halo wider than the neighbour's block takes columns from ranks further
out. Under gloo, CUDA tensors go through host copies; under NCCL they go
directly. The estimate path only: no gradient flows through an exchange.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class SpatialShard(NamedTuple):
    """A rank's place on the spatial axis: the group, the rank's index in
    it and its size. At a resolution where the rank holds ``w`` columns,
    its block starts at column ``index * w`` of a frame ``size * w``
    wide."""

    group: object
    index: int
    size: int


_SCOPE = [None]
_COUNTS = {"exchanges": 0, "bytes": 0, "seconds": 0.0}


def current() -> Optional[SpatialShard]:
    """The active shard, or None."""
    return _SCOPE[-1]


@contextlib.contextmanager
def spatial_shard(mesh):
    """Run the models inside on this rank's block of every frame's
    columns (parallel.mesh.frame_columns), split over the spatial axis of
    `mesh` (parallel.mesh.make_mesh). A spatial axis of one rank is no
    shard: the helpers stay the identity."""
    if mesh.spatial == 1:
        yield None
        return
    shard = SpatialShard(mesh.spatial_group, mesh.spatial_index, mesh.spatial)
    _SCOPE.append(shard)
    try:
        yield shard
    finally:
        _SCOPE.pop()


@contextlib.contextmanager
def suspended():
    """No shard inside: the tensors are whole (gathered) or widened."""
    _SCOPE.append(None)
    try:
        yield
    finally:
        _SCOPE.pop()


def counters(reset: bool = False) -> dict:
    """Exchanges since the last reset, the bytes this rank received in
    them and the host seconds they took (host copies and waits
    included)."""
    out = dict(_COUNTS)
    if reset:
        _COUNTS.update(exchanges=0, bytes=0, seconds=0.0)
    return out


def global_width(x, dim: int = -1) -> int:
    """The frame's width at x's resolution (x's own outside a shard)."""
    sh = current()
    return x.shape[dim] * (1 if sh is None else sh.size)


def check_columns(x, align: int, what: str, dim: int = -1) -> None:
    """Raise unless every rank's block of x's columns divides by `align`
    (the subsampling and checkerboard parity `what` needs)."""
    sh = current()
    if sh is not None and x.shape[dim] % align:
        raise ValueError(f"{what}: a shard {x.shape[dim]} columns wide does not divide by "
                         f"{align}, the alignment it needs")


def _collective(fn, t: torch.Tensor, group) -> torch.Tensor:
    """Run `fn(t)` (a collective on the group); under gloo a CUDA tensor
    goes through a host copy."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return fn(t.cpu()).to(t.device)
    return fn(t)


def _timed(fn):
    start = time.perf_counter()
    out = fn()
    _COUNTS["exchanges"] += 1
    _COUNTS["seconds"] += time.perf_counter() - start
    return out


def _all_gather_flat(flat: torch.Tensor, group, size: int) -> list:
    def gather(t):
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)
    out = _timed(lambda: _collective(gather, flat, group))
    _COUNTS["bytes"] += (size - 1) * flat.numel() * flat.element_size()
    return list(out)


def _extent(sh: SpatialShard, columns: int, left: int, right: int):
    """(left, right): the halo columns that a block `columns` wide gets
    when it asks for `left` and `right`; none beyond a frame edge."""
    return (min(left, sh.index * columns),
            min(right, (sh.size - 1 - sh.index) * columns))


def _widen_all(items):
    """items: (x, left, right, dim) each, the halo asked for (the same on
    every rank); returns the widened tensors (edges clipped as _extent
    gives them) after one all_gather of every rank's edge strips. An
    item's x may be None."""
    sh = current()
    live = [(i, it) for i, it in enumerate(items) if it[0] is not None]
    if not live:
        return [it[0] for it in items]
    # each rank sends its first min(right, w) columns (its left
    # neighbours' right halo) and its last min(left, w) (its right
    # neighbours' left halo): the same sizes on every rank; a halo wider
    # than w takes whole blocks of ranks further out
    strips, specs = [], []
    dtype = live[0][1][0].dtype
    for _, (x, left, right, dim) in live:
        w = x.shape[dim]
        head = x.narrow(dim, 0, min(right, w))
        tail = x.narrow(dim, w - min(left, w), min(left, w))
        specs.append((head.shape, tail.shape))
        strips += [head, tail]
        dtype = torch.promote_types(dtype, x.dtype)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in strips])
    parts = _all_gather_flat(flat, sh.group, sh.size)
    out = [it[0] for it in items]
    pos = 0
    for (i, (x, left, right, dim)), (head_shape, tail_shape) in zip(live, specs):
        w = x.shape[dim]
        n_head, n_tail = math.prod(head_shape), math.prod(tail_shape)
        get_left, get_right = _extent(sh, w, left, right)

        def strip(rank, first, n, shape):
            return parts[rank][pos + first:pos + first + n].view(shape).to(x.dtype)

        pieces, need, rank = [x], get_left, sh.index - 1
        while need > 0:
            take = min(need, w)
            tail = strip(rank, n_head, n_tail, tail_shape)
            pieces.insert(0, tail.narrow(dim, tail.shape[dim] - take, take))
            need, rank = need - take, rank - 1
        need, rank = get_right, sh.index + 1
        while need > 0:
            take = min(need, w)
            pieces.append(strip(rank, 0, n_head, head_shape).narrow(dim, 0, take))
            need, rank = need - take, rank + 1
        out[i] = torch.cat(pieces, dim=dim) if len(pieces) > 1 else x
        pos += n_head + n_tail
    return out


def widen(x, left: int, right: int, dim: int = -1):
    """x with up to `left` columns of the ranks to its left and `right` of
    those to its right, fewer at a frame edge, by one exchange.
    Every rank of the group must ask for the same `left` and `right`."""
    if current() is None:
        return x
    return _widen_all([(x, left, right, dim % x.dim())])[0]


def _map_tensors(fn, out):
    if torch.is_tensor(out):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_map_tensors(fn, o) for o in out)
    if isinstance(out, dict):
        return {k: _map_tensors(fn, v) for k, v in out.items()}
    return out


def _ratio(a: int, b: int, what: str) -> int:
    if a % b:
        raise ValueError(f"halo: {what}")
    return a // b


def halo_call(fn, *xs, r: int, align: int = 1, dim: int = -1):
    """``fn(*xs)`` on this rank's block: the inputs widened by a halo of
    radius `r` (rounded up to a multiple of `align`; both in columns of
    the first input that is not None, the others' halos scaled to their
    widths), fn run with the shard suspended, every tensor it returns
    cropped to the block again at its own resolution. Outside a shard:
    ``fn(*xs)``."""
    sh = current()
    if sh is None:
        return fn(*xs)
    ref = next(x for x in xs if x is not None)
    dim = dim % ref.dim()
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs):
        raise RuntimeError("spatial sharding runs the estimate path: no gradient flows "
                           "through a halo exchange")
    w0 = ref.shape[dim]
    # the coarsest input's halo must be whole columns
    step = align
    for x in xs:
        if x is not None and x.shape[dim] < w0:
            step = math.lcm(step, _ratio(w0, x.shape[dim], "inputs of other resolutions"))
    r = -(-r // step) * step
    left, right = _extent(sh, w0, r, r)
    wide = _widen_all([(x, 0, 0, dim) if x is None else
                       (x, r * x.shape[dim] // w0, r * x.shape[dim] // w0, dim) for x in xs])
    with suspended():
        out = fn(*wide)
    ww = w0 + left + right

    def cut(y):
        wy = y.shape[dim]
        if (left * wy) % ww or (w0 * wy) % ww:
            raise ValueError(f"halo: an output {wy} wide of an input {ww} wide does not crop "
                             f"at a halo of {left} (align the halo to the output's stride)")
        return y.narrow(dim, left * wy // ww, w0 * wy // ww)
    return _map_tensors(cut, out)


def gather_width(x, dim: int = -1):
    """The whole frame's width of x on every rank, by one exchange."""
    sh = current()
    if sh is None:
        return x
    parts = _all_gather_flat(x.contiguous().reshape(-1), sh.group, sh.size)
    return torch.cat([p.view(x.shape) for p in parts], dim=dim)


def own_columns(x, dim: int = -1):
    """This rank's block of a tensor that holds the frame's whole width."""
    sh = current()
    if sh is None:
        return x
    w = _ratio(x.shape[dim], sh.size, "a whole width over the ranks")
    return x.narrow(dim, sh.index * w, w)


def sum_over_width(t):
    """t summed over the spatial group (a rate, a squared error), by one
    exchange; every rank gets the sum."""
    sh = current()
    if sh is None:
        return t

    def reduce(v):
        v = v.clone()
        dist.all_reduce(v, group=sh.group)
        return v
    out = _timed(lambda: _collective(reduce, t, sh.group))
    _COUNTS["bytes"] += (sh.size - 1) * t.numel() * t.element_size()
    return out


def mean_over_width(t):
    """The frame's mean of t (a block of each rank's plane)."""
    sh = current()
    if sh is None:
        return torch.mean(t)
    return sum_over_width(t.sum()) / (t.numel() * sh.size)
