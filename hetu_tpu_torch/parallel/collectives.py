"""Collective communication over ``torch.distributed`` (twin of
``hetu_tpu/parallel/collectives.py``, the reference's MPI+NCCL bridge).

The JAX package writes per-device code inside ``shard_map`` and names a
mesh axis; here every process is already one device's program, and each
wrapper takes the axis's process group instead (``group``: None for the
default group, a ``ProcessGroup``, or a :class:`CommGroup`).  The caller
initialises the process group (gloo on the CPU, NCCL on the card).

Every wrapper is functional: it returns a new tensor and leaves its input
alone.  ``all_reduce`` with ``op="sum"`` (and the mean built on it) and
``all_gather`` are differentiable: the backward of a sum over ranks is a
sum over ranks of the cotangent, and the backward of a gather is the
reduce-scatter of the cotangent, so differentiating a replicated loss on
every rank counts each rank's contribution once per rank, and the
executor's mean over ranks of the parameter gradients divides that back
out (``parallel/batch_axis.py``).

Only calls that the torch releases this port runs on all have are used
(``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``batch_isend_irecv``); newer releases mark the
first two deprecated, which is silenced where they are called.
``reduce_scatter_flat`` / ``all_gather_flat`` move the flat ``(dp,
width)`` slabs of the ZeRO update (``parallel/zero.py``); its GSPMD
layouts ``slab_spec`` / ``replicated_spec`` are not ported.
"""
from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist

#: capacity of one flattened gradient bucket of :func:`all_reduce_mean_buckets`
BUCKET_BYTES = 25 * 2 ** 20

_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _pg(group):
    """The process group of ``group`` (None: the default group)."""
    return group.group if isinstance(group, CommGroup) else group


def _size(group):
    return dist.get_world_size(_pg(group))


def _global(group, rank):
    """The global rank of ``rank`` of ``group``."""
    pg = _pg(group)
    return rank if pg is None else dist.get_global_rank(pg, rank)


def _dense(x):
    """A contiguous copy of ``x`` that a collective may overwrite."""
    return x.detach().clone(memory_format=torch.contiguous_format)


@contextlib.contextmanager
def _quiet():
    """Silence the deprecation newer torch releases attach to
    ``all_gather_into_tensor`` / ``reduce_scatter_tensor``."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r".*is deprecated.*_single")
        yield


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = _dense(x)
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        out = _dense(g)
        dist.all_reduce(out, group=ctx.pg)
        return out, None


def _gather0(x, pg):
    """``x`` of every rank stacked on a new leading dim, in rank order."""
    n = dist.get_world_size(pg)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    with _quiet():            # flat: gloo splits the output along dim 0
        dist.all_gather_into_tensor(out, _dense(x).reshape(-1), group=pg)
    return out.view((n,) + tuple(x.shape))


def _scatter0(x, pg):
    """Rank r's block ``x[r]`` of the sum over ranks of ``x`` (n, ...)."""
    out = torch.empty(x[0].numel(), dtype=x.dtype, device=x.device)
    with _quiet():
        dist.reduce_scatter_tensor(out, _dense(x).reshape(-1), group=pg)
    return out.view(tuple(x.shape[1:]))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, axis, tiled):
        ctx.pg, ctx.axis, ctx.tiled, ctx.shape = pg, axis, tiled, x.shape
        stacked = _gather0(x, pg)
        out = stacked.movedim(0, axis)
        if tiled:
            s = tuple(x.shape)
            out = out.reshape(s[:axis] + (-1,) + s[axis + 1:])
        return out

    @staticmethod
    def backward(ctx, g):
        axis, s = ctx.axis, tuple(ctx.shape)
        if ctx.tiled:
            g = g.reshape(s[:axis] + (-1, s[axis]) + s[axis + 1:])
        return _scatter0(g.movedim(axis, 0), ctx.pg), None, None, None


# -- the collectives --------------------------------------------------------

def all_reduce(x, group=None, op="sum"):
    """The reduction of ``x`` over the group's ranks on every rank
    (ncclAllReduce; ``avg`` / ``mean`` is the sum over the group size, as
    ``pmean``).  ``sum`` and the mean are differentiable."""
    pg = _pg(group)
    if op == "sum":
        return _SumOverRanks.apply(x, pg)
    if op in ("avg", "mean"):
        return _SumOverRanks.apply(x, pg) / dist.get_world_size(pg)
    if op in _OPS:
        out = _dense(x)
        dist.all_reduce(out, op=_OPS[op], group=pg)
        return out
    raise ValueError(op)


def all_gather(x, group=None, axis=0, tiled=True):
    """Every rank's ``x`` in rank order: concatenated along ``axis``
    (``tiled``), or stacked on a new dim at ``axis``.  Differentiable."""
    axis = axis % (x.ndim + (0 if tiled else 1))
    return _Gather.apply(x, _pg(group), axis, tiled)


def reduce_scatter(x, group=None, axis=0, tiled=True):
    """Rank r's block r along ``axis`` of the sum over ranks of ``x``
    (``psum_scatter``; untiled, ``x.shape[axis]`` is the group size and
    the dim is dropped)."""
    pg = _pg(group)
    n = dist.get_world_size(pg)
    xm = x.movedim(axis, 0)
    if tiled:
        if xm.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)}"
                             f" does not divide by the group size {n}")
        out = _scatter0(xm.reshape((n, -1) + tuple(xm.shape[1:])), pg)
        return out.movedim(0, axis)
    return _scatter0(xm, pg)


def reduce_scatter_flat(slab, group=None):
    """Row r of the sum over ranks of a ``(dp, width)`` slab on rank r:
    one ``reduce_scatter_tensor`` (a flat ``width``-long tensor)."""
    return _scatter0(slab, _pg(group))


def all_gather_flat(row, group=None):
    """Every rank's flat ``width``-long row stacked into the ``(dp,
    width)`` slab, in rank order: one ``all_gather_into_tensor``."""
    return _gather0(row, _pg(group))


def all_to_all(x, group=None, split_axis=0, concat_axis=0):
    """Split ``x`` along ``split_axis`` into one chunk per rank, send chunk
    j to rank j and concatenate the received chunks along ``concat_axis``
    in source order (tiled ``all_to_all``)."""
    pg = _pg(group)
    n = dist.get_world_size(pg)
    xm = _dense(x.movedim(split_axis, 0))
    if xm.shape[0] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not divide by the group size {n}")
    out = torch.empty_like(xm)
    dist.all_to_all_single(out, xm, group=pg)
    chunks = out.reshape((n, -1) + tuple(xm.shape[1:])).unbind(0)
    return torch.cat([c.movedim(0, split_axis) for c in chunks],
                     dim=concat_axis)


def broadcast(x, group=None, root=0):
    """Rank ``root``'s ``x`` on every rank (ncclBroadcast)."""
    out = _dense(x)
    dist.broadcast(out, src=_global(group, root), group=_pg(group))
    return out


def reduce(x, group=None, root=0, op="sum"):
    """The reduction of ``x`` on rank ``root``; every other rank gets
    zeros (ncclReduce, the JAX wrapper's convention)."""
    pg = _pg(group)
    out = _dense(x)
    red = dist.ReduceOp.SUM if op in ("sum", "avg", "mean") else _OPS.get(op)
    if red is None:
        raise ValueError(op)
    dist.reduce(out, dst=_global(group, root), op=red, group=pg)
    if dist.get_rank(pg) != root:
        return torch.zeros_like(out)
    return out / dist.get_world_size(pg) if op in ("avg", "mean") else out


def ppermute(x, group=None, perm=()):
    """Collective permute: for each ``(src, dst)`` of ``perm`` (group
    ranks), rank dst receives src's ``x``; a rank that receives nothing
    gets zeros (NCCL grouped send / recv)."""
    pg = _pg(group)
    me = dist.get_rank(pg)
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    ops, send = [], _dense(x)
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(send)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, send, _global(group, dst), pg))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _global(group, src), pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def send_next(x, group=None, n=None):
    """Shift by +1 around the ring (a pipeline's send to the next stage)."""
    n = _size(group) if n is None else n
    return ppermute(x, group, [(i, (i + 1) % n) for i in range(n)])


def send_prev(x, group=None, n=None):
    n = _size(group) if n is None else n
    return ppermute(x, group, [(i, (i - 1) % n) for i in range(n)])


def hierarchical_all_to_all(x, outer_group, inner_group):
    """Two-level all-to-all (reference HAllToAll): an exchange inside the
    inner group, then one across the outer group.  Equal to ``all_to_all``
    over the flat group whose rank is ``o * I + i`` (o the rank in the
    outer group, i in the inner one).  ``x``: (E·k, ...), chunk j for flat
    rank j; returns the received chunks in flat source order."""
    n_out, n_in = _size(outer_group), _size(inner_group)
    k = x.shape[0] // (n_out * n_in)
    rest = tuple(x.shape[1:])
    y = x.reshape((n_out, n_in, k) + rest)
    y = all_to_all(y, inner_group, split_axis=1, concat_axis=1)
    y = all_to_all(y, outer_group, split_axis=0, concat_axis=0)
    return y.reshape((n_out * n_in * k,) + rest)


def all_reduce_mean_buckets(tensors, group=None):
    """The mean over ranks of each tensor, reduced in flattened buckets of
    at most ``BUCKET_BYTES`` (one tensor larger than that is a bucket of
    its own) so that a model pays a few collectives, not one a tensor.
    One ``all_reduce`` a bucket; returns new contiguous tensors."""
    pg = _pg(group)
    n = dist.get_world_size(pg)
    out = [None] * len(tensors)
    buckets, cur, size, key = [], [], 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and ((t.dtype, t.device) != key
                    or size + nbytes > BUCKET_BYTES):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
        key = (t.dtype, t.device)
    if cur:
        buckets.append(cur)
    for idx in buckets:
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=pg)
        flat.div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


# -- group communicators ------------------------------------------------------

class CommGroup:
    """A named-axis communicator over a mesh axis (``new_group_comm``):
    the axis's process group, which the wrappers above take."""

    def __init__(self, mesh, axis_name):
        if axis_name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {axis_name!r}: "
                             f"{mesh.mesh_dim_names}")
        self.mesh = mesh
        self.axis_name = axis_name
        self.group = mesh.get_group(axis_name)

    @property
    def size(self):
        return dist.get_world_size(self.group)

    @property
    def rank(self):
        return dist.get_rank(self.group)

    def allreduce(self, x, op="sum"):
        return all_reduce(x, self, op)


def new_group_comm(mesh, axis_name="dp"):
    """Reference-parity constructor (``new_group_comm``)."""
    return CommGroup(mesh, axis_name)
