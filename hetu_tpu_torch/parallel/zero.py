"""ZeRO-style cross-replica sharding of the weight update (twin of
``hetu_tpu/parallel/zero.py``; Xu et al., "Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training").

Instead of every rank paying the whole optimizer update (and Adam's two
moments of every parameter), each rank updates only its 1/dp slice of
every parameter and keeps only that slice's optimizer state.  This module
owns the layout, as in the JAX package: an optimizer's parameters are
flattened, concatenated, zero-padded to a multiple of dp and packed into
buckets of at most ``HETU_ZERO_BUCKET_MB`` (a ``(dp, width)`` slab each),
so ragged shapes shard evenly and small parameters ride one collective.

The JAX package leaves the collectives to GSPMD (sharding constraints on
the slab); the port has no partitioner, so it issues them itself over
``torch.distributed``.  Each rank holds **its row** of every slab, a flat
``width``-long tensor:

* stage 1 — the gradients are all-reduced as at stage 0 and each rank
  takes its row; the optimizer state lives in rows;
* stage 2 — each bucket's packed gradient slab is reduce-scattered
  (``collectives.reduce_scatter_flat``) and divided by dp;
* stage 3 — stage 2, and the rows are also the master parameters between
  steps: the executor all-gathers them at the top of the next step,
  before the forward (the JAX package's placement).

After the update, stages 1 and 2 all-gather the rows back into full
parameters.  The update itself is elementwise, row by row, except LAMB's
trust ratio, whose two norms are summed over the group
(``AdamOptimizer.apply(group=)``; every LAMB parameter is a bucket of its
own, and the zero padding adds 0 to both).

Not ported: ``slab_sharding`` / ``replicated_sharding`` (GSPMD layouts;
the port places rows itself), as ``collectives.py`` leaves out
``slab_spec``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..metrics import record_zero
from .collectives import all_gather_flat, reduce_scatter_flat

#: the data-parallel mesh axis the weight update shards over
ZERO_AXIS = "dp"

#: default collective bucket size (MB); 0 = one bucket per parameter
DEFAULT_BUCKET_MB = 4.0


def bucket_bytes():
    """Configured bucket size in bytes (``HETU_ZERO_BUCKET_MB``)."""
    try:
        mb = float(os.environ.get("HETU_ZERO_BUCKET_MB",
                                  str(DEFAULT_BUCKET_MB)))
    except ValueError:
        mb = DEFAULT_BUCKET_MB
    return int(mb * 2**20)


@dataclass
class ZeroBucket:
    """One fused collective: a group of params packed into a flat slab.

    The slab layout is ``concat(flatten(p) for p in params) + zero pad``
    reshaped to ``(dp, width)``: contiguous, so packing and unpacking are
    pure data movement, and row r is rank r's 1/dp slice."""

    key: str                    # key of this bucket's rows and state
    param_keys: list            # canonical keys of member params
    shapes: list                # original shapes, same order
    offsets: list               # start of each param in the flat concat
    numel: int                  # total unpadded elements
    dp: int
    dtype: str = "float32"

    @property
    def padded(self):
        return -(-self.numel // self.dp) * self.dp

    @property
    def pad(self):
        return self.padded - self.numel

    @property
    def width(self):
        return self.padded // self.dp

    @property
    def nbytes(self):
        return self.padded * np.dtype(self.dtype).itemsize


@dataclass
class ZeroPlan:
    """Per-OptimizerOp sharding plan: stage + bucket layout."""

    stage: int
    dp: int
    buckets: list = field(default_factory=list)
    axis: str = ZERO_AXIS

    @property
    def param_keys(self):
        return [k for b in self.buckets for k in b.param_keys]


def resolve_stage(value):
    """Normalize a user/env zero setting to an int stage in {0,1,2,3}."""
    if value is None or value is False:
        return 0
    if value is True:
        return 2            # the canonical reduce-scatter mode
    try:
        stage = int(value)
    except (TypeError, ValueError):
        stage = -1          # HETU_ZERO=on etc. get the range message
    if stage < 0 or stage > 3:
        raise ValueError(f"zero={value!r}: expected a stage in 0..3 "
                         "(0=off, 1=opt-state, 2=+reduce-scatter, "
                         "3=+sharded params)")
    return stage


def ineligible_reason(param, dtype):
    """Why ``param`` keeps its WHOLE optimizer off the ZeRO plan, or
    ``None`` if it doesn't: an explicit sharding annotation (the JAX
    package's model-parallel layouts; the port has none, so only a
    foreign node can carry one) or a non-float dtype.  ``dtype=None`` is
    eligible."""
    if any(s is not None for s in (getattr(param, "sharding", None) or ())):
        return ("carries an explicit sharding annotation "
                "(model parallelism)")
    if dtype is not None and not np.issubdtype(np.dtype(dtype),
                                               np.floating):
        return f"is not a float array (dtype {np.dtype(dtype).name})"
    return None


def build_plan(param_items, dp, stage, max_bytes=None, per_param=False,
               prefix=""):
    """Pack ``param_items`` (``[(key, shape, dtype), ...]`` in a stable
    order) into buckets of at most ``max_bytes`` each.

    ``per_param=True`` forces one bucket per parameter (LAMB's trust
    ratio needs per-parameter norms).  Params are grouped by dtype (a slab
    is one homogeneous buffer).  ``prefix`` namespaces the bucket keys
    (several OptimizerOps' buckets share one executor)."""
    if max_bytes is None:
        max_bytes = bucket_bytes()
    plan = ZeroPlan(stage=stage, dp=dp)
    cur = None
    for key, shape, dtype in param_items:
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        dts = np.dtype(dtype).name
        itemsize = np.dtype(dtype).itemsize
        if (per_param or cur is None or cur.dtype != dts
                or (cur.numel + size) * itemsize > max_bytes):
            cur = ZeroBucket(key=f"{prefix}zb{len(plan.buckets)}",
                             param_keys=[],
                             shapes=[], offsets=[], numel=0, dp=dp,
                             dtype=dts)
            plan.buckets.append(cur)
        cur.param_keys.append(key)
        cur.shapes.append(tuple(shape))
        cur.offsets.append(cur.numel)
        cur.numel += size
    return plan


# -- slab packing (pure data movement, bitwise-preserving) -------------------

def _size(shape):
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def pack_slab(vals, bucket):
    """``{param_key: tensor}`` → ``(dp, width)`` slab (flatten, concat,
    zero pad)."""
    flat = [vals[k].reshape(-1) for k in bucket.param_keys]
    if bucket.pad:
        flat.append(flat[0].new_zeros(bucket.pad))
    cat = flat[0] if len(flat) == 1 else torch.cat(flat)
    return cat.reshape(bucket.dp, bucket.width)


def unpack_slab(slab, bucket):
    """Inverse of :func:`pack_slab` → ``{param_key: tensor}`` (views of
    ``slab``)."""
    flat = slab.reshape(-1)
    return {k: flat[off:off + _size(shape)].reshape(shape)
            for k, shape, off in zip(bucket.param_keys, bucket.shapes,
                                     bucket.offsets)}


def host_pack_slab(np_vals, bucket):
    """Host-side (numpy) slab packing."""
    flat = [np.asarray(np_vals[k], np.dtype(bucket.dtype)).reshape(-1)
            for k in bucket.param_keys]
    cat = flat[0] if len(flat) == 1 else np.concatenate(flat)
    if bucket.pad:
        cat = np.pad(cat, (0, bucket.pad))
    return cat.reshape(bucket.dp, bucket.width)


def host_unpack_slab(slab, bucket):
    """Host-side inverse: slab (numpy) → ``{param_key: array}``."""
    flat = np.asarray(slab).reshape(-1)
    return {k: flat[off:off + _size(shape)].reshape(shape)
            for k, shape, off in zip(bucket.param_keys, bucket.shapes,
                                     bucket.offsets)}


def row_of(slab, rank):
    """Rank ``rank``'s row of a ``(dp, width)`` slab, as its own flat
    tensor (a copy: the row outlives the slab)."""
    return slab[rank].clone()


# -- the sharded update --------------------------------------------------------

def gather_full(row, bucket, group=None, count=True):
    """Every rank's row of ``bucket`` gathered into the full slab, unpacked
    to ``{param_key: tensor}``; a collective over ``group``.  ``count``:
    record the bytes under ``zero_all_gather_bytes``."""
    slab = all_gather_flat(row, group)
    if count:
        record_zero("zero_all_gather_bytes", bucket.nbytes)
    return unpack_slab(slab, bucket)


def grad_rows(plan, grads, rank, group=None):
    """This rank's row of every bucket's averaged gradient slab:
    ``grads`` are the group-averaged gradients (stage 1), or this rank's
    own gradients, reduce-scattered here and divided by dp (stages 2 and
    3).  ``{bucket key: row}``."""
    rows = {}
    for b in plan.buckets:
        slab = pack_slab(grads, b)
        if plan.stage >= 2:
            rows[b.key] = reduce_scatter_flat(slab, group).div_(plan.dp)
            record_zero("zero_reduce_scatter_bytes", b.nbytes)
        else:
            rows[b.key] = row_of(slab, rank)
        record_zero("zero_pad_bytes", b.pad * np.dtype(b.dtype).itemsize)
    return rows


def apply_sharded(optimizer, plan, params, g_rows, state, lr, rank,
                  group=None):
    """One optimizer step with the update sharded over the group.

    ``params``: full tensors keyed by canonical param key (stages 1 and 2),
    or this rank's rows keyed by bucket key (stage 3).  ``g_rows``: this
    rank's gradient rows (:func:`grad_rows`).  ``state``: the row-layout
    state :meth:`Executor._init_zero_state` made.  Returns ``(new_params,
    new_state)``, ``new_params`` keyed as ``params`` came in: full
    tensors, gathered from every rank's updated row (stages 1 and 2), or
    the new rows (stage 3)."""
    if plan.stage >= 3:
        p_rows = dict(params)
    else:
        p_rows = {b.key: row_of(pack_slab(params, b), rank)
                  for b in plan.buckets}
    kw = {"group": group} if getattr(optimizer, "lamb", False) else {}
    new_rows, new_state = optimizer.apply(p_rows, g_rows, state, lr, **kw)
    if plan.stage >= 3:
        return new_rows, new_state
    full = {}
    for b in plan.buckets:
        full.update(gather_full(new_rows[b.key], b, group))
    return full, new_state


__all__ = ["ZERO_AXIS", "DEFAULT_BUCKET_MB", "ZeroBucket", "ZeroPlan",
           "resolve_stage", "ineligible_reason", "build_plan",
           "bucket_bytes", "pack_slab", "unpack_slab", "host_pack_slab",
           "host_unpack_slab", "row_of", "gather_full", "grad_rows",
           "apply_sharded"]
