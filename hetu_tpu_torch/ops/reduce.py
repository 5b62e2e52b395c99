"""Reduction ops (subset of ``hetu_tpu/ops/reduce.py``).

An integer input keeps its dtype under ``reduce_sum_op`` (a bool one
sums as int32), as under ``jnp.sum`` (``torch.sum`` would widen to
int64); ``reduce_mean_op``
of an integer input is float32, as ``jnp.mean``'s."""
import torch

from .base import def_op


def _dims(a, axes):
    if axes is None:
        return tuple(range(a.ndim))
    if isinstance(axes, (list, tuple)):
        return tuple(axes)
    return (axes,)


def _reduce_sum(c, a, axes=None, keepdims=False):
    if a.dtype == torch.bool:
        a = a.to(torch.int32)
    dtype = None if a.is_floating_point() else a.dtype
    return torch.sum(a, dim=_dims(a, axes), keepdim=keepdims, dtype=dtype)


def _reduce_mean(c, a, axes=None, keepdims=False):
    if not a.is_floating_point():
        a = a.to(torch.float32)
    return torch.mean(a, dim=_dims(a, axes), keepdim=keepdims)


reduce_sum_op = def_op("ReduceSum", _reduce_sum)
reduce_mean_op = def_op("ReduceMean", _reduce_mean)
