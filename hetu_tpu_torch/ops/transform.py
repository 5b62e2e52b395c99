"""Reshape / transpose / slice / concat / broadcast (subset of
``hetu_tpu/ops/transform.py``)."""
import torch

from .base import def_op

array_reshape_op = def_op(
    "ArrayReshape",
    lambda c, a, output_shape=None: torch.reshape(a, tuple(output_shape)))


def _transpose(c, a, perm=None):
    if perm is None:
        perm = tuple(reversed(range(a.ndim)))
    return a.permute(*perm)


transpose_op = def_op("Transpose", _transpose)


def _slice(c, a, begin=None, size=None, end=None):
    begin = list(begin)
    if size is not None:
        end = [b + s if s >= 0 else dim
               for b, s, dim in zip(begin, size, a.shape)]
    return a[tuple(slice(b, e) for b, e in zip(begin, end))]


slice_op = def_op("Slice", _slice)

concat_op = def_op("Concat",
                   lambda c, a, b, axis=0: torch.cat([a, b], dim=axis))

# ``a`` broadcast to the shape of the second input's value
broadcastto_op = def_op("BroadcastTo",
                        lambda c, a, b: torch.broadcast_to(a, b.shape))
