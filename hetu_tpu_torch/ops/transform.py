"""Reshape / transpose (subset of ``hetu_tpu/ops/transform.py``)."""
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
