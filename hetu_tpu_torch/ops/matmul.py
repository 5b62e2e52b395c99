"""Matrix ops (twin of ``hetu_tpu/ops/matmul.py``).

Plain ``torch.matmul``: the JAX package left these products to XLA, and
the port leaves them to cuBLAS.  Float32 products run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` stays False; the decode entry
points set it explicitly).
"""
import torch

from .base import SimpleOp, def_op


def _t(x):
    # ``jnp``'s ``.T`` reverses ALL axes (not a swap of the trailing two)
    return x.permute(*reversed(range(x.ndim)))


def _mm(c, a, b, trans_A=False, trans_B=False):
    if trans_A:
        a = _t(a)
    if trans_B:
        b = _t(b)
    return torch.matmul(a, b)


matmul_op = def_op("MatrixMult", _mm)


def _linear(c, a, b, bias, trans_A=False, trans_B=False):
    return _mm(c, a, b, trans_A, trans_B) + bias


linear_op = def_op("Linear", _linear)


def einsum_op(subscripts, *nodes, name=None):
    """General einsum node (``torch.einsum``; the MoE experts' batched
    products)."""
    return SimpleOp("Einsum", list(nodes),
                    lambda c, *vals, subscripts=None: torch.einsum(
                        subscripts, *vals),
                    name=name, subscripts=subscripts)
