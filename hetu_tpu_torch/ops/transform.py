"""Reshape / transpose / slice / concat / broadcast / roll / gather-scatter
(subset of ``hetu_tpu/ops/transform.py``).

Each op's gradient is torch autograd's of its lowering, which is the one
the JAX package's autodiff gives: a ``repeat_op`` (``jnp.tile``) or
``broadcast_shape_op`` sums over the copies, a ``roll_op`` rolls back,
``indexing_op`` (a row gather) scatter-adds into its rows, and
``scatter1d_grad_op`` (``zeros.at[idx].set(g)``) gathers the rows its
indices name.  Indices given as floats truncate toward zero, as
``astype(int32)`` does.  Every lowering also runs on meta tensors
(``analysis.infer_graph``)."""
import torch

from .base import SimpleOp, def_op

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


def _concatenate(c, *vals, axis=0):
    return torch.cat(vals, dim=axis)


def concatenate_op(node_list, axis=0, ctx=None, name=None):
    """Any number of nodes joined along ``axis`` (``jnp.concatenate``)."""
    del ctx
    return SimpleOp("Concatenate", list(node_list), _concatenate, name=name,
                    axis=axis)


# ``a`` broadcast to the shape of the second input's value
broadcastto_op = def_op("BroadcastTo",
                        lambda c, a, b: torch.broadcast_to(a, b.shape))


def _broadcast_shape(c, a, shape=None, add_axes=None):
    if add_axes:
        for ax in sorted(add_axes):
            a = a.unsqueeze(ax)
    return torch.broadcast_to(a, tuple(shape))


broadcast_shape_op = def_op("BroadcastShape", _broadcast_shape)

# ``jnp.tile``: whole copies of ``a`` along each axis (not
# ``repeat_interleave``); fewer reps than axes repeat the leading ones once
repeat_op = def_op("Repeat",
                   lambda c, a, reps=None: torch.tile(a, tuple(reps)))


def _roll(c, a, shift=None, axis=None):
    if axis is None:       # ``jnp.roll`` with no axis rolls the flat array
        return torch.roll(a, shift)
    return torch.roll(a, shifts=shift, dims=axis)


roll_op = def_op("Roll", _roll)


def _scatter1d_grad(c, g, idx, size=None):
    out = torch.zeros((size,) + tuple(g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    return out.index_put((idx.long(),), g)


# rows ``g[i]`` written to ``out[idx[i]]`` of a zero (size, ...) array
scatter1d_grad_op = def_op("Scatter1DGrad", _scatter1d_grad)

# rows ``a[idx[i]]``
indexing_op = def_op("Indexing", lambda c, a, idx: a[idx.long()])
