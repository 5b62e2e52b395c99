"""The batch axis under data parallelism: what each op does to a value
whose dim 0 is split over the ``dp`` group.  In the JAX package GSPMD
does this; the port has no partitioner, so this table does it by hand.

Under ``Executor(dist_strategy=DataParallel())`` rank r is fed the r-th
contiguous block of rows of every fed value with ndim > 0.  A value is
*sharded* when it holds this rank's block of the global value's rows, and
*replicated* when every rank holds the whole of it (variables, 0-d feeds,
anything computed from replicated values only).  :class:`BatchAxis`
carries that property from node to node through one step
(``LowerCtx.batch_axis``) and lowers every node with a sharded input by
the rule :data:`RULES` names for its op type, so that each rank computes
its rows of what the single-device program computes on the global batch:

* row-local ops (elementwise, activations, dropout, LayerNorm, the pools,
  the per-row losses) lower as they are; a replicated input may only
  broadcast against the rows (fewer dims, or a leading dim of 1), or hold
  the global batch's rows (a leading dim of dp times the rank's rows, as
  Longformer's global-token selector and XLNet's tiled query stream do):
  then the rank takes its block of it, as GSPMD would;
* ops with weights (matmul and linear without ``trans_A``, convolution,
  embedding lookup) lower as they are; the weights must be replicated and
  the data sharded;
* attention: q, k and v sharded (or holding the global rows, as above); a
  mask, bias or lengths sharded, or broadcast over the batch;
* ``BroadcastTo`` to a sharded shape gives a sharded value (its operand
  sharded, or replicated and broadcast into the rows); a sharded operand
  broadcast to a replicated shape raises;
* ``Transpose`` keeps dim 0 in place;
* ``Concat`` / ``Concatenate`` along a dim after the batch's is
  row-local (Wide & Deep joins its embedding rows to the dense
  features); along dim 0 it raises;
* a reduction over dim 0 (``ReduceSum``, ``ReduceMean``) reduces locally,
  then sums over the group with the differentiable ``all_reduce`` (a mean
  divides by the global count): a replicated value.  A bf16 input is
  reduced in float32, locally and over the group, and rounded once;
* shape-carrying ops (``ArrayReshape``, ``Slice``) take the leading
  static dim of their shape argument divided by dp (a reshape's must
  divide exactly; a slice must keep the whole batch);
* ``BatchNorm`` in training takes the mean and the biased variance of
  the global batch, for the normalization and the running statistics
  alike (sync BN, what GSPMD computes): each rank's per-channel mean and
  sum of squared deviations, exchanged in one all-reduce and combined
  exactly (Chan's pairwise update); its backward sums ``dy`` and
  ``dy * xhat`` over the group in one more.  A bf16 input is normalized
  in float32 and rounded once, and its statistics round to bf16, as the
  single-device ``F.batch_norm`` and ``var_mean`` give them.

An op type the table does not name, on a sharded input, raises
``NotImplementedError`` naming it: never a silent local answer.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .collectives import all_reduce

#: reduced and normalized in float32, rounded once (the bf16 step)
_LOW = (torch.bfloat16, torch.float16)


def _up(t):
    return t.float() if t.dtype in _LOW else t


class BatchAxis:
    """One step's batch split: the ``dp`` process group, its size, this
    rank, and the nodes whose value is sharded."""

    def __init__(self, group, size, rank):
        self.group = group
        self.size = size
        self.rank = rank
        self.sharded = set()

    def lower(self, node, ctx, vals):
        """``node.lower`` on ``vals``, by its rule when an input is
        sharded; records whether the output is."""
        flags = [i in self.sharded for i in node.inputs]
        if not any(flags):
            return node.lower(ctx, *vals)
        rule = RULES.get(node.op_type)
        if rule is None:
            raise NotImplementedError(
                f"{node.op_type} ({node.name}) on a batch-sharded input: the "
                f"op type has no data-parallel rule "
                f"(hetu_tpu_torch/parallel/batch_axis.py)")
        out, sharded = rule(self, node, ctx, vals, flags)
        if sharded:
            self.sharded.add(node)
        return out


def _refuse(node, why):
    raise NotImplementedError(
        f"{node.op_type} ({node.name}) under data parallelism: {why}")


def _lower_with(node, ctx, vals, **attrs):
    """A ``SimpleOp``'s lowering with some attributes replaced."""
    return node._lower_fn(ctx, *vals, **{**node.attrs, **attrs})


def _take_rows(ax, vals, flags):
    """Each replicated input that holds the global batch's rows (as many
    dims as the sharded inputs, dim 0 dp times theirs) replaced by this
    rank's block of them, and then counted sharded."""
    sharded = [v for v, f in zip(vals, flags) if f]
    rows, nd = sharded[0].shape[0], max(v.ndim for v in sharded)
    vals, flags = list(vals), list(flags)
    for i, (v, f) in enumerate(zip(vals, flags)):
        if not f and v is not None and v.ndim >= nd \
                and v.shape[0] == rows * ax.size:
            vals[i] = v[ax.rank * rows:(ax.rank + 1) * rows]
            flags[i] = True
    return vals, flags


def _rowwise(ax, node, ctx, vals, flags):
    vals, flags = _take_rows(ax, vals, flags)
    out = node.lower(ctx, *vals)
    for v, f in zip(vals, flags):
        if f and (out.ndim == 0 or v.shape[0] != out.shape[0]):
            _refuse(node, f"a sharded input {tuple(v.shape)} and the output "
                          f"{tuple(out.shape)} disagree on the rows")
        if not f and v.ndim >= out.ndim and v.shape[0] != 1:
            _refuse(node, f"a replicated input {tuple(v.shape)} meets the "
                          f"sharded rows along dim 0")
    return out, True


def _weights(*pos):
    """Inputs at ``pos`` are weights (replicated), the others data
    (sharded)."""
    def rule(ax, node, ctx, vals, flags):
        for i, f in enumerate(flags):
            if (i in pos) == f:
                _refuse(node, f"input {i} ({node.inputs[i].name}) is "
                              f"{'sharded' if f else 'replicated'}")
        if node.attrs.get("trans_A"):
            _refuse(node, "trans_A contracts over the batch")
        return node.lower(ctx, *vals), True
    return rule


def _attention(ax, node, ctx, vals, flags):
    vals, flags = _take_rows(ax, vals, flags)
    if not all(flags[:3]):
        _refuse(node, "q, k and v must all be sharded")
    for v, f in zip(vals[3:], flags[3:]):
        if not f and (v.ndim == 0 or v.shape[0] != 1):
            _refuse(node, f"a replicated mask, bias or lengths "
                          f"{tuple(v.shape)} is not broadcast over the batch")
    return node.lower(ctx, *vals), True


def _transpose(ax, node, ctx, vals, flags):
    nd = vals[0].ndim
    perm = node.attrs.get("perm") or tuple(reversed(range(nd)))
    if perm[0] % nd != 0:
        _refuse(node, f"perm {tuple(perm)} moves the batch dim")
    return node.lower(ctx, *vals), True


def _reshape(ax, node, ctx, vals, flags):
    shape = list(node.attrs["output_shape"])
    if shape[0] != -1:
        if shape[0] % ax.size:
            raise ValueError(
                f"{node.op_type} ({node.name}): the leading dim of "
                f"{tuple(shape)} does not divide by dp = {ax.size}")
        shape[0] //= ax.size
    return _lower_with(node, ctx, vals, output_shape=tuple(shape)), True


def _slice(ax, node, ctx, vals, flags):
    rows = vals[0].shape[0]
    total = rows * ax.size
    begin, size, end = (node.attrs.get(k) for k in ("begin", "size", "end"))
    last = (begin[0] + size[0] if size[0] >= 0 else total) \
        if size is not None else end[0]
    if begin[0] != 0 or last < total:
        _refuse(node, f"the slice takes rows {begin[0]}:{last} of the "
                      f"global batch of {total}; only the whole batch is "
                      f"ported")
    if size is not None:
        size = (-1 if size[0] < 0 else rows,) + tuple(size[1:])
        return _lower_with(node, ctx, vals, size=size), True
    end = (rows,) + tuple(end[1:])
    return _lower_with(node, ctx, vals, end=end), True


def _concat(ax, node, ctx, vals, flags):
    """Joined along a dim after the batch's: row-local.  Along dim 0 the
    ranks' blocks would interleave: refused."""
    nd = max(v.ndim for v in vals)
    if node.attrs.get("axis", 0) % nd == 0:
        _refuse(node, "a join along the batch dim")
    return _rowwise(ax, node, ctx, vals, flags)


def _reduce(mean):
    def rule(ax, node, ctx, vals, flags):
        a = vals[0]
        axes = node.attrs.get("axes")
        axes = range(a.ndim) if axes is None else \
            axes if isinstance(axes, (list, tuple)) else (axes,)
        dims = tuple(d % a.ndim for d in axes)
        if 0 not in dims:
            return node.lower(ctx, *vals), True
        low = a.dtype if a.dtype in _LOW else None
        a = _up(a)                          # float32 sums, one rounding
        if not mean:
            out = all_reduce(node.lower(ctx, a), ax.group)
        else:
            if not a.is_floating_point():
                a = a.to(torch.float32)
            count = math.prod(a.shape[d] for d in dims) * ax.size
            local = torch.sum(a, dim=dims,
                              keepdim=node.attrs.get("keepdims", False))
            out = all_reduce(local, ax.group) / count
        return (out if low is None else out.to(low)), False
    return rule


def _broadcast_to(ax, node, ctx, vals, flags):
    if not flags[1]:
        _refuse(node, "a sharded operand broadcast to a replicated shape")
    vals, flags = _take_rows(ax, vals, flags)
    return node.lower(ctx, *vals), True


class _SyncBatchNorm(torch.autograd.Function):
    """Training BatchNorm of NC... ``x`` over the global batch of a group
    whose ranks hold equal row counts.  Returns the normalized output and
    the global mean and biased variance (no gradient)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group, size, rank):
        low = x.dtype
        x = _up(x)
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        n = x.numel() // x.shape[1]
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        stats = x.new_zeros((size, 2, x.shape[1]))
        stats[rank, 0] = mean
        stats[rank, 1] = var * n                   # sum of squared deviations
        dist.all_reduce(stats, group=group)        # every rank's, in its row
        means = stats[:, 0]
        mean = means.mean(0)
        var = (stats[:, 1].sum(0) + n * ((means - mean) ** 2).sum(0)) \
            / (n * size)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        ctx.save_for_backward(xhat, scale, invstd)
        ctx.group, ctx.count, ctx.low = group, n * size, low
        mean, var = mean.to(low), var.to(low)
        ctx.mark_non_differentiable(mean, var)
        out = xhat * _up(scale).reshape(shape) + _up(bias).reshape(shape)
        return out.to(low), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, scale, invstd = ctx.saved_tensors
        dy = _up(dy)
        dims = [0] + list(range(2, dy.ndim))
        shape = (1, -1) + (1,) * (dy.ndim - 2)
        local = torch.stack([dy.sum(dims), (dy * xhat).sum(dims)])
        dbias, dscale = local.clone()              # this rank's rows
        dist.all_reduce(local, group=ctx.group)    # the global batch's
        dx = (_up(scale) * invstd).reshape(shape) * (
            dy - (local[0] / ctx.count).reshape(shape)
            - xhat * (local[1] / ctx.count).reshape(shape))
        return (dx.to(ctx.low), dscale.reshape(scale.shape).to(scale.dtype),
                dbias.reshape(scale.shape).to(scale.dtype),
                None, None, None, None)


def _batch_norm(ax, node, ctx, vals, flags):
    if any(flags[1:]):
        _refuse(node, "the scale, bias and running statistics must be "
                      "replicated")
    if not ctx.training:                  # the running statistics: per row
        return node.lower(ctx, *vals), True
    x, scale, bias, rmean, rvar = vals
    nhwc = node.attrs["data_format"] == "NHWC"
    out, mean, var = _SyncBatchNorm.apply(
        x.movedim(-1, 1) if nhwc else x, scale, bias, node.attrs["eps"],
        ax.group, ax.size, ax.rank)
    node.write_running(ctx, rmean, rvar, mean, var)
    return (out.movedim(1, -1) if nhwc else out), True


_ROW_LOCAL = (
    "AddElewise", "MinusElewise", "MultiplyElewise", "Division", "Ne",
    "AddConst", "MinusByConst", "MultiplyConst", "DivConst", "ConstDiv",
    "Opposite", "Pow", "Tanh", "ReciprocalSqrt", "Sigmoid", "Relu",
    "LeakyRelu", "Gelu", "Softmax", "LogSoftmax", "Dropout", "Dropout2d",
    "LayerNorm", "MaxPool2d", "AvgPool2d", "SoftmaxCrossEntropy",
    "SoftmaxCrossEntropySparse", "BinaryCrossEntropy")
_ATTENTION = (
    "ScaledDotProductAttention", "ScaledDotProductAttentionMasked",
    "ScaledDotProductAttentionBias", "ScaledDotProductAttentionMaskedBias",
    "ScaledDotProductAttentionVarlen")

#: op type -> rule(batch_axis, node, ctx, vals, sharded flags)
#: -> (output, whether the output is sharded)
RULES = {t: _rowwise for t in _ROW_LOCAL}
RULES.update({t: _attention for t in _ATTENTION})
RULES.update({
    "MatrixMult": _weights(1), "Linear": _weights(1, 2),
    "Conv2d": _weights(1), "Conv2dAddBias": _weights(1, 2),
    "EmbeddingLookup": _weights(0), "Transpose": _transpose,
    "ArrayReshape": _reshape, "Slice": _slice,
    "Concat": _concat, "Concatenate": _concat,
    "ReduceSum": _reduce(mean=False), "ReduceMean": _reduce(mean=True),
    "BatchNorm": _batch_norm, "BroadcastTo": _broadcast_to})
