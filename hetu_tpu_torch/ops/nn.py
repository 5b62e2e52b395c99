"""Neural-net ops (twin of ``hetu_tpu/ops/nn.py``): activations, softmax,
dropout, convolution, pooling and normalization, with the JAX package's
``op_type`` strings and keyword arguments.

Convolution and pooling lower to ``torch.nn.functional`` (cuDNN on the
card; the JAX package leaves them to XLA, outside any Pallas kernel).
``data_format="NHWC"`` is a layout of the graph's tensors: the lowering
views them as NCHW with channels-last strides (``permute``), so torch
picks its channels-last kernels and the output permutes back to NHWC
without a copy.  Weights are OIHW in both layouts.

BatchNorm's running statistics are non-trainable variables; in training
the lowering writes their new values into ``LowerCtx.state_updates`` and
the executor commits them after the step, as in the JAX package.
"""
import math

import torch
import torch.nn.functional as F

from ..graph.node import Op, PlaceholderOp
from .base import SimpleOp, def_op

# -- activations ------------------------------------------------------------
relu_op = def_op("Relu", lambda c, a: torch.relu(a))

leaky_relu_op = def_op("LeakyRelu",
                       lambda c, a, alpha=0.01: F.leaky_relu(a, alpha))

gelu_op = def_op("Gelu", lambda c, a: F.gelu(a, approximate="tanh"))

softmax_op = def_op("Softmax", lambda c, a: torch.softmax(a, dim=-1))

log_softmax_op = def_op("LogSoftmax",
                        lambda c, a: torch.log_softmax(a, dim=-1))


def softmax_func(x):
    """Softmax over the last axis of a tensor (not a graph node)."""
    return torch.softmax(x, dim=-1)


# -- dropout ----------------------------------------------------------------
# The Bernoulli masks come from the step's generator (``c.rng()``): the
# distribution of the JAX package's ``jax.random.bernoulli``, not its bits.


def _dropout(c, a, keep_prob=0.9):
    """Keep each element with probability ``keep_prob`` and scale the
    survivors by 1 / keep_prob."""
    if not c.training or keep_prob >= 1.0:
        return a
    keep = torch.rand(a.shape, generator=c.rng(), device=a.device) \
        < keep_prob
    return torch.where(keep, a / keep_prob, torch.zeros_like(a))


dropout_op = def_op("Dropout", _dropout)


def _dropout2d(c, a, keep_prob=0.9):
    """Channel dropout: keep or zero whole (N, C) feature maps (the mask
    spans the first two axes, whatever the layout, as in the JAX
    package)."""
    if not c.training or keep_prob >= 1.0:
        return a
    keep = torch.rand(a.shape[:2] + (1,) * (a.ndim - 2), generator=c.rng(),
                      device=a.device) < keep_prob
    return torch.where(keep, a / keep_prob, torch.zeros_like(a))


dropout2d_op = def_op("Dropout2d", _dropout2d)

# -- conv / pool ------------------------------------------------------------


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _to_nchw(x, data_format):
    """An NHWC tensor as an NCHW view (channels-last strides)."""
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(x, data_format):
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def _conv2d(c, x, w, padding=0, stride=1, data_format="NCHW"):
    # no bias inside the call: the bias op adds it after the convolution,
    # as the JAX lowering does (under bf16 the two round separately)
    out = F.conv2d(_to_nchw(x, data_format), w, None, _pair(stride),
                   _pair(padding))
    return _from_nchw(out, data_format)


def _conv2d_shape(x, w, padding=0, stride=1, data_format="NCHW"):
    ph, pw = _pair(padding)
    sh, sw = _pair(stride)
    if data_format == "NHWC":
        n, h, ww, _ = x
    else:
        n, _, h, ww = x
    o, _, kh, kw = w
    oh, ow = (h + 2 * ph - kh) // sh + 1, (ww + 2 * pw - kw) // sw + 1
    return (n, oh, ow, o) if data_format == "NHWC" else (n, o, oh, ow)


conv2d_op = def_op("Conv2d", _conv2d, _conv2d_shape)


def _bias_shape(data_format):
    return (1, 1, 1, -1) if data_format == "NHWC" else (1, -1, 1, 1)


conv2d_add_bias_op = def_op(
    "Conv2dAddBias",
    lambda c, x, w, b, padding=0, stride=1, data_format="NCHW":
        _conv2d(c, x, w, padding, stride, data_format)
        + b.reshape(_bias_shape(data_format)),
    lambda x, w, b, padding=0, stride=1, data_format="NCHW":
        _conv2d_shape(x, w, padding, stride, data_format))


def _pool(c, x, kernel_H, kernel_W, padding, stride, kind,
          data_format="NCHW"):
    """Max (padding -inf) or average (padding counted, the sum over
    ``kernel_H * kernel_W``) of each window, as ``reduce_window`` does.
    torch's pools refuse padding above half the kernel; there the padding
    is applied here and the pool runs unpadded."""
    ph, pw = _pair(padding)
    x = _to_nchw(x, data_format)
    if 2 * ph > kernel_H or 2 * pw > kernel_W:
        x = F.pad(x, (pw, pw, ph, ph),
                  value=-math.inf if kind == "max" else 0.0)
        ph = pw = 0
    if kind == "max":
        out = F.max_pool2d(x, (kernel_H, kernel_W), _pair(stride), (ph, pw))
    else:
        out = F.avg_pool2d(x, (kernel_H, kernel_W), _pair(stride), (ph, pw),
                           count_include_pad=True)
    return _from_nchw(out, data_format)


def _pool_shape(x, kernel_H, kernel_W, padding, stride, data_format="NCHW"):
    ph, pw = _pair(padding)
    sh, sw = _pair(stride)
    if data_format == "NHWC":
        n, h, w, ch = x
    else:
        n, ch, h, w = x
    oh, ow = (h + 2 * ph - kernel_H) // sh + 1, \
        (w + 2 * pw - kernel_W) // sw + 1
    return (n, oh, ow, ch) if data_format == "NHWC" else (n, ch, oh, ow)


def _pool_op(op_type, kind):
    def ctor(node, kernel_H, kernel_W, padding=0, stride=1, ctx=None,
             name=None, data_format="NCHW"):
        del ctx
        return SimpleOp(op_type, [node],
                        lambda c, x, **kw: _pool(c, x, kind=kind, **kw),
                        lambda x, **kw: _pool_shape(x, **kw),
                        name=name, kernel_H=kernel_H, kernel_W=kernel_W,
                        padding=padding, stride=stride,
                        data_format=data_format)
    ctor.__name__ = f"{kind}_pool2d_op"
    return ctor


max_pool2d_op = _pool_op("MaxPool2d", "max")
avg_pool2d_op = _pool_op("AvgPool2d", "avg")

# -- normalization ----------------------------------------------------------


class BatchNormOp(Op):
    """BatchNorm over NCHW or NHWC with functional running statistics.

    Training normalizes with the batch's mean and biased variance and
    writes ``(1 - momentum) * running + momentum * batch`` for both
    statistics (the biased variance in the running variance too, unlike
    ``torch.nn.BatchNorm2d``), computed in the activations' dtype;
    inference normalizes with the running statistics.  The statistics are
    the variables ``f"{name or 'bn'}_running_mean"`` / ``_running_var``,
    shaped as ``bn_scale`` (which must have a shape: the JAX package reads
    it when the executor starts, the port when the op is built)."""

    op_type = "BatchNorm"

    def __init__(self, node_in, bn_scale, bn_bias, momentum=0.1, eps=1e-5,
                 name=None, data_format="NCHW"):
        from ..initializers import OnesInit, ZerosInit
        shape = getattr(bn_scale, "shape", None)
        if shape is None:
            raise ValueError(
                f"batch_normalization_op: the scale {bn_scale} has no "
                f"shape; the running statistics take theirs from it")
        self.running_mean = PlaceholderOp(
            f"{name or 'bn'}_running_mean", trainable=False,
            initializer=ZerosInit(), shape=shape)
        self.running_var = PlaceholderOp(
            f"{name or 'bn'}_running_var", trainable=False,
            initializer=OnesInit(), shape=shape)
        super().__init__([node_in, bn_scale, bn_bias,
                          self.running_mean, self.running_var], name=name,
                         momentum=momentum, eps=eps, data_format=data_format)

    def write_running(self, ctx, rmean, rvar, mean, var):
        """Write ``(1 - momentum) * running + momentum * batch`` of both
        statistics into ``ctx.state_updates``."""
        momentum = self.attrs["momentum"]
        ctx.state_updates[self.running_mean] = \
            (1 - momentum) * rmean.reshape(-1) + momentum * mean
        ctx.state_updates[self.running_var] = \
            (1 - momentum) * rvar.reshape(-1) + momentum * var

    def lower(self, ctx, x, scale, bias, rmean, rvar):
        eps = self.attrs["eps"]
        df = self.attrs["data_format"]
        xc = x.movedim(-1, 1) if df == "NHWC" else x
        if ctx.training:
            with torch.no_grad():
                var, mean = torch.var_mean(
                    xc, dim=[0] + list(range(2, xc.ndim)), correction=0)
            self.write_running(ctx, rmean, rvar, mean, var)
            # torch's own running update would take the unbiased variance:
            # it gets no running tensors and normalizes with the batch's
            out = F.batch_norm(xc, None, None, scale.reshape(-1),
                               bias.reshape(-1), training=True, eps=eps)
        else:
            out = F.batch_norm(xc, rmean.reshape(-1), rvar.reshape(-1),
                               scale.reshape(-1), bias.reshape(-1),
                               training=False, eps=eps)
        return out.movedim(1, -1) if df == "NHWC" else out

    def infer_shape(self, input_shapes):
        return tuple(input_shapes[0])


def batch_normalization_op(node_in, bn_scale, bn_bias, momentum=0.1, eps=1e-5,
                           ctx=None, name=None, data_format="NCHW"):
    del ctx
    return BatchNormOp(node_in, bn_scale, bn_bias, momentum, eps, name=name,
                       data_format=data_format)


def _layer_norm(c, x, scale, bias, eps=0.01):
    # biased variance and rsqrt(var + eps), as the JAX lowering
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


layer_normalization_op = def_op("LayerNorm", _layer_norm,
                                lambda x, s, b, eps=0.01: tuple(x))


def _instance_norm2d(c, x, eps=1e-7):
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


instance_normalization2d_op = def_op("InstanceNorm2d", _instance_norm2d)
