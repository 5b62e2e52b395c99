"""Core layers of the decode slice (twin of ``hetu_tpu/layers/core.py``):
``Linear`` and ``LayerNorm`` with the same variable names
(``<name>.weight`` / ``.bias``, ``<name>.scale`` / ``.bias``)."""
from __future__ import annotations

from .base import BaseLayer
from ..graph.node import Op
from .. import initializers as init
from .. import ops


def _resolve_activation(activation):
    if isinstance(activation, str):
        table = {"gelu": ops.gelu_op}
        if activation not in table:
            raise NotImplementedError(activation)
        return table[activation]
    return activation


class Linear(BaseLayer):
    def __init__(self, in_features, out_features, initializer=None, bias=True,
                 activation=None, name="linear"):
        initializer = initializer or init.GenXavierUniform()
        self.in_features, self.out_features = in_features, out_features
        self.bias = bias
        self.activation = _resolve_activation(activation)
        self.name = name
        if isinstance(initializer, Op):
            self.weight_var = initializer  # user-supplied weight node
        else:
            self.weight_var = initializer(shape=(in_features, out_features),
                                          name=name + ".weight")
        if bias:
            self.bias_var = init.zeros(shape=(out_features,),
                                       name=name + ".bias")

    def __call__(self, x):
        if self.bias:
            x = ops.linear_op(x, self.weight_var, self.bias_var)
        else:
            x = ops.matmul_op(x, self.weight_var)
        if self.activation is not None:
            x = self.activation(x)
        return x


class LayerNorm(BaseLayer):
    def __init__(self, num_channels, eps=1e-5, name="layernorm"):
        self.scale_var = init.ones(shape=(num_channels,), name=name + ".scale")
        self.bias_var = init.zeros(shape=(num_channels,), name=name + ".bias")
        self.eps = eps

    def __call__(self, x):
        return ops.layer_normalization_op(x, self.scale_var, self.bias_var,
                                          eps=self.eps)
