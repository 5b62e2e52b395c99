"""Neural-net ops on the decode path (subset of ``hetu_tpu/ops/nn.py``):
GELU (tanh approximation), layer normalization, dropout."""
import torch

from .base import def_op

gelu_op = def_op(
    "Gelu", lambda c, a: torch.nn.functional.gelu(a, approximate="tanh"))


def _dropout(c, a, keep_prob=0.9):
    if not c.training or keep_prob >= 1.0:
        return a
    raise NotImplementedError(
        "dropout in training: the port serves only (training=False)")


dropout_op = def_op("Dropout", _dropout)


def _layer_norm(c, x, scale, bias, eps=0.01):
    # biased variance and rsqrt(var + eps), as the JAX lowering
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


layer_normalization_op = def_op("LayerNorm", _layer_norm)
