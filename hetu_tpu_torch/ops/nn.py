"""Neural-net ops of the ported paths (subset of ``hetu_tpu/ops/nn.py``):
ReLU, GELU (tanh approximation), layer normalization, dropout."""
import torch

from .base import def_op

relu_op = def_op("Relu", lambda c, a: torch.relu(a))

gelu_op = def_op(
    "Gelu", lambda c, a: torch.nn.functional.gelu(a, approximate="tanh"))


def _dropout(c, a, keep_prob=0.9):
    """Keep each element with probability ``keep_prob`` and scale the
    survivors by 1 / keep_prob.  The Bernoulli mask comes from the step's
    generator (``c.rng()``), so the bits differ from the JAX package's
    ``jax.random.bernoulli``; the distribution is the same."""
    if not c.training or keep_prob >= 1.0:
        return a
    keep = torch.rand(a.shape, generator=c.rng(), device=a.device) \
        < keep_prob
    return torch.where(keep, a / keep_prob, torch.zeros_like(a))


dropout_op = def_op("Dropout", _dropout)


def _layer_norm(c, x, scale, bias, eps=0.01):
    # biased variance and rsqrt(var + eps), as the JAX lowering
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


layer_normalization_op = def_op("LayerNorm", _layer_norm)
