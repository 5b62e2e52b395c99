"""Reverse-mode autodiff over the symbolic graph (twin of
``hetu_tpu/graph/gradients.py``).

Gradients are symbolic markers: ``gradients(loss, [w1, w2])`` returns
graph nodes that can be fetched or fed to an optimizer.  The executor
resolves them with ``torch.autograd.grad`` over the eagerly evaluated
forward, as the JAX package resolves them with ``jax.grad``.
"""
from __future__ import annotations

from .node import Op


class GradientOp(Op):
    """Marker node: d(loss)/d(wrt), resolved by the executor."""

    op_type = "Gradient"

    def __init__(self, loss, wrt, name=None):
        super().__init__([loss, wrt], name=name or f"grad_{wrt.name}")
        self.loss = loss
        self.wrt = wrt

    def lower(self, ctx, *vals):  # resolved specially by the executor
        raise RuntimeError("GradientOp must be resolved by the executor")


def gradients(loss, node_list, insert_grad=None):
    """Gradient nodes of ``loss`` w.r.t. each node in ``node_list``.
    ``insert_grad`` (an initial output cotangent) is accepted for API
    parity and ignored, as in the JAX package."""
    del insert_grad
    return [GradientOp(loss, n) for n in node_list]
