"""MoE gates (the ported subset of ``hetu_tpu/layers/gates.py``): GShard
top-1/top-2 with capacity and the aux balance loss, dense and sparse.
Variable names as the JAX package's (``<name>.wg``)."""
from __future__ import annotations

import math

from .base import BaseLayer
from .. import initializers as init
from .. import ops
from ..ops.moe import topk_gate_op, topk_gate_sparse_op


class TopKGate(BaseLayer):
    """GShard-style top-1/top-2 gate with capacity + aux balance loss.

    ``__call__(x)`` with x:(tokens, d) → (dispatch, combine, aux_loss).
    """

    def __init__(self, embed_dim, num_tokens, num_experts, k=1,
                 capacity_factor=1.0, name="topk_gate"):
        assert k in (1, 2)
        self.num_experts = num_experts
        self.k = k
        self.capacity = max(1, int(math.ceil(
            k * capacity_factor * num_tokens / num_experts)))
        self.wg = init.xavier_uniform(shape=(embed_dim, num_experts),
                                      name=name + ".wg")

    def __call__(self, x):
        logits = ops.matmul_op(x, self.wg)
        return topk_gate_op(logits, k=self.k, capacity=self.capacity)


class TopKGateSparse(TopKGate):
    """TopKGate emitting index maps for the row-gather dispatch (O(s·m)
    memory instead of the dense (s, e, c) one-hot tensors).

    ``__call__(x)`` → (token_of_slot, slot_of_token, k_of_slot, gate_w, aux).
    """

    def __call__(self, x):
        logits = ops.matmul_op(x, self.wg)
        return topk_gate_sparse_op(logits, k=self.k, capacity=self.capacity)
