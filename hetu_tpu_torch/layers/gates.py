"""MoE gates (the port of ``hetu_tpu/layers/gates.py``; reference
``layers/TopGate.py`` topkgating:14, ``HashGate.py``, ``KTop1Gate.py``,
``SAMGate.py``, ``BalanceGate.py``): GShard top-1/top-2 with capacity and
the aux balance loss, dense and sparse; token-id hashing; KTop1; SAM; the
BASE layer's balanced assignment.  Variable names as the JAX package's
(``<name>.wg``, ``<name>.we``)."""
from __future__ import annotations

import math

from .base import BaseLayer
from .. import initializers as init
from .. import ops
from ..ops.moe import (balance_assignment_op, hash_dispatch_op,
                       ktop1_gate_op, sam_gate_op, topk_gate_op,
                       topk_gate_sparse_op)


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


class HashGate(BaseLayer):
    """Token-id hash routing (no learned params, reference HashGate.py)."""

    def __init__(self, num_tokens, num_experts, capacity_factor=1.0,
                 name="hash_gate"):
        self.num_experts = num_experts
        self.capacity = max(1, int(math.ceil(
            capacity_factor * num_tokens / num_experts)))

    def __call__(self, token_ids):
        dispatch = hash_dispatch_op(token_ids, self.num_experts, self.capacity)
        return dispatch, dispatch, None  # combine == dispatch (weight 1)


class KTop1Gate(BaseLayer):
    """Experts split into k prototype groups; every token routes top-1 in
    EACH group (reference ``KTop1Gate.py`` ktop1gating:14).  Returns
    (dispatch, combine, aux_loss).  ``capacity`` is k times the per-expert
    share, as the JAX package sizes it."""

    def __init__(self, embed_dim, num_tokens, num_experts, k=2,
                 capacity_factor=1.0, name="ktop1_gate"):
        assert num_experts % k == 0
        self.k = k
        self.capacity = k * max(1, int(math.ceil(
            capacity_factor * num_tokens / num_experts)))
        self.wg = init.xavier_uniform(shape=(embed_dim, num_experts),
                                      name=name + ".wg")

    def __call__(self, x):
        logits = ops.matmul_op(x, self.wg)
        return ktop1_gate_op(logits, k=self.k, capacity=self.capacity)


class SAMGate(BaseLayer):
    """Switch-and-Mix gate (reference ``SAMGate.py`` samgating:22): pick the
    expert GROUP (node) with max summed prob, route top-k within it; returns
    (dispatch, combine, aux_loss) where aux_loss = balance + alignment hinge
    (SamMax.cu semantics) times ``align_weight``.  ``num_local_devices`` is
    the experts-per-group size, matching the reference's
    ``num_local_gpus``."""

    def __init__(self, embed_dim, num_tokens, num_experts, k=1,
                 capacity_factor=1.0, num_local_devices=8, align_weight=1.0,
                 name="sam_gate"):
        assert num_experts % num_local_devices == 0
        self.k = k
        self.group_size = num_local_devices
        self.align_weight = align_weight
        self.capacity = k * max(1, int(math.ceil(
            capacity_factor * num_tokens / num_experts)))
        self.wg = init.xavier_uniform(shape=(embed_dim, num_experts),
                                      name=name + ".wg")

    def __call__(self, x):
        logits = ops.matmul_op(x, self.wg)
        dispatch, combine, aux, align = sam_gate_op(
            logits, k=self.k, capacity=self.capacity,
            group_size=self.group_size)
        return dispatch, combine, aux + align * self.align_weight


class BalanceAssignmentGate(BaseLayer):
    """BASE layer (reference BalanceGate.py + BalanceAssignment.cu): balanced
    linear assignment of tokens to experts (equal load by construction).
    ``__call__(x)`` → the slot→token permutation (int32, no gradient: the
    JAX package's gradient of ``<name>.we`` is zero, and so is the port's)."""

    def __init__(self, embed_dim, num_tokens, num_experts, name="balance_gate"):
        self.num_experts = num_experts
        self.num_tokens = num_tokens
        self.we = init.xavier_uniform(shape=(embed_dim, num_experts),
                                      name=name + ".we")

    def __call__(self, x):
        scores = ops.matmul_op(x, self.we)
        return balance_assignment_op(scores)
