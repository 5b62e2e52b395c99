"""MoE layers (the port of ``hetu_tpu/layers/moe_layer.py``; reference
``layers/moe_layer.py:45`` MoELayer + Expert:7 and the BASE-layer variant
:90-133): ``Expert``, ``MoELayer`` (dense einsum dispatch, any dense
gate), ``SparseMoELayer`` (the row-gather dispatch, kernel B6) and
``BalancedMoELayer`` (the balanced-assignment permutation).

Expert FFN weights are STACKED along a leading expert axis, (E, d, h),
and applied with one batched einsum, so the expert dimension can later be
sharded for expert parallelism.  The JAX package marks that axis with
``PartitionSpec("ep")``; the port keeps each annotation as the plain
tuple ``("ep",)`` (nothing reads it until expert parallel is ported).
Under ``DataParallel`` (``parallel/batch_axis.py``) ``MoELayer`` and
``SparseMoELayer`` route over the global batch; ``BalancedMoELayer`` is
refused by name.
"""
from __future__ import annotations

from .base import BaseLayer
from .. import initializers as init
from .. import ops
from ..ops.matmul import einsum_op
from ..ops.moe import (layout_transform_op, reverse_layout_transform_op,
                       sparse_combine_op, sparse_dispatch_op)

EP = ("ep",)


class Expert(BaseLayer):
    """Stacked per-expert 2-layer FFN. Input (E, C, d) → (E, C, d)."""

    def __init__(self, num_experts, embed_dim, hidden_dim=None,
                 activation="relu", name="expert"):
        hidden_dim = hidden_dim or 4 * embed_dim
        self.w1 = init.he_uniform(shape=(num_experts, embed_dim, hidden_dim),
                                  name=name + ".w1")
        self.b1 = init.zeros(shape=(num_experts, 1, hidden_dim),
                             name=name + ".b1")
        self.w2 = init.he_uniform(shape=(num_experts, hidden_dim, embed_dim),
                                  name=name + ".w2")
        self.b2 = init.zeros(shape=(num_experts, 1, embed_dim),
                             name=name + ".b2")
        self.act = {"relu": ops.relu_op, "gelu": ops.gelu_op}[activation]
        for v in (self.w1, self.b1, self.w2, self.b2):
            v.sharding = EP

    def __call__(self, x):
        h = self.act(einsum_op("ecd,edh->ech", x, self.w1) + self.b1)
        return einsum_op("ech,ehd->ecd", h, self.w2) + self.b2


class MoELayer(BaseLayer):
    """gate → dispatch (einsum) → experts → combine.

    ``__call__(x)`` with x:(tokens, d) → (output (tokens, d), aux_loss|None).
    """

    def __init__(self, gate, experts, name="moe"):
        self.gate = gate
        self.experts = experts
        self.name = name

    def __call__(self, x):
        dispatch, combine, aux = self.gate(x)
        expert_in = layout_transform_op(dispatch, x)        # (E, C, d)
        expert_in.sharding = EP
        expert_out = self.experts(expert_in)                # (E, C, d)
        expert_out.sharding = EP
        y = reverse_layout_transform_op(combine, expert_out)  # (tokens, d)
        return y, aux


class SparseMoELayer(BaseLayer):
    """MoE layer on the row-gather dispatch path (kernel B6, see
    :mod:`hetu_tpu_torch.ops.kernels.moe_dispatch`): no (s, e, c) one-hot
    tensors, so memory stays O(s·d) + O(e·c·d) for any expert count.

    ``gate`` must be a :class:`~hetu_tpu_torch.layers.gates.TopKGateSparse`
    — expert count and capacity are read from it.
    """

    def __init__(self, gate, experts, embed_dim, name="sparse_moe"):
        self.gate = gate
        self.experts = experts
        self.embed_dim = embed_dim

    @property
    def num_experts(self):
        return self.gate.num_experts

    @property
    def capacity(self):
        return self.gate.capacity

    def __call__(self, x):
        tos, sot, kos, gate_w, aux = self.gate(x)
        flat = sparse_dispatch_op(x, tos, sot)              # (E*C, d)
        expert_in = ops.array_reshape_op(
            flat, output_shape=(self.num_experts, self.capacity,
                                self.embed_dim))
        expert_in.sharding = EP
        expert_out = self.experts(expert_in)                # (E, C, d)
        expert_out.sharding = EP
        out_flat = ops.array_reshape_op(
            expert_out, output_shape=(self.num_experts * self.capacity,
                                      self.embed_dim))
        y = sparse_combine_op(out_flat, gate_w, sot, tos, kos)
        return y, aux


class BalancedMoELayer(BaseLayer):
    """BASE-layer variant (reference moe_layer.py:90-133): balanced-assignment
    permutation instead of capacity gating — every expert gets exactly
    tokens/E tokens, no drops.  Needs the static token count, matching the
    reference gates' ``num_tokens`` argument."""

    def __init__(self, gate, experts, num_experts, num_tokens, embed_dim,
                 name="base_moe"):
        assert num_tokens % num_experts == 0
        self.gate = gate
        self.experts = experts
        self.num_experts = num_experts
        self.num_tokens = num_tokens
        self.embed_dim = embed_dim

    def __call__(self, x):
        # slot→token permutation from the balanced-assignment gate
        assign = self.gate(x)                      # (tokens,)
        gathered = ops.indexing_op(x, assign)      # (tokens, d) expert-grouped
        cap = self.num_tokens // self.num_experts
        expert_in = ops.array_reshape_op(
            gathered, output_shape=(self.num_experts, cap, self.embed_dim))
        expert_in.sharding = EP
        expert_out = self.experts(expert_in)
        expert_out.sharding = EP
        flat = ops.array_reshape_op(
            expert_out, output_shape=(self.num_tokens, self.embed_dim))
        # inverse permutation: scatter rows back to original token order
        return ops.scatter1d_grad_op(flat, assign, size=self.num_tokens), None
