"""MoE ops: GShard top-1/top-2 gating and token dispatch / combine (the
ported subset of ``hetu_tpu/ops/moe.py``, same ``op_type`` strings).

Two formulations of one routing, as in the JAX package:

* dense (``TopKGate`` → ``MoELayer``): :func:`topk_gate_op` builds the
  ``(s, e, c)`` one-hot dispatch and combine tensors, and
  :func:`layout_transform_op` / :func:`reverse_layout_transform_op` are
  einsums against them (plain PyTorch products, no kernel);
* sparse (``TopKGateSparse`` → ``SparseMoELayer``):
  :func:`topk_gate_sparse_op` emits index maps, and
  :func:`sparse_dispatch_op` / :func:`sparse_combine_op` move rows with
  the CUDA row-gather kernel (``ops/kernels/moe_dispatch.py``, B6),
  forward and backward.

The arithmetic is the JAX package's, literally: the softmax one op at a
time (:func:`_softmax`), float32 one-hot cumsums for
the queue positions, expert-2 positions offset by the count of expert-1
*choices* (``mask1``, dropped ones included), the aux loss from the first
route's mask only, the top-2 renormalisation with its ``1e-9`` floor, and
``token_of_slot`` / ``k_of_slot`` built by a scatter whose dropped routes
land in a discarded ``n_slots``-th bin.  Not ported: the KTop1, SAM, hash
and balanced-assignment gates, and the expert-parallel all-to-alls.
"""
import torch

from .base import SimpleOp, def_op, tuple_outputs
from .kernels.moe_dispatch import sparse_combine, sparse_dispatch


def _one_hot_f(idx, n):
    # a compare, not F.one_hot: that checks its range on the host, a
    # device sync per call on the card
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _softmax(logits):
    """``jax.nn.softmax`` over the last axis as the JAX package computes
    it, ``exp(x - max) / sum(exp(x - max))`` one op at a time, each op
    rounding to the logits' dtype.  ``torch.softmax`` rounds once from
    float32: in bf16 that lands an ulp away from the JAX package's gates
    in most rows and flips a route wherever two gates tie after one of
    the two roundings (ROADMAP C13)."""
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _cumsum_tokens(mask):
    """``cumsum(mask, axis=0)`` of an (s, e) one-hot, scanned along the
    last axis of its transpose: PyTorch scans an outer axis one column a
    thread, which at e = 16 left the card idle for milliseconds.  The
    sums are of 0.0 / 1.0 below 2^24, exact in any order, so the bits are
    those of the token-axis cumsum."""
    return torch.cumsum(mask.t().contiguous(), dim=1).t()


def _top1_gating(logits, capacity):
    """Returns (dispatch (s,e,c), combine (s,e,c), aux_loss) — GShard top-1."""
    s, e = logits.shape
    gates = _softmax(logits)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot_f(idx1, e)                       # (s, e)
    # position of each token within its expert queue
    pos1 = _cumsum_tokens(mask1) * mask1 - mask1  # (s, e), 0-based
    keep1 = mask1 * (pos1 < capacity)
    gate1 = torch.sum(gates * keep1, dim=-1)          # (s,)
    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    aux = torch.sum(me * ce) * e
    pos_in_e = torch.sum(pos1 * keep1, dim=-1).to(torch.int64)  # (s,)
    dispatch = keep1[:, :, None] * _one_hot_f(pos_in_e, capacity)[:, None, :]
    combine = gate1[:, None, None] * dispatch
    return dispatch, combine, aux


def _top2_gating(logits, capacity):
    s, e = logits.shape
    gates = _softmax(logits)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot_f(idx1, e)
    gates2 = gates * (1 - mask1)
    idx2 = torch.argmax(gates2, dim=-1)
    mask2 = _one_hot_f(idx2, e)

    pos1 = _cumsum_tokens(mask1) * mask1 - mask1
    # expert-2 queue positions come after all expert-1 tokens of that expert
    pos2 = (_cumsum_tokens(mask2) * mask2 - mask2) \
        + torch.sum(mask1, dim=0, keepdim=True)
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    g1 = torch.sum(gates * keep1, dim=-1)
    g2 = torch.sum(gates * keep2, dim=-1)
    denom = torch.clamp_min(g1 + g2, 1e-9)
    g1, g2 = g1 / denom, g2 / denom

    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    aux = torch.sum(me * ce) * e

    p1 = torch.sum(pos1 * keep1, dim=-1).to(torch.int64)
    p2 = torch.sum(pos2 * keep2, dim=-1).to(torch.int64)
    d1 = keep1[:, :, None] * _one_hot_f(p1, capacity)[:, None, :]
    d2 = keep2[:, :, None] * _one_hot_f(p2, capacity)[:, None, :]
    dispatch = torch.maximum(d1, d2)
    combine = g1[:, None, None] * d1 + g2[:, None, None] * d2
    return dispatch, combine, aux


def topk_gate_op(logits_node, k=1, capacity=None, name=None):
    """Fused GShard gating: returns (dispatch, combine, aux_loss) nodes."""
    assert k in (1, 2)

    def lower(c, logits, k=1, capacity=None):
        fn = _top1_gating if k == 1 else _top2_gating
        return fn(logits, capacity)

    node = SimpleOp("TopKGate", [logits_node], lower, name=name,
                    k=k, capacity=capacity)
    return tuple_outputs(node, 3)


# dense dispatch/combine einsums (the reference's layout_transform /
# reverse_layout_transform)
layout_transform_op = def_op(
    "LayoutTransform",
    lambda c, dispatch, tokens: torch.einsum(
        "sec,sm->ecm", dispatch.to(tokens.dtype), tokens))

reverse_layout_transform_op = def_op(
    "ReverseLayoutTransform",
    lambda c, combine, expert_out: torch.einsum(
        "sec,ecm->sm", combine.to(expert_out.dtype), expert_out))


def _topk_sparse_indices(logits, k, capacity):
    """GShard top-1/2 routing as index maps (no (s,e,c) tensors).

    Returns (token_of_slot (e*cap,), slot_of_token (s, k),
    k_of_slot (e*cap,), gate_w (s, k), aux_loss), the maps int32, with
    routing, capacity drops, gate normalisation and aux loss identical to
    :func:`_top1_gating` / :func:`_top2_gating`.
    """
    s, e = logits.shape
    dev = logits.device
    gates = _softmax(logits)
    remaining = gates
    count_prev = torch.zeros((1, e), dtype=torch.float32, device=dev)
    slots, gws, masks = [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        mask = _one_hot_f(idx, e)
        pos = (_cumsum_tokens(mask) * mask - mask) + count_prev * mask
        keep = mask * (pos < capacity)
        kept = torch.sum(keep, dim=-1) > 0                    # (s,) bool
        gws.append(torch.sum(gates * keep, dim=-1))           # (s,)
        p = torch.sum(pos * keep, dim=-1).to(torch.int32)
        slot = torch.where(kept, idx.to(torch.int32) * capacity + p,
                           torch.full_like(p, -1))
        slots.append(slot)
        masks.append(mask)
        count_prev = count_prev + torch.sum(mask, dim=0, keepdim=True)
        remaining = remaining * (1 - mask)
    gate_w = torch.stack(gws, dim=1)                          # (s, k)
    if k > 1:  # top-2 renormalisation (reference TopGate.py)
        denom = torch.clamp_min(torch.sum(gate_w, dim=1, keepdim=True), 1e-9)
        gate_w = gate_w / denom
    slot_of_token = torch.stack(slots, dim=1)                 # (s, k)
    me = torch.mean(gates, dim=0)
    ce = torch.mean(masks[0], dim=0)
    aux = torch.sum(me * ce) * e

    # the scatter of ``.at[tgt].set(..., mode="drop")``: dropped routes
    # land in bin n_slots, cut off after (every kept slot is unique)
    n_slots = e * capacity
    tok_ids = torch.arange(s, dtype=torch.int32, device=dev)
    token_of_slot = torch.full((n_slots + 1,), -1, dtype=torch.int32,
                               device=dev)
    k_of_slot = torch.zeros((n_slots + 1,), dtype=torch.int32, device=dev)
    for j in range(k):
        tgt = torch.where(slots[j] >= 0, slots[j],
                          torch.full_like(slots[j], n_slots)).long()
        token_of_slot[tgt] = tok_ids
        k_of_slot[tgt] = j
    return (token_of_slot[:n_slots], slot_of_token, k_of_slot[:n_slots],
            gate_w, aux)


def topk_gate_sparse_op(logits_node, k=1, capacity=None, name=None):
    """Sparse GShard gating → (token_of_slot, slot_of_token, k_of_slot,
    gate_w, aux_loss) nodes for the row-gather dispatch path."""
    node = SimpleOp("TopKGateSparse", [logits_node],
                    lambda c, logits, k=1, capacity=None:
                        _topk_sparse_indices(logits, k, capacity),
                    name=name, k=k, capacity=capacity)
    return tuple_outputs(node, 5)


def _record_cpu(what, t):
    if t.device.type == "cpu":
        from ..metrics import record_moe_fallback
        record_moe_fallback(f"{what}:backend:cpu")


def _sparse_dispatch_lower(c, tokens, token_of_slot, slot_of_token):
    _record_cpu("dispatch", tokens)
    return sparse_dispatch(tokens, token_of_slot, slot_of_token)


sparse_dispatch_op = def_op("SparseDispatch", _sparse_dispatch_lower)


def _sparse_combine_lower(c, buffers, gate_w, slot_of_token, token_of_slot,
                          k_of_slot):
    _record_cpu("combine", buffers)
    return sparse_combine(buffers, gate_w, slot_of_token, token_of_slot,
                          k_of_slot)


sparse_combine_op = def_op("SparseCombine", _sparse_combine_lower)
