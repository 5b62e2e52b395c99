"""MoE ops: gating, token dispatch / combine and the expert-parallel
collectives (the port of ``hetu_tpu/ops/moe.py``, same ``op_type``
strings).

Two formulations of one routing, as in the JAX package:

* dense (``TopKGate`` → ``MoELayer``): :func:`topk_gate_op` builds the
  ``(s, e, c)`` one-hot dispatch and combine tensors, and
  :func:`layout_transform_op` / :func:`reverse_layout_transform_op` are
  einsums against them (plain PyTorch products, no kernel); the KTop1
  (:func:`ktop1_gate_op`), SAM (:func:`sam_gate_op`) and hash
  (:func:`hash_dispatch_op`) gates build the same tensors;
* sparse (``TopKGateSparse`` → ``SparseMoELayer``):
  :func:`topk_gate_sparse_op` emits index maps, and
  :func:`sparse_dispatch_op` / :func:`sparse_combine_op` move rows with
  the CUDA row-gather kernel (``ops/kernels/moe_dispatch.py``, B6),
  forward and backward.

:func:`balance_assignment_op` is the BASE layer's balanced assignment, a
slot→token permutation (``BalancedMoELayer`` gathers rows by it).

The arithmetic is the JAX package's, literally: the softmax one op at a
time (:func:`_softmax`), float32 one-hot cumsums for
the queue positions, expert-2 positions offset by the count of expert-1
*choices* (``mask1``, dropped ones included), the aux loss from the first
route's mask only, the top-2 renormalisation with its ``1e-9`` floor, and
``token_of_slot`` / ``k_of_slot`` built by a scatter whose dropped routes
land in a discarded ``n_slots``-th bin.  Every sort is stable, as
``jnp.argsort`` is.  :func:`alltoall_op` / :func:`halltoall_op` are the
identity: they exchange rows only over an ``ep`` mesh, and expert
parallelism is not ported (``ModelParallel`` is refused).
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


def _dispatch_from(keep, pos, capacity, gate_w=None):
    """Build (s,e,c) dispatch / combine tensors from a keep mask (s,e) and
    per-token queue positions (s,)."""
    d = keep[:, :, None] * _one_hot_f(pos, capacity)[:, None, :]
    if gate_w is None:
        return d
    return d, gate_w[:, None, None] * d


def _ktop1_gating(logits, k, capacity):
    """KTop1 (reference ``layers/KTop1Gate.py`` ktop1gating:14): experts are
    split into k prototype groups of e/k; each token routes top-1 within
    EVERY group (so k experts per token, one per group); balance loss summed
    per group."""
    s, e = logits.shape
    g = e // k
    dis_parts, com_parts = [], []
    aux = 0.0
    for i in range(k):
        gates = _softmax(logits[:, i * g:(i + 1) * g])
        idx = torch.argmax(gates, dim=-1)
        mask = _one_hot_f(idx, g)
        posm = _cumsum_tokens(mask) * mask - mask
        keep = mask * (posm < capacity)
        gate_w = torch.sum(gates * keep, dim=-1)
        aux = aux + torch.sum(torch.mean(gates, 0) * torch.mean(mask, 0)) * g
        p = torch.sum(posm * keep, dim=-1).to(torch.int64)
        d, c = _dispatch_from(keep, p, capacity, gate_w)
        dis_parts.append(d)
        com_parts.append(c)
    dispatch = torch.cat(dis_parts, dim=1)          # (s, e, c)
    combine = torch.cat(com_parts, dim=1)
    return dispatch, combine, aux


def _sam_gating(logits, k, capacity, group_size):
    """SAM gate (reference ``layers/SAMGate.py`` samgating:22 + SamMax.cu,
    SamGroupSum.cu, GroupTopKIdx.cu): softmax over all experts; pick the
    group (node) with the largest summed prob; route top-k within that group;
    alignment loss = hinge on out-group probs exceeding the selected k-th
    expert's prob."""
    s, e = logits.shape
    ngroups = e // group_size
    gates = _softmax(logits)
    gsum = gates.reshape(s, ngroups, group_size).sum(-1)
    top_group = torch.argmax(gsum, dim=-1)                      # (s,)
    in_group = _one_hot_f(top_group, ngroups)                   # (s, ngroups)
    in_group_e = in_group[:, :, None].expand(
        s, ngroups, group_size).reshape(s, e)                # jnp.repeat
    neg_inf = gates.new_full((), float("-inf"))
    masked_gates = torch.where(in_group_e > 0, gates, neg_inf)

    dispatch = gates.new_zeros((s, e, capacity), dtype=torch.float32)
    combine = gates.new_zeros((s, e, capacity), dtype=torch.float32)
    aux = 0.0
    used = gates.new_zeros((s, e), dtype=torch.float32)  # routed experts
    kth_prob = None
    for _ in range(k):
        idx = torch.argmax(torch.where(used > 0, neg_inf, masked_gates),
                           dim=-1)
        mask = _one_hot_f(idx, e)
        used = used + mask
        # queue positions account for earlier-k selections (acc_base)
        posm = _cumsum_tokens(mask) * mask - mask \
            + torch.sum(used - mask, dim=0, keepdim=True) * mask
        keep = mask * (posm < capacity)
        gate_w = torch.sum(gates * keep, dim=-1)
        aux = aux + torch.sum(torch.mean(gates, 0) * torch.mean(mask, 0)) * e
        p = torch.sum(posm * keep, dim=-1).to(torch.int64)
        d, c = _dispatch_from(keep, p, capacity, gate_w)
        dispatch = dispatch + d
        combine = combine + c
        kth_prob = torch.sum(gates * mask, dim=-1)              # (s,)
    # SamMax hinge: out-group probs exceeding the k-th selected prob
    out_group = 1.0 - in_group_e
    align = torch.sum(torch.clamp_min(gates - kth_prob[:, None], 0.0)
                      * out_group)
    return dispatch, combine, aux, align


def ktop1_gate_op(logits_node, k, capacity, name=None):
    """Fused KTop1 gating node → (dispatch, combine, aux_loss)."""
    node = SimpleOp("KTop1Gate", [logits_node],
                    lambda c, logits, k=1, capacity=None:
                        _ktop1_gating(logits, k, capacity),
                    name=name, k=k, capacity=capacity)
    return tuple_outputs(node, 3)


def sam_gate_op(logits_node, k, capacity, group_size, name=None):
    """Fused SAM gating node → (dispatch, combine, aux_loss, align_loss)."""
    node = SimpleOp("SAMGate", [logits_node],
                    lambda c, logits, k=1, capacity=None, group_size=1:
                        _sam_gating(logits, k, capacity, group_size),
                    name=name, k=k, capacity=capacity, group_size=group_size)
    return tuple_outputs(node, 4)


def _hash_dispatch(c, idx, num_experts=1, capacity=None):
    """Hash gating (reference HashGate.py): expert = token_id % E, the
    floor modulo of ``jnp``'s ``%`` (``torch.remainder``)."""
    e = num_experts
    expert_of = torch.remainder(idx.to(torch.int32), e)
    mask = _one_hot_f(expert_of, e)
    pos = _cumsum_tokens(mask) * mask - mask
    keep = mask * (pos < capacity)
    p = torch.sum(pos * keep, dim=-1).to(torch.int64)
    return keep[:, :, None] * _one_hot_f(p, capacity)[:, None, :]


def hash_dispatch_op(idx_node, num_experts, capacity, name=None):
    return SimpleOp("HashDispatch", [idx_node], _hash_dispatch, name=name,
                    num_experts=num_experts, capacity=capacity)


def _logsumexp(a, dim):
    """``jax.nn.logsumexp(a, axis=dim, keepdims=True)`` as the JAX package
    computes it: the max (0 where it is not finite) taken out, then added
    back to the log of the absolute sum."""
    amax = a.amax(dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, amax.new_zeros(()))
    sumexp = torch.exp(a - amax).sum(dim=dim, keepdim=True)
    return torch.log(torch.abs(sumexp)) + amax


def _set_drop(size, idx, vals):
    """``zeros(size).at[idx].set(vals, mode="drop")`` for int ``idx``
    whose out-of-range entries are ``size``: those land in a discarded
    bin (torch's indexing raises on them)."""
    out = torch.zeros(size + 1, dtype=vals.dtype, device=vals.device)
    out[idx.long()] = vals
    return out[:size]


def _balanced_assignment(scores, rounds=4):
    """Balanced token→expert assignment: every expert gets exactly
    tokens/experts tokens and every token is assigned exactly once.

    The JAX package's replacement for the reference's auction kernel
    (``BalanceAssignment.cu``): a fixed number of dense greedy rounds —
    each round, unassigned tokens bid for their best expert with remaining
    capacity and the top bidders win (ties to the lower token: the sort is
    stable, as ``jnp.argsort`` is) — then a deterministic fill matches any
    leftovers to the remaining slots.  Static shapes, no data-dependent
    loops.  The result carries no gradient.

    Returns slot→token ids, int32 of shape (s,), grouped by expert: slot
    q*cap+i holds the i-th token assigned to expert q — a permutation of
    arange(s).
    """
    scores = scores.detach()
    s, e = scores.shape
    cap = s // e
    dev = scores.device
    # Sinkhorn normalization evens out scale differences between experts
    p = scores
    for _ in range(4):
        p = p - _logsumexp(p, 1)
        p = p - _logsumexp(p, 0)

    assigned = torch.full((s,), -1, dtype=torch.int32, device=dev)
    pos = torch.zeros((s,), dtype=torch.int32, device=dev)
    used = torch.zeros((e,), dtype=torch.int32, device=dev)
    neg = torch.tensor(-1e30, dtype=p.dtype, device=dev)
    for _ in range(rounds):
        open_e = used < cap                       # (e,)
        unas = assigned < 0                       # (s,)
        masked = torch.where(open_e[None, :] & unas[:, None], p, neg)
        choice = torch.argmax(masked, dim=1)      # (s,)
        bid = torch.where(unas & open_e[choice],
                          torch.gather(masked, 1, choice[:, None])[:, 0], neg)
        cmask = _one_hot_f(choice, e) * (bid > neg / 2)[:, None]  # (s, e)
        score_col = torch.where(cmask > 0, bid[:, None], neg)
        # rank tokens per chosen expert by bid (descending, stable)
        order = torch.argsort(-score_col, dim=0, stable=True)
        rank = torch.argsort(order, dim=0, stable=True)  # rank in column
        accept = (cmask > 0) & (rank < (cap - used)[None, :])
        zero = rank.new_zeros(())
        tok_rank = torch.sum(torch.where(accept, rank, zero), dim=1)
        acc_any = torch.any(accept, dim=1)
        new_pos = torch.sum(torch.where(accept, used[None, :].to(rank.dtype),
                                        zero), dim=1) + tok_rank
        assigned = torch.where(acc_any, choice.to(torch.int32), assigned)
        pos = torch.where(acc_any, new_pos.to(torch.int32), pos)
        used = used + torch.sum(accept, dim=0).to(torch.int32)

    # deterministic fill: k-th leftover token -> k-th free slot
    unas = assigned < 0
    token_rank = torch.cumsum(unas.to(torch.int32), dim=0) - 1   # (s,)
    slot_expert = torch.arange(e, dtype=torch.int32, device=dev)[
        :, None].expand(e, cap).reshape(-1)                      # (e*cap,)
    slot_idx = torch.arange(cap, dtype=torch.int32, device=dev).repeat(e)
    free = slot_idx >= used[slot_expert.long()]                  # slot free?
    free_rank = torch.cumsum(free.to(torch.int32), dim=0) - 1
    # token with rank r takes the slot with rank r
    tgt = torch.where(free, free_rank, torch.full_like(free_rank, s))
    fill_expert = _set_drop(s, tgt, slot_expert)
    fill_pos = _set_drop(s, tgt, slot_idx)
    # a token that is assigned reads any entry: the where keeps its own
    take = token_rank.clamp_min(0).long()
    assigned = torch.where(unas, fill_expert[take], assigned)
    pos = torch.where(unas, fill_pos[take], pos)

    slot_of_token = assigned * cap + pos                          # (s,)
    return _set_drop(s, torch.where(slot_of_token < s, slot_of_token,
                                    torch.full_like(slot_of_token, s)),
                     torch.arange(s, dtype=torch.int32, device=dev))


def balance_assignment_op(scores_node, name=None):
    """BASE-layer balanced assignment node: scores (tokens, experts) →
    slot→token permutation (see :func:`_balanced_assignment`)."""
    return SimpleOp("BalanceAssignment", [scores_node],
                    lambda c, scores: _balanced_assignment(scores), name=name)


# the graph-level all-to-alls: the JAX package exchanges rows only under
# an ``ep`` mesh (a sharding constraint, or the two-phase schedule of
# ``parallel.collectives.hierarchical_all_to_all`` on an
# (ep_outer, ep_inner) mesh) and is the identity without one; the port
# has no such mesh
alltoall_op = def_op("AllToAll", lambda c, x: x)

halltoall_op = def_op("HAllToAll", lambda c, x: x)


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
