"""Attention ops of the ported paths (twin of ``hetu_tpu/ops/attention.py``).

``sdpa_reference`` is the plain attention, with the reference's rule that
a query row with no valid key outputs zero.  The dispatchers:

* ``dispatch_sdpa`` (dense or ``causal``) and ``dispatch_sdpa_masked`` (a
  mask node): the training path.  ``_split_mask_kinds`` routes a
  (B|1, 1, 1, S_kv) mask to the ``key_mask`` specialization and any
  other broadcastable mask to the full-mask one, forward and backward
  (Longformer's static (1, 1, S, S) sliding-window mask: group ``one``).
* ``dispatch_sdpa_bias`` (an additive bias, dense or ``causal``) and
  ``dispatch_sdpa_masked_bias`` (a mask node and a bias): T5's relative
  position bias with its key-padding mask, XLNet's with its (B, 1, S, S)
  permutation masks.  The mask takes ``_split_mask_kinds``: a key mask
  rides the bias kernels, a full mask the mask-with-bias ones, the mask
  and the bias each in its own group mode (XLNet: mask ``b``, bias
  ``h``).  The bias's gradient comes from the kernels (dbias, or dkbias
  for a (., ., 1, S_kv) key-bias strip), summed over its broadcast
  group.
* ``dispatch_sdpa_decode``: the q_len=1 decode step against a KV cache
  (the ``lengths`` specialization).
* ``dispatch_sdpa_prefill``: the q_len=C chunked-prefill step against a
  KV cache (the full-mask specialization; the per-sequence positions
  cannot be written as one causal diagonal).

``kv_cache_append_op`` and the chunk ops (``chunk_positions_op``,
``split_heads_chunk_op``, ``merge_heads_chunk_op``,
``chunk_emit_gather_op``) are the plain tensor code around them.  Not
ported: the varlen dispatcher and the ring and Ulysses schedules.

On a CUDA tensor each always launches the hand-written flash kernels
(:mod:`hetu_tpu_torch.ops.kernels.flash_attention`) at every length — the
TPU package's gate (``_FLASH_MIN_LEN``, mod-128 bucketing, the prefill gate,
``artifacts/flash_ab.json``) does not carry over and is not read — and
never falls back to ``sdpa_reference``.  On a CPU tensor each takes
``sdpa_reference`` and counts ``backend:cpu`` in the ``flash_fallbacks``
family.
"""
import math

import torch

from .base import def_op
from .kernels.flash_attention import NEG_INF, flash_attention


class ScoresF32(torch.autograd.Function):
    """q·kᵀ with a float32 result from bfloat16 operands (softmax needs the
    float32 range), whose backward rounds the float32 cotangent to the
    operands' dtype before the dQ and dK products: the JAX package's
    ``_scores_f32`` custom VJP, the discipline of the flash backward
    kernels.  A bfloat16 product accumulates in float32 and rounds once,
    in both packages."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.matmul(q.float(), k.float().transpose(-1, -2))

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        g = g.to(q.dtype)
        return (torch.matmul(g, k),
                torch.matmul(g.transpose(-1, -2), q).to(k.dtype))


def sdpa_reference(q, k, v, causal=False, scale=None, mask=None, bias=None):
    """(B, H, S, D) reference attention in plain torch (float32 scores).
    With bfloat16 inputs the scores come from :class:`ScoresF32` and the
    probabilities are rounded to bfloat16 before P·V, as in the JAX
    package; the output is in the inputs' dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.dtype == torch.float32:
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    else:
        logits = ScoresF32.apply(q, k) * scale
    if bias is not None:
        logits = logits + bias
    valid = None
    if causal:
        s_q, s_k = logits.shape[-2:]
        valid = torch.ones((s_q, s_k), dtype=torch.bool,
                           device=q.device).tril(s_k - s_q)
    if mask is not None:
        m = mask.to(torch.bool)
        valid = m if valid is None else torch.logical_and(valid, m)
    if valid is not None:
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if valid is not None:
        # a query row with NO valid key yields ZERO output, not the
        # uniform softmax over masked keys
        row_any = torch.any(valid, dim=-1, keepdim=True)
        probs = torch.where(row_any, probs, torch.zeros_like(probs))
    return torch.matmul(probs.to(q.dtype), v)


def _note_cpu():
    from ..metrics import record_flash_fallback
    record_flash_fallback("backend:cpu")


def dispatch_sdpa(q, k, v, causal=False, scale=None):
    """Dense (B, H, S, D) attention: the flash kernels on the card, the
    plain attention on the CPU."""
    if q.device.type == "cpu":
        _note_cpu()
        return sdpa_reference(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)


def _sdpa(c, q, k, v, causal=False, scale=None):
    return dispatch_sdpa(q, k, v, causal=causal, scale=scale)


sdpa_op = def_op("ScaledDotProductAttention", _sdpa)


def _split_mask_kinds(mask, q):
    """Route a broadcastable mask: a (B|1, 1, 1, S_kv) mask is a pure
    key-padding mask, the kernels' O(S) ``key_mask``; anything else is a
    full mask.  Returns (key_mask, full_mask) with exactly one set."""
    b = q.shape[0]
    if mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        km = mask.reshape(mask.shape[0], mask.shape[-1])
        if km.shape[0] == 1:
            km = km.expand(b, km.shape[-1])
        return km, None
    return None, mask


def dispatch_sdpa_masked(q, k, v, mask, causal=False, scale=None):
    """Masked (B, H, S, D) attention: on the card a key-padding mask
    rides the flash kernels' ``key_mask`` path and any other mask the
    full-mask kernels, forward and backward; the CPU takes the plain
    attention."""
    if q.device.type == "cpu":
        _note_cpu()
        return sdpa_reference(q, k, v, causal=causal, scale=scale, mask=mask)
    km, fm = _split_mask_kinds(mask, q)
    return flash_attention(q, k, v, causal=causal, scale=scale, key_mask=km,
                           mask=fm)


def _sdpa_masked(c, q, k, v, mask, causal=False, scale=None):
    return dispatch_sdpa_masked(q, k, v, mask, causal=causal, scale=scale)


sdpa_masked_op = def_op("ScaledDotProductAttentionMasked", _sdpa_masked)


def dispatch_sdpa_bias(q, k, v, bias, causal=False, scale=None):
    """(B, H, S, D) attention with an additive logit ``bias``
    broadcastable to (B, H, S_q, S_kv): the flash kernels' bias
    specialization on the card, the plain attention on the CPU."""
    if q.device.type == "cpu":
        _note_cpu()
        return sdpa_reference(q, k, v, causal=causal, scale=scale, bias=bias)
    return flash_attention(q, k, v, causal=causal, scale=scale, bias=bias)


def _sdpa_bias(c, q, k, v, bias, causal=False, scale=None):
    """Attention with an additive logit bias (T5 relative position bias)."""
    return dispatch_sdpa_bias(q, k, v, bias, causal=causal, scale=scale)


sdpa_bias_op = def_op("ScaledDotProductAttentionBias", _sdpa_bias)


def dispatch_sdpa_masked_bias(q, k, v, mask, bias, causal=False,
                              scale=None):
    """Masked and biased (B, H, S, D) attention: on the card a
    key-padding mask rides the bias kernels' ``key_mask`` path and any
    other mask the full-mask-with-bias kernels; the CPU takes the plain
    attention."""
    if q.device.type == "cpu":
        _note_cpu()
        return sdpa_reference(q, k, v, causal=causal, scale=scale, mask=mask,
                              bias=bias)
    km, fm = _split_mask_kinds(mask, q)
    return flash_attention(q, k, v, causal=causal, scale=scale, key_mask=km,
                           mask=fm, bias=bias)


def _sdpa_masked_bias(c, q, k, v, mask, bias, causal=False, scale=None):
    """Masked attention with an additive bias (T5's padded encoder,
    XLNet's two streams)."""
    return dispatch_sdpa_masked_bias(q, k, v, mask, bias, causal=causal,
                                     scale=scale)


sdpa_masked_bias_op = def_op("ScaledDotProductAttentionMaskedBias",
                             _sdpa_masked_bias)


def dispatch_sdpa_decode(q, k_cache, v_cache, positions, scale=None):
    """One decode step: ``q`` (B, H, 1, D) against ``k_cache``/``v_cache``
    (B, H, L, D) with the new token already appended at ``positions``
    (B,); keys beyond each position are invisible."""
    lengths = positions.to(torch.int32) + 1
    if q.device.type == "cpu":
        _note_cpu()
        s_kv = k_cache.shape[-2]
        cols = torch.arange(s_kv, device=q.device)[None, None, None, :]
        mask = cols < lengths[:, None, None, None]
        return sdpa_reference(q, k_cache, v_cache, scale=scale, mask=mask)
    return flash_attention(q.contiguous(), k_cache.contiguous(),
                           v_cache.contiguous(), scale=scale,
                           lengths=lengths.contiguous())


def _sdpa_decode(c, q, k_cache, v_cache, positions, scale=None):
    return dispatch_sdpa_decode(q, k_cache, v_cache, positions, scale=scale)


sdpa_decode_op = def_op("ScaledDotProductAttentionDecode", _sdpa_decode)


def _kv_cache_append(c, cache, new, positions, valid=None):
    """Write the (B, H, C, D) token rows into the (B, H, L, D) cache at
    rows ``positions[b] .. positions[b] + C`` of each sequence, IN PLACE,
    and return the cache.  C = 1 is the decode write, C > 1 a
    chunked-prefill write.

    ``valid`` (B,) int: rows ``>= valid[b]`` of the chunk are not
    written, so a ragged chunk (a row that consumes fewer than C tokens,
    or an idle slot with valid = 0) leaves the cache bytes equal to the
    token-by-token path's.

    The JAX package returns a fresh array and lets XLA reuse the donated
    input buffer; here the write goes straight into the fed cache tensor
    (the engine feeds its own cache and reads the same tensor back).  The
    start row follows ``dynamic_update_slice``: a negative start counts
    from the end, then the start clamps into ``[0, L - C]`` (the engine
    grows the cache so that the window never has to shift)."""
    b, _, s_kv, _ = cache.shape
    chunk = new.shape[-2]
    if chunk > s_kv:
        raise ValueError(f"kv_cache_append: a chunked write of {chunk} rows "
                         f"does not fit a cache of {s_kv} rows")
    start = positions.to(device=cache.device, dtype=torch.int64)
    start = torch.where(start < 0, start + s_kv, start).clamp(0, s_kv - chunk)
    rows = start[:, None] + torch.arange(chunk, device=cache.device)[None, :]
    batch = torch.arange(b, device=cache.device)[:, None]
    rows_new = new.to(cache.dtype).permute(0, 2, 1, 3)        # (B, C, H, D)
    if valid is not None:
        keep = torch.arange(chunk, device=cache.device)[None, :] \
            < valid.to(device=cache.device, dtype=torch.int64)[:, None]
        rows_new = torch.where(keep[:, :, None, None], rows_new,
                               cache[batch, :, rows, :])
    cache[batch, :, rows, :] = rows_new
    return cache


kv_cache_append_op = def_op("KVCacheAppend", _kv_cache_append)


def dispatch_sdpa_prefill(q, k_cache, v_cache, positions, scale=None):
    """A chunked prefill step: ``q`` (B, H, C, D), this chunk's queries,
    against ``k_cache``/``v_cache`` (B, H, L, D) with the chunk's rows
    already appended at ``positions .. positions + C``.  ``positions``
    (B,) is the cache row of each sequence's first chunk token;
    chunk-local query j sees keys ``< positions + j + 1`` (causal within
    the chunk, everything before it visible).  The (B, 1, C, L) mask is
    built here, as the JAX package builds it, and goes to the full-mask
    forward kernel on the card at every chunk and cache length.  Rows
    past a sequence's real prompt are don't-cares: the caller's cache
    write masks them and the emit gather slices them away."""
    chunk, s_kv = q.shape[-2], k_cache.shape[-2]
    lengths = (positions.to(torch.int32)[:, None] + 1
               + torch.arange(chunk, dtype=torch.int32,
                              device=q.device)[None, :])          # (B, C)
    cols = torch.arange(s_kv, dtype=torch.int32, device=q.device)
    mask = cols[None, None, None, :] < lengths[:, None, :, None]
    if q.device.type == "cpu":
        _note_cpu()
        return sdpa_reference(q, k_cache, v_cache, scale=scale, mask=mask)
    return flash_attention(q, k_cache, v_cache, scale=scale, mask=mask)


def _sdpa_prefill(c, q, k_cache, v_cache, positions, scale=None):
    return dispatch_sdpa_prefill(q, k_cache, v_cache, positions, scale=scale)


sdpa_prefill_op = def_op("ScaledDotProductAttentionPrefill", _sdpa_prefill)


def _chunk_positions(c, positions, ids, limit=None):
    """Per-token cache positions of a (B, C) chunk: ``positions[b] + j``
    for chunk-local token j, clamped to ``limit - 1`` so idle slots and
    ragged tails index a real (ignored) position-embedding row."""
    chunk = ids.shape[-1]
    p = positions.to(torch.int32)[:, None] \
        + torch.arange(chunk, dtype=torch.int32,
                       device=positions.device)[None, :]
    if limit is not None:
        p = p.clamp(max=int(limit) - 1)
    return p


chunk_positions_op = def_op("ChunkPositions", _chunk_positions)


def _split_heads_chunk(c, t, ids, n_head=1):
    """(B*C, H*D) projected activations -> (B, H, C, D) heads, with the
    (B, C) shape recovered from the ``ids`` feed."""
    b, chunk = ids.shape
    return t.reshape(b, chunk, n_head, -1).permute(0, 2, 1, 3)


split_heads_chunk_op = def_op("SplitHeadsChunk", _split_heads_chunk)


def _merge_heads_chunk(c, att):
    """(B, H, C, D) attention outputs -> (B*C, H*D) for the residual
    stream."""
    b, h, chunk, d = att.shape
    return att.permute(0, 2, 1, 3).reshape(b * chunk, h * d)


merge_heads_chunk_op = def_op("MergeHeadsChunk", _merge_heads_chunk)


def _chunk_emit_gather(c, hidden, ids, valid):
    """Each sequence's LAST consumed chunk row out of the (B*C, E) hidden
    stream: row ``valid[b] - 1`` (clamped into the chunk) of batch b ->
    (B, E).  Taken before ln_f / lm_head, so a chunked step pays the
    vocabulary projection for B rows, not B*C."""
    b, chunk = ids.shape
    h3 = hidden.reshape(b, chunk, hidden.shape[-1])
    rows = (valid.to(torch.int64) - 1).clamp(0, chunk - 1)
    return h3[torch.arange(b, device=hidden.device), rows]


chunk_emit_gather_op = def_op("ChunkEmitGather", _chunk_emit_gather)
