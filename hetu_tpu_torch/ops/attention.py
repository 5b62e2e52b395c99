"""Attention ops of the ported paths (twin of ``hetu_tpu/ops/attention.py``).

``sdpa_reference`` is the plain attention, with the reference's rule that
a query row with no valid key outputs zero.  The dispatchers:

* ``dispatch_sdpa`` (dense) and ``dispatch_sdpa_masked`` (a mask node):
  the training path.  ``_split_mask_kinds`` routes a (B|1, 1, 1, S_kv)
  mask to the ``key_mask`` specialization; any other mask, and
  ``causal``, raise ``NotImplementedError`` on the card (not ported).
* ``dispatch_sdpa_decode``: the q_len=1 decode step against a KV cache
  (the ``lengths`` specialization).

On a CUDA tensor each always launches the hand-written flash kernels
(:mod:`hetu_tpu_torch.ops.kernels.flash_attention`) at every length — the
TPU package's gate (``_FLASH_MIN_LEN``, mod-128 bucketing,
``artifacts/flash_ab.json``) does not carry over and is not read — and
never falls back to ``sdpa_reference``.  On a CPU tensor each takes
``sdpa_reference`` and counts ``backend:cpu`` in the ``flash_fallbacks``
family.
"""
import math

import torch

from .base import def_op
from .kernels.flash_attention import NEG_INF, flash_attention


def sdpa_reference(q, k, v, causal=False, scale=None, mask=None, bias=None):
    """(B, H, S, D) reference attention in plain torch (float32 scores)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
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
    """Masked (B, H, S, D) attention: a key-padding mask rides the flash
    kernels' ``key_mask`` path on the card; the CPU takes the plain
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
    """Write the (B, H, 1, D) token rows into the (B, H, L, D) cache at row
    ``positions[b]`` of each sequence, IN PLACE, and return the cache.

    The JAX package returns a fresh array and lets XLA reuse the donated
    input buffer; here the write goes straight into the fed cache tensor
    (the engine feeds its own cache and reads the same tensor back).  The
    start row follows ``dynamic_update_slice``: a negative start counts
    from the end, then the start clamps into ``[0, L - 1]``.  Only the
    one-token write is ported: chunked writes (C > 1) and the ``valid``
    mask belong to chunked prefill."""
    if valid is not None or new.shape[-2] != 1:
        raise NotImplementedError(
            "kv_cache_append: chunked writes (C > 1, valid=) are not ported")
    b, _, s_kv, _ = cache.shape
    rows = positions.to(device=cache.device, dtype=torch.int64)
    rows = torch.where(rows < 0, rows + s_kv, rows).clamp(0, s_kv - 1)
    batch = torch.arange(b, device=cache.device)
    cache[batch, :, rows, :] = new[:, :, 0, :].to(cache.dtype)
    return cache


kv_cache_append_op = def_op("KVCacheAppend", _kv_cache_append)
