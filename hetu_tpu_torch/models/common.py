"""Shared model-graph helpers (subset of ``hetu_tpu/models/common.py``)."""
from .. import ops


def masked_lm_loss(logits, labels, n_tokens, ignored_index=-1):
    """Token-masked cross-entropy: mean over positions whose label !=
    ``ignored_index``.  ``logits``: (n_tokens, vocab); ``labels``: any
    shape flattening to (n_tokens,).

    The dtypes follow the JAX graph: ``flat * 0.0`` of the int32 labels is
    float32, ``ne_op`` returns the labels' int32, and the int32 count
    becomes float32 when 1e-6 is added."""
    flat = ops.array_reshape_op(labels, output_shape=(n_tokens,))
    per_tok = ops.softmaxcrossentropy_sparse_op(logits, flat,
                                                ignored_index=ignored_index)
    valid = ops.ne_op(flat, flat * 0.0 + float(ignored_index))
    return ops.reduce_sum_op(per_tok, [0]) \
        / (ops.reduce_sum_op(valid, [0]) + 1e-6)


def split_heads(x, batch, seq, heads, head_dim):
    """(batch*seq, hidden) → (batch, heads, seq, head_dim)."""
    x = ops.array_reshape_op(x, output_shape=(batch, seq, heads, head_dim))
    return ops.transpose_op(x, perm=(0, 2, 1, 3))


def merge_heads(x, batch, seq, hidden):
    """(batch, heads, seq, head_dim) → (batch*seq, hidden)."""
    x = ops.transpose_op(x, perm=(0, 2, 1, 3))
    return ops.array_reshape_op(x, output_shape=(batch * seq, hidden))
