"""Shared model-graph helpers (twin of ``hetu_tpu/models/common.py``)."""
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


def patchify(images, batch, channels, image_size, patch_size, hidden,
             name, bias=True):
    """(B, C, H, W) → (B*P, hidden) with one product (shared by ViT,
    Swin, CLIP and MAE): reshape (B, C, g, p, g, p) → transpose →
    (B*g*g, C*p*p) @ W."""
    from .. import initializers as init
    from ..layers.core import Linear
    p_ = patch_size
    g = image_size // p_
    x = ops.array_reshape_op(
        images, output_shape=(batch, channels, g, p_, g, p_))
    x = ops.transpose_op(x, perm=(0, 2, 4, 1, 3, 5))
    x = ops.array_reshape_op(
        x, output_shape=(batch * g * g, channels * p_ * p_))
    return Linear(channels * p_ * p_, hidden, bias=bias,
                  initializer=init.GenTruncatedNormal(0.0, 0.02),
                  name=name)(x)


def pre_ln_block(hidden, heads, seq, batch, eps, name, causal=False,
                 dropout=0.0):
    """The pre-LN transformer encoder block (ViT, CLIP and MAE towers):
    x + attn(ln1(x)); x + mlp(ln2(x))."""
    from .. import initializers as init
    from ..layers.attention import MultiHeadAttention
    from ..layers.core import Linear, LayerNorm

    def block(x):
        h = LayerNorm(hidden, eps, name + ".ln1")(x)
        mha = MultiHeadAttention(hidden, heads, causal=causal,
                                 dropout=dropout, name=name + ".attn")
        x = x + mha(h, batch, seq)
        h = LayerNorm(hidden, eps, name + ".ln2")(x)
        h = Linear(hidden, 4 * hidden, activation="gelu",
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=name + ".mlp1")(h)
        h = Linear(4 * hidden, hidden,
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=name + ".mlp2")(h)
        if dropout:
            h = ops.dropout_op(h, 1.0 - dropout)
        return x + h
    return block


def split_heads(x, batch, seq, heads, head_dim):
    """(batch*seq, hidden) → (batch, heads, seq, head_dim)."""
    x = ops.array_reshape_op(x, output_shape=(batch, seq, heads, head_dim))
    return ops.transpose_op(x, perm=(0, 2, 1, 3))


def merge_heads(x, batch, seq, hidden):
    """(batch, heads, seq, head_dim) → (batch*seq, hidden)."""
    x = ops.transpose_op(x, perm=(0, 2, 1, 3))
    return ops.array_reshape_op(x, output_shape=(batch * seq, hidden))


def post_ln_encoder_stack(x, cfg, attn_factory, name):
    """BERT-style post-LN encoder stack shared by the static-sparse-mask
    models (Longformer, BigBird): per layer, x = LN(x + attn(x));
    x = LN(x + dropout(FFN(x))).  ``attn_factory(layer_name) -> callable``.
    Reads hidden_size / num_hidden_layers / intermediate_size /
    hidden_dropout_prob / layer_norm_eps off ``cfg``."""
    from .. import initializers as init
    from ..layers.core import Linear, LayerNorm
    for i in range(cfg.num_hidden_layers):
        ln = f"{name}.layer{i}"
        attn = attn_factory(ln + ".attn")
        x = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                      ln + ".ln1")(x + attn(x))
        h = Linear(cfg.hidden_size, cfg.intermediate_size, activation="gelu",
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".ffn1")(x)
        h = Linear(cfg.intermediate_size, cfg.hidden_size,
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".ffn2")(h)
        h = ops.dropout_op(h, 1.0 - cfg.hidden_dropout_prob)
        x = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                      ln + ".ln2")(x + h)
    return x
