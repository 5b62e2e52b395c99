"""T5 encoder-decoder (twin of ``hetu_tpu/models/t5.py``).

RMSNorm (T5LayerNorm), the bucketed relative-position bias as a trainable
(num_buckets, heads) table gathered with bucket indices computed on the
host, attention with that additive bias through ``MultiHeadAttention(bias=)``
(the flash kernels' bias specialization on the card: the encoder's with a
key-padding mask, the decoder's with ``causal``), cross-attention through
the key-mask kernels.  Variable names equal the JAX graph's, so
``Executor.load_dict`` carries ``hetu_tpu``'s weights across.
``T5Config(context_parallel=)`` is refused by the attention layer (not
ported).
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, RMSNorm
from .common import masked_lm_loss


class T5Config:
    def __init__(self, vocab_size=32128, d_model=512, d_ff=2048,
                 num_layers=6, num_heads=8, relative_attention_num_buckets=32,
                 relative_attention_max_distance=128, dropout_rate=0.1,
                 layer_norm_epsilon=1e-6, batch_size=8, src_len=128,
                 tgt_len=128, context_parallel=None):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.relative_attention_max_distance = relative_attention_max_distance
        self.dropout_rate = dropout_rate
        self.layer_norm_epsilon = layer_norm_epsilon
        self.batch_size = batch_size
        self.src_len = src_len
        self.tgt_len = tgt_len
        self.context_parallel = context_parallel

    @classmethod
    def small(cls, **kw):
        """T5-small's published widths (HF ``google-t5/t5-small``)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("d_model", 128)
        kw.setdefault("d_ff", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("vocab_size", 512)
        return cls(**kw)


def _relative_bucket(rel_pos, bidirectional, num_buckets, max_distance):
    """T5's log-spaced relative position bucketing (numpy, on the host).
    ``rel_pos`` = memory_pos - context_pos; causal mode buckets the *past*
    distance max(-rel, 0), so visible keys get distinct buckets and masked
    future keys collapse to 0."""
    ret = np.zeros_like(rel_pos)
    if bidirectional:
        num_buckets //= 2
        ret += (rel_pos > 0).astype(np.int64) * num_buckets
        n = np.abs(rel_pos)
    else:
        n = np.maximum(-rel_pos, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


def _relpos_bias(cfg, q_len, k_len, bidirectional, name):
    """Trainable (num_buckets, heads) table gathered with the bucket
    indices → a bias node broadcastable to (1, H, q_len, k_len).  Every
    layer of the stack shares it, so its gradient sums every layer's
    dbias."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    buckets = _relative_bucket(mem - ctx, bidirectional,
                               cfg.relative_attention_num_buckets,
                               cfg.relative_attention_max_distance)
    table = init.truncated_normal(
        (cfg.relative_attention_num_buckets, cfg.num_heads), 0.0, 0.02,
        name=name)
    idx = Variable(name + ".buckets",
                   value=buckets.reshape(-1).astype(np.float32),
                   trainable=False)
    bias = ops.embedding_lookup_op(table, idx)          # (q*k, H)
    bias = ops.array_reshape_op(bias, output_shape=(q_len, k_len,
                                                    cfg.num_heads))
    bias = ops.transpose_op(bias, perm=(2, 0, 1))       # (H, q, k)
    return ops.array_reshape_op(bias,
                                output_shape=(1, cfg.num_heads, q_len, k_len))


def _ffn(cfg, x, name):
    h = Linear(cfg.d_model, cfg.d_ff, activation="relu", bias=False,
               initializer=init.GenTruncatedNormal(0.0, 0.02),
               name=name + ".wi")(x)
    h = ops.dropout_op(h, 1.0 - cfg.dropout_rate)
    return Linear(cfg.d_ff, cfg.d_model, bias=False,
                  initializer=init.GenTruncatedNormal(0.0, 0.02),
                  name=name + ".wo")(h)


def t5_encoder(cfg, x_embed, mask=None, name="t5.encoder"):
    """x_embed: (batch*src_len, d_model); returns the same shape.
    ``mask``: an optional (B, 1, 1, src_len) key-padding mask node; it
    composes with the relative-position bias."""
    bias = _relpos_bias(cfg, cfg.src_len, cfg.src_len, True,
                        name + ".relpos")
    x = x_embed
    for i in range(cfg.num_layers):
        ln = name + f".block{i}"
        h = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, ln + ".ln1")(x)
        mha = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                 context_parallel=cfg.context_parallel,
                                 name=ln + ".attn")
        x = x + mha(h, cfg.batch_size, cfg.src_len, mask=mask, bias=bias,
                    scale=1.0)
        h = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, ln + ".ln2")(x)
        x = x + ops.dropout_op(_ffn(cfg, h, ln + ".ffn"),
                               1.0 - cfg.dropout_rate)
    return RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, name + ".ln_f")(x)


def t5_decoder(cfg, y_embed, memory, mem_mask=None, name="t5.decoder"):
    """y_embed: (batch*tgt_len, d_model); memory: the encoder output.
    ``mem_mask``: an optional (B, 1, 1, src_len) padding mask over the
    memory keys of the cross-attention."""
    self_bias = _relpos_bias(cfg, cfg.tgt_len, cfg.tgt_len, False,
                             name + ".relpos")
    x = y_embed
    for i in range(cfg.num_layers):
        ln = name + f".block{i}"
        h = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, ln + ".ln1")(x)
        self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                       causal=True,
                                       context_parallel=cfg.context_parallel,
                                       name=ln + ".self")
        x = x + self_attn(h, cfg.batch_size, cfg.tgt_len, bias=self_bias,
                          scale=1.0)
        h = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, ln + ".ln2")(x)
        cross = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                   name=ln + ".cross")
        x = x + cross(h, cfg.batch_size, cfg.tgt_len, kv=memory,
                      kv_seq=cfg.src_len, mask=mem_mask, scale=1.0)
        h = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, ln + ".ln3")(x)
        x = x + ops.dropout_op(_ffn(cfg, h, ln + ".ffn"),
                               1.0 - cfg.dropout_rate)
    return RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, name + ".ln_f")(x)


def t5_seq2seq_graph(cfg, name="t5", use_mask=False):
    """Teacher-forced seq2seq training graph: (feeds dict, loss node,
    logits node).  ``use_mask=True`` adds an int32 ``attention_mask``
    (B, src_len) input, threaded through the encoder's self-attention and
    the decoder's cross-attention."""
    src = placeholder_op("input_ids", shape=(cfg.batch_size, cfg.src_len),
                         dtype=np.int32)
    tgt_in = placeholder_op("decoder_input_ids",
                            shape=(cfg.batch_size, cfg.tgt_len),
                            dtype=np.int32)
    labels = placeholder_op("labels", shape=(cfg.batch_size, cfg.tgt_len),
                            dtype=np.int32)
    mask = None
    if use_mask:
        attention_mask = placeholder_op(
            "attention_mask", shape=(cfg.batch_size, cfg.src_len),
            dtype=np.int32)
        mask = ops.array_reshape_op(
            attention_mask, output_shape=(cfg.batch_size, 1, 1, cfg.src_len))

    shared = init.truncated_normal((cfg.vocab_size, cfg.d_model), 0.0, 0.02,
                                   name=name + ".shared_embed")
    src_e = ops.array_reshape_op(
        ops.embedding_lookup_op(shared, src),
        output_shape=(cfg.batch_size * cfg.src_len, cfg.d_model))
    tgt_e = ops.array_reshape_op(
        ops.embedding_lookup_op(shared, tgt_in),
        output_shape=(cfg.batch_size * cfg.tgt_len, cfg.d_model))
    mem = t5_encoder(cfg, src_e, mask=mask, name=name + ".encoder")
    dec = t5_decoder(cfg, tgt_e, mem, mem_mask=mask,
                     name=name + ".decoder")
    # T5 scales the decoder output by d_model^-0.5 before the untied lm head
    dec = dec * float(cfg.d_model) ** -0.5
    logits = Linear(cfg.d_model, cfg.vocab_size, bias=False,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".lm_head")(dec)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.tgt_len)
    feeds = {"input_ids": src, "decoder_input_ids": tgt_in, "labels": labels}
    if use_mask:
        feeds["attention_mask"] = attention_mask
    return feeds, loss, logits


def synthetic_seq2seq_batch(cfg, seed=0, padded=False):
    """Seeded random (src, tgt_in, labels) int32 batches; ``padded=True``
    also returns an int32 attention_mask with source lengths drawn from
    [src_len // 4, src_len] (PAD id 0 past each length)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.src_len))
    tgt = rng.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.tgt_len + 1))
    if not padded:
        return (src.astype(np.int32), tgt[:, :-1].astype(np.int32),
                tgt[:, 1:].astype(np.int32))
    lengths = rng.randint(max(1, cfg.src_len // 4), cfg.src_len + 1,
                          cfg.batch_size)
    attn = (np.arange(cfg.src_len)[None, :] < lengths[:, None])
    src[~attn] = 0
    return (src.astype(np.int32), tgt[:, :-1].astype(np.int32),
            tgt[:, 1:].astype(np.int32), attn.astype(np.int32))
