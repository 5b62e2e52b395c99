"""The encoder-decoder Transformer of "Attention Is All You Need" (twin of
``hetu_tpu/models/transformer.py``): sinusoidal positions, post-LN
blocks, causal decoder self-attention and cross-attention to the
encoder's memory.  On the card the encoder's attention and the
cross-attention take the flash kernels' dense specialization and the
decoder's self-attention the causal one, forward, dQ and dK/dV.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, LayerNorm
from .common import masked_lm_loss


class TransformerConfig:
    def __init__(self, vocab_size=32000, d_model=512, d_ff=2048,
                 num_layers=6, num_heads=8, dropout=0.1, batch_size=8,
                 src_len=64, tgt_len=64):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.d_ff = d_ff
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.dropout = dropout
        self.batch_size = batch_size
        self.src_len = src_len
        self.tgt_len = tgt_len

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("d_model", 64)
        kw.setdefault("d_ff", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("vocab_size", 256)
        return cls(**kw)


def _sinusoid(seq_len, d_model):
    pos = np.arange(seq_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    enc = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return enc.astype(np.float32)


def _embed(cfg, ids, table, seq_len, name):
    e = ops.embedding_lookup_op(table, ids) * float(cfg.d_model) ** 0.5
    pe = Variable(name + ".sinusoid", value=_sinusoid(seq_len, cfg.d_model),
                  trainable=False)
    pe3 = ops.array_reshape_op(pe, output_shape=(1, seq_len, cfg.d_model))
    e = e + ops.broadcastto_op(pe3, e)
    e = ops.array_reshape_op(
        e, output_shape=(cfg.batch_size * seq_len, cfg.d_model))
    return ops.dropout_op(e, 1.0 - cfg.dropout)


def _ffn(cfg, x, name):
    h = Linear(cfg.d_model, cfg.d_ff, activation="relu", name=name + ".w1")(x)
    return Linear(cfg.d_ff, cfg.d_model, name=name + ".w2")(h)


def transformer_graph(cfg, name="transformer"):
    """Seq2seq training graph.  Returns (feeds, loss, logits)."""
    src = placeholder_op("src_ids", shape=(cfg.batch_size, cfg.src_len),
                         dtype=np.int32)
    tgt_in = placeholder_op("tgt_ids", shape=(cfg.batch_size, cfg.tgt_len),
                            dtype=np.int32)
    labels = placeholder_op("labels", shape=(cfg.batch_size, cfg.tgt_len),
                            dtype=np.int32)
    table = init.truncated_normal((cfg.vocab_size, cfg.d_model), 0.0, 0.02,
                                  name=name + ".embed")

    # encoder (post-LN)
    x = _embed(cfg, src, table, cfg.src_len, name + ".src")
    for i in range(cfg.num_layers):
        ln = f"{name}.enc{i}"
        mha = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                 dropout=cfg.dropout, name=ln + ".attn")
        x = LayerNorm(cfg.d_model, name=ln + ".ln1")(
            x + mha(x, cfg.batch_size, cfg.src_len))
        x = LayerNorm(cfg.d_model, name=ln + ".ln2")(
            x + ops.dropout_op(_ffn(cfg, x, ln + ".ffn"), 1.0 - cfg.dropout))
    memory = x

    # decoder
    y = _embed(cfg, tgt_in, table, cfg.tgt_len, name + ".tgt")
    for i in range(cfg.num_layers):
        ln = f"{name}.dec{i}"
        self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                       dropout=cfg.dropout, causal=True,
                                       name=ln + ".self")
        y = LayerNorm(cfg.d_model, name=ln + ".ln1")(
            y + self_attn(y, cfg.batch_size, cfg.tgt_len))
        cross = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                   dropout=cfg.dropout, name=ln + ".cross")
        y = LayerNorm(cfg.d_model, name=ln + ".ln2")(
            y + cross(y, cfg.batch_size, cfg.tgt_len, kv=memory,
                      kv_seq=cfg.src_len))
        y = LayerNorm(cfg.d_model, name=ln + ".ln3")(
            y + ops.dropout_op(_ffn(cfg, y, ln + ".ffn"), 1.0 - cfg.dropout))

    logits = Linear(cfg.d_model, cfg.vocab_size, name=name + ".out")(y)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.tgt_len)
    feeds = {"src_ids": src, "tgt_ids": tgt_in, "labels": labels}
    return feeds, loss, logits


def synthetic_copy_batch(cfg, seed=0):
    """The copy task (target = source), float32 as the JAX package draws
    it."""
    rng = np.random.RandomState(seed)
    assert cfg.src_len == cfg.tgt_len
    src = rng.randint(2, cfg.vocab_size, (cfg.batch_size, cfg.src_len))
    tgt_in = np.concatenate([np.ones((cfg.batch_size, 1)), src[:, :-1]], 1)
    return (src.astype(np.float32), tgt_in.astype(np.float32),
            src.astype(np.float32))
