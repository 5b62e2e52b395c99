"""BART denoising seq2seq training (twin of ``hetu_tpu/models/bart.py``):
post-LN encoder-decoder with learned positions at BART's offset of 2,
causal decoder self-attention and cross-attention to the encoder's
memory, activations flattened to (batch*seq, d_model), and the LM head
tied to the shared token embedding.  On the card the encoder's attention
and the cross-attention take the flash kernels' dense specialization and
the decoder's self-attention the causal one, forward, dQ and dK/dV.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, LayerNorm
from .common import masked_lm_loss


class BartConfig:
    def __init__(self, vocab_size=50265, d_model=768, encoder_layers=6,
                 decoder_layers=6, encoder_attention_heads=12,
                 decoder_attention_heads=12, encoder_ffn_dim=3072,
                 decoder_ffn_dim=3072, max_position_embeddings=1024,
                 dropout=0.1, layer_norm_eps=1e-5, batch_size=8,
                 src_len=128, tgt_len=128):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.encoder_layers = encoder_layers
        self.decoder_layers = decoder_layers
        self.encoder_attention_heads = encoder_attention_heads
        self.decoder_attention_heads = decoder_attention_heads
        self.encoder_ffn_dim = encoder_ffn_dim
        self.decoder_ffn_dim = decoder_ffn_dim
        self.max_position_embeddings = max_position_embeddings
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.src_len = src_len
        self.tgt_len = tgt_len

    @classmethod
    def base(cls, **kw):
        """BART-base (768 wide, 6 + 6 layers, 12 heads, FFN 3072,
        vocabulary 50,265)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("d_model", 128)
        kw.setdefault("encoder_layers", 2)
        kw.setdefault("decoder_layers", 2)
        kw.setdefault("encoder_attention_heads", 2)
        kw.setdefault("decoder_attention_heads", 2)
        kw.setdefault("encoder_ffn_dim", 256)
        kw.setdefault("decoder_ffn_dim", 256)
        kw.setdefault("vocab_size", 512)
        return cls(**kw)


def _learned_positions(cfg, seq, name):
    """BART's learned positions start at offset 2 (pad / bos reserved)."""
    table = init.truncated_normal(
        (cfg.max_position_embeddings + 2, cfg.d_model), 0.0, 0.02, name=name)
    pos = Variable(name + ".ids",
                   value=(np.arange(seq) + 2).astype(np.float32),
                   trainable=False)
    return ops.embedding_lookup_op(table, pos)          # (seq, d_model)


def _embed(cfg, shared, ids, seq, name):
    e = ops.embedding_lookup_op(shared, ids)            # (B, seq, d)
    pe = _learned_positions(cfg, seq, name + ".pos")
    pe = ops.array_reshape_op(pe, output_shape=(1, seq, cfg.d_model))
    e = e + ops.broadcastto_op(pe, e)
    e = ops.array_reshape_op(
        e, output_shape=(cfg.batch_size * seq, cfg.d_model))
    e = LayerNorm(cfg.d_model, cfg.layer_norm_eps, name + ".ln")(e)
    return ops.dropout_op(e, 1.0 - cfg.dropout)


def _post_ln_block(cfg, x, sub, residual_name):
    return LayerNorm(cfg.d_model, cfg.layer_norm_eps, residual_name)(x + sub)


def bart_encoder(cfg, x, name="bart.encoder"):
    for i in range(cfg.encoder_layers):
        ln = f"{name}.layer{i}"
        mha = MultiHeadAttention(cfg.d_model, cfg.encoder_attention_heads,
                                 dropout=cfg.dropout, name=ln + ".attn")
        x = _post_ln_block(cfg, x, mha(x, cfg.batch_size, cfg.src_len),
                           ln + ".ln1")
        h = Linear(cfg.d_model, cfg.encoder_ffn_dim, activation="gelu",
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".fc1")(x)
        h = Linear(cfg.encoder_ffn_dim, cfg.d_model,
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".fc2")(h)
        x = _post_ln_block(cfg, x, ops.dropout_op(h, 1.0 - cfg.dropout),
                           ln + ".ln2")
    return x


def bart_decoder(cfg, y, memory, name="bart.decoder"):
    for i in range(cfg.decoder_layers):
        ln = f"{name}.layer{i}"
        self_attn = MultiHeadAttention(
            cfg.d_model, cfg.decoder_attention_heads, dropout=cfg.dropout,
            causal=True, name=ln + ".self")
        y = _post_ln_block(cfg, y,
                           self_attn(y, cfg.batch_size, cfg.tgt_len),
                           ln + ".ln1")
        cross = MultiHeadAttention(
            cfg.d_model, cfg.decoder_attention_heads, dropout=cfg.dropout,
            name=ln + ".cross")
        y = _post_ln_block(
            cfg, y, cross(y, cfg.batch_size, cfg.tgt_len, kv=memory,
                          kv_seq=cfg.src_len), ln + ".ln2")
        h = Linear(cfg.d_model, cfg.decoder_ffn_dim, activation="gelu",
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".fc1")(y)
        h = Linear(cfg.decoder_ffn_dim, cfg.d_model,
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".fc2")(h)
        y = _post_ln_block(cfg, y, ops.dropout_op(h, 1.0 - cfg.dropout),
                           ln + ".ln3")
    return y


def bart_seq2seq_graph(cfg, name="bart"):
    """Denoising seq2seq training graph (teacher forcing).  Returns
    (feeds dict, loss node, logits node); logits = h @ Eᵀ, the head tied
    to the shared embedding."""
    src = placeholder_op("input_ids", shape=(cfg.batch_size, cfg.src_len),
                         dtype=np.int32)
    tgt_in = placeholder_op("decoder_input_ids",
                            shape=(cfg.batch_size, cfg.tgt_len),
                            dtype=np.int32)
    labels = placeholder_op("labels", shape=(cfg.batch_size, cfg.tgt_len),
                            dtype=np.int32)
    shared = init.truncated_normal((cfg.vocab_size, cfg.d_model), 0.0, 0.02,
                                   name=name + ".shared_embed")
    enc_in = _embed(cfg, shared, src, cfg.src_len, name + ".enc_embed")
    dec_in = _embed(cfg, shared, tgt_in, cfg.tgt_len, name + ".dec_embed")
    memory = bart_encoder(cfg, enc_in, name + ".encoder")
    hidden = bart_decoder(cfg, dec_in, memory, name + ".decoder")
    logits = ops.matmul_op(hidden, shared, trans_B=True)  # tied head
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.tgt_len)
    feeds = {"input_ids": src, "decoder_input_ids": tgt_in, "labels": labels}
    return feeds, loss, logits
