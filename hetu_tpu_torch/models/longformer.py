"""Longformer MLM pretraining (twin of ``hetu_tpu/models/longformer.py``).

The sliding-window + global attention pattern is one static (1, 1, S, S)
0/1 mask Variable shared by every layer and fed to ``sdpa_masked_op``; on
the card it takes the flash kernels' full-mask specialization, forward,
dQ and dK/dV (group ``one``).  The kernels skip no tile for a data mask:
at S = 4096 with a 512 window they walk every (query tile, key tile)
pair though about 12.6 % of the pairs are visible.  The global query
projection (``q_global``) is blended in at the global positions through a
static 0/1 selector, as in the JAX graph.  Variable names equal the JAX
graph's, so ``Executor.load_dict`` carries ``hetu_tpu``'s weights across.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.core import Linear, LayerNorm
from .common import (masked_lm_loss, merge_heads, post_ln_encoder_stack,
                     split_heads)


class LongformerConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, attention_window=512,
                 num_global_tokens=1, max_position_embeddings=4098,
                 hidden_dropout_prob=0.1, layer_norm_eps=1e-5,
                 batch_size=2, seq_len=1024):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.attention_window = attention_window
        self.num_global_tokens = num_global_tokens
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.seq_len = seq_len

    @classmethod
    def base(cls, **kw):
        """Longformer-base widths (HF ``allenai/longformer-base-4096``: 12
        layers, 768 wide, 12 heads, window 512, 4098 positions; the
        repository's vocabulary is 30,522, the checkpoint's 50,265)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("hidden_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 2)
        kw.setdefault("intermediate_size", 256)
        kw.setdefault("attention_window", 8)
        kw.setdefault("vocab_size", 512)
        kw.setdefault("seq_len", 64)
        return cls(**kw)


def longformer_attention_mask(seq_len, window, num_global=1):
    """Static sliding-window + global mask, (S, S) float 0/1.

    Position i attends to |i - j| <= window/2; the first ``num_global``
    tokens attend everywhere and are attended by everyone (the reference's
    global-attention ids — CLS by convention).
    """
    half = max(1, window // 2)
    i = np.arange(seq_len)[:, None]
    j = np.arange(seq_len)[None, :]
    local = np.abs(i - j) <= half
    glob = (i < num_global) | (j < num_global)
    return (local | glob).astype(np.float32)


class LongformerSelfAttention:
    def __init__(self, cfg, name, mask=None):
        self.cfg = cfg
        h = cfg.hidden_size
        self.h = cfg.num_attention_heads
        self.dk = h // self.h
        self.q = Linear(h, h, name=name + ".q")
        self.k = Linear(h, h, name=name + ".k")
        self.v = Linear(h, h, name=name + ".v")
        # separate global query projection (Longformer's q_global) blended
        # in at the global token positions via a static 0/1 selector
        self.qg = Linear(h, h, name=name + ".q_global")
        self.o = Linear(h, h, name=name + ".o")
        if mask is None:  # standalone use; models share one across layers
            m = longformer_attention_mask(cfg.seq_len, cfg.attention_window,
                                          cfg.num_global_tokens)
            mask = Variable(
                name + ".window_mask",
                value=m.reshape(1, 1, cfg.seq_len, cfg.seq_len),
                trainable=False)
        self.mask = mask
        gsel = (np.arange(cfg.seq_len) < cfg.num_global_tokens)
        gsel = np.tile(gsel.astype(np.float32), cfg.batch_size)[:, None]
        self.gsel = Variable(name + ".global_sel", value=gsel,
                             trainable=False)

    def _split(self, x):
        cfg = self.cfg
        return split_heads(x, cfg.batch_size, cfg.seq_len, self.h, self.dk)

    def __call__(self, x):
        cfg = self.cfg
        qmix = self.q(x) * (1.0 - self.gsel) + self.qg(x) * self.gsel
        o = ops.sdpa_masked_op(self._split(qmix), self._split(self.k(x)),
                               self._split(self.v(x)), self.mask)
        o = merge_heads(o, cfg.batch_size, cfg.seq_len, cfg.hidden_size)
        return ops.dropout_op(self.o(o), 1.0 - cfg.hidden_dropout_prob)


def longformer_model(cfg, input_ids, name="longformer"):
    """The sequence output node, (batch*seq, hidden)."""
    tokens = cfg.batch_size * cfg.seq_len
    word = init.truncated_normal((cfg.vocab_size, cfg.hidden_size), 0.0, 0.02,
                                 name=name + ".word")
    pos = init.truncated_normal(
        (cfg.max_position_embeddings, cfg.hidden_size), 0.0, 0.02,
        name=name + ".pos")
    pos_ids = Variable(name + ".pos_ids",
                       value=np.arange(cfg.seq_len, dtype=np.float32),
                       trainable=False)
    x = ops.embedding_lookup_op(word, input_ids) \
        + ops.embedding_lookup_op(pos, pos_ids)
    x = ops.array_reshape_op(x, output_shape=(tokens, cfg.hidden_size))
    x = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, name + ".emb_ln")(x)
    x = ops.dropout_op(x, 1.0 - cfg.hidden_dropout_prob)
    m = longformer_attention_mask(cfg.seq_len, cfg.attention_window,
                                  cfg.num_global_tokens)
    shared_mask = Variable(
        name + ".window_mask",
        value=m.reshape(1, 1, cfg.seq_len, cfg.seq_len), trainable=False)
    return post_ln_encoder_stack(
        x, cfg,
        lambda nm: LongformerSelfAttention(cfg, nm, mask=shared_mask), name)


def longformer_mlm_graph(cfg, name="longformer"):
    """MLM pretraining graph. Returns (feeds dict, loss, logits)."""
    shape = (cfg.batch_size, cfg.seq_len)
    input_ids = placeholder_op("input_ids", shape=shape, dtype=np.int32)
    labels = placeholder_op("labels", shape=shape, dtype=np.int32)
    x = longformer_model(cfg, input_ids, name)
    logits = Linear(cfg.hidden_size, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".mlm_head")(x)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.seq_len)
    return {"input_ids": input_ids, "labels": labels}, loss, logits


def synthetic_mlm_ids(cfg, seed=0, mask_frac=0.15):
    """Seeded (ids, labels) int32 of shape (B, S): uniform ids and
    ``mask_frac`` of the positions labelled with their id, -1 elsewhere
    (the draw ``examples/transformers/train_lm.py`` makes for its MLM
    models)."""
    rng = np.random.RandomState(seed)
    shape = (cfg.batch_size, cfg.seq_len)
    ids = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    labels = np.where(rng.rand(*shape) < mask_frac, ids, -1).astype(np.int32)
    return ids, labels
