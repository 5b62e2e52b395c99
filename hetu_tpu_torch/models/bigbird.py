"""BigBird MLM pretraining (twin of ``hetu_tpu/models/bigbird.py``).

The window + global + random block-sparse pattern is one static (1, 1,
S, S) 0/1 mask Variable, built at graph construction with the random
blocks drawn once from ``mask_seed`` (so both packages draw the same
mask), shared by every layer and fed to ``sdpa_masked_op``: on the card
the flash kernels' full-mask specialization at group ``one``, forward,
dQ and dK/dV, which walk only the (query tile, key tile) pairs that hold
a visible one (Longformer's path).
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.core import Linear, LayerNorm
from .common import (masked_lm_loss, merge_heads, post_ln_encoder_stack,
                     split_heads)


class BigBirdConfig:
    def __init__(self, vocab_size=50358, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, block_size=64, num_random_blocks=3,
                 num_global_blocks=1, max_position_embeddings=4096,
                 hidden_dropout_prob=0.1, layer_norm_eps=1e-12,
                 batch_size=2, seq_len=1024, mask_seed=0):
        assert seq_len % block_size == 0
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.block_size = block_size
        self.num_random_blocks = num_random_blocks
        self.num_global_blocks = num_global_blocks
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.mask_seed = mask_seed

    @classmethod
    def base(cls, **kw):
        """BigBird-base (768 wide, 12 layers, 12 heads, blocks of 64, 3
        random blocks, vocabulary 50,358)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("hidden_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 2)
        kw.setdefault("intermediate_size", 256)
        kw.setdefault("block_size", 8)
        kw.setdefault("num_random_blocks", 2)
        kw.setdefault("vocab_size", 512)
        kw.setdefault("seq_len", 64)
        return cls(**kw)


def bigbird_attention_mask(seq_len, block_size, num_random_blocks,
                           num_global_blocks=1, seed=0):
    """Static block-sparse mask (S, S): a sliding window of 3 blocks, the
    global first block(s), and ``num_random_blocks`` random key blocks a
    query block, drawn from ``seed``."""
    nb = seq_len // block_size
    rng = np.random.RandomState(seed)
    blk = np.zeros((nb, nb), bool)
    for i in range(nb):
        for j in (i - 1, i, i + 1):                   # window
            if 0 <= j < nb:
                blk[i, j] = True
        cand = [j for j in range(nb)
                if abs(j - i) > 1 and j >= num_global_blocks]
        if cand:
            pick = rng.choice(cand, size=min(num_random_blocks, len(cand)),
                              replace=False)
            blk[i, pick] = True                        # random
    blk[:num_global_blocks, :] = True                  # global rows
    blk[:, :num_global_blocks] = True                  # global cols
    return np.kron(blk, np.ones((block_size, block_size))).astype(np.float32)


class _BigBirdLayer:
    def __init__(self, cfg, name, mask=None):
        h = cfg.hidden_size
        self.cfg = cfg
        self.heads = cfg.num_attention_heads
        self.dk = h // self.heads
        self.q = Linear(h, h, name=name + ".q")
        self.k = Linear(h, h, name=name + ".k")
        self.v = Linear(h, h, name=name + ".v")
        self.o = Linear(h, h, name=name + ".o")
        if mask is None:  # standalone use; the model shares one per stack
            m = bigbird_attention_mask(
                cfg.seq_len, cfg.block_size, cfg.num_random_blocks,
                cfg.num_global_blocks, cfg.mask_seed)
            mask = Variable(name + ".sparse_mask",
                            value=m.reshape(1, 1, cfg.seq_len, cfg.seq_len),
                            trainable=False)
        self.mask = mask

    def _split(self, x):
        cfg = self.cfg
        return split_heads(x, cfg.batch_size, cfg.seq_len, self.heads,
                           self.dk)

    def __call__(self, x):
        cfg = self.cfg
        o = ops.sdpa_masked_op(self._split(self.q(x)), self._split(self.k(x)),
                               self._split(self.v(x)), self.mask)
        o = merge_heads(o, cfg.batch_size, cfg.seq_len, cfg.hidden_size)
        return ops.dropout_op(self.o(o), 1.0 - cfg.hidden_dropout_prob)


def bigbird_model(cfg, input_ids, name="bigbird"):
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
    m = bigbird_attention_mask(
        cfg.seq_len, cfg.block_size, cfg.num_random_blocks,
        cfg.num_global_blocks, cfg.mask_seed)
    shared_mask = Variable(name + ".sparse_mask",
                           value=m.reshape(1, 1, cfg.seq_len, cfg.seq_len),
                           trainable=False)
    return post_ln_encoder_stack(
        x, cfg, lambda nm: _BigBirdLayer(cfg, nm, mask=shared_mask), name)


def bigbird_mlm_graph(cfg, name="bigbird"):
    """MLM pretraining graph.  Returns (feeds dict, loss, logits)."""
    shape = (cfg.batch_size, cfg.seq_len)
    input_ids = placeholder_op("input_ids", shape=shape, dtype=np.int32)
    labels = placeholder_op("labels", shape=shape, dtype=np.int32)
    x = bigbird_model(cfg, input_ids, name)
    logits = Linear(cfg.hidden_size, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".mlm_head")(x)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.seq_len)
    return {"input_ids": input_ids, "labels": labels}, loss, logits
