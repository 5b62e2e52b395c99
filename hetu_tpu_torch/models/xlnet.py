"""XLNet two-stream permutation-LM pretraining (twin of
``hetu_tpu/models/xlnet.py``).

The same graph, node for node:

* the factorization-order visibility masks are built on the host per
  batch from the sampled permutation (:func:`perm_masks_from_order`) and
  fed as (B, 1, S, S) placeholders;
* the content stream h attends with the inclusive mask (j visible if
  perm_pos[j] <= perm_pos[i], self included), the query stream g queries
  the same content keys / values with the exclusive mask (strictly
  earlier in the permutation), the projection weights shared between
  the streams;
* predictions come from the query stream; relative position enters as a
  learned clamped-distance bias (1, H, S, S) that both streams of a layer
  share.

Attention is ``sdpa_masked_bias_op``: on the card the flash kernels'
full-mask-with-bias specialization, forward, dQ with dbias and dK/dV (the
mask is group ``b``, the bias group ``h``, in one launch), the bias's
gradient summed over the batch and, through autograd, over the two
streams.  The query stream's first token in each permutation sees no key
and outputs zero.  Variable names equal the JAX graph's, so
``Executor.load_dict`` carries ``hetu_tpu``'s weights across.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.core import Linear, LayerNorm
from .common import masked_lm_loss


class XLNetConfig:
    def __init__(self, vocab_size=32000, d_model=768, n_head=12,
                 d_inner=3072, n_layer=12, clamp_len=256, dropout=0.1,
                 layer_norm_eps=1e-12, batch_size=4, seq_len=128):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_head = n_head
        self.d_inner = d_inner
        self.n_layer = n_layer
        self.clamp_len = clamp_len
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.seq_len = seq_len

    @classmethod
    def base(cls, **kw):
        """XLNet-base (HF ``xlnet/xlnet-base-cased``): 12 layers, d_model
        768, 12 heads, d_inner 3072, vocab 32,000."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("d_model", 128)
        kw.setdefault("n_head", 2)
        kw.setdefault("d_inner", 256)
        kw.setdefault("n_layer", 2)
        kw.setdefault("vocab_size", 512)
        kw.setdefault("seq_len", 32)
        return cls(**kw)


def perm_masks_from_order(perm):
    """Build (content_mask, query_mask) from a permutation.

    ``perm``: (B, S) int — perm[b, k] is the position processed k-th.
    content_mask[b, i, j] = 1 iff perm_pos[j] <= perm_pos[i] (self incl.)
    query_mask[b, i, j]   = 1 iff perm_pos[j] <  perm_pos[i]
    """
    B, S = perm.shape
    rank = np.empty_like(perm)
    for b in range(B):
        rank[b, perm[b]] = np.arange(S)
    r_i = rank[:, :, None]
    r_j = rank[:, None, :]
    content = (r_j <= r_i).astype(np.float32)
    query = (r_j < r_i).astype(np.float32)
    return content.reshape(B, 1, S, S), query.reshape(B, 1, S, S)


def _rel_bias(cfg, name):
    """Trainable (clamp_len + 1, H) table gathered with the clamped
    distances |i - j| → a (1, H, S, S) bias node."""
    S = cfg.seq_len
    dist = np.clip(np.abs(np.arange(S)[:, None] - np.arange(S)[None, :]),
                   0, cfg.clamp_len)
    table = init.truncated_normal((cfg.clamp_len + 1, cfg.n_head), 0.0, 0.02,
                                  name=name)
    idx = Variable(name + ".idx", value=dist.reshape(-1).astype(np.float32),
                   trainable=False)
    bias = ops.embedding_lookup_op(table, idx)
    bias = ops.array_reshape_op(bias, output_shape=(S, S, cfg.n_head))
    bias = ops.transpose_op(bias, perm=(2, 0, 1))
    return ops.array_reshape_op(bias, output_shape=(1, cfg.n_head, S, S))


class _TwoStreamLayer:
    """One XLNet layer: shared QKV weights, two masked attention streams."""

    def __init__(self, cfg, name):
        d = cfg.d_model
        self.cfg = cfg
        self.heads = cfg.n_head
        self.dk = d // self.heads
        self.q = Linear(d, d, bias=False, name=name + ".q")
        self.k = Linear(d, d, bias=False, name=name + ".k")
        self.v = Linear(d, d, bias=False, name=name + ".v")
        self.o = Linear(d, d, name=name + ".o")
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, name + ".ln1")
        self.f1 = Linear(d, cfg.d_inner, activation="gelu",
                         initializer=init.GenTruncatedNormal(0.0, 0.02),
                         name=name + ".ff1")
        self.f2 = Linear(cfg.d_inner, d,
                         initializer=init.GenTruncatedNormal(0.0, 0.02),
                         name=name + ".ff2")
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps, name + ".ln2")
        self.bias = _rel_bias(cfg, name + ".rel_bias")

    def _split(self, x):
        cfg = self.cfg
        x = ops.array_reshape_op(
            x, output_shape=(cfg.batch_size, cfg.seq_len, self.heads,
                             self.dk))
        return ops.transpose_op(x, perm=(0, 2, 1, 3))

    def _attend(self, q_src, k_heads, v_heads, mask):
        cfg = self.cfg
        q = self._split(self.q(q_src))
        o = ops.sdpa_masked_bias_op(q, k_heads, v_heads, mask, self.bias)
        o = ops.transpose_op(o, perm=(0, 2, 1, 3))
        o = ops.array_reshape_op(
            o, output_shape=(cfg.batch_size * cfg.seq_len, cfg.d_model))
        return self.o(o)

    def _ffn(self, x):
        return self.ln2(x + self.f2(self.f1(x)))

    def __call__(self, h, g, content_mask, query_mask):
        k = self._split(self.k(h))
        v = self._split(self.v(h))
        h2 = self.ln1(h + self._attend(h, k, v, content_mask))
        g2 = self.ln1(g + self._attend(g, k, v, query_mask))
        return self._ffn(h2), self._ffn(g2)


def xlnet_model(cfg, input_ids, content_mask, query_mask, name="xlnet"):
    """Returns (content stream, query stream), each (B*S, d)."""
    B, S, d = cfg.batch_size, cfg.seq_len, cfg.d_model
    word = init.truncated_normal((cfg.vocab_size, d), 0.0, 0.02,
                                 name=name + ".word")
    h = ops.embedding_lookup_op(word, input_ids)
    h = ops.array_reshape_op(h, output_shape=(B * S, d))
    h = ops.dropout_op(h, 1.0 - cfg.dropout)
    # the query stream starts from one learned vector w (the paper's
    # init); tiling it = one embedding lookup with constant zero ids
    g0 = init.truncated_normal((1, d), 0.0, 0.02, name=name + ".mask_emb")
    g_ids = Variable(name + ".g_ids", value=np.zeros(B * S, np.float32),
                     trainable=False)
    g = ops.embedding_lookup_op(g0, g_ids)
    for i in range(cfg.n_layer):
        layer = _TwoStreamLayer(cfg, f"{name}.layer{i}")
        h, g = layer(h, g, content_mask, query_mask)
    return h, g


def xlnet_plm_graph(cfg, name="xlnet"):
    """Permutation-LM pretraining graph.

    Feeds: input_ids (B,S) int32; content_mask/query_mask (B,1,S,S) from
    :func:`perm_masks_from_order`; labels (B,S) with -1 outside the
    predicted target positions.  Returns (feeds, loss, logits).
    """
    B, S = cfg.batch_size, cfg.seq_len
    input_ids = placeholder_op("input_ids", shape=(B, S), dtype=np.int32)
    labels = placeholder_op("labels", shape=(B, S), dtype=np.int32)
    content_mask = placeholder_op("content_mask", shape=(B, 1, S, S))
    query_mask = placeholder_op("query_mask", shape=(B, 1, S, S))
    h, g = xlnet_model(cfg, input_ids, content_mask, query_mask, name)
    logits = Linear(cfg.d_model, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".lm_head")(g)          # predictions from g
    loss = masked_lm_loss(logits, labels, B * S)
    feeds = {"input_ids": input_ids, "labels": labels,
             "content_mask": content_mask, "query_mask": query_mask}
    return feeds, loss, logits


def synthetic_plm_batch(cfg, seed=0, target_frac=0.25):
    """ids + permutation masks + labels on the last-k permutation targets
    (a copy of the JAX package's: the same numbers from the same seed)."""
    rng = np.random.RandomState(seed)
    B, S = cfg.batch_size, cfg.seq_len
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    perm = np.stack([rng.permutation(S) for _ in range(B)])
    cmask, qmask = perm_masks_from_order(perm)
    labels = np.full((B, S), -1, np.int64)
    k = max(1, int(S * target_frac))
    for b in range(B):
        targets = perm[b, -k:]                    # last-k in factorization
        labels[b, targets] = ids[b, targets]
    return ids, cmask.astype(np.float32), qmask.astype(np.float32), \
        labels.astype(np.int32)
