"""Reformer causal LM (twin of ``hetu_tpu/models/reformer.py``).

LSH attention: random-rotation bucketing, a stable sort by bucket,
chunked attention over the sorted order with one chunk of lookback, then
the inverse permutation.  The JAX package writes it in plain ``jnp``
with no Pallas kernel, so the port writes it in plain PyTorch as its own
op (``LSHAttention``), with autograd's gradient; no flash kernel
launches on this path.  Shared-QK projections and fixed random rotations
a layer follow the paper; blocks keep plain residuals.

``argmax`` over the rotated projections and the bucket sort can flip
between the packages when two rotated values lie within rounding of each
other; the parity test picks a seed with no such near tie.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.core import Linear, LayerNorm
from ..ops.base import def_op
from .common import masked_lm_loss


class ReformerConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, num_buckets=32, chunk_length=64,
                 max_position_embeddings=4096, hidden_dropout_prob=0.1,
                 layer_norm_eps=1e-12, batch_size=2, seq_len=1024):
        assert seq_len % chunk_length == 0
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.num_buckets = num_buckets
        self.chunk_length = chunk_length
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.seq_len = seq_len

    @classmethod
    def base(cls, **kw):
        """Reformer-base (768 wide, 12 layers, 12 heads, 32 buckets,
        chunks of 64)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("hidden_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 2)
        kw.setdefault("intermediate_size", 256)
        kw.setdefault("num_buckets", 4)
        kw.setdefault("chunk_length", 16)
        kw.setdefault("vocab_size", 512)
        kw.setdefault("seq_len", 64)
        return cls(**kw)


def _take(x, idx):
    """``x`` (B, H, S, ...) rows reordered along S by ``idx`` (B, H, S)."""
    idx = idx.reshape(*idx.shape, *([1] * (x.ndim - 3)))
    return torch.gather(x, 2, idx.expand(*idx.shape[:3], *x.shape[3:]))


def lsh_attention(qk, v, rotations, chunk_length, causal=True):
    """Single-round LSH attention, (B, H, S, D) → (B, H, S, D).

    ``rotations``: (D, n_buckets // 2) fixed random projections.  Sorted
    bucket chunks with one chunk of lookback; a token's own key weighs
    -1e5 (the paper's last resort, not -inf); ``causal`` masks later
    *original* positions; the first chunk's lookback (the wrap of the
    roll) is masked."""
    b, h, s, d = qk.shape
    c = chunk_length
    nc = s // c
    rot = torch.einsum("bhsd,df->bhsf", qk, rotations)
    buckets = torch.argmax(torch.cat([rot, -rot], -1), -1)      # (B,H,S)
    pos = torch.arange(s, device=qk.device)[None, None, :]
    # stable sort, bucket-major and position-minor (the keys are distinct)
    order = torch.argsort(buckets * (s + 1) + pos, dim=-1)     # (B,H,S)
    inv = torch.argsort(order, dim=-1)

    sq = _take(qk, order)
    sv = _take(v, order)
    spos = torch.gather(pos.expand(b, h, s), 2, order)
    sq_c = sq.reshape(b, h, nc, c, d)
    sk_c = sq_c / torch.clamp(torch.linalg.vector_norm(
        sq_c, dim=-1, keepdim=True), min=1e-6)                 # shared-QK
    sv_c = sv.reshape(b, h, nc, c, d)
    spos_c = spos.reshape(b, h, nc, c)

    def with_prev(x):
        return torch.cat([torch.roll(x, 1, dims=2), x], dim=3)

    keys = with_prev(sk_c)                                  # (B,H,nc,2c,D)
    vals = with_prev(sv_c)
    kpos = with_prev(spos_c[..., None])[..., 0]             # (B,H,nc,2c)

    logits = torch.einsum("bhncd,bhnkd->bhnck", sq_c.float(),
                          keys.float()) / np.sqrt(d)
    qpos = spos_c[..., :, None]
    kp = kpos[..., None, :]
    if causal:
        logits = torch.where(kp > qpos, torch.full_like(logits, -1e30),
                             logits)
    logits = torch.where(kp == qpos, torch.full_like(logits, -1e5), logits)
    first = (torch.arange(nc, device=qk.device) == 0)[None, None, :, None,
                                                      None]
    look = (torch.arange(2 * c, device=qk.device) < c)[None, None, None,
                                                       None, :]
    logits = torch.where(first & look, torch.full_like(logits, -1e30),
                         logits)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnck,bhnkd->bhncd", probs.to(vals.dtype), vals)
    out = out.reshape(b, h, s, d).to(qk.dtype)
    return _take(out, inv)                                  # un-sort


lsh_attention_op = def_op(
    "LSHAttention",
    lambda ctx, qk, v, rotations, chunk_length=64, causal=True:
        lsh_attention(qk, v, rotations, chunk_length, causal))


class ReformerSelfAttention:
    def __init__(self, cfg, name, seed=0):
        h = cfg.hidden_size
        self.cfg = cfg
        self.heads = cfg.num_attention_heads
        self.dk = h // self.heads
        self.qk = Linear(h, h, bias=False, name=name + ".qk")  # shared QK
        self.v = Linear(h, h, bias=False, name=name + ".v")
        self.o = Linear(h, h, name=name + ".o")
        rng = np.random.RandomState(seed)
        self.rot = Variable(
            name + ".rotations",
            value=rng.randn(self.dk, cfg.num_buckets // 2).astype(np.float32),
            trainable=False)

    def _split(self, x):
        cfg = self.cfg
        x = ops.array_reshape_op(
            x, output_shape=(cfg.batch_size, cfg.seq_len, self.heads,
                             self.dk))
        return ops.transpose_op(x, perm=(0, 2, 1, 3))

    def __call__(self, x):
        cfg = self.cfg
        qk = self._split(self.qk(x))
        v = self._split(self.v(x))
        o = lsh_attention_op(qk, v, self.rot,
                             chunk_length=cfg.chunk_length, causal=True)
        o = ops.transpose_op(o, perm=(0, 2, 1, 3))
        o = ops.array_reshape_op(
            o, output_shape=(cfg.batch_size * cfg.seq_len, cfg.hidden_size))
        return self.o(o)


def reformer_model(cfg, input_ids, name="reformer"):
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
    for i in range(cfg.num_hidden_layers):
        ln = f"{name}.layer{i}"
        h = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, ln + ".ln1")(x)
        attn = ReformerSelfAttention(cfg, ln + ".attn", seed=i)
        x = x + attn(h)
        h = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, ln + ".ln2")(x)
        h = Linear(cfg.hidden_size, cfg.intermediate_size, activation="gelu",
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".ffn1")(h)
        h = Linear(cfg.intermediate_size, cfg.hidden_size,
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".ffn2")(h)
        x = x + ops.dropout_op(h, 1.0 - cfg.hidden_dropout_prob)
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, name + ".ln_f")(x)


def reformer_lm_graph(cfg, name="reformer"):
    """Causal LM graph.  Returns (feeds dict, loss, logits)."""
    shape = (cfg.batch_size, cfg.seq_len)
    input_ids = placeholder_op("input_ids", shape=shape, dtype=np.int32)
    labels = placeholder_op("labels", shape=shape, dtype=np.int32)
    x = reformer_model(cfg, input_ids, name)
    logits = Linear(cfg.hidden_size, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".lm_head")(x)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.seq_len)
    return {"input_ids": input_ids, "labels": labels}, loss, logits
