"""Transformer-XL segment-recurrent LM (twin of
``hetu_tpu/models/transfoxl.py``).

Each layer's memory is a non-trainable (B, mem_len, d) Variable that the
step reads and that :class:`_StateWriteOp` rewrites with the segment's
detached hidden states through ``ctx.state_updates`` (BatchNorm's running
statistics use the same channel), so memory carries across
``Executor.run`` calls.  Attention over [memory ‖ segment] is
``sdpa_bias_op`` with ``causal=True``, whose diagonal is bottom-right
aligned (query i sees keys j <= i + mem_len), plus a learned bias over
the clamped relative distance, gathered by a constant index into
(1, H, S, M + S).  On the card that is the flash kernels' causal-bias
specialization, forward, dQ (with dbias) and dK/dV, at S_q = tgt_len and
S_kv = mem_len + tgt_len; Transformer-XL wt103's head dim of 410 / 10 =
41 takes the kernels zero-padded along D (``fa.dpad_launches``).
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Op, Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, LayerNorm
from .common import masked_lm_loss


class TransfoXLConfig:
    def __init__(self, vocab_size=267735, d_model=410, n_head=10,
                 d_inner=2100, n_layer=16, mem_len=160, clamp_len=400,
                 dropout=0.1, layer_norm_eps=1e-5, batch_size=4,
                 tgt_len=128):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_head = n_head
        self.d_inner = d_inner
        self.n_layer = n_layer
        self.mem_len = mem_len
        self.clamp_len = clamp_len
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.tgt_len = tgt_len

    @classmethod
    def base(cls, **kw):
        """Transformer-XL wt103 base (410 wide, 10 heads of 41, 16
        layers, d_inner 2100, memory 160, vocabulary 267,735)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("d_model", 128)
        kw.setdefault("n_head", 2)
        kw.setdefault("d_inner", 256)
        kw.setdefault("n_layer", 2)
        kw.setdefault("mem_len", 16)
        kw.setdefault("vocab_size", 512)
        kw.setdefault("tgt_len", 32)
        return cls(**kw)


class _StateWriteOp(Op):
    """Writes a computed value, detached, into the executor's state
    channel for a non-trainable variable (``ctx.state_updates``), and
    passes it on."""

    op_type = "StateWrite"

    def __init__(self, value_node, var, name=None):
        super().__init__([value_node, var], name=name)
        self.var = var

    def lower(self, ctx, value, var_val):
        del var_val
        new = value.detach()
        ctx.state_updates[self.var] = new
        return new

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def _rel_bias(cfg, name):
    """Learned per-head bias over the clamped relative distance q − k in
    [0, clamp_len], gathered by a constant index → (1, H, S, M+S)."""
    S, M = cfg.tgt_len, cfg.mem_len
    q = np.arange(S)[:, None]
    k = np.arange(M + S)[None, :] - M
    dist = np.clip(q - k, 0, cfg.clamp_len)       # causal distances >= 0
    table = init.truncated_normal((cfg.clamp_len + 1, cfg.n_head), 0.0, 0.02,
                                  name=name)
    idx = Variable(name + ".idx", value=dist.reshape(-1).astype(np.float32),
                   trainable=False)
    bias = ops.embedding_lookup_op(table, idx)     # (S*(M+S), H)
    bias = ops.array_reshape_op(bias, output_shape=(S, M + S, cfg.n_head))
    bias = ops.transpose_op(bias, perm=(2, 0, 1))
    return ops.array_reshape_op(bias,
                                output_shape=(1, cfg.n_head, S, M + S))


def transfoxl_model(cfg, input_ids, name="transfoxl"):
    """Returns (hidden (B*S, d), the new-memory nodes): each a
    :class:`_StateWriteOp` the step must reach."""
    B, S, M, d = cfg.batch_size, cfg.tgt_len, cfg.mem_len, cfg.d_model
    word = init.truncated_normal((cfg.vocab_size, d), 0.0, 0.02,
                                 name=name + ".word")
    x = ops.embedding_lookup_op(word, input_ids)          # (B, S, d)
    x = ops.dropout_op(x, 1.0 - cfg.dropout)
    mem_writes = []
    for i in range(cfg.n_layer):
        ln = f"{name}.layer{i}"
        mem = Variable(ln + ".mems", value=np.zeros((B, M, d), np.float32),
                       trainable=False)
        # the new memory: the last M positions of [mem ‖ x], detached
        cat = ops.concatenate_op([mem, x], axis=1)        # (B, M+S, d)
        new_mem = ops.slice_op(cat, begin=(0, S, 0), size=(B, M, d))
        mem_writes.append(_StateWriteOp(new_mem, mem, name=ln + ".memwrite"))

        flat_x = ops.array_reshape_op(x, output_shape=(B * S, d))
        flat_kv = ops.array_reshape_op(cat, output_shape=(B * (M + S), d))
        bias = _rel_bias(cfg, ln + ".rel_bias")
        mha = MultiHeadAttention(d, cfg.n_head, dropout=cfg.dropout,
                                 causal=True, name=ln + ".attn")
        a = mha(flat_x, B, S, kv=flat_kv, kv_seq=M + S, bias=bias)
        h = LayerNorm(d, cfg.layer_norm_eps, ln + ".ln1")(flat_x + a)
        f = Linear(d, cfg.d_inner, activation="relu",
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".ff1")(h)
        f = Linear(cfg.d_inner, d,
                   initializer=init.GenTruncatedNormal(0.0, 0.02),
                   name=ln + ".ff2")(f)
        f = ops.dropout_op(f, 1.0 - cfg.dropout)
        h = LayerNorm(d, cfg.layer_norm_eps, ln + ".ln2")(h + f)
        x = ops.array_reshape_op(h, output_shape=(B, S, d))
    hidden = ops.array_reshape_op(x, output_shape=(B * S, d))
    return hidden, mem_writes


def transfoxl_lm_graph(cfg, name="transfoxl"):
    """Segment-recurrent causal LM graph.  Returns (feeds dict, loss,
    logits); consecutive segments fed to ``Executor.run`` carry the
    memory across calls."""
    shape = (cfg.batch_size, cfg.tgt_len)
    input_ids = placeholder_op("input_ids", shape=shape, dtype=np.int32)
    labels = placeholder_op("labels", shape=shape, dtype=np.int32)
    hidden, mem_writes = transfoxl_model(cfg, input_ids, name)
    logits = Linear(cfg.d_model, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".lm_head")(hidden)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.tgt_len)
    # anchor the memory writes on the loss, so every step runs them
    for w in mem_writes:
        loss = loss + ops.reduce_mean_op(w, [0, 1, 2]) * 0.0
    return {"input_ids": input_ids, "labels": labels}, loss, logits
