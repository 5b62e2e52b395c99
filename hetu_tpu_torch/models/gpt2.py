"""GPT-2 one-token decode graph (the decode half of
``hetu_tpu/models/gpt2.py``).  Weight names match the JAX graph exactly
(``gpt2.h{i}.attn.{q,k,v,o}``, ``.ln1``, ``.ln2``, ``.mlp_fc``,
``.mlp_proj``, ``gpt2.wte``, ``.wpe``, ``.ln_f``, ``.lm_head``), so the
JAX package's parameters load into the port by name.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import placeholder_op
from ..layers.core import Linear, LayerNorm


class GPT2Config:
    def __init__(self, vocab_size=50257, n_positions=1024, n_embd=768,
                 n_layer=12, n_head=12, resid_pdrop=0.1, embd_pdrop=0.1,
                 attn_pdrop=0.1, layer_norm_epsilon=1e-5,
                 batch_size=8, seq_len=128):
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.n_embd = n_embd
        self.n_layer = n_layer
        self.n_head = n_head
        self.resid_pdrop = resid_pdrop
        self.embd_pdrop = embd_pdrop
        self.attn_pdrop = attn_pdrop
        self.layer_norm_epsilon = layer_norm_epsilon
        self.batch_size = batch_size
        self.seq_len = seq_len

    @classmethod
    def small(cls, **kw):
        """GPT-2 small (HF ``gpt2``): 12 layers, 768 wide, 12 heads."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("n_embd", 128)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 2)
        kw.setdefault("vocab_size", 512)
        return cls(**kw)


class _DecodeBlockLayer:
    """Per-block weight handles (column-parallel q/k/v + mlp_fc,
    row-parallel o + mlp_proj), returned for API parity with the JAX
    graph, whose tensor-parallel plans bind them."""

    def __init__(self, in_kernels, out_kernels):
        self.in_kernels = in_kernels
        self.out_kernels = out_kernels


def _block_decode(cfg, x, k_cache, v_cache, positions, name):
    """One-token pre-LN block against the KV cache: x + attn(ln1(x)),
    then x + mlp(ln2(x)).  No dropout: decode is a serving graph.
    Returns (x, new_k_cache, new_v_cache, layer)."""
    dk = cfg.n_embd // cfg.n_head
    h = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln1")(x)

    def heads(t):
        # (B, n_embd) -> (B, H, 1, dk); -1 keeps the graph batch-agnostic
        t = ops.array_reshape_op(t, output_shape=(-1, 1, cfg.n_head, dk))
        return ops.transpose_op(t, perm=(0, 2, 1, 3))

    lq = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.q")
    lk = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.k")
    lv = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.v")
    lo = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.o")
    q = heads(lq(h))
    kc = ops.kv_cache_append_op(k_cache, heads(lk(h)), positions)
    vc = ops.kv_cache_append_op(v_cache, heads(lv(h)), positions)
    att = ops.sdpa_decode_op(q, kc, vc, positions)       # (B, H, 1, dk)
    att = ops.transpose_op(att, perm=(0, 2, 1, 3))
    att = ops.array_reshape_op(att, output_shape=(-1, cfg.n_embd))
    x = x + lo(att)
    h = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln2")(x)
    fc = Linear(cfg.n_embd, 4 * cfg.n_embd, activation="gelu",
                initializer=init.GenTruncatedNormal(0.0, 0.02),
                name=name + ".mlp_fc")
    proj = Linear(4 * cfg.n_embd, cfg.n_embd,
                  initializer=init.GenTruncatedNormal(0.0, 0.02),
                  name=name + ".mlp_proj")
    x = x + proj(fc(h))
    layer = _DecodeBlockLayer(
        [lq.weight_var, lk.weight_var, lv.weight_var, fc.weight_var],
        [lo.weight_var, proj.weight_var])
    return x, kc, vc, layer


def gpt2_decode_graph(cfg, max_len=None, name="gpt2"):
    """One-token autoregressive decode graph over per-layer KV caches.

    Feeds (batch-leading; the decode engine buckets the batch at run
    time): ``input_ids`` (B, 1) int32, ``positions`` (B,) int32 (the
    cache row the token writes; keys beyond it stay invisible), and
    ``k_cache_i`` / ``v_cache_i`` (B, n_head, L, head_dim) float32 per
    layer, written in place.

    Returns ``(feeds, logits, cache_fetches, layers)``: ``logits`` is
    (B, vocab) for the fed token, ``cache_fetches`` is [k0', v0', k1',
    v1', ...] in feed order."""
    max_len = int(max_len or cfg.n_positions)
    dk = cfg.n_embd // cfg.n_head
    ids = placeholder_op("input_ids", shape=(cfg.batch_size, 1),
                         dtype=np.int32)
    positions = placeholder_op("positions", shape=(cfg.batch_size,),
                               dtype=np.int32)
    wte = init.truncated_normal((cfg.vocab_size, cfg.n_embd), 0.0, 0.02,
                                name=name + ".wte")
    wpe = init.truncated_normal((cfg.n_positions, cfg.n_embd), 0.0, 0.01,
                                name=name + ".wpe")
    x = ops.embedding_lookup_op(wte, ids)                # (B, 1, n_embd)
    x = ops.array_reshape_op(x, output_shape=(-1, cfg.n_embd))
    x = x + ops.embedding_lookup_op(wpe, positions)      # (B, n_embd)
    feeds = {"input_ids": ids, "positions": positions}
    cache_fetches, layers = [], []
    for i in range(cfg.n_layer):
        kc = placeholder_op(
            f"k_cache_{i}", dtype=np.float32,
            shape=(cfg.batch_size, cfg.n_head, max_len, dk))
        vc = placeholder_op(
            f"v_cache_{i}", dtype=np.float32,
            shape=(cfg.batch_size, cfg.n_head, max_len, dk))
        feeds[f"k_cache_{i}"] = kc
        feeds[f"v_cache_{i}"] = vc
        x, kc2, vc2, layer = _block_decode(cfg, x, kc, vc, positions,
                                           f"{name}.h{i}")
        cache_fetches += [kc2, vc2]
        layers.append(layer)
    x = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln_f")(x)
    logits = Linear(cfg.n_embd, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".lm_head")(x)
    return feeds, logits, cache_fetches, layers
