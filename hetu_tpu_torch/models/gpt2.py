"""GPT-2 (twin of ``hetu_tpu/models/gpt2.py``): the causal-LM training
graph (pre-LN blocks, fused causal ``sdpa_op``), the one-token decode
graph and the chunked-prefill decode graph over per-layer KV caches.

Weight names match the JAX graphs exactly (``gpt2.h{i}.attn.{q,k,v,o}``,
``.ln1``, ``.ln2``, ``.mlp_fc``, ``.mlp_proj``, ``gpt2.wte``, ``.wpe``,
``.ln_f``, ``.lm_head``) and are the same in all three graphs, so the
JAX package's parameters load into the port by name, and a trained
executor's weights load into the decode engine by name with no
conversion.  The training graph alone holds ``gpt2.pos_ids``, a
non-trainable float32 ``arange(seq_len)``.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, LayerNorm
from .common import masked_lm_loss


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
    def medium(cls, **kw):
        kw.setdefault("n_embd", 1024)
        kw.setdefault("n_layer", 24)
        kw.setdefault("n_head", 16)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("n_embd", 128)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 2)
        kw.setdefault("vocab_size", 512)
        return cls(**kw)


def _block(cfg, x, name):
    """Pre-LN transformer block: x + attn(ln1(x)); x + mlp(ln2(x))."""
    h = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln1")(x)
    # attn_pdrop applies to the attention OUTPUT, not the probabilities
    # (layers/attention.py)
    mha = MultiHeadAttention(cfg.n_embd, cfg.n_head, dropout=cfg.attn_pdrop,
                             causal=True, name=name + ".attn")
    x = x + mha(h, cfg.batch_size, cfg.seq_len)
    h = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln2")(x)
    h = Linear(cfg.n_embd, 4 * cfg.n_embd, activation="gelu",
               initializer=init.GenTruncatedNormal(0.0, 0.02),
               name=name + ".mlp_fc")(h)
    h = Linear(4 * cfg.n_embd, cfg.n_embd,
               initializer=init.GenTruncatedNormal(0.0, 0.02),
               name=name + ".mlp_proj")(h)
    h = ops.dropout_op(h, 1.0 - cfg.resid_pdrop)
    return x + h


def gpt2_model(cfg, input_ids, name="gpt2"):
    """Returns the hidden states node, (batch*seq, n_embd)."""
    wte = init.truncated_normal((cfg.vocab_size, cfg.n_embd), 0.0, 0.02,
                                name=name + ".wte")
    wpe = init.truncated_normal((cfg.n_positions, cfg.n_embd), 0.0, 0.01,
                                name=name + ".wpe")
    positions = Variable(name + ".pos_ids",
                         value=np.arange(cfg.seq_len, dtype=np.float32),
                         trainable=False)
    x = ops.embedding_lookup_op(wte, input_ids) \
        + ops.embedding_lookup_op(wpe, positions)
    x = ops.array_reshape_op(
        x, output_shape=(cfg.batch_size * cfg.seq_len, cfg.n_embd))
    x = ops.dropout_op(x, 1.0 - cfg.embd_pdrop)
    for i in range(cfg.n_layer):
        x = _block(cfg, x, f"{name}.h{i}")
    return LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln_f")(x)


def gpt2_lm_graph(cfg, name="gpt2"):
    """Causal LM training graph: next-token prediction.

    Returns (feeds dict, loss node, logits node).  ``input_ids`` and
    ``labels``: (batch, seq) int32, labels -1 at padded positions
    (ignored)."""
    shape = (cfg.batch_size, cfg.seq_len)
    input_ids = placeholder_op("input_ids", shape=shape, dtype=np.int32)
    labels = placeholder_op("labels", shape=shape, dtype=np.int32)
    hidden = gpt2_model(cfg, input_ids, name)
    logits = Linear(cfg.n_embd, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".lm_head")(hidden)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.seq_len)
    return {"input_ids": input_ids, "labels": labels}, loss, logits


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


def _block_decode_chunked(cfg, x, ids, k_cache, v_cache, positions, valid,
                          name):
    """Chunked-prefill twin of :func:`_block_decode`: the residual stream
    is (B*C, n_embd) for a (B, C) token chunk, weights identical by name,
    the cache write masked by ``valid`` (rows past a sequence's real
    consumption keep the old cache bytes) and attention through the
    q_len=C entry, causal within the chunk.
    Returns (x, new_k_cache, new_v_cache, layer)."""
    h = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln1")(x)

    def heads(t):
        # (B*C, n_embd) -> (B, H, C, dk), (B, C) recovered from ids
        return ops.split_heads_chunk_op(t, ids, n_head=cfg.n_head)

    lq = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.q")
    lk = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.k")
    lv = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.v")
    lo = Linear(cfg.n_embd, cfg.n_embd, name=name + ".attn.o")
    q = heads(lq(h))
    kc = ops.kv_cache_append_op(k_cache, heads(lk(h)), positions, valid)
    vc = ops.kv_cache_append_op(v_cache, heads(lv(h)), positions, valid)
    att = ops.sdpa_prefill_op(q, kc, vc, positions)      # (B, H, C, dk)
    att = ops.merge_heads_chunk_op(att)                  # (B*C, n_embd)
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


def gpt2_decode_chunked_graph(cfg, max_len=None, chunk=4, name="gpt2"):
    """Chunked-prefill decode graph: each step consumes a (B, C) token
    chunk instead of one token per sequence, so a P-token prompt ingests
    in ceil(P/C) steps instead of P.  Weight names match
    :func:`gpt2_decode_graph` / :func:`gpt2_lm_graph`; the decode engine
    loads this graph's executor from the primary executor's parameters.

    Feeds (the engine buckets the batch and the chunk at run time;
    ``chunk`` only sizes the nominal placeholders): ``input_ids`` (B, C)
    int32 (a generating row rides along with its one token at column 0),
    ``positions`` (B,) int32 (the cache row of each sequence's first
    chunk token), ``valid`` (B,) int32 (how many chunk columns each
    sequence consumes, 0 for idle slots; rows ``>= valid`` neither write
    the cache nor reach the logits), and ``k_cache_i`` / ``v_cache_i``
    (B, n_head, L, head_dim) float32 per layer, written in place.

    Returns ``(feeds, logits, cache_fetches, layers)`` like the one-token
    graph; ``logits`` is (B, vocab) for each sequence's last consumed
    chunk token, gathered before ln_f / lm_head."""
    max_len = int(max_len or cfg.n_positions)
    chunk = int(chunk)
    dk = cfg.n_embd // cfg.n_head
    ids = placeholder_op("input_ids", shape=(cfg.batch_size, chunk),
                         dtype=np.int32)
    positions = placeholder_op("positions", shape=(cfg.batch_size,),
                               dtype=np.int32)
    valid = placeholder_op("valid", shape=(cfg.batch_size,), dtype=np.int32)
    wte = init.truncated_normal((cfg.vocab_size, cfg.n_embd), 0.0, 0.02,
                                name=name + ".wte")
    wpe = init.truncated_normal((cfg.n_positions, cfg.n_embd), 0.0, 0.01,
                                name=name + ".wpe")
    pos2d = ops.chunk_positions_op(positions, ids,
                                   limit=cfg.n_positions)   # (B, C)
    x = ops.embedding_lookup_op(wte, ids)             # (B, C, n_embd)
    x = ops.array_reshape_op(x, output_shape=(-1, cfg.n_embd))
    pe = ops.embedding_lookup_op(wpe, pos2d)          # (B, C, n_embd)
    pe = ops.array_reshape_op(pe, output_shape=(-1, cfg.n_embd))
    x = x + pe
    feeds = {"input_ids": ids, "positions": positions, "valid": valid}
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
        x, kc2, vc2, layer = _block_decode_chunked(
            cfg, x, ids, kc, vc, positions, valid, f"{name}.h{i}")
        cache_fetches += [kc2, vc2]
        layers.append(layer)
    # each sequence's last consumed row, before ln_f / lm_head: LayerNorm
    # is row-wise, so the gather commutes and the vocabulary product
    # shrinks C-fold
    x = ops.chunk_emit_gather_op(x, ids, valid)       # (B, n_embd)
    x = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, name + ".ln_f")(x)
    logits = Linear(cfg.n_embd, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".lm_head")(x)
    return feeds, logits, cache_fetches, layers


def synthetic_lm_batch(cfg, seed=0):
    """Next-token synthetic batch (a copy of the JAX package's): ids
    shifted left for labels, both returned as float32 for the int32
    placeholders."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.seq_len + 1))
    return (ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.float32))
