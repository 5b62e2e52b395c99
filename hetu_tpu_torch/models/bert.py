"""BERT pretraining graph (twin of ``hetu_tpu/models/bert.py``).

The same graph, node for node: attention is the fused ``sdpa_op`` /
``sdpa_masked_op`` (the hand-written flash kernels on the card) and
activations flow as (batch*seq, hidden) 2-D tensors.  Variable names match
the JAX graph letter for letter (``bert.embeddings.word.weight``,
``bert.layer{i}.attn.{q,k,v,o}``, ``.ln1``, ``.ffn1``, ``.ffn2``,
``.ln2``, ``bert.mlm_transform``, ``.mlm_ln``, ``.mlm_decoder``,
``bert.pooler.dense``, ``bert.seq_relationship``), so the JAX package's
weights load into the port by name.
"""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import initializers as init
from ..graph.node import Variable, placeholder_op
from ..layers.attention import MultiHeadAttention
from ..layers.core import Linear, LayerNorm, Embedding
from .common import masked_lm_loss


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, layer_norm_eps=1e-12,
                 batch_size=8, seq_len=128):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.layer_norm_eps = layer_norm_eps
        self.batch_size = batch_size
        self.seq_len = seq_len

    @classmethod
    def base(cls, **kw):
        """BERT-base (HF ``bert-base-uncased``): 12 layers, hidden 768,
        12 heads, intermediate 3072, vocab 30522."""
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_hidden_layers", 24)
        kw.setdefault("num_attention_heads", 16)
        kw.setdefault("intermediate_size", 4096)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("hidden_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 2)
        kw.setdefault("intermediate_size", 512)
        kw.setdefault("vocab_size", 1024)
        return cls(**kw)


def _embeddings(cfg, input_ids, token_type_ids, name="embeddings"):
    word = Embedding(cfg.vocab_size, cfg.hidden_size,
                     init.GenTruncatedNormal(0.0, 0.02), name + ".word")
    pos_table = init.truncated_normal(
        (cfg.max_position_embeddings, cfg.hidden_size), 0.0, 0.02,
        name=name + ".position")
    ttype = Embedding(cfg.type_vocab_size, cfg.hidden_size,
                      init.GenTruncatedNormal(0.0, 0.02), name + ".token_type")
    positions = Variable(
        name + ".pos_ids",
        value=np.arange(cfg.seq_len, dtype=np.float32), trainable=False)
    e = word(input_ids) + ops.embedding_lookup_op(pos_table, positions) \
        + ttype(token_type_ids)
    e = ops.array_reshape_op(
        e, output_shape=(cfg.batch_size * cfg.seq_len, cfg.hidden_size))
    e = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, name + ".ln")(e)
    return ops.dropout_op(e, 1.0 - cfg.hidden_dropout_prob)


def _encoder_layer(cfg, x, name, mask=None):
    # attention_probs_dropout_prob applies to the attention OUTPUT
    # (layers/attention.py)
    mha = MultiHeadAttention(cfg.hidden_size, cfg.num_attention_heads,
                             dropout=cfg.attention_probs_dropout_prob,
                             name=name + ".attn")
    attn = mha(x, cfg.batch_size, cfg.seq_len, mask=mask)
    x = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                  name + ".ln1")(x + attn)
    h = Linear(cfg.hidden_size, cfg.intermediate_size, activation="gelu",
               initializer=init.GenTruncatedNormal(0.0, 0.02),
               name=name + ".ffn1")(x)
    h = Linear(cfg.intermediate_size, cfg.hidden_size,
               initializer=init.GenTruncatedNormal(0.0, 0.02),
               name=name + ".ffn2")(h)
    h = ops.dropout_op(h, 1.0 - cfg.hidden_dropout_prob)
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                     name + ".ln2")(x + h)


def bert_model(cfg, input_ids, token_type_ids, attention_mask=None,
               name="bert"):
    """The sequence output node, (batch*seq, hidden).

    ``attention_mask``: an optional (batch, seq) node of 1/0 key-validity
    flags, reshaped once to the (B, 1, 1, S) key-padding form that
    ``sdpa_masked_op`` routes to the flash kernels' key-mask path."""
    x = _embeddings(cfg, input_ids, token_type_ids, name + ".embeddings")
    mask = None
    if attention_mask is not None:
        mask = ops.array_reshape_op(
            attention_mask, output_shape=(cfg.batch_size, 1, 1, cfg.seq_len))
    for i in range(cfg.num_hidden_layers):
        x = _encoder_layer(cfg, x, f"{name}.layer{i}", mask=mask)
    return x


def bert_pretrain_graph(cfg, name="bert", use_mask=True, use_nsp=False):
    """The MLM pretraining graph.  Returns (placeholders dict, loss node,
    logits node).

    ``masked_lm_labels``: (batch, seq) int32 with -1 at unmasked
    positions.  ``use_mask=True`` adds an ``attention_mask`` (batch, seq)
    int32 feed, so padded pretraining attends only to real tokens.
    ``use_nsp=True`` adds next-sentence prediction: a pooler over [CLS],
    a 2-way head, a ``next_sentence_label`` (batch,) feed, and
    loss = mlm_mean + nsp_mean."""
    shape = (cfg.batch_size, cfg.seq_len)
    input_ids = placeholder_op("input_ids", shape=shape, dtype=np.int32)
    token_type_ids = placeholder_op("token_type_ids", shape=shape,
                                    dtype=np.int32)
    labels = placeholder_op("masked_lm_labels", shape=shape, dtype=np.int32)
    attention_mask = placeholder_op("attention_mask", shape=shape,
                                    dtype=np.int32) if use_mask else None

    seq = bert_model(cfg, input_ids, token_type_ids,
                     attention_mask=attention_mask, name=name)
    h = Linear(cfg.hidden_size, cfg.hidden_size, activation="gelu",
               initializer=init.GenTruncatedNormal(0.0, 0.02),
               name=name + ".mlm_transform")(seq)
    h = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, name + ".mlm_ln")(h)
    logits = Linear(cfg.hidden_size, cfg.vocab_size,
                    initializer=init.GenTruncatedNormal(0.0, 0.02),
                    name=name + ".mlm_decoder")(h)
    loss = masked_lm_loss(logits, labels, cfg.batch_size * cfg.seq_len)
    feeds = {"input_ids": input_ids, "token_type_ids": token_type_ids,
             "masked_lm_labels": labels}
    if use_nsp:
        nsp_label = placeholder_op("next_sentence_label",
                                   shape=(cfg.batch_size,), dtype=np.int32)
        pooled = bert_pooler(cfg, seq, name + ".pooler")
        nsp_logits = Linear(cfg.hidden_size, 2,
                            initializer=init.GenTruncatedNormal(0.0, 0.02),
                            name=name + ".seq_relationship")(pooled)
        loss = loss + ops.reduce_mean_op(
            ops.softmaxcrossentropy_sparse_op(nsp_logits, nsp_label), [0])
        feeds["next_sentence_label"] = nsp_label
    if attention_mask is not None:
        feeds["attention_mask"] = attention_mask
    return feeds, loss, logits


def bert_pooler(cfg, seq, name="bert.pooler"):
    """HF-style pooler: dense + tanh over the [CLS] (first) token.
    ``seq``: (batch*seq_len, hidden) → (batch, hidden)."""
    x = ops.array_reshape_op(
        seq, output_shape=(cfg.batch_size, cfg.seq_len, cfg.hidden_size))
    cls = ops.slice_op(x, begin=(0, 0, 0),
                       size=(cfg.batch_size, 1, cfg.hidden_size))
    cls = ops.array_reshape_op(
        cls, output_shape=(cfg.batch_size, cfg.hidden_size))
    return Linear(cfg.hidden_size, cfg.hidden_size, activation="tanh",
                  initializer=init.GenTruncatedNormal(0.0, 0.02),
                  name=name + ".dense")(cls)


def synthetic_mlm_batch(cfg, seed=0, mask_frac=0.15, full_frac=0.35):
    """Deterministic synthetic MLM batch (a copy of the JAX package's).

    Returns (ids, token_type_ids, labels, attention_mask).  ``full_frac``
    of the batch is packed full-length, the rest uniform over
    [seq/4, seq]; positions past a row's length are PAD: id 0, label -1,
    attention_mask 0."""
    rng = np.random.RandomState(seed)
    b, s = cfg.batch_size, cfg.seq_len
    ids = rng.randint(0, cfg.vocab_size, (b, s))
    tt = np.zeros((b, s), np.int32)
    lengths = np.full((b,), s, np.int32)
    short = rng.rand(b) >= full_frac
    lengths[short] = rng.randint(max(1, s // 4), s + 1, short.sum())
    attn = (np.arange(s)[None, :] < lengths[:, None])
    ids[~attn] = 0
    labels = np.full((b, s), -1, np.int64)
    mask = (rng.rand(b, s) < mask_frac) & attn
    labels[mask] = ids[mask]
    return (ids.astype(np.int32), tt, labels.astype(np.int32),
            attn.astype(np.int32))
