"""CTR models over the port's ops (twin of ``examples/ctr/models.py``):
Wide & Deep on Criteo-format data, 13 dense and 26 categorical fields, one
shared embedding table addressed with per-field offsets, binary
cross-entropy loss.  The embedding lives in the graph (a dense variable)
or in a host store behind ``ps_embedding_lookup_op``, directly or through
a HET cache: the vectorized one (whose slab can live on the card) or the
native one (``CacheSparseTable``).

Not ported: DeepFM, DCN and the cache-parity validation.
"""
import numpy as np

from .. import initializers as init
from ..graph.node import Variable
from ..ops import (array_reshape_op, binarycrossentropy_op, broadcastto_op,
                   concat_op, embedding_lookup_op, matmul_op, reduce_mean_op,
                   relu_op, sigmoid_op)
from ..ps import (CacheSparseTable, DistCacheTable, EmbeddingStore,
                  default_store)
from ..ps.ops import ps_embedding_lookup_op

NUM_DENSE = 13
NUM_SPARSE = 26


def _embed(ids_node, vocab, dim, mode, lr, name, batch_ids=None,
           slab_device=None):
    """Shared embedding.  Modes: ``dense`` (in-graph variable), ``ps``
    (the default store, no cache), ``lru`` / ``lfu`` / ``lfuopt`` (the
    native HET cache, :class:`CacheSparseTable`, over the default store),
    ``vlru`` / ``vlfu`` (the vectorized HET cache, :class:`DistCacheTable`,
    host slab) and ``vlru_dev`` / ``vlfu_dev`` (the same cache with its
    slab on ``slab_device``, CUDA by default: hit rows gathered on the
    card, only miss rows cross from the host, grads summed on the
    card)."""
    if mode == "dense":
        table = Variable(name, initializer=init.GenNormal(0.0, 0.01),
                         shape=(vocab, dim), trainable=True, is_embed=True)
        return embedding_lookup_op(table, ids_node)
    if mode == "ps":
        store = default_store()
        t = store.init_table(vocab, dim, opt="sgd", lr=lr, seed=0,
                             init_scale=0.01)
        return ps_embedding_lookup_op((store, t), ids_node, width=dim)
    if mode in ("vlru", "vlfu", "vlru_dev", "vlfu_dev"):
        store = EmbeddingStore()
        t = store.init_table(vocab, dim, opt="sgd", lr=lr, seed=0,
                             init_scale=0.01)
        device = mode.endswith("_dev")
        # a batch never holds more uncacheable unique keys than ids, so
        # batch_ids scratch rows make overflow impossible
        scratch = min(vocab, batch_ids) if device and batch_ids \
            else (vocab if device else None)
        cache = DistCacheTable(store, t, limit=max(vocab // 10, 256),
                               pull_bound=10, push_bound=10,
                               policy=mode[1:4], device=device,
                               device_scratch=scratch,
                               slab_device=slab_device)
        return ps_embedding_lookup_op(cache, ids_node, width=dim)
    # the native cache policies; an unknown mode is refused by name there
    cs = CacheSparseTable(limit=max(vocab // 10, 256), length=vocab,
                          width=dim, policy=mode, bound=10, opt="sgd", lr=lr,
                          seed=0)
    return ps_embedding_lookup_op(cs, ids_node)


def _mlp(x, dims, name):
    h = x
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = Variable(f"{name}_w{i}", initializer=init.GenXavierNormal(),
                     shape=(din, dout))
        b = Variable(f"{name}_b{i}", initializer=init.GenZeros(),
                     shape=(dout,))
        hm = matmul_op(h, w)
        h = hm + broadcastto_op(b, hm)
        if i < len(dims) - 2:
            h = relu_op(h)
    return h


def wdl_criteo(dense, sparse, y_, batch_size, vocab=100000, dim=16,
               embed_mode="dense", lr=0.01, slab_device=None):
    """Wide & Deep (reference models/wdl_criteo.py).  Returns
    ``(loss, prob)``.  ``slab_device``: where a ``*_dev`` cache keeps its
    slab (CUDA by default; pass the executor's device)."""
    emb = _embed(sparse, vocab, dim, embed_mode, lr, "wdl_embed",
                 batch_ids=batch_size * NUM_SPARSE, slab_device=slab_device)
    return _wdl_head(emb, dense, y_, batch_size, dim)


def _wdl_head(emb, dense, y_, batch_size, dim):
    """Wide & Deep above its embedding node ``emb`` (batch, 26, dim):
    ``(loss, prob)``."""
    flat = array_reshape_op(emb, (batch_size, NUM_SPARSE * dim))
    deep_in = concat_op(flat, dense, axis=1)
    deep = _mlp(deep_in, [NUM_SPARSE * dim + NUM_DENSE, 256, 256, 1], "deep")
    wide = _mlp(dense, [NUM_DENSE, 1], "wide")
    logit = wide + deep
    prob = sigmoid_op(logit)
    loss = reduce_mean_op(binarycrossentropy_op(prob, y_), [0, 1])
    return loss, prob


def synthetic_criteo_skewed(n_rows, vocab=100000, seed=0, zipf_a=1.1):
    """Criteo-format data with Zipf-skewed id frequencies (what makes the
    HET cache effective) and a click signal carried partly by the
    categorical fields.  Returns (dense, sparse, y) for all rows."""
    rng = np.random.RandomState(seed)
    dense = rng.rand(n_rows, NUM_DENSE).astype(np.float32)
    per_field = vocab // NUM_SPARSE
    ranks = np.arange(per_field, dtype=np.float64)
    p = 1.0 / (ranks + 1.0) ** zipf_a
    p /= p.sum()
    field = np.stack([rng.choice(per_field, n_rows, p=p)
                      for _ in range(NUM_SPARSE)], axis=1)
    offsets = np.arange(NUM_SPARSE) * per_field
    sparse = (field + offsets).astype(np.int64)
    # planted signal: a dense linear part plus per-id effects on 6 fields
    cat_effect = np.cos(field[:, :6] * 2.399963).sum(axis=1)
    signal = dense @ rng.randn(NUM_DENSE) * 0.5 + 0.8 * cat_effect
    y = signal + 0.5 * rng.randn(n_rows) > np.median(signal)
    return dense, sparse, y.astype(np.float32).reshape(-1, 1)


def synthetic_criteo(batch_size, vocab=100000, seed=0):
    """One Criteo-shaped batch with uniform ids and a planted linear click
    signal."""
    rng = np.random.RandomState(seed)
    dense = rng.rand(batch_size, NUM_DENSE).astype(np.float32)
    per_field = vocab // NUM_SPARSE
    field = rng.randint(0, per_field, (batch_size, NUM_SPARSE))
    offsets = np.arange(NUM_SPARSE) * per_field
    sparse = (field + offsets).astype(np.int64)
    signal = dense @ rng.randn(NUM_DENSE) + 0.003 * (field[:, 0] % 37 - 18)
    y = signal + 0.3 * rng.randn(batch_size) > np.median(signal)
    return dense, sparse, y.astype(np.float32).reshape(-1, 1)
