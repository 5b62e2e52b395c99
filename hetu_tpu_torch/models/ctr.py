"""CTR models over the port's ops (twin of ``examples/ctr/models.py``):
Wide & Deep, DeepFM and DCN on Criteo-format data, 13 dense and 26
categorical fields, one shared embedding table addressed with per-field
offsets, binary cross-entropy loss.  The embedding lives in the graph (a
dense variable) or in a host store behind ``ps_embedding_lookup_op``,
directly or through a HET cache: the vectorized one (whose slab can live
on the card) or the native one (``CacheSparseTable``).
:func:`validate_cache_parity` trains Wide & Deep through the native cache
and the direct store on the same skewed data and reports both curves.
"""
import numpy as np

from .. import initializers as init
from ..graph.node import Variable
from ..ops import (array_reshape_op, binarycrossentropy_op, broadcastto_op,
                   concat_op, embedding_lookup_op, matmul_op, mul_op,
                   reduce_mean_op, reduce_sum_op, relu_op, sigmoid_op)
from ..ps import (CacheSparseTable, DistCacheTable, EmbeddingStore,
                  default_store)
from ..ps.ops import ps_embedding_lookup_op

NUM_DENSE = 13
NUM_SPARSE = 26


def _embed(ids_node, vocab, dim, mode, lr, name, batch_ids=None,
           slab_device=None, store=None, table_opt="sgd"):
    """Shared embedding.  Modes: ``dense`` (in-graph variable), ``ps``
    (the store, no cache), ``lru`` / ``lfu`` / ``lfuopt`` (the native HET
    cache, :class:`CacheSparseTable`, with its own table), ``vlru`` /
    ``vlfu`` (the vectorized HET cache, :class:`DistCacheTable`, host
    slab, over the store) and ``vlru_dev`` / ``vlfu_dev`` (the same cache
    with its slab on ``slab_device``, CUDA by default: hit rows gathered
    on the card, only miss rows cross from the host, grads summed on the
    card).  ``store``: where ``ps`` and the vectorized caches keep the
    table (a ``DistributedStore`` for the hybrid deployment); None is the
    default store for ``ps`` and a fresh ``EmbeddingStore`` for the
    caches, as in the JAX package.  ``table_opt``: the store's optimizer
    of the table's rows (``sgd``, as in the JAX package, ``adam``, ...)."""
    if mode == "dense":
        table = Variable(name, initializer=init.GenNormal(0.0, 0.01),
                         shape=(vocab, dim), trainable=True, is_embed=True)
        return embedding_lookup_op(table, ids_node)
    if mode == "ps":
        store = store if store is not None else default_store()
        t = store.init_table(vocab, dim, opt=table_opt, lr=lr, seed=0,
                             init_scale=0.01)
        return ps_embedding_lookup_op((store, t), ids_node, width=dim)
    if mode in ("vlru", "vlfu", "vlru_dev", "vlfu_dev"):
        store = store if store is not None else EmbeddingStore()
        t = store.init_table(vocab, dim, opt=table_opt, lr=lr, seed=0,
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
               embed_mode="dense", lr=0.01, slab_device=None, store=None,
               table_opt="sgd"):
    """Wide & Deep (reference models/wdl_criteo.py).  Returns
    ``(loss, prob)``.  ``slab_device``: where a ``*_dev`` cache keeps its
    slab (CUDA by default; pass the executor's device).  ``store`` and
    ``table_opt``: the PS table's store and optimizer (see ``_embed``)."""
    emb = _embed(sparse, vocab, dim, embed_mode, lr, "wdl_embed",
                 batch_ids=batch_size * NUM_SPARSE, slab_device=slab_device,
                 store=store, table_opt=table_opt)
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


def deepfm_criteo(dense, sparse, y_, batch_size, vocab=100000, dim=16,
                  embed_mode="dense", lr=0.01, slab_device=None):
    """DeepFM (reference models/deepfm_criteo.py): the FM second-order
    term 0.5 * ((sum v)^2 - sum v^2), a linear term and a deep MLP.
    Returns ``(loss, prob)``."""
    emb = _embed(sparse, vocab, dim, embed_mode, lr, "fm_embed",
                 batch_ids=batch_size * NUM_SPARSE,
                 slab_device=slab_device)                     # B, 26, D
    sum_vec = reduce_sum_op(emb, [1])                         # B, D
    sum_sq = mul_op(sum_vec, sum_vec)
    sq_sum = reduce_sum_op(mul_op(emb, emb), [1])
    fm2 = reduce_sum_op(sum_sq - sq_sum, [1], keepdims=True) * 0.5  # B, 1
    lin = _mlp(dense, [NUM_DENSE, 1], "fm_lin")
    flat = array_reshape_op(emb, (batch_size, NUM_SPARSE * dim))
    deep = _mlp(flat, [NUM_SPARSE * dim, 256, 256, 1], "fm_deep")
    prob = sigmoid_op(lin + fm2 + deep)
    loss = reduce_mean_op(binarycrossentropy_op(prob, y_), [0, 1])
    return loss, prob


def dcn_criteo(dense, sparse, y_, batch_size, vocab=100000, dim=16,
               embed_mode="dense", lr=0.01, n_cross=3, slab_device=None):
    """Deep & Cross (reference models/dcn_criteo.py): cross layers
    ``x_{l+1} = x0 * (x_l . w) + b + x_l`` beside a deep tower.  Returns
    ``(loss, prob)``."""
    emb = _embed(sparse, vocab, dim, embed_mode, lr, "dcn_embed",
                 batch_ids=batch_size * NUM_SPARSE, slab_device=slab_device)
    flat = array_reshape_op(emb, (batch_size, NUM_SPARSE * dim))
    x0 = concat_op(flat, dense, axis=1)
    width = NUM_SPARSE * dim + NUM_DENSE
    x = x0
    for i in range(n_cross):
        w = Variable(f"cross_w{i}", initializer=init.GenXavierNormal(),
                     shape=(width, 1))
        b = Variable(f"cross_b{i}", initializer=init.GenZeros(),
                     shape=(width,))
        xw = matmul_op(x, w)                                  # B, 1
        x = mul_op(x0, broadcastto_op(xw, x0)) + broadcastto_op(b, x) + x
    deep = _mlp(x0, [width, 256, 256], "dcn_deep")
    both = concat_op(x, deep, axis=1)
    prob = sigmoid_op(_mlp(both, [width + 256, 1], "dcn_out"))
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


def validate_cache_parity(steps=300, batch_size=512, vocab=100000, dim=16,
                          policy="lru", bound=10, lr=0.01, seed=0,
                          record_every=10, device=None):
    """Loss parity of Wide & Deep trained through the native HET cache
    (``CacheSparseTable``) and through the direct store, on the same
    skewed Criteo-format data from one table (BASELINE config 4;
    reference cache flags run_hetu.py:121-126), Adam on the dense
    weights.  ``device``: where the executors run (CUDA by default).
    Returns a JSON-ready dict: both loss curves (every ``record_every``
    steps), their divergence, both AUCs on a held-out batch, and the
    cache counters."""
    from ..graph.executor import Executor
    from ..graph.node import placeholder_op
    from ..metrics import auc as auc_of
    from ..optim import AdamOptimizer
    n_rows = steps * batch_size + batch_size
    dense_all, sparse_all, y_all = synthetic_criteo_skewed(
        n_rows, vocab=vocab, seed=seed)
    table0 = np.random.RandomState(seed).normal(
        0.0, 0.01, (vocab, dim)).astype(np.float32)

    def run(use_cache):
        store = EmbeddingStore()
        t = store.init_table(vocab, dim, opt="sgd", lr=lr, seed=seed,
                             init_scale=0.01)
        store.set_data(t, table0.copy())
        cs = None
        embed_src = (store, t)
        if use_cache:
            cs = CacheSparseTable(limit=max(vocab // 10, 256), length=vocab,
                                  width=dim, policy=policy, bound=bound,
                                  store=store, table=t)
            embed_src = cs
        dense = placeholder_op("dense")
        sparse = placeholder_op("sparse", dtype=np.int64)
        y_ = placeholder_op("y")
        emb = ps_embedding_lookup_op(embed_src, sparse, width=dim)
        loss, prob = _wdl_head(emb, dense, y_, batch_size, dim)
        ex = Executor({"train": [loss, AdamOptimizer(lr).minimize(loss)],
                       "eval": [prob]}, seed=seed, device=device)
        curve = []
        for i in range(steps):
            lo = batch_size * i
            out = ex.run("train", feed_dict={
                dense: dense_all[lo:lo + batch_size],
                sparse: sparse_all[lo:lo + batch_size],
                y_: y_all[lo:lo + batch_size]})
            if i % record_every == 0:
                curve.append(round(float(out[0].asnumpy()), 6))
        lo = batch_size * steps      # the held-out tail batch
        pv = ex.run("eval", feed_dict={
            dense: dense_all[lo:lo + batch_size],
            sparse: sparse_all[lo:lo + batch_size],
            y_: y_all[lo:lo + batch_size]},
            convert_to_numpy_ret_vals=True)[0]
        auc = float(auc_of(pv.ravel(), y_all[lo:lo + batch_size].ravel()))
        perf = cs.perf() if cs is not None else {}
        if cs is not None:
            cs.flush()
        ex.close()
        return curve, auc, perf

    curve_off, auc_off, _ = run(False)
    curve_on, auc_on, perf = run(True)
    diffs = [abs(a - b) for a, b in zip(curve_off, curve_on)]
    return {
        "config": {"steps": steps, "batch_size": batch_size, "vocab": vocab,
                   "dim": dim, "policy": policy, "bound": bound, "lr": lr,
                   "zipf_a": 1.1},
        "loss_curve_cache_off": curve_off,
        "loss_curve_cache_on": curve_on,
        "max_curve_divergence": round(max(diffs), 6),
        "final_divergence": round(diffs[-1], 6),
        "auc_cache_off": round(auc_off, 4),
        "auc_cache_on": round(auc_on, 4),
        "cache_perf": perf,
        # the READ hit rate: read hits over read lookups
        "cache_hit_rate": round(perf.get("hit_rate", 0.0), 4),
    }


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
