"""Wide & Deep CTR training through the HET embedding cache: the port
against the JAX package, on the CPU, at a tiny size (vocab 520, dim 4,
batch 8, 26 Zipf fields: the cache evicts from the second step on).

Both packages build ``wdl_criteo`` with the same embed mode; one table is
loaded into both stores (``set_data``) and one set of MLP weights into
both executors (``load_dict``).  Over 5 SGD steps the losses agree within
rtol 1e-5, the final store table within rtol 2e-5 / atol 1e-6 (float32
sums in another order), the versions and cache counters exactly, and the
eval subgraph's ``prob`` within rtol 1e-5 / atol 1e-6.  The port's device
cache (slab on the CPU, the kernels' plain versions) trains bit for bit as
its host cache does, as the JAX package's does (tests/test_emb_device.py).
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                     # noqa: E402
import hetu_tpu_torch as tht               # noqa: E402

VOCAB, DIM, BATCH = 520, 4, 8
STATS = ("lookups", "hits", "evictions", "pushes", "fetches", "updates")


def _jax_ctr():
    spec = importlib.util.spec_from_file_location(
        "jax_ctr_models", os.path.join(ROOT, "examples", "ctr", "models.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(ht, ctr, mode, **kw):
    dense = ht.placeholder_op("dense")
    sparse = ht.placeholder_op("sparse", dtype=np.int64)
    y_ = ht.placeholder_op("y")
    loss, prob = ctr.wdl_criteo(dense, sparse, y_, BATCH, vocab=VOCAB,
                                dim=DIM, embed_mode=mode, lr=0.01, **kw)
    train = ht.optim.SGDOptimizer(0.01).minimize(loss)
    return (dense, sparse, y_), {"train": [loss, train], "eval": [prob]}


def _cache(ex):
    return ex.subexecutors["train"].ps_nodes[0].cache


def _data(steps, seed=0):
    d, s, y = tht.synthetic_criteo_skewed((steps + 1) * BATCH, vocab=VOCAB,
                                          seed=seed)
    return [(d[i * BATCH:(i + 1) * BATCH], s[i * BATCH:(i + 1) * BATCH],
             y[i * BATCH:(i + 1) * BATCH]) for i in range(steps + 1)]


def _table():
    return np.random.RandomState(1).uniform(
        -0.01, 0.01, (VOCAB, DIM)).astype(np.float32)


def _train(ex, feeds, batches):
    losses = []
    for d, s, y in batches:
        out = ex.run("train", feed_dict=dict(zip(feeds, (d, s, y))))
        losses.append(float(out[0].asnumpy()))
    return losses


@pytest.mark.parametrize("mode", ["vlru_dev", "vlfu_dev", "vlru"])
def test_wdl_matches_jax(mode):
    steps = 5
    batches = _data(steps)
    jfeeds, jfetch = _build(jht, _jax_ctr(), mode)
    tfeeds, tfetch = _build(tht, tht.models.ctr, mode, slab_device="cpu")
    jex = jht.Executor(jfetch, seed=0)
    tex = tht.Executor(tfetch, seed=0, device="cpu")
    tex.load_dict(jex.return_tensor_values())
    jc, tc = _cache(jex), _cache(tex)
    for c in (jc, tc):
        c.store.set_data(c.table, _table())
    jl = _train(jex, jfeeds, batches[:steps])
    tl = _train(tex, tfeeds, batches[:steps])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    d, s, y = batches[steps]
    jp = jex.run("eval", feed_dict=dict(zip(jfeeds, (d, s, y))),
                 convert_to_numpy_ret_vals=True)[0]
    tp = tex.run("eval", feed_dict=dict(zip(tfeeds, (d, s, y))),
                 convert_to_numpy_ret_vals=True)[0]
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)
    for c in (jc, tc):
        c.flush()
    np.testing.assert_allclose(tc.store.get_data(tc.table),
                               jc.store.get_data(jc.table),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tc.store.versions(tc.table, np.arange(VOCAB)),
        jc.store.versions(jc.table, np.arange(VOCAB)))
    for k in STATS:
        assert tc.stats[k] == jc.stats[k], (k, tc.stats, jc.stats)
    assert tc.stats["evictions"] > 0
    tex.close()


def test_device_cache_trains_bitwise_as_host_cache():
    batches = _data(8, seed=2)

    def run(mode):
        feeds, fetch = _build(tht, tht.models.ctr, mode, slab_device="cpu")
        ex = tht.Executor(fetch, seed=0, device="cpu")
        c = _cache(ex)
        c.store.set_data(c.table, _table())
        losses = _train(ex, feeds, batches)
        c.flush()
        ex.close()
        return (losses, c.store.get_data(c.table),
                c.store.versions(c.table, np.arange(VOCAB)), c.stats)

    lh, th, vh, sh = run("vlru")
    ld, td, vd, sd = run("vlru_dev")
    assert lh == ld
    np.testing.assert_array_equal(th, td)
    np.testing.assert_array_equal(vh, vd)
    assert sh == sd


def test_ps_executor_contract():
    """Counters, the empty batch, ``auc``, and the refusals by name."""
    tmetrics = tht.metrics
    feeds, fetch = _build(tht, tht.models.ctr, "vlru_dev", slab_device="cpu")
    ex = tht.Executor(fetch, seed=0, device="cpu")
    tmetrics.reset_cache_counts()
    tmetrics.reset_emb_fallbacks()
    d, s, y = _data(1)[0]
    ex.run("train", feed_dict=dict(zip(feeds, (d, s, y))))
    counts = tmetrics.cache_counts()
    assert counts.get("emb_cache_hit_rows", 0) \
        + counts["emb_cache_miss_rows"] == s.size
    assert tmetrics.emb_fallback_counts() == {"gather:backend:cpu": 1,
                                              "scatter_add:backend:cpu": 1}
    ex.ps_flush()
    with pytest.raises(ValueError, match="missing ids feed"):
        ex.run("eval", feed_dict={feeds[0]: d})
    # the cache released its lock after the failed run
    assert _cache(ex)._lock.acquire(blocking=False)
    _cache(ex)._lock.release()
    ex.close()
    # an empty lookup through the executor's device path
    ids = tht.placeholder_op("ids", dtype=np.int64)
    st = tht.EmbeddingStore()
    t = st.init_table(10, 3)
    cache = tht.DistCacheTable(st, t, limit=4, device=True,
                               slab_device="cpu")
    e = tht.ps_embedding_lookup_op(cache, ids)
    ex2 = tht.Executor([tht.reduce_sum_op(e)], device="cpu")
    assert float(ex2.run(feed_dict={ids: np.zeros((0, 2), np.int64)})[0]
                 .asnumpy()) == 0.0
    assert tmetrics.auc([0.1, 0.4, 0.35, 0.8], [0, 0, 1, 1]) == 0.75
    rng = np.random.RandomState(0)
    p, lab = rng.rand(50).round(1), rng.rand(50) > 0.5
    assert tmetrics.auc(p, lab) == jht.metrics.auc(p, lab)
    # a device cache trains BSP only: ASP / SSP refused at the first run
    for bsp in (1, -1):
        exb = tht.Executor(fetch, device="cpu", bsp=bsp)
        with pytest.raises(NotImplementedError, match="bsp=0"):
            exb.run("train", feed_dict=dict(zip(feeds, (d, s, y))))
        exb.close()
    with pytest.raises(NotImplementedError, match="computed node"):
        tht.Executor([tht.ps_embedding_lookup_op(cache, ids + 1)],
                     device="cpu")
    # the native cache modes build over CacheSparseTable
    for mode in ("lru", "lfu", "lfuopt"):
        _, fl = _build(tht, tht.models.ctr, mode)
        exm = tht.Executor(fl, device="cpu")
        assert isinstance(_cache(exm), tht.CacheSparseTable)
        assert _cache(exm).policy == mode.upper()
        exm.close()
