"""The port's HET embedding cache against the JAX package's, on the CPU.

* The plain versions of the two kernels (the slab row gather, the sorted
  segment-sum) against the Pallas kernels in interpret mode: the gather
  exactly; the segment-sum within rtol 2e-5 / atol 1e-6 (the Pallas
  kernel's one-hot matmul adds in another order) and exactly against the
  port's host ``_segment_sum`` (both add each key's occurrences in batch
  order).
* ``DistCacheTable(device=True)`` over a CPU slab replaying mixed traces
  against the JAX package's ``DistCacheTable(device=True)`` and its
  per-key oracle ``PerKeyCacheTable``: served values and the final store
  table within rtol 2e-5 / atol 1e-6 (float32 sums in another order);
  versions, counters and ``len`` exact.
* Scratch overflow, scratch exhausted, ``apply_update_summed`` against the
  host ``update``, the store's SGD against the JAX package's native store,
  and the options that are refused by name.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp                                    # noqa: E402

from hetu_tpu.ops.pallas import emb_cache as jemb          # noqa: E402
from hetu_tpu.ops.pallas import segment_sum as jseg        # noqa: E402
from hetu_tpu.ps import EmbeddingStore as JStore           # noqa: E402
from hetu_tpu.ps.dist_store import DistCacheTable as JCache  # noqa: E402
from hetu_tpu.ps.refcache import PerKeyCacheTable          # noqa: E402

import hetu_tpu_torch as tht                               # noqa: E402
from hetu_tpu_torch import metrics as tmetrics             # noqa: E402
from hetu_tpu_torch.ops.kernels import emb_cache as temb   # noqa: E402
from hetu_tpu_torch.ops.kernels import segment_sum as tseg  # noqa: E402
from hetu_tpu_torch.ps import EmbeddingStore as TStore     # noqa: E402
from hetu_tpu_torch.ps.dist_store import DistCacheTable as TCache  # noqa: E402
from hetu_tpu_torch.ps.dist_store import _segment_sum      # noqa: E402

RTOL, ATOL = 2e-5, 1e-6
STATS = ("lookups", "hits", "evictions", "pushes", "fetches", "updates")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize("rows,w,n", [(64, 8, 21), (40, 13, 17),
                                      (300, 128, 64), (9, 4, 0)])
def test_gather_plain_matches_pallas(rows, w, n):
    rng = np.random.RandomState(w)
    slab = rng.randn(rows, w).astype(np.float32)
    slots = rng.randint(0, rows, n).astype(np.int32)
    got = temb.gather_rows(_t(slab), _t(slots)).numpy()
    assert got.shape == (n, w)
    if n:
        want = np.asarray(jemb.gather_rows(jnp.asarray(slab),
                                           jnp.asarray(slots),
                                           interpret=True))
        np.testing.assert_array_equal(got, want)


def _zipf_ids(rng, n, vocab):
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    return rng.choice(vocab, n, p=p / p.sum()).astype(np.int64)


@pytest.mark.parametrize("n,w,kind", [(37, 8, "zipf"), (300, 16, "zipf"),
                                      (129, 13, "distinct"), (64, 4, "one")])
def test_scatter_add_plain_matches_pallas_and_host(n, w, kind):
    rng = np.random.RandomState(n)
    ids = {"zipf": _zipf_ids(rng, n, 50), "one": np.full(n, 7),
           "distinct": rng.permutation(1000)[:n]}[kind]
    uk, inv, cnt = np.unique(ids, return_inverse=True, return_counts=True)
    g = rng.randn(n, w).astype(np.float32)
    got = temb.scatter_add_grads(_t(g), _t(inv.astype(np.int32))).numpy()
    want = np.asarray(jemb.scatter_add_grads(jnp.asarray(g),
                                             jnp.asarray(inv),
                                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # exactly the host cache's segment sum; zero past the last segment
    np.testing.assert_array_equal(got[:uk.size], _segment_sum(g, inv, cnt))
    assert not got[uk.size:].any()


def test_sorted_segment_sum_and_dedup_match_pallas():
    rng = np.random.RandomState(3)
    seg = np.sort(rng.randint(0, 30, 200)).astype(np.int32)
    seg = np.unique(seg, return_inverse=True)[1].astype(np.int32)
    rows = rng.randn(200, 16).astype(np.float32)
    got = tseg.sorted_segment_sum(_t(rows), _t(seg), 210).numpy()
    want = np.asarray(jseg.sorted_segment_sum(
        jnp.asarray(rows), jnp.asarray(seg), 210, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ids = rng.randint(0, 40, 64).astype(np.int32)
    g = rng.randn(64, 8).astype(np.float32)
    tu, ts, tn = tseg.dedup_rows(_t(ids), _t(g))
    ju, js, jn = jseg.dedup_rows(jnp.asarray(ids), jnp.asarray(g),
                                 interpret=True)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)


def test_fill_rows_in_place_and_cpu_dispatch_counted():
    slab = torch.zeros(16, 4)
    rows = torch.arange(8, dtype=torch.float32).view(2, 4)
    out = temb.fill_rows(slab, rows, torch.tensor([3, 7], dtype=torch.int32))
    assert out.data_ptr() == slab.data_ptr()
    assert torch.equal(slab[3], rows[0]) and torch.equal(slab[7], rows[1])
    assert not slab[4].any()
    tmetrics.reset_emb_fallbacks()
    temb.emb_gather(slab, torch.tensor([3, 7]))
    temb.emb_scatter_add(rows, torch.tensor([0, 0]))
    assert tmetrics.emb_fallback_counts() == {
        "gather:backend:cpu": 1, "scatter_add:backend:cpu": 1}


# ------------------------------------------------------- cache vs JAX

def _trace(rng, n_ops, vocab, dim, batch):
    """The mixed lookup / update / flush trace of the JAX package's
    device-cache tests (tests/test_emb_device.py)."""
    ops = []
    for _ in range(n_ops):
        r = rng.rand()
        n = rng.randint(1, batch + 1)
        ids = rng.randint(0, vocab, n).astype(np.int64)
        if r < 0.45:
            ops.append(("lookup", ids))
        elif r < 0.92:
            ops.append(("update", ids,
                        rng.randn(n, dim).astype(np.float32)))
        else:
            ops.append(("flush",))
    return ops


def _replay(cache, ops):
    outs = []
    for op in ops:
        if op[0] == "lookup":
            outs.append(np.array(cache.lookup(op[1])))
        elif op[0] == "update":
            cache.update(op[1], op[2])
        else:
            cache.flush()
    cache.flush()
    return outs


def _stores(vocab, dim, n=1):
    """``n`` JAX-package stores and one port store holding one table."""
    table = np.random.RandomState(9).uniform(
        -0.1, 0.1, (vocab, dim)).astype(np.float32)
    out = []
    for cls in [JStore] * n + [TStore]:
        st = cls()
        t = st.init_table(vocab, dim, opt="sgd", lr=0.5, seed=3,
                          init_scale=0.1)
        st.set_data(t, table)
        out.append((st, t))
    return out


@pytest.mark.parametrize("policy,seed,vocab,limit,batch,n_ops,scratch", [
    ("lru", 1, 120, 16, 12, 35, 64),
    ("lfu", 1, 120, 16, 12, 35, 64),
    ("lru", 3, 60, 4, 24, 15, 64)])          # overflow served via scratch
def test_device_cache_matches_jax_and_oracle(policy, seed, vocab, limit,
                                             batch, n_ops, scratch):
    dim = 4
    ops = _trace(np.random.RandomState(seed), n_ops, vocab, dim, batch)
    (sj, tj), (sr, tr), (sp, tp) = _stores(vocab, dim, n=2)
    kw = dict(limit=limit, pull_bound=5, push_bound=3, policy=policy)
    jdev = JCache(sj, tj, device=True, device_scratch=scratch, **kw)
    ref = PerKeyCacheTable(sr, tr, **kw)
    tdev = TCache(sp, tp, device=True, device_scratch=scratch,
                  slab_device="cpu", **kw)
    out_t, out_j, out_r = _replay(tdev, ops), _replay(jdev, ops), \
        _replay(ref, ops)
    for i, (a, b, c) in enumerate(zip(out_t, out_j, out_r)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"lookup #{i}")
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL,
                                   err_msg=f"lookup #{i}")
    for st, t in ((sj, tj), (sr, tr)):
        np.testing.assert_allclose(sp.get_data(tp), st.get_data(t),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(sp.versions(tp, np.arange(vocab)),
                                      st.versions(t, np.arange(vocab)))
    for k in STATS:
        assert tdev.stats[k] == jdev.stats[k] == ref.stats[k], k
    assert len(tdev) == len(jdev) == len(ref)


def test_host_cache_matches_device_cache_bitwise():
    """Host and device modes of the port over the same trace: every
    served value, the store table and the counters equal bit for bit."""
    ops = _trace(np.random.RandomState(4), 30, 80, 4, 16)
    sa, ta = _stores(80, 4, n=0)[0]
    sb, tb = _stores(80, 4, n=0)[0]
    kw = dict(limit=12, pull_bound=5, push_bound=3)
    host = TCache(sa, ta, **kw)
    dev = TCache(sb, tb, device=True, device_scratch=64, slab_device="cpu",
                 **kw)
    for a, b in zip(_replay(host, ops), _replay(dev, ops)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa.get_data(ta), sb.get_data(tb))
    assert host.stats == dev.stats


def test_scratch_exhausted_raises_and_releases():
    st, t = _stores(64, 4, n=0)[0]
    dev = TCache(st, t, limit=2, device=True, device_scratch=2,
                 slab_device="cpu")
    with pytest.raises(RuntimeError, match="device_scratch"):
        dev.lookup(np.arange(16, dtype=np.int64))
    assert len(dev) == 0
    assert dev._lock.acquire(blocking=False)      # the failed plan let go
    dev._lock.release()
    dev2 = TCache(st, t, limit=2, device=True, device_scratch=32,
                  slab_device="cpu")
    assert dev2.lookup(np.arange(16, dtype=np.int64)).shape == (16, 4)
    assert dev2.lookup(np.zeros(0, np.int64)).shape == (0, 4)


def test_apply_update_summed_matches_host_update():
    ids = np.array([5, 7, 5, 9, 7, 5], np.int64)
    g = np.random.RandomState(5).randn(6, 4).astype(np.float32)
    sa, ta = _stores(32, 4, n=0)[0]
    sb, tb = _stores(32, 4, n=0)[0]
    host = TCache(sa, ta, limit=8, push_bound=100)
    dev = TCache(sb, tb, limit=8, push_bound=100, device=True,
                 slab_device="cpu")
    host.lookup(ids)
    dev.lookup(ids)
    host.update(ids, g)
    uk, inv, cnt = np.unique(ids, return_inverse=True, return_counts=True)
    dev.apply_update_summed(uk, _segment_sum(g, inv, cnt), cnt)
    np.testing.assert_array_equal(host._gcnt[host._find(uk)],
                                  dev._gcnt[dev._find(uk)])
    np.testing.assert_array_equal(host._grad[host._find(uk)],
                                  dev._grad[dev._find(uk)])
    assert host.stats["updates"] == dev.stats["updates"]


def test_store_sgd_matches_native_store():
    """The port's numpy table against the JAX package's store (its native
    C++ table where g++ built it) from one table: the same pushes with
    repeated keys give the same rows and versions."""
    (sj, tj), (sp, tp) = _stores(50, 6, n=1)
    rng = np.random.RandomState(6)
    for _ in range(5):
        keys = rng.randint(0, 50, 30).astype(np.int64)
        g = rng.randn(30, 6).astype(np.float32)
        sj.push(tj, keys, g)
        sp.push(tp, keys, g)
        np.testing.assert_allclose(sp.pull(tp, keys), sj.pull(tj, keys),
                                   rtol=RTOL, atol=ATOL)
    fused = sp.push_pull(tp, keys, g, keys[:4])
    np.testing.assert_allclose(fused, sj.push_pull(tj, keys, g, keys[:4]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(sp.versions(tp, np.arange(50)),
                                  sj.versions(tj, np.arange(50)))
    assert (sp.rows(tp), sp.width(tp)) == (50, 6)
    with pytest.raises(IndexError):
        sp.pull(tp, np.array([50]))


def test_refusals_by_name():
    st, t = _stores(16, 4, n=0)[0]
    for kw, name in ((dict(read_only=True), "read_only"),
                     (dict(refresh_every=3), "refresh_every"),
                     (dict(device=True, device_interpret=True),
                      "device_interpret")):
        with pytest.raises(NotImplementedError, match=name):
            TCache(st, t, slab_device="cpu", **kw)
    # what stays refused of the sharded store: replication and standby
    for kw, name in ((dict(replication=2), "replication=2"),
                     (dict(standby=True), "standby")):
        with pytest.raises(NotImplementedError, match=name):
            tht.ps.DistributedStore(0, 1, **kw)
        with pytest.raises(NotImplementedError, match=name):
            tht.ps.StoreServer(st, 1, 0, **kw)
    if not torch.cuda.is_available():
        # the slab goes to CUDA unless the CPU is asked for
        with pytest.raises(RuntimeError, match="CUDA"):
            TCache(st, t, device=True)
