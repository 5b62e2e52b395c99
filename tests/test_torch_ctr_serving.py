"""CTR serving in the port against the JAX package's, on the CPU at a tiny
size: the read-only ``DistCacheTable`` (the twins of the read-only cases
of ``tests/test_emb_cache.py``), PS embeddings served through
``InferenceExecutor`` and ``ServingRouter(refresh_every_batches=)`` (the
twins of ``tests/test_serving.py``'s PS cases), a replicated shard
primary killed mid-load, and the serving cells (``CellMap`` /
``CellHead``, the twins of ``tests/test_partition.py``'s cell tagging).

Each case runs once in each package on the same stores, ids and writes.
Served outputs agree within rtol 1e-5 (float32 products of the same
operands, summed by two libraries); cache rows, counters and refreshed
row counts exactly."""
import os
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu as jht                                   # noqa: E402
from hetu_tpu import metrics as jmetrics                 # noqa: E402
from hetu_tpu.ps import dist_store as jds                # noqa: E402
from hetu_tpu.serving import CellHead as JCellHead       # noqa: E402
from hetu_tpu.serving import CellMap as JCellMap         # noqa: E402
import hetu_tpu_torch as tht                             # noqa: E402
from hetu_tpu_torch import metrics as tmetrics           # noqa: E402
from hetu_tpu_torch.ps import dist_store as tds          # noqa: E402
from _torch_ps_harness import (free_ports as _free_ports,  # noqa: E402
                               run_both)

RTOL = 1e-5
JAX = SimpleNamespace(name="jax", ht=jht, ds=jds, metrics=jmetrics,
                      CellMap=JCellMap, CellHead=JCellHead, kw={})
PORT = SimpleNamespace(name="port", ht=tht, ds=tds, metrics=tmetrics,
                       CellMap=tht.CellMap, CellHead=tht.CellHead,
                       kw={"device": "cpu"})
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _reset():
    for p in PKGS:
        p.metrics.reset_serve_counts()
        p.metrics.reset_faults()
        p.metrics.reset_cache_counts()
    yield


def _mk_store(pkg, vocab, dim, opt="sgd", lr=0.5, seed=3):
    st = pkg.ht.EmbeddingStore()
    t = st.init_table(vocab, dim, opt=opt, lr=lr, seed=seed, init_scale=0.1)
    return st, t


def _iex(pkg, fetches, **kw):
    return pkg.ht.serving.InferenceExecutor(fetches, **kw, **pkg.kw)


def _both(scenario):
    """``scenario`` in both packages: float arrays within RTOL, every
    other value exactly."""
    return run_both(PKGS, scenario, faults=False, rtol=RTOL)


# -- the read-only cache ------------------------------------------------------

def test_readonly_lookup_parity_and_no_write_bookkeeping():
    """On one lookup trace the read-only cache serves the training
    cache's rows, with no dirty slab, no push and no pull_bound spent."""
    def scenario(pkg):
        rng = np.random.RandomState(0)
        st_a, ta = _mk_store(pkg, 64, 4)
        st_b, tb = _mk_store(pkg, 64, 4)
        train = pkg.ds.DistCacheTable(st_a, ta, limit=16, pull_bound=3,
                                      push_bound=2)
        ro = pkg.ds.DistCacheTable(st_b, tb, limit=16, pull_bound=3,
                                   push_bound=2, read_only=True)
        rows = []
        for _ in range(40):
            ids = rng.randint(0, 64, rng.randint(1, 12)).astype(np.int64)
            a, b = train.lookup(ids), ro.lookup(ids)
            assert np.array_equal(a, b)
            rows.append(b)
        assert not ro._gcnt.any() and not ro._grad.any()
        assert ro.stats["pushes"] == 0 and ro.stats["push_rpcs"] == 0
        hot = np.asarray([7], np.int64)
        f_train, f_ro = train.stats["fetches"], ro.stats["fetches"]
        for _ in range(10):
            train.lookup(hot)
            ro.lookup(hot)
        assert train.stats["fetches"] > f_train
        assert ro.stats["fetches"] - f_ro <= 1
        return {"rows": np.concatenate(rows), "stats": dict(ro.stats)}
    _both(scenario)


def test_readonly_rejects_update_and_keeps_evicting():
    def scenario(pkg):
        st, t = _mk_store(pkg, 32, 4)
        ro = pkg.ds.DistCacheTable(st, t, limit=8, pull_bound=100,
                                   push_bound=2, read_only=True)
        with pytest.raises(RuntimeError, match="read_only"):
            ro.update(np.asarray([1], np.int64), np.ones((1, 4), np.float32))
        for lo in range(0, 32, 4):
            ro.lookup(np.arange(lo, lo + 4, dtype=np.int64))
        assert ro.stats["evictions"] > 0 and len(ro) <= 8
        return {"stats": dict(ro.stats), "keys": np.sort(ro._slotkey)}
    _both(scenario)


def test_readonly_version_refresh_picks_up_writer():
    def scenario(pkg):
        st, t = _mk_store(pkg, 32, 4, lr=1.0)
        ro = pkg.ds.DistCacheTable(st, t, limit=16, pull_bound=2,
                                   push_bound=2, read_only=True)
        ids = np.arange(8, dtype=np.int64)
        before = ro.lookup(ids)
        st.push(t, np.asarray([2, 5], np.int64),
                np.ones((2, 4), np.float32), 1.0)
        assert np.array_equal(ro.lookup(ids), before)    # stale until
        assert np.array_equal(ro.lookup(ids), before)    # refreshed
        n = ro.refresh_stale()
        after = ro.lookup(ids)
        expect = before.copy()
        expect[[2, 5]] -= 1.0
        np.testing.assert_allclose(after, expect)
        return {"n": n, "again": ro.refresh_stale(), "after": after,
                "refresh_rows": pkg.metrics.cache_counts().get(
                    "emb_cache_refresh_rows", 0)}
    out = _both(scenario)
    assert out["n"] == 2 and out["again"] == 0


def test_readonly_refresh_every_autorefresh():
    def scenario(pkg):
        st, t = _mk_store(pkg, 16, 4, lr=1.0)
        ro = pkg.ds.DistCacheTable(st, t, limit=16, read_only=True,
                                   refresh_every=3)
        ids = np.arange(4, dtype=np.int64)
        before = ro.lookup(ids)
        st.push(t, np.asarray([1], np.int64), np.ones((1, 4), np.float32),
                1.0)
        ro.lookup(ids)
        out = ro.lookup(ids)       # the 3rd call trips the async sweep
        assert np.array_equal(out, before)
        assert ro.refresh_join(timeout=10)
        out = ro.lookup(ids)
        assert out[1][0] == before[1][0] - 1.0
        return {"out": out}
    _both(scenario)


def test_readonly_fill_reads_versions_before_rows():
    """A write landing between the miss path's versions and pull: the
    recorded version is the older, so the sweep re-pulls once, then
    settles."""
    def scenario(pkg):
        st, t = _mk_store(pkg, 16, 4, lr=1.0)

        class Racing:
            def __init__(self):
                self.armed = True

            def width(self, table):
                return st.width(table)

            def versions(self, table, keys):
                v = st.versions(table, keys)
                if self.armed:
                    self.armed = False
                    st.push(t, np.asarray([3], np.int64),
                            np.ones((1, 4), np.float32), 1.0)
                return v

            def pull(self, table, keys):
                return st.pull(table, keys)

        ro = pkg.ds.DistCacheTable(Racing(), t, limit=16, read_only=True)
        first = ro.lookup(np.asarray([3], np.int64))
        np.testing.assert_array_equal(first[0], st.pull(t, [3])[0])
        return {"first": first, "sweeps": [ro.refresh_stale(),
                                           ro.refresh_stale()]}
    assert _both(scenario)["sweeps"] == [1, 0]


def test_device_slab_with_read_only_stays_refused():
    st, t = _mk_store(PORT, 8, 4)
    with pytest.raises(NotImplementedError, match="device-resident serving"):
        tds.DistCacheTable(st, t, device=True, read_only=True,
                           slab_device="cpu")
    with pytest.raises(NotImplementedError, match="device_interpret"):
        tds.DistCacheTable(st, t, device=True, device_interpret=True,
                           slab_device="cpu")


# -- PS embeddings behind InferenceExecutor / ServingRouter -------------------

def _ps_graph(pkg, cache, dim, name="ids"):
    ids = pkg.ht.placeholder_op(name, dtype=np.int64)
    emb = pkg.ht.ps_embedding_lookup_op(cache, ids, width=dim)
    w = pkg.ht.Variable("w_ps", value=np.arange(
        dim * 2, dtype=np.float32).reshape(dim, 2))
    return ids, pkg.ht.matmul_op(pkg.ht.array_reshape_op(emb, (-1, dim)), w)


def test_ps_readonly_embedding_serving_end_to_end():
    vocab, dim = 40, 4

    def scenario(pkg):
        st = pkg.ht.EmbeddingStore()
        t = st.init_table(vocab, dim, opt="sgd", lr=0.1, seed=5,
                          init_scale=0.1)
        table = st.get_data(t)
        cache = pkg.ds.DistCacheTable(st, t, limit=16, read_only=True)
        ids, out = _ps_graph(pkg, cache, dim)
        iex = _iex(pkg, [out], buckets=(4, 8))
        with pkg.ht.serving.ServingRouter(iex, max_batch=8,
                                          max_wait_ms=20.0) as r:
            futs = [r.submit({ids: np.asarray([i % vocab], np.int64)})
                    for i in range(20)]
            res = np.stack([f.result(timeout=30)[0] for f in futs])
        wv = np.arange(dim * 2, dtype=np.float32).reshape(dim, 2)
        want = table[np.arange(20) % vocab] @ wv
        np.testing.assert_allclose(res, want, rtol=RTOL)
        assert cache.stats["pushes"] == 0 and not cache._gcnt.any()
        # infer() pulls the real ids only: two rows, padded to bucket 4
        one = iex.infer({ids: np.asarray([3, 9], np.int64)})[0]
        return {"res": res, "one": one,
                "lookups": cache.stats["lookups"]}
    _both(scenario)


def test_warm_does_not_touch_the_embedding_cache():
    def scenario(pkg):
        st = pkg.ht.EmbeddingStore()
        t = st.init_table(16, 4, opt="sgd", lr=0.1, seed=3, init_scale=0.1)
        ids = pkg.ht.placeholder_op("ids", dtype=np.int64, shape=(1,))
        cache = pkg.ds.DistCacheTable(st, t, limit=8, read_only=True,
                                      policy="lfu")
        emb = pkg.ht.ps_embedding_lookup_op(cache, ids, width=4)
        iex = _iex(pkg, [pkg.ht.array_reshape_op(emb, (-1, 4))],
                   buckets=(2, 4))
        n = iex.warm()
        assert cache.stats["lookups"] == cache.stats["fetches"] == 0
        assert not cache._freq.any()
        c = pkg.metrics.serve_counts()
        return {"n": n, "batches": c.get("serve_batches", 0),
                "rows": c.get("serve_batch_rows", 0)}
    assert _both(scenario) == {"n": 2, "batches": 0, "rows": 0}


def test_checkpoint_ps_tables_restore_by_node_name(tmp_path):
    vocab, dim = 12, 3

    def scenario(pkg):
        ht = pkg.ht
        st = ht.EmbeddingStore()
        t = st.init_table(vocab, dim, opt="sgd", lr=0.1, seed=2,
                          init_scale=0.1)
        ids = ht.placeholder_op("ids_ck", dtype=np.int64)
        y_ = ht.placeholder_op("y_ck")
        emb = ht.ps_embedding_lookup_op((st, t), ids, width=dim,
                                        name="user_emb")
        w = ht.Variable("w_ck", value=np.ones((dim, 2), np.float32))
        d = ht.matmul_op(ht.array_reshape_op(emb, (-1, dim)), w) - y_
        loss = ht.reduce_mean_op(ht.mul_op(d, d), [0, 1])
        ex = ht.Executor({"train": [loss, ht.optim.SGDOptimizer(0.1)
                                    .minimize(loss)]}, seed=0,
                         install_signal_handlers=False, **pkg.kw)
        ck = str(tmp_path / pkg.name / "ck")
        ex.save(ck)
        saved = st.get_data(t)
        st.push(t, np.arange(vocab), np.ones((vocab, dim), np.float32), 1.0)
        s_ids = ht.placeholder_op("s_ids_ck", dtype=np.int64)
        s_emb = ht.ps_embedding_lookup_op((st, t), s_ids, width=dim,
                                          name="user_emb")
        _iex(pkg, [s_emb + 0.0], weights=ck, buckets=(4,))
        np.testing.assert_array_equal(st.get_data(t), saved)
        st.push(t, np.arange(vocab), np.ones((vocab, dim), np.float32), 1.0)
        drifted = st.get_data(t)
        o_ids = ht.placeholder_op("o_ids_ck", dtype=np.int64)
        o_emb = ht.ps_embedding_lookup_op((st, t), o_ids, width=dim,
                                          name="other_emb")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            _iex(pkg, [o_emb + 0.0], weights=ck, buckets=(4,))
        assert any("no PS table for serving node 'other_emb'"
                   in str(w_.message) for w_ in rec)
        np.testing.assert_array_equal(st.get_data(t), drifted)
        return {"saved": saved, "drifted": drifted}
    _both(scenario)


def test_router_refresh_every_batches_picks_up_a_writer():
    """A writer pushes rows 1 and 6 after the first wave; the router's
    sweep after the second batch re-pulls exactly row 1 (row 6 was first
    pulled after the write), counted as serve_emb_refresh_rows, and the
    third wave carries the new row."""
    vocab, dim = 24, 4

    def scenario(pkg):
        st, t = _mk_store(pkg, vocab, dim, lr=1.0)
        cache = pkg.ds.DistCacheTable(st, t, limit=32, read_only=True)
        ids, out = _ps_graph(pkg, cache, dim)
        iex = _iex(pkg, [out], buckets=(4,))
        waves = []
        with pkg.ht.serving.ServingRouter(iex, max_batch=4, max_wait_ms=5.0,
                                          refresh_every_batches=2) as r:
            for wave in range(4):
                fd = {ids: np.arange(4 * (wave % 2), 4 * (wave % 2) + 4)}
                fut = r.submit(fd)
                waves.append(fut.result(timeout=30)[0])
                if wave == 0:
                    st.push(t, np.asarray([1, 6]),
                            np.ones((2, 4), np.float32), 1.0)
        c = pkg.metrics.serve_counts()
        return {"waves": np.stack(waves),
                "refreshed": c.get("serve_emb_refresh_rows", 0),
                "direct": iex.refresh_embeddings()}
    out = _both(scenario)
    assert out["refreshed"] == 1 and out["direct"] == 0
    assert not np.array_equal(out["waves"][2], out["waves"][0])
    assert np.array_equal(out["waves"][3], out["waves"][1])


def test_failover_mid_load_answers_every_request():
    """A replicated shard primary stopped mid-stream is absorbed inside a
    batch's pull: every request answered, the answers equal the
    unperturbed run's, the promotion counted as serve_failovers."""
    world, vocab, dim = 2, 48, 4
    rng = np.random.RandomState(3)
    stream = [rng.randint(0, vocab, 4).astype(np.int64) for _ in range(12)]
    table = np.random.RandomState(11).normal(
        0, 0.1, (vocab, dim)).astype(np.float32)

    def run(pkg, kill):
        ports = _free_ports(world)
        stores = [pkg.ds.DistributedStore(
            r, world, [("127.0.0.1", p) for p in ports], port=ports[r],
            rpc_timeout=3.0, rpc_retries=2, connect_timeout=2.0,
            replication=2) for r in range(world)]
        try:
            tid = None
            for s in stores:
                tid = s.init_table(vocab, dim, opt="sgd", lr=0.1,
                                   init_scale=0.0)
            stores[0].set_data(tid, table)
            cache = pkg.ds.DistCacheTable(stores[0], tid, limit=8,
                                          read_only=True)
            ids, out = _ps_graph(pkg, cache, dim)
            iex = _iex(pkg, [out], buckets=(4,))
            res = []
            with pkg.ht.serving.ServingRouter(iex, max_batch=1,
                                              max_wait_ms=1.0) as r:
                for i, s in enumerate(stream):
                    if kill and i == 6:
                        stores[1].server.stop()
                    res.append(r.submit({ids: s}).result(timeout=60)[0])
            return np.stack(res)
        finally:
            for s in stores:
                try:
                    s.close()
                except Exception:
                    pass

    def scenario(pkg):
        clean = run(pkg, False)
        pkg.metrics.reset_serve_counts()
        killed = run(pkg, True)
        assert np.array_equal(killed, clean)
        c = pkg.metrics.serve_counts()
        return {"killed": killed,
                "failovers": c.get("serve_failovers", 0),
                "responses": c.get("serve_responses", 0)}
    out = _both(scenario)
    assert out["failovers"] == 1 and out["responses"] == len(stream)


# -- serving cells ------------------------------------------------------------

def test_cellmap_tagging_and_partition_spec():
    for pkg in PKGS:
        cm = pkg.CellMap({"west": [0, 1], "east": {"ranks": [2, 3],
                                                   "replicas": 2}})
        assert cm.world == 4 and cm.cell_of(3) == "east"
        assert cm.ranks("east") == [2, 3] and cm.replicas("east") == 2
        assert cm.replicas("west") == 1
        assert cm.is_local("west", 0) and not cm.is_local("west", 2)
        assert cm.partition_spec("west", "east", 3, 7) \
            == "partition:rank0+rank1|rank2+rank3@step3:heal7"
        assert cm.partition_spec("west", "east", 3).endswith("@step3")
    # the port's string parses in the JAX package's chaos DSL
    from hetu_tpu import chaos
    _, faults = chaos.parse_spec("7:" + tht.CellMap(
        {"west": [0, 1], "east": [2, 3]}).partition_spec(
            "west", "east", 3, 7))
    assert faults[0]["a"] == frozenset({0, 1})
    assert faults[0]["b"] == frozenset({2, 3})


@pytest.mark.parametrize("cells,match", [
    ({"a": [0, 1], "b": [1, 2]}, "disjoint"),
    ({"a": [0], "b": [2]}, "exactly once"),
    ({"a": [], "b": [0]}, "tags no ranks"),
    ({"a": {"ranks": [0], "replicas": 0}}, "at least one"),
    ({"a": {"ranks": [0], "zone": 1}}, "unknown keys"),
])
def test_cellmap_validation_is_loud(cells, match):
    for pkg in PKGS:
        with pytest.raises(ValueError, match=match):
            pkg.CellMap(cells)


def test_cell_heads_serve_their_own_waves():
    """Two cells of one replicated store each warm their read-only cache
    and serve their own wave through their CellHead; a writer pushes,
    ``catch_up`` re-pulls exactly the written cached rows; the answers
    and every counter equal the JAX package's."""
    world, vocab, dim = 2, 32, 4

    def scenario(pkg):
        ports = _free_ports(world)
        stores = [pkg.ds.DistributedStore(
            r, world, [("127.0.0.1", p) for p in ports], port=ports[r],
            rpc_timeout=3.0, rpc_retries=2, connect_timeout=2.0,
            replication=2) for r in range(world)]
        heads = []
        try:
            tid = None
            for s in stores:
                tid = s.init_table(vocab, dim, opt="sgd", lr=1.0, seed=4,
                                   init_scale=0.1)
            cm = pkg.CellMap({"west": [0], "east": [1]})
            out = {}
            for cell in ("west", "east"):
                store = stores[cm.ranks(cell)[0]]
                cache = pkg.ds.DistCacheTable(store, tid, limit=16,
                                              read_only=True)
                ids, fetch = _ps_graph(pkg, cache, dim, name=f"ids_{cell}")
                router = pkg.ht.serving.ServingRouter(
                    _iex(pkg, [fetch], buckets=(2,)), max_batch=2,
                    max_wait_ms=5.0)
                head = pkg.CellHead(cell, store, router, cache)
                heads.append(head)
                lo = 0 if cell == "west" else 16
                head.warm(np.arange(lo, lo + 8))
                feeds = [{ids: np.asarray([lo + i, lo + i + 1])}
                         for i in range(0, 8, 2)]
                resp, wave = head.serve_wave(feeds)
                out[cell] = np.stack([r[0] for r in resp])
                out[cell + "_wave"] = wave
            stores[0].push(tid, np.asarray([1, 17]),
                           np.ones((2, dim), np.float32), 1.0)
            for head in heads:
                out[head.name + "_catch_up"] = head.catch_up()
                out[head.name + "_stats"] = dict(head.stats)
            return out
        finally:
            for h in heads:
                h.close()
            for s in stores:
                s.close()
    out = _both(scenario)
    for cell in ("west", "east"):
        assert out[cell + "_wave"] == {"admitted": 4, "answered": 4,
                                       "rejections": 0, "errors": 0}
        assert out[cell + "_catch_up"] == {"repaired": False,
                                           "refreshed_rows": 1}
