"""The port's native parameter-server core against the JAX package's, on the
CPU: the store (``ps/store.py`` over ``csrc/ps_store.cc``), its numpy twin,
SSP clocks, load recording, the native HET cache (``CacheSparseTable``) and
the per-key cache oracle (``PerKeyCacheTable``).

Both packages build the same C++ source with g++, so a table made from one
seed, and every push, is the same bit for bit; the port's native table
against its own ``_NumpyTable`` is held at
``tests/test_ps.py::test_server_optimizers_match_numpy``'s rtol 2e-5 /
atol 1e-6.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu.ps import store as jstore                  # noqa: E402
from hetu_tpu.ps.cstable import CacheSparseTable as JCST  # noqa: E402
from hetu_tpu.ps.refcache import PerKeyCacheTable as JRef  # noqa: E402
from hetu_tpu_torch.ops.kernels import _build             # noqa: E402
from hetu_tpu_torch.ps import build as tbuild             # noqa: E402
from hetu_tpu_torch.ps import store as tstore             # noqa: E402
from hetu_tpu_torch.ps.cstable import CacheSparseTable as TCST  # noqa: E402
from hetu_tpu_torch.ps.dist_store import DistCacheTable   # noqa: E402
from hetu_tpu_torch.ps.refcache import PerKeyCacheTable as TRef  # noqa: E402

OPTS = ["sgd", "momentum", "nesterov", "adagrad", "adam"]


def _pair(rows, width, **kw):
    js, ts = jstore.EmbeddingStore(), tstore.EmbeddingStore()
    return (js, js.init_table(rows, width, **kw)), \
        (ts, ts.init_table(rows, width, **kw))


def test_library_builds_from_the_source_into_build():
    lib = tbuild.get_lib()
    assert lib is not None
    path = tbuild.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libhetu_ps-")
    assert os.path.exists(path)
    assert tbuild.SOURCE == os.path.join(ROOT, "hetu_tpu_torch", "csrc",
                                         "ps_store.cc")
    # nvcc takes the .cu sources only
    assert "ps_store" not in _build.sources()
    assert tstore.EmbeddingStore().native


@pytest.mark.parametrize("rows, width, seed, scale", [
    (50, 8, 0, None), (1000, 16, 7, 0.01), (33, 3, 2 ** 33 + 5, 0.5),
    (20, 4, 3, 0.0)])
def test_tables_from_one_seed_are_bit_equal(rows, width, seed, scale):
    (js, jt), (ts, tt) = _pair(rows, width, seed=seed, init_scale=scale)
    assert np.array_equal(ts.get_data(tt), js.get_data(jt))
    assert (ts.rows(tt), ts.width(tt)) == (rows, width)


@pytest.mark.parametrize("opt", OPTS)
def test_sparse_ops_are_bit_equal(opt):
    (js, jt), (ts, tt) = _pair(40, 6, opt=opt, lr=0.05, seed=4)
    rng = np.random.RandomState(11)
    for step in range(6):
        keys = rng.randint(0, 40, 17)
        grads = rng.randn(17, 6).astype(np.float32)
        lr = -1.0 if step % 2 else 0.2
        if step % 3 == 0:
            pk = rng.randint(0, 40, 9)
            a = js.push_pull(jt, keys, grads, pk, lr)
            b = ts.push_pull(tt, keys, grads, pk, lr)
        else:
            js.push(jt, keys, grads, lr)
            ts.push(tt, keys, grads, lr)
            a, b = js.pull(jt, keys.reshape(1, -1)), \
                ts.pull(tt, keys.reshape(1, -1))
        assert a.shape == b.shape and np.array_equal(a, b), step
    dense = rng.randn(40, 6).astype(np.float32)
    js.dense_push(jt, dense, 0.1)
    ts.dense_push(tt, dense, 0.1)
    assert np.array_equal(ts.get_data(tt), js.get_data(jt))
    keys = np.arange(40)
    np.testing.assert_array_equal(ts.versions(tt, keys), js.versions(jt, keys))
    with pytest.raises(IndexError, match="out of range"):
        ts.pull(tt, [40])
    with pytest.raises(ValueError, match="set_data shape"):
        ts.set_data(tt, np.zeros((39, 6), np.float32))


@pytest.mark.parametrize("opt", OPTS)
def test_native_table_matches_its_numpy_twin(opt):
    st = tstore.EmbeddingStore()
    t = st.init_table(20, 4, opt=opt, lr=0.1, seed=3)
    ref = tstore._NumpyTable(20, 4, tstore._OPT_IDS[opt], 0.1, 0.9, 0.999,
                             1e-7, 3, 0.0)
    ref.data[:] = st.get_data(t)
    rng = np.random.RandomState(0)
    for _ in range(5):
        keys = rng.randint(0, 20, 6)
        grads = rng.randn(6, 4).astype(np.float32)
        st.push(t, keys, grads)
        ref.push(keys, grads)
    np.testing.assert_allclose(st.get_data(t), ref.data, rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(st.versions(t, np.arange(20)), ref.version)


@pytest.mark.parametrize("opt", OPTS)
def test_native_save_file_is_the_jax_packages(tmp_path, opt):
    (js, jt), (ts, tt) = _pair(30, 5, opt=opt, lr=0.05, seed=1)
    rng = np.random.RandomState(2)
    for _ in range(3):
        k = rng.randint(0, 30, 12)
        g = rng.randn(12, 5).astype(np.float32)
        js.push(jt, k, g)
        ts.push(tt, k, g)
    js.save(jt, str(tmp_path / "j"))
    ts.save(tt, str(tmp_path / "t"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    ts2 = tstore.EmbeddingStore()
    t2 = ts2.init_table(30, 5, opt=opt, lr=0.05, seed=9)
    ts2.load(t2, str(tmp_path / "j"))
    k = rng.randint(0, 30, 12)
    g = rng.randn(12, 5).astype(np.float32)
    ts.push(tt, k, g)
    ts2.push(t2, k, g)     # the optimizer slots came back too
    assert np.array_equal(ts2.get_data(t2), ts.get_data(tt))
    js.push(jt, k, g)
    # the state digest (slab, slots, versions) is the JAX package's
    assert ts.state_digest(tt) == js.state_digest(jt) == ts2.state_digest(t2)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_state_digest_is_the_jax_packages(monkeypatch, native, opt):
    """``state_digest`` of a native table hashes its save file, of a
    numpy table its arrays: either flavour's digest equals the JAX
    package's table of the same flavour after the same pushes, and moves
    with every push (the optimizer slots included)."""
    if not native:
        monkeypatch.setattr(tstore, "get_lib", lambda: None)
        monkeypatch.setattr(jstore, "get_lib", lambda: None)
    (js, jt), (ts, tt) = _pair(24, 3, opt=opt, lr=0.05, seed=4)
    assert ts.native == (js._lib is not None) == native
    rng = np.random.RandomState(5)
    seen = {ts.state_digest(tt)}
    for _ in range(3):
        k = rng.randint(0, 24, 8)
        g = rng.randn(8, 3).astype(np.float32)
        js.push(jt, k, g)
        ts.push(tt, k, g)
        d = ts.state_digest(tt)
        assert d == js.state_digest(jt) and d not in seen
        seen.add(d)


@pytest.mark.parametrize("native", [True, False])
def test_ssp_blocks_and_is_released_by_a_tick(monkeypatch, native):
    if not native:
        monkeypatch.setattr(tstore, "get_lib", lambda: None)
    st = tstore.EmbeddingStore()
    assert st.native == native and not st.ssp_ready
    st.ssp_init(2)
    assert st.ssp_ready and st.ssp_blocking
    st.clock(0)
    st.clock(0)
    assert [st.clock_value(0), st.clock_value(1)] == [2, 0]
    assert st.ssp_sync(0, 1, timeout_ms=30) is False    # 2 ahead, bound 1
    got = []
    waiter = threading.Thread(
        target=lambda: got.append(st.ssp_sync(0, 1, timeout_ms=20000)))
    t0 = time.monotonic()
    waiter.start()
    time.sleep(0.2)
    assert waiter.is_alive()        # blocked, not polling to False
    st.clock(1)                     # the slow worker ticks: released
    waiter.join(10)
    assert got == [True] and time.monotonic() - t0 < 10
    assert st.ssp_sync(1, 0, timeout_ms=10) is True


def test_load_recording_matches_the_jax_package():
    (js, jt), (ts, tt) = _pair(16, 2, seed=0)
    for s, t in ((js, jt), (ts, tt)):
        assert s.get_loads() == {}
        s.start_record()
        s.pull(t, [[1, 2, 2], [5, 1, 1]])
        s.push(t, [3, 3, 1], np.ones((3, 2), np.float32))
    assert ts.get_loads() == js.get_loads()
    assert ts.get_loads()[(tt, "pull")] == {1: 3, 2: 2, 5: 1}


def _zipf_trace(n, steps, batch, seed):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    p /= p.sum()
    return [(rng.choice(n, batch, p=p),
             rng.randn(batch, 4).astype(np.float32)) for _ in range(steps)]


@pytest.mark.parametrize("policy", ["LRU", "LFU", "LFUOPT"])
def test_cache_sparse_table_matches_the_jax_package(policy):
    """The native HET cache on a Zipf trace with evictions: every lookup,
    the table after ``flush``, the versions and ``perf()``, equal."""
    js, ts = jstore.EmbeddingStore(), tstore.EmbeddingStore()
    kw = dict(limit=12, length=80, width=4, policy=policy, bound=3,
              opt="sgd", lr=0.1, seed=5)
    jc, tc = JCST(store=js, **kw), TCST(store=ts, **kw)
    for keys, grads in _zipf_trace(80, 12, 16, seed=3):
        a = jc.embedding_lookup(keys).result()
        b = tc.embedding_lookup(keys).result()
        assert np.array_equal(a, b)
        jc.embedding_update(keys, grads).result()
        tc.embedding_update(keys, grads).result()
    pk = np.arange(0, 80, 7)
    a = jc.embedding_push_pull(pk, np.ones((pk.size, 4), np.float32),
                               pk).result()
    b = tc.embedding_push_pull(pk, np.ones((pk.size, 4), np.float32),
                               pk).result()
    assert np.array_equal(a, b)
    jc.flush()
    tc.flush()
    assert np.array_equal(ts.get_data(tc.table), js.get_data(jc.table))
    np.testing.assert_array_equal(ts.versions(tc.table, np.arange(80)),
                                  js.versions(jc.table, np.arange(80)))
    perf = tc.perf()
    assert perf == jc.perf()
    assert perf["evictions"] > 0 and 0 < perf["hit_rate"] < 1
    assert len(tc) == len(jc) <= 12
    tc.close()
    tc.close()                              # idempotent
    tc.embedding_lookup([1]).result()       # the pool revives
    jc.close()
    with pytest.raises(ValueError, match="policy"):
        TCST(store=ts, **dict(kw, policy="MRU"))


def test_cache_sparse_table_passes_through_without_a_handle(monkeypatch):
    """Over a store with no native handle (the numpy table here; a
    DistributedStore likewise) lookups and updates are the store's pull
    and push."""
    monkeypatch.setattr(tstore, "get_lib", lambda: None)
    st = tstore.EmbeddingStore()
    c = TCST(limit=4, length=10, width=3, store=st, seed=1)
    assert c._h is None and c.perf() == {} and len(c) == 0
    before = st.get_data(c.table)
    np.testing.assert_array_equal(c.embedding_lookup([[1, 2]]).result(),
                                  before[[[1, 2]]])
    c.embedding_update([1], np.ones((1, 3), np.float32)).result()
    np.testing.assert_allclose(st.get_data(c.table)[1], before[1] - 0.01,
                               rtol=1e-6)
    c.close()


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_per_key_oracle_matches_the_jax_oracle_and_the_cache(policy):
    """``PerKeyCacheTable`` replays the JAX package's oracle bit for bit,
    and the vectorized ``DistCacheTable`` replays it."""
    runs = []
    for store_cls, cache_cls in ((jstore.EmbeddingStore, JRef),
                                 (tstore.EmbeddingStore, TRef),
                                 (tstore.EmbeddingStore, DistCacheTable)):
        st = store_cls()
        t = st.init_table(60, 4, opt="sgd", lr=0.1, seed=2)
        c = cache_cls(st, t, limit=10, pull_bound=3, push_bound=2,
                      policy=policy)
        outs = []
        for keys, grads in _zipf_trace(60, 10, 14, seed=8):
            outs.append(c.lookup(keys))
            c.update(keys, grads)
        c.flush()
        stats = {k: v for k, v in c.perf().items() if k != "push_rpcs"}
        runs.append((outs, st.get_data(t), st.versions(t, np.arange(60)),
                     stats))
    (jo, jd, jv, js_), (to, td, tv, ts_), (vo, vd, vv, vs) = runs
    for a, b, c in zip(jo, to, vo):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert np.array_equal(jd, td) and np.array_equal(jd, vd)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jv, vv)
    assert js_ == ts_ == vs and ts_["evictions"] > 0
