"""The port's sharded parameter server against the JAX package's, on the
CPU: the TCP transport, ``StoreServer`` / ``DistributedStore`` (two ranks
in one process, and rank 1 in a spawned process of either package), the
SSP clocks and ``DistPartialReduce``, and the executor's PS plane (BSP,
ASP, SSP, prefetch, ``DataloaderOp`` ids, the native cache) on tiny Wide
& Deep at ``tests/test_torch_ctr.py``'s gates: losses rtol 1e-5, the
store table rtol 2e-5 / atol 1e-6, versions and counters exact.

A **mixed world** has rank 0 a port ``DistributedStore`` (this process)
and rank 1 a ``hetu_tpu`` one (a spawned JAX process): the port's client
talks to the JAX server and the JAX client to the port's, and every
result equals the all-port world's.  Each spawned world starts once per
module.
"""
import multiprocessing as mp
import os
import socket
import struct
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                     # noqa: E402
import hetu_tpu_torch as tht               # noqa: E402
from hetu_tpu import metrics as jmetrics   # noqa: E402
from hetu_tpu.ps import dist_store as jds  # noqa: E402
from hetu_tpu_torch import metrics as tmetrics  # noqa: E402
from hetu_tpu_torch.ps import dist_store as tds  # noqa: E402

VOCAB, DIM, BATCH = 520, 4, 8
STATS = ("lookups", "hits", "evictions", "pushes", "fetches", "updates")
DEDUP = ("ps_dedup_pull_rows_saved", "ps_dedup_pull_bytes_saved",
         "ps_dedup_push_rows_saved", "ps_dedup_push_bytes_saved",
         "ps_push_pull_fused_rpcs")


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _two_ranks(mod, rows=64, width=8, lr=1.0, **kw):
    """Ranks 0 and 1 of a store in this process, one table of zeros."""
    ports = _free_ports(2)
    ends = [("127.0.0.1", p) for p in ports]
    stores = [mod.DistributedStore(r, 2, ends, port=ports[r], **kw)
              for r in range(2)]
    tid = [s.init_table(rows, width, opt="sgd", lr=lr, init_scale=0.0)
           for s in stores][0]
    return stores, tid


def _close(stores):
    for s in stores:
        s.close()


def _dedup_counts(metrics):
    c = metrics.cache_counts()
    return {k: c.get(k, 0) for k in DEDUP}


# -- one process -------------------------------------------------------------------

def test_dedup_counters_and_semantics():
    got = []
    for mod, metrics in ((jds, jmetrics), (tds, tmetrics)):
        metrics.reset_cache_counts()
        store = mod.DistributedStore(0, 1)
        try:
            t = store.init_table(32, 4, opt="sgd", lr=1.0, init_scale=0.0)
            dup = np.asarray([3, 3, 5, 3, 5, 9], np.int64)
            rows = store.pull(t, dup)
            store.push(t, dup, np.ones((6, 4), np.float32))
            got.append((rows, store.pull(t, np.asarray([3, 5, 9])),
                        store.versions(t, dup), _dedup_counts(metrics)))
        finally:
            store.close()
    (jr, jp, jv, jc), (tr, tp, tv, tc) = got
    assert tr.shape == (6, 4) and np.array_equal(tr, jr)
    np.testing.assert_array_equal(tp[:, 0], [-3.0, -2.0, -1.0])
    assert np.array_equal(tp, jp)
    np.testing.assert_array_equal(tv, [1, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(tv, jv)
    assert tc == jc and tc["ps_dedup_push_rows_saved"] == 3


def test_fused_push_pull_single_round_trip():
    got = []
    for mod, metrics in ((jds, jmetrics), (tds, tmetrics)):
        metrics.reset_cache_counts()
        stores, tid = _two_ranks(mod)
        try:
            s0 = stores[0]
            push_keys = np.asarray([1, 3, 2], np.int64)  # 1, 3 remote
            rows = s0.push_pull(tid, push_keys, np.ones((3, 8), np.float32),
                                np.asarray([1, 3, 2, 5], np.int64), lr=1.0)
            s0.push(tid, push_keys, np.ones((3, 8), np.float32), lr=1.0)
            got.append((rows, s0.pull(tid, push_keys),
                        _dedup_counts(metrics)))
        finally:
            _close(stores)
    (jr, jp, jc), (tr, tp, tc) = got
    np.testing.assert_array_equal(tr[:, 0], [-1.0, -1.0, -1.0, 0.0])
    assert np.array_equal(tr, jr) and np.array_equal(tp, jp)
    assert np.all(tp == -2.0)
    assert tc == jc and tc["ps_push_pull_fused_rpcs"] == 1


def test_fused_push_pull_dup_frame_applies_push_once():
    """The same (client, seq) OP_PUSH_PULL frame sent twice, as a retry
    whose ack was lost: the push half applies once, the pull answers
    both times."""
    got = []
    for mod in (jds, tds):
        stores, tid = _two_ranks(mod)
        s0 = stores[0]
        try:
            # npush 2: push [1, 3], pull [1, 3]
            keys = np.asarray([2, 1, 3, 1, 3], np.int64)
            payload = np.ones((2, 8), np.float32).tobytes()
            seq = 12345
            raws = [s0._rpc(1, mod.OP_PUSH_PULL, tid, keys, payload, 1.0, 8,
                            shard=1, seq=seq) for _ in range(2)]
            rows = [np.frombuffer(r, np.float32).reshape(2, 8) for r in raws]
            got.append((rows, s0.versions(tid, np.asarray([1, 3]))))
        finally:
            _close(stores)
    (jr, jv), (tr, tv) = got
    for a, b in zip(jr, tr):
        assert np.array_equal(a, b) and np.all(b == -1.0)
    np.testing.assert_array_equal(tv, [1, 1])
    np.testing.assert_array_equal(tv, jv)


def test_recv_frame_rejects_corrupt_lengths():
    tmetrics.reset_faults()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<q", -5))
        with pytest.raises(tds.FrameError, match="outside"):
            tds._recv_frame(b)
        a.sendall(struct.pack("<q", tds.MAX_FRAME_BYTES + 1))
        with pytest.raises(tds.FrameError, match="outside"):
            tds._recv_frame(b)
        assert tmetrics.fault_counts().get("ps_bad_frame", 0) == 2
        assert issubclass(tds.FrameError, ConnectionError)
    finally:
        a.close()
        b.close()
    assert tds.MAX_FRAME_BYTES == jds.MAX_FRAME_BYTES
    assert tds._HDR.format == jds._HDR.format
    assert {tds.op_name(v) for v in range(1, 20)} == \
        {jds.op_name(v) for v in range(1, 20)}
    import random
    a_, b_ = random.Random(3), random.Random(3)
    prev_a = prev_b = 0.0
    for _ in range(8):
        prev_a = tds._next_backoff(0.05, prev_a, 1.0, a_)
        prev_b = jds._next_backoff(0.05, prev_b, 1.0, b_)
        assert prev_a == prev_b and 0.05 <= prev_a <= 1.0


def test_server_survives_hostile_frame():
    store = tds.DistributedStore(0, 1)
    try:
        s = socket.create_connection(("127.0.0.1", store.server.port),
                                     timeout=5)
        s.sendall(struct.pack("<q", 1 << 60))   # an exabyte frame
        s.settimeout(10)
        assert s.recv(1) == b"", "the server should drop the connection"
        s.close()
        store.ssp_init(1)                       # the server still serves
        store.clock()
        np.testing.assert_array_equal(store.clocks(), [1])
    finally:
        store.close()


def test_clock_channels_are_independent():
    store = tds.DistributedStore(0, 1)
    try:
        store.ssp_init(1)                       # the executor's channel
        pr = tht.dist.DistPartialReduce(store, n_workers=1, max_wait_ms=50.0,
                                        min_workers=1)
        for _ in range(5):
            store.clock()
        np.testing.assert_array_equal(store.clocks(), [5])
        np.testing.assert_array_equal(store.clocks(channel=pr.CHANNEL), [0])
        pr.report_arrival(0, 0)
        np.testing.assert_allclose(pr.get_partner(0, 0), [1.0])
        np.testing.assert_array_equal(store.clocks(channel=pr.CHANNEL), [1])
        with pytest.raises(RuntimeError, match="channel 7 not initialised"):
            store.clocks(channel=7)
    finally:
        store.close()


def test_heartbeats_liveness_and_stopped_server():
    tmetrics.reset_faults()
    stores, _ = _two_ranks(tds, rpc_timeout=2.0, rpc_retries=2,
                           connect_timeout=2.0)
    s0, s1 = stores
    try:
        np.testing.assert_array_equal(s0.alive_mask(100, 3), [1, 1, 1])
        s1.heartbeat(step=7)
        s0.heartbeat()
        np.testing.assert_array_equal(s0.alive_mask(5000), [1, 1])
        time.sleep(0.35)
        s0.heartbeat()
        # rank 1 went stale; rank 2 never pinged and counts alive
        np.testing.assert_array_equal(s0.alive_mask(300, 3), [1, 0, 1])
        # rank 1 answers a direct probe: cut off from rank 0, not dead
        rep = s0.liveness_report(300)
        assert rep == {"alive": [0], "dead": [], "unreachable": [1]}
        s1.start_heartbeat(interval_ms=20)
        time.sleep(0.2)
        s0.heartbeat()
        np.testing.assert_array_equal(s0.alive_mask(150), [1, 1])
        s1._hb_stop.set()
        s1.server.stop()                  # a stopped server serves nothing
        time.sleep(0.3)
        s0.heartbeat()
        rep = s0.liveness_report(150)
        assert rep == {"alive": [0], "dead": [1], "unreachable": []}
        with pytest.raises(RuntimeError, match="peer 1 .*unreachable"):
            s0.pull(0, np.asarray([1]))
        assert tmetrics.fault_counts().get("ps_peer_unreachable", 0) >= 1
    finally:
        _close(stores)


def test_what_stays_refused_by_name():
    stores, tid = _two_ranks(tds)
    s0 = stores[0]
    try:
        for op in (tds.OP_REPLICATE, tds.OP_PROMOTE, tds.OP_INIT,
                   tds.OP_SYNC, tds.OP_SYNC_PUT, tds.OP_CHECKSUM,
                   tds.OP_EPOCH):
            with pytest.raises(RuntimeError, match=tds.op_name(op)
                               + r".*not ported"):
                s0._rpc(1, op, 0, np.asarray([1, 0], np.int64))
        for call in (lambda: s0.re_replicate(), lambda: s0.maybe_re_replicate(),
                     lambda: s0.re_replicate_async(),
                     lambda: s0.table_checksum(tid, 1),
                     lambda: s0.shard_epoch(1)):
            with pytest.raises(NotImplementedError, match="not ported"):
                call()
        with pytest.raises(RuntimeError, match="unknown opcode"):
            s0._rpc(1, 99, 0, np.zeros(0, np.int64))
        np.testing.assert_array_equal(s0.pull(tid, [1, 2]), 0.0)
    finally:
        _close(stores)
    with pytest.raises(ValueError, match="replication=3"):
        tds.DistributedStore(0, 1, replication=3)


def test_set_data_async_push_and_shard_files(tmp_path):
    stores, tid = _two_ranks(tds, rows=11, width=3, lr=0.5)
    s0, s1 = stores
    try:
        table = np.arange(33, dtype=np.float32).reshape(11, 3)
        s0.set_data(tid, table)
        np.testing.assert_array_equal(s1.pull(tid, np.arange(11)), table)
        with pytest.raises(ValueError, match="shape"):
            s0.set_data(tid, table[:5])
        for k in (1, 4, 4, 9):
            s0.push_async(tid, np.asarray([k]), np.ones((1, 3), np.float32))
        s0.flush()
        want = table.copy()
        want[[1, 9]] -= 0.5
        want[4] -= 1.0
        np.testing.assert_array_equal(s0.pull(tid, np.arange(11)), want)
        for s in stores:
            s.save(tid, str(tmp_path / "t.bin"))
        assert sorted(os.listdir(tmp_path)) == ["t.bin.shard0", "t.bin.shard1"]
        s0.set_data(tid, np.zeros((11, 3), np.float32))
        for s in stores:
            s.load(tid, str(tmp_path / "t.bin"))
        np.testing.assert_array_equal(s1.pull(tid, np.arange(11)), want)
        assert s0.width(tid) == 3
        # a mis-shaped shard from the wire is refused, not read past
        with pytest.raises(RuntimeError, match="set_data shape"):
            s0._rpc(1, tds.OP_SET_DATA, tid, np.zeros(0, np.int64),
                    np.zeros((2, 3), np.float32).tobytes(), width=3, shard=1)
    finally:
        _close(stores)


# -- spawned worlds ----------------------------------------------------------------

def _shard_child(kind, ports, conn):
    """Rank 1 of a two-rank store of the ``kind`` package, driven by
    commands over ``conn``."""
    try:
        if kind == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
            from hetu_tpu.ps.dist_store import DistributedStore
            from hetu_tpu.parallel.preduce import DistPartialReduce
        else:
            from hetu_tpu_torch.ps.dist_store import DistributedStore
            from hetu_tpu_torch.parallel.preduce import DistPartialReduce
        store = DistributedStore(1, 2, [("127.0.0.1", p) for p in ports],
                                 port=ports[1], rpc_timeout=10.0,
                                 rpc_retries=2, connect_timeout=5.0)
        store.init_table(40, 4, opt="adam", lr=0.05, seed=3)
        pr = None
        conn.send(("ready", None))
        while True:
            cmd, args = conn.recv()
            try:
                if cmd == "exit_hard":
                    os._exit(1)
                if cmd == "close":
                    store.close()
                    conn.send(("ok", None))
                    return
                if cmd == "preduce":
                    pr = DistPartialReduce(store, max_wait_ms=300.0,
                                           min_workers=1)
                    out = None
                elif cmd == "arrive":
                    out = pr.report_arrival(1, args)
                elif cmd == "partner":
                    out = pr.get_partner(1, args)
                else:
                    out = getattr(store, cmd)(*args)
                conn.send(("ok", out))
            except Exception as e:     # back to the test, which raises it
                conn.send(("err", f"{type(e).__name__}: {e}"))
    except BaseException as e:
        try:
            conn.send(("err", f"{type(e).__name__}: {e}"))
        except Exception:
            pass


class _World:
    """Rank 0 (a port store here) and rank 1 (a spawned process)."""

    def __init__(self, ctx, kind):
        self.kind = kind
        self.ports = _free_ports(2)
        self.store = tds.DistributedStore(
            0, 2, [("127.0.0.1", p) for p in self.ports],
            port=self.ports[0], rpc_timeout=10.0, rpc_retries=2,
            connect_timeout=5.0)
        self.tid = self.store.init_table(40, 4, opt="adam", lr=0.05, seed=3)
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_shard_child,
                                args=(kind, self.ports, child), daemon=True)
        self.proc.start()

    def wait_ready(self):
        if not self.conn.poll(120):
            raise RuntimeError(f"{self.kind} shard process did not start")
        status, msg = self.conn.recv()
        assert status == "ready", msg

    def child(self, cmd, *args):
        self.conn.send((cmd, args[0] if cmd in ("arrive", "partner")
                        else args))
        if not self.conn.poll(60):
            raise RuntimeError(f"{self.kind} shard process hung on {cmd}")
        status, out = self.conn.recv()
        if status != "ok":
            raise RuntimeError(f"{self.kind} rank 1: {out}")
        return out

    def close(self):
        try:
            if self.proc.is_alive():
                self.child("close")
        except Exception:
            pass
        self.store.close()
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(10)


@pytest.fixture(scope="module")
def worlds():
    ctx = mp.get_context("spawn")
    ws = {kind: _World(ctx, kind) for kind in ("port", "jax")}
    try:
        for w in ws.values():
            w.wait_ready()
        yield ws
    finally:
        for w in ws.values():
            w.close()


def _script(w):
    """One op sequence through a world: rank 0 (this process) and rank 1
    (the spawned client) both push and pull across the shards."""
    s, t = w.store, w.tid
    rng = np.random.RandomState(4)
    out = [s.pull(t, np.arange(40))]                   # rank 1's rows too
    for step in range(3):
        keys = rng.randint(0, 40, 12)
        grads = rng.randn(12, 4).astype(np.float32)
        s.push(t, keys, grads)
        w.child("push", t, keys[::-1].copy(), grads[::-1].copy())
        pk = rng.randint(0, 40, 7)
        out.append(s.push_pull(t, pk, np.ones((7, 4), np.float32), keys))
        out.append(w.child("pull", t, keys))
    out.append(w.child("push_pull", t, np.asarray([2, 5]),
                       np.ones((2, 4), np.float32), np.asarray([5, 6])))
    out.append(s.versions(t, np.arange(40)))
    out.append(w.child("versions", t, np.arange(40)))
    s.ssp_init(2)
    w.child("ssp_init", 2)                              # idempotent
    s.clock()
    w.child("clock")
    w.child("clock")
    out.append(s.clocks())
    out.append(w.child("clocks"))
    out.append(np.asarray([w.child("ssp_sync", None, 1, 2000),
                           w.child("ssp_sync", None, 0, 50)]))
    w.child("heartbeat", None, 3)
    out.append(s.alive_mask(5000))
    out.append(s.pull(t, np.arange(40)))
    return out


def test_mixed_world_exchanges_equal_results(worlds):
    """The port's client with the JAX server (pull, push, push_pull,
    versions) and the JAX client with the port's server (the same, and
    the SSP clocks on rank 0): every result equals the all-port
    world's."""
    got = {k: _script(w) for k, w in worlds.items()}
    assert len(got["port"]) == len(got["jax"])
    for i, (a, b) in enumerate(zip(got["port"], got["jax"])):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), i
    port = got["port"]
    np.testing.assert_array_equal(port[-4], [1, 2])     # clocks
    np.testing.assert_array_equal(port[-3], [True, False])
    assert not np.array_equal(port[0], port[-1])


def test_dist_partial_reduce_forms_the_jax_group(worlds):
    masks = {}
    for kind, w in worlds.items():
        pr = tht.dist.DistPartialReduce(w.store, max_wait_ms=300.0,
                                        min_workers=1)
        w.child("preduce")
        pr.report_arrival(0, 0)
        w.child("arrive", 0)
        got = [pr.get_partner(0, 0), w.child("partner", 0)]
        pr.report_arrival(0, 1)               # rank 1 straggles: alone
        t0 = time.monotonic()
        got.append(pr.get_partner(0, 1))
        waited = time.monotonic() - t0
        w.child("arrive", 1)                  # rank 0 already arrived
        got.append(w.child("partner", 1))
        masks[kind] = got
        assert 0.25 <= waited < 5.0
    for a, b in zip(masks["port"], masks["jax"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(masks["port"]),
                                  [[1, 1], [1, 1], [1, 0], [1, 1]])


def test_dead_peer_raises_a_clean_diagnostic(worlds):
    """Rank 1 dies hard: the next RPC to it raises a RuntimeError naming
    the peer within the retry budget, and shard 0 still answers."""
    w = worlds["port"]
    s, t = w.store, w.tid
    s.rpc_timeout, s.rpc_retries = 3.0, 2
    np.testing.assert_array_equal(s.pull(t, [1]).shape, (1, 4))
    w.conn.send(("exit_hard", ()))
    w.proc.join(30)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="peer 1 .*unreachable"):
        for _ in range(3):      # the first recv may see a clean reset
            s.pull(t, np.asarray([1]))
    assert time.monotonic() - t0 < 30
    assert s.pull(t, np.asarray([0])).shape == (1, 4)


# -- the executor's PS plane on tiny Wide & Deep ---------------------------------

def _jax_ctr():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_ctr_models_ps", os.path.join(ROOT, "examples", "ctr",
                                          "models.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table():
    return np.random.RandomState(1).uniform(
        -0.01, 0.01, (VOCAB, DIM)).astype(np.float32)


def _data(steps, seed=0):
    d, s, y = tht.synthetic_criteo_skewed((steps + 1) * BATCH, vocab=VOCAB,
                                          seed=seed)
    return d, s, y


def _wdl(ht, mlp, emb, dense, y_):
    """Wide & Deep above ``emb`` (the two packages' ``wdl_criteo``)."""
    flat = ht.array_reshape_op(emb, (BATCH, 26 * DIM))
    deep = mlp(ht.concat_op(flat, dense, axis=1),
               [26 * DIM + 13, 256, 256, 1], "deep")
    prob = ht.sigmoid_op(mlp(dense, [13, 1], "wide") + deep)
    loss = ht.reduce_mean_op(ht.binarycrossentropy_op(prob, y_), [0, 1])
    return loss, prob


def _ps_run(pkg, store, t, steps=5, device_cache=False, ids=None,
            cache_kw=None, weights=None, flush_each=False, **ex_kw):
    """Tiny WDL through a DistCacheTable (or ``(store, t)`` when
    ``cache_kw`` is False) over ``store``: (losses, store table after the
    flushes, versions, cache stats, executor)."""
    port = pkg is tht
    mlp = tht.models.ctr._mlp if port else _jax_ctr()._mlp
    d, s, y = _data(steps)
    dense = pkg.placeholder_op("dense")
    y_ = pkg.placeholder_op("y")
    sparse = ids if ids is not None else \
        pkg.placeholder_op("sparse", dtype=np.int64)
    store.set_data(t, _table())
    if cache_kw is False:
        table = (store, t)
        cache = None
    else:
        kw = dict(limit=52, pull_bound=10, push_bound=10, policy="lru",
                  device=device_cache)
        if device_cache:
            kw["device_scratch"] = BATCH * 26
            if port:
                kw["slab_device"] = "cpu"
        kw.update(cache_kw or {})
        cache = table = pkg.ps.DistCacheTable(store, t, **kw)
    emb = pkg.ps_embedding_lookup_op(table, sparse, width=DIM)
    loss, _ = _wdl(pkg, mlp, emb, dense, y_)
    train = pkg.optim.SGDOptimizer(0.01).minimize(loss)
    if port:
        ex_kw.setdefault("device", "cpu")
    ex = pkg.Executor({"train": [loss, train]}, seed=0, **ex_kw)
    if weights is not None:
        ex.load_dict(weights)
    losses = []
    for i in range(steps):
        fd = {dense: d[i * BATCH:(i + 1) * BATCH],
              y_: y[i * BATCH:(i + 1) * BATCH]}
        if ids is None:
            fd[sparse] = s[i * BATCH:(i + 1) * BATCH]
        losses.append(float(ex.run("train", feed_dict=fd)[0].asnumpy()))
        if flush_each:
            ex.ps_flush()
    ex.ps_flush()
    # a lookahead pull in flight lands before the table is read
    for _, fut in ex.subexecutors["train"]._prefetched.values():
        fut.result()
    stats = None
    if cache is not None:
        cache.flush()
        stats = {k: cache.stats[k] for k in STATS}
    keys = np.arange(VOCAB)
    return (losses, store.pull(t, keys), store.versions(t, keys), stats, ex)


def _close_ex(ex):
    """The port's executor stops its threads (the JAX one has none)."""
    if isinstance(ex, tht.Executor):
        ex.close()


def _assert_gates(got, want, exact=False):
    """``tests/test_torch_ctr.py``'s gates (or bit for bit)."""
    if exact:
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


@pytest.fixture(scope="module")
def jax_weights():
    """One set of MLP weights, the JAX package's initialisation."""
    stores, t = _two_ranks(jds, rows=VOCAB, width=DIM, lr=0.01)
    try:
        *_, ex = _ps_run(jht, stores[0], t, steps=0)
        return ex.return_tensor_values()
    finally:
        _close(stores)


@pytest.mark.parametrize("device_cache", [False, True])
def test_wdl_over_two_ranks_matches_jax_and_the_local_store(jax_weights,
                                                            device_cache):
    """BSP over a two-rank store: the port against the JAX package at the
    gates, and bit for bit against the port over one local store."""
    runs = {}
    for name, pkg, mod in (("jax", jht, jds), ("port", tht, tds)):
        stores, t = _two_ranks(mod, rows=VOCAB, width=DIM, lr=0.01)
        try:
            tmetrics.reset_rpc_stats()
            runs[name] = _ps_run(pkg, stores[0], t, weights=jax_weights,
                                 device_cache=device_cache)
            if pkg is tht:
                calls = tmetrics.rpc_stats()["calls"]
                # only the misses and the pushes cross the socket
                assert calls.get("OP_PUSH_PULL", 0) \
                    + calls.get("OP_PULL", 0) >= 1
            _close_ex(runs[name][-1])
        finally:
            _close(stores)
    local = tht.EmbeddingStore()
    lt = local.init_table(VOCAB, DIM, opt="sgd", lr=0.01)
    runs["local"] = _ps_run(tht, local, lt, weights=jax_weights,
                            device_cache=device_cache)
    _assert_gates(runs["port"], runs["jax"])
    _assert_gates(runs["port"], runs["local"], exact=True)
    assert runs["port"][3]["evictions"] > 0


def test_wdl_asp_flushed_table_equals_bsp(jax_weights):
    """ASP (``bsp=-1``) with a flush each step trains as BSP bit for bit,
    as in the JAX package; without it, every push lands by
    ``ps_flush``."""
    runs = {}
    for bsp, flush in ((0, False), (-1, True)):
        for name, pkg, mod in (("jax", jht, jds), ("port", tht, tds)):
            stores, t = _two_ranks(mod, rows=VOCAB, width=DIM, lr=0.01)
            try:
                runs[name, bsp] = _ps_run(pkg, stores[0], t, bsp=bsp,
                                          weights=jax_weights,
                                          flush_each=flush)
                _close_ex(runs[name, bsp][-1])
            finally:
                _close(stores)
    _assert_gates(runs["port", -1], runs["port", 0], exact=True)
    _assert_gates(runs["port", -1], runs["jax", -1])
    # no barrier: a plain table's versions after ps_flush
    stores, t = _two_ranks(tds, rows=VOCAB, width=DIM, lr=0.01)
    try:
        got = _ps_run(tht, stores[0], t, bsp=-1, cache_kw=False,
                      weights=jax_weights)
        ex = got[-1]
        assert ex._ps_futures == [] and ex._ps_pool is not None
        _, s, _ = _data(5)
        want = np.zeros(VOCAB, np.int64)    # one bump a push a key
        for i in range(5):
            want[np.unique(s[i * BATCH:(i + 1) * BATCH])] += 1
        np.testing.assert_array_equal(got[2], want)
        ex.close()
    finally:
        _close(stores)


def test_wdl_ssp_ticks_one_clock_a_step(jax_weights):
    got = {}
    for name, pkg, mod in (("jax", jht, jds), ("port", tht, tds)):
        stores, t = _two_ranks(mod, rows=VOCAB, width=DIM, lr=0.01)
        try:
            stores[0].ssp_init(1)
            got[name] = _ps_run(pkg, stores[0], t, bsp=2, weights=jax_weights,
                                ssp_timeout_ms=20000)
            got[name, "clocks"] = stores[0].clocks()
            _close_ex(got[name][-1])
        finally:
            _close(stores)
    np.testing.assert_array_equal(got["port", "clocks"], [5])
    np.testing.assert_array_equal(got["jax", "clocks"], [5])
    _assert_gates(got["port"], got["jax"])
    # a store never ssp_init-ed is skipped
    stores, t = _two_ranks(tds, rows=VOCAB, width=DIM, lr=0.01)
    try:
        bsp0 = _ps_run(tht, stores[0], t, bsp=0, weights=jax_weights,
                       steps=2)
        ssp = _ps_run(tht, stores[0], t, bsp=1, weights=jax_weights,
                      steps=2)
        assert ssp[0] == bsp0[0]
    finally:
        _close(stores)


@pytest.mark.parametrize("cache", [False, True])
def test_wdl_dataloader_ids_with_and_without_prefetch(jax_weights, cache):
    """Ids from a ``DataloaderOp``, over one local store (over a sharded
    store BSP skips the lookahead): the lookahead taken, prefetch on and
    off bit-equal (through the cache, the losses: the last step's
    lookahead is one more lookup), and the port against the JAX package
    at the gates."""
    _, s, _ = _data(5)
    runs = {}
    for name, pkg in (("jax", jht), ("port", tht)):
        for prefetch in (True, False):
            ids = pkg.dataloader_op([pkg.Dataloader(s, BATCH, "train")])
            st = pkg.EmbeddingStore()
            t = st.init_table(VOCAB, DIM, opt="sgd", lr=0.01)
            r = _ps_run(pkg, st, t, ids=ids, weights=jax_weights,
                        prefetch=prefetch, cache_kw=None if cache else False)
            sub = r[-1].subexecutors["train"]
            assert bool(sub._prefetched) == prefetch, (name, prefetch)
            if pkg is tht:
                r[-1].close()
            runs[name, prefetch] = r
    if cache:
        assert runs["port", True][0] == runs["port", False][0]
    else:
        _assert_gates(runs["port", True], runs["port", False], exact=True)
    for prefetch in (True, False):
        _assert_gates(runs["port", prefetch], runs["jax", prefetch])
    # the ids a run took are the loader's batches in order
    ids = tht.dataloader_op([tht.Dataloader(s, BATCH, "train")])
    st = tht.EmbeddingStore()
    t = st.init_table(VOCAB, DIM, opt="sgd", lr=0.01)
    r = _ps_run(tht, st, t, ids=ids, cache_kw=False, weights=jax_weights,
                steps=2)
    node = r[-1].subexecutors["train"].ps_nodes[0]
    np.testing.assert_array_equal(node._last_ids, s[BATCH:2 * BATCH])
    r[-1].close()


def test_wdl_native_lru_cache_matches_jax():
    """``embed_mode='lru'``: the native cache over each package's default
    store, 5 SGD steps."""
    jctr = _jax_ctr()
    d, s, y = _data(5)
    runs = []
    for pkg, ctr in ((jht, jctr), (tht, tht.models.ctr)):
        dense = pkg.placeholder_op("dense")
        sparse = pkg.placeholder_op("sparse", dtype=np.int64)
        y_ = pkg.placeholder_op("y")
        loss, _ = ctr.wdl_criteo(dense, sparse, y_, BATCH, vocab=VOCAB,
                                 dim=DIM, embed_mode="lru", lr=0.01)
        kw = {"device": "cpu"} if pkg is tht else {}
        ex = pkg.Executor({"train": [loss, pkg.optim.SGDOptimizer(0.01)
                                     .minimize(loss)]}, seed=0, **kw)
        if runs:
            ex.load_dict(runs[0][-1])        # the JAX initial weights
        w0 = ex.return_tensor_values()
        cache = ex.subexecutors["train"].ps_nodes[0].cache
        assert cache._h is not None
        losses = [float(ex.run("train", feed_dict={
            dense: d[i * BATCH:(i + 1) * BATCH],
            sparse: s[i * BATCH:(i + 1) * BATCH],
            y_: y[i * BATCH:(i + 1) * BATCH]})[0].asnumpy())
            for i in range(5)]
        cache.flush()
        runs.append((losses, cache.store.get_data(cache.table),
                     cache.store.versions(cache.table, np.arange(VOCAB)),
                     cache.perf(), w0))
        if pkg is tht:
            ex.close()
    (jl, jd, jv, jp, _), (tl, td, tv, tp, _) = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(tv, jv)
    assert tp == jp and tp["lookups"] == 5 * BATCH * 26
