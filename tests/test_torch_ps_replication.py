"""Shard replication of the port's parameter server against the JAX
package's, on the CPU: the twins of ``tests/test_ps_replication.py``
(but its two chaos cases, which wait for a chaos injector, and the bench
smoke).  Each scenario runs once on a cluster of each package — 2 or 3
ranks as server threads in this process, short timeouts — on the same
sequence of operations, and the two runs agree: the pulled tables and
versions bit for bit, every copy's state digest (``OP_CHECKSUM``) bit for
bit, and every fault counter equal.

Two mixed rings hold the wire: a JAX primary with a port backup and the
reverse, replicas bit-equal after forwarded Adam pushes and a failover;
and the repo's ``tools/ps_fsck.py`` and the port's ``ps_fsck`` give one
report on one cluster."""
import os
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu as jht                                # noqa: E402
from hetu_tpu import metrics as jmetrics              # noqa: E402
from hetu_tpu.ps import dist_store as jds             # noqa: E402
import hetu_tpu_torch as tht                          # noqa: E402
from hetu_tpu_torch import metrics as tmetrics        # noqa: E402
from hetu_tpu_torch.ps import dist_store as tds       # noqa: E402
from hetu_tpu_torch.tools import ps_fsck as tfsck     # noqa: E402
from tools import ps_fsck as jfsck                    # noqa: E402
from _torch_ps_harness import (close_all as _close_all,  # noqa: E402
                               ends as _ends, free_ports as _free_ports,
                               run_both)

JAX = SimpleNamespace(name="jax", ds=jds, metrics=jmetrics, fsck=jfsck)
PORT = SimpleNamespace(name="port", ds=tds, metrics=tmetrics, fsck=tfsck)
FAST = dict(rpc_timeout=5.0, rpc_retries=2, connect_timeout=2.0)


@pytest.fixture(autouse=True)
def _clean_counters():
    for pkg in (JAX, PORT):
        pkg.metrics.reset_faults()
    yield
    for pkg in (JAX, PORT):
        pkg.metrics.reset_faults()


def _cluster(pkg, world=3, rows=48, width=8, opt="sgd", lr=0.1, mods=None,
             **kw):
    """``world`` replicated stores (rank r of package ``mods[r]``, all
    ``pkg`` by default) sharing one table seeded through the replicated
    ``set_data``."""
    ports = _free_ports(world)
    for k, v in FAST.items():
        kw.setdefault(k, v)
    mods = mods or [pkg.ds] * world
    stores = [mods[r].DistributedStore(r, world, _ends(ports), port=ports[r],
                                       replication=2, **kw)
              for r in range(world)]
    tid = None
    for s in stores:
        tid = s.init_table(rows, width, opt=opt, lr=lr, init_scale=0.0)
    stores[0].set_data(tid, np.random.RandomState(42).normal(
        0, 0.01, (rows, width)).astype(np.float32))
    return stores, tid, ports


def _standby(pkg, rank, world, ports):
    return pkg.ds.DistributedStore(rank, world, _ends(ports),
                                   port=ports[rank], replication=2,
                                   standby=True, **FAST)


def _digests(client, tid, world, shards=None):
    """Every live holder's digest of every shard: {(shard, rank): hex}."""
    out = {}
    for s in shards if shards is not None else range(world):
        for r in (s, (s + 1) % world):
            try:
                out[(s, r)] = client.table_checksum(tid, s, rank=r)
            except RuntimeError:
                out[(s, r)] = None          # a stopped holder
    return out


def _replicas_equal(d, shards):
    for s in shards:
        pair = [v for (sh, _), v in d.items() if sh == s]
        assert len(pair) == 2 and pair[0] == pair[1], (s, d)


def _both(scenario):
    """``scenario`` in both packages: values and fault counters equal."""
    return run_both((JAX, PORT), scenario)


# -- replica parity -----------------------------------------------------------

def test_replicated_init_and_set_data_parity():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            d = _digests(stores[0], tid, 3)
            _replicas_equal(d, range(3))
            return {"digests": d, "table": stores[1].pull(tid, np.arange(48))}
        finally:
            _close_all(stores)
    _both(scenario)


def test_oplog_forwarding_keeps_adam_moments_identical():
    """Pushes from every client, duplicate keys included: both copies of
    every shard agree bit for bit, Adam moments and step counters too,
    and the digests are the JAX package's."""
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg, opt="adam", lr=0.01)
        try:
            rng = np.random.RandomState(0)
            for i in range(6):
                ids = rng.randint(0, 48, 32)
                g = rng.standard_normal((32, 8)).astype(np.float32) * 0.1
                stores[i % 3].push(tid, ids, g)
            d = _digests(stores[0], tid, 3)
            _replicas_equal(d, range(3))
            return {"digests": d,
                    "table": stores[2].pull(tid, np.arange(48)),
                    "versions": stores[1].versions(tid, np.arange(48))}
        finally:
            _close_all(stores)
    _both(scenario)


def test_fused_push_pull_rides_the_oplog():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            rng = np.random.RandomState(1)
            rows = []
            for _ in range(4):
                keys = np.unique(rng.randint(0, 48, 16))
                g = rng.standard_normal((keys.size, 8)).astype(np.float32)
                rows.append(stores[0].push_pull(tid, keys, g, np.arange(48)))
            d = _digests(stores[0], tid, 3)
            _replicas_equal(d, range(3))
            return {"digests": d, "rows": np.stack(rows)}
        finally:
            _close_all(stores)
    _both(scenario)


def test_replication1_is_unchanged_and_counter_free():
    def scenario(pkg):
        ports = _free_ports(2)
        stores = [pkg.ds.DistributedStore(r, 2, _ends(ports), port=ports[r],
                                          **FAST) for r in range(2)]
        try:
            tid = None
            for s in stores:
                tid = s.init_table(16, 4, opt="sgd", lr=1.0, init_scale=0.0)
            assert stores[0].replication == 1
            assert len(stores[0].server._stores) == 1
            stores[0].push(tid, np.asarray([1, 2]),
                           np.ones((2, 4), np.float32))
            row = stores[1].pull(tid, np.asarray([1]))[0]
            np.testing.assert_allclose(row, -1.0)
        finally:
            _close_all(stores)
        fc = pkg.metrics.fault_counts()
        for k in fc:
            assert "failover" not in k and "repl" not in k \
                and "promote" not in k, fc
        return {"row": row}
    _both(scenario)


def test_replication_env_knob(monkeypatch):
    monkeypatch.setenv("HETU_PS_REPLICATION", "2")

    def scenario(pkg):
        ports = _free_ports(2)
        stores = [pkg.ds.DistributedStore(r, 2, _ends(ports), port=ports[r])
                  for r in range(2)]
        try:
            out = {"replication": [s.replication for s in stores],
                   "held": [sorted(s.server._stores) for s in stores]}
        finally:
            _close_all(stores)
        with pytest.raises(ValueError, match="replication=3"):
            pkg.ds.DistributedStore(0, 2, replication=3)
        s = pkg.ds.DistributedStore(0, 1, replication=2)  # no room: 1
        try:
            out["world1"] = s.replication
        finally:
            s.close()
        return out
    out = _both(scenario)
    assert out["replication"] == [2, 2] and out["world1"] == 1
    assert out["held"] == [[0, 1], [0, 1]]


# -- transparent failover -----------------------------------------------------

def test_failover_transparent_pull_push_and_versions():
    """Kill shard 1's primary: the next op promotes the backup inside the
    failing call — the same values, no error, the counters equal."""
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            expected = stores[0].pull(tid, np.arange(48))
            vexpected = stores[0].versions(tid, np.arange(48))
            stores[1].server.stop()
            got = stores[0].pull(tid, np.arange(48))
            np.testing.assert_array_equal(got, expected)
            v = stores[0].versions(tid, np.arange(48))
            np.testing.assert_array_equal(v, vexpected)
            stores[0].push(tid, np.asarray([1, 4]),
                           np.ones((2, 8), np.float32))
            row = stores[0].pull(tid, np.asarray([1]))[0]
            np.testing.assert_allclose(row, expected[1] - 0.1)
            assert stores[0]._route[1] == 2 and 1 in stores[0]._failed_over
            return {"got": got, "row": row, "route": list(stores[0]._route),
                    "epoch": list(stores[0]._epoch)}
        finally:
            _close_all(stores)
    out = _both(scenario)
    for k in ("ps_failover", "ps_promoted", "ps_failover_promoted"):
        assert out["faults"].get(k, 0) >= 1, k


def test_failover_of_both_copies_raises_diagnosable():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            stores[1].server.stop()
            stores[2].server.stop()
            with pytest.raises(RuntimeError,
                               match="shard 1.*unreachable AND backup"):
                stores[0].pull(tid, np.asarray([1]))
            return {}
        finally:
            _close_all(stores)
    assert _both(scenario)["faults"].get("ps_failover_failed", 0) >= 1


def test_promotion_refuses_half_initialised_standby():
    def scenario(pkg):
        stores, tid, ports = _cluster(pkg)
        try:
            stores[1].server.stop()
            stores[2].server.stop()
            stores.append(_standby(pkg, 2, 3, ports))
            with pytest.raises(RuntimeError, match="not promotable"):
                stores[0].pull(tid, np.asarray([1]))
            return {}
        finally:
            _close_all(stores)
    _both(scenario)


def test_promotion_window_retry_is_exactly_once():
    """A push applied, forwarded and acked, then the primary dies before
    the client reads the ack: the retry, the same (client, seq) at the
    promoted backup, is absorbed by the backup's dedup window, which the
    forwarded frame fed."""
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            before = stores[0].pull(tid, np.asarray([1]))[0].copy()
            keys = np.asarray([1], np.int64)
            grads = np.ones((1, 8), np.float32)
            seq = next(stores[0]._seq)
            stores[0]._rpc(1, pkg.ds.OP_PUSH, tid, keys, grads.tobytes(),
                           0.1, 8, shard=1, seq=seq)
            stores[1].server.stop()
            alt = stores[0]._failover(1)
            stores[0]._rpc(alt, pkg.ds.OP_PUSH, tid, keys, grads.tobytes(),
                           0.1, 8, shard=1, seq=seq,
                           epoch=stores[0]._epoch[1])
            after = stores[0].pull(tid, np.asarray([1]))[0]
            np.testing.assert_allclose(after, before - 0.1)
            return {"alt": alt, "after": after}
        finally:
            _close_all(stores)
    assert _both(scenario)["alt"] == 2


# -- re-replication -----------------------------------------------------------

def test_re_replication_restores_redundancy_for_second_failure():
    """Fail over shard 1, relaunch a standby at the dead rank,
    re-replicate (snapshot and op-log catch-up), then kill the promoted
    ex-backup too: the second failover serves the same bits."""
    def scenario(pkg):
        stores, tid, ports = _cluster(pkg)
        try:
            rng = np.random.RandomState(3)
            stores[1].server.stop()
            stores[0].push(tid, rng.randint(0, 48, 16),
                           rng.standard_normal((16, 8)).astype(np.float32))
            assert 1 in stores[0]._failed_over
            stores.append(_standby(pkg, 1, 3, ports))
            assert not stores[-1].server.serves(1)
            stores[0].re_replicate(1)
            assert 1 not in stores[0]._failed_over
            d1 = _digests(stores[0], tid, 3, shards=[1])
            _replicas_equal(d1, [1])
            stores[0].push(tid, np.asarray([7]), np.ones((1, 8), np.float32))
            d2 = _digests(stores[0], tid, 3, shards=[1])
            _replicas_equal(d2, [1])
            expected = stores[0].pull(tid, np.arange(48))
            stores[2].server.stop()
            got = stores[0].pull(tid, np.arange(48))
            np.testing.assert_array_equal(got, expected)
            assert stores[0]._route[1] == 1
            return {"d1": d1, "d2": d2, "got": got,
                    "epoch": list(stores[0]._epoch)}
        finally:
            _close_all(stores)
    assert _both(scenario)["faults"].get("ps_re_replicated", 0) >= 1


def test_maybe_re_replicate_defers_then_repairs():
    def scenario(pkg):
        stores, tid, ports = _cluster(pkg)
        try:
            stores[1].server.stop()
            stores[0].pull(tid, np.asarray([1]))       # the failover
            first = stores[0].maybe_re_replicate()     # target dead
            deferred = pkg.metrics.fault_counts().get(
                "ps_re_replicate_deferred", 0)
            stores.append(_standby(pkg, 1, 3, ports))
            second = stores[0].maybe_re_replicate()
            d = _digests(stores[0], tid, 3, shards=[1])
            _replicas_equal(d, [1])
            return {"first": first, "second": second, "d": d,
                    "deferred": deferred}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["first"] is False and out["second"] is True
    assert out["deferred"] >= 1


def test_backup_loss_degrades_then_repairs():
    """Killing a backup leaves serving alone: the primary's forward fails
    once (counted, warned), and maybe_re_replicate re-attaches a standby
    at the backup's slot."""
    def scenario(pkg):
        stores, tid, ports = _cluster(pkg)
        try:
            stores[1].server.stop()            # shard 0's backup
            with pytest.warns(RuntimeWarning, match="UNREPLICATED"):
                stores[0].push(tid, np.asarray([0]),
                               np.ones((1, 8), np.float32))
            stores.append(_standby(pkg, 1, 3, ports))
            repaired = stores[0].maybe_re_replicate()
            d = {k: v for k, v in _digests(stores[0], tid, 3,
                                           shards=[0]).items()}
            _replicas_equal(d, [0])
            return {"repaired": repaired, "d": d}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["repaired"] is True
    assert out["faults"].get("repl_forward_failed", 0) >= 1
    assert out["faults"].get("ps_failover", 0) == 0


def test_standby_self_initialised_tables_are_not_promotable():
    def scenario(pkg):
        stores, tid, ports = _cluster(pkg)
        try:
            stores[1].server.stop()
            stores[0].pull(tid, np.asarray([1]))       # failover to rank 2
            sb = _standby(pkg, 1, 3, ports)
            stores.append(sb)
            sb.init_table(48, 8, opt="sgd", lr=0.1, init_scale=0.0)
            stores[2].server.stop()
            with pytest.raises(RuntimeError, match="never "):
                stores[0].pull(tid, np.asarray([1]))
            return {}
        finally:
            _close_all(stores)
    _both(scenario)


def test_post_failover_save_covers_adopted_shard(tmp_path):
    """The promoted server saves the shard it adopted: a save / restore
    round-trips through a failover, and each package's shard files are
    the other's, byte for byte."""
    files = {}

    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        restored = None
        base = str(tmp_path / pkg.name / "ps.bin")
        os.makedirs(os.path.dirname(base))
        try:
            stores[1].server.stop()
            expected = stores[2].pull(tid, np.arange(48))
            for r in (0, 2):
                stores[r].save(tid, base)
            files[pkg.name] = [open(f"{base}.shard{s}", "rb").read()
                               for s in range(3)]
            ports2 = _free_ports(3)
            restored = [pkg.ds.DistributedStore(r, 3, _ends(ports2),
                                                port=ports2[r], **FAST)
                        for r in range(3)]
            for s in restored:
                s.init_table(48, 8, opt="sgd", lr=0.1, init_scale=0.0)
                s.load(tid, base)
            got = restored[0].pull(tid, np.arange(48))
            np.testing.assert_array_equal(got, expected)
            return {"got": got}
        finally:
            _close_all(stores + (restored or []))
    _both(scenario)
    assert files["jax"] == files["port"]


def test_ssp_clocks_survive_rank0_death():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            stores[0].ssp_init(3)
            stores[1].clock(worker=1)
            stores[1].clock(worker=1)
            stores[2].clock(worker=2)
            stores[0].server.stop()
            c1 = stores[1].clocks()
            stores[1].clock(worker=0)
            c2 = stores[1].clocks()
            ok = stores[2].ssp_sync(worker=2, staleness=2, timeout_ms=5000)
            return {"c1": c1, "c2": c2, "ok": ok}
        finally:
            _close_all(stores)
    out = _both(scenario)
    np.testing.assert_array_equal(out["c1"], [0, 2, 1])
    np.testing.assert_array_equal(out["c2"], [1, 2, 1])
    assert out["ok"]


def test_heartbeat_mirror_survives_rank0_death():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            stores[1].heartbeat(rank=1, step=5)
            stores[2].heartbeat(rank=2, step=5)
            stores[0].server.stop()
            mask = stores[2].alive_mask(5000)
            stores[2].heartbeat(rank=2, step=6)
            return {"mask": mask[1:], "after": int(
                stores[2].alive_mask(5000)[2])}
        finally:
            _close_all(stores)
    out = _both(scenario)
    np.testing.assert_array_equal(out["mask"], [1, 1])
    assert out["after"] == 1
    assert out["faults"].get("ps_failover_promoted", 0) >= 1


# -- ps_fsck ------------------------------------------------------------------

def test_ps_fsck_clean_and_divergence_detection():
    def scenario(pkg):
        stores, tid, ports = _cluster(pkg, world=2, rows=16, width=4)
        try:
            clean = pkg.fsck.fsck(_ends(ports), n_tables=1, replication=2)
            assert clean["ok"], clean
            # rank 1's copy of shard 0, corrupted behind the op-log's back
            stores[1].server._stores[0].set_data(
                tid, np.zeros((8, 4), np.float32))
            rep = pkg.fsck.fsck(_ends(ports), n_tables=1, replication=2)
            assert not rep["ok"]
            return {"clean": clean["ok"], "bad": rep["ok"],
                    "shards": [m["shard"] for m in rep["mismatches"]],
                    "digests": [sorted(m["digests"].values())
                                for m in rep["mismatches"]]}
        finally:
            _close_all(stores)
    assert _both(scenario)["shards"] == [0]


def test_ps_fsck_cli_verify_exit_codes():
    def scenario(pkg):
        stores, tid, ports = _cluster(pkg, world=2, rows=16, width=4)
        arg = ",".join(f"127.0.0.1:{p}" for p in ports)
        try:
            codes = [pkg.fsck.main(["--endpoints", arg, "--tables", "1",
                                    "--verify"])]
            stores[0].server._stores[1].set_data(
                tid, np.zeros((8, 4), np.float32))
            codes.append(pkg.fsck.main(["--endpoints", arg, "--tables", "1",
                                        "--verify"]))
            return {"codes": codes}
        finally:
            _close_all(stores)
    assert _both(scenario)["codes"] == [0, 1]


# -- the backoff --------------------------------------------------------------

def test_backoff_is_decorrelated_jittered_and_env_tunable(monkeypatch):
    for seed in (0, 1):
        rj, rt = random.Random(seed), random.Random(seed)
        pj = pt = 0.0
        for _ in range(64):
            pj = jds._next_backoff(0.05, pj, 1.0, rj)
            pt = tds._next_backoff(0.05, pt, 1.0, rt)
            assert pj == pt and 0.05 <= pt <= 1.0
    monkeypatch.setenv("HETU_RPC_BACKOFF_MS", "123")
    s = tds.DistributedStore(0, 1)
    try:
        assert abs(s._backoff_base - 0.123) < 1e-9
    finally:
        s.close()


# -- mixed rings --------------------------------------------------------------

@pytest.mark.parametrize("primary", ["jax", "port"])
def test_mixed_ring_replicas_bit_equal(primary):
    """Two ranks, one of each package: rank 0 (``primary``'s package)
    forwards its shard's Adam pushes to rank 1's copy of the other
    package, and rank 1 forwards back; the copies agree bit for bit and
    equal an all-JAX ring's; after rank 0 dies, rank 1 serves shard 0
    from its replica with the same bits."""
    other = "port" if primary == "jax" else "jax"
    mods = [{"jax": jds, "port": tds}[k] for k in (primary, other)]
    rng = np.random.RandomState(7)
    pushes = [(rng.randint(0, 20, 12),
               (rng.standard_normal((12, 4)) * 0.1).astype(np.float32))
              for _ in range(5)]
    out = {}
    for kind, ms in (("mixed", mods), ("jax", [jds, jds])):
        stores, tid, _ = _cluster(JAX, world=2, rows=20, width=4, opt="adam",
                                  lr=0.01, mods=ms)
        try:
            for i, (k, g) in enumerate(pushes):
                stores[i % 2].push(tid, k, g)
            d = _digests(stores[1], tid, 2)
            _replicas_equal(d, range(2))
            table = stores[1].pull(tid, np.arange(20))
            stores[0].server.stop()
            after = stores[1].pull(tid, np.arange(20))    # promoted copy
            out[kind] = (d, table, after, stores[1]._route[0])
        finally:
            _close_all(stores)
    (dm, tm, am, rm), (dj, tj, aj, rj) = out["mixed"], out["jax"]
    assert dm == dj
    assert np.array_equal(tm, tj) and np.array_equal(am, tm)
    assert np.array_equal(aj, tj) and rm == rj == 1


def test_both_fscks_give_one_report():
    """The repo's ``tools/ps_fsck.py`` and the port's read one mixed
    cluster — clean, then with a corrupted backup and a split lineage —
    and return the same report."""
    stores, tid, ports = _cluster(JAX, world=2, rows=16, width=4,
                                  mods=[tds, jds])
    try:
        reps = []
        for corrupt in (False, True):
            if corrupt:
                stores[1].server._stores[0].set_data(
                    tid, np.zeros((8, 4), np.float32))
                stores[0].server._promote(1, 1, want_epoch=1)
            got = [f.fsck(_ends(ports), n_tables=1, replication=2)
                   for f in (jfsck, tfsck)]
            assert got[0] == got[1]
            reps.append(got[1])
        assert reps[0]["ok"] and not reps[1]["ok"]
        assert [m["shard"] for m in reps[1]["mismatches"]] == [0]
        assert reps[1]["serving_ranks"][1] == [0, 1]
    finally:
        _close_all(stores)


# -- the executor's repair tick through two kills -----------------------------

def test_executor_trains_through_two_kills_bit_equal(monkeypatch):
    """bench.py's failover schedule on a tiny embedding model through the
    device cache (CPU slab) over a three-rank replicated store: shard 1's
    primary stopped after step 3, a standby relaunched after step 4 and
    re-replicated by the executor's ``HETU_PS_REREPLICATE_EVERY=1`` tick,
    the promoted ex-backup stopped three steps before the end.  In each
    package the losses are bit-equal to an uninterrupted run's and the
    failovers land in steps 3 and 7; the two packages' losses agree within
    rtol 1e-5 and their fault counters exactly."""
    vocab, dim, batch, steps = 520, 4, 8, 10
    rng = np.random.RandomState(5)
    feeds = [(rng.randint(0, vocab, (batch, 26)),
              rng.randint(0, 2, (batch, 1)).astype(np.float32))
             for _ in range(steps)]
    w0 = (rng.randn(26 * dim, 1) * 0.3).astype(np.float32)

    def train(pkg, chaos):
        ht = tht if pkg is PORT else jht
        stores, tid, ports = _cluster(pkg, rows=vocab, width=dim, lr=0.05)
        extra = []
        try:
            kw = {"slab_device": "cpu"} if pkg is PORT else {}
            cache = pkg.ds.DistCacheTable(stores[0], tid, limit=52,
                                          device=True,
                                          device_scratch=batch * 26, **kw)
            ids = ht.placeholder_op("ids", dtype=np.int64)
            y_ = ht.placeholder_op("y")
            emb = ht.ps_embedding_lookup_op(cache, ids, width=dim)
            prob = ht.sigmoid_op(ht.matmul_op(ht.array_reshape_op(
                emb, (batch, 26 * dim)), ht.Variable("w_fo", value=w0)))
            loss = ht.reduce_mean_op(ht.binarycrossentropy_op(prob, y_),
                                     [0, 1])
            ex = ht.Executor([loss, ht.optim.SGDOptimizer(0.1).minimize(
                loss)], seed=0, **({"device": "cpu"} if pkg is PORT else {}))
            losses, failed_over = [], []
            for step, (i, y) in enumerate(feeds):
                before = pkg.metrics.fault_counts().get(
                    "ps_failover_promoted", 0)
                losses.append(float(np.asarray(ex.run(
                    feed_dict={ids: i, y_: y})[0].asnumpy())))
                if pkg.metrics.fault_counts().get("ps_failover_promoted",
                                                  0) > before:
                    failed_over.append(step)
                if not chaos:
                    continue
                if step == 2:
                    stores[1].server.stop()
                elif step == 3:
                    extra.append(_standby(pkg, 1, 3, ports))
                elif step == 5:
                    d = _digests(stores[0], tid, 3)
                    _replicas_equal(d, range(3))
                elif step == 6:
                    stores[2].server.stop()
            return np.asarray(losses), failed_over
        finally:
            _close_all(stores + extra)

    monkeypatch.setenv("HETU_PS_REREPLICATE_EVERY", "1")

    def scenario(pkg):
        base, none = train(pkg, False)
        pkg.metrics.reset_faults()
        killed, steps_ = train(pkg, True)
        assert np.array_equal(killed, base) and none == []
        return {"losses": killed, "failover_steps": steps_}
    out = run_both((JAX, PORT), scenario, rtol=1e-5)
    assert out["failover_steps"] == [3, 7]
    assert out["faults"]["ps_re_replicated"] >= 2
    assert out["faults"]["ps_failover_promoted"] >= 2

