"""Fencing and partition tolerance of the port's replicated parameter
server against the JAX package's, on the CPU: the twins of
``tests/test_partition.py``'s fencing, liveness and fsck cases (its cell
tagging twins are in ``tests/test_torch_ctr_serving.py``; its bench
smoke is not twinned).  Each scenario runs on a two-rank replicated
cluster of each package (server threads in this process, short
timeouts); the two runs agree on every value read back, every lineage
(route, epoch, serving flag) and every fault counter."""
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hetu_tpu import metrics as jmetrics              # noqa: E402
from hetu_tpu.ps import dist_store as jds             # noqa: E402
from hetu_tpu_torch import metrics as tmetrics        # noqa: E402
from hetu_tpu_torch.ps import dist_store as tds       # noqa: E402
from hetu_tpu_torch.tools import ps_fsck as tfsck     # noqa: E402
from tools import ps_fsck as jfsck                    # noqa: E402
from _torch_ps_harness import (close_all as _close_all,  # noqa: E402
                               free_ports as _free_ports, run_both)

JAX = SimpleNamespace(name="jax", ds=jds, metrics=jmetrics, fsck=jfsck)
PORT = SimpleNamespace(name="port", ds=tds, metrics=tmetrics, fsck=tfsck)


def _cluster(pkg, world=2, rows=16, width=4, **kw):
    ports = _free_ports(world)
    ends = [("127.0.0.1", p) for p in ports]
    kw.setdefault("rpc_timeout", 5.0)
    kw.setdefault("rpc_retries", 2)
    kw.setdefault("connect_timeout", 2.0)
    kw.setdefault("replication", 2)
    stores = [pkg.ds.DistributedStore(r, world, ends, port=ports[r], **kw)
              for r in range(world)]
    tid = None
    for s in stores:
        tid = s.init_table(rows, width, opt="sgd", lr=0.1, init_scale=0.0)
    stores[0].set_data(tid, np.random.RandomState(42).normal(
        0, 0.01, (rows, width)).astype(np.float32))
    return stores, tid, ends


def _both(scenario):
    """``scenario`` in both packages: values and fault counters equal."""
    return run_both((JAX, PORT), scenario)


def _lineage(stores, shard):
    return {"route": [list(s._route) for s in stores],
            "epoch": [list(s._epoch) for s in stores],
            "serving": [s.server.serves(shard) for s in stores]}


# -- epoch fencing ------------------------------------------------------------

def test_old_epoch_push_refused_and_counted_without_mutation():
    """An old-epoch OP_PUSH against a promoted copy is refused, counted
    and applies nothing; the same (client, seq) retried at the right
    epoch still applies, once."""
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            assert stores[0]._failover(0) == 1
            key = np.asarray([0], np.int64)
            before = stores[0].pull(tid, key)[0].copy()
            g = np.ones((1, 4), np.float32)
            seq = next(stores[0]._seq)
            with pytest.raises(RuntimeError, match="epoch_fence cur=1"):
                stores[0]._rpc(1, pkg.ds.OP_PUSH, tid, key, g.tobytes(), 0.1,
                               4, shard=0, seq=seq, epoch=0)
            unchanged = stores[0].pull(tid, key)[0]
            np.testing.assert_array_equal(unchanged, before)
            stores[0]._rpc(1, pkg.ds.OP_PUSH, tid, key, g.tobytes(), 0.1, 4,
                           shard=0, seq=seq, epoch=1)
            after = stores[0].pull(tid, key)[0]
            np.testing.assert_allclose(after, before - 0.1)
            return {"after": after, **_lineage(stores, 0)}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["faults"].get("ps_epoch_refused") == 1
    assert out["faults"].get("ps_epoch_bumps") == 1


def test_old_epoch_replicate_frame_refused_without_mutation():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            stores[0]._failover(0)
            key = np.asarray([0], np.int64)
            before = stores[0].pull(tid, key)[0].copy()
            inner = pkg.ds._HDR.pack(pkg.ds.OP_PUSH, tid, 1, 0.1, 4, 99,
                                     time.time_ns(), 0, 0) \
                + key.tobytes() + np.ones((1, 4), np.float32).tobytes()
            with pytest.raises(RuntimeError, match="epoch_fence cur=1"):
                stores[0]._rpc(1, pkg.ds.OP_REPLICATE, 0,
                               np.asarray([0], np.int64), payload=inner,
                               epoch=0)
            after = stores[0].pull(tid, key)[0]
            np.testing.assert_array_equal(after, before)
            return {"after": after}
        finally:
            _close_all(stores)
    assert _both(scenario)["faults"].get("ps_epoch_refused") == 1


def test_stale_ex_primary_demotes_and_stale_client_reroutes():
    """Rank 1 is promoted for shard 0 while rank 0 still serves it; a
    stale client's push through rank 0 is applied there, refused by rank
    1's fence on the forward, rank 0 demotes itself, and the client
    re-routes: the write lands on the surviving lineage once."""
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            stores[0]._failover(0)
            key = np.asarray([0], np.int64)
            before = stores[0].pull(tid, key)[0].copy()
            stores[1].push(tid, key, np.ones((1, 4), np.float32))
            after = stores[0].pull(tid, key)[0]
            np.testing.assert_allclose(after, before - 0.1)
            return {"after": after, **_lineage(stores, 0),
                    "epochs": [stores[1].shard_epoch(0),
                               stores[1].shard_epoch(0, rank=0)]}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["faults"].get("ps_demotions") == 1
    assert out["serving"] == [False, True]
    assert out["route"][1][0] == 1 and out["epoch"][1][0] == 1
    assert out["epochs"] == [(1, True), (1, False)]


def test_demoted_copy_needs_sync_before_promotion():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            stores[0]._failover(0)
            key = np.asarray([0], np.int64)
            stores[1].push(tid, key, np.ones((1, 4), np.float32))
            assert not stores[0].server.serves(0)
            with pytest.raises(RuntimeError, match="not promotable|never"):
                stores[1]._rpc(0, pkg.ds.OP_PROMOTE, 0,
                               np.asarray([0, 1, 2], np.int64))
            stores[1].re_replicate(0)
            a = stores[1].table_checksum(tid, 0, rank=0)
            assert a == stores[1].table_checksum(tid, 0, rank=1)
            expected = stores[1].pull(tid, key)[0].copy()
            stores[1].server.stop()
            got = stores[0].pull(tid, key)[0]
            np.testing.assert_array_equal(got, expected)
            return {"digest": a, "got": got,
                    "route": list(stores[0]._route),
                    "epoch": list(stores[0]._epoch),
                    "lineage": stores[0].shard_epoch(0, rank=0)}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["route"][0] == 0 and out["epoch"][0] == 2
    assert out["lineage"] == (2, True)


def test_broken_forward_primary_probes_lineage_and_demotes(monkeypatch):
    monkeypatch.setenv("HETU_PS_FENCE_PROBE_S", "0")

    def scenario(pkg):
        stores, tid, _ = _cluster(pkg)
        try:
            stores[0].server._fwd_ok[0] = False
            stores[0]._failover(0)
            key = np.asarray([0], np.int64)
            surviving = stores[0].pull(tid, key)[0].copy()
            stores[1].push(tid, key, np.ones((1, 4), np.float32))
            after = stores[0].pull(tid, key)[0]
            np.testing.assert_allclose(after, surviving - 0.1)
            return {"after": after, **_lineage(stores, 0)}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["serving"] == [False, True]
    assert out["faults"].get("ps_demotions") == 1


# -- liveness vs partition ----------------------------------------------------

def test_liveness_report_distinguishes_unreachable_from_dead():
    def scenario(pkg):
        stores, tid, _ = _cluster(pkg, replication=1)
        try:
            stores[0].heartbeat(rank=0)
            stores[0].heartbeat(rank=1)
            time.sleep(0.35)
            stores[0].heartbeat(rank=0)       # rank 1 goes silent
            first = stores[0].liveness_report(250)
            stores[1].server.stop()           # now it is really dead
            return {"first": first,
                    "second": stores[0].liveness_report(250)}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["first"] == {"alive": [0], "dead": [], "unreachable": [1]}
    assert out["second"] == {"alive": [0], "dead": [1], "unreachable": []}
    assert out["faults"].get("ps_unreachable") == 1


# -- fsck: retries and the lineage check --------------------------------------

def test_fsck_retries_clear_transient_but_keep_stable_divergence():
    def scenario(pkg):
        stores, tid, ends = _cluster(pkg)
        try:
            lied = []

            def flaky(endpoint, shard, table, timeout=10.0):
                if not lied:                # a frame "in flight" once
                    lied.append(1)
                    return "ok", "transient-bogus-digest"
                return pkg.fsck.checksum(endpoint, shard, table,
                                         timeout=timeout)

            rep = pkg.fsck.fsck(ends, n_tables=1, replication=2, retries=2,
                                retry_wait=0.01, probe=flaky)
            assert rep["ok"], rep
            first = (rep["retries_used"], rep["transient_cleared"])
            stores[1].server._stores[0].set_data(
                tid, np.zeros((8, 4), np.float32))
            rep = pkg.fsck.fsck(ends, n_tables=1, replication=2, retries=2,
                                retry_wait=0.01)
            assert not rep["ok"]
            return {"first": first, "retries": rep["retries_used"],
                    "shards": [m["shard"] for m in rep["mismatches"]]}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["first"] == (1, 1) and out["retries"] == 2
    assert out["shards"] == [0]


def test_fsck_reports_epochs_and_flags_split_brain():
    def scenario(pkg):
        stores, tid, ends = _cluster(pkg)
        try:
            rep = pkg.fsck.fsck(ends, n_tables=1, replication=2)
            assert rep["ok"]
            clean = (rep["serving_ranks"], rep["epochs"][0][0])
            stores[1].server._promote(0, 1, want_epoch=1)
            rep = pkg.fsck.fsck(ends, n_tables=1, replication=2)
            assert not rep["ok"] and not rep["mismatches"]
            arg = ",".join(f"{h}:{p}" for h, p in ends)
            code = pkg.fsck.main(["--endpoints", arg, "--tables", "1",
                                  "--verify"])
            return {"clean": clean, "split": rep["serving_ranks"][0],
                    "violations": rep["lineage_violations"], "code": code}
        finally:
            _close_all(stores)
    out = _both(scenario)
    assert out["clean"] == ({0: [0], 1: [1]},
                            {"status": "ok", "epoch": 0, "serving": True,
                             "error": None})
    assert out["split"] == [0, 1] and out["code"] == 1
    assert out["violations"][0]["shard"] == 0
