"""The port's fleet tier (``serving/fleet.py``: ``FrontDoor``,
``SLOAutoscaler``; ``parallel/elastic.py::FlapDamper``), on the CPU over
the 3x4 matmul graph's ``ServingRouter`` replicas, held to the JAX
package.

With paused replicas (``start=False``) one scripted run of submissions,
a kill, polls and scaling goes through both packages' front doors: each
admission lands on the same replica index, each shed or deadline carries
the same ``ServeRejected.reason`` and ``klass``, and the ``fleet`` and
``serve_rejection_reason`` counters are equal; once the survivors start,
every admitted request is answered with the JAX fleet's rows within
``ROW_ATOL`` = 1e-6 absolute.  ``SLOAutoscaler`` fed the same polls makes
the same resize events.  Not held: the JAX package's serve-cache hit on
scale-out (ROADMAP C7 (k): the port compiles nothing)."""
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu import metrics as jmetrics                   # noqa: E402
from hetu_tpu.parallel.elastic import FlapDamper as JFlap  # noqa: E402
import hetu_tpu_torch as ht                                # noqa: E402
from hetu_tpu_torch import metrics                         # noqa: E402
from hetu_tpu_torch.parallel.elastic import FlapDamper     # noqa: E402

ROW_ATOL = 1e-6
W0 = (np.arange(12, dtype=np.float32).reshape(3, 4) * 0.1) - 0.5


@pytest.fixture(autouse=True)
def _reset():
    for m in (metrics, jmetrics):
        m.reset_fleet_counts()
        m.reset_serve_rejection_counts()
    yield


def _door(pkg, n=2, queue_limit=4, max_batch=4, **kw):
    x = pkg.placeholder_op("x_fleet")
    y = pkg.matmul_op(x, pkg.Variable("w_fleet", value=W0.copy()))
    routers = {}

    def mk(idx):
        dev = {"device": "cpu"} if pkg is ht else {}
        iex = pkg.serving.InferenceExecutor([y], buckets=(max_batch,), **dev)
        routers[idx] = pkg.serving.ServingRouter(
            iex, max_batch=max_batch, max_wait_ms=1.0,
            queue_limit=queue_limit, start=False, name=f"fleet{idx}")
        return routers[idx]

    kw.setdefault("health_every_ms", 1e9)
    return pkg.serving.FrontDoor(mk, n, **kw), routers, x


def _script(pkg):
    """Submissions by class and deadline, a kill and a sweep, a scale-out
    and a scale-in; returns (admission trace, futures, counters, routers,
    door)."""
    door, routers, x = _door(pkg, class_deadline_ms={"batch": 5000.0})
    trace, futs = [], []

    def sub(v, klass="interactive", deadline_ms=None):
        before = {i: r.pending for i, r in routers.items()}
        try:
            f = door.submit({x: np.full((3,), v, np.float32)}, klass=klass,
                            deadline_ms=deadline_ms)
        except pkg.ServeRejected as e:
            trace.append(("rejected", e.reason, e.klass))
            return
        grew = [i for i, r in routers.items() if r.pending > before.get(i, 0)]
        trace.append(("admitted", grew))
        futs.append((v, f))

    for v in range(3):
        sub(v)                                   # r0, r1, r0
    sub(3, "best_effort")                        # load 3/8: admitted
    sub(4, "best_effort")                        # load 4/8: shed
    sub(5, "batch")                              # 0.5 < 0.85: admitted
    sub(6, deadline_ms=0.001)                    # the wait cannot meet it
    sub(7, deadline_ms=1000.0)
    sub(8)                                       # 7/8
    sub(9, "batch")                              # shed at 0.875
    sub(10)                                      # the last seat
    sub(11)                                      # queue_full
    routers[0].kill()
    door.poll()                                  # ejected, queue rescued
    trace.append(("stats", [(r["idx"], r["pending"], r["ejected"])
                            for r in door.stats()["replicas"]]))
    sub(12)                                      # the survivor is full
    trace.append(("scale_out", door.scale_out(), door.scale_out()))
    sub(13)                                      # load 8/12
    sub(14, "batch")
    sub(15, "best_effort")                       # shed at 0.75
    trace.append(("scale_in", door.scale_in(timeout=0.1)))  # queue rescued
    trace.append(("n_replicas", door.n_replicas, door.load_factor()))
    counts = (pkg.metrics.fleet_counts(), pkg.metrics.serve_rejection_counts())
    return trace, futs, counts, routers, door


def test_scripted_fleet_makes_the_jax_decisions():
    jtrace, jfuts, jcounts, jrouters, jdoor = _script(jht)
    trace, futs, counts, routers, door = _script(ht)
    assert trace == jtrace
    assert counts == jcounts
    kinds = [t[1] for t in trace if t[0] == "rejected"]
    assert kinds == ["shed:best_effort", "deadline", "shed:batch",
                     "queue_full", "queue_full", "shed:best_effort"]
    assert counts[0]["fleet_replica_ejected"] == 1
    assert counts[0]["fleet_rescued"] == 4 + 1
    assert counts[0]["fleet_scale_in"] == 1
    for rs in (jrouters, routers):
        for r in rs.values():
            r.start()
    want = {v: f.result(timeout=30)[0] for v, f in jfuts}
    got = {v: f.result(timeout=30)[0] for v, f in futs}
    assert sorted(got) == sorted(want)
    for v in got:
        np.testing.assert_allclose(got[v], want[v], rtol=0, atol=ROW_ATOL)
        np.testing.assert_allclose(got[v], np.full(3, v) @ W0, rtol=0,
                                   atol=ROW_ATOL)
    door.close()
    jdoor.close()
    after = metrics.fleet_counts()
    assert after == jmetrics.fleet_counts()
    assert "fleet_request_failures" not in after
    assert after["fleet_drained"] == 1
    assert door.stats()["failures"] == 0
    with pytest.raises(ht.ServeRejected) as ei:
        door.submit({})
    assert ei.value.reason == "draining"


def test_wedged_replica_ejected_then_readmitted():
    """A paused replica with captive work and a stale heartbeat is a
    wedge: ejected and its queue rescued; once its loop runs, the fresh
    heartbeat re-admits it."""
    door, routers, x = _door(ht, wedge_timeout_ms=75.0)
    try:
        futs = [door.submit({x: np.full((3,), i, np.float32)})
                for i in range(4)]
        routers[1].start()
        now = time.monotonic()               # replica 0's heartbeat ages
        with routers[0]._cv:
            routers[0].hb_ts = now - 1.0
        with routers[1]._cv:
            routers[1].hb_ts = now
        door.poll(now=now)
        assert metrics.fleet_counts()["fleet_replica_ejected"] == 1
        assert door.n_replicas == 1
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=30)[0],
                                       np.full(3, i) @ W0, rtol=0,
                                       atol=ROW_ATOL)
        routers[0].start()
        deadline = time.monotonic() + 10.0
        while door.n_replicas < 2 and time.monotonic() < deadline:
            door.poll()
            time.sleep(0.02)
        assert metrics.fleet_counts()["fleet_replica_readmitted"] == 1
    finally:
        door.close()


class _FakeDoor:
    """Duck-typed FrontDoor: scripted p99 and load, counted resizes."""

    def __init__(self, n):
        self.n, self.p99, self.load, self.admitted = n, 0.0, 0.0, 0

    def poll(self, now=None):
        pass

    def p99_ms(self):
        return self.p99

    def load_factor(self):
        return self.load

    @property
    def n_replicas(self):
        return self.n

    def scale_out(self):
        self.n += 1
        return self.n - 1

    def scale_in(self):
        if self.n <= 1:
            return None
        self.n -= 1
        return self.n

    def reset_window(self):
        pass


#: (p99 ms, load) per poll: hot spells, a flap, cold spells
_POLLS = ([(500.0, 0.1)] * 5 + [(5.0, 0.9)] * 2 + [(5.0, 0.0)] * 3
          + [(500.0, 0.0)] + [(5.0, 0.0)] * 6 + [(50.0, 0.3)] * 2)


def test_autoscaler_makes_the_jax_events():
    out = []
    for pkg, m in ((jht, jmetrics), (ht, metrics)):
        door = _FakeDoor(2)
        sc = pkg.serving.SLOAutoscaler(door, p99_target_ms=100.0,
                                       min_replicas=1, max_replicas=4,
                                       grow_grace=2, shrink_grace=3)
        for p99, load in _POLLS:
            door.p99, door.load = p99, load
            door.admitted += 1
            sc.poll()
        out.append((sc.events, door.n, m.fleet_counts()))
    assert out[1] == out[0]
    assert {e["kind"] for e in out[1][0]} == {"scale_out", "scale_in"}
    assert out[1][2]["fleet_scale_refused"] >= 1


def test_flap_damper_matches_jax():
    seq = [True, True, False, True, True, True, True, False, True]
    for grace in (1, 3):
        a, b = FlapDamper(grace), JFlap(grace)
        assert [a.ready("k", ok) for ok in seq] \
            == [b.ready("k", ok) for ok in seq]
        assert a.streak("k") == b.streak("k")
        a.clear()
        assert a.streak("k") == 0


def test_decode_replica_contract_over_the_front_door():
    """DecodeRouter replicas behind the door: a killed replica's queued
    streams are rescued onto the survivor and complete."""
    cfg = ht.GPT2Config.tiny(n_positions=32, batch_size=1)
    feeds, logits, caches, _ = ht.gpt2_decode_graph(cfg, max_len=16)
    routers = {}

    def mk(idx):
        eng = ht.DecodeEngine(feeds, logits, caches, max_slots=2,
                              max_len=16, device="cpu")
        routers[idx] = ht.DecodeRouter(eng, queue_limit=8,
                                       start=(idx != 0), name=f"d{idx}")
        return routers[idx]

    door = ht.FrontDoor(mk, 2, health_every_ms=1e9)
    try:
        streams = [door.submit([3 + i, 5], max_new_tokens=2)
                   for i in range(4)]
        assert routers[0].pending > 0
        routers[0].kill()
        door.poll()
        for s in streams:
            assert len(s.result(timeout=120)) == 2
        assert metrics.fleet_counts()["fleet_rescued"] >= 1
    finally:
        door.close()
