"""Exactly-once recovery of in-flight decode streams in the port
(``DecodeStream``'s journal and epochs, ``_continuation``,
``DecodeRouter``'s replica contract, ``FrontDoor``'s rescue), on the CPU
at tiny size, held to the JAX package.

The routers are built paused and driven one loop pass at a time on the
test thread (``_torch_decode_harness.tick``), so one schedule runs the
same in both packages: the streams, the ``decode_recovery``, ``fleet``
and ``prefix_cache`` counters and the partial tokens of a failed
recovery are compared exactly.  Every recovered stream equals the JAX
package's unkilled stream token for token, and the smallest top-1 /
top-2 logit gap over the streams is checked above ``GAP_MIN`` = 1e-4
(ROADMAP C7 (l)).  One test runs the routers' own threads."""
import threading
import time

import numpy as np
import pytest

import _torch_decode_harness as H


@pytest.fixture(scope="module")
def pair():
    return H.build_pair()


@pytest.fixture(autouse=True)
def _reset(pair):
    for p in pair:
        p.reset()
    yield


_REF = {}


def reference(pair, prompt, max_new):
    """The JAX package's unkilled stream (one-token engine, batch 1), and
    the port's logit gap over the same tokens."""
    key = (tuple(prompt), max_new)
    if key not in _REF:
        jax_side, port = pair
        want = H.run(jax_side.engine(chunked=False, max_slots=1),
                     jax_side.request(prompt, max_new))
        toks, gap = H.greedy_with_gap(port, prompt, max_new)
        assert toks == want
        _REF[key] = (want, gap)
    return _REF[key]


# ------------------------------------------------ journal and epoch fence

def _fence_script(pkg):
    s = pkg.decode.DecodeStream(prompt_len=2, max_new_tokens=4)
    fired = H.watch_fires(s, 4)
    out = [s._emit(7, epoch=0), s._emit(8, epoch=0), s._detach(),
           s._emit(99, epoch=0), s._finish(epoch=0),
           s._fail(RuntimeError("stale"), epoch=0), s.partial(), s.done,
           s._emit(9, epoch=1), s._emit(10, epoch=1), s._finish(epoch=1),
           s.result(timeout=5), s.epoch]
    return out, fired


def test_stream_epoch_fencing_is_exactly_once(pair):
    """``_detach`` bumps the epoch with the journal snapshot; a late
    ``_emit`` / ``_finish`` / ``_fail`` under the old epoch returns False
    and changes nothing; each token future fires once.  The same script
    returns the same values in both packages."""
    jax_side, port = pair
    want, _ = _fence_script(jax_side)
    got, fired = _fence_script(port)
    assert got == want
    assert got[2] == (1, [7, 8]) and got[3] is False and got[11] == [7, 8,
                                                                     9, 10]
    assert fired == [1, 1, 1, 1]


def test_continuation_carries_journal_deadline_and_retry(pair):
    for pkg in pair:
        req = pkg.request([3, 5, 11], 6, deadline=12345.0)
        req.stream._emit(7, epoch=0)
        req.stream._emit(8, epoch=0)
        cont = pkg.decode._continuation(req)
        assert cont.prompt.tolist() == [3, 5, 11, 7, 8]
        assert (cont.max_new, cont.eos_id, cont.deadline) == (4, None, 12345.0)
        assert cont.stream is req.stream and cont.t_arrival == req.t_arrival
        assert cont.epoch == req.stream.epoch == 1
        assert cont.retries == 1 and cont.detached_ts is not None
        cont2 = pkg.decode._continuation(cont)
        assert cont2.retries == 2
        assert cont2.prompt.tolist() == [3, 5, 11, 7, 8]
    assert pair[1].counts()["decode_recovery"] \
        == pair[0].counts()["decode_recovery"] \
        == {"decode_recovery_detached": 2, "decode_recovery_retries": 1}


# ---------------------------------------------------- the crowded kill

_BASE = [5, 3, 9, 2]
_PROMPTS = [_BASE + [7], _BASE + [11], [2, 4, 6, 8, 1], [13, 1, 5],
            _BASE + [6, 6]]
_MAX_NEW = 8


def _crowded_kill(pkg):
    """Five streams over two chunked replicas sharing one prefix store;
    replica 1 killed once every stream holds two tokens; the sweep
    rescues its seated streams onto replica 0; the dead engine then wakes
    for one step (its emissions fenced); replica 0 finishes everything."""
    store = pkg.store()
    door, routers = pkg.fleet(2, store=store)
    streams = [door.submit(p, max_new_tokens=_MAX_NEW) for p in _PROMPTS]
    fired = [H.watch_fires(s, _MAX_NEW) for s in streams]
    while not all(s.n_tokens >= 2 for s in streams):
        H.tick(routers[0])
        H.tick(routers[1])
    seated = routers[1].health()["inflight"]
    routers[1].kill()
    door.poll()
    assert routers[1].engine.step() == 0        # the late, fenced step
    while not all(s.done for s in streams):
        assert H.tick(routers[0])
    out = [s.result(timeout=5) for s in streams]
    counts = pkg.counts()
    door.close()
    return out, fired, seated, counts


def test_crowded_kill_matches_the_unkilled_jax_stream(pair):
    jax_side, port = pair
    want, _, jseated, jcounts = _crowded_kill(jax_side)
    got, fired, seated, counts = _crowded_kill(port)
    refs = [reference(pair, p, _MAX_NEW) for p in _PROMPTS]
    assert got == want == [r for r, _ in refs]
    assert min(g for _, g in refs) > H.GAP_MIN
    assert all(f == [1] * _MAX_NEW for f in fired)
    assert seated == jseated == 2
    for fam in ("decode_recovery", "fleet", "prefix_cache"):
        assert counts[fam] == jcounts[fam], fam
    rec = counts["decode_recovery"]
    assert rec["decode_recovery_detached"] == rec["decode_recovery_reseated"] \
        == 2
    assert rec["decode_recovery_prefix_assisted"] > 0
    assert rec["decode_recovery_fenced"] == 2
    assert counts["fleet"]["fleet_replica_ejected"] == 1
    assert "fleet_request_failures" not in counts["fleet"]


# ----------------------------------------------- gated failure surfaces

def _exhausted(pkg, case):
    n, budget = (2, 0) if case == "budget" else (1, 2)
    door, routers = pkg.fleet(n, chunked=False, recovery_budget=budget)
    s = door.submit([3, 5, 9], max_new_tokens=10)
    while s.n_tokens < 3:
        H.tick(routers[0])
    routers[0].kill()
    door.poll()
    exc = s._final.exception(timeout=5)
    out = (exc.reason, exc.partial, s.partial(), str(exc),
           pkg.counts()["decode_recovery"], door.stats()["failures"])
    door.close()
    return out


@pytest.mark.parametrize("case", ["budget", "no_survivor"])
def test_recovery_exhausted_carries_partial(pair, case):
    """``recovery_budget=0`` (the first recovery is over budget) and a
    kill of the only replica: the stream fails fast with
    ``recovery_exhausted``, its ``partial`` the tokens already delivered,
    the same in both packages."""
    jax_side, port = pair
    want = _exhausted(jax_side, case)
    got = _exhausted(port, case)
    assert got[0] == "recovery_exhausted"
    assert got[1] == got[2] == want[1] and len(got[1]) == 3
    assert ("retry budget" if case == "budget" else "no survivor") in got[3]
    assert got[4] == want[4] == {"decode_recovery_detached": 1,
                                 "decode_recovery_exhausted": 1}
    assert got[5] == want[5] == 1
    assert port.metrics.serve_rejection_counts()["recovery_exhausted"] == 1


def test_wedge_sweep_sees_seated_work_that_is_not_queued(pair):
    """A replica whose whole batch is seated (its queue empty) and whose
    heartbeat is stale is ejected by the sweep, and its stream finishes
    on the survivor as the unkilled run."""
    jax_side, port = pair
    prompt, max_new = [3, 5, 9], 8
    outs = []
    for pkg in pair:
        door, routers = pkg.fleet(2, chunked=False, wedge_timeout_ms=75.0)
        s = door.submit(prompt, max_new_tokens=max_new)
        H.tick(routers[0])
        snap = routers[0].health()
        assert snap["queued"] == 0 and snap["pending"] == 1
        # replica 0's heartbeat goes stale; replica 1's loop beats
        now = time.monotonic()
        with routers[0]._cv:
            routers[0].hb_ts = now - 1.0
        with routers[1]._cv:
            routers[1].hb_ts = now
        door.poll(now=now)
        assert pkg.metrics.fleet_counts()["fleet_replica_ejected"] == 1
        assert routers[1].health()["queued"] == 1
        while not s.done:
            assert H.tick(routers[1])
        outs.append((s.result(), pkg.counts()["decode_recovery"]))
        door.close()
    assert outs[1] == outs[0]
    assert outs[1][0] == reference(pair, prompt, max_new)[0]


# ------------------------------------------------ the routers' own threads

def test_threaded_kill_mid_generation(pair):
    """The routers' loop threads: replica 1's engine is held at a step
    boundary once its streams hold two tokens, killed and swept there,
    then let go: its late step is fenced, and every stream finishes on
    replica 0 as the unkilled run, each token future firing once."""
    _, port = pair
    prompts = [[3, 5, 9], [4, 1, 2], [6, 6, 1], [7, 2, 2]]
    max_new = 8
    door, routers = port.fleet(2, chunked=False)
    release, holding, watch = threading.Event(), threading.Event(), []
    step = routers[1].engine.step

    def held_step():
        if watch and all(s.n_tokens >= 2 for s in watch) \
                and not release.is_set():
            holding.set()
            release.wait(timeout=60)
        return step()

    routers[1].engine.step = held_step
    try:
        streams = [door.submit(p, max_new_tokens=max_new) for p in prompts]
        fired = [H.watch_fires(s, max_new) for s in streams]
        watch.extend([streams[1], streams[3]])   # dispatched to replica 1
        for r in routers.values():
            r.start()
        assert holding.wait(timeout=60)         # replica 1 is mid-step
        routers[1].kill()
        door.poll()
        release.set()
        deadline = time.monotonic() + 60
        while not all(s.done for s in streams) \
                and time.monotonic() < deadline:
            door.poll()
            time.sleep(0.01)
        assert [s.result(timeout=5) for s in streams] \
            == [reference(pair, p, max_new)[0] for p in prompts]
        assert all(f == [1] * max_new for f in fired)
        rec = port.metrics.decode_recovery_counts()
        assert rec["decode_recovery_reseated"] == 2
    finally:
        release.set()
        door.close()
    assert port.metrics.decode_recovery_counts()["decode_recovery_fenced"] == 2
    assert min(reference(pair, p, max_new)[1] for p in prompts) > H.GAP_MIN


# ------------------------------------------------ request-level mode, plans

def _request_level(pkg):
    eng = pkg.engine(chunked=False)
    r = pkg.serving.DecodeRouter(eng, continuous=False, max_wait_ms=0.0,
                                 start=False)
    a = r.submit([3, 5], max_new_tokens=3)
    b = r.submit([4, 1, 2], max_new_tokens=2)
    H.tick(r)
    c = r.submit([6, 6], max_new_tokens=2)
    trace = []
    while H.tick(r):
        trace.append((r.queue_depth, eng.active))
    out = ([s.result(timeout=5) for s in (a, b, c)], trace,
           pkg.counts()["run_plan"])
    r.close()
    return out


def test_request_level_mode_joins_only_an_empty_engine(pair):
    """``continuous=False``: a request queued while the batch runs waits
    until the engine is empty, the same step for step in both packages;
    the keyed plan cache counts the same hits and misses (one miss a
    bucket key)."""
    jax_side, port = pair
    want = _request_level(jax_side)
    got = _request_level(port)
    assert got == want
    trace = got[1]
    first_join = next(i for i, (q, _) in enumerate(trace) if q == 0)
    assert sum(a > 0 for _, a in trace[:first_join]) >= 2  # waited, busy
    assert trace[first_join - 1] == (1, 0) and trace[first_join][1] == 1
    plans = got[2]
    assert plans["plan_cache_miss"] >= 2 and plans["plan_cache_hit"] > 0


def test_adopt_into_a_stopped_router_is_refused(pair):
    _, port = pair
    r = port.serving.DecodeRouter(port.engine(chunked=False), start=False)
    r.kill()
    with pytest.raises(port.serving.ServeRejected) as ei:
        r.adopt([port.request([1, 2], 2)])
    assert ei.value.reason == "draining"
    with pytest.raises(port.serving.ServeRejected):
        r.submit([1, 2])
    assert r.adopt([]) == 0
    assert np.isfinite(r.health()["hb_ts"])
