"""The port's chaos injector (``hetu_tpu_torch/chaos.py``) and its hooks on
the PS path against the JAX package's, on the CPU: the twins of
``tests/test_chaos.py``'s parser, injector, transport, role-kill,
proc-kill, replica-clock, partition and ``kill:ps`` cases.  Each
scenario runs once in each package (stores as server threads in this
process) and the two runs agree: the decision sequences, the returned
victims and every fault counter, exactly — one seeded schedule gives
both packages one fault order.  The executor's ``on_step`` hook fires
after the auto-save, and the ``kill:ps`` acceptance run finishes through
retry and resume with the clean run's losses in each package."""
import glob
import os
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu as jht                                # noqa: E402
from hetu_tpu import chaos as jchaos                  # noqa: E402
from hetu_tpu import metrics as jmetrics              # noqa: E402
from hetu_tpu.ps import dist_store as jds             # noqa: E402
import hetu_tpu_torch as tht                          # noqa: E402
from hetu_tpu_torch import chaos as tchaos            # noqa: E402
from hetu_tpu_torch import metrics as tmetrics        # noqa: E402
from hetu_tpu_torch.ps import dist_store as tds       # noqa: E402
from _torch_ps_harness import (close_all, ends,       # noqa: E402
                               free_ports, run_both)

JAX = SimpleNamespace(name="jax", ht=jht, chaos=jchaos, metrics=jmetrics,
                      ds=jds, ex_kw={})
PORT = SimpleNamespace(name="port", ht=tht, chaos=tchaos, metrics=tmetrics,
                       ds=tds, ex_kw={"device": "cpu"})
BOTH = (JAX, PORT)
FAST = dict(rpc_timeout=5.0, rpc_retries=2, connect_timeout=2.0)

#: every fault form of the grammar, each parsed alike by both packages
GOOD_SPECS = (
    "1234:drop=0.1,delay=0.2:50,dup=0.05,wedge=0.01:2000",
    "7:kill:ps@rank1:step3", "7:kill:proc@rank0:after250",
    "7:kill:proc@rank2:step5", "7:kill:primary@shard1:step3",
    "7:kill:backup@shard1:step3", "7:kill:primary@shard1:req200",
    "7:kill:backup@shard0:req9", "7:kill:replica@1:req40",
    "7:kill:replica@0:tok16", "7:partition:rank0|rank1@step3:heal7",
    "7:partition:rank0+rank1|rank2+rank3@step3",
    "7:drop=0.1,partition:rank0|rank1@step2:heal4,kill:ps@rank1:step9",
    "7:kill:replica@1:req3,kill:replica@0:tok5")
#: malformed schedules: loud in both packages
BAD_SPECS = (
    "drop=0.5", "7:", "7:flip=0.5", "7:drop=1.5", "7:delay=0.5",
    "7:kill:ps@rank1", "7:kill:primary@rank1:step3", "7:kill:backup@shard1",
    "x:drop=0.5", "7:kill:proc@rank2:when5", "7:kill:replica@1:step40",
    "7:partition:rank0|rank1", "7:partition:rank0@step3",
    "7:partition:rank0|rank0@step3", "7:partition:rank0+rank1|rank1@step3",
    "7:partition:|rank1@step3", "7:partition:rank0|rank1@step3:heal2",
    "7:partition:rank0|rank1@step3:heal3", "7:partition:rankX|rank1@step3",
    "7:partition:rank0|rank1@stepX", "7:partition:rank0|rank1@req3",
    "7:partition:rank0|rank1@step3:cure7")


@pytest.fixture(autouse=True)
def _clean():
    for pkg in BOTH:
        pkg.chaos.uninstall()
        pkg.metrics.reset_faults()
    yield
    for pkg in BOTH:
        pkg.chaos.uninstall()
        pkg.metrics.reset_faults()


class _Handle:
    def __init__(self):
        self.stopped = 0

    def stop(self):
        self.stopped += 1


# -- the parser ---------------------------------------------------------------

@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_every_spec_form_parses_as_in_jax(spec):
    assert tchaos.parse_spec(spec) == jchaos.parse_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_specs_are_loud_in_both(spec):
    for pkg in BOTH:
        with pytest.raises(pkg.chaos.ChaosSpecError):
            pkg.chaos.parse_spec(spec)
    assert issubclass(tchaos.ChaosSpecError, ValueError)


# -- the injector -------------------------------------------------------------

def test_same_seed_gives_the_jax_fault_sequence():
    """One seed, one event order: the JAX injector's decisions, frame
    for frame; another seed another sequence."""
    spec = "123:drop=0.3,delay=0.2:15,dup=0.1,wedge=0.05:50"

    def scenario(pkg):
        inj = pkg.chaos.ChaosInjector.from_spec(spec)
        seq = [inj.on_send(i % 4, 1) for i in range(300)]
        other = pkg.chaos.ChaosInjector.from_spec(
            "124" + spec[3:])
        assert [other.on_send(i % 4, 1) for i in range(300)] != seq
        return {"seq": seq, "log": inj.decisions}
    out = run_both(BOTH, scenario)
    assert any(x is None for x in out["seq"])
    assert any(x is not None for x in out["seq"])


def test_proc_step_kill_fires_once_and_draws_nothing():
    spec = "11:drop=0.2,kill:proc@rank1:step3"

    def scenario(pkg):
        inj = pkg.chaos.ChaosInjector.from_spec(spec)
        procs = {r: _Handle() for r in range(2)}
        for r, p in procs.items():
            inj.register_proc(r, p)
        fired = [inj.due_proc_kills(1e9), inj.on_step(2), inj.on_step(3),
                 inj.on_step(3)]
        a = pkg.chaos.ChaosInjector.from_spec(spec)
        b = pkg.chaos.ChaosInjector.from_spec("11:drop=0.2")
        a.register_proc(1, _Handle())
        seq = []
        for i in range(100):
            if i == 50:
                a.on_step(3)
            seq.append(a.on_send(i % 3, 1))
        assert seq == [b.on_send(i % 3, 1) for i in range(100)]
        return {"fired": fired, "stopped": [procs[0].stopped,
                                            procs[1].stopped], "seq": seq}
    out = run_both(BOTH, scenario)
    assert out["fired"] == [[], [], [1], []]
    assert out["faults"]["chaos_kill_proc"] == 2


def test_kills_with_no_target_are_loud_and_quiet_elsewhere():
    """No handle registered at all: a warning and
    ``chaos_kill_target_missing``; another rank's handle registered: the
    target lives in another process, quiet."""
    def scenario(pkg):
        out = {}
        for spec, clock, fire in (
                ("7:kill:proc@rank1:step2", "proc", lambda i: i.on_step(2)),
                ("7:kill:ps@rank1:step2", "server",
                 lambda i: i.on_step(2)),
                ("7:kill:replica@1:req2", "replica",
                 lambda i: i.on_request(2)),
                ("7:kill:replica@1:tok2", "replica",
                 lambda i: i.on_token(1, 2))):
            inj = pkg.chaos.ChaosInjector.from_spec(spec)
            with pytest.warns(RuntimeWarning, match=spec[2:]):
                out[spec, "loud"] = fire(inj)
            quiet = pkg.chaos.ChaosInjector.from_spec(spec)
            getattr(quiet, "register_" + clock)(0, _Handle())
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                out[spec, "quiet"] = fire(quiet)
        return {"fired": sorted(out.items())}
    out = run_both(BOTH, scenario)
    assert out["faults"] == {"chaos_kill_target_missing": 4}


def test_replica_kills_fire_once_on_their_clocks():
    def scenario(pkg):
        got = {}
        for spec, fire in (("11:drop=0.2,kill:replica@1:req5",
                            lambda i, n: i.on_request(n)),
                           ("11:drop=0.2,kill:replica@1:tok5",
                            lambda i, n: i.on_token(1, n))):
            inj = pkg.chaos.ChaosInjector.from_spec(spec)
            reps = {i: _Handle() for i in range(2)}
            for i, h in reps.items():
                inj.register_replica(i, h)
            got[spec] = [fire(inj, 4), fire(inj, 5), fire(inj, 6),
                         reps[0].stopped, reps[1].stopped]
        inj = pkg.chaos.ChaosInjector.from_spec("7:kill:replica@1:tok5")
        inj.register_replica(1, _Handle())
        got["other replica's clock"] = inj.on_token(0, 9)
        return got
    out = run_both(BOTH, scenario)
    assert out["11:drop=0.2,kill:replica@1:req5"] == [[], [1], [], 0, 1]
    assert out["faults"] == {"chaos_kill_replica": 2}


def test_role_kills_resolve_the_live_route():
    """``kill:backup`` stops the shard's non-serving holder,
    ``kill:primary`` whoever serves it at fire time."""
    def scenario(pkg):
        ports = free_ports(2)
        stores = [pkg.ds.DistributedStore(r, 2, ends(ports), port=ports[r],
                                          replication=2, **FAST)
                  for r in range(2)]
        try:
            inj = pkg.chaos.ChaosInjector.from_spec(
                "7:kill:backup@shard0:step1,kill:primary@shard0:step2")
            for r, s in enumerate(stores):
                inj.register_server(r, s.server)
            for s in stores:
                s.init_table(8, 4, opt="sgd", lr=1.0, init_scale=0)
            first = inj.on_step(1)
            stopped = [bool(s.server._stop) for s in stores]
            return {"first": first, "stopped": stopped,
                    "second": inj.on_step(2)}
        finally:
            close_all(stores)
    out = run_both(BOTH, scenario)
    assert out["first"] == [1] and out["second"] == [0]
    assert out["stopped"] == [False, True]
    assert out["faults"] == {"chaos_kill_backup": 1, "chaos_kill_primary": 1}


def test_partitions_draw_nothing_and_heal_apart_from_kills():
    def scenario(pkg):
        with_p = pkg.chaos.ChaosInjector.from_spec(
            "123:drop=0.3,partition:rank0|rank1@step1:heal3")
        without = pkg.chaos.ChaosInjector.from_spec("123:drop=0.3")
        before = [with_p.on_send(1, 1, src=0) for _ in range(60)]
        assert before == [without.on_send(1, 1, src=0) for _ in range(60)]
        with_p.on_step(1)
        during = [with_p.on_send(1, 1, src=0) for _ in range(40)]
        for _ in range(40):
            without.on_send(1, 1, src=0)
        with_p.on_step(3)
        after = [with_p.on_send(1, 1, src=0) for _ in range(60)]
        assert after == [without.on_send(1, 1, src=0) for _ in range(60)]
        inj = pkg.chaos.ChaosInjector.from_spec(
            "7:partition:rank0|rank1@step2:heal4,kill:ps@rank5:step2")
        seq = [inj.on_send(1, 1, src=0)]
        with pytest.warns(RuntimeWarning, match="no registered kill"):
            inj.on_step(2)
        seq += [inj.on_send(1, 1, src=0), inj.on_send(0, 1, src=1),
                inj.on_send(2, 1, src=0), inj.on_send(1, 1)]
        inj.on_step(3)
        seq.append(inj.on_send(1, 1, src=0))
        inj.on_step(4)
        seq.append(inj.on_send(1, 1, src=0))
        inj.on_step(2)                  # a replayed step re-fires nothing
        seq.append(inj.on_send(1, 1, src=0))
        return {"before": before, "during": during, "after": after,
                "seq": seq}
    out = run_both(BOTH, scenario)
    assert all(a == ("drop", 0.0) for a in out["during"])
    d = ("drop", 0.0)
    assert out["seq"] == [None, d, d, None, None, d, None, None]
    assert out["faults"]["chaos_kill_target_missing"] == 1


def test_install_from_env(monkeypatch):
    monkeypatch.setenv("HETU_CHAOS", "9:drop=0.25")
    inj = tchaos.install_from_env()
    assert inj is not None and tchaos.active() is inj and inj.seed == 9
    assert tchaos.uninstall() is inj and tchaos.active() is None
    monkeypatch.delenv("HETU_CHAOS")
    assert tchaos.ChaosInjector.from_env() is None
    assert tchaos.install_from_env() is None


# -- the hooks on the PS transport --------------------------------------------

def _pair(pkg, ports, **kw):
    """``tests/test_chaos.py``'s store pair: a 32x8 table, key k on rank
    k % 2."""
    for k, v in FAST.items():
        kw.setdefault(k, v)
    stores = [pkg.ds.DistributedStore(r, 2, ends(ports), port=ports[r],
                                      **kw) for r in range(2)]
    table = np.random.RandomState(42).normal(
        0, 0.01, (32, 8)).astype(np.float32)
    tids = [s.init_table(32, 8, opt="sgd", lr=0.1, init_scale=0.0)
            for s in stores]
    for r, s in enumerate(stores):
        s.local.set_data(tids[r], table[np.arange(16) * 2 + r])
    return stores, tids[0]


def test_partition_blocks_then_heals_the_transport():
    def scenario(pkg):
        stores, tid = _pair(pkg, free_ports(2))
        inj = pkg.chaos.ChaosInjector.from_spec(
            "9:partition:rank0|rank1@step1:heal2")
        pkg.chaos.install(inj)
        try:
            key = np.asarray([1], np.int64)
            before = stores[0].pull(tid, key)
            inj.on_step(1)
            with pytest.raises(RuntimeError, match="unreachable"):
                stores[0].pull(tid, key)
            inj.on_step(2)
            after = stores[0].pull(tid, key)
            assert np.array_equal(after, before)
            return {"rows": after}
        finally:
            pkg.chaos.uninstall()
            close_all(stores)
    out = run_both(BOTH, scenario)
    assert out["faults"]["partition_frames_dropped"] == 2


def test_dup_frames_apply_once():
    def scenario(pkg):
        pkg.chaos.install(pkg.chaos.ChaosInjector.from_spec("5:dup=1.0"))
        store = pkg.ds.DistributedStore(0, 1)
        try:
            store.ssp_init(1)
            store.clock()
            return {"clocks": store.clocks()}
        finally:
            pkg.chaos.uninstall()
            store.close()
    out = run_both(BOTH, scenario)
    assert out["clocks"].tolist() == [1]
    assert out["faults"]["chaos_dup"] == 3


def test_drops_exhaust_the_retries_with_the_jax_counters():
    def scenario(pkg):
        store = pkg.ds.DistributedStore(0, 1, rpc_retries=2)
        store.ssp_init(1)
        pkg.chaos.install(pkg.chaos.ChaosInjector.from_spec("5:drop=1.0"))
        try:
            with pytest.raises(RuntimeError, match="unreachable"):
                store.clock()
            return {}
        finally:
            pkg.chaos.uninstall()
            store.close()
    out = run_both(BOTH, scenario)
    assert out["faults"] == {"chaos_drop": 2, "ps_rpc_retry": 1,
                             "ps_peer_unreachable": 1}


def test_dropped_frames_are_retried_to_the_same_result():
    def scenario(pkg):
        pkg.chaos.install(pkg.chaos.ChaosInjector.from_spec("21:drop=0.4"))
        store = pkg.ds.DistributedStore(0, 1, rpc_retries=8)
        try:
            store.ssp_init(1)
            for _ in range(10):
                store.clock()
            pkg.chaos.uninstall()
            return {"clocks": store.clocks()}
        finally:
            pkg.chaos.uninstall()
            store.close()
    out = run_both(BOTH, scenario)
    assert out["clocks"].tolist() == [10]
    assert out["faults"]["chaos_drop"] >= 1


# -- the executor's step hook: kill:ps mid-training, retry and resume ---------

def _ps_executor(pkg, store, tid, **kw):
    ht = pkg.ht
    rng = np.random.RandomState(1)
    ids = ht.placeholder_op("ids")
    y_ = ht.placeholder_op("y")
    h = ht.ps_embedding_lookup_op((store, tid), ids, width=8)
    w = ht.Variable("w", value=rng.randn(8, 2).astype(np.float32) * 0.3)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(h, w), y_), [0])
    ex = ht.Executor(
        {"train": [loss, ht.optim.AdamOptimizer(0.01).minimize(loss)]},
        seed=0, **pkg.ex_kw, **kw)
    return ex, ids, y_


def _feeds(n):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 32, 16),
             np.eye(2, dtype=np.float32)[rng.randint(0, 2, 16)])
            for _ in range(n)]


def _close_ex(ex):
    if isinstance(ex, tht.Executor):
        ex.close()


def test_kill_ps_mid_training_resumes_with_the_clean_losses(tmp_path):
    """``tests/test_chaos.py``'s acceptance run in each package: the
    schedule kills rank 1's server after step 3 (after that step's
    auto-save); the executor raises a clean diagnostic, a replacement
    server loads its shard from the newest complete checkpoint, a fresh
    executor resumes at step 3, and the six losses are the clean run's
    bit for bit.  The two packages' fault counters are equal."""
    feeds = _feeds(6)

    def scenario(pkg):
        stores, tid = _pair(pkg, free_ports(2))
        try:
            ex, ids, y_ = _ps_executor(pkg, stores[0], tid)
            base = [float(np.asarray(ex.run("train", feed_dict={
                ids: f[0], y_: f[1]})[0].asnumpy())) for f in feeds]
            _close_ex(ex)
        finally:
            close_all(stores)
        assert pkg.metrics.fault_counts() == {}
        save_dir = str(tmp_path / pkg.name)
        ports = free_ports(2)
        pkg.chaos.install(pkg.chaos.ChaosInjector.from_spec(
            "11:kill:ps@rank1:step3"))
        stores, tid = _pair(pkg, ports)
        live = list(stores)
        kw = dict(auto_save_dir=save_dir, auto_save_every=1,
                  install_signal_handlers=False)
        try:
            ex, ids, y_ = _ps_executor(pkg, stores[0], tid, **kw)
            losses, step, failures, restored = [None] * 6, 0, 0, None
            while step < 6:
                try:
                    losses[step] = float(np.asarray(ex.run(
                        "train", feed_dict={ids: feeds[step][0],
                                            y_: feeds[step][1]})[0]
                        .asnumpy()))
                    step += 1
                    # rank 1's executor would save its shard; this process
                    # has rank 0's only, so the shard is saved here
                    ck = os.path.join(save_dir, f"ckpt-{step:08d}")
                    if os.path.isdir(ck):
                        live[1].save(tid, os.path.join(ck, "ps0.bin"))
                except RuntimeError as e:
                    assert "unreachable" in str(e), e
                    failures += 1
                    assert failures == 1
                    newest = next(c for c in sorted(glob.glob(
                        os.path.join(save_dir, "ckpt-*")), reverse=True)
                        if pkg.ht.Executor._checkpoint_complete(c))
                    s1 = pkg.ds.DistributedStore(1, 2, ends(ports),
                                                 port=ports[1], **FAST)
                    live.append(s1)
                    s1.init_table(32, 8, opt="sgd", lr=0.1, init_scale=0.0)
                    s1.load(tid, os.path.join(newest, "ps0.bin"))
                    live[1] = s1
                    _close_ex(ex)
                    ex, ids, y_ = _ps_executor(pkg, stores[0], tid, **kw)
                    restored = step = ex.resume(save_dir)
            _close_ex(ex)
            assert losses == base
            return {"restored": restored, "failures": failures}
        finally:
            pkg.chaos.uninstall()
            close_all(live)
    out = run_both(BOTH, scenario)
    assert out["restored"] == 3 and out["failures"] == 1
    fc = out["faults"]
    assert fc["chaos_kill_ps"] == 1 and fc["resume"] == 1
    assert fc["ps_rpc_retry"] >= 1 and fc["ps_peer_unreachable"] >= 1
    assert fc["auto_save"] >= 3


def test_on_step_runs_after_the_auto_save(tmp_path):
    """The port's step boundary orders the hooks as the JAX package's:
    the auto-save of step s, then ``on_step(s)``."""
    order = []

    class Probe(tchaos.ChaosInjector):
        def on_step(self, step):
            order.append(("chaos", step, sorted(os.listdir(tmp_path))))
            return super().on_step(step)

    tchaos.install(Probe(0, []))
    x = tht.placeholder_op("x")
    w = tht.Variable("w_chaos", value=np.ones((2, 1), np.float32))
    loss = tht.reduce_sum_op(tht.matmul_op(x, w))
    ex = tht.Executor([loss, tht.optim.SGDOptimizer(0.1).minimize(loss)],
                      device="cpu", auto_save_dir=str(tmp_path),
                      auto_save_every=1, install_signal_handlers=False)
    for _ in range(2):
        ex.run(feed_dict={x: np.ones((1, 2), np.float32)})
    assert [o[:2] for o in order] == [("chaos", 1), ("chaos", 2)]
    assert "ckpt-00000001" in order[0][2]
    assert "ckpt-00000002" in order[1][2]


def test_a_killed_servers_own_worker_fails_over_too():
    """``kill:primary`` stops a server whose worker lives on (the hybrid
    deployment puts both in one process).  The port's worker then reaches
    its shard over the transport, fails over and reads the surviving
    copy, as every other rank does; the JAX package's worker keeps
    reading the dead server's copy and misses the pushes made since the
    kill (ROADMAP C17)."""
    def scenario(pkg):
        ports = free_ports(3)
        stores = [pkg.ds.DistributedStore(r, 3, ends(ports), port=ports[r],
                                          replication=2, **FAST)
                  for r in range(3)]
        try:
            tid = [s.init_table(48, 8, opt="sgd", lr=0.1, init_scale=0.0)
                   for s in stores][0]
            inj = pkg.chaos.ChaosInjector.from_spec(
                "7:kill:primary@shard1:step1")
            for r, s in enumerate(stores):
                inj.register_server(r, s.server)
            assert inj.on_step(1) == [1]
            key = np.asarray([1], np.int64)          # shard 1
            stores[0].push(tid, key, np.ones((1, 8), np.float32))
            return (stores[0].pull(tid, key)[0].copy(),
                    stores[1].pull(tid, key)[0].copy(),
                    sorted(stores[2].server._serving))
        finally:
            close_all(stores)
    j0, j1, jserving = scenario(JAX)
    t0, t1, tserving = scenario(PORT)
    np.testing.assert_array_equal(t0, j0)
    np.testing.assert_allclose(t0, -0.1 * np.ones(8), atol=1e-6)
    np.testing.assert_array_equal(t1, t0)          # the surviving copy
    np.testing.assert_array_equal(j1, np.zeros(8))  # the dead copy
    assert tserving == jserving == [1, 2]
