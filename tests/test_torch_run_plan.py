"""Cached run plans, pipelined feeds, non-blocking stepping, ``timing=``,
and ``matmul_precision=`` in the port, on the CPU
(twin of ``tests/test_run_plan.py``).

* Plans: a steady schema hits the cache every step after the first; a
  schema change re-plans and both stay cached; numpy, tensor and
  ``NDArray`` feeds give the same bits; sustained churn warns naming the
  placeholder and its creation site, a fixed bucket set warming up does
  not; ``KeyedPlanCache`` counts like the JAX package's.
* The rates the port reads on the host every step: a mutated constant
  rate and a reassigned scheduler take effect on the next step, an
  instance ``on_step`` hook fires every step (the JAX cases that test
  what a jitted step bakes in are ported as this behaviour only).
* Async: ``run_steps(..., sync=False)`` (dense, Adam) and ``run(sync=
  False)`` of Wide & Deep through a PS store are bit-equal to the plain
  loop, and both match the JAX package's trajectory at the gates of
  ``tests/test_torch_bert.py`` (step-1 loss atol 1e-5, every loss rtol
  1e-5); the numpy conversion, the push boundary, the window and a save
  are counted sync points; the window bounds the steps in flight.
* ``run_steps`` against a manual loop, and a dataloader-fed graph with
  the double buffer on and off: bit-equal, the pipelined feeds counted,
  and each against the JAX package's run.
* ``timing=True`` records every run, also under ``sync=False``;
  ``logOut`` / ``clearTimer``.
* ``matmul_precision``: the mapping of the JAX names, the setting applied
  inside the step only and restored after it (also when the step
  raises), ``'float32'`` held to the JAX package.

``remat='auto'`` is held in ``tests/test_torch_remat.py``.
"""
import importlib.util
import os
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jtopo         # noqa: E402
import hetu_tpu_torch as tht                               # noqa: E402
from hetu_tpu_torch import metrics as tmetrics             # noqa: E402
from hetu_tpu_torch.graph import executor as texec         # noqa: E402
from hetu_tpu_torch.graph.run_plan import KeyedPlanCache   # noqa: E402

LOSS_ATOL_STEP1, LOSS_RTOL = 1e-5, 1e-5


def _dense(ht, shape=(8, 8), optimizer=None, declared=True):
    x = ht.placeholder_op("x", shape=shape if declared else None)
    w = ht.Variable("w", value=np.random.RandomState(3).randn(
        shape[1], 4).astype(np.float32) * 0.1)
    loss = ht.reduce_mean_op(ht.matmul_op(x, w) * ht.matmul_op(x, w),
                             [0, 1])
    opt = optimizer or ht.optim.SGDOptimizer(0.1)
    return x, loss, opt.minimize(loss)


def _feed(shape=(8, 8), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(fetches, **kw):
    return tht.Executor(fetches, seed=0, device="cpu", **kw)


def _loss(out):
    return np.asarray(out[0].asnumpy(), np.float32)


def _against_jax(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=LOSS_ATOL_STEP1)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


# ------------------------------------------------------------ plan cache

def test_plan_cache_hits_on_a_steady_schema():
    x, loss, train = _dense(tht)
    ex = _port({"train": [loss, train]})
    xv = _feed()
    tmetrics.reset_run_plan_counts()
    for _ in range(6):
        out = ex.run("train", feed_dict={x: xv})
    c = tmetrics.run_plan_counts()
    assert c.get("plan_cache_miss") == 1 and c.get("plan_cache_hit") == 5, c
    assert np.isfinite(_loss(out))


def test_plan_cache_replans_on_a_schema_change_and_keeps_both():
    x, loss, train = _dense(tht, declared=False)
    ex = _port({"train": [loss, train]})
    a, b = _feed((4, 8)), _feed((6, 8), seed=1)
    tmetrics.reset_run_plan_counts()
    for v in (a, b, a, b):
        ex.run("train", feed_dict={x: v})
    c = tmetrics.run_plan_counts()
    assert c.get("plan_cache_miss") == 2 and c.get("plan_cache_hit") == 2, c


def test_feed_containers_give_the_same_bits():
    losses = {}
    for kind in ("np", "torch", "ndarray", "list"):
        x, loss, train = _dense(tht)
        ex = _port({"train": [loss, train]})
        xv = _feed()
        val = {"np": xv, "torch": torch.from_numpy(xv.copy()),
               "ndarray": tht.NDArray(xv), "list": xv.tolist()}[kind]
        losses[kind] = [_loss(ex.run("train", feed_dict={x: val})).tobytes()
                        for _ in range(3)]
    assert losses["np"] == losses["torch"] == losses["ndarray"] \
        == losses["list"]


def test_feed_schema_churn_warns_with_the_creation_site(monkeypatch):
    monkeypatch.setenv("HETU_RUN_PLAN_CACHE", "2")
    x, loss, train = _dense(tht, declared=False)
    x.name = "ragged_x"
    ex = _port({"train": [loss, train]})
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i in range(8):
            ex.run("train", feed_dict={x: _feed(((2, 3, 5, 7)[i % 4], 8),
                                                seed=i)})
    msgs = [str(r.message) for r in rec
            if "feed-schema-churn" in str(r.message)]
    assert len(msgs) == 1, [str(r.message) for r in rec]
    assert "ragged_x" in msgs[0] and "created at" in msgs[0]
    assert "test_torch_run_plan.py" in msgs[0]
    assert "bucket" in msgs[0].lower()


def test_a_fixed_bucket_set_warming_up_does_not_warn():
    x, loss, train = _dense(tht, declared=False)
    ex = _port({"train": [loss, train]})
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i in range(12):
            ex.run("train", feed_dict={x: _feed(((8, 16, 24, 32)[i % 4], 8),
                                                seed=i)})
    assert not [r for r in rec if "feed-schema-churn" in str(r.message)]


def test_keyed_plan_cache_counts_hits_and_misses():
    tmetrics.reset_run_plan_counts()
    cache = KeyedPlanCache(max_entries=2)
    built = []
    for key in ("a", "b", "a", "c", "b"):
        cache.lookup(key, lambda k=key: built.append(k) or k)
    # "b" was evicted by "c" (LRU of 2): built again
    assert built == ["a", "b", "c", "b"]
    assert tmetrics.run_plan_counts() == {"plan_cache_miss": 4,
                                          "plan_cache_hit": 1}


# ------------------------------------------------- rates read every step

def _weights(ex):
    return {k: np.asarray(v) for k, v in ex.return_tensor_values().items()}


@pytest.mark.parametrize("first", ["constant", "scheduler"])
def test_a_new_rate_takes_effect_on_the_next_step(first):
    lr = 0.5 if first == "constant" else \
        tht.optim.lr_scheduler.StepScheduler(0.5, step_size=1000)
    opt = tht.optim.SGDOptimizer(lr)
    x, loss, train = _dense(tht, optimizer=opt)
    ex = _port({"train": [loss, train]})
    xv = _feed()
    ex.run("train", feed_dict={x: xv})
    opt.lr = 1e-6
    before = _weights(ex)
    ex.run("train", feed_dict={x: xv})
    after = _weights(ex)
    assert max(np.abs(after[k] - before[k]).max() for k in before) < 1e-4


def test_an_instance_on_step_hook_fires_every_step():
    opt = tht.optim.SGDOptimizer(0.1)
    calls = []
    opt.on_step = calls.append
    x, loss, train = _dense(tht, optimizer=opt)
    ex = _port({"train": [loss, train]})
    for _ in range(3):
        ex.run("train", feed_dict={x: _feed()})
    assert calls == [1, 2, 3]


# --------------------------------------------------- async / sync parity

def _dense_run(ht, mode, n=12):
    feeds = [_feed(seed=i) for i in range(n)]
    x, loss, train = _dense(ht, optimizer=ht.optim.AdamOptimizer(1e-2))
    if ht is jht:
        ex = jht.Executor({"train": [loss, train]}, seed=0)
    else:
        ex = _port({"train": [loss, train]})
    if mode == "loop":
        losses = [_loss(ex.run("train", feed_dict={x: feeds[i]}))
                  for i in range(n)]
    else:
        rs = ex.run_steps(lambda i: {x: feeds[i]}, n, name="train",
                          sync=mode != "steps_sync")
        losses = [_loss(r) for r in rs]
    return losses, _weights(ex)


def test_run_steps_async_is_bit_equal_to_the_loop_and_matches_jax():
    loop, wl = _dense_run(tht, "loop")
    steps, ws = _dense_run(tht, "steps")
    steps_sync, _ = _dense_run(tht, "steps_sync")
    assert [v.tobytes() for v in loop] == [v.tobytes() for v in steps] \
        == [v.tobytes() for v in steps_sync]
    assert {k: v.tobytes() for k, v in wl.items()} == \
        {k: v.tobytes() for k, v in ws.items()}
    jsteps, _ = _dense_run(jht, "steps")
    _against_jax(np.array(steps), np.array(jsteps))


def _jax_ctr():
    name = "_jax_ctr_models_rp"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", "ctr", "models.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def _wdl_run(ht, sync, steps=10, batch=32, vocab=1000):
    dv, sv, yv = tht.synthetic_criteo(batch, vocab=vocab)
    dense = ht.placeholder_op("dense")
    sparse = ht.placeholder_op("sparse", dtype=np.int64)
    y_ = ht.placeholder_op("y")
    ctr = _jax_ctr() if ht is jht else tht.models.ctr
    loss, _ = ctr.wdl_criteo(dense, sparse, y_, batch, vocab=vocab, dim=8,
                             embed_mode="ps", lr=0.01)[:2]
    fetches = {"train": [loss, ht.optim.SGDOptimizer(0.01).minimize(loss)]}
    ex = jht.Executor(fetches, seed=0) if ht is jht else _port(fetches)
    return ex, {dense: dv, sparse: sv, y_: yv}, loss


def _ps_node(loss, topo):
    return next(n for n in topo([loss]) if getattr(n, "is_ps", False))


def test_async_wdl_through_a_ps_store_is_bit_equal_and_counts_pushes():
    """The push boundary is the forced sync point of every async step."""
    table = np.random.RandomState(1).uniform(
        -0.01, 0.01, (1000, 8)).astype(np.float32)
    jex, jfd, jloss = _wdl_run(jht, True)
    node = _ps_node(jloss, jtopo)
    node.store.set_data(node.table, table.copy())
    w0 = {k: np.array(v) for k, v in jex.return_tensor_values().items()}
    want = np.array([_loss(jex.run("train", feed_dict=jfd))
                     for _ in range(10)])
    runs = {}
    for sync in (True, False):
        ex, fd, loss = _wdl_run(tht, sync)
        ex.load_dict(w0)
        node = _ps_node(loss, tht.topo_sort)
        node.store.set_data(node.table, table.copy())
        tmetrics.reset_run_plan_counts()
        outs = [ex.run("train", feed_dict=fd, sync=sync) for _ in range(10)]
        points = tmetrics.run_plan_counts().get("async_sync_points", 0)
        # ten push boundaries, and the window of 4 full six times
        assert points == (0 if sync else 10 + 6)
        got = np.array([_loss(o) for o in outs])
        _against_jax(got, want)
        runs[sync] = ([v.tobytes() for v in got],
                      node.store.get_data(node.table).tobytes(),
                      {k: v.tobytes() for k, v in _weights(ex).items()})
    assert runs[True] == runs[False]


def test_the_numpy_conversion_is_a_sync_point():
    x, loss, train = _dense(tht)
    ex = _port({"train": [loss, train]})
    tmetrics.reset_run_plan_counts()
    out = ex.run("train", feed_dict={x: _feed()}, sync=False,
                 convert_to_numpy_ret_vals=True)
    assert isinstance(out[0], np.ndarray)
    assert tmetrics.run_plan_counts().get("async_sync_points") == 1
    assert not ex._async_pending


def test_the_window_bounds_the_steps_in_flight(monkeypatch):
    monkeypatch.setenv("HETU_ASYNC_WINDOW", "2")
    x, loss, train = _dense(tht)
    ex = _port({"train": [loss, train]})
    tmetrics.reset_run_plan_counts()
    for _ in range(8):
        ex.run("train", feed_dict={x: _feed()}, sync=False)
    assert len(ex._async_pending) == 2
    assert tmetrics.run_plan_counts().get("async_sync_points") == 6
    ex.ps_flush()
    assert not ex._async_pending
    assert tmetrics.run_plan_counts().get("async_sync_points") == 7


def test_save_and_resume_drain_the_steps_in_flight(tmp_path):
    x, loss, train = _dense(tht)
    ex = _port({"train": [loss, train]})
    for _ in range(3):
        ex.run("train", feed_dict={x: _feed()}, sync=False)
    assert len(ex._async_pending) == 3
    ex.save(str(tmp_path / "ck"))
    assert not ex._async_pending
    ex.run("train", feed_dict={x: _feed()}, sync=False)
    assert ex.resume(str(tmp_path / "ck")) == 3
    assert not ex._async_pending


# ------------------------------------------------- run_steps + pipeline

def test_run_steps_validates_its_arguments():
    x, loss, train = _dense(tht)
    ex = _port({"train": [loss, train]})
    with pytest.raises(ValueError, match="step count"):
        ex.run_steps(lambda i: {x: _feed()}, -1, name="train")
    with pytest.raises(ValueError, match="only 1 feed dicts"):
        ex.run_steps([{x: _feed()}], 2, name="train")
    assert ex.run_steps([{x: _feed()}], 0, name="train") == []


def test_run_steps_pipelines_feeds_and_matches_the_loop(monkeypatch):
    """With the handoff threshold at 0 every next step's feeds are placed
    on the run-steps thread (counted); the bits are the loop's."""
    monkeypatch.setenv("HETU_FEED_PIPELINE_MIN_US", "0")
    tmetrics.reset_run_plan_counts()
    steps, _ = _dense_run(tht, "steps", n=6)
    assert tmetrics.run_plan_counts().get("feeds_pipelined") == 5
    loop, _ = _dense_run(tht, "loop", n=6)
    assert [v.tobytes() for v in steps] == [v.tobytes() for v in loop]


def _dataloader_run(ht, steps=10):
    xv = np.random.RandomState(0).randn(40, 8).astype(np.float32)
    x = ht.dataloader_op([ht.Dataloader(xv, 8, "train")])
    w = ht.Variable("w", value=np.random.RandomState(3).randn(
        8, 4).astype(np.float32) * 0.1)
    loss = ht.reduce_mean_op(ht.matmul_op(x, w) * ht.matmul_op(x, w),
                             [0, 1])
    fetches = {"train": [loss, ht.optim.SGDOptimizer(0.1).minimize(loss)]}
    ex = jht.Executor(fetches, seed=0) if ht is jht else _port(fetches)
    return [_loss(ex.run("train")) for _ in range(steps)]


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_the_dataloader_double_buffer_is_bit_equal_and_counted(
        pipeline, monkeypatch):
    monkeypatch.setenv("HETU_FEED_PIPELINE_MIN_US", "0")
    monkeypatch.setenv("HETU_FEED_PIPELINE", "0")
    want = _dataloader_run(tht)
    monkeypatch.setenv("HETU_FEED_PIPELINE", pipeline)
    tmetrics.reset_run_plan_counts()
    got = _dataloader_run(tht)
    c = tmetrics.run_plan_counts()
    if pipeline == "1":
        # step 0 places inline; each later batch was prefetched
        assert c.get("feeds_pipelined") == 9, c
        assert c.get("feed_pipeline_depth_hw") == 1, c
    else:
        assert "feeds_pipelined" not in c, c
    assert [v.tobytes() for v in got] == [v.tobytes() for v in want]
    _against_jax(np.array(got), np.array(_dataloader_run(jht)))


def test_a_restored_loader_never_reads_a_stale_prefetch(monkeypatch):
    """The double buffer consumes a prefetch only when the loader hands
    out the very batch that was peeked: rewinding the loader makes the
    next step place the loader's batch inline."""
    monkeypatch.setenv("HETU_FEED_PIPELINE_MIN_US", "0")
    xv = np.arange(40 * 8, dtype=np.float32).reshape(40, 8)
    dl = tht.Dataloader(xv, 8, "train", prefetch=0)
    x = tht.dataloader_op([dl])
    ex = _port({"train": [tht.reduce_sum_op(x, [0, 1])]})
    first = [float(_loss(ex.run("train"))) for _ in range(3)]
    state = dl.state_dict()
    state["consumed"] = 0
    dl.load_state(state)
    again = [float(_loss(ex.run("train"))) for _ in range(3)]
    assert again == first


# ----------------------------------------------------- timing, precision

def test_timing_records_every_run_and_logs_out(tmp_path):
    x, loss, train = _dense(tht)
    ex = _port({"train": [loss, train]}, timing=True)
    for _ in range(3):
        ex.run("train", feed_dict={x: _feed()})
    assert len(ex.timer_logs["train"]) == 3
    assert all(t > 0 for t in ex.timer_logs["train"])
    ex.run("train", feed_dict={x: _feed()}, sync=False)
    assert len(ex.timer_logs["train"]) == 4
    path = tmp_path / "times.log"
    ex.logOut(str(path))
    lines = path.read_text().splitlines()
    assert len(lines) == 4 and lines[0].startswith("train\t")
    assert ex.timer_logs == {}
    ex.run("train", feed_dict={x: _feed()})
    ex.clearTimer()
    assert ex.timer_logs == {}


@pytest.mark.parametrize("name,level", sorted(
    texec.MATMUL_PRECISIONS.items()))
def test_matmul_precision_maps_and_restores(name, level, monkeypatch):
    seen = []
    real = texec.SubExecutor.run

    def spy(self, *a, **kw):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cudnn.allow_tf32))
        return real(self, *a, **kw)

    monkeypatch.setattr(texec.SubExecutor, "run", spy)
    x, loss, train = _dense(tht)
    ex = _port({"train": [loss, train]}, matmul_precision=name)
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    assert before == ("highest", False, False)     # the executor's default
    ex.run("train", feed_dict={x: _feed()})
    assert seen == [(level, level != "highest")]
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    # also restored when the step raises
    with pytest.raises(ValueError, match="missing feed"):
        ex.run("train", feed_dict={})
    assert torch.get_float32_matmul_precision() == "highest"


def test_matmul_precision_rejects_an_unknown_name():
    x, loss, train = _dense(tht)
    with pytest.raises(ValueError, match="matmul_precision"):
        _port({"train": [loss, train]}, matmul_precision="double")


def test_float32_precision_matches_the_jax_package():
    x, loss, train = _dense(tht, optimizer=tht.optim.AdamOptimizer(1e-2))
    ex = _port({"train": [loss, train]}, matmul_precision="float32")
    jx, jloss, jtrain = _dense(jht, optimizer=jht.optim.AdamOptimizer(1e-2))
    jex = jht.Executor({"train": [jloss, jtrain]}, seed=0,
                       matmul_precision="float32")
    got = [_loss(ex.run("train", feed_dict={x: _feed(seed=i)}))
           for i in range(5)]
    want = [_loss(jex.run("train", feed_dict={jx: _feed(seed=i)}))
            for i in range(5)]
    _against_jax(np.array(got), np.array(want))
