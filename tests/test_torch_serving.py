"""The port's request-level serving plane (``serving/router.py::
ServingRouter``, ``serving/executor.py``'s ``infer`` / ``infer_rows`` /
``warm`` and weight sources), on the CPU at tiny size, held to the JAX
package on the same 3x4 matmul graph.

Response rows equal the JAX router's within ``ROW_ATOL`` = 1e-6 absolute
(both are float32 products of the same operands; the libraries may sum
in another order), and ``infer_rows``' scatter plans equal the JAX ones
exactly.  Weights from a live port ``Executor`` and from a checkpoint
directory serve the rows of a weights dict within the same tolerance."""
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu import metrics as jmetrics                   # noqa: E402
import hetu_tpu_torch as ht                                # noqa: E402
from hetu_tpu_torch import metrics                         # noqa: E402

ROW_ATOL = 1e-6
W0 = (np.arange(12, dtype=np.float32).reshape(3, 4) * 0.1) - 0.5
SERVE_KEYS = ("serve_requests", "serve_responses", "serve_batches",
              "serve_batch_rows", "serve_pad_rows", "serve_queue_depth_hw")


def _graph(pkg):
    x = pkg.placeholder_op("x")
    return x, pkg.matmul_op(x, pkg.Variable("w", value=W0.copy()))


def _iex(pkg, fetches, **kw):
    if pkg is ht:
        kw["device"] = "cpu"
    return pkg.serving.InferenceExecutor(fetches, **kw)


@pytest.fixture(autouse=True)
def _reset():
    for m in (metrics, jmetrics):
        m.reset_serve_counts()
        m.reset_serve_rejection_counts()
    yield


def _ragged(pkg):
    x, y = _graph(pkg)
    r = pkg.serving.ServingRouter(_iex(pkg, [y], buckets=(2, 4, 8)),
                                  max_batch=4, max_wait_ms=30.0,
                                  start=False)
    futs = [r.submit({x: np.full((3,), i * 0.37, np.float32)})
            for i in range(11)]
    r.start()
    rows = [f.result(timeout=30)[0] for f in futs]
    r.close()
    counts = pkg.metrics.serve_counts()
    return rows, {k: counts.get(k, 0) for k in SERVE_KEYS}


def test_ragged_arrivals_match_the_jax_router():
    """Eleven requests queued on a paused router, then served at
    ``max_batch`` 4 (batches 4, 4, 3 → bucket 4): each response row
    within ROW_ATOL of the JAX router's, and the batch counters equal."""
    want, wcounts = _ragged(jht)
    got, counts = _ragged(ht)
    for g, w in zip(got, want):
        assert g.shape == (4,)
        np.testing.assert_allclose(g, w, rtol=0, atol=ROW_ATOL)
    assert counts == wcounts
    assert counts["serve_batches"] == 3 and counts["serve_pad_rows"] == 1


def _plans(pkg):
    """A per-row fetch, a fetch that flattens 2 rows a sample into the
    batch dim, a batch aggregate and a batch-invariant fetch."""
    x = pkg.placeholder_op("x2")
    w = pkg.Variable("w2", value=W0.copy())
    y = pkg.matmul_op(x, w)
    ids = pkg.placeholder_op("ids")
    k2 = pkg.matmul_op(pkg.array_reshape_op(ids, (-1, 3)), w)
    mean = pkg.reduce_mean_op(y, [0])
    inv = pkg.reduce_sum_op(w, [0])
    iex = _iex(pkg, [y, k2, mean, inv], buckets=(4, 8))
    feeds = {x: np.arange(12, dtype=np.float32).reshape(4, 3) / 7,
             ids: np.arange(24, dtype=np.float32).reshape(4, 2, 3) / 5}
    outs, plan = iex.infer_rows(feeds)
    return [np.asarray(o) for o in outs], plan, iex, feeds, x


def test_infer_rows_plans_match_the_jax_plans():
    want, wplan, _, _, _ = _plans(jht)
    got, plan, iex, feeds, x = _plans(ht)
    assert plan == wplan == [1, 2, None, None]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ROW_ATOL)
    with pytest.raises(ValueError, match="zero-padding"):
        iex.infer({k: v[:3] for k, v in feeds.items()})   # 3 -> bucket 4
    with pytest.raises(ValueError, match="exceeds the largest"):
        iex.infer({k: np.concatenate([v, v, v]) for k, v in feeds.items()})


def test_aggregating_fetch_served_whole_to_every_request_at_an_exact_fit():
    for pkg in (ht, jht):
        x, y = _graph(pkg)
        mean = pkg.reduce_mean_op(y, [0])
        iex = _iex(pkg, [y, mean], buckets=(4, 8))
        exact = np.arange(12, dtype=np.float32).reshape(4, 3)
        with pkg.serving.ServingRouter(iex, max_batch=4,
                                       max_wait_ms=2000.0) as r:
            res = [f.result(timeout=30)
                   for f in [r.submit({x: exact[i]}) for i in range(4)]]
        for i, (row, agg) in enumerate(res):
            np.testing.assert_allclose(row, (exact @ W0)[i], rtol=0,
                                       atol=ROW_ATOL)
            np.testing.assert_allclose(agg, (exact @ W0).mean(0), rtol=0,
                                       atol=ROW_ATOL)


def test_straggler_ships_at_its_arrival_anchored_deadline():
    """A lone request ships after one ``max_wait_ms`` window, padded to
    the bucket; a request that already waited out its window on a paused
    router ships at once when the batcher starts."""
    x, y = _graph(ht)
    iex = _iex(ht, [y], buckets=(8,))
    iex.warm({x: np.zeros((1, 3), np.float32)})
    with ht.ServingRouter(iex, max_batch=8, max_wait_ms=40.0) as r:
        t0 = time.monotonic()
        r.submit({x: np.ones((3,), np.float32)}).result(timeout=30)
        assert time.monotonic() - t0 >= 0.030
    assert metrics.serve_counts()["serve_pad_rows"] == 7
    r = ht.ServingRouter(iex, max_batch=8, max_wait_ms=2000.0, start=False)
    try:
        fut = r.submit({x: np.ones((3,), np.float32)})
        time.sleep(2.2)                  # the paused router: a slow batch
        t0 = time.monotonic()
        r.start()
        row = fut.result(timeout=30)
        assert time.monotonic() - t0 < 1.5
    finally:
        r.close()
    np.testing.assert_allclose(row[0], np.ones(3) @ W0, rtol=0, atol=ROW_ATOL)


def test_cancelled_futures_neither_kill_the_batcher_nor_close():
    x, y = _graph(ht)
    iex = _iex(ht, [y], buckets=(4,))
    r = ht.ServingRouter(iex, max_batch=4, max_wait_ms=10.0, start=False)
    doomed = r.submit({x: np.zeros((3,), np.float32)})
    live = [r.submit({x: np.full((3,), i, np.float32)}) for i in range(3)]
    assert doomed.cancel()
    r.start()
    for i, f in enumerate(live):
        np.testing.assert_allclose(f.result(timeout=30)[0],
                                   np.full(3, i) @ W0, rtol=0, atol=ROW_ATOL)
    again = r.submit({x: np.ones((3,), np.float32)})
    assert again.result(timeout=30)[0].shape == (4,)
    r.close()
    r2 = ht.ServingRouter(iex, queue_limit=8, start=False)
    gone = r2.submit({x: np.zeros((3,), np.float32)})
    kept = r2.submit({x: np.ones((3,), np.float32)})
    assert gone.cancel()
    r2.close()                           # must not raise
    assert gone.cancelled()
    with pytest.raises(ht.ServeRejected) as ei:
        kept.result(timeout=5)
    assert ei.value.reason == "draining"


def test_malformed_request_fails_only_itself():
    x, y = _graph(ht)
    r = ht.ServingRouter(_iex(ht, [y], buckets=(2, 4, 8)), max_batch=8,
                         max_wait_ms=20.0, start=False)
    good = [r.submit({x: np.full((3,), i, np.float32)}) for i in range(3)]
    bad = r.submit({x: np.zeros((5,), np.float32)})
    r.start()
    try:
        for i, f in enumerate(good):
            np.testing.assert_allclose(f.result(timeout=30)[0],
                                       np.full(3, i) @ W0, rtol=0,
                                       atol=ROW_ATOL)
        with pytest.raises(Exception):
            bad.result(timeout=30)
        assert metrics.serve_counts()["serve_batch_retries"] == 1
    finally:
        r.close()


def test_queue_full_and_close_are_structured_rejections():
    """The reasons and their counts match the JAX router's."""
    out = []
    for pkg in (jht, ht):
        x, y = _graph(pkg)
        r = pkg.serving.ServingRouter(_iex(pkg, [y], buckets=(4,)),
                                      queue_limit=2, start=False)
        futs = [r.submit({x: np.zeros((3,), np.float32)}) for _ in range(2)]
        reasons = []
        try:
            r.submit({x: np.zeros((3,), np.float32)})
        except pkg.ServeRejected as e:
            reasons.append(e.reason)
        r.stop_admitting()
        try:
            r.submit({x: np.zeros((3,), np.float32)})
        except pkg.ServeRejected as e:
            reasons.append(e.reason)
        assert r.health()["draining"] and r.pending == 2
        assert r.drain(timeout=0.1) is False      # never started
        r.close()
        for f in futs:
            try:
                f.result(timeout=5)
            except pkg.ServeRejected as e:
                reasons.append(e.reason)
        out.append((reasons, pkg.metrics.serve_rejection_counts(),
                    pkg.metrics.serve_counts().get("serve_rejections")))
    assert out[1] == out[0]
    assert out[1][0] == ["queue_full", "draining", "draining", "draining"]


def test_serve_rejected_taxonomy_matches_jax():
    assert ht.ServeRejected.REASONS == jht.ServeRejected.REASONS
    for reason in ht.ServeRejected.REASONS + ("shed:batch",):
        exc = ht.ServeRejected(reason, "detail", klass="batch",
                               partial=[1, 2])
        assert (exc.reason, exc.klass, exc.partial, str(exc)) \
            == (reason, "batch", [1, 2], f"{reason}: detail")
    assert metrics.serve_rejection_counts()["shed:batch"] == 1
    with pytest.raises(ValueError, match="taxonomy"):
        ht.ServeRejected("queue full")


def test_warm_runs_every_bucket_without_counting_batches():
    x, y = _graph(ht)
    iex = _iex(ht, [y], buckets=(1, 2, 4))
    assert iex.warm({x: np.ones((1, 3), np.float32)}) == 3
    assert sorted(iex._compiled) == [1, 2, 4]
    assert "serve_batches" not in metrics.serve_counts()
    assert iex.bucket_for(3) == 4 and iex.bucket_for(5) is None


def test_weights_from_a_live_executor_and_a_checkpoint_directory(tmp_path):
    """Three SGD steps on the port's Executor, saved with
    ``Executor.save``: the executor itself, the directory and the dict of
    ``return_tensor_values`` serve the same rows; a directory without
    ``meta.json`` raises ``ValueError``."""
    x = ht.placeholder_op("x", shape=(4, 3))
    y_ = ht.placeholder_op("y", shape=(4, 2))
    w = ht.Variable("w", initializer=ht.init.GenXavierNormal(), shape=(3, 2))
    d = ht.matmul_op(x, w) - y_
    loss = ht.reduce_mean_op(ht.mul_op(d, d), [0, 1])
    ex = ht.Executor({"train": [loss,
                                ht.optim.SGDOptimizer(0.1).minimize(loss)]},
                     seed=0, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(3):
        ex.run("train", feed_dict={x: rng.rand(4, 3).astype(np.float32),
                                   y_: rng.rand(4, 2).astype(np.float32)})
    ck = str(tmp_path / "ck")
    ex.save(ck)
    prob = ht.matmul_op(x, w)
    xv = np.ones((2, 3), np.float32)
    trained = ex.return_tensor_values()["w"]
    want = xv @ trained
    for source in (ex, ck, {"w": trained}):
        iex = _iex(ht, [prob], weights=source, buckets=(2, 4))
        np.testing.assert_allclose(iex.infer({x: xv})[0], want, rtol=0,
                                   atol=ROW_ATOL)
        assert torch.equal(iex.params[iex._k(w)], torch.from_numpy(trained))
    with pytest.raises(ValueError, match="meta.json"):
        _iex(ht, [prob], weights=str(tmp_path), buckets=(2,))


def test_refresh_every_batches_without_ps_is_a_no_op(monkeypatch):
    """``refresh_every_batches`` is ported (tests/test_torch_ctr_serving.py
    holds the sweep against the JAX package's): over a graph without PS
    embeddings the sweep refreshes nothing and the rows are the JAX
    router's; what stays refused is a set ``HETU_CHAOS``."""
    got = []
    for pkg in (ht, jht):
        x, y = _graph(pkg)
        iex = _iex(pkg, [y], buckets=(4,))
        with pkg.ServingRouter(iex, refresh_every_batches=1) as r:
            got.append(r.submit({x: np.ones((3,), np.float32)})
                       .result(timeout=30)[0])
        assert iex.refresh_embeddings() == 0
    np.testing.assert_allclose(got[0], got[1], rtol=0, atol=ROW_ATOL)
    monkeypatch.setenv("HETU_CHAOS", "7:kill:replica@0:req4")
    x, y = _graph(ht)
    with pytest.raises(NotImplementedError, match="HETU_CHAOS"):
        ht.ServingRouter(_iex(ht, [y], buckets=(4,)),
                         refresh_every_batches=5, start=False)


def test_fixed_batch_graph_is_planned_at_its_own_size():
    """A graph built at one batch size (a reshape names the batch, as
    BERT's does) cannot be evaluated at twice the bucket: the port plans
    it from the bucket's shapes alone and serves it, padded; the JAX
    package refuses it (ROADMAP C7 (n))."""
    out = []
    for pkg in (ht, jht):
        x = pkg.placeholder_op("xf")
        y = pkg.matmul_op(pkg.array_reshape_op(x, (4, 3)),
                          pkg.Variable("wf", value=W0.copy()))
        iex = _iex(pkg, [y], buckets=(4,))
        xv = np.arange(9, dtype=np.float32).reshape(3, 3)
        try:
            out.append(iex.infer_rows({x: xv}))
        except Exception as e:             # noqa: BLE001 — the JAX refusal
            out.append(e)
    rows, plan = out[0]
    assert plan == [1]
    np.testing.assert_allclose(rows[0], xv @ W0, rtol=0, atol=ROW_ATOL)
    assert isinstance(out[1], Exception)
