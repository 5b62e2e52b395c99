"""The hybrid Wide & Deep deployment of the port (PS embeddings under
``DataParallel``) against the JAX package, on the CPU.

A module fixture starts two ranks through the port's launcher
(``launcher.launch``, a gloo world), each running
``hetu_tpu_torch/tools/hybrid_wdl.py``: a shard of a two-shard
``DistributedStore`` a rank, tiny Wide & Deep (vocab 520, dim 4, batch 8,
5 steps) over a fresh table a run, ``embed_mode`` ``ps`` and ``vlru``
(the host-mode HET cache), a server-side ``sgd`` and ``adam`` table, under
BSP, ASP and SSP.  Meanwhile this process runs the JAX package's
single-process reference of every run: the same graph over a local
``EmbeddingStore`` from the same rows, dense weights and feeds (the
baseline of ``tests/test_launcher.py``'s hybrid case); its ASP run is
flushed every step, as the hybrid run is at the step boundary.

Held: the losses at rtol 2e-5 (that case's bar); the final tables at
``tests/test_torch_ctr.py``'s gates (rtol 2e-5, atol 1e-6) against the
port's own single-process run of the same configuration, and against the
JAX package's (an ``adam`` table against the JAX run at that case's
table bar, its digest within 2e-4: Adam's first steps move a row by
about lr times the sign of its gradient, so a near-zero gradient turns
the two frameworks' last-bit differences into 1.2e-6 on one element,
measured in one process without any strategy); the caches' counters
exactly; both ranks' losses and digests bit-equal; only rank 0
pushes; every rank ticks its SSP clock once a step; a checkpoint saved by
both ranks (their shards' rows included) resumes in fresh executors to
the uninterrupted losses bit for bit.  In this process:
``num_microbatches`` with PS embeddings takes the whole batch's gradient
as the JAX package does, and a device cache under the strategy is
refused by name."""
import json
import os
import pickle
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu_torch as tht                               # noqa: E402
from hetu_tpu_torch import launcher                        # noqa: E402
from hetu_tpu_torch.context import DistConfig              # noqa: E402
from hetu_tpu_torch.tools import hybrid_wdl                # noqa: E402
from _torch_ps_harness import free_ports                   # noqa: E402

VOCAB, DIM, BATCH, STEPS = 520, 4, 8, 5
LR = hybrid_wdl.LR
MODES, OPTS, BSPS = ("ps", "vlru"), ("sgd", "adam"), (0, -1, 2)
RESUME_AT = 2
LOSS_RTOL = 2e-5
TABLE_TOL = dict(rtol=2e-5, atol=1e-6)
DEADLINE = 240


def jax_run(mode, opt, bsp, weights=None, steps=STEPS, **ex_kw):
    """The JAX package's single-process run of one configuration over a
    local store: (losses, final table, cache counters, initial weights)."""
    import hetu_tpu as jht
    from hetu_tpu.ps import DistCacheTable
    from test_torch_ps_dist import _jax_ctr
    mlp = _jax_ctr()._mlp
    store = jht.EmbeddingStore()
    t = store.init_table(VOCAB, DIM, opt=opt, lr=LR, seed=0,
                         init_scale=0.01)
    store.set_data(t, hybrid_wdl.table0(VOCAB, DIM, 1))
    dense = jht.placeholder_op("dense")
    sparse = jht.placeholder_op("sparse", dtype=np.int64)
    y_ = jht.placeholder_op("y")
    cache = None
    if mode == "vlru":
        cache = DistCacheTable(store, t, limit=max(VOCAB // 10, 256),
                               pull_bound=10, push_bound=10, policy="lru")
        emb = jht.ps_embedding_lookup_op(cache, sparse, width=DIM)
    else:
        emb = jht.ps_embedding_lookup_op((store, t), sparse, width=DIM)
    flat = jht.array_reshape_op(emb, (BATCH, 26 * DIM))
    deep = mlp(jht.concat_op(flat, dense, axis=1),
               [26 * DIM + 13, 256, 256, 1], "deep")
    wide = mlp(dense, [13, 1], "wide")
    prob = jht.sigmoid_op(wide + deep)
    loss = jht.reduce_mean_op(jht.binarycrossentropy_op(prob, y_), [0, 1])
    ex = jht.Executor({"train": [loss, jht.optim.SGDOptimizer(LR)
                                 .minimize(loss)]}, seed=0, bsp=bsp,
                      validate="off", **ex_kw)
    if weights is None:
        weights = ex.return_tensor_values()
    else:
        ex.load_dict(weights)
    losses = []
    for d, s, y in hybrid_wdl.feeds(steps, BATCH, VOCAB, 0):
        losses.append(float(np.asarray(ex.run("train", feed_dict={
            dense: d, sparse: s, y_: y})[0].asnumpy())))
        ex.ps_flush()
    stats = None
    if cache is not None:
        cache.flush()
        stats = {k: int(cache.stats[k]) for k in ("lookups", "hits",
                                                  "pushes")}
    return losses, store.pull(t, np.arange(VOCAB)), stats, weights


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """{"ranks": [rank 0's JSON, rank 1's], "jax": {run: reference},
    "out": the ranks' directory}."""
    tmp = str(tmp_path_factory.mktemp("hybrid"))
    _, _, _, weights = jax_run("ps", "sgd", 0, steps=0)
    wpath = os.path.join(tmp, "weights.pkl")
    with open(wpath, "wb") as f:
        pickle.dump(weights, f)
    ports = free_ports(3)
    args = ["--ports", f"{ports[0]},{ports[1]}", "--out", tmp,
            "--device", "cpu", "--vocab", str(VOCAB), "--dim", str(DIM),
            "--batch", str(BATCH), "--steps", str(STEPS),
            "--modes", ",".join(MODES), "--opts", ",".join(OPTS),
            "--bsps", ",".join(map(str, BSPS)), "--weights", wpath,
            "--dump-tables", "--save-resume", str(RESUME_AT)]
    config = DistConfig(num_hosts=2, hosts=["localhost"] * 2)
    procs = launcher.launch(config, hybrid_wdl.__file__, args, ssh=False,
                            coordinator_port=ports[2])
    rc = None
    try:
        ref = {(m, o, b): jax_run(m, o, b, weights)
               for o in OPTS for m in MODES for b in BSPS}
        own = {(m, o): port_run(m, o, weights) for o in OPTS for m in MODES}
        t0 = time.monotonic()
        while rc is None and time.monotonic() - t0 < DEADLINE:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                rc = next(c for c in codes if c not in (None, 0))
            elif all(c == 0 for c in codes):
                rc = 0
            else:
                time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if rc != 0:
        pytest.fail(f"the ranks exited {[p.returncode for p in procs]} "
                    f"(None: past the {DEADLINE} s deadline)")
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(2)]
    return {"ranks": ranks, "jax": ref, "port": own, "out": tmp}


def port_run(mode, opt, weights, steps=STEPS, **ex_kw):
    """The port's single-process run over a local store: (losses, final
    table)."""
    store = tht.EmbeddingStore()
    run = hybrid_wdl.Run(store, mode, opt, _Args(), None, **ex_kw)
    store.set_data(run.node.table, hybrid_wdl.table0(VOCAB, DIM, 1))
    run.ex.load_dict(weights)
    losses, _ = run.steps(hybrid_wdl.feeds(steps, BATCH, VOCAB, 0))
    run.finish()
    run.ex.close()
    return losses, store.pull(run.node.table, np.arange(VOCAB))


def _name(mode, opt, bsp):
    return f"{mode}_{opt}_bsp{bsp}"


@pytest.mark.parametrize("bsp", BSPS)
@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_match_the_jax_single_process_run(hybrid, mode, opt, bsp):
    losses, table, stats, _ = hybrid["jax"][mode, opt, bsp]
    name = _name(mode, opt, bsp)
    r0, r1 = (r["runs"][name] for r in hybrid["ranks"])
    np.testing.assert_allclose(r0["losses"], losses, rtol=LOSS_RTOL)
    got = np.load(os.path.join(hybrid["out"], name + ".npy"))
    own_losses, own_table = hybrid["port"][mode, opt]
    np.testing.assert_allclose(r0["losses"], own_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, own_table, **TABLE_TOL)
    if opt == "adam":
        assert abs(np.abs(got.astype(np.float64)).sum()
                   - np.abs(table.astype(np.float64)).sum()) < 2e-4
    else:
        np.testing.assert_allclose(got, table, **TABLE_TOL)
    # one global batch, one result: the ranks agree bit for bit
    assert r1["losses"] == r0["losses"] and r1["digest"] == r0["digest"]
    if mode == "vlru":
        # every rank's cache sees the global batch; rank 0 alone pushes,
        # as often as the JAX process's cache
        assert r0["cache"] == stats
        assert r1["cache"]["lookups"] == stats["lookups"]
        assert r1["cache"]["hits"] == stats["hits"]
        assert r1["cache"]["pushes"] == 0
    assert r0["losses"][-1] != r0["losses"][0]


def test_every_rank_ticks_its_ssp_clock_once_a_step(hybrid):
    for r in hybrid["ranks"]:
        clocks = [r["runs"][_name(m, o, 2)]["clocks"]
                  for o in OPTS for m in MODES]
        assert clocks == [[STEPS * k] * 2 for k in range(1, 5)]


def test_the_table_under_asp_and_ssp_equals_bsp(hybrid):
    """ASP is flushed at the step boundary and SSP waits on a barrier too:
    both train as BSP does, bit for bit."""
    out = hybrid["out"]
    for m in MODES:
        for o in OPTS:
            base = np.load(os.path.join(out, _name(m, o, 0) + ".npy"))
            for b in (-1, 2):
                runs = hybrid["ranks"][0]["runs"]
                assert runs[_name(m, o, b)]["losses"] == \
                    runs[_name(m, o, 0)]["losses"]
                np.testing.assert_array_equal(
                    np.load(os.path.join(out, _name(m, o, b) + ".npy")),
                    base)


def test_save_then_fresh_resume_under_the_strategy(hybrid):
    """Every rank saves (rank 0 the dense state, each rank its shard);
    fresh executors resume it and retrain the steps after it bit for
    bit."""
    for r in hybrid["ranks"]:
        res = r["resume"]
        assert res["step"] == RESUME_AT
        assert len(res["want"]) == STEPS - RESUME_AT
        assert res["got"] == res["want"]
    ckpt = os.path.join(hybrid["out"], "ckpt")
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    assert [e["file"] for e in meta["ps_tables"]] == ["ps0.bin"]
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("ps0")) == \
        ["ps0.bin.shard0", "ps0.bin.shard1"]
    assert all(r["faults"] == {"resume": 1} for r in hybrid["ranks"])
    assert [r["serving"] for r in hybrid["ranks"]] == [[0], [1]]


# -- in this process ----------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_num_microbatches_with_ps_takes_the_whole_batch(mode):
    """The JAX package without a pipeline takes the whole batch's gradient
    when a subgraph has PS embeddings; so does the port (bit-equal to its
    plain step), within the gates of the JAX run."""
    want, wtable, _, weights = jax_run(mode, "sgd", 0, steps=3,
                                       num_microbatches=2)
    plain_jax = jax_run(mode, "sgd", 0, weights, steps=3)
    assert plain_jax[0] == want
    got, table = port_run(mode, "sgd", weights, steps=3, num_microbatches=2)
    plain, ptable = port_run(mode, "sgd", weights, steps=3)
    assert got == plain and np.array_equal(table, ptable)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(table, wtable, **TABLE_TOL)


class _Args:
    batch, vocab, dim, device = BATCH, VOCAB, DIM, "cpu"


@pytest.fixture
def world1(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://"
                            + str(tmp_path / "init1"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_device_cache_under_the_strategy_is_refused_by_name(world1):
    dense = tht.placeholder_op("dense")
    sparse = tht.placeholder_op("sparse", dtype=np.int64)
    y_ = tht.placeholder_op("y")
    loss, _ = tht.models.ctr.wdl_criteo(dense, sparse, y_, BATCH,
                                        vocab=VOCAB, dim=DIM,
                                        embed_mode="vlru_dev",
                                        slab_device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"device-resident embedding caches.*"
                             r"DistCacheTable\(device=False\)"):
        tht.Executor([loss, tht.optim.SGDOptimizer(LR).minimize(loss)],
                     device="cpu", dist_strategy=tht.dist.DataParallel())


def test_world_of_one_trains_the_hybrid_graph_as_the_plain_step(world1):
    """At world size 1 the strategy over a host cache is the plain
    executor's step, bit for bit."""
    weights = jax_run("vlru", "sgd", 0, steps=0)[3]
    got = port_run("vlru", "sgd", weights, steps=3,
                   dist_strategy=tht.dist.DataParallel())
    want = port_run("vlru", "sgd", weights, steps=3)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
