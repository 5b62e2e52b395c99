"""ZeRO weight-update sharding in the port (``parallel/zero.py``,
``Executor(zero=)``, ``DataParallel(zero=)``, ``preduce_scatter_mean``)
against the port's own replicated update and the JAX package.

A module-scoped fixture spawns gloo worlds of 2 and 4 once each (the
pattern of ``tests/test_torch_parallel.py``); every rank runs every
workload, fed the global batch, while the JAX references run in the test
process.

* ``tests/test_zero.py``'s ragged MLP (w1 7x9 = 63 elements, b1 9, w2
  9x4: one bucket of 108, padded at dp 8 only; LAMB's buckets, one a
  parameter, pad 1 + 3 elements at dp 4), 10 steps of batch 8, for SGD,
  Momentum, Adam, AdamW and LAMB at stages 0-3.  Stage 1 all-reduces the
  gradients exactly as stage 0 and updates elementwise, row by row, so it
  is held to stage 0 bit for bit (losses, every variable, the fetched
  gradients).  Stages 2 and 3 reduce-scatter the gradient slab; at dp 2 a
  reduce-scatter adds the same two terms as the all-reduce, and at dp 4
  gloo's reduce-scatter of these slabs was measured to add in the same
  order as its all-reduce (every bit equal, all five optimizers), so they
  are held bit for bit too.  LAMB's trust ratio takes two norms summed
  over the ranks' rows, another order than one sum over the parameter:
  measured 1.5e-8 (dp 2) and 6.0e-8 (dp 4) apart in the variables after
  10 steps, 1.5e-8 in the gradients, held at ``LAMB_TOL``; a rank-local
  norm is off by 1e-3 and more, and fails it.  Every run is also held to
  the JAX package's ``DataParallel(num_devices=dp)`` stage-0 losses at
  ``MLP_RTOL`` (never bitwise: ROADMAP C0).
* A rank's optimizer state is ``ceil(numel / dp)`` a bucket (Adam's m and
  v, each a flat row), and at stage 3 so are its parameters
  (``memory_accounting``).
* Stage 3: ``return_tensor_values`` gathers the rows, ``load_dict`` writes
  them (a fresh stage-3 executor loaded from another's values returns
  them bit for bit and then trains as a stage-0 executor loaded the same
  way), and an eval subgraph sharing the weights sees each update.
* ``preduce_scatter_mean`` with rank 2 dead (world 4): each rank's row is
  its block of ``preduce_mean``'s result bit for bit, and the JAX
  function's under ``shard_map`` within ``SUM_TOL``.
* ``zero_counts()``: one step's bytes, as the JAX package's one trace
  records them.
* Tiny BERT (``test_torch_parallel.py``'s, Adam 1e-3, 5 steps) at stages
  2 and 3, dp 2: losses bit-equal to the port's stage 0, and within
  rtol 2e-4 of the JAX single-device run.
* Checkpoints (Adam): at dp 2, stages 1-3 save after 3 steps, a fresh
  executor loads, and its next 3 losses are the uninterrupted run's bit
  for bit; the moments are stored as ``(dp, width)`` slabs, as the JAX
  package stores them.  World 4 loads each dp-2 checkpoint (the moments
  transcoded to its layout, with the JAX package's warning) and continues
  within ``MLP_RTOL`` of the dp-2 run.  The JAX package's
  ``DataParallel(num_devices=2)``, ``zero=2`` checkpoint loads in the port
  at dp 2 and continues within ``MLP_RTOL`` of the JAX continuation.

The plan, the stage resolution and the slab packing are held to
``hetu_tpu.parallel.zero`` exactly, in this process.  The rank processes
import this module, so JAX is imported only inside functions."""
import os
import pickle
import sys
import time
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu_torch as tht                                  # noqa: E402
from hetu_tpu_torch import metrics as tmetrics                # noqa: E402
from hetu_tpu_torch.parallel import zero as tzero             # noqa: E402
from test_torch_parallel import (JOIN_TIMEOUT, bert_graph,    # noqa: E402
                                 end_world, join_world, spawn_world)

WORLDS = (2, 4)
STAGES = (0, 1, 2, 3)
#: tests/test_zero.py's ragged parameters and optimizers
SHAPES = {"w1": (7, 9), "b1": (9,), "w2": (9, 4)}
OPTS = ("sgd", "momentum", "adam", "adamw", "lamb")
MLP_STEPS, MLP_BATCH = 10, 8
MLP_RTOL = 2e-5
LAMB_TOL = dict(rtol=1e-6, atol=1e-6)
BERT_STEPS, BERT_RTOL = 5, 2e-4
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
PREDUCE_MASK = (1.0, 1.0, 0.0, 1.0)     # rank 2 dead
PREDUCE_WIDTH = 6
CKPT_STEPS = 3


def optimizer(ht, name):
    return {"sgd": lambda: ht.optim.SGDOptimizer(0.05),
            "momentum": lambda: ht.optim.MomentumOptimizer(0.05,
                                                           momentum=0.9),
            "adam": lambda: ht.optim.AdamOptimizer(0.01),
            "adamw": lambda: ht.optim.AdamWOptimizer(0.01,
                                                     weight_decay=0.01),
            "lamb": lambda: ht.optim.LambOptimizer(0.01,
                                                   weight_decay=0.01)}[name]()


def mlp(ht, opt, eval_too=False, **kw):
    """tests/test_zero.py's graph: (x, y_, params, executor); the step-1
    gradients of every parameter are fetched after the loss and the
    step; ``eval_too`` adds an "eval" subgraph of the logits."""
    rng = np.random.RandomState(0)
    x = ht.placeholder_op("x")
    y_ = ht.placeholder_op("y_")
    w1 = ht.Variable("w1", value=rng.randn(*SHAPES["w1"])
                     .astype(np.float32) * 0.3)
    b1 = ht.Variable("b1", value=np.zeros(SHAPES["b1"], np.float32))
    w2 = ht.Variable("w2", value=rng.randn(*SHAPES["w2"])
                     .astype(np.float32) * 0.3)
    h = ht.relu_op(ht.linear_op(x, w1, b1))
    logits = ht.matmul_op(h, w2)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    fetches = {"train": [loss, optimizer(ht, opt).minimize(loss)]
               + ht.gradients(loss, [w1, b1, w2])}
    if eval_too:
        fetches["eval"] = [logits]
    return x, y_, [w1, b1, w2], ht.Executor(fetches, seed=0, **kw)


def mlp_feeds():
    rng = np.random.RandomState(1)
    xv = rng.randn(MLP_BATCH, 7).astype(np.float32)
    yv = np.eye(4, dtype=np.float32)[rng.randint(0, 4, MLP_BATCH)]
    return xv, yv


# -- the port, on every rank ----------------------------------------------------

def _run_mlp(ex, x, y_, steps):
    xv, yv = mlp_feeds()
    losses, grads = [], None
    for _ in range(steps):
        out = ex.run("train", feed_dict={x: xv, y_: yv})
        losses.append(float(out[0].asnumpy()))
        if grads is None:
            grads = [g.asnumpy() for g in out[2:]]
    return losses, grads


def mlp_workloads(dp):
    """Every optimizer at every stage: losses, step-1 gradients, final
    variables, memory accounting, and each planned bucket's (numel,
    width, the element count of every state row)."""
    out = {}
    for opt in OPTS:
        for stage in STAGES:
            x, y_, _, ex = mlp(tht, opt, device="cpu", dist_strategy=dp,
                               zero=stage)
            losses, grads = _run_mlp(ex, x, y_, MLP_STEPS)
            rows = []
            for op, plan in ex._zero_plans.items():
                st = ex.opt_states[op]
                for b in plan.buckets:
                    rows.append((b.numel, b.width, [
                        tree[b.key].numel() for tree in st.values()
                        if isinstance(tree, dict)]))
            out[opt, stage] = {
                "losses": losses, "grads": grads,
                "vars": ex.return_tensor_values(),
                "mem": ex.memory_accounting(), "rows": rows,
                "planned": bool(ex._zero_plans), "zero": ex.zero}
    return out


def stage3_workloads(dp):
    """``return_tensor_values`` / ``load_dict`` round trip and the eval
    subgraph at stage 3, each beside the stage-0 executor."""
    xv, yv = mlp_feeds()
    x, y_, _, ex = mlp(tht, "adam", device="cpu", dist_strategy=dp, zero=3)
    for _ in range(2):
        ex.run("train", feed_dict={x: xv, y_: yv})
    vals = ex.return_tensor_values()
    runs = {}
    for stage in (3, 0):
        x2, y2, params, ex2 = mlp(tht, "adam", device="cpu",
                                  dist_strategy=dp, zero=stage)
        ex2.load_dict(vals)
        back = ex2.return_tensor_values()
        views = [type(ex2.var_values[p]).__name__ for p in params]
        losses, _ = _run_mlp(ex2, x2, y2, 3)
        runs[stage] = {"back": back, "losses": losses, "views": views}
    evals = {}
    for stage in (3, 0):
        x, y_, params, ex = mlp(tht, "adam", eval_too=True, device="cpu",
                                dist_strategy=dp, zero=stage)
        seq = []
        for _ in range(2):
            ex.run("train", feed_dict={x: xv, y_: yv})
            seq.append(ex.run("eval", feed_dict={x: xv})[0].asnumpy())
        evals[stage] = {"evals": seq, "views": [
            type(ex.var_values[p]).__name__ for p in params]}
    return {"vals": vals, "runs": runs, "evals": evals}


def counter_workloads(dp):
    """``zero_counts()`` after one step of each run."""
    out = {}
    for opt, stage in (("adam", 0), ("adam", 1), ("adam", 2), ("adam", 3),
                       ("lamb", 2)):
        x, y_, _, ex = mlp(tht, opt, device="cpu", dist_strategy=dp,
                           zero=stage)
        tmetrics.reset_zero_counts()
        _run_mlp(ex, x, y_, 1)
        out[opt, stage] = tmetrics.zero_counts()
    tmetrics.reset_zero_counts()
    return out


def preduce_inputs():
    """G[r]: rank r's local (dp, width) gradient slab (world 4)."""
    rng = np.random.RandomState(3)
    return rng.randn(4, 4, PREDUCE_WIDTH).astype(np.float32)


def preduce_workload(rank):
    g = torch.from_numpy(preduce_inputs()[rank])
    mask = PREDUCE_MASK[rank]
    return {"scatter": tht.dist.preduce_scatter_mean(g, mask).numpy(),
            "full": tht.dist.preduce_mean(g, mask).numpy()}


def bert_workloads(dp, weights):
    out = {}
    for stage in (0, 2, 3):
        loss, fd = bert_graph(tht.models)
        ex = tht.Executor({"train": [loss, tht.optim.AdamOptimizer(1e-3)
                                     .minimize(loss)]}, seed=0,
                          device="cpu", dist_strategy=dp, zero=stage)
        ex.load_dict(weights)
        out[stage] = [float(ex.run("train", feed_dict=fd)[0].asnumpy())
                      for _ in range(BERT_STEPS)]
    return out


def ckpt_saves(dp, tmp):
    """World 2: each stage's save → fresh executor → load → continue; the
    checkpoints stay for world 4 (a marker file says they are complete)."""
    import torch.distributed as dist
    out = {}
    for stage in (1, 2, 3):
        x, y_, _, ex = mlp(tht, "adam", device="cpu", dist_strategy=dp,
                           zero=stage)
        first, _ = _run_mlp(ex, x, y_, CKPT_STEPS)
        path = os.path.join(tmp, f"dp2_stage{stage}")
        ex.save(path)
        x2, y2, _, ex2 = mlp(tht, "adam", device="cpu", dist_strategy=dp,
                             zero=stage)
        ex2.load(path)
        out[stage] = {"first": first, "step": ex2.step_counter,
                      "next": _run_mlp(ex2, x2, y2, CKPT_STEPS)[0]}
    if dist.get_rank() == 0:
        with open(os.path.join(tmp, "dp2.tmp"), "w") as f:
            f.write("done")
        os.replace(os.path.join(tmp, "dp2.tmp"),
                   os.path.join(tmp, "dp2.done"))
    return out


def ckpt_loads_transcoded(dp, tmp, deadline):
    """World 4: each dp-2 checkpoint loaded and continued."""
    import warnings
    while not os.path.exists(os.path.join(tmp, "dp2.done")):
        if time.monotonic() > deadline:
            raise TimeoutError("the dp-2 checkpoints never appeared")
        time.sleep(0.2)
    out = {}
    for stage in (1, 2, 3):
        x, y_, _, ex = mlp(tht, "adam", device="cpu", dist_strategy=dp,
                           zero=stage)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ex.load(os.path.join(tmp, f"dp2_stage{stage}"))
        out[stage] = {"next": _run_mlp(ex, x, y_, CKPT_STEPS)[0],
                      "warned": any("transcoding" in str(w.message)
                                    for w in caught)}
    return out


def rank_main(rank, world, init_file, out_dir, weights_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    clean = False
    try:
        dist.init_process_group("gloo", init_method="file://" + init_file,
                                rank=rank, world_size=world)
        dp = tht.dist.DataParallel()
        tmp = os.path.dirname(out_dir)
        res = {}
        if world == 2:
            res["ckpt"] = ckpt_saves(dp, tmp)
            x, y_, _, ex = mlp(tht, "adam", device="cpu", dist_strategy=dp,
                               zero=2)
            ex.load(os.path.join(tmp, "jax_zero2"))
            res["from_jax"] = _run_mlp(ex, x, y_, CKPT_STEPS)[0]
        res.update({"mlp": mlp_workloads(dp),
                    "stage3": stage3_workloads(dp),
                    "counts": counter_workloads(dp)})
        if world == 4:
            res["ckpt"] = ckpt_loads_transcoded(
                dp, tmp, time.monotonic() + JOIN_TIMEOUT)
        x, y_, _, ex = mlp(tht, "adam", device="cpu",
                           dist_strategy=tht.dist.DataParallel(zero=1))
        res["strategy_zero"] = (ex.zero, bool(ex._zero_plans),
                                _run_mlp(ex, x, y_, MLP_STEPS)[0])
        if world == 4:
            res["preduce"] = preduce_workload(rank)
        if world == 2:
            with open(weights_path, "rb") as f:
                res["bert"] = bert_workloads(dp, pickle.load(f))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        clean = True
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        end_world(clean)


# -- the JAX references, in the test process ---------------------------------------

def jax_references(jht, jbert, tmp):
    """Tiny BERT's initial weights and the ``zero=2`` dp-2 checkpoint
    (``<tmp>/jax_zero2``, written after 3 steps) first; then the BERT
    single-device losses, that checkpoint's continuation and the ragged
    MLP's ``DataParallel(num_devices=dp)`` stage-0 losses of every
    optimizer."""
    loss, fd = bert_graph(jbert)
    ex = jht.Executor({"train": [loss, jht.optim.AdamOptimizer(1e-3)
                                 .minimize(loss)]}, seed=11, validate="off")
    ref = {"weights": ex.return_tensor_values()}
    xv, yv = mlp_feeds()
    zx, zy, _, zex = mlp(jht, "adam", dist_strategy=jht.dist.DataParallel(
        num_devices=2), zero=2, validate="off")
    for _ in range(CKPT_STEPS):
        zex.run("train", feed_dict={zx: xv, zy: yv})
    zex.save(os.path.join(tmp, "jax_zero2"))
    yield ref
    ref["jax_zero2_next"] = [
        float(np.asarray(zex.run("train", feed_dict={zx: xv, zy: yv})[0]
                         .asnumpy())) for _ in range(CKPT_STEPS)]
    ref["bert"] = [float(np.asarray(ex.run("train", feed_dict=fd)[0]
                                    .asnumpy())) for _ in range(BERT_STEPS)]
    for world in WORLDS:
        for opt in OPTS:
            x, y_, _, jex = mlp(jht, opt, dist_strategy=jht.dist
                                .DataParallel(num_devices=world), zero=0,
                                validate="off")
            ref[opt, world] = [
                float(np.asarray(jex.run("train", feed_dict={x: xv, y_: yv})
                                 [0].asnumpy())) for _ in range(MLP_STEPS)]
    yield ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the JAX references, world: [each rank's results]}."""
    import hetu_tpu as jht
    from hetu_tpu.models import bert as jbert
    tmp = str(tmp_path_factory.mktemp("zero"))
    refs = jax_references(jht, jbert, tmp)
    ref = next(refs)
    weights_path = os.path.join(tmp, "weights.pkl")
    with open(weights_path, "wb") as f:
        pickle.dump(ref["weights"], f)
    deadline = time.monotonic() + JOIN_TIMEOUT
    started = {w: spawn_world(w, tmp, rank_main, weights_path)
               for w in WORLDS}
    try:
        ref = next(refs)
    finally:
        out = {w: join_world(*started[w], deadline) for w in WORLDS}
    out["ref"] = ref
    out["tmp"] = tmp
    return out


# -- the cases ---------------------------------------------------------------------

def _same(a, b):
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_update_matches_the_replicated_one(runs, world, opt, stage):
    """Bit for bit (see the module docstring), LAMB at ``LAMB_TOL``;
    every rank returns the same bits."""
    base = runs[world][0]["mlp"][opt, 0]
    got = runs[world][0]["mlp"][opt, stage]
    assert got["planned"] and not base["planned"] and got["zero"] == stage
    if opt == "lamb":
        np.testing.assert_allclose(got["losses"], base["losses"], **LAMB_TOL)
        for g, w in zip(got["grads"], base["grads"]):
            np.testing.assert_allclose(g, w, **LAMB_TOL)
        for k, v in base["vars"].items():
            np.testing.assert_allclose(got["vars"][k], v, err_msg=k,
                                       **LAMB_TOL)
    else:
        assert got["losses"] == base["losses"]
        for g, w in zip(got["grads"], base["grads"]):
            np.testing.assert_array_equal(g, w)
        _same(base["vars"], got["vars"])
    for other in runs[world][1:]:
        rec = other["mlp"][opt, stage]
        assert rec["losses"] == got["losses"]
        _same(got["vars"], rec["vars"])


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("world", WORLDS)
def test_every_stage_matches_jax_stage0(runs, world, opt):
    want = runs["ref"][opt, world]
    for stage in STAGES:
        np.testing.assert_allclose(runs[world][0]["mlp"][opt, stage]
                                   ["losses"], want, rtol=MLP_RTOL,
                                   err_msg=f"stage {stage}")


@pytest.mark.parametrize("world", WORLDS)
def test_a_rank_holds_ceil_numel_over_dp_of_each_bucket(runs, world):
    for opt in ("momentum", "adam", "lamb"):
        for stage in (1, 2, 3):
            rec = runs[world][0]["mlp"][opt, stage]
            want_buckets = [63, 9, 36] if opt == "lamb" else [108]
            assert [n for n, _, _ in rec["rows"]] == want_buckets
            for numel, width, leaves in rec["rows"]:
                assert width == -(-numel // world)
                assert leaves and all(n == width for n in leaves)
            mem, base = rec["mem"], runs[world][0]["mlp"][opt, 0]["mem"]
            widths = sum(w for _, w, _ in rec["rows"])
            moments = 2 if opt != "momentum" else 1
            scalar = 4 if opt != "momentum" else 0          # Adam's t
            assert mem["opt_state_bytes_per_device"] == \
                moments * widths * 4 + scalar
            assert base["opt_state_bytes_per_device"] == \
                moments * 108 * 4 + scalar
            assert mem["zero_stage"] == stage and base["zero_stage"] == 0
            if stage == 3:
                assert mem["param_bytes_per_device"] == 0
                assert mem["zero_slab_bytes_per_device"] == widths * 4
            else:
                assert mem["param_bytes_per_device"] == 108 * 4
            assert mem["grad_bytes_per_device"] == (
                widths * 4 if stage >= 2 else
                sum(-(-n // world) * world for n, _, _ in rec["rows"]) * 4)


@pytest.mark.parametrize("world", WORLDS)
def test_stage3_values_round_trip_through_load_dict(runs, world):
    for rank, res in enumerate(runs[world]):
        st = res["stage3"]
        assert st["vals"]["w1"].shape == SHAPES["w1"]
        _same(st["vals"], runs[world][0]["stage3"]["vals"])
        for stage in (3, 0):
            _same(st["vals"], st["runs"][stage]["back"])
        assert st["runs"][3]["views"] == ["_ZeroView"] * 3
        assert st["runs"][3]["losses"] == st["runs"][0]["losses"]


@pytest.mark.parametrize("world", WORLDS)
def test_stage3_eval_subgraph_sees_the_current_weights(runs, world):
    ev = runs[world][0]["stage3"]["evals"]
    assert ev[3]["views"] == ["_ZeroView"] * 3      # still rows after eval
    assert ev[0]["views"] == ["Tensor"] * 3
    assert not np.array_equal(ev[3]["evals"][0], ev[3]["evals"][1])
    for a, b in zip(ev[3]["evals"], ev[0]["evals"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_zero_counts_one_step(runs, world):
    """One step's bytes: 108 elements, 432 bytes, no pad at dp 2 and 4;
    LAMB's per-parameter buckets pad 63 and 9 elements at dp 4 (1 + 3
    elements, 16 bytes) and 63, 9 at dp 2 (1 + 1, 8 bytes)."""
    c = runs[world][0]["counts"]
    assert c["adam", 0] == {}
    assert c["adam", 1] == {"zero_all_gather_bytes": 432}
    assert c["adam", 2] == {"zero_reduce_scatter_bytes": 432,
                            "zero_all_gather_bytes": 432}
    # stage 3 gathers at the top of the step, not after the update
    assert c["adam", 3] == {"zero_reduce_scatter_bytes": 432,
                            "zero_all_gather_bytes": 432}
    pad = {2: 8, 4: 16}[world]
    padded = sum(-(-n // world) * world for n in (63, 9, 36)) * 4
    assert c["lamb", 2] == {"zero_reduce_scatter_bytes": padded,
                            "zero_all_gather_bytes": padded,
                            "zero_pad_bytes": pad}


def test_zero_counts_match_the_jax_packages_one_trace(runs):
    """The JAX package records once a trace, the port once a step: one
    step of stage 2 at dp 4 is the same bytes in both."""
    import hetu_tpu as jht
    from hetu_tpu.graph import step_cache
    from hetu_tpu.metrics import reset_zero_counts, zero_counts
    step_cache.clear()
    reset_zero_counts()
    x, y_, _, jex = mlp(jht, "adam", dist_strategy=jht.dist.DataParallel(
        num_devices=4), zero=2, validate="off")
    xv, yv = mlp_feeds()
    jex.run("train", feed_dict={x: xv, y_: yv})
    want = zero_counts()
    reset_zero_counts()
    assert runs[4][0]["counts"]["adam", 2] == want


def test_strategy_zero_is_read_when_the_keyword_is_absent(runs):
    for world in WORLDS:
        for r in runs[world]:
            assert r["strategy_zero"] == (
                1, True, runs[world][0]["mlp"]["adam", 1]["losses"])


def test_preduce_scatter_mean_with_a_dead_rank_matches_jax(runs):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from hetu_tpu.parallel.preduce import preduce_scatter_mean
    G = preduce_inputs()
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    m = np.array(PREDUCE_MASK, np.float32).reshape(4, 1)
    want = np.asarray(jax.shard_map(
        lambda g, k: preduce_scatter_mean(g[0], k[0, 0], "dp")[None],
        mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=P("dp"),
        check_vma=False)(G, m))
    expect = (G * np.array(PREDUCE_MASK)[:, None, None]).sum(0) \
        / sum(PREDUCE_MASK)
    for r in range(4):
        got = runs[4][r]["preduce"]
        assert got["scatter"].shape == (1, PREDUCE_WIDTH)
        np.testing.assert_array_equal(got["scatter"], got["full"][r:r + 1])
        np.testing.assert_allclose(got["full"], expect, **SUM_TOL)
        np.testing.assert_allclose(got["scatter"], want[r], **SUM_TOL)


@pytest.mark.parametrize("stage", [2, 3])
def test_tiny_bert_sharded_matches_stage0_and_jax(runs, stage):
    got = runs[2][0]["bert"]
    assert got[stage] == got[0]
    np.testing.assert_allclose(got[stage], runs["ref"]["bert"],
                               rtol=BERT_RTOL)
    assert got[stage][-1] < got[stage][0]
    assert runs[2][1]["bert"][stage] == got[stage]


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_checkpoint_round_trip_is_bit_equal(runs, stage):
    whole = runs[2][0]["mlp"]["adam", stage]["losses"]
    for res in runs[2]:
        got = res["ckpt"][stage]
        assert got["step"] == CKPT_STEPS
        assert got["first"] == whole[:CKPT_STEPS]
        assert got["next"] == whole[CKPT_STEPS:2 * CKPT_STEPS]
    # the moments as the JAX package stores them: (dp, width) slabs
    import json
    path = os.path.join(runs["tmp"], f"dp2_stage{stage}")
    with open(os.path.join(path, "meta.json")) as f:
        leaves = json.load(f)["opt"][0]["leaves"]
    slabs = [k for k in leaves if k.endswith(".zb0']")]
    assert sorted(k.split("']")[0] for k in slabs) == ["['m", "['v"]
    for k in slabs:
        assert np.load(os.path.join(path, "opt", leaves[k])).shape == \
            (2, 54)
    if stage == 2:
        with open(os.path.join(runs["tmp"], "jax_zero2", "meta.json")) as f:
            assert json.load(f)["opt"][0]["leaves"] == leaves


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_dp2_checkpoint_loads_transcoded_at_dp4(runs, stage):
    want = runs[2][0]["mlp"]["adam", stage]["losses"][
        CKPT_STEPS:2 * CKPT_STEPS]
    for res in runs[4]:
        got = res["ckpt"][stage]
        assert got["warned"]
        np.testing.assert_allclose(got["next"], want, rtol=MLP_RTOL)
        assert got["next"] == runs[4][0]["ckpt"][stage]["next"]


def test_jax_zero2_checkpoint_continues_in_the_port(runs):
    for res in runs[2]:
        np.testing.assert_allclose(res["from_jax"],
                                   runs["ref"]["jax_zero2_next"],
                                   rtol=MLP_RTOL)


# -- plans, stages and slabs against the JAX package, in this process ---------------

def _plan_fields(plan):
    return (plan.stage, plan.dp, plan.axis, plan.param_keys,
            [(b.key, b.param_keys, b.shapes, b.offsets, b.numel, b.dp,
              b.dtype, b.padded, b.pad, b.width, b.nbytes)
             for b in plan.buckets])


@pytest.mark.parametrize("case", ["ragged", "by_size_and_dtype",
                                  "per_param", "prefix"])
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_build_plan_equals_the_jax_packages(case, dp):
    from hetu_tpu.parallel import zero as jzero
    items = [(k, s, "float32") for k, s in SHAPES.items()]
    kw = {}
    if case == "by_size_and_dtype":
        items = [("p0", (1024,), "float32"), ("p1", (1024,), "float32"),
                 ("p2", (1024,), "float32"), ("h0", (64,), "float16"),
                 ("s0", (), "float32")]
        kw = dict(max_bytes=2 * 1024 * 4)
    elif case == "per_param":
        kw = dict(per_param=True)
    elif case == "prefix":
        kw = dict(prefix="t7.")
    got, want = (m.build_plan(items, dp, 2, **kw) for m in (tzero, jzero))
    assert _plan_fields(got) == _plan_fields(want)


def test_bucket_bytes_and_stages_equal_the_jax_packages(monkeypatch):
    from hetu_tpu.parallel import zero as jzero
    assert (tzero.ZERO_AXIS, tzero.DEFAULT_BUCKET_MB) == \
        (jzero.ZERO_AXIS, jzero.DEFAULT_BUCKET_MB)
    for env in (None, "1.5", "0", "junk"):
        if env is None:
            monkeypatch.delenv("HETU_ZERO_BUCKET_MB", raising=False)
        else:
            monkeypatch.setenv("HETU_ZERO_BUCKET_MB", env)
        assert tzero.bucket_bytes() == jzero.bucket_bytes()
    for v in (None, False, True, 0, 1, 2, 3, "2"):
        assert tzero.resolve_stage(v) == jzero.resolve_stage(v)
    for v in (5, -1, "on"):
        with pytest.raises(ValueError, match="0..3"):
            tzero.resolve_stage(v)
    assert tzero.ineligible_reason(None, "float32") is None
    assert "int32" in tzero.ineligible_reason(None, "int32")


def test_slab_packing_equals_the_jax_packages():
    from hetu_tpu.parallel import zero as jzero
    rng = np.random.RandomState(7)
    vals = {"a": rng.randn(3, 5).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": np.float32(rng.randn()).reshape(())}
    items = [(k, v.shape, v.dtype.name) for k, v in vals.items()]
    plan = tzero.build_plan(items, dp=4, stage=2)
    b = plan.buckets[0]
    assert (b.numel, b.padded, b.pad, b.width) == (23, 24, 1, 6)
    jb = jzero.build_plan(items, dp=4, stage=2).buckets[0]
    host = tzero.host_pack_slab(vals, b)
    np.testing.assert_array_equal(host, jzero.host_pack_slab(vals, jb))
    dev = tzero.pack_slab({k: torch.as_tensor(np.asarray(v))
                           for k, v in vals.items()},
                          b)
    assert tuple(dev.shape) == (4, 6)
    np.testing.assert_array_equal(dev.numpy(), host)
    for unpacked in (tzero.host_unpack_slab(host, b),
                     {k: t.numpy() for k, t in tzero.unpack_slab(dev, b)
                      .items()}):
        for k, v in vals.items():
            assert unpacked[k].shape == v.shape
            np.testing.assert_array_equal(unpacked[k], v)
    np.testing.assert_array_equal(tzero.row_of(dev, 3).numpy(), host[3])


def test_zero_without_a_strategy_or_at_world_one_is_the_plain_step(
        tmp_path, monkeypatch):
    """No plan without a strategy, nor at world size 1: ``zero=`` (or
    ``HETU_ZERO``) leaves the plain step's bits."""
    import torch.distributed as dist
    xv, yv = mlp_feeds()
    base = None
    monkeypatch.setenv("HETU_ZERO", "3")
    for kw in ({"zero": 0}, {}, {"zero": 2}):
        x, y_, _, ex = mlp(tht, "adam", device="cpu", **kw)
        assert not ex._zero_plans
        losses, _ = _run_mlp(ex, x, y_, 3)
        base = base or losses
        assert losses == base
    assert ex.zero == 2
    dist.init_process_group("gloo", init_method="file://"
                            + str(tmp_path / "init1"), rank=0, world_size=1)
    try:
        x, y_, _, ex = mlp(tht, "adam", device="cpu",
                           dist_strategy=tht.dist.DataParallel(zero=3))
        assert ex.zero == 3 and not ex._zero_plans
        assert _run_mlp(ex, x, y_, 3)[0] == base
    finally:
        dist.destroy_process_group()
