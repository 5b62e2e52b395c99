"""Data-parallel training in the port (``Executor(dist_strategy=
ht.dist.DataParallel())`` over ``torch.distributed`` with gloo on the CPU)
against the JAX package's single-device run and its
``DataParallel(num_devices=dp)`` run on the 8-device CPU mesh of
``tests/conftest.py``.

A module-scoped fixture spawns world 2 and world 4 once each (one torch
thread a rank, ``init_method`` a file under ``tmp_path``); every rank
runs every workload, fed the global batch, and writes its results.  The
JAX references run in the test process meanwhile.  A rank that fails or
hangs past ``JOIN_TIMEOUT`` fails the fixture, with its traceback.  The
rank processes import this module to reach their entry point, so JAX is
imported only inside the reference functions.

Workloads, dropout off in every parity run (as every parity test of the
port runs), the port loaded with the JAX ``Executor``'s initial weights
by name:

* the MLP of ``tests/test_parallel.py`` under Momentum (6 steps, batch 64)
  and Adam (4 steps, batch 32): losses rtol 2e-5, that file's gate;
* tiny BERT (``BertConfig.tiny(batch_size=16, seq_len=32)``, Adam 1e-3,
  5 steps, one fixed ``synthetic_mlm_batch``): losses rtol 2e-4; step-1
  gradients of every parameter against the JAX single-device gradients at
  ``test_torch_bert.py``'s gate (rtol 1e-4, atol 1e-6).  The masked MLM
  loss is a ratio of two batch sums, so a per-rank loss, or a gradient
  off by a factor of dp, fails here;
* ResNet-18 at full width, batch 4 (dp 4 leaves one sample a rank),
  Momentum 0.1, 3 steps, at ``test_torch_cnn.py``'s float32 gates
  (``TRAJ_TOL``, ``GRAD_TOL``, ``STATS_TOL``): the losses, the step-1
  gradients and the running statistics by name after every step against
  the port's single-device ``Executor`` on the global batch (rank 0 runs
  it), and the step-1 loss, the step-1 gradients and the statistics after
  step 1 against the JAX single-device run.  BatchNorm's statistics are
  global (sync BN).  This batch holds a ReLU tie: one element of the
  first residual block's output pre-activation is -7.1e-7 in the port
  and +9.8e-7 in the JAX package, so that ReLU passes its gradient in one
  package and stops it in the other, and the eight gradients below it in
  backprop (``TIE_REACHED``) move by up to 7.9e-3 of their norm, in the
  port's single-device run as in its data-parallel one (which agree to
  2e-6).  The statistics after the last step are held, as
  ``test_torch_cnn.py`` holds its last step, to ``STATS_LAST_RELNORM`` a
  variable: two updates at lr 0.1 on four samples carry the summation
  order of the sums over ranks to 1e-3 of an element (4.0e-4 of a
  variable's norm at most, dp 4).  Those eight are held to the JAX package to a relative norm of
  ``TIE_RELNORM`` (``test_torch_cnn.py``'s gate for the same one-ReLU
  effect), and the later losses, which the changed update moves by
  1.1e-3 at step 2, to the JAX package's single-device run and its
  ``DataParallel(num_devices=dp)`` run at ``TIE_LOSS_TOL`` (to the port's
  single-device run at ``TRAJ_TOL``);
* the Momentum MLP fed by ``DataloaderOp``s, whole (``dp_nrank=1``) and
  already cut to each rank's shard: the same losses as the feed dict;
* a dropout graph: rank 0 draws the single-device mask, the other ranks
  masks of their own, and the sharded output is gathered to the global
  batch on every rank.

Every rank returns the same losses, gradients and variables, BatchNorm's
running statistics included, bit for bit.
"""
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

import hetu_tpu_torch as tht                                  # noqa: E402
from hetu_tpu_torch.parallel.batch_axis import BatchAxis      # noqa: E402

WORLDS = (2, 4)
JOIN_TIMEOUT = 240
#: (graph seed, data seed, batch, steps) of tests/test_parallel.py's MLPs
MLP = {"momentum": (0, 1, 64, 6), "adam": (3, 2, 32, 4)}
MLP_RTOL = 2e-5
BERT_STEPS, BERT_RTOL = 5, 2e-4
BERT_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
RN_BATCH, RN_STEPS = 4, 3
# tests/test_torch_cnn.py's float32 gates
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
STATS_LAST_RELNORM = 2e-2
DROP_ROWS = 8
#: the ResNet-18 step-1 gradients below the ReLU tie (module docstring)
TIE_REACHED = ("stem_weight", "stem_bn_scale", "stem_bn_bias",
               "s0b0_c1_weight", "s0b0_bn1_scale", "s0b0_bn1_bias",
               "s0b0_c2_weight", "s0b0_bn2_bias")
TIE_RELNORM = 1e-2                      # test_torch_cnn.ZOO_GRAD_RELNORM
#: the later ResNet-18 losses against the JAX package (measured 1.1e-3 at
#: step 2; step 3's loss is 2.5e-5, held by TRAJ_TOL's atol)
TIE_LOSS_TOL = dict(rtol=5e-3, atol=1e-5)


# -- graphs, built the same way in both packages ------------------------------

def mlp_graph(ht, seed, x=None, y_=None):
    rng = np.random.RandomState(seed)
    x = ht.placeholder_op("x") if x is None else x
    y_ = ht.placeholder_op("y_") if y_ is None else y_
    w1 = ht.Variable("w1", value=rng.randn(16, 32).astype(np.float32) * 0.1)
    w2 = ht.Variable("w2", value=rng.randn(32, 4).astype(np.float32) * 0.1)
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    return x, y_, loss


def mlp_optimizer(ht, kind):
    return ht.optim.MomentumOptimizer(0.1, momentum=0.9) \
        if kind == "momentum" else ht.optim.AdamOptimizer(0.01)


def mlp_feeds(kind):
    _, seed, batch, _ = MLP[kind]
    rng = np.random.RandomState(seed)
    xv = rng.randn(batch, 16).astype(np.float32)
    yv = np.eye(4, dtype=np.float32)[rng.randint(0, 4, batch)]
    return xv, yv


def bert_graph(models):
    cfg = models.BertConfig.tiny(batch_size=16, seq_len=32,
                                 hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    feeds, loss, _ = models.bert_pretrain_graph(cfg)
    ids, tt, labels, attn = models.synthetic_mlm_batch(cfg, seed=0)
    fd = {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
          feeds["masked_lm_labels"]: labels,
          feeds["attention_mask"]: attn}
    return loss, fd


def resnet_graph(ht, resnet18):
    x = ht.placeholder_op("x", shape=(RN_BATCH, 3, 32, 32))
    y = ht.placeholder_op("y", shape=(RN_BATCH, 10))
    loss, _ = resnet18(x, y)
    rng = np.random.RandomState(0)
    fd = {x: rng.rand(RN_BATCH, 3, 32, 32).astype(np.float32),
          y: np.eye(10, dtype=np.float32)[rng.randint(0, 10, RN_BATCH)]}
    return loss, fd


def trainable(loss, topo):
    return [n for n in topo([loss])
            if getattr(n, "is_variable", False) and n.trainable]


def _stats(values):
    return {k: v for k, v in values.items() if "_running_" in k}


def train(ht, ex, loss, fd, steps, wrt):
    """Losses, step-1 gradients by name, running statistics after every
    step, final variables."""
    losses, grads, stats = [], None, []
    for _ in range(steps):
        out = ex.run("train", feed_dict=fd)
        losses.append(float(np.asarray(out[0].asnumpy())))
        if grads is None:
            grads = {n.name: np.asarray(g.asnumpy())
                     for n, g in zip(wrt, out[2:])}
        stats.append(_stats(ex.return_tensor_values()))
    return {"losses": losses, "grads": grads, "stats": stats,
            "vars": ex.return_tensor_values()}


# -- the port, on every rank ----------------------------------------------------

def port_workloads(weights):
    """Every workload through ``DataParallel`` on this rank."""
    dp = tht.dist.DataParallel()
    res = {}
    for kind, (gseed, _, _, steps) in MLP.items():
        x, y_, loss = mlp_graph(tht, gseed)
        ex = tht.Executor({"train": [loss, mlp_optimizer(tht, kind)
                                     .minimize(loss)]},
                          device="cpu", dist_strategy=dp)
        xv, yv = mlp_feeds(kind)
        res["mlp_" + kind] = train(tht, ex, loss, {x: xv, y_: yv}, steps,
                                   [])["losses"]
    for name, (loss, fd), opt, steps in (
            ("bert", bert_graph(tht.models), tht.optim.AdamOptimizer(1e-3),
             BERT_STEPS),
            ("resnet", resnet_graph(tht, tht.models.resnet18),
             tht.optim.MomentumOptimizer(0.1), RN_STEPS)):
        wrt = trainable(loss, tht.topo_sort)
        ex = tht.Executor({"train": [loss, opt.minimize(loss)]
                           + tht.gradients(loss, wrt)},
                          device="cpu", dist_strategy=dp)
        ex.load_dict(weights[name])
        res[name] = train(tht, ex, loss, fd, steps, wrt)
    import torch.distributed as dist
    if dist.get_rank() == 0:
        res["resnet_single"] = port_resnet_single(weights["resnet"])
    res["loader"] = loader_workload(dp)
    res["dropout"] = dropout_workload(dp)
    res["refused"] = refused_workload(dp)
    return res


def port_resnet_single(weights):
    """ResNet-18 through the plain executor on the global batch."""
    loss, fd = resnet_graph(tht, tht.models.resnet18)
    wrt = trainable(loss, tht.topo_sort)
    ex = tht.Executor({"train": [loss, tht.optim.MomentumOptimizer(0.1)
                                 .minimize(loss)] + tht.gradients(loss, wrt)},
                      device="cpu")
    ex.load_dict(weights)
    return train(tht, ex, loss, fd, RN_STEPS, wrt)


def loader_workload(dp):
    """The Momentum MLP fed by DataloaderOps holding the whole dataset
    (one global batch an epoch, split like a feed) and holding this
    rank's shard of it."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    xv, yv = mlp_feeds("momentum")
    out = {}
    for how, kw in (("whole", {}),
                    ("shard", dict(dp_rank=rank, dp_nrank=world))):
        batch = len(xv) // (world if kw else 1)
        x = tht.dataloader_op([tht.Dataloader(xv, batch, "train", **kw)])
        y_ = tht.dataloader_op([tht.Dataloader(yv, batch, "train", **kw)])
        gseed, _, _, steps = MLP["momentum"]
        _, _, loss = mlp_graph(tht, gseed, x, y_)
        ex = tht.Executor({"train": [loss, mlp_optimizer(tht, "momentum")
                                     .minimize(loss)]},
                          device="cpu", dist_strategy=dp)
        out[how] = [float(ex.run("train")[0].asnumpy())
                    for _ in range(steps)]
        ex.close()
    return out


def dropout_workload(dp):
    """The gathered output of one dropout step over a (DROP_ROWS, 16)
    batch of ones, under the strategy and (every rank) alone."""
    x = tht.placeholder_op("x")
    out = tht.dropout_op(x, 0.5)
    ones = np.ones((DROP_ROWS, 16), np.float32)
    got = {}
    for tag, kw in (("dp", dict(dist_strategy=dp)), ("single", {})):
        ex = tht.Executor({"train": [out]}, device="cpu", seed=5, **kw)
        got[tag] = ex.run("train", feed_dict={x: ones})[0].asnumpy()
    return got


def refused_workload(dp):
    """What every rank raises (so no rank is left in a collective): a
    feed whose dim 0 does not divide by dp, and a dataloader holding a
    shard of another group."""
    msgs = {}
    x, y_, loss = mlp_graph(tht, 0)
    ex = tht.Executor({"train": [loss]}, device="cpu", dist_strategy=dp)
    try:
        ex.run("train", feed_dict={x: np.zeros((3, 16), np.float32),
                                   y_: np.zeros((3, 4), np.float32)})
    except ValueError as e:
        msgs["feed"] = str(e)
    xl = tht.dataloader_op([tht.Dataloader(np.zeros((6, 16)), 2, "train",
                                           dp_rank=0, dp_nrank=3)])
    try:
        tht.Executor({"train": [tht.reduce_sum_op(xl)]}, device="cpu",
                     dist_strategy=dp)
    except ValueError as e:
        msgs["loader"] = str(e)
    return msgs


def rank_main(rank, world, init_file, out_dir, weights_path):
    """Entry of one rank: gloo over ``init_file``, every workload, the
    results (or the traceback) under ``out_dir``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + init_file,
                                rank=rank, world_size=world)
        with open(weights_path, "rb") as f:
            weights = pickle.load(f)
        res = port_workloads(weights)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(world, tmp, target, *args):
    """Start ``world`` ranks of ``target(rank, world, init_file, out_dir,
    *args)``; returns (processes, out_dir)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out_dir = os.path.join(tmp, f"world{world}")
    os.makedirs(out_dir)
    init_file = os.path.join(tmp, f"init{world}")
    procs = [ctx.Process(target=target,
                         args=(r, world, init_file, out_dir) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out_dir


def join_world(procs, out_dir, deadline):
    """Each rank's results; fails on a rank that exits non-zero or outlives
    ``deadline`` (every rank is then killed)."""
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errs = [open(os.path.join(out_dir, f)).read()
            for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
    if errs or codes != [0] * len(procs):
        pytest.fail(f"ranks exited {codes} (None: hung past the deadline)\n"
                    + "\n".join(errs))
    out = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the JAX references, in the test process -------------------------------------

def jax_references(jht, jbert, jresnet18):
    """Every workload in the JAX package: single-device (losses, step-1
    gradients, running statistics), ``DataParallel(num_devices=dp)`` for
    each world (losses), and the initial weights of BERT and ResNet-18 for
    the port."""
    from hetu_tpu.graph.node import topo_sort as jtopo
    ref = {"weights": {}}

    def executor(fetches, seed, strategy):
        return jht.Executor({"train": fetches}, seed=seed,
                            dist_strategy=strategy, validate="off")

    def build(name, strategy):
        if name.startswith("mlp_"):
            kind = name[4:]
            x, y_, loss = mlp_graph(jht, MLP[kind][0])
            xv, yv = mlp_feeds(kind)
            ex = executor([loss, mlp_optimizer(jht, kind).minimize(loss)],
                          0, strategy)
            return ex, loss, {x: xv, y_: yv}, MLP[kind][3], []
        if name == "bert":
            loss, fd = bert_graph(jbert)
            opt, steps, seed = jht.optim.AdamOptimizer(1e-3), BERT_STEPS, 11
        else:
            loss, fd = resnet_graph(jht, jresnet18)
            opt, steps, seed = jht.optim.MomentumOptimizer(0.1), RN_STEPS, 0
        wrt = trainable(loss, jtopo)
        ex = executor([loss, opt.minimize(loss)] + jht.gradients(loss, wrt),
                      seed, strategy)
        return ex, loss, fd, steps, wrt

    names = ["mlp_momentum", "mlp_adam", "bert", "resnet"]
    built = {n: build(n, None) for n in names}
    for n in ("bert", "resnet"):
        ref["weights"][n] = built[n][0].return_tensor_values()
    yield ref                     # the weights, before any step is taken
    for n in names:
        ex, loss, fd, steps, wrt = built[n]
        ref[n] = train(jht, ex, loss, fd, steps, wrt)
        for world in WORLDS:
            ex, loss, fd, steps, wrt = build(
                n, jht.dist.DataParallel(num_devices=world))
            ref[(n, world)] = [float(np.asarray(ex.run(
                "train", feed_dict=fd)[0].asnumpy())) for _ in range(steps)]
    yield ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the JAX references, world: [each rank's results]}."""
    import hetu_tpu as jht
    from hetu_tpu.models import bert as jbert
    from test_torch_cnn import jax_cnn_models
    tmp = str(tmp_path_factory.mktemp("dp"))
    refs = jax_references(jht, jbert, jax_cnn_models().resnet18)
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
    return out


# -- the cases ---------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", sorted(MLP))
def test_mlp_matches_jax(runs, world, kind):
    got = runs[world][0]["mlp_" + kind]
    np.testing.assert_allclose(got, runs["ref"]["mlp_" + kind]["losses"],
                               rtol=MLP_RTOL)
    np.testing.assert_allclose(got, runs["ref"][("mlp_" + kind, world)],
                               rtol=MLP_RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_bert_losses_match_jax(runs, world):
    got = runs[world][0]["bert"]["losses"]
    np.testing.assert_allclose(got, runs["ref"]["bert"]["losses"],
                               rtol=BERT_RTOL)
    np.testing.assert_allclose(got, runs["ref"][("bert", world)],
                               rtol=BERT_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("world", WORLDS)
def test_bert_step1_gradients_match_jax_single_device(runs, world):
    got, want = runs[world][0]["bert"]["grads"], runs["ref"]["bert"]["grads"]
    assert sorted(got) == sorted(want) and len(want) > 30
    for name, g in want.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(got[name], g, err_msg=name,
                                   **BERT_GRAD_TOL)


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("world", WORLDS)
def test_resnet18_losses_match_the_single_device_port(runs, world):
    got = runs[world][0]["resnet"]["losses"]
    np.testing.assert_allclose(got, runs[world][0]["resnet_single"]
                               ["losses"], **TRAJ_TOL)
    np.testing.assert_allclose(got[0], runs["ref"]["resnet"]["losses"][0],
                               **TRAJ_TOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("world", WORLDS)
def test_resnet18_losses_match_jax(runs, world):
    """The losses against the JAX package's single-device run and its
    ``DataParallel(num_devices=dp)`` run: step 1 at ``TRAJ_TOL``, the
    later steps, which the ReLU tie's changed update moves, at
    ``TIE_LOSS_TOL``."""
    got = runs[world][0]["resnet"]["losses"]
    for want in (runs["ref"]["resnet"]["losses"],
                 runs["ref"][("resnet", world)]):
        np.testing.assert_allclose(got[0], want[0], **TRAJ_TOL)
        np.testing.assert_allclose(got[1:], want[1:], **TIE_LOSS_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_resnet18_step1_gradients_match(runs, world):
    """Every step-1 gradient: the single-device port's at ``GRAD_TOL``;
    the JAX package's at ``GRAD_TOL``, those below the ReLU tie to
    ``TIE_RELNORM``."""
    got = runs[world][0]["resnet"]["grads"]
    single = runs[world][0]["resnet_single"]["grads"]
    want = runs["ref"]["resnet"]["grads"]
    assert sorted(got) == sorted(want) == sorted(single)
    assert len(want) == 20 + 2 * 20 + 2
    for name, g in want.items():
        np.testing.assert_allclose(got[name], single[name], err_msg=name,
                                   **GRAD_TOL)
        if name in TIE_REACHED:
            assert _relnorm(got[name], g) <= TIE_RELNORM, name
        else:
            np.testing.assert_allclose(got[name], g, err_msg=name,
                                       **GRAD_TOL)


@pytest.mark.parametrize("after", range(1, RN_STEPS + 1))
@pytest.mark.parametrize("world", WORLDS)
def test_resnet18_running_stats_match(runs, world, after):
    """The 40 running statistics by name after each step: the
    single-device port's, and after step 1 the JAX package's; after the
    last step to ``STATS_LAST_RELNORM`` a variable, as
    ``test_torch_cnn.py`` holds its last step."""
    got = runs[world][0]["resnet"]["stats"][after - 1]
    refs = [runs[world][0]["resnet_single"]["stats"][after - 1]]
    if after == 1:
        refs.append(runs["ref"]["resnet"]["stats"][0])
    for want in refs:
        assert sorted(got) == sorted(want) and len(want) == 40
        for name, w in want.items():
            if after < RN_STEPS:
                np.testing.assert_allclose(got[name], w, err_msg=name,
                                           **STATS_TOL)
            else:
                assert _relnorm(got[name], w) <= STATS_LAST_RELNORM, name


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_bits(runs, world):
    """Losses, gradients and every variable (BatchNorm's running
    statistics too) equal on every rank, bit for bit."""
    first = runs[world][0]
    for other in runs[world][1:]:
        for key in ("mlp_momentum", "mlp_adam"):
            assert other[key] == first[key]
        for key in ("bert", "resnet"):
            assert other[key]["losses"] == first[key]["losses"]
            for part in ("grads", "vars"):
                for name, v in first[key][part].items():
                    np.testing.assert_array_equal(other[key][part][name], v,
                                                  err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_dataloaders_whole_and_sharded_feed_the_same_steps(runs, world):
    got = runs[world][0]["loader"]
    assert got["whole"] == got["shard"] == runs[world][0]["mlp_momentum"]


@pytest.mark.parametrize("world", WORLDS)
def test_dropout_masks_are_drawn_per_rank_and_gathered(runs, world):
    per = DROP_ROWS // world
    outs = [r["dropout"] for r in runs[world]]
    for o in outs:
        assert o["dp"].shape == (DROP_ROWS, 16)
        np.testing.assert_array_equal(o["dp"], outs[0]["dp"])
        np.testing.assert_array_equal(o["single"], outs[0]["single"])
    got, single = outs[0]["dp"], outs[0]["single"]
    assert set(np.unique(got)) <= {0.0, 2.0}
    # rank 0 draws the single-device mask: its rows are that mask's first
    np.testing.assert_array_equal(got[:per], single[:per])
    masks = [got[r * per:(r + 1) * per] for r in range(world)]
    assert all(not np.array_equal(masks[0], m) for m in masks[1:])


@pytest.mark.parametrize("world", WORLDS)
def test_undivided_feed_and_foreign_shard_raise(runs, world):
    for r in runs[world]:
        assert "does not divide" in r["refused"]["feed"]
        assert "shard 0 of 3" in r["refused"]["loader"]


# -- refusals and the batch-axis table, in this process ---------------------------

@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://"
                            + str(tmp_path / "init1"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mlp_executor(**kw):
    x, y_, loss = mlp_graph(tht, 0)
    return tht.Executor({"train": [loss, mlp_optimizer(tht, "momentum")
                                   .minimize(loss)]}, device="cpu", **kw)


@pytest.mark.parametrize("what", ["model_parallel", "mesh", "not_a_strategy",
                                  "no_group", "make_mesh_tp", "dcn_axes"])
def test_unported_strategy_arguments_raise_by_name(what):
    dp = tht.dist.DataParallel
    cases = {
        "model_parallel": (NotImplementedError, "ModelParallel",
                           lambda: tht.dist.ModelParallel({"tp": 2})),
        "mesh": (NotImplementedError, "mesh",
                 lambda: _mlp_executor(dist_strategy=dp(), mesh=object())),
        "not_a_strategy": (NotImplementedError, "dist_strategy",
                           lambda: _mlp_executor(dist_strategy=object())),
        "no_group": (RuntimeError, "init_process_group",
                     lambda: _mlp_executor(dist_strategy=dp())),
        "make_mesh_tp": (NotImplementedError, "tp",
                         lambda: tht.make_mesh({"dp": 1, "tp": 2})),
        "dcn_axes": (NotImplementedError, "dcn_axes",
                     lambda: tht.make_mesh({"dp": 2}, dcn_axes={"dp": 2})),
    }
    err, match, call = cases[what]
    with pytest.raises(err, match=match):
        call()


def test_strategy_checks_mirror_the_jax_package():
    dp = tht.dist.DataParallel(aggregate="PS", zero=False)
    assert (dp.aggregate, dp.zero) == ("ps", 0)
    assert dp.feed_spec(None, 2) == 0 and dp.feed_spec(None, 0) is None
    with pytest.raises(ValueError, match="aggregate"):
        tht.dist.DataParallel(aggregate="ring")
    with pytest.raises(ValueError, match="0..3"):
        tht.dist.DataParallel(zero=7)
    assert [tht.dist.DataParallel(zero=z).zero
            for z in (None, True, 1, 3, "2")] == [0, 2, 1, 3, 2]
    # DistPartialReduce forms a group from a store's clocks (one rank
    # here); replication=2 on a world of one runs unreplicated
    store = tht.ps.DistributedStore(0, 1)
    try:
        pr = tht.dist.DistPartialReduce(store, max_wait_ms=50.0,
                                        min_workers=1)
        pr.report_arrival(0, 0)
        assert pr.get_partner(0, 0).tolist() == [1.0]
    finally:
        store.close()
    store = tht.ps.DistributedStore(0, 1, replication=2)
    try:
        assert store.replication == 1
    finally:
        store.close()


def test_world_of_one_needs_num_devices_to_match(world1):
    mesh = tht.make_mesh()
    assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
    assert tht.dist.new_group_comm(mesh).size == 1
    with pytest.raises(NotImplementedError, match="num_devices=2"):
        _mlp_executor(dist_strategy=tht.dist.DataParallel(num_devices=2))
    with pytest.raises(ValueError, match="need 2 ranks"):
        tht.make_mesh({"dp": 2})


def test_ps_embedding_under_dist_strategy_is_refused(world1):
    ids = tht.placeholder_op("ids", dtype=np.int64)
    st = tht.EmbeddingStore()
    cache = tht.DistCacheTable(st, st.init_table(10, 3), limit=4,
                               device=True, slab_device="cpu")
    e = tht.ps_embedding_lookup_op(cache, ids)
    with pytest.raises(NotImplementedError, match="PS embedding"):
        tht.Executor([tht.reduce_sum_op(e)], device="cpu",
                     dist_strategy=tht.dist.DataParallel())


def test_world_of_one_is_the_single_device_step(world1):
    """At world size 1 the strategy's path (sync BN included) gives the
    plain executor's losses and variables."""
    from hetu_tpu_torch.models import cnn
    x = tht.placeholder_op("x", shape=(2, 3, 8, 8))
    y = tht.placeholder_op("y", shape=(2, 10))
    h = cnn.bn(cnn.conv2d(x, 3, 4, name="c"), 4, "b", relu=True)
    h = tht.array_reshape_op(h, output_shape=(-1, 4 * 8 * 8))
    loss, _ = cnn.ce_loss(cnn.fc(h, (4 * 8 * 8, 10), "f"), y)
    rng = np.random.RandomState(0)
    fd = {x: rng.rand(2, 3, 8, 8).astype(np.float32),
          y: np.eye(10, dtype=np.float32)[[1, 7]]}
    got = []
    for kw in ({}, dict(dist_strategy=tht.dist.DataParallel())):
        ex = tht.Executor({"train": [loss, tht.optim.MomentumOptimizer(0.1)
                                     .minimize(loss)]}, device="cpu",
                          seed=0, **kw)
        losses = [float(ex.run("train", feed_dict=fd)[0].asnumpy())
                  for _ in range(2)]
        got.append((losses, ex.return_tensor_values()))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-5)
    for name, v in got[0][1].items():
        np.testing.assert_allclose(got[1][1][name], v, err_msg=name,
                                   rtol=1e-4, atol=1e-5)


def test_sync_batch_norm_is_the_single_device_arithmetic_in_float64(world1):
    """ResNet-18's step-1 gradients through the batch-axis rules at world
    size 1 (sync BN, the loss's mean as a global sum) against the plain
    lowering (``F.batch_norm``, ``torch.mean``), in float64: the same
    function to 1e-12 of each gradient's norm.  In float32 the two round
    the forward differently, which at a large batch moves a few ReLU
    pre-activations across 0 (``chip_smoke.py``'s
    ``RN_TIE_GRAD_RELNORM``)."""
    batch = 8
    x = tht.placeholder_op("x", shape=(batch, 3, 32, 32))
    y = tht.placeholder_op("y", shape=(batch, 10))
    loss, _ = tht.models.resnet18(x, y)
    topo = tht.topo_sort([loss])
    ex = tht.Executor([loss], seed=0, device="cpu")
    rng = np.random.RandomState(0)
    feeds = {x: torch.from_numpy(rng.rand(batch, 3, 32, 32)),
             y: torch.from_numpy(np.eye(10)[rng.randint(0, 10, batch)])}
    wrt = trainable(loss, tht.topo_sort)
    got = []
    for axis in (None, BatchAxis(None, 1, 0)):
        leaves = {n: ex.var_values[n].double().requires_grad_(True)
                  for n in wrt}
        if axis is not None:
            axis.sharded.update(feeds)
        env = tht.lower_forward(
            topo, tht.LowerCtx(True, None, axis),
            lambda n: feeds[n] if n in feeds
            else leaves.get(n, ex.var_values[n].double()))
        got.append((float(env[loss].detach()), torch.autograd.grad(
            env[loss], [leaves[n] for n in wrt])))
    assert got[1][0] == pytest.approx(got[0][0], rel=1e-12)
    for n, a, b in zip(wrt, got[0][1], got[1][1]):
        assert _relnorm(b.numpy(), a.numpy()) <= 1e-12, n.name


def _lower_sharded(node, *vals, size=2, training=True):
    """``node`` lowered by the batch-axis table with its first input
    sharded over a group of ``size`` (no collective is reached)."""
    axis = BatchAxis(None, size, 0)
    axis.sharded.add(node.inputs[0])
    ctx = tht.LowerCtx(training, None, axis)
    return axis.lower(node, ctx, [torch.as_tensor(v) for v in vals])


@pytest.mark.parametrize("what", ["unknown_op", "moves_batch", "partial_slice",
                                  "trans_A", "sharded_weight",
                                  "replicated_rows", "replicated_mask",
                                  "undivided_reshape", "sharded_broadcast"])
def test_batch_axis_refuses_what_it_cannot_split(what):
    a = tht.placeholder_op("a")
    b = tht.placeholder_op("b")
    x = np.ones((2, 4), np.float32)
    q = np.ones((1, 2, 3, 4), np.float32)
    cases = {
        "unknown_op": (NotImplementedError, "Concat",
                       tht.concat_op(a, b, axis=1), (x, x)),
        "moves_batch": (NotImplementedError, "moves the batch",
                        tht.transpose_op(a, perm=(1, 0)), (x,)),
        "partial_slice": (NotImplementedError, "whole batch",
                          tht.slice_op(a, begin=(0, 0), size=(2, 4)), (x,)),
        "trans_A": (NotImplementedError, "trans_A",
                    tht.matmul_op(a, b, trans_A=True), (x, x)),
        "sharded_weight": (NotImplementedError, "input 0",
                           tht.embedding_lookup_op(a, b), (x, x)),
        "replicated_rows": (NotImplementedError, "replicated input",
                            tht.ops.add_op(a, b), (x, x)),
        "replicated_mask": (NotImplementedError, "broadcast over the batch",
                            tht.sdpa_masked_op(a, a, a, b),
                            (q, q, q, np.ones((3, 1, 1, 3), np.int32))),
        "undivided_reshape": (ValueError, "does not divide",
                              tht.array_reshape_op(a, output_shape=(3, 8)),
                              (np.ones((3, 8), np.float32),)),
        "sharded_broadcast": (NotImplementedError, "replicated shape",
                              tht.broadcastto_op(a, b),
                              (np.ones((2, 1), np.float32), x)),
    }
    err, match, node, vals = cases[what]
    with pytest.raises(err, match=match):
        _lower_sharded(node, *vals)


def test_batch_axis_splits_shapes_and_keeps_row_local_ops():
    a = tht.placeholder_op("a")
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)  # rank 0's rows
    out = _lower_sharded(tht.array_reshape_op(a, output_shape=(4, 12)), x)
    assert tuple(out.shape) == (2, 12)
    out = _lower_sharded(tht.slice_op(a, begin=(0, 1, 0), size=(4, 1, 4)), x)
    np.testing.assert_array_equal(out.numpy(), x[:, 1:2])
    out = _lower_sharded(tht.transpose_op(a, perm=(0, 2, 1)), x)
    assert tuple(out.shape) == (2, 4, 3)
    out = _lower_sharded(tht.relu_op(a), x - 5.0)
    np.testing.assert_array_equal(out.numpy(), np.maximum(x - 5.0, 0))
    # a reduction that keeps dim 0 stays row-local (no collective)
    out = _lower_sharded(tht.reduce_sum_op(a, [2]), x)
    np.testing.assert_array_equal(out.numpy(), x.sum(2))


@pytest.mark.parametrize("rank", [0, 1])
def test_batch_axis_broadcasts_and_takes_the_global_rows_of_replicated(rank):
    """``BroadcastTo`` of a replicated operand into sharded rows (T5's
    RMSNorm scale) is sharded; a replicated value holding the global
    batch's rows (Longformer's global-token selector, XLNet's tiled query
    stream) meets the sharded rows as this rank's block of it."""
    a, b = tht.placeholder_op("a"), tht.placeholder_op("b")
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)   # a rank's rows
    scale = np.arange(4, dtype=np.float32)
    glob = np.arange(4 * 3 * 4, dtype=np.float32).reshape(4, 3, 4)
    for node, vals, want in (
            (tht.broadcastto_op(b, a), (scale, x),
             np.broadcast_to(scale, x.shape)),
            (tht.broadcastto_op(a, a), (x[:, :, :1],), None),
            (tht.ops.mul_op(a, b), (x, glob), x * glob[2 * rank:2 * rank + 2]),
            (tht.ops.mul_op(a, b), (x, scale), x * scale)):
        axis = BatchAxis(None, 2, rank)
        axis.sharded.add(a)
        out = axis.lower(node, tht.LowerCtx(True, None, axis),
                         [torch.as_tensor(v) for v in vals]
                         + ([torch.as_tensor(x)] if want is None else []))
        assert node in axis.sharded
        if want is not None:
            np.testing.assert_array_equal(out.numpy(), want)
