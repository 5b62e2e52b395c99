"""Data parallelism on the transformer graphs and in bf16: the port's
``Executor(dist_strategy=DataParallel())`` over a gloo world of 2 against
the JAX package's single-device runs, and the port's own single-device
bf16 run.

A module-scoped fixture spawns world 2 once (the pattern of
``tests/test_torch_parallel.py``); each rank is fed the global batch of
every workload, from the JAX package's initial weights, while the JAX
references run in the test process.

* Tiny GPT-2, T5 (``use_mask=True``, the padded batch, every
  ``*.q.weight`` scaled by 1/8 in both packages as
  ``tests/test_torch_t5.py`` does), XLNet and Longformer, each at the
  tiny configuration of its own ``tests/test_torch_<model>.py`` (batch 2:
  one sequence a rank), 3 Adam steps, at those files' gates: the step-1
  loss atol 1e-5, every step-1 gradient ``allclose(rtol=1e-4,
  atol=1e-6)``, the losses rtol 1e-5.  T5 reaches ``BroadcastTo`` (its
  RMSNorm), Longformer a replicated global-token selector with the
  global batch's rows, XLNet a query stream tiled from one replicated
  vector (``parallel/batch_axis.py``).
* bf16 (``compute_dtype="bfloat16"``): ``test_torch_parallel.py``'s Adam
  MLP (batch 32) and tiny BERT (batch 16, seq 32), 3 Adam steps, and
  ResNet-18 at full width, batch 4, one Momentum step (sync BN in bf16),
  each against the JAX package's bf16 run and the port's single-device
  bf16 run at ``tests/test_torch_bf16.py``'s gates: losses rtol 5e-3,
  step-1 gradients ``allclose(rtol=2e-2, atol=1e-2)``; ResNet-18's
  gradients and running statistics by that file's spread rule (a relative
  norm at most 1.5 times the JAX package's own bf16-to-float32 one,
  floored at 2e-2).
* bf16 with ``zero=2`` on the MLP: bit-equal to the bf16 run at stage 0
  (dp 2), and within rtol 5e-3 of the JAX package's bf16 losses.
* The sparse MoE graph under the strategy raises, naming
  ``TopKGateSparse`` (its capacity counts over the global batch).

The rank processes import this module, so JAX is imported only inside
functions."""
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
from test_torch_parallel import (JOIN_TIMEOUT, bert_graph,    # noqa: E402
                                 end_world, join_world, mlp_feeds, mlp_graph,
                                 resnet_graph, spawn_world)

WORLD = 2
MODELS = ("gpt2", "t5", "xlnet", "longformer")
STEPS = 3
LOSS1_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
T5_Q_SCALE = 0.125
# tests/test_torch_bf16.py's gates
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_TOL = dict(rtol=2e-2, atol=1e-2)
RESNET_SPREAD_RATIO = 1.5
BF16 = ("mlp", "bert", "resnet")


def _trainable(loss, topo):
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def model_graph(model, mod):
    """(loss, {feed name: node}, {feed name: value}) of a tiny model from
    its package's module ``mod``, at its own test's configuration."""
    if model == "gpt2":
        cfg = mod.GPT2Config.tiny(batch_size=2, seq_len=24, resid_pdrop=0.0,
                                  embd_pdrop=0.0, attn_pdrop=0.0)
        feeds, loss, _ = mod.gpt2_lm_graph(cfg)
        ids, labels = mod.synthetic_lm_batch(cfg, seed=0)
        labels = labels.copy()
        labels[0, -5:] = -1
        labels[1, 3] = -1
        return loss, feeds, {"input_ids": ids, "labels": labels}
    if model == "t5":
        cfg = mod.T5Config.tiny(batch_size=2, src_len=16, tgt_len=12,
                                dropout_rate=0.0)
        feeds, loss, _ = mod.t5_seq2seq_graph(cfg, use_mask=True)
        batch = mod.synthetic_seq2seq_batch(cfg, seed=0, padded=True)
        return loss, feeds, dict(zip(("input_ids", "decoder_input_ids",
                                      "labels", "attention_mask"), batch))
    if model == "xlnet":
        cfg = mod.XLNetConfig.tiny(batch_size=2, dropout=0.0)
        feeds, loss, _ = mod.xlnet_plm_graph(cfg)
        return loss, feeds, dict(zip(
            ("input_ids", "content_mask", "query_mask", "labels"),
            mod.synthetic_plm_batch(cfg, seed=0)))
    cfg = mod.LongformerConfig.tiny(batch_size=2, hidden_dropout_prob=0.0)
    feeds, loss, _ = mod.longformer_mlm_graph(cfg)
    # the JAX package draws them in examples/transformers/train_lm.py
    ids, labels = tht.models.longformer.synthetic_mlm_ids(cfg, seed=0)
    return loss, feeds, {"input_ids": ids, "labels": labels}


def bf16_graph(ht, models, model):
    """(loss, feed dict, optimizer, steps) of a bf16 workload."""
    if model == "mlp":
        x, y_, loss = mlp_graph(ht, 3)
        xv, yv = mlp_feeds("adam")
        return loss, {x: xv, y_: yv}, ht.optim.AdamOptimizer(0.01), STEPS
    if model == "bert":
        loss, fd = bert_graph(models)
        return loss, fd, ht.optim.AdamOptimizer(1e-3), STEPS
    loss, fd = resnet_graph(ht, models.resnet18)
    return loss, fd, ht.optim.MomentumOptimizer(0.1), 1


def train(ex, fd, steps, n_grads):
    """Losses, step-1 gradients in order, running statistics after the
    last step."""
    losses, grads = [], None
    for _ in range(steps):
        out = ex.run("train", feed_dict=fd)
        losses.append(float(np.asarray(out[0].asnumpy())))
        if grads is None:
            grads = [np.asarray(g.asnumpy()) for g in out[2:2 + n_grads]]
    stats = {k: v for k, v in ex.return_tensor_values().items()
             if "_running_" in k}
    return {"losses": losses, "grads": grads, "stats": stats}


# -- the port, on every rank ------------------------------------------------------

def port_workloads(data):
    import torch.distributed as dist
    dp = tht.dist.DataParallel()
    mods = {"gpt2": tht.models.gpt2, "t5": tht.models.t5,
            "xlnet": tht.models.xlnet, "longformer": tht.models.longformer}
    res = {}
    for model in MODELS:
        loss, feeds, _ = model_graph(model, mods[model])
        wrt = _trainable(loss, tht.topo_sort)
        ex = tht.Executor({"train": [loss, tht.optim.AdamOptimizer(1e-3)
                                     .minimize(loss)]
                           + tht.gradients(loss, wrt)},
                          seed=0, device="cpu", dist_strategy=dp)
        ex.load_dict(data["weights"][model])
        fd = {feeds[k]: v for k, v in data["feeds"][model].items()}
        res[model] = train(ex, fd, STEPS, len(wrt))
    for model in BF16:
        for tag, kw in (("dp", dict(dist_strategy=dp)),
                        ("dp_zero2", dict(dist_strategy=dp, zero=2)),
                        ("single", {})):
            if (tag == "single" and dist.get_rank() != 0) \
                    or (tag == "dp_zero2" and model != "mlp"):
                continue
            loss, fd, opt, steps = bf16_graph(tht, tht.models, model)
            wrt = _trainable(loss, tht.topo_sort)
            ex = tht.Executor({"train": [loss, opt.minimize(loss)]
                               + tht.gradients(loss, wrt)}, seed=0,
                              device="cpu", compute_dtype="bfloat16", **kw)
            ex.load_dict(data["weights"][model])
            res[model, tag] = train(ex, fd, steps, len(wrt))
            res[model, tag]["planned"] = bool(ex._zero_plans)
    return res


def rank_main(rank, world, init_file, out_dir, data_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    clean = False
    try:
        dist.init_process_group("gloo", init_method="file://" + init_file,
                                rank=rank, world_size=world)
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        res = port_workloads(data)
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

def jax_references():
    """The weights and feed values (yielded first), then each workload's
    single-device run: float32 for the four models, bf16 for the
    others, and float32 for ResNet-18 (its bf16 spread)."""
    import hetu_tpu as jht
    from hetu_tpu.graph.node import topo_sort as jtopo
    from hetu_tpu.models import bert as jbert
    from hetu_tpu.models import gpt2, longformer, t5, xlnet
    from test_torch_cnn import jax_cnn_models
    mods = {"gpt2": gpt2, "t5": t5, "xlnet": xlnet, "longformer": longformer}
    data = {"weights": {}, "feeds": {}}
    built = {}
    for model in MODELS:
        loss, feeds, values = model_graph(model, mods[model])
        wrt = _trainable(loss, jtopo)
        ex = jht.Executor({"train": [loss, jht.optim.AdamOptimizer(1e-3)
                                     .minimize(loss)]
                           + jht.gradients(loss, wrt)}, seed=0,
                          validate="off")
        weights = ex.return_tensor_values()
        if model == "t5":
            weights = {n: w * T5_Q_SCALE if n.endswith(".q.weight") else w
                       for n, w in weights.items()}
            ex.load_dict(weights)
        data["weights"][model] = weights
        data["feeds"][model] = values
        built[model] = (ex, {feeds[k]: v for k, v in values.items()},
                        STEPS, len(wrt))
    models = {"mlp": jht, "bert": jbert, "resnet": jax_cnn_models()}
    for model in BF16:
        for cd in ("bfloat16", None) if model == "resnet" else ("bfloat16",):
            loss, fd, opt, steps = bf16_graph(jht, models[model], model)
            wrt = _trainable(loss, jtopo)
            ex = jht.Executor({"train": [loss, opt.minimize(loss)]
                               + jht.gradients(loss, wrt)}, seed=0,
                              compute_dtype=cd, validate="off")
            if cd is not None:
                data["weights"][model] = ex.return_tensor_values()
            else:
                ex.load_dict(data["weights"][model])
            built[model, cd] = (ex, fd, steps, len(wrt))
    yield data
    yield {k: train(*v) for k, v in built.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the JAX runs, "ranks": each rank's results}."""
    tmp = str(tmp_path_factory.mktemp("dpm"))
    refs = jax_references()
    data = next(refs)
    data_path = os.path.join(tmp, "data.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(data, f)
    deadline = time.monotonic() + JOIN_TIMEOUT
    started = spawn_world(WORLD, tmp, rank_main, data_path)
    try:
        ref = next(refs)
    finally:
        ranks = join_world(*started, deadline)
    return {"ref": ref, "ranks": ranks}


# -- the cases ----------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_model_under_the_strategy_matches_jax_single_device(runs, model):
    got, want = runs["ranks"][0][model], runs["ref"][model]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=0,
                               atol=LOSS1_ATOL)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    assert got["losses"][-1] < got["losses"][0]
    assert len(got["grads"]) == len(want["grads"]) > 10
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, err_msg=str(i), **GRAD_TOL)
    other = runs["ranks"][1][model]
    assert other["losses"] == got["losses"]
    for g, h in zip(got["grads"], other["grads"]):
        np.testing.assert_array_equal(g, h)


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("against", ["jax", "port_single"])
@pytest.mark.parametrize("model", BF16)
def test_bf16_under_the_strategy(runs, model, against):
    got = runs["ranks"][0][model, "dp"]
    want = runs["ref"][model, "bfloat16"] if against == "jax" \
        else runs["ranks"][0][model, "single"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=BF16_LOSS_RTOL)
    assert len(got["grads"]) == len(want["grads"])
    if model != "resnet":
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, err_msg=str(i),
                                       **BF16_GRAD_TOL)
        assert got["losses"][-1] < got["losses"][0]
        return
    # tests/test_torch_bf16.py's spread rule (see its ResNet-18 test)
    j16, j32 = runs["ref"]["resnet", "bfloat16"], runs["ref"]["resnet", None]
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        spread = max(_relnorm(j16["grads"][i], j32["grads"][i]),
                     BF16_GRAD_TOL["rtol"])
        assert _relnorm(g, w) <= RESNET_SPREAD_RATIO * spread, i
    assert sorted(got["stats"]) == sorted(want["stats"])
    assert len(got["stats"]) == 40
    for name, w in want["stats"].items():
        spread = max(_relnorm(j16["stats"][name], j32["stats"][name]),
                     BF16_GRAD_TOL["rtol"])
        assert _relnorm(got["stats"][name], w) <= \
            RESNET_SPREAD_RATIO * spread, name


def test_bf16_with_zero2_is_the_bf16_stage0_step(runs):
    got = runs["ranks"][0]["mlp", "dp_zero2"]
    base = runs["ranks"][0]["mlp", "dp"]
    assert got["planned"] and not base["planned"]
    assert got["losses"] == base["losses"]
    for g, w in zip(got["grads"], base["grads"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got["losses"],
                               runs["ref"]["mlp", "bfloat16"]["losses"],
                               rtol=BF16_LOSS_RTOL)
    assert runs["ranks"][1]["mlp", "dp_zero2"]["losses"] == got["losses"]


def test_sparse_moe_under_the_strategy_raises_by_name(tmp_path):
    import torch.distributed as dist
    from test_torch_bf16 import _moe_graph
    dist.init_process_group("gloo", init_method="file://"
                            + str(tmp_path / "init1"), rank=0, world_size=1)
    try:
        feeds, loss, _ = _moe_graph(tht)
        ex = tht.Executor([loss, tht.optim.AdamOptimizer(1e-3)
                           .minimize(loss)], device="cpu",
                          dist_strategy=tht.dist.DataParallel())
        rng = np.random.RandomState(0)
        fd = {n: rng.randn(*n.shape).astype(np.float32)
              for n in feeds.values()}
        with pytest.raises(NotImplementedError, match="TopKGateSparse"):
            ex.run(fd)
    finally:
        dist.destroy_process_group()
