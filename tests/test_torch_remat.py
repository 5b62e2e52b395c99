"""Rematerialization (``parallel/remat.py``, ``Executor(remat=)``) and
gradient accumulation (``Executor(num_microbatches=)``) in the port.

* Remat: tiny BERT with dropout on (keep_prob 0.9), 3 Adam steps under
  ``'dots'``, ``'full'`` and ``'offload'`` (on the CPU the counted
  fallback to ``'dots'``): every loss and every gradient is bit-equal to
  ``'off'``.  Without the generator replay a recompute draws new dropout
  masks, and the gradients differ: held here by disabling it.
  ``build_segments`` on tiny BERT gives the JAX package's segments (op
  types and names); ``remat_plan()`` reports the JAX keys;
  ``HETU_REQUIRE_OFFLOAD=1`` raises without a card.
* Accumulation: tiny BERT built at the microbatch size, fed the whole
  batch, with M = 2 and 4 against the JAX package's accumulated run
  (``pipeline='gpipe', num_microbatches=M`` on a graph with no pipeline
  block, which is its scanned accumulation) at ``tests/test_torch_bert.
  py``'s gates (step-1 loss atol 1e-5, 5 Adam losses rtol 1e-5, the
  gradients rtol 1e-4 atol 1e-6); M = 1 is the plain step bit for bit;
  a BatchNorm graph's running statistics are threaded from microbatch to
  microbatch as the JAX package threads them (rtol 1e-5); the
  ``microbatch_feeds`` choice, an indivisible batch and PS embeddings are
  held to the JAX package's rules.
* ``remat='auto'``: on ``tests/test_remat.py``'s two-segment toy the
  port's plan equals ``hetu_tpu.parallel.remat.build_plan``'s for the
  same budget (segment for segment, bytes, FLOPs, the report); without a
  budget every segment is rematted and noted, and the lint warns; through
  the executor the plan follows ``HETU_HBM_BUDGET_MB`` and the losses and
  gradients are bit-equal to ``'off'``."""
import os
import sys
import warnings

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jtopo        # noqa: E402
from hetu_tpu.models import bert as jbert                 # noqa: E402
from hetu_tpu.parallel import remat as jremat             # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics as tmetrics            # noqa: E402
from hetu_tpu_torch.parallel import remat as tremat       # noqa: E402

CFG = dict(batch_size=4, seq_len=16, hidden_size=32, intermediate_size=64,
           vocab_size=96, num_hidden_layers=2, num_attention_heads=2,
           hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
REMAT_STEPS, MB_STEPS = 3, 5


def _trainable(loss, topo):
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def _bert(ht, models, topo, batch=None, **cfg_kw):
    """(fetches, feed dict) of tiny BERT with its gradient fetches;
    ``batch``: the graph's batch (the microbatch), fed CFG's batch."""
    cfg = models.BertConfig.tiny(**dict(CFG, **cfg_kw))
    if batch is not None:
        cfg.batch_size = batch
    feeds, loss, _ = models.bert_pretrain_graph(cfg)
    grads = ht.gradients(loss, _trainable(loss, topo))
    fetches = {"train": [loss, ht.optim.AdamOptimizer(1e-3).minimize(loss)]
               + grads}
    ids, tt, labels, attn = jbert.synthetic_mlm_batch(
        jbert.BertConfig.tiny(**dict(CFG, **cfg_kw)), seed=0)
    fd = {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
          feeds["masked_lm_labels"]: labels, feeds["attention_mask"]: attn}
    return fetches, fd


def _run(ex, fd, n):
    out = []
    for _ in range(n):
        o = ex.run("train", feed_dict=fd)
        out.append((float(np.asarray(o[0].asnumpy())),
                    [np.asarray(g.asnumpy()) for g in o[2:]]))
    return out


def _port(remat="off", **kw):
    fetches, fd = _bert(tht, tht.models, tht.topo_sort)
    return tht.Executor(fetches, seed=0, device="cpu", remat=remat,
                        **kw), fd


@pytest.fixture(scope="module")
def off_run():
    return _run(*_port(), REMAT_STEPS)


def _bit_equal(got, want):
    for (gl, gg), (wl, wg) in zip(got, want):
        assert gl == wl
        for a, b in zip(gg, wg):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["dots", "full", "offload", True])
def test_policy_is_bit_equal_to_off_with_dropout(off_run, policy):
    tmetrics.reset_remat_counts()
    ex, fd = _port(policy)
    tmetrics.reset_flash_fallbacks()
    _bit_equal(_run(ex, fd, REMAT_STEPS), off_run)
    # a recompute dispatches the attention forward again (on the card: a
    # second flash forward launch); 'offload' here is 'dots'
    assert tmetrics.flash_fallback_counts() == {
        "backend:cpu": 2 * REMAT_STEPS * CFG["num_hidden_layers"]}
    counts = tmetrics.remat_counts()
    if policy == "offload":
        assert counts == {"remat_offload_fallback": 1}
    elif policy == "full":
        plan = ex.remat_plan("train")
        assert counts["remat_layers_rematted"] == plan["segments"] > 1
    else:
        assert counts == {}


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_recompute_without_generator_replay_differs(off_run, policy,
                                                    monkeypatch):
    real = tremat.checkpointed

    def no_replay(fn, generator, *args, dots=False):
        return real(fn, None, *args, dots=dots)

    monkeypatch.setattr(tremat, "checkpointed", no_replay)
    ex, fd = _port(policy)
    got = _run(ex, fd, 1)
    assert got[0][0] == off_run[0][0]          # the forward is the same
    assert any(not np.array_equal(a, b)
               for a, b in zip(got[0][1], off_run[0][1]))


def test_segments_are_the_jax_packages():
    jcfg = jbert.BertConfig.tiny(**CFG)
    tcfg = tht.BertConfig.tiny(**CFG)
    _, jloss, _ = jbert.bert_pretrain_graph(jcfg)
    _, tloss, _ = tht.bert_pretrain_graph(tcfg)
    js = jremat.build_segments(jtopo([jloss]))
    ts = tremat.build_segments(tht.topo_sort([tloss]))
    assert len(ts) == len(js) > 1
    for a, b in zip(ts, js):
        assert [(n.op_type, n.name.split("_")[0]) for n in a] == \
            [(n.op_type, n.name.split("_")[0]) for n in b]


def test_segment_anchors_follow_the_variable(monkeypatch):
    monkeypatch.setenv("HETU_REMAT_SEGMENT_ANCHORS", "2")
    _, tloss, _ = tht.bert_pretrain_graph(tht.BertConfig.tiny(**CFG))
    _, jloss, _ = jbert.bert_pretrain_graph(jbert.BertConfig.tiny(**CFG))
    assert [len(s) for s in tremat.build_segments(tht.topo_sort([tloss]))] \
        == [len(s) for s in jremat.build_segments(jtopo([jloss]))]


def test_remat_plan_report_keys_are_the_jax_packages():
    ex, _ = _port("full")
    rep = ex.remat_plan("train")
    jplan = jremat.RematPlan(policy="full")
    assert sorted(rep) == sorted(jplan.report())
    assert ex.remat_plan()["policy"] == "full"
    assert _port("dots")[0].remat_plan() == {"policy": "dots", "plans": {}}


def test_offload_on_the_cpu_is_a_counted_fallback(monkeypatch):
    tmetrics.reset_remat_counts()
    _port("offload")
    assert tmetrics.remat_counts() == {"remat_offload_fallback": 1}
    monkeypatch.setenv("HETU_REQUIRE_OFFLOAD", "1")
    with pytest.raises(RuntimeError, match="HETU_REQUIRE_OFFLOAD"):
        _port("offload")
    tmetrics.reset_remat_counts()


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat="):
        _port("sometimes")


# -- num_microbatches ---------------------------------------------------------

def _jax_accumulated(M):
    fetches, fd = _bert(jht, jbert, jtopo, batch=CFG["batch_size"] // M,
                        **NO_DROPOUT)
    kw = dict(pipeline="gpipe", num_microbatches=M) if M > 1 else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # no pipeline block: intended
        ex = jht.Executor(fetches, seed=0, validate="off", **kw)
    return ex, fd


@pytest.mark.parametrize("M", [2, 4])
def test_accumulation_matches_jax(M):
    jex, jfd = _jax_accumulated(M)
    fetches, tfd = _bert(tht, tht.models, tht.topo_sort,
                         batch=CFG["batch_size"] // M, **NO_DROPOUT)
    tex = tht.Executor(fetches, seed=0, device="cpu", num_microbatches=M)
    tex.load_dict(jex.return_tensor_values())
    want, got = _run(jex, jfd, MB_STEPS), _run(tex, tfd, MB_STEPS)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=0, atol=1e-5)
    for g, w in zip(got[0][1], want[0][1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([x[0] for x in got], [x[0] for x in want],
                               rtol=1e-5, atol=0)
    assert tex.step_counter == MB_STEPS


def test_one_microbatch_is_the_plain_step():
    fetches, fd = _bert(tht, tht.models, tht.topo_sort)
    plain = tht.Executor(fetches, seed=0, device="cpu")
    fetches, fd1 = _bert(tht, tht.models, tht.topo_sort)
    one = tht.Executor(fetches, seed=0, device="cpu", num_microbatches=1)
    _bit_equal(_run(one, fd1, 3), _run(plain, fd, 3))


def _bn_graph(ht, batch):
    rng = np.random.RandomState(4)
    x = ht.placeholder_op("x")
    y_ = ht.placeholder_op("y_")
    scale = ht.Variable("bn_scale", value=np.ones(3, np.float32))
    bias = ht.Variable("bn_bias", value=np.zeros(3, np.float32))
    w = ht.Variable("w", value=rng.randn(12, 2).astype(np.float32) * .3)
    h = ht.batch_normalization_op(x, scale, bias, momentum=0.1, name="bn")
    h = ht.array_reshape_op(h, output_shape=(batch, 12))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(h, w), y_), [0])
    return x, y_, {"train": [loss, ht.optim.SGDOptimizer(0.1)
                             .minimize(loss), h]}


def test_batchnorm_statistics_thread_through_the_microbatches():
    rng = np.random.RandomState(6)
    xv = rng.randn(8, 3, 2, 2).astype(np.float32) * 2 + 1
    yv = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]
    jx, jy, jf = _bn_graph(jht, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jex = jht.Executor(jf, seed=0, validate="off", pipeline="gpipe",
                           num_microbatches=2)
    tx, ty, tf = _bn_graph(tht, 4)
    tex = tht.Executor(tf, seed=0, device="cpu", num_microbatches=2)
    for _ in range(3):
        jo = jex.run("train", feed_dict={jx: xv, jy: yv})
        to = tex.run("train", feed_dict={tx: xv, ty: yv})
        np.testing.assert_allclose(float(to[0].asnumpy()),
                                   float(np.asarray(jo[0].asnumpy())),
                                   rtol=1e-5)
        # a batch-derived fetch comes back whole, concatenated
        assert to[2].shape == (8, 12)
        np.testing.assert_allclose(to[2].asnumpy(),
                                   np.asarray(jo[2].asnumpy()),
                                   rtol=1e-5, atol=1e-6)
    jv, tv = jex.return_tensor_values(), tex.return_tensor_values()
    for name in ("bn_running_mean", "bn_running_var"):
        np.testing.assert_allclose(tv[name], np.asarray(jv[name]),
                                   rtol=1e-5, err_msg=name)
    # threaded: the two microbatches' updates compound
    assert not np.allclose(tv["bn_running_mean"],
                           0.1 * xv.mean((0, 2, 3)))


def test_microbatch_feeds_and_the_batch_rule():
    rng = np.random.RandomState(2)
    x = tht.placeholder_op("x")
    scale = tht.placeholder_op("scale")    # (8, 8): not the batch
    y_ = tht.placeholder_op("y_")
    w = tht.Variable("w", value=rng.randn(8, 3).astype(np.float32) * .2)
    loss = tht.reduce_mean_op(tht.softmaxcrossentropy_op(
        tht.matmul_op(tht.matmul_op(x, scale), w), y_), [0])
    fetches = {"train": [loss, tht.optim.SGDOptimizer(0.1).minimize(loss)]}
    fd = {x: rng.randn(16, 8).astype(np.float32),
          scale: np.eye(8, dtype=np.float32),
          y_: np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]}
    plain = tht.Executor(fetches, seed=0, device="cpu")
    acc = tht.Executor(fetches, seed=0, device="cpu", num_microbatches=4)
    named = tht.Executor(fetches, seed=0, device="cpu", num_microbatches=4,
                         microbatch_feeds=[x, y_])
    want = float(plain.run("train", feed_dict=fd)[0].asnumpy())
    for ex in (acc, named):
        np.testing.assert_allclose(
            float(ex.run("train", feed_dict=fd)[0].asnumpy()), want,
            rtol=1e-6)
    bad = tht.Executor(fetches, seed=0, device="cpu", num_microbatches=3)
    with pytest.raises(ValueError, match="not divisible into 3"):
        bad.run("train", feed_dict=fd)


def test_accumulation_with_ps_embeddings_is_refused():
    ids = tht.placeholder_op("ids", dtype=np.int64)
    store = tht.EmbeddingStore()
    t = store.init_table(10, 4, seed=0)
    emb = tht.ps_embedding_lookup_op((store, t), ids, width=4)
    w = tht.Variable("w", value=np.ones((4, 1), np.float32))
    loss = tht.reduce_mean_op(tht.matmul_op(emb, w), [0, 1])
    with pytest.raises(NotImplementedError, match="num_microbatches"):
        tht.Executor({"train": [loss, tht.optim.SGDOptimizer(0.1)
                                .minimize(loss)]}, device="cpu",
                     num_microbatches=2)


# ------------------------------------------------------------ remat auto

def _toy(ht):
    """``tests/test_remat.py``'s two-segment toy (one anchor a segment)."""
    rng = np.random.RandomState(0)
    x = ht.placeholder_op("x", shape=(64, 32))
    y_ = ht.placeholder_op("y", shape=(64, 4))
    wa = ht.Variable("wa", value=rng.randn(32, 512).astype(np.float32) * .1)
    wb = ht.Variable("wb", value=rng.randn(512, 4).astype(np.float32) * .1)
    ha = ht.relu_op(ht.matmul_op(ht.relu_op(x), wa))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(ha, wb), y_), [0])
    return x, y_, [loss, ht.optim.SGDOptimizer(0.1).minimize(loss)]


def _plan(mod, topo, fetches, policy, **kw):
    skip = [n for n in topo if n.op_type == "OptimizerUpdate"]
    return mod.build_plan(topo, fetches, policy, skip=skip, **kw)


def _summary(plan):
    return [(len(s.nodes), s.anchors, s.act_bytes, s.out_bytes,
             s.recompute_flops, s.remat) for s in plan.segments]


def test_auto_plan_equals_the_jax_packages(monkeypatch):
    monkeypatch.setenv("HETU_REMAT_SEGMENT_ANCHORS", "1")
    monkeypatch.delenv("HETU_HBM_BUDGET_MB", raising=False)
    tf, jf = _toy(tht)[2], _toy(jht)[2]
    ttopo, jtopo_ = tht.topo_sort(tf), jtopo(jf)
    tall = _plan(tremat, ttopo, tf, "full")
    jall = _plan(jremat, jtopo_, jf, "full")
    assert tall.priced and jall.priced and len(tall.segments) == 2
    assert _summary(tall) == _summary(jall)
    cheapest = min(tall.segments, key=lambda s: s.cost_per_byte)
    budget = int(sum(s.act_bytes for s in tall.segments)
                 - cheapest.saved_bytes)
    for b in (budget, budget - 1, 10 ** 9):
        t = _plan(tremat, ttopo, tf, "auto", budget=b, budget_source="t")
        j = _plan(jremat, jtopo_, jf, "auto", budget=b, budget_source="t")
        assert _summary(t) == _summary(j), b
        assert t.report() == j.report(), b
    assert [s.index for s in _plan(tremat, ttopo, tf, "auto", budget=budget)
            .segments if s.remat] == [cheapest.index]
    t = _plan(tremat, ttopo, tf, "auto")
    j = _plan(jremat, jtopo_, jf, "auto")
    assert t.n_remat == len(t.segments) == j.n_remat
    assert t.note == j.note and "no HBM budget" in t.note


def test_auto_through_the_executor_follows_the_budget(monkeypatch):
    """Tiny BERT with dropout: with a budget too small for anything every
    segment is rematted, with a large one none; the losses and every
    gradient are bit-equal to 'off' either way."""
    base = _run(*_port("off"), 2)
    monkeypatch.setenv("HETU_HBM_BUDGET_MB", "0.001")
    ex, fd = _port("auto")
    rep = ex.remat_plan("train")
    assert rep["policy"] == "auto" and rep["budget_source"] == \
        "HETU_HBM_BUDGET_MB" and rep["priced"]
    assert rep["segments_rematted"] == rep["segments"] > 1
    _bit_equal(_run(ex, fd, 2), base)
    monkeypatch.setenv("HETU_HBM_BUDGET_MB", "100000")
    ex, fd = _port("auto")
    assert ex.remat_plan("train")["segments_rematted"] == 0
    _bit_equal(_run(ex, fd, 2), base)


def test_auto_without_a_budget_warns_on_the_cpu(monkeypatch):
    monkeypatch.delenv("HETU_HBM_BUDGET_MB", raising=False)
    x, y_, fetches = _toy(tht)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ex = tht.Executor({"train": fetches}, seed=0, device="cpu",
                          remat="auto")
    assert any("remat-policy" in str(r.message)
               and "no resolvable HBM budget" in str(r.message)
               for r in rec)
    assert "no HBM budget" in ex.remat_plan("train")["note"]
