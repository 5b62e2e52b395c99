"""Static analysis in the port (``hetu_tpu_torch.analysis``) against the
JAX package's (``hetu_tpu.analysis``), on the CPU.

* ``infer_graph``: tiny BERT, GPT-2, T5, XLNet, Longformer, sparse MoE,
  ResNet-18 (full width, batch 2), Wide & Deep through a device PS
  cache, and tiny ViT, Swin (roll, repeat, the window mask with a bias),
  Transformer-XL (concatenate, the memory's state write) and Reformer
  (LSH attention), built alike in both packages: node for node in topo order the
  same op type, shape and dtype.  The JAX package runs without x64, so
  its integer leaves are int32 where the port keeps the int64 the
  executor feeds: an int64 of the port is read as int32 here, and no
  other dtype is mapped.  Inference runs no kernel and moves no counter.
* The lint: each rule fires with the JAX package's name and severity on
  the bad graphs of ``tests/test_analysis.py``, and both packages give
  the same (rule, severity) pairs on them; ``flash-fallback`` is the
  port's own (ROADMAP C7) and held apart: it flags what the port's
  kernels refuse (a head dim above 128 once padded to their multiple, a
  mask shape), not a head dim off the multiple (zero-padded and taken)
  nor the JAX package's ragged causal case.
* ``validate=``: ``'warn'`` (the default), ``'error'`` and ``'off'`` in
  ``Executor``, ``InferenceExecutor`` and ``DecodeEngine`` as in the JAX
  package; a mis-shaped feed names its placeholder and creation site.
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

import hetu_tpu as jht                                      # noqa: E402
from hetu_tpu import models as jmodels                      # noqa: E402
from hetu_tpu.analysis import infer_graph as jinfer         # noqa: E402
from hetu_tpu.analysis import lint as jlint                 # noqa: E402
import hetu_tpu_torch as tht                                # noqa: E402
from hetu_tpu_torch import metrics as tmetrics              # noqa: E402
from hetu_tpu_torch.analysis import infer_graph as tinfer   # noqa: E402
from hetu_tpu_torch.analysis import lint as tlint           # noqa: E402
from hetu_tpu_torch.analysis import GraphValidationError    # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402


def _jax_module(name, *parts):
    if name not in sys.modules:
        path = os.path.join(ROOT, *parts)
        base = os.path.dirname(path)
        spec = importlib.util.spec_from_file_location(
            name, path, submodule_search_locations=[base]
            if parts[-1] == "__init__.py" else None)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _trainable(ht, loss):
    topo = jht.graph.node.topo_sort if ht is jht else tht.topo_sort
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def _train(ht, loss, grads=False):
    fetches = [loss, ht.optim.AdamOptimizer(1e-3).minimize(loss)]
    if grads:
        fetches += ht.gradients(loss, _trainable(ht, loss))
    return fetches


def _bert(ht, models):
    cfg = models.BertConfig.tiny(batch_size=2, seq_len=16, hidden_size=32,
                                 intermediate_size=64, vocab_size=96,
                                 num_hidden_layers=2, num_attention_heads=2)
    return _train(ht, models.bert_pretrain_graph(cfg)[1], grads=True)


def _gpt2(ht, models):
    cfg = models.GPT2Config.tiny(batch_size=2, seq_len=24)
    return _train(ht, models.gpt2_lm_graph(cfg)[1])


def _t5(ht, models):
    cfg = models.T5Config.tiny(batch_size=2, src_len=16, tgt_len=12)
    return _train(ht, models.t5_seq2seq_graph(cfg, use_mask=True)[1])


def _xlnet(ht, models):
    return _train(ht, models.xlnet_plm_graph(
        models.XLNetConfig.tiny(batch_size=2))[1])


def _longformer(ht, models):
    return _train(ht, models.longformer_mlm_graph(
        models.LongformerConfig.tiny(batch_size=2))[1])


def _moe(ht, models):
    x = ht.placeholder_op("x", shape=(64, 16))
    y_ = ht.placeholder_op("y", shape=(64, 16))
    gate = ht.layers.TopKGateSparse(16, 64, 4, k=2, capacity_factor=1.25)
    h, aux = ht.layers.SparseMoELayer(gate, ht.layers.Expert(4, 16, 32),
                                      16)(x)
    loss = ht.reduce_mean_op(ht.ops.mul_op(h - y_, h - y_), [0, 1]) \
        + aux * 0.01
    return _train(ht, loss, grads=True)


def _resnet18(ht, models):
    zoo = _jax_module("_jax_cnn_models", "examples", "cnn", "models",
                      "__init__.py") if ht is jht else tht.models
    x = ht.placeholder_op("x", shape=(2, 3, 32, 32))
    y = ht.placeholder_op("y", shape=(2, 10))
    loss, _ = zoo.resnet18(x, y)
    return [loss, ht.optim.MomentumOptimizer(0.1).minimize(loss)]


def _wdl(ht, models):
    if ht is jht:
        ctr, kw = _jax_module("_jax_ctr_models", "examples", "ctr",
                              "models.py"), {}
    else:
        ctr, kw = tht.models.ctr, {"slab_device": "cpu"}
    dense = ht.placeholder_op("dense", shape=(8, 13))
    sparse = ht.placeholder_op("sparse", shape=(8, 26), dtype=np.int64)
    y_ = ht.placeholder_op("y", shape=(8, 1))
    loss, _ = ctr.wdl_criteo(dense, sparse, y_, 8, vocab=520, dim=4,
                             embed_mode="vlru_dev", lr=0.01, **kw)
    return [loss, ht.optim.SGDOptimizer(0.01).minimize(loss)]


def _vit(ht, models):
    return _train(ht, models.vit_classify_graph(
        models.ViTConfig.tiny(batch_size=2))[1])


def _swin(ht, models):
    return _train(ht, models.swin_classify_graph(
        models.SwinConfig.tiny(batch_size=2))[1], grads=True)


def _transfoxl(ht, models):
    return _train(ht, models.transfoxl_lm_graph(
        models.TransfoXLConfig.tiny(batch_size=2))[1])


def _reformer(ht, models):
    return _train(ht, models.reformer_lm_graph(
        models.ReformerConfig.tiny(batch_size=2))[1])


GRAPHS = {"bert": _bert, "gpt2": _gpt2, "t5": _t5, "xlnet": _xlnet,
          "longformer": _longformer, "moe": _moe, "resnet18": _resnet18,
          "wdl_ps": _wdl, "vit": _vit, "swin": _swin,
          "transfoxl": _transfoxl, "reformer": _reformer}


def _dtype_name(dt):
    name = str(dt).replace("torch.", "")
    return "int32" if name == "int64" else name


def _canon(value, fn):
    if isinstance(value, tuple) and value and isinstance(value[0], tuple) \
            or isinstance(value, tuple) and value \
            and not isinstance(value[0], (int, np.integer)):
        return tuple(_canon(v, fn) for v in value)
    return fn(value)


@pytest.mark.parametrize("model", sorted(GRAPHS))
def test_infer_graph_matches_the_jax_package(model):
    tfetch = GRAPHS[model](tht, tht.models)
    jfetch = GRAPHS[model](jht, jmodels)
    tmetrics.reset_flash_fallbacks()
    tmetrics.reset_moe_fallbacks()
    launches = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    tg, jg = tinfer(tfetch), jinfer(jfetch)
    assert tg.complete, (list(tg.failed.items())[:3],
                         list(tg.pending.items())[:3])
    assert jg.complete
    assert len(tg.topo) == len(jg.topo)
    for t, j in zip(tg.topo, jg.topo):
        assert t.op_type == j.op_type, (t, j)
        if t in tg.markers:
            assert j in jg.markers
            continue
        assert tg.shape(t) == jg.shape(j), (t, tg.shape(t), jg.shape(j))
        assert _canon(tg.dtype(t), _dtype_name) == \
            _canon(jg.dtype(j), _dtype_name), (t, tg.dtype(t), jg.dtype(j))
    # abstract evaluation launches nothing and counts nothing
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == launches
    assert tmetrics.flash_fallback_counts() == {}
    assert tmetrics.moe_fallback_counts() == {}


def test_infer_graph_pending_and_failed_paths():
    """A shapeless feed leaves its consumers pending; a lowering that
    raises is isolated as failed and its consumers turn pending, in both
    packages alike; a feed example fills the pending shape."""
    def graph(ht, op_base):
        x = ht.placeholder_op("x")
        w = ht.Variable("w", value=np.ones((8, 4), np.float32))
        y = ht.matmul_op(x, w)

        class Boom(op_base):
            op_type = "Boom"

            def lower(self, ctx, a):
                raise ValueError("broken on purpose")

        z = ht.placeholder_op("z", shape=(2, 2))
        boom = Boom([z], name="boom")
        return x, [y, ht.relu_op(boom)]

    tx, tf = graph(tht, tht.Op)
    jx, jf = graph(jht, jht.graph.node.Op)
    tg, jg = tinfer(tf), jinfer(jf)
    for g in (tg, jg):
        assert not g.complete
    assert sorted(n.op_type for n in tg.pending) == \
        sorted(n.op_type for n in jg.pending) == \
        ["MatrixMult", "Placeholder", "Relu"]
    assert [n.name for n in tg.failed] == [n.name for n in jg.failed] \
        == ["boom"]
    tg = tinfer(tf, feeds={tx: np.zeros((3, 8), np.float32)})
    assert tg.shape(tf[0]) == (3, 4)


def test_abstract_infer_shape_is_the_ops_fallback():
    x = tht.placeholder_op("x", shape=(4, 8))
    ids = tht.placeholder_op("ids", shape=(5,), dtype=np.int32)
    table = tht.Variable("t", value=np.zeros((10, 3), np.float32))
    assert tht.relu_op(x).infer_shape([(4, 8)]) == (4, 8)
    assert tht.ops.embedding_lookup_op(table, ids).infer_shape(
        [(10, 3), (5,)]) == (5, 3)
    assert x.infer_shape([]) == (4, 8)
    conv = tht.conv2d_op(tht.placeholder_op("im"),
                         tht.placeholder_op("k"), padding=1, stride=2)
    assert conv.has_shape_rule
    assert conv.infer_shape([(2, 3, 8, 8), (6, 3, 3, 3)]) == (2, 6, 4, 4)


# --------------------------------------------------------------- the lint

def _pairs(report, skip=("flash-fallback",)):
    return sorted({(d.rule, d.severity) for d in report.diagnostics
                   if d.rule not in skip})


def _case_feed_shape(ht):
    x = ht.placeholder_op("x_feed", shape=(4, 8))
    return [ht.reduce_sum_op(x, [0, 1])], {x: np.zeros((5, 8), np.float32)}


def _case_feed_fraction(ht):
    ids = ht.placeholder_op("int_ids", shape=(4,), dtype=np.int32)
    return [ht.reduce_sum_op(ids, [0])], \
        {ids: np.full((4,), 0.5, np.float32)}


def _case_grad(ht):
    v = ht.Variable("frozen_v", value=np.zeros(3, np.float32),
                    trainable=False)
    loss = ht.reduce_sum_op(v * v, [0])
    return [loss, ht.gradients(loss, [v])[0]], None


def _case_dup(ht):
    a = ht.Variable("dup_w", value=np.zeros(2, np.float32))
    b = ht.Variable("dup_w", value=np.zeros(2, np.float32))
    return [ht.reduce_sum_op(a + b, [0])], None


def _case_ps_width(ht):
    store = ht.EmbeddingStore()
    t = store.init_table(100, 16, opt="sgd", lr=0.1, seed=0)
    ids = ht.placeholder_op("emb_ids", shape=(8,))
    emb = ht.ps_embedding_lookup_op((store, t), ids, width=32,
                                    name="bad_width_emb")
    return [ht.reduce_sum_op(emb, [0, 1])], None


def _case_shape_rule(ht):
    x = ht.placeholder_op("x", shape=(4, 8))
    if ht is jht:
        import jax.numpy as jnp
        from hetu_tpu.ops.base import SimpleOp
        fn = lambda c, a: jnp.sum(a, axis=1)                    # noqa: E731
    else:
        from hetu_tpu_torch.ops.base import SimpleOp
        fn = lambda c, a: torch.sum(a, dim=1)                   # noqa: E731
    node = SimpleOp("BadRule", [x], fn, shape_fn=lambda a: tuple(a),
                    name="bad_rule_node")
    return [node], None


def _case_uninferable(ht):
    base = jht.graph.node.Op if ht is jht else tht.Op

    class Boom(base):
        op_type = "Boom"

        def lower(self, ctx, xv):
            raise ValueError("intentionally broken lowering")

    return [Boom([ht.placeholder_op("x", shape=(2, 2))],
                 name="boom_node")], None


def _mlp_train(ht):
    x = ht.placeholder_op("x", shape=(8, 16))
    w = ht.Variable("w", value=np.full((16, 7), 0.1, np.float32))
    b = ht.Variable("b", value=np.zeros((7,), np.float32))
    loss = ht.reduce_mean_op(ht.matmul_op(x, w) + ht.broadcastto_op(
        b, ht.matmul_op(x, w)), [0, 1])
    return [loss, ht.optim.SGDOptimizer(0.1).minimize(loss)]


def _case_serving(ht):
    x = ht.placeholder_op("x", shape=(2, 4))
    y = ht.dropout_op(ht.relu_op(x), 0.9)
    loss = ht.reduce_sum_op(y, [0, 1])
    w = ht.Variable("w", value=np.ones((4,), np.float32))
    return [y, ht.gradients(ht.reduce_sum_op(w * w, [0]), [w])[0]], None


def _case_decode(ht):
    q = ht.placeholder_op("q", shape=(1, 2, 4, 8))
    return [ht.sdpa_op(q, q, q, name="full_seq_attn")], None


#: case -> (graph function, lint keywords, the rule it must fire)
LINT_CASES = {
    "feed-mismatch-shape": (_case_feed_shape, {}, "feed-mismatch"),
    "feed-mismatch-fraction": (_case_feed_fraction, {}, "feed-mismatch"),
    "grad-nontrainable": (_case_grad, {}, "grad-nontrainable"),
    "duplicate-var-name": (_case_dup, {}, "duplicate-var-name"),
    "ps-embedding-width": (_case_ps_width, {}, "ps-embedding-width"),
    "shape-rule-mismatch": (_case_shape_rule, {}, "shape-rule-mismatch"),
    "uninferable": (_case_uninferable, {}, "uninferable"),
    "zero-sharding": (lambda ht: (_mlp_train(ht), None), {"zero": 2},
                      "zero-sharding"),
    "remat-policy-unknown": (lambda ht: (_mlp_train(ht), None),
                             {"remat": "sometimes"}, "remat-policy"),
    "remat-policy-forward-only": (
        lambda ht: ([ht.reduce_sum_op(ht.matmul_op(
            ht.placeholder_op("x", shape=(2, 3)),
            ht.Variable("w", value=np.ones((3, 2), np.float32))), [0, 1])],
            None), {"remat": "full"}, "remat-policy"),
    "remat-policy-auto-no-budget": (lambda ht: (_mlp_train(ht), None),
                                    {"remat": "auto"}, "remat-policy"),
    "train-only-op-in-serving": (_case_serving,
                                 {"serving": True, "training": False},
                                 "train-only-op-in-serving"),
    "decode-incompatible-op": (_case_decode,
                               {"decode": True, "training": False},
                               "decode-incompatible-op"),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_rules_match_the_jax_package(case, monkeypatch):
    monkeypatch.delenv("HETU_HBM_BUDGET_MB", raising=False)
    build, kw, want_rule = LINT_CASES[case]
    (tf, tfeeds), (jf, jfeeds) = build(tht), build(jht)
    treport = tlint(tf, feeds=tfeeds, **kw)
    jreport = jlint(jf, feeds=jfeeds, **kw)
    assert _pairs(treport) == _pairs(jreport), (str(treport), str(jreport))
    hits = [d for d in treport.diagnostics if d.rule == want_rule]
    assert hits, str(treport)
    # actionable: the node's creation site is this file
    if hits[0].node is not None:
        assert "test_torch_analysis.py" in str(hits[0]), str(hits[0])


@pytest.mark.parametrize("model", ["bert", "gpt2", "resnet18", "vit",
                                   "swin", "transfoxl", "reformer"])
def test_lint_of_the_model_graphs_matches(model):
    """BERT, GPT-2, ViT, Swin, Transformer-XL and Reformer lint clean in
    both packages; ResNet-18's BatchNorm statistics share default names,
    a warning in both."""
    t = tlint(GRAPHS[model](tht, tht.models))
    j = jlint(GRAPHS[model](jht, jmodels))
    assert _pairs(t, skip=()) == _pairs(j, skip=()), (str(t), str(j))
    assert t.ok == (model != "resnet18"), str(t)


def test_zero_sharding_buckets_match_at_a_group_of_four():
    """With a group of 4 both packages pad the same ragged bucket."""
    from hetu_tpu.context import make_mesh
    t = tlint(_mlp_train(tht), zero=2, dp=4)
    j = jlint(_mlp_train(jht), zero=2, mesh=make_mesh({"dp": 4}))
    tz = [d.message for d in t.diagnostics if d.rule == "zero-sharding"]
    jz = [d.message for d in j.diagnostics if d.rule == "zero-sharding"]
    assert len(tz) == len(jz) == 1
    assert tz[0].split("totals")[1] == jz[0].split("totals")[1]


def test_flash_fallback_flags_what_the_port_refuses():
    """The port's rule: a mask outside the broadcast support and a head
    dim above the kernels' 128 are flagged; a head dim off the kernels'
    multiple (Transformer-XL's 41: zero-padded to 44) and the JAX
    package's ragged causal case (q 384, kv 273) are not, since the
    port's kernels take them."""
    q = tht.placeholder_op("q", shape=(1, 2, 256, 64))
    mask = tht.placeholder_op("m", shape=(1, 2, 3, 256))
    bad_mask = tht.sdpa_masked_op(q, q, q, mask, name="badmask_attn")
    q41 = tht.placeholder_op("q41", shape=(1, 2, 16, 41))
    dim41 = tht.sdpa_op(q41, q41, q41, causal=True, name="dim41_attn")
    q132 = tht.placeholder_op("q132", shape=(1, 2, 16, 132))
    bad_dim = tht.sdpa_op(q132, q132, q132, name="dim132_attn")
    qr = tht.placeholder_op("qr", shape=(1, 2, 384, 64))
    kr = tht.placeholder_op("kr", shape=(1, 2, 273, 64))
    ragged = tht.sdpa_op(qr, kr, kr, causal=True, name="ragged_attn")
    rep = tlint([bad_mask, dim41, bad_dim, ragged])
    flagged = {d.node.name: d for d in rep.diagnostics
               if d.rule == "flash-fallback"}
    assert set(flagged) == {"badmask_attn", "dim132_attn"}, str(rep)
    assert all(d.severity == "warn" for d in flagged.values())
    assert "mask_shape" in flagged["badmask_attn"].message
    assert "head_dim" in flagged["dim132_attn"].message
    # the JAX package flags the ragged causal call
    jq = jht.placeholder_op("qr", shape=(1, 2, 384, 64))
    jk = jht.placeholder_op("kr", shape=(1, 2, 273, 64))
    jr = jlint([jht.sdpa_op(jq, jk, jk, causal=True)])
    assert any(d.rule == "flash-fallback" for d in jr.diagnostics)


def test_creation_site_points_at_user_code():
    node = tht.placeholder_op("site_probe")
    fn, _, func = node.creation_site
    assert fn.endswith("test_torch_analysis.py")
    assert func == "test_creation_site_points_at_user_code"
    # through a model function, the site is still the caller's line
    bert = _bert(tht, tht.models)[0]
    assert bert.creation_site[0].endswith("test_torch_analysis.py")


# ------------------------------------------------------------ validate=

def _declared_mlp(ht):
    x = ht.placeholder_op("x_declared", shape=(4, 8))
    w = ht.Variable("w", value=np.full((8, 2), 0.5, np.float32))
    return x, ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])


def test_validate_error_rejects_a_bad_feed_shape():
    x, loss = _declared_mlp(tht)
    ex = tht.Executor({"train": [loss]}, validate="error", device="cpu")
    with pytest.raises(GraphValidationError) as ei:
        ex.run("train", feed_dict={x: np.zeros((5, 8), np.float32)})
    assert "x_declared" in str(ei.value)
    assert "test_torch_analysis.py" in str(ei.value)
    out = ex.run("train", feed_dict={x: np.zeros((4, 8), np.float32)})
    assert np.isfinite(float(out[0].asnumpy()))


def test_validate_warn_is_the_default_and_off_silences():
    def graph():
        v = tht.Variable("frozen2", value=np.zeros(3, np.float32),
                         trainable=False)
        loss = tht.reduce_sum_op(v * v, [0])
        return {"train": [loss, tht.gradients(loss, [v])[0]]}

    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        tht.Executor(graph(), device="cpu")
    assert any("grad-nontrainable" in str(w.message) for w in wl)
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        tht.Executor(graph(), device="cpu", validate="off")
    assert not any("grad-nontrainable" in str(w.message) for w in wl)
    with pytest.raises(GraphValidationError, match="frozen2"):
        tht.Executor(graph(), device="cpu", validate="error")


def test_validate_rejects_an_unknown_mode():
    x = tht.placeholder_op("x", shape=(2,))
    with pytest.raises(ValueError, match="validate"):
        tht.Executor({"d": [tht.reduce_sum_op(x, [0])]}, validate="maybe",
                     device="cpu")


def test_validate_error_warns_once_a_schema_in_warn_mode():
    x, loss = _declared_mlp(tht)
    ex = tht.Executor({"train": [loss]}, device="cpu")
    bad = np.zeros((5, 8), np.float32)
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        for _ in range(3):
            ex.run("train", feed_dict={x: bad})
    assert sum("x_declared" in str(w.message) for w in wl) == 1


def test_inference_executor_validate_modes():
    x = tht.placeholder_op("x", shape=(2, 4))
    w = tht.Variable("w", value=np.ones((4,), np.float32))
    grad = tht.gradients(tht.reduce_sum_op(w * w, [0]), [w])[0]
    drop = tht.dropout_op(tht.relu_op(x), 0.9)
    with pytest.raises(GraphValidationError, match="train-only"):
        tht.InferenceExecutor([grad], device="cpu")         # 'error'
    # a dropout is a warning: 'error' escalates only errors
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        tht.InferenceExecutor([drop], device="cpu", validate="error")
    assert any("train-only-op-in-serving" in str(m.message) for m in wl)
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        tht.InferenceExecutor([grad], device="cpu", validate="warn")
    assert any("train-only-op-in-serving" in str(m.message) for m in wl)
    tht.InferenceExecutor([grad], device="cpu", validate="off")
    with pytest.raises(ValueError, match="validate"):
        tht.InferenceExecutor([drop], device="cpu", validate="maybe")


def test_decode_engine_validate_is_passed_through():
    cfg = tht.GPT2Config.tiny(n_layer=1)
    feeds, logits, caches, _ = tht.gpt2_decode_graph(cfg, max_len=8)
    eng = tht.DecodeEngine(feeds, logits, caches, device="cpu",
                           validate="error", max_len=8)
    assert eng.iex.validate == "error"
    q = tht.placeholder_op("q", shape=(1, 2, 4, 8))
    full = tht.sdpa_op(q, q, q, name="full_seq_attn")
    with pytest.raises(GraphValidationError, match="decode-incompatible"):
        tht.DecodeEngine(feeds, full, caches, device="cpu", max_len=8)
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        tht.DecodeEngine(feeds, full, caches, device="cpu", max_len=8,
                         validate="warn")
    assert any("decode-incompatible-op" in str(m.message) for m in wl)


def test_validated_construction_launches_nothing():
    """Building an executor with validation runs the lint on meta
    tensors: no kernel counter and no fallback counter moves."""
    tmetrics.reset_flash_fallbacks()
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches,
              fa.launches)
    tht.Executor({"train": _bert(tht, tht.models)}, device="cpu",
                 validate="error")
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches,
            fa.launches) == before
    assert tmetrics.flash_fallback_counts() == {}


def test_lint_and_graph_validation_error_are_exported():
    assert tht.lint is tlint
    assert tht.GraphValidationError is GraphValidationError
    assert issubclass(GraphValidationError, ValueError)
