"""One BERT pretraining step in the port against the JAX package.

Both packages build ``bert_pretrain_graph`` on a cut-down
``BertConfig.tiny`` (2 layers, hidden 32, seq 24, ragged lengths from
``synthetic_mlm_batch``, dropout 0).  The JAX ``Executor(seed=0)``
weights go into the port through ``load_dict``; then the same feeds go
through both.  Both run attention through their plain versions here on
the CPU (the JAX package's ``sdpa_reference``, the port's counted
``backend:cpu`` path).

Tolerances (float32): step-1 loss atol 1e-5; every variable's gradient
``allclose(rtol=1e-4, atol=1e-6)``; a 5-step Adam loss trajectory
rtol 1e-5."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo     # noqa: E402
from hetu_tpu.models import bert as jbert                 # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics                        # noqa: E402

CFG = dict(batch_size=2, seq_len=24, hidden_size=32, intermediate_size=64,
           vocab_size=96, num_hidden_layers=2, num_attention_heads=2,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _trainable(loss, topo):
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def _build(ht, models, topo, use_nsp, device=None):
    cfg = models.BertConfig.tiny(**CFG)
    feeds, loss, _ = models.bert_pretrain_graph(cfg, use_nsp=use_nsp)
    wrt = _trainable(loss, topo)
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-3).minimize(loss)
    kw = {} if device is None else {"device": device}
    ex = ht.Executor({"train": [loss, train_op] + grads}, seed=0, **kw)
    return cfg, feeds, ex, [n.name for n in wrt]


def _feeds(cfg, feeds, use_nsp):
    ids, tt, labels, attn = jbert.synthetic_mlm_batch(cfg, seed=0)
    fd = {"input_ids": ids, "token_type_ids": tt,
          "masked_lm_labels": labels, "attention_mask": attn}
    if use_nsp:
        fd["next_sentence_label"] = np.array([1, 0], np.int32)
    return {feeds[k]: v for k, v in fd.items()}


@pytest.mark.parametrize("use_nsp", [False, True])
def test_bert_training_step_matches_jax(use_nsp):
    jcfg, jfeeds, jex, jnames = _build(jht, jbert, jax_topo, use_nsp)
    tcfg, tfeeds, tex, tnames = _build(tht, tht.models, tht.topo_sort,
                                       use_nsp, device="cpu")
    assert tnames == jnames
    assert sorted(tex.var_names.values()) == sorted(jex.var_names.values())
    tex.load_dict(jex.return_tensor_values())
    jfd, tfd = _feeds(jcfg, jfeeds, use_nsp), _feeds(tcfg, tfeeds, use_nsp)
    lengths = jfd[jfeeds["attention_mask"]].sum(1)
    assert lengths.min() < tcfg.seq_len          # ragged: padding is masked

    metrics.reset_flash_fallbacks()
    jl, tl = [], []
    for step in range(5):
        jout = jex.run("train", feed_dict=jfd)
        tout = tex.run("train", feed_dict=tfd)
        jl.append(float(np.asarray(jout[0].asnumpy())))
        tl.append(float(tout[0].asnumpy()))
        if step == 0:
            np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=1e-5)
            assert tout[1] is None
            for name, jg, tg in zip(jnames, jout[2:], tout[2:]):
                np.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    assert tex.step_counter == 5
    # attention took the plain version only because the tensors are on
    # the CPU: one counted dispatch per layer and step
    assert metrics.flash_fallback_counts() == {
        "backend:cpu": 5 * tcfg.num_hidden_layers}


def test_synthetic_batch_is_the_jax_packages():
    cfg = tht.BertConfig.tiny(**CFG)
    for got, want in zip(tht.synthetic_mlm_batch(cfg, seed=3),
                         jbert.synthetic_mlm_batch(jbert.BertConfig.tiny(
                             **CFG), seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_bert_graph_names_match_jax():
    """Node op types and variable names line up one for one, so weights
    carry by name and the graphs lower op for op."""
    jcfg = jbert.BertConfig.tiny(**CFG)
    tcfg = tht.BertConfig.tiny(**CFG)
    _, jloss, _ = jbert.bert_pretrain_graph(jcfg, use_nsp=True)
    _, tloss, _ = tht.bert_pretrain_graph(tcfg, use_nsp=True)
    jt, tt = jax_topo([jloss]), tht.topo_sort([tloss])
    assert [n.op_type for n in tt] == [n.op_type for n in jt]
    assert [n.name for n in tt if isinstance(n, tht.PlaceholderOp)] == \
        [n.name for n in jt if isinstance(n, jht.PlaceholderOp)]
