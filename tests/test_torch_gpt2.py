"""GPT-2 causal-LM training in the port against the JAX package, and the
hand-over of the trained weights to the port's decode engines.

Both packages build ``gpt2_lm_graph`` on ``GPT2Config.tiny`` (2 layers,
128 wide, 2 heads, vocabulary 512; batch 2, seq 24, dropout 0, some
labels -1).  The JAX ``Executor(seed=0)`` weights go into the port
through ``load_dict``; then the same feeds go through both.  Both run the
causal attention through their plain versions here on the CPU (the JAX
package's ``sdpa_reference``, the port's counted ``backend:cpu`` path).

Tolerances (float32): step-1 loss atol 1e-5; every variable's gradient
``allclose(rtol=1e-4, atol=1e-6)``; a 5-step Adam loss trajectory
rtol 1e-5; teacher-forced decode logits against the training graph's
logits atol 1e-4 (the property tests/test_decode.py holds in the JAX
package: the decode graphs and the training graph share weights by
name)."""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo     # noqa: E402
from hetu_tpu.models import gpt2 as jgpt2                 # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics                        # noqa: E402

CFG = dict(batch_size=2, seq_len=24, resid_pdrop=0.0, embd_pdrop=0.0,
           attn_pdrop=0.0)
LOGITS_ATOL = 1e-4


def _trainable(loss, topo):
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def _build(ht, models, topo, device=None):
    cfg = models.GPT2Config.tiny(**CFG)
    feeds, loss, logits = models.gpt2_lm_graph(cfg)
    wrt = _trainable(loss, topo)
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-3).minimize(loss)
    kw = {} if device is None else {"device": device}
    ex = ht.Executor({"train": [loss, train_op] + grads, "eval": [logits]},
                     seed=0, **kw)
    return cfg, feeds, ex, [n.name for n in wrt]


def _batch(cfg):
    ids, labels = jgpt2.synthetic_lm_batch(cfg, seed=0)
    labels = labels.copy()
    labels[0, -5:] = -1                 # padded positions: ignored
    labels[1, 3] = -1
    return ids, labels


@pytest.fixture(scope="module")
def trained():
    """Both executors after 5 Adam steps from the JAX package's weights:
    (port cfg, port feeds, port executor, ids, per-step record)."""
    jcfg, jfeeds, jex, jnames = _build(jht, jgpt2, jax_topo)
    tcfg, tfeeds, tex, tnames = _build(tht, tht.models, tht.topo_sort,
                                       device="cpu")
    assert tnames == jnames
    assert sorted(tex.var_names.values()) == sorted(jex.var_names.values())
    tex.load_dict(jex.return_tensor_values())
    ids, labels = _batch(tcfg)
    jfd = {jfeeds["input_ids"]: ids, jfeeds["labels"]: labels}
    tfd = {tfeeds["input_ids"]: ids, tfeeds["labels"]: labels}
    metrics.reset_flash_fallbacks()
    rec = {"names": jnames, "jl": [], "tl": []}
    for step in range(5):
        jout = jex.run("train", feed_dict=jfd)
        tout = tex.run("train", feed_dict=tfd)
        rec["jl"].append(float(np.asarray(jout[0].asnumpy())))
        rec["tl"].append(float(tout[0].asnumpy()))
        if step == 0:
            rec["jg"] = [g.asnumpy() for g in jout[2:]]
            rec["tg"] = [g.asnumpy() for g in tout[2:]]
    rec["fallbacks"] = metrics.flash_fallback_counts()
    rec["jax_weights"] = jex.return_tensor_values()
    return tcfg, tfeeds, tex, ids, rec


def test_gpt2_training_step_matches_jax(trained):
    cfg, _, tex, _, rec = trained
    np.testing.assert_allclose(rec["tl"][0], rec["jl"][0], rtol=0, atol=1e-5)
    assert len(rec["names"]) == len(rec["tg"]) == 4 + 16 * cfg.n_layer + 2
    for name, jg, tg in zip(rec["names"], rec["jg"], rec["tg"]):
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert tex.step_counter == 5
    # causal attention took the plain version only because the tensors are
    # on the CPU: one counted dispatch per layer and step
    assert rec["fallbacks"] == {"backend:cpu": 5 * cfg.n_layer}


def test_gpt2_five_adam_steps_match_jax(trained):
    _, _, tex, _, rec = trained
    np.testing.assert_allclose(rec["tl"], rec["jl"], rtol=1e-5, atol=0)
    assert rec["tl"][-1] < rec["tl"][0]
    got = tex.return_tensor_values()
    assert set(got) == set(rec["jax_weights"])
    for name, want in rec["jax_weights"].items():
        if name.endswith(".attn.k.bias"):
            # softmax ignores a bias shared by every key, so this gradient
            # is rounding noise around 0 and Adam turns its sign into
            # steps of the size of the learning rate
            continue
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _engine(cfg, weights, chunked, **kw):
    graph = tht.gpt2_decode_graph(cfg, max_len=32)
    if chunked:
        kw["chunked"] = tht.gpt2_decode_chunked_graph(cfg, max_len=32)[:3]
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # a missing name would warn
        return tht.DecodeEngine(*graph[:3], weights=weights, max_slots=2,
                                max_len=32, device="cpu", **kw)


def _one_token_logits(eng, tokens):
    fn = eng.iex.compiled(1)
    caches = {n: eng._alloc(1, 32) for n in eng.cache_names}
    out = []
    for t, tok in enumerate(tokens):
        feeds = {eng._fk["input_ids"]: torch.tensor([[int(tok)]],
                                                    dtype=torch.int32),
                 eng._fk["positions"]: torch.tensor([t], dtype=torch.int32)}
        feeds.update({eng._fk[n]: caches[n] for n in eng.cache_names})
        out.append(fn(eng.iex.params, feeds)[0][0].numpy())
    return np.stack(out)


def _chunked_logits(eng, tokens, chunk):
    """Logits at the last token of each ``chunk``-wide piece."""
    fn = eng.ciex.compiled(1)
    caches = {n: eng._alloc(1, 32) for n in eng.cache_names}
    out = {}
    for t in range(0, len(tokens), chunk):
        piece = list(tokens[t:t + chunk])
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :len(piece)] = piece
        feeds = {eng._cfk["input_ids"]: torch.from_numpy(ids),
                 eng._cfk["positions"]: torch.tensor([t], dtype=torch.int32),
                 eng._cfk["valid"]: torch.tensor([len(piece)],
                                                 dtype=torch.int32)}
        feeds.update({eng._cfk[n]: caches[n] for n in eng.cache_names})
        out[t + len(piece) - 1] = fn(eng.ciex.params, feeds)[0][0].numpy()
    return out


def test_trained_weights_serve_by_name_and_match_the_training_logits(trained):
    """``params_from_named_arrays(ex.return_tensor_values())`` into the
    decode engines: every decode variable is found by name,
    ``gpt2.pos_ids`` is an extra name the decode graphs lack, and the
    teacher-forced logits equal the training graph's logits at each
    position, token by token and in chunks of 8 and 5."""
    cfg, tfeeds, tex, ids, _ = trained
    named = tex.return_tensor_values()
    weights = tht.params_from_named_arrays(named, "cpu")
    want = tex.run("eval", feed_dict={tfeeds["input_ids"]: ids})[0] \
        .asnumpy().reshape(cfg.batch_size, cfg.seq_len, cfg.vocab_size)
    eng = _engine(cfg, weights, chunked=True)
    decode_names = set(eng.iex.var_names.values())
    assert set(named) - decode_names == {"gpt2.pos_ids"}
    assert decode_names <= set(named)
    assert set(eng.ciex.var_names.values()) == decode_names
    for b in range(cfg.batch_size):
        tokens = ids[b].astype(np.int64)
        got = _one_token_logits(eng, tokens)
        np.testing.assert_allclose(got, want[b], rtol=0, atol=LOGITS_ATOL)
        for chunk in (8, 5):
            for pos, row in _chunked_logits(eng, tokens, chunk).items():
                np.testing.assert_allclose(row, want[b, pos], rtol=0,
                                           atol=LOGITS_ATOL)


def test_trained_weights_with_a_missing_variable_are_not_reinitialised(
        trained):
    cfg, _, tex, _, _ = trained
    named = tex.return_tensor_values()
    del named[next(n for n in sorted(named) if "h1.mlp_fc" in n)]
    with pytest.raises(RuntimeWarning, match="provides no value"):
        _engine(cfg, tht.params_from_named_arrays(named, "cpu"),
                chunked=False)


def test_synthetic_lm_batch_is_the_jax_packages():
    cfg = tht.GPT2Config.tiny(**CFG)
    for got, want in zip(tht.synthetic_lm_batch(cfg, seed=3),
                         jgpt2.synthetic_lm_batch(
                             jgpt2.GPT2Config.tiny(**CFG), seed=3)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", ["small", "medium", "tiny"])
def test_gpt2_configs_match_jax(size):
    got = vars(getattr(tht.GPT2Config, size)())
    assert got == vars(getattr(jgpt2.GPT2Config, size)())


@pytest.mark.parametrize("graph", ["lm", "decode", "chunked"])
def test_gpt2_graph_names_match_jax(graph):
    """Node op types and placeholder / variable names line up one for
    one, so weights carry by name and the graphs lower op for op."""
    def build(models):
        cfg = models.GPT2Config.tiny(**CFG)
        if graph == "lm":
            return [models.gpt2_lm_graph(cfg)[1]]
        fn = models.gpt2_decode_graph if graph == "decode" \
            else models.gpt2_decode_chunked_graph
        _, logits, caches, _ = fn(cfg, max_len=32)
        return [logits] + list(caches)
    jt, tt = jax_topo(build(jgpt2)), tht.topo_sort(build(tht.models))
    assert [n.op_type for n in tt] == [n.op_type for n in jt]
    assert [n.name for n in tt if isinstance(n, tht.PlaceholderOp)] == \
        [n.name for n in jt if isinstance(n, jht.PlaceholderOp)]
