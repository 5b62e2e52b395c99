"""T5 seq2seq training in the port against the JAX package.

Both packages build ``t5_seq2seq_graph`` on ``T5Config.tiny`` (2 + 2
layers, 128 wide, 2 heads, vocabulary 512; batch 2, source 16, target 12,
dropout 0), with and without ``use_mask`` (a padded source batch from
``synthetic_seq2seq_batch(padded=True)``).  The JAX ``Executor(seed=0)``
weights go into the port through ``load_dict``; then the same feeds go
through both.  Both run the biased attention through their plain
versions here on the CPU (the JAX package's ``sdpa_reference``, the
port's counted ``backend:cpu`` path); the port's bias kernels are held to
the Pallas kernels in tests/test_torch_flash_attention.py.

Tolerances (float32): step-1 loss atol 1e-5; every variable's gradient,
the relative-position tables included, ``allclose(rtol=1e-4,
atol=1e-6)``; a 5-step Adam loss trajectory rtol 1e-5.

T5 attends at scale 1.0.  With the packages' Xavier-initialised query
projections the unscaled logits have a standard deviation near sqrt(64)
= 8, the softmax rows are close to one-hot, and its backward cancels
(dP - delta is near 0 on the dominant key).  The two frameworks' float32
summation orders then differ by up to 11.5x the gradient tolerance
above: the shared embedding's gradient by 2.9e-5 at a largest entry of
0.37, the first encoder block's q/k weights by 1.5x (dense; 2.5x and
below 1x with ``use_mask``).  T5 initialises the query projection with
std (d_model * d_kv)^-1/2 so that these logits are O(1); the main
comparison does the same by scaling every ``*.q.weight`` by 1/8 in both
packages, and then agrees to 1 % of the tolerance.  The graph as both
packages initialise it is compared too, at tolerances set from that
spread: step-1 loss atol 1e-5, each gradient ``allclose(rtol=1e-4,
atol=max(1e-6, 2e-4 x its largest entry))`` (the worst measured 8.8e-5
x), the 5 Adam losses rtol 2e-3 (measured 4.0e-4 dense, 2.9e-6 with
``use_mask``: Adam's normalised steps carry the step-1 spread into the
weights)."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo     # noqa: E402
from hetu_tpu.models import t5 as jt5                     # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics                        # noqa: E402
from hetu_tpu_torch.models import t5 as tt5               # noqa: E402

CFG = dict(batch_size=2, src_len=16, tgt_len=12, dropout_rate=0.0)
#: brings the unscaled attention logits to O(1), as T5's own init does
Q_SCALE = 0.125


def _trainable(loss, topo):
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def _build(ht, models, topo, use_mask, device=None):
    cfg = models.T5Config.tiny(**CFG)
    feeds, loss, _ = models.t5_seq2seq_graph(cfg, use_mask=use_mask)
    wrt = _trainable(loss, topo)
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-3).minimize(loss)
    kw = {} if device is None else {"device": device}
    ex = ht.Executor({"train": [loss, train_op] + grads}, seed=0, **kw)
    return cfg, feeds, ex, [n.name for n in wrt]


def _feeds(feeds, batch):
    keys = ["input_ids", "decoder_input_ids", "labels", "attention_mask"]
    return {feeds[k]: v for k, v in zip(keys, batch)}


def _train_both(use_mask, q_scale):
    """Both executors over 5 Adam steps from the JAX package's weights,
    every ``*.q.weight`` scaled by ``q_scale``."""
    jcfg, jfeeds, jex, jnames = _build(jht, jt5, jax_topo, use_mask)
    tcfg, tfeeds, tex, tnames = _build(tht, tt5, tht.topo_sort, use_mask,
                                       device="cpu")
    assert tnames == jnames
    assert sorted(tex.var_names.values()) == sorted(jex.var_names.values())
    weights = {name: w * q_scale if name.endswith(".q.weight") else w
               for name, w in jex.return_tensor_values().items()}
    jex.load_dict(weights)
    tex.load_dict(weights)
    batch = jt5.synthetic_seq2seq_batch(jcfg, seed=0, padded=use_mask)
    if use_mask:
        assert 0 < batch[3].sum() < batch[3].size     # padding is real
    jfd, tfd = _feeds(jfeeds, batch), _feeds(tfeeds, batch)
    metrics.reset_flash_fallbacks()
    rec = {"names": jnames, "jl": [], "tl": [], "cfg": tcfg}
    for step in range(5):
        jout = jex.run("train", feed_dict=jfd)
        tout = tex.run("train", feed_dict=tfd)
        rec["jl"].append(float(np.asarray(jout[0].asnumpy())))
        rec["tl"].append(float(tout[0].asnumpy()))
        if step == 0:
            rec["jg"] = [np.asarray(g.asnumpy()) for g in jout[2:]]
            rec["tg"] = [g.asnumpy() for g in tout[2:]]
    rec["fallbacks"] = metrics.flash_fallback_counts()
    return rec


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "use_mask"])
def trained(request):
    return _train_both(request.param, Q_SCALE)


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "use_mask"])
def unscaled(request):
    return _train_both(request.param, 1.0)


def test_t5_training_step_matches_jax(trained):
    rec = trained
    cfg = rec["cfg"]
    np.testing.assert_allclose(rec["tl"][0], rec["jl"][0], rtol=0, atol=1e-5)
    # shared embedding, lm head, two relpos tables, per encoder block
    # 2 norms + q/k/v/o weights and biases + wi/wo, per decoder block 3
    # norms + 2 x 8 attention + wi/wo, two final norms
    n = 2 + 2 + cfg.num_layers * (2 + 8 + 2) \
        + cfg.num_layers * (3 + 16 + 2) + 2
    assert len(rec["names"]) == len(rec["tg"]) == n
    assert sum(name.endswith(".relpos") for name in rec["names"]) == 2
    for name, jg, tg in zip(rec["names"], rec["jg"], rec["tg"]):
        assert tg.shape == jg.shape, name
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    relpos = [g for name, g in zip(rec["names"], rec["tg"])
              if name.endswith(".relpos")]
    assert all(np.abs(g).max() > 0 for g in relpos)
    # every attention call took the plain version only because the tensors
    # are on the CPU: self, cross and encoder attention, per layer and step
    assert rec["fallbacks"] == {"backend:cpu": 5 * 3 * cfg.num_layers}


def test_t5_five_adam_steps_match_jax(trained):
    np.testing.assert_allclose(trained["tl"], trained["jl"], rtol=1e-5,
                               atol=0)
    assert trained["tl"][-1] < trained["tl"][0]


def test_t5_unscaled_init_matches_jax_within_its_spread(unscaled):
    rec = unscaled
    np.testing.assert_allclose(rec["tl"][0], rec["jl"][0], rtol=0, atol=1e-5)
    for name, jg, tg in zip(rec["names"], rec["jg"], rec["tg"]):
        assert tg.shape == jg.shape, name
        np.testing.assert_allclose(
            tg, jg, rtol=1e-4, atol=max(1e-6, 2e-4 * float(np.abs(jg).max())),
            err_msg=name)
    np.testing.assert_allclose(rec["tl"], rec["jl"], rtol=2e-3, atol=0)
    assert rec["tl"][-1] < rec["tl"][0]
    assert rec["fallbacks"] == {"backend:cpu": 5 * 3 * rec["cfg"].num_layers}


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_bucket_and_configs_equal_the_jax_package(bidirectional):
    rel = np.arange(-300, 300)[None, :] - np.arange(40)[:, None]
    for nb, md in ((32, 128), (8, 20)):
        np.testing.assert_array_equal(
            tt5._relative_bucket(rel, bidirectional, nb, md),
            jt5._relative_bucket(rel, bidirectional, nb, md))
    for make in ("small", "tiny"):
        assert vars(getattr(tt5.T5Config, make)()) \
            == vars(getattr(jt5.T5Config, make)())
    for seed, padded in ((0, False), (3, True)):
        cfg = tt5.T5Config.tiny(**CFG)
        for a, b in zip(tt5.synthetic_seq2seq_batch(cfg, seed, padded),
                        jt5.synthetic_seq2seq_batch(cfg, seed, padded)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.int32


def test_t5_graph_variable_names_equal_the_jax_package():
    def names(models, topo):
        cfg = models.T5Config.tiny(**CFG)
        _, loss, _ = models.t5_seq2seq_graph(cfg, use_mask=True)
        return sorted((n.name, tuple(n.shape), bool(n.trainable))
                      for n in topo([loss])
                      if getattr(n, "is_variable", False))
    assert names(tt5, tht.topo_sort) == names(jt5, jax_topo)
