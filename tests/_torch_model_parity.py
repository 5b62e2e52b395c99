"""Shared harness of the model parity tests (``test_torch_vit_swin.py``,
``test_torch_mae_clip.py``, ``test_torch_text_models.py``,
``test_torch_transfoxl_reformer.py``): one model built in both packages
from one config, the JAX ``Executor(seed=0)`` weights loaded into the
port by name (``load_dict``), the same feeds through both, 5 Adam steps.

Gates (those of ``tests/test_torch_xlnet.py``, float32): the step-1 loss
at ``rtol=0, atol=1e-5``; every trainable variable's step-1 gradient at
``allclose(rtol=1e-4, atol=1e-6)``; the 5-step Adam loss trajectory at
``rtol=1e-5``.  Both packages run attention through their plain versions
on the CPU; the port counts each such call as a ``backend:cpu`` fallback,
which the tests count against the model's attention calls."""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu import models as jmodels                     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo     # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics                        # noqa: E402
from hetu_tpu_torch import models as tmodels              # noqa: E402

LOSS_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TRAJ_RTOL = 1e-5
STEPS = 5


def build(port, config, graph, cfg_kw, lr=1e-3):
    """``graph`` of ``config.tiny(**cfg_kw)`` in the port (``port``) or
    the JAX package, with the gradient of every trainable variable and an
    Adam step.  Returns (cfg, feeds, executor, trainable variables)."""
    ht, models, topo = (tht, tmodels, tht.topo_sort) if port \
        else (jht, jmodels, jax_topo)
    cfg = getattr(models, config).tiny(**cfg_kw)
    feeds, loss, _ = getattr(models, graph)(cfg)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(lr).minimize(loss)
    kw = {"device": "cpu"} if port else {}
    ex = ht.Executor({"train": [loss, train_op] + grads}, seed=0, **kw)
    return cfg, feeds, ex, wrt


def train_both(config, graph, cfg_kw, batch, steps=STEPS):
    """Both executors over ``steps`` Adam steps from the JAX package's
    weights on the feeds ``batch`` ({feed name: array}).  Returns the
    record the checks read."""
    jcfg, jfeeds, jex, jwrt = build(False, config, graph, cfg_kw)
    tcfg, tfeeds, tex, twrt = build(True, config, graph, cfg_kw)
    names = [n.name for n in jwrt]
    assert [n.name for n in twrt] == names
    assert sorted(tex.var_names.values()) == sorted(jex.var_names.values())
    tex.load_dict(jex.return_tensor_values())
    jfd = {jfeeds[k]: v for k, v in batch.items()}
    tfd = {tfeeds[k]: v for k, v in batch.items()}
    metrics.reset_flash_fallbacks()
    rec = {"names": names, "jl": [], "tl": [], "cfg": tcfg, "tex": tex,
           "jex": jex}
    for step in range(steps):
        jout = jex.run("train", feed_dict=jfd)
        tout = tex.run("train", feed_dict=tfd)
        rec["jl"].append(float(np.asarray(jout[0].asnumpy())))
        rec["tl"].append(float(tout[0].asnumpy()))
        if step == 0:
            rec["jg"] = [np.asarray(g.asnumpy()) for g in jout[2:]]
            rec["tg"] = [g.asnumpy() for g in tout[2:]]
    rec["fallbacks"] = metrics.flash_fallback_counts()
    return rec


def check_step(rec, attention_calls):
    """The step-1 loss and every gradient at the gates; each attention
    call of each step took the plain version only because the tensors
    are on the CPU (``attention_calls`` a step)."""
    np.testing.assert_allclose(rec["tl"][0], rec["jl"][0], rtol=0,
                               atol=LOSS_ATOL)
    assert len(rec["tg"]) == len(rec["jg"]) == len(rec["names"])
    for name, jg, tg in zip(rec["names"], rec["jg"], rec["tg"]):
        assert tg.shape == jg.shape, name
        np.testing.assert_allclose(tg, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    want = {"backend:cpu": STEPS * attention_calls} if attention_calls \
        else {}
    assert rec["fallbacks"] == want


def check_trajectory(rec):
    """The 5 Adam losses at the gate, and the loss falls."""
    np.testing.assert_allclose(rec["tl"], rec["jl"], rtol=TRAJ_RTOL, atol=0)
    assert rec["tl"][-1] < rec["tl"][0]


def names_and_shapes(port, config, graph, cfg_kw):
    """Every variable of the graph: (name, shape, trainable), sorted."""
    models, topo = (tmodels, tht.topo_sort) if port else (jmodels, jax_topo)
    _, loss, _ = getattr(models, graph)(getattr(models, config).tiny(
        **cfg_kw))
    return sorted((n.name, tuple(n.shape), bool(n.trainable))
                  for n in topo([loss]) if getattr(n, "is_variable", False))


def lm_batch(vocab, batch, seq, seed=0):
    """Seeded next-token ids and labels (B, S) int32."""
    ids = np.random.RandomState(seed).randint(
        0, vocab, (batch, seq + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def mlm_batch(vocab, batch, seq, seed=0):
    """Seeded ids and labels (B, S) int32, 15 % of the positions labelled
    with their id and -1 elsewhere (``tests/test_models.py``'s draw)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.where(rng.rand(batch, seq) < 0.15, ids, -1).astype(np.int32)
    return {"input_ids": ids, "labels": labels}
