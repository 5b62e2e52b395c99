"""Learning-rate schedules in the port against the JAX package.

* Each scheduler's float32 rate at steps 0-200 (``traced``, the value the
  step uses) is within one float32 ulp of ``jax.jit(sched.traced)(step)``
  on XLA's CPU backend (the port reproduces XLA's rewrites of the
  expression: a division by a constant as a product with its reciprocal,
  ``a * b + c`` fused; what is left is XLA's float32 ``cos``, one ulp from
  a correctly rounded one on about 1 % of inputs).  ``get`` is the same
  float64 value in both.
* ReduceOnPlateau follows the same ``step(metric)`` sequence.
* Tiny BERT (``tests/test_torch_bert.py``'s configuration, the JAX
  weights loaded by name) takes 6 Adam steps under Cosine, MultiStep and
  a ReduceOnPlateau stepped on the loss, and a number rate reassigned
  mid-run, at that file's gates: step-1 loss atol 1e-5, the trajectory
  rtol 1e-5."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.models import bert as jbert                 # noqa: E402
from hetu_tpu.optim import lr_scheduler as jlr            # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch.optim import lr_scheduler as tlr      # noqa: E402

STEPS = range(201)
SCHEDULES = {
    "fixed": ("FixedScheduler", (1e-3,), {}),
    "step": ("StepScheduler", (0.1, 7), dict(gamma=0.5)),
    "multistep": ("MultiStepScheduler", (0.1, [10, 50, 120]),
                  dict(gamma=0.3)),
    "exponential": ("ExponentialScheduler", (0.1,), dict(gamma=0.97)),
    "cosine": ("CosineScheduler", (1e-4, 10, 150), dict(min_ratio=0.1)),
    "cosine_short": ("CosineScheduler", (3e-4, 2, 8), {}),
    "cosine_long": ("CosineScheduler", (1e-3, 5, 200), {}),
}
BERT_CFG = dict(batch_size=2, seq_len=24, hidden_size=32,
                intermediate_size=64, vocab_size=96, num_hidden_layers=2,
                num_attention_heads=2, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
BERT_STEPS = 6


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_float32_rate_within_one_ulp_of_jax(case):
    import jax
    import jax.numpy as jnp
    name, args, kw = SCHEDULES[case]
    js, ts = getattr(jlr, name)(*args, **kw), getattr(tlr, name)(*args, **kw)
    traced = jax.jit(js.traced)
    want = np.array([np.float32(traced(jnp.int32(s))) for s in STEPS])
    got = np.array([ts.traced(s) for s in STEPS])
    assert got.dtype == np.float32
    assert _ulps(got, want).max() <= 1
    assert [ts.get(s) for s in STEPS] == [js.get(s) for s in STEPS]
    opt = tht.optim.AdamOptimizer(ts)
    assert [opt.step_lr(s) for s in STEPS] == list(got)


def test_reduce_on_plateau_follows_the_same_metric_sequence():
    kw = dict(factor=0.5, patience=2, cooldown=1, min_lr=1e-4)
    js = jlr.ReduceOnPlateauScheduler(0.1, **kw)
    ts = tlr.ReduceOnPlateauScheduler(0.1, **kw)
    assert ts.traced(0) is None
    metrics = np.r_[np.linspace(1.0, 0.8, 5), np.full(12, 0.8),
                    np.linspace(0.79, 0.7, 3), np.full(20, 0.7)]
    opt = tht.optim.SGDOptimizer(ts)
    for step, m in enumerate(metrics):
        js.step(m)
        ts.step(m)
        assert (ts.lr, ts.best, ts.num_bad, ts.cooldown_left) == \
            (js.lr, js.best, js.num_bad, js.cooldown_left)
        assert opt.step_lr(step) == np.float32(js.get(step))
    assert ts.lr < 0.1


def _bert(ht, models, lr, device=None):
    cfg = models.BertConfig.tiny(**BERT_CFG)
    feeds, loss, _ = models.bert_pretrain_graph(cfg)
    opt = ht.optim.AdamOptimizer(lr)
    kw = {"validate": "off"} if device is None else {"device": device}
    ex = ht.Executor({"train": [loss, opt.minimize(loss)]}, seed=0, **kw)
    ids, tt, labels, attn = jbert.synthetic_mlm_batch(cfg, seed=0)
    fd = {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
          feeds["masked_lm_labels"]: labels, feeds["attention_mask"]: attn}
    return ex, fd, opt


def _schedule(pkg, case):
    return {"cosine": lambda: pkg.CosineScheduler(1e-3, 2, 5),
            "multistep": lambda: pkg.MultiStepScheduler(2e-3, [2, 4],
                                                        gamma=0.3),
            "plateau": lambda: pkg.ReduceOnPlateauScheduler(
                2e-3, factor=0.5, patience=0),
            "reassigned": lambda: 1e-3}[case]()


@pytest.mark.parametrize("case", ["cosine", "multistep", "plateau",
                                  "reassigned"])
def test_tiny_bert_trains_under_the_schedule_as_jax_does(case):
    jex, jfd, jopt = _bert(jht, jbert, _schedule(jlr, case))
    tex, tfd, topt = _bert(tht, tht.models, _schedule(tlr, case),
                           device="cpu")
    tex.load_dict(jex.return_tensor_values())
    jl, tl = [], []
    for step in range(BERT_STEPS):
        jl.append(float(np.asarray(jex.run("train", feed_dict=jfd)[0]
                                   .asnumpy())))
        tl.append(float(tex.run("train", feed_dict=tfd)[0].asnumpy()))
        if case == "plateau":
            # the metric climbs after step 2: the rate halves each step
            m = jl[-1] + max(0, step - 2)
            jopt.lr.step(m)
            topt.lr.step(m)
        if case == "reassigned" and step == 2:
            jopt.lr = topt.lr = 3e-3
    np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    if case == "plateau":
        assert topt.lr.lr < 2e-3
    if case in ("cosine", "multistep"):
        # the schedule moved the rate within the run
        assert len({topt.step_lr(s) for s in range(BERT_STEPS)}) > 1
    assert tex.step_counter == BERT_STEPS
