"""Every optimizer of the port against the JAX package: a 10-step
trajectory on the same small graph (a two-layer tanh MLP under sparse
softmax cross-entropy) from the same numpy weights and feeds, float32.
Losses and final weights agree within atol 1e-6 (the two libraries round
the same float32 formulas in a few places differently)."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                 # noqa: E402
import hetu_tpu_torch as tht           # noqa: E402

ATOL = 1e-6
STEPS = 10

OPTIMIZERS = {
    "sgd": ("SGDOptimizer", dict(learning_rate=0.1)),
    "sgd_l2reg": ("SGDOptimizer", dict(learning_rate=0.1, l2reg=0.01)),
    "momentum": ("MomentumOptimizer", dict(learning_rate=0.05,
                                           momentum=0.9)),
    "nesterov": ("MomentumOptimizer", dict(learning_rate=0.05,
                                           momentum=0.9, nesterov=True)),
    "adagrad": ("AdaGradOptimizer", dict(learning_rate=0.05,
                                         initial_accumulator_value=0.1)),
    "adam": ("AdamOptimizer", dict(learning_rate=0.01)),
    "adam_amsgrad": ("AdamOptimizer", dict(learning_rate=0.01,
                                           amsgrad=True)),
    "adam_l2reg": ("AdamOptimizer", dict(learning_rate=0.01, l2reg=0.01)),
    "adamw": ("AdamWOptimizer", dict(learning_rate=0.01,
                                     weight_decay=0.05)),
    "lamb": ("LambOptimizer", dict(learning_rate=0.01, weight_decay=0.01)),
}


def _weights():
    rng = np.random.RandomState(0)
    return {"w1": (rng.randn(6, 5) * 0.5).astype(np.float32),
            "b1": (rng.randn(5) * 0.1).astype(np.float32),
            "w2": (rng.randn(5, 4) * 0.5).astype(np.float32),
            "b2": np.zeros(4, np.float32)}


def _run(ht, opt_name, kw, device=None):
    w = _weights()
    x = ht.placeholder_op("x")
    y = ht.placeholder_op("y", dtype=np.int32)
    vs = {k: ht.Variable(k, value=v) for k, v in w.items()}
    h = ht.tanh_op(ht.matmul_op(x, vs["w1"]) + vs["b1"])
    logits = ht.matmul_op(h, vs["w2"]) + vs["b2"]
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_sparse_op(logits, y), [0])
    opt = getattr(ht.optim, opt_name)(**kw)
    dev = {} if device is None else {"device": device}
    ex = ht.Executor({"train": [loss, opt.minimize(loss)]}, seed=0, **dev)
    rng = np.random.RandomState(1)
    fd = {x: rng.randn(8, 6).astype(np.float32),
          y: rng.randint(0, 4, size=8).astype(np.int32)}
    losses = [float(np.asarray(ex.run("train", feed_dict=fd)[0].asnumpy()))
              for _ in range(STEPS)]
    return losses, ex.return_tensor_values()


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_jax(case):
    opt_name, kw = OPTIMIZERS[case]
    want_loss, want_w = _run(jht, opt_name, kw)
    got_loss, got_w = _run(tht, opt_name, kw, device="cpu")
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=ATOL)
    assert got_loss[-1] < got_loss[0]
    assert sorted(got_w) == sorted(want_w)
    for name in want_w:
        np.testing.assert_allclose(got_w[name], np.asarray(want_w[name]),
                                   rtol=0, atol=ATOL, err_msg=name)

