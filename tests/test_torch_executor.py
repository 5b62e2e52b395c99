"""The port's training executor against the JAX package's: the MLP of the
``hetu_tpu`` package docstring (a 784 → 10 softmax regression under SGD)
gives the same loss and the same ``gradients`` fetches in both packages
from the same weights (atol 1e-6, float32), plus the executor's own
contract: ``run`` returns ``NDArray``s, ``step_counter`` advances on
training subgraphs only, ``load_dict`` / ``return_tensor_values``
round-trip, and unported options fail by name."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                 # noqa: E402
import hetu_tpu_torch as tht           # noqa: E402

ATOL = 1e-6


def _mlp(ht):
    """The package docstring's example graph, with gradient fetches."""
    x = ht.placeholder_op("x")
    y_ = ht.placeholder_op("y_")
    w = ht.init.xavier_uniform((784, 10), name="w")
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(x, w), y_), [0])
    (gw,) = ht.gradients(loss, [w])
    train_op = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return x, y_, loss, gw, train_op


def _feeds(x, y_):
    rng = np.random.RandomState(0)
    return {x: rng.rand(8, 784).astype(np.float32),
            y_: np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)]}


def test_docstring_mlp_matches_jax():
    jx, jy, jloss, jgw, jtrain = _mlp(jht)
    tx, ty, tloss, tgw, ttrain = _mlp(tht)
    jex = jht.Executor({"train": [jloss, jgw, jtrain]}, seed=0)
    tex = tht.Executor({"train": [tloss, tgw, ttrain]}, seed=0,
                       device="cpu")
    tex.load_dict(jex.return_tensor_values())
    jfd, tfd = _feeds(jx, jy), _feeds(tx, ty)
    for _ in range(3):
        jl, jg, jnone = jex.run("train", feed_dict=jfd)
        tl, tg, tnone = tex.run("train", feed_dict=tfd)
        assert jnone is None and tnone is None
        np.testing.assert_allclose(tl.asnumpy(), np.asarray(jl.asnumpy()),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(tg.asnumpy(), np.asarray(jg.asnumpy()),
                                   rtol=0, atol=ATOL)
    np.testing.assert_allclose(tex.return_tensor_values()["w"],
                               np.asarray(jex.return_tensor_values()["w"]),
                               rtol=0, atol=ATOL)


def test_run_returns_ndarrays_and_counts_training_steps():
    x, y_, loss, gw, train_op = _mlp(tht)
    ex = tht.Executor({"train": [loss, gw, train_op], "eval": [loss]},
                      seed=0, device="cpu")
    fd = _feeds(x, y_)
    out = ex.run("train", feed_dict=fd)
    assert isinstance(out[0], tht.NDArray) and out[0].shape == ()
    assert out[1].shape == (784, 10) and out[1].dtype == torch.float32
    assert out[2] is None
    assert ex.step_counter == 1
    ex.run("eval", feed_dict=fd)                     # no training: no step
    assert ex.step_counter == 1
    ev = ex.run("eval", feed_dict=fd, convert_to_numpy_ret_vals=True)
    assert isinstance(ev[0], np.ndarray)
    ex.run("train", feed_dict=fd)
    assert ex.step_counter == 2
    with pytest.raises(ValueError, match="missing feed"):
        ex.run("train", feed_dict={x: fd[x]})


def test_load_dict_and_return_tensor_values_round_trip():
    x, y_, loss, gw, train_op = _mlp(tht)
    a = tht.Executor({"train": [loss, train_op]}, seed=0, device="cpu")
    b = tht.Executor({"train": [loss, train_op]}, seed=1, device="cpu")
    assert not np.array_equal(a.return_tensor_values()["w"],
                              b.return_tensor_values()["w"])
    b.load_dict(dict(a.return_tensor_values(), unknown=np.zeros(3)))
    for name, val in a.return_tensor_values().items():
        np.testing.assert_array_equal(b.return_tensor_values()[name], val)
    fd = _feeds(x, y_)
    np.testing.assert_array_equal(a.run("train", feed_dict=fd)[0].asnumpy(),
                                  b.run("train", feed_dict=fd)[0].asnumpy())


@pytest.mark.parametrize("opt", ["dist_strategy", "mesh", "zero", "remat",
                                 "plan", "pipeline", "num_microbatches",
                                 "matmul_precision", "compute_dtype",
                                 "timing"])
def test_unported_executor_options_raise_by_name(opt):
    _, _, loss, _, train_op = _mlp(tht)
    # compute_dtype is ported for bfloat16 only; float16 stays refused
    value = {"compute_dtype": "float16", "remat": "dots", "zero": 1,
             "num_microbatches": 4, "pipeline": "gpipe",
             "timing": True}.get(opt, object())
    with pytest.raises(NotImplementedError, match=opt):
        tht.Executor({"train": [loss, train_op]}, device="cpu",
                     **{opt: value})


def test_non_blocking_run_is_not_ported():
    x, y_, loss, _, train_op = _mlp(tht)
    ex = tht.Executor({"train": [loss, train_op]}, device="cpu")
    with pytest.raises(NotImplementedError, match="sync=False"):
        ex.run("train", feed_dict=_feeds(x, y_), sync=False)
