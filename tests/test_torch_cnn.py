"""The CNN path of the port (``ops/nn.py``'s convolution, pooling and
normalization ops, ``models/cnn.py``'s zoo) against the JAX package's
(``hetu_tpu/ops/nn.py``, ``examples/cnn/models``), in float32 on the CPU.

Ops: each lowering of the port against the JAX package's on the same
numpy inputs, the value and the gradient of every input for a seeded
cotangent (``jax.vjp`` against ``torch.autograd.grad``); convolutions and
pools sum in another order: allclose(rtol=1e-5, atol=1e-5) (``OP_TOL``).

Models: ResNet-18 at full width (BASELINE config 1's model, batch 2) and
mlp, logreg, cnn_3_layers, lenet, alexnet and vgg16 (batch 2), built in
both packages; the JAX ``Executor(seed=0)`` weights go into the port
through ``load_dict(return_tensor_values())`` (the running statistics
too, named ``bn_running_mean``, ``bn_running_mean~1``, ... in both), the
same feeds go through both, ``MomentumOptimizer(0.1)`` (dropout off:
keep_prob 1.0 in both graphs, as every parity test of the port runs).
Tolerances, from the measured spread at batch 2 (beside each, the worst
measured ratio to it):

* ResNet-18: step-1 loss rtol 1e-5 (0.016); every step-1 gradient
  allclose(rtol=1e-4, atol=1e-5) (0.22); the running statistics after
  each of steps 1-4 allclose(rtol=1e-4, atol=1e-5) (0.18, 0.40, 0.65,
  0.74); the 5-step loss trajectory allclose(rtol=1e-4, atol=1e-5)
  (0.33).  The two samples are fit by step 3 (losses 2.93, 3.17, 4e-7,
  0.64, 0): step 4's gradient of a loss of 0 is rounding noise, so the
  statistics after step 5 are held only to a relative norm of 2e-2 a
  variable (measured 5.1e-3, 0.25).
* The zoo: loss rtol 1e-5; each gradient to a relative norm of 1e-2
  (``ZOO_GRAD_RELNORM``): 2.2e-5 at most for vgg16 (13 BatchNorms over
  batch 2, the last over 8 values a channel), 1e-6 for the others but
  alexnet, 3.2e-3 there (0.32): one pre-activation of its third
  convolution lies within float32 rounding of 0, so one ReLU passes its
  gradient in one package and stops it in the other, and every
  gradient below that layer moves by that one element."""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                       # noqa: E402
import hetu_tpu.ops as jops                                  # noqa: E402
from hetu_tpu.graph.node import LowerCtx as JaxCtx           # noqa: E402
from hetu_tpu.graph.node import placeholder_op as jax_ph     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo        # noqa: E402
import hetu_tpu_torch as tht                                 # noqa: E402
from hetu_tpu_torch.graph.node import LowerCtx as TorchCtx   # noqa: E402

OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
STATS_LAST_RELNORM = 2e-2
ZOO_GRAD_RELNORM = 1e-2
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 5
BATCH = 2


def jax_cnn_models():
    """``examples/cnn/models`` (the JAX package's model zoo), loaded under
    a name of its own so no other ``models`` package shadows it."""
    name = "_jax_cnn_models"
    if name not in sys.modules:
        base = os.path.join(ROOT, "examples", "cnn", "models")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(base, "__init__.py"),
            submodule_search_locations=[base])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _lower_both(jnode, tnode, arrays, training=False, n_diff=None):
    """Lower the two nodes on the same inputs; the outputs, the gradients
    of the first ``n_diff`` inputs (all by default) for one seeded
    cotangent, and both contexts of a lowering outside the
    differentiation (their ``state_updates``)."""
    assert jnode.op_type == tnode.op_type
    n_diff = len(arrays) if n_diff is None else n_diff
    jarr = [jnp.asarray(a) for a in arrays]
    jout, vjp = jax.vjp(
        lambda *xs: jnode.lower(JaxCtx(training), *xs, *jarr[n_diff:]),
        *jarr[:n_diff])
    cot = _rand(*jout.shape, seed=99)
    jgrads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=i < n_diff)
          for i, a in enumerate(arrays)]
    tout = tnode.lower(TorchCtx(training), *ts)
    tgrads = torch.autograd.grad(tout, ts[:n_diff], torch.from_numpy(cot))
    ctxs = (TorchCtx(training), JaxCtx(training))
    tnode.lower(ctxs[0], *[torch.from_numpy(a) for a in arrays])
    jnode.lower(ctxs[1], *jarr)
    return ((tout.detach().numpy(), np.asarray(jout)),
            [(t.numpy(), np.asarray(j)) for t, j in zip(tgrads, jgrads)],
            ctxs)


def _op_both(name, arrays, training=False, **attrs):
    """``_lower_both`` of op ``name`` over placeholders."""
    n = len(arrays)
    jnode = getattr(jops, name)(*[jax_ph(f"x{i}") for i in range(n)],
                                **attrs)
    tnode = getattr(tht.ops, name)(*[tht.placeholder_op(f"x{i}")
                                     for i in range(n)], **attrs)
    return _lower_both(jnode, tnode, arrays, training)


def _close(pairs, **tol):
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **tol)


# -- ops --------------------------------------------------------------------

CONV_CASES = [  # (data_format, stride, padding, kernel)
    ("NCHW", 1, 1, 3), ("NCHW", 2, 0, 3), ("NCHW", 2, 2, 5),
    ("NCHW", 1, 0, 1), ("NHWC", 1, 1, 3), ("NHWC", 2, 1, 3),
    ("NHWC", 2, 0, 1)]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("df,stride,padding,k", CONV_CASES)
def test_conv2d_matches_jax(df, stride, padding, k, bias):
    x = _rand(2, 9, 9, 3, seed=1) if df == "NHWC" else _rand(2, 3, 9, 9,
                                                            seed=1)
    arrays = [x, _rand(4, 3, k, k, seed=2)] + ([_rand(4, seed=3)]
                                               if bias else [])
    out, grads, _ = _op_both("conv2d_add_bias_op" if bias else "conv2d_op",
                             arrays, stride=stride, padding=padding,
                             data_format=df)
    _close([out] + grads, **OP_TOL)


POOL_CASES = [  # (kernel, stride, padding): the last two pad past half the
    (2, 2, 0), (3, 2, 1), (3, 1, 2), (2, 2, 2), (4, 4, 0)]  # kernel


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("k,stride,padding", POOL_CASES)
def test_pool2d_matches_jax(kind, k, stride, padding, df):
    """Max pads with -inf, average counts the padding (sum / k^2), as
    ``reduce_window``; padding above half the kernel, which torch's pools
    refuse, is applied before an unpadded pool.  Distinct random inputs, so
    no window's max ties."""
    x = _rand(2, 8, 8, 3, seed=4) if df == "NHWC" else _rand(2, 3, 8, 8,
                                                            seed=4)
    out, grads, _ = _op_both(f"{kind}_pool2d_op", [x], kernel_H=k,
                             kernel_W=k, padding=padding, stride=stride,
                             data_format=df)
    _close([out] + grads, **OP_TOL)


def _bn_nodes(df, training, momentum=0.9):
    scale = (_rand(5, seed=5) * 0.5 + 1.0)
    bias = _rand(5, seed=6)
    jn = jops.batch_normalization_op(
        jax_ph("x"), jht.Variable("s", value=scale),
        jht.Variable("b", value=bias), momentum=momentum, eps=1e-5,
        data_format=df)
    tn = tht.ops.batch_normalization_op(
        tht.placeholder_op("x"), tht.Variable("s", value=scale),
        tht.Variable("b", value=bias), momentum=momentum, eps=1e-5,
        data_format=df)
    x = _rand(4, 6, 6, 5, seed=7) if df == "NHWC" else _rand(4, 5, 6, 6,
                                                            seed=7)
    x = x * 3.0 + 1.5
    rmean, rvar = _rand(5, seed=8), np.abs(_rand(5, seed=9)) + 0.5
    return jn, tn, [x, scale, bias, rmean, rvar]


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(df, training):
    """Output; the gradients of x, scale and bias; in training both running
    statistics, each ``(1 - momentum) * running + momentum * batch`` with the
    batch's biased variance (torch's own running update would take the
    unbiased one)."""
    jn, tn, arrays = _bn_nodes(df, training)
    out, grads, (tctx, jctx) = _lower_both(jn, tn, arrays, training,
                                           n_diff=3)
    _close([out] + grads, **OP_TOL)
    if training:
        assert set(tctx.state_updates) == {tn.running_mean, tn.running_var}
        for tnode, jnode in ((tn.running_mean, jn.running_mean),
                             (tn.running_var, jn.running_var)):
            np.testing.assert_allclose(
                tctx.state_updates[tnode].detach().numpy(),
                np.asarray(jctx.state_updates[jnode]), **OP_TOL)
        x = arrays[0] if df == "NCHW" else arrays[0].transpose(0, 3, 1, 2)
        biased = x.var(axis=(0, 2, 3))
        np.testing.assert_allclose(
            tctx.state_updates[tn.running_var].detach().numpy(),
            0.1 * arrays[4] + 0.9 * biased, rtol=1e-5)
    else:
        assert not tctx.state_updates


def test_batch_norm_running_stats_are_shaped_as_the_scale():
    _, tn, _ = _bn_nodes("NCHW", True)
    assert tn.running_mean.shape == tn.running_var.shape == (5,)
    assert (tn.running_mean.name, tn.running_var.name) == \
        ("bn_running_mean", "bn_running_var")
    assert not tn.running_mean.trainable
    with pytest.raises(ValueError, match="no shape"):
        tht.ops.batch_normalization_op(tht.placeholder_op("x"),
                                       tht.placeholder_op("s"),
                                       tht.placeholder_op("b"))


@pytest.mark.parametrize("name,attrs", [
    ("instance_normalization2d_op", {}), ("softmax_op", {}),
    ("log_softmax_op", {}), ("leaky_relu_op", {"alpha": 0.2}),
    ("relu_op", {})])
def test_activation_and_norm_ops_match_jax(name, attrs):
    out, grads, _ = _op_both(name, [_rand(2, 3, 5, 7, seed=10) * 2.0],
                             **attrs)
    _close([out] + grads, **OP_TOL)
    np.testing.assert_allclose(
        tht.ops.softmax_func(torch.from_numpy(_rand(3, 6))).numpy(),
        np.asarray(jops.softmax_func(jnp.asarray(_rand(3, 6)))), **OP_TOL)


@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_dropout2d_drops_whole_channels(keep):
    """keep_prob 1.0: the input, exactly, in both packages.  Below: every
    (n, c) map is either 0 or x / keep in both, and each package keeps a
    fraction of the 4,096 maps within 4 sigma of keep (the masks' bits
    differ: two generators)."""
    x = np.abs(_rand(64, 64, 3, 3, seed=11)) + 0.1
    jnode = jops.dropout2d_op(jax_ph("x"), keep)
    tnode = tht.ops.dropout2d_op(tht.placeholder_op("x"), keep)
    jout = np.asarray(jnode.lower(JaxCtx(True, base_key=jax.random.key(0)),
                                  jnp.asarray(x)))
    tout = tnode.lower(TorchCtx(True, torch.Generator().manual_seed(0)),
                       torch.from_numpy(x)).numpy()
    if keep == 1.0:
        np.testing.assert_array_equal(tout, x)
        np.testing.assert_array_equal(jout, x)
        return
    sigma = np.sqrt(keep * (1 - keep) / 4096)
    for out in (tout, jout):
        kept = np.all(out != 0, axis=(2, 3))
        dropped = np.all(out == 0, axis=(2, 3))
        assert np.all(kept | dropped)
        np.testing.assert_allclose(out[kept], (x / keep)[kept], rtol=1e-6)
        assert abs(kept.mean() - keep) < 4 * sigma


def test_conv_bn_pool_nhwc_matches_nchw():
    """The twin of tests/test_ops.py's check: ``data_format="NHWC"`` gives
    NCHW's numbers across conv with bias, BatchNorm and both pools."""
    rng = np.random.RandomState(3)
    xv = rng.rand(2, 3, 8, 8).astype(np.float32)
    wv = rng.randn(4, 3, 3, 3).astype(np.float32)
    bv = rng.randn(4).astype(np.float32)
    sv = rng.rand(4).astype(np.float32) + 0.5
    bb = rng.randn(4).astype(np.float32)

    def run(df):
        ht = tht
        x = ht.placeholder_op("x", shape=(2, 3, 8, 8))
        h = x if df == "NCHW" else ht.transpose_op(x, perm=(0, 2, 3, 1))
        h = ht.conv2d_add_bias_op(h, ht.Variable("w", value=wv),
                                  ht.Variable("b", value=bv), padding=1,
                                  stride=1, data_format=df)
        h = ht.batch_normalization_op(h, ht.Variable("s", value=sv),
                                      ht.Variable("b2", value=bb),
                                      data_format=df)
        h = ht.max_pool2d_op(h, 2, 2, padding=0, stride=2, data_format=df)
        h = ht.avg_pool2d_op(h, 2, 2, padding=0, stride=2, data_format=df)
        if df == "NHWC":
            h = ht.transpose_op(h, perm=(0, 3, 1, 2))
        ex = ht.Executor({"default": [h]}, seed=0, device="cpu")
        return ex.run("default", feed_dict={x: xv})[0].asnumpy()

    np.testing.assert_allclose(run("NCHW"), run("NHWC"), rtol=1e-5,
                               atol=1e-5)


# -- models -----------------------------------------------------------------

#: model -> the shape of one sample its ``x`` takes
ZOO = {"mlp": (784,), "logreg": (784,), "cnn_3_layers": (784,),
       "lenet": (784,), "alexnet": (3, 32, 32), "vgg16": (3, 32, 32)}


def build(jax_side, model, batch, sample_shape=(3, 32, 32), steps=True,
          compute_dtype=None, data_format="NCHW"):
    """(x, y, executor, trainable names) of one zoo model in one package:
    the loss, a ``MomentumOptimizer(0.1)`` step (``steps``) and the
    gradient of every trainable variable, dropout off."""
    ht = jht if jax_side else tht
    topo = jax_topo if jax_side else tht.topo_sort
    x = ht.placeholder_op("x", shape=(batch,) + sample_shape)
    y = ht.placeholder_op("y", shape=(batch, 10))
    fn = getattr(jax_cnn_models() if jax_side else tht.models, model)
    kw = {"data_format": data_format} if model.startswith("resnet") else {}
    loss, _ = fn(x, y, **kw)
    for node in topo([loss]):
        if node.op_type == "Dropout":
            node.attrs["keep_prob"] = 1.0
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    fetches = [loss] + ht.gradients(loss, wrt)
    if steps:
        fetches.insert(1, ht.optim.MomentumOptimizer(0.1).minimize(loss))
    kw = {"validate": "off"} if jax_side else {"device": "cpu"}
    ex = ht.Executor({"train": fetches}, seed=0,
                     compute_dtype=compute_dtype, **kw)
    return x, y, ex, [n.name for n in wrt]


def feeds(batch, sample_shape=(3, 32, 32), seed=0):
    """bench.py's resnet18 feeds: ``rand`` inputs, one-hot labels."""
    rng = np.random.RandomState(seed)
    xv = rng.rand(batch, *sample_shape).astype(np.float32)
    yv = np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)]
    return xv, yv


def _stats(values):
    return {k: v for k, v in values.items() if "_running_" in k}


@pytest.fixture(scope="module")
def resnet():
    """ResNet-18 at full width, batch 2: both packages over 5 Momentum
    steps from the JAX package's weights."""
    jx, jy, jex, jnames = build(True, "resnet18", BATCH)
    tx, ty, tex, tnames = build(False, "resnet18", BATCH)
    assert tnames == jnames
    rec = {"names": jnames, "var_names": (list(tex.var_names.values()),
                                          list(jex.var_names.values()))}
    tex.load_dict(jex.return_tensor_values())
    xv, yv = feeds(BATCH)
    rec["jl"], rec["tl"], rec["stats"] = [], [], []
    for step in range(STEPS):
        jout = jex.run("train", feed_dict={jx: xv, jy: yv})
        tout = tex.run("train", feed_dict={tx: xv, ty: yv})
        rec["jl"].append(float(np.asarray(jout[0].asnumpy())))
        rec["tl"].append(float(tout[0].asnumpy()))
        if step == 0:
            rec["jg"] = [np.asarray(g.asnumpy()) for g in jout[2:]]
            rec["tg"] = [g.asnumpy() for g in tout[2:]]
        rec["stats"].append((_stats(tex.return_tensor_values()),
                                 _stats(jex.return_tensor_values())))
    rec["shapes"] = {k: v.shape for k, v in
                     tex.return_tensor_values().items()}
    return rec


def test_resnet18_names_and_batchnorm_order_match_jax(resnet):
    """Every variable, the 20 BatchNorms' running statistics included, has
    the same checkpoint name in the same order in both packages, so
    ``load_dict`` puts each statistic on its own layer: the k-th
    ``bn_running_mean~k`` is the k-th BatchNorm in topological order
    (its width: 64 at the stem and stage 0, then 128, 256, 512)."""
    tnames, jnames = resnet["var_names"]
    assert tnames == jnames
    means = [n for n in tnames if n.startswith("bn_running_mean")]
    assert means == ["bn_running_mean"] + [f"bn_running_mean~{k}"
                                           for k in range(1, 20)]
    widths = [resnet["shapes"][n][0] for n in means]
    assert widths == [64] * 5 + [128] * 5 + [256] * 5 + [512] * 5
    # 20 convolutions, 20 BatchNorms (scale, bias), the head
    assert len(resnet["names"]) == 20 + 2 * 20 + 2


def test_resnet18_step_matches_jax(resnet):
    np.testing.assert_allclose(resnet["tl"][0], resnet["jl"][0],
                               rtol=LOSS_RTOL)
    for name, jg, tg in zip(resnet["names"], resnet["jg"], resnet["tg"]):
        assert tg.shape == jg.shape, name
        assert np.abs(jg).max() > 0, name
        np.testing.assert_allclose(tg, jg, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("after", range(1, STEPS + 1))
def test_resnet18_running_stats_match_jax(resnet, after):
    tstats, jstats = resnet["stats"][after - 1]
    assert sorted(tstats) == sorted(jstats) and len(tstats) == 40
    for name, want in jstats.items():
        if after < STEPS:
            np.testing.assert_allclose(tstats[name], want, err_msg=name,
                                       **STATS_TOL)
        else:
            err = np.linalg.norm(tstats[name] - want) / np.linalg.norm(want)
            assert err <= STATS_LAST_RELNORM, (name, err)
    # the statistics moved off their start (0 and 1) on every layer
    assert all(np.abs(v - (0.0 if "mean" in k else 1.0)).max() > 1e-3
               for k, v in tstats.items())


def test_resnet18_momentum_trajectory_matches_jax(resnet):
    np.testing.assert_allclose(resnet["tl"], resnet["jl"], **TRAJ_TOL)
    assert resnet["tl"][-1] < resnet["tl"][0]


@pytest.mark.parametrize("model", sorted(ZOO))
def test_zoo_model_step_matches_jax(model):
    """Loss and every gradient of one training step, batch 2, from the
    JAX package's weights (alexnet with its dropout off)."""
    shape = ZOO[model]
    jx, jy, jex, jnames = build(True, model, BATCH, shape, steps=False)
    tx, ty, tex, tnames = build(False, model, BATCH, shape, steps=False)
    assert tnames == jnames
    assert list(tex.var_names.values()) == list(jex.var_names.values())
    tex.load_dict(jex.return_tensor_values())
    xv, yv = feeds(BATCH, shape)
    jout = jex.run("train", feed_dict={jx: xv, jy: yv})
    tout = tex.run("train", feed_dict={tx: xv, ty: yv})
    np.testing.assert_allclose(float(tout[0].asnumpy()),
                               float(np.asarray(jout[0].asnumpy())),
                               rtol=LOSS_RTOL)
    for name, jg, tg in zip(jnames, jout[1:], tout[1:]):
        jg, tg = np.asarray(jg.asnumpy()), tg.asnumpy()
        assert tg.shape == jg.shape, name
        err = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
        assert err <= ZOO_GRAD_RELNORM, (name, err)


def test_resnet_nhwc_matches_nchw_in_the_port():
    """ResNet-18 with ``data_format="NHWC"`` (the transposed stem, every
    activation channels-last) gives the NCHW graph's loss and gradients
    from the same weights."""
    xv, yv = feeds(BATCH)
    out = {}
    for df in ("NCHW", "NHWC"):
        x, y, ex, names = build(False, "resnet18", BATCH, steps=False,
                                data_format=df)
        if df == "NHWC":
            ex.load_dict(weights)
        else:
            weights = ex.return_tensor_values()
        out[df] = [v.asnumpy() for v in ex.run("train",
                                               feed_dict={x: xv, y: yv})]
    for name, a, b in zip(["loss"] + names, out["NCHW"], out["NHWC"]):
        np.testing.assert_allclose(b, a, err_msg=name, **GRAD_TOL)


def test_step_flops_count_resnet18_by_hand():
    """``profile_train.graph_flops`` (the MFU's numerator on the card)
    against a count by hand of ResNet-18's convolutions (CIFAR stem, four
    stages, 1x1 projections) and head: 0.5554 G multiply-adds a sample."""
    from hetu_tpu_torch.tools import profile_train as pt
    batch = 4
    want, hw, cin = 32 * 32 * 64 * 3 * 9, 32, 64
    for stage, ch in enumerate((64, 128, 256, 512)):
        for r in range(2):
            stride = 2 if stage > 0 and r == 0 else 1
            hw //= stride
            want += hw * hw * ch * cin * 9 + hw * hw * ch * ch * 9
            if cin != ch or stride > 1:
                want += hw * hw * ch * cin
            cin = ch
    for df in ("NCHW", "NHWC"):
        _, fd, loss = pt.resnet18_step(batch, df, device="cpu")
        macs = pt.graph_flops(loss, {n: np.shape(v) for n, v in fd.items()})
        assert macs == {"conv": batch * want, "linear": batch * 512 * 10,
                        "attention": 0}
    assert round(want / 1e9, 4) == 0.5554


@pytest.mark.parametrize("ops,kernel,family", [
    (["aten::cudnn_convolution", "aten::convolution", "aten::conv2d"],
     "sm90_xmma_fprop_implicit_gemm", "conv forward"),
    (["aten::convolution_backward",
      "autograd::engine::evaluate_function: ConvolutionBackward0"],
     "sm80_xmma_wgrad_implicit_gemm", "conv wgrad"),
    (["aten::convolution_backward",
      "autograd::engine::evaluate_function: ConvolutionBackward0"],
     "void cudnn::detail::dgrad_engine<float>", "conv dgrad"),
    (["aten::convolution_backward",
      "autograd::engine::evaluate_function: ConvolutionBackward0"],
     "sm80_xmma_gemm_cf32cf32_f32f32", "conv backward, other"),
    (["aten::native_batch_norm_backward",
      "autograd::engine::evaluate_function: NativeBatchNormBackward0"],
     "batch_norm_backward_kernel", "batchnorm"),
    (["aten::var_mean"], "reduce_kernel", "batchnorm"),
    (["aten::threshold_backward",
      "autograd::engine::evaluate_function: ReluBackward0"],
     "elementwise", "relu and add"),
    (["aten::add"], "CUDAFunctor_add", "relu and add"),
    (["aten::avg_pool2d"], "avg_pool2d_out_cuda_frame", "pooling"),
    (["aten::mm", "aten::matmul"], "gemm", "head"),
    (["aten::mul", "optimizer"], "elementwise", "momentum update"),
    (["aten::copy_", "aten::_to_copy", "aten::to"], "direct_copy",
     "casts and copies")])
def test_resnet_kernel_families(ops, kernel, family):
    from hetu_tpu_torch.tools import profile_train as pt
    assert pt.resnet_family(ops, kernel) == family
    assert family in pt.RESNET_FAMILIES
