"""The rest of MoE in the port against the JAX package, on the CPU, at
small sizes: the KTop1, SAM, hash and balanced-assignment gates, the
all-to-alls, ``BalancedMoELayer`` and ``tools/train_moe.py``.

* The gate ops on seeded logits (s 64-256, e 4-8, capacities that drop
  tokens): the 0/1 dispatch and every integer map equal, combine, aux and
  align within rtol 1e-6 / atol 1e-7.
* ``_balanced_assignment``: a permutation equal to JAX's, also on scores
  with tied rows, where the bid order decides between equal bids (the
  port's sorts are stable, as ``jnp.argsort`` is).
* ``alltoall_op`` / ``halltoall_op``: the identity, as in the JAX package
  without an ``ep`` mesh.
* ``analysis.infer_graph``: every node's shape and dtype of each
  ``--gate``'s training graph equal to the JAX package's.
* ``train_moe`` at its defaults (d 32, 256 tokens, 4 experts), each
  ``--gate``, 5 Adam steps from the JAX package's weights (its
  ``examples/moe/train_moe.py`` gates): the step-1 loss atol 1e-5, every
  step-1 gradient ``allclose(rtol=1e-4, atol=1e-6)``, the losses rtol
  1e-5.  ``balance_gate.we`` reaches the loss only through an integer
  permutation: its gradient is zero in both packages, and Adam leaves it
  where it was.
"""
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
from hetu_tpu.analysis import infer_graph as jinfer         # noqa: E402
from hetu_tpu.graph.node import topo_sort as jtopo          # noqa: E402
from hetu_tpu.ops import moe as jmoe                        # noqa: E402
import hetu_tpu_torch as tht                                # noqa: E402
from hetu_tpu_torch.analysis import infer_graph as tinfer   # noqa: E402
from hetu_tpu_torch.ops import moe as tmoe                  # noqa: E402
from hetu_tpu_torch.tools import train_moe                  # noqa: E402

GATE_TOL = dict(rtol=1e-6, atol=1e-7)
STEPS = 5
LOSS1_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
D, TOKENS, EXPERTS = 32, 256, 4          # train_moe's defaults


def _logits(s, e, seed):
    return np.random.RandomState(seed).randn(s, e).astype(np.float32)


def _assert_gate(tout, jout, n_maps):
    """The first ``n_maps`` outputs equal, the rest within GATE_TOL."""
    for i, (t, j) in enumerate(zip(tout, jout)):
        t, j = np.asarray(t), np.asarray(j)
        if i < n_maps:
            np.testing.assert_array_equal(t, j, err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(t, j, err_msg=f"output {i}",
                                       **GATE_TOL)


def _dropped(dispatch, routes):
    """Tokens the capacity dropped: fewer than ``routes`` slots."""
    return int(np.sum(np.asarray(dispatch).sum(axis=(1, 2)) < routes))


# ------------------------------------------------------------------ the ops

@pytest.mark.parametrize("s,e,k,cap", [(64, 4, 2, 8), (256, 8, 2, 24),
                                       (128, 8, 4, 10), (256, 8, 2, 200)])
def test_ktop1_gating_matches_jax(s, e, k, cap):
    logits = _logits(s, e, s + e)
    jout = jax.jit(jmoe._ktop1_gating, static_argnums=(1, 2))(
        jnp.asarray(logits), k, cap)
    tout = tmoe._ktop1_gating(torch.from_numpy(logits), k, cap)
    _assert_gate(tout, jout, 1)
    assert (_dropped(jout[0], k) > 0) == (cap < 200)


@pytest.mark.parametrize("s,e,k,cap,group", [
    (64, 4, 1, 6, 2), (256, 8, 2, 20, 4), (128, 8, 3, 16, 4),
    (256, 8, 1, 256, 2)])
def test_sam_gating_matches_jax(s, e, k, cap, group):
    logits = _logits(s, e, 7 * s + e)
    jout = jax.jit(jmoe._sam_gating, static_argnums=(1, 2, 3))(
        jnp.asarray(logits), k, cap, group)
    tout = tmoe._sam_gating(torch.from_numpy(logits), k, cap, group)
    _assert_gate(tout, jout, 1)
    assert (_dropped(jout[0], k) > 0) == (cap < 256)
    assert float(jout[3]) > 0 or k > 1        # the hinge is exercised


@pytest.mark.parametrize("s,e,cap", [(64, 4, 10), (256, 8, 28),
                                     (256, 8, 12)])
def test_hash_dispatch_matches_jax(s, e, cap):
    """Negative ids too: ``%`` is a floor modulo in both."""
    ids = np.random.RandomState(s + cap).randint(-300, 300, size=s) \
        .astype(np.int32)
    want = jmoe._hash_dispatch(None, jnp.asarray(ids), num_experts=e,
                               capacity=cap)
    got = tmoe._hash_dispatch(None, torch.from_numpy(ids), num_experts=e,
                              capacity=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _dropped(want, 1) > 0


@pytest.mark.parametrize("s,e,tied", [(64, 4, False), (256, 8, False),
                                      (128, 8, True), (256, 4, True)])
def test_balanced_assignment_matches_jax(s, e, tied):
    """A permutation equal to JAX's.  Tied: every row one of 8 seeded
    rows, so equal bids meet in a round and the (stable) bid order picks
    the lower token, as ``jnp.argsort`` does."""
    rng = np.random.RandomState(s * e)
    scores = rng.randn(s, e).astype(np.float32)
    if tied:
        scores = scores[:8][rng.randint(0, 8, size=s)]
    want = np.asarray(jax.jit(jmoe._balanced_assignment)(
        jnp.asarray(scores)))
    got = tmoe._balanced_assignment(torch.from_numpy(scores))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.sort(want), np.arange(s))


def test_alltoall_ops_are_the_identity():
    """Their values, and ``infer_graph``'s shapes, the JAX package's."""
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    outs, shapes = [], []
    for ht, infer, kw in ((jht, jinfer, {}), (tht, tinfer, {"device": "cpu"})):
        xn = ht.placeholder_op("x", shape=(16, 4))
        fetches = [ht.alltoall_op(xn), ht.halltoall_op(xn)]
        ex = ht.Executor(fetches, **kw)
        outs.append([np.asarray(v.asnumpy())
                     for v in ex.run(feed_dict={xn: x})])
        gs = infer(fetches)
        shapes.append([gs.shape(f) for f in fetches])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x)
    assert shapes[0] == shapes[1] == [(16, 4), (16, 4)]


# ----------------------------------------------------------- train_moe


def _jax_train_moe():
    """``examples/moe/train_moe.py`` (its gates and adapter)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_moe", os.path.join(ROOT, "examples", "moe",
                                      "train_moe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_graph(gate, experts=EXPERTS, dim=D, tokens=TOKENS):
    """The JAX script's graph as its ``main`` builds it, as a dict like
    ``train_moe.build_graph``'s."""
    from hetu_tpu.layers import Expert, Linear, MoELayer
    from hetu_tpu.layers.moe_layer import BalancedMoELayer
    jtm = _jax_train_moe()
    d, e = dim, experts
    x = jht.placeholder_op("x")
    y = jht.placeholder_op("y")
    ids_node = jht.Variable("token_ids",
                            value=(np.arange(tokens) % 97).astype(np.int32),
                            trainable=False)
    g = jtm.build_gate(gate, d, tokens, e, ids_node=ids_node)
    if gate == "base":
        moe = BalancedMoELayer(g, Expert(e, d, 2 * d), e, tokens, d)
    else:
        moe = MoELayer(g, Expert(e, d, 2 * d))
    h, aux = moe(x)
    logits = Linear(d, 8, name="head")(h)
    loss = jht.reduce_mean_op(
        jht.softmaxcrossentropy_sparse_op(logits, y), [0])
    if aux is not None:
        loss = loss + aux * 0.01
    return {"x": x, "y": y, "loss": loss, "gate": g}


def _trainable(loss, topo):
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def _run(ex, fd, steps):
    losses, grads = [], None
    for step in range(steps):
        out = ex.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        losses.append(float(out[0]))
        if step == 0:
            grads = [np.asarray(g) for g in out[2:]]
    return losses, grads


@pytest.mark.parametrize("gate", train_moe.GATES)
def test_train_moe_matches_jax(gate):
    jg = jax_graph(gate)
    jwrt = _trainable(jg["loss"], jtopo)
    jex = jht.Executor({"train": [jg["loss"], jht.optim.AdamOptimizer(1e-3)
                                  .minimize(jg["loss"])]
                        + jht.gradients(jg["loss"], jwrt)}, seed=0)
    weights = {k: np.asarray(v) for k, v in jex.return_tensor_values().items()}
    tg = train_moe.build_graph(gate)
    tfd = train_moe.feeds(tg, TOKENS, D)
    jfd = {jg["x"]: tfd[tg["x"]], jg["y"]: tfd[tg["y"]]}
    twrt = _trainable(tg["loss"], tht.topo_sort)
    # op for op and name for name the JAX script's graph
    assert [n.op_type for n in tht.topo_sort([tg["loss"]])] == \
        [n.op_type for n in jtopo([jg["loss"]])]
    assert [n.name for n in twrt] == [n.name for n in jwrt]
    assert getattr(tg["gate"], "capacity", None) == \
        getattr(jg["gate"], "capacity", None)
    tex = train_moe.build_executor(tg, device="cpu",
                                   extra=tht.gradients(tg["loss"], twrt))
    assert set(tex.var_names.values()) == set(weights)
    tex.load_dict(weights)
    jl, jgr = _run(jex, jfd, STEPS)
    tl, tgr = _run(tex, tfd, STEPS)
    assert abs(tl[0] - jl[0]) <= LOSS1_ATOL, (tl[0], jl[0])
    for node, got, want in zip(twrt, tgr, jgr):
        np.testing.assert_allclose(got, want, err_msg=node.name, **GRAD_TOL)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    if gate == "base":
        # the permutation carries no gradient: zero in both, and Adam
        # leaves the scores' weight where it was
        i = [n.name for n in twrt].index("balance_gate.we")
        assert not jgr[i].any() and not tgr[i].any()
        after = tex.return_tensor_values()["balance_gate.we"]
        np.testing.assert_array_equal(np.asarray(after),
                                      weights["balance_gate.we"])
        np.testing.assert_array_equal(
            np.asarray(jex.return_tensor_values()["balance_gate.we"]),
            weights["balance_gate.we"])


def _dtype_names(dt):
    """A dtype (or a tuple-valued node's tuple of them) by name, int64
    read as int32 (the JAX package's default integer)."""
    if isinstance(dt, tuple):
        return tuple(_dtype_names(d) for d in dt)
    name = str(dt).replace("torch.", "")
    return "int32" if name == "int64" else str(np.dtype(name))


@pytest.mark.parametrize("gate", train_moe.GATES)
def test_infer_graph_matches_the_jax_package(gate):
    tg, jg = train_moe.build_graph(gate, tokens=64), jax_graph(gate,
                                                               tokens=64)
    fd = train_moe.feeds(tg, 64, D)
    feeds = {"x": fd[tg["x"]], "y": fd[tg["y"]]}
    ts, js = tinfer([tg["loss"]], feeds), jinfer([jg["loss"]], feeds)
    assert ts.complete and js.complete
    assert len(ts.topo) == len(js.topo)
    for t, j in zip(ts.topo, js.topo):
        assert t.op_type == j.op_type
        assert ts.shape(t) == js.shape(j), (t, ts.shape(t), js.shape(j))
        assert _dtype_names(ts.dtype(t)) == _dtype_names(js.dtype(j)), t


def test_train_moe_cli():
    """``--device cpu`` trains; ``--ep 2`` is expert parallel, refused
    naming ``ModelParallel``; ``--dp 2`` outside a launched world
    stops."""
    train_moe.main(["--device", "cpu", "--gate", "ktop1", "--steps", "2",
                    "--tokens", "32", "--dim", "8"])
    with pytest.raises(NotImplementedError, match="ModelParallel"):
        train_moe.main(["--device", "cpu", "--ep", "2"])
    with pytest.raises(SystemExit, match="launched world"):
        train_moe.main(["--device", "cpu", "--dp", "2"])
