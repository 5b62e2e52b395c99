"""GShard top-2 MoE training in the port against the JAX package, on the
CPU, at a tiny size.

* The row gather: ``row_gather_plain`` equals the Pallas ``row_gather``
  (interpret mode) exactly, -1 rows zero.
* The gating: the port's ``_top1_gating`` / ``_top2_gating`` /
  ``_topk_sparse_indices`` against the JAX package's on the same logits,
  with and without capacity drops; the index maps and the dispatch
  tensor exactly, ``gate_w`` / combine / aux within rtol 1e-6.
* The VJPs: ``SparseDispatch`` / ``SparseCombine`` (plain gather, as on
  every CPU tensor) against ``jax.value_and_grad`` of the dense einsum
  formulation, rtol 1e-4 / atol 1e-4 (the JAX package's own tolerance,
  ``tests/test_pallas.py``); ``torch.autograd.gradcheck`` in float64 on
  the hand-written backward passes.
* The slice: tokens 64, d 16, 4 experts, hidden 32, top-2, capacity
  factor 1.25, ``AdamOptimizer(1e-3)``.  ``hetu_tpu``'s dense
  ``MoELayer`` graph is the reference; its weights go through
  ``return_tensor_values()`` into the port's dense and sparse graphs
  (every variable name found).  Step-1 loss within rtol 1e-5, every
  step-1 gradient within ``allclose(rtol=1e-4, atol=1e-6)``, 5 Adam
  losses within rtol 1e-5.

The JAX package reaches its Pallas kernel (interpret mode, seconds a call
site here) in the gather test only; elsewhere it runs its dense
formulation, as its own lean tests do.
"""
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
from hetu_tpu.graph.node import topo_sort as jax_topo       # noqa: E402
from hetu_tpu.ops import moe as jmoe                        # noqa: E402
from hetu_tpu.ops.pallas.moe_dispatch import row_gather as jrow_gather  # noqa: E402,E501
import hetu_tpu_torch as tht                                # noqa: E402
from hetu_tpu_torch import metrics                          # noqa: E402
from hetu_tpu_torch.ops import moe as tmoe                  # noqa: E402
from hetu_tpu_torch.ops.kernels import moe_dispatch as tmd  # noqa: E402

TOKENS, D, E, HIDDEN, K, CF = 64, 16, 4, 32, 2, 1.25


# ----------------------------------------------------------- row gather

@pytest.mark.parametrize("width,dtype", [
    pytest.param(16, "float32", id="16"), pytest.param(13, "float32", id="13"),
    pytest.param(16, "bfloat16", id="bf16-16"),
    pytest.param(13, "bfloat16", id="bf16-13")])
def test_row_gather_plain_matches_pallas_kernel(width, dtype):
    """Bit-equal to the Pallas kernel in interpret mode in either dtype
    (bf16: the rows compared as their 16-bit patterns)."""
    rng = np.random.RandomState(width)
    src = rng.randn(20, width).astype(np.float32)
    idx = rng.randint(-1, 20, size=37).astype(np.int32)   # n off 32
    idx[:4] = [-1, 3, 3, -1]                               # -1s, repeats
    jsrc = jnp.asarray(src, dtype)
    want = np.asarray(jrow_gather(jsrc, jnp.asarray(idx), interpret=True))
    assert str(want.dtype) == dtype
    tsrc = torch.from_numpy(np.array(jsrc.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = (tmd.launches, tmd.bf16_launches)
    got = tmd.row_gather(tsrc, torch.from_numpy(idx))
    plain = tmd.row_gather_plain(tsrc, torch.from_numpy(idx))
    # a CPU tensor never launches
    assert (tmd.launches, tmd.bf16_launches) == before
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    for out in (got, plain):
        assert out.dtype == tsrc.dtype
        np.testing.assert_array_equal(
            out.view(torch.int16 if bits is np.uint16 else torch.int32)
            .numpy().view(bits), want.view(bits))
    assert not want[idx < 0].astype(np.float32).any()


def test_row_gather_edges_and_refusals():
    src = torch.randn(5, 4)
    assert tmd.row_gather(src, torch.zeros(0, dtype=torch.int32)).shape \
        == (0, 4)
    empty = torch.zeros(0, 4)
    out = tmd.row_gather(empty, torch.full((3,), -1, dtype=torch.int32))
    assert out.shape == (3, 4) and not out.any()
    with pytest.raises(TypeError, match="int32"):
        tmd.row_gather(src, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32"):
        tmd.row_gather(src.double(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="torch.float16"):
        tmd.row_gather(src.half(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        tmd.row_gather(src.to("meta"),
                       torch.zeros(2, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------- gating

def _logits(s=64, e=8, seed=0):
    return np.random.RandomState(seed).randn(s, e).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cap", [6, 16])
def test_gating_matches_jax(k, cap):
    logits = _logits()
    jfn, tfn = ((jmoe._top1_gating, tmoe._top1_gating) if k == 1
                else (jmoe._top2_gating, tmoe._top2_gating))
    jd, jc, ja = (np.asarray(v) for v in jfn(jnp.asarray(logits), cap))
    td, tc, ta = (v.numpy() for v in tfn(torch.from_numpy(logits), cap))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)

    jmaps = [np.asarray(v) for v in jmoe._topk_sparse_indices(
        jnp.asarray(logits), k, cap)]
    tmaps = [v.numpy() for v in tmoe._topk_sparse_indices(
        torch.from_numpy(logits), k, cap)]
    for name, t, j in zip(("token_of_slot", "slot_of_token", "k_of_slot"),
                          tmaps[:3], jmaps[:3]):
        assert t.dtype == np.int32, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    np.testing.assert_allclose(tmaps[3], jmaps[3], rtol=1e-6, atol=0)
    np.testing.assert_allclose(tmaps[4], jmaps[4], rtol=1e-6)
    # the maps are the dense dispatch's routing: token_of_slot from it
    flat = jd.reshape(jd.shape[0], -1)
    dense_tos = np.where(flat.max(0) > 0, flat.argmax(0), -1)
    np.testing.assert_array_equal(tmaps[0], dense_tos)
    if cap == 6:
        assert (tmaps[1] < 0).any()          # capacity dropped routes


# ------------------------------------------------------------------ VJPs

def _vjp_inputs(k):
    rng = np.random.RandomState(10 + k)
    s, d, e = 16, 8, 4
    cap = 3 * k                              # drops routes at both k
    return (s, d, e, cap, rng.randn(s, d).astype(np.float32),
            (rng.randn(d, d) * 0.3).astype(np.float32),
            rng.randn(d, e).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2])
def test_sparse_dispatch_and_combine_grads_match_dense_jax(k):
    """loss(tokens, w, wg) = sum(combine(tanh(dispatch(tokens) @ w))^2)
    with logits = tokens @ wg: the gradient reaches tokens through both
    transforms (SparseDispatch backward, SparseCombine d_buffers), w
    through the experts and wg through the gate weights (d_w)."""
    s, d, e, cap, tokens, w, wg = _vjp_inputs(k)
    gating = jmoe._top1_gating if k == 1 else jmoe._top2_gating

    def dense_loss(tok, w_, wg_):
        dispatch, combine, _ = gating(tok @ wg_, cap)
        buf = jnp.einsum("sec,sm->ecm", dispatch, tok)
        eo = jnp.tanh(buf @ w_)
        return jnp.sum(jnp.einsum("sec,ecm->sm", combine, eo) ** 2)

    jl, jg = jax.value_and_grad(dense_loss, argnums=(0, 1, 2))(
        jnp.asarray(tokens), jnp.asarray(w), jnp.asarray(wg))
    tt, tw, twg = (torch.from_numpy(a).requires_grad_(True)
                   for a in (tokens, w, wg))
    tos, sot, kos, gate_w, _ = tmoe._topk_sparse_indices(tt @ twg, k, cap)
    assert (sot < 0).any()
    buf = tmd.sparse_dispatch(tt, tos, sot)
    eo = torch.tanh(buf @ tw)
    loss = torch.sum(tmd.sparse_combine(eo, gate_w, sot, tos, kos) ** 2)
    tg = torch.autograd.grad(loss, (tt, tw, twg))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for got, want, name in zip(tg, jg, ("tokens", "w", "wg")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_hand_written_backward_passes_pass_gradcheck():
    """float64, plain gather: SparseDispatch w.r.t. tokens and
    SparseCombine w.r.t. buffers and gate weights against finite
    differences (top-2 maps with drops and empty slots)."""
    s, d, e, cap, tokens, _, _ = _vjp_inputs(2)
    rng = np.random.RandomState(3)
    # skewed toward expert 0 and away from expert 3: both kinds of -1
    logits = rng.randn(s, e) + np.array([2.0, 0.0, 0.0, -2.0])
    tos, sot, kos, _, _ = tmoe._topk_sparse_indices(
        torch.from_numpy(logits.astype(np.float32)), 2, cap)
    assert (tos < 0).any() and (sot < 0).any()
    tok = torch.from_numpy(tokens.astype(np.float64)).requires_grad_(True)
    buffers = torch.from_numpy(rng.randn(e * cap, d)).requires_grad_(True)
    w = torch.from_numpy(rng.rand(s, 2)).requires_grad_(True)
    plain = tmd.row_gather_plain
    sot_t = sot.t().contiguous()
    assert torch.autograd.gradcheck(
        lambda t: tmd.SparseDispatch.apply(t, tos, sot_t, plain), (tok,))
    assert torch.autograd.gradcheck(
        lambda b, ww: tmd.SparseCombine.apply(b, ww, sot_t, tos, kos, plain),
        (buffers, w))


# ----------------------------------------------------------------- slice

def _graph(ht, layers, sparse):
    x = ht.placeholder_op("x", shape=(TOKENS, D))
    y_ = ht.placeholder_op("y", shape=(TOKENS, D))
    gate = (layers.TopKGateSparse if sparse else layers.TopKGate)(
        D, TOKENS, E, k=K, capacity_factor=CF)
    experts = layers.Expert(E, D, HIDDEN)
    moe = layers.SparseMoELayer(gate, experts, D) if sparse \
        else layers.MoELayer(gate, experts)
    h, aux = moe(x)
    loss = ht.reduce_mean_op(ht.ops.mul_op(h - y_, h - y_), [0, 1]) \
        + aux * 0.01
    return x, y_, loss, gate


def _executor(ht, layers, topo, sparse, **kw):
    x, y_, loss, gate = _graph(ht, layers, sparse)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    train = ht.optim.AdamOptimizer(1e-3).minimize(loss)
    ex = ht.Executor({"train": [loss, train] + ht.gradients(loss, wrt)},
                     seed=0, **kw)
    rng = np.random.RandomState(0)
    fd = {x: rng.randn(TOKENS, D).astype(np.float32),
          y_: rng.randn(TOKENS, D).astype(np.float32)}
    return ex, fd, [n.name for n in wrt], gate


def _run(ex, fd, steps):
    losses, grads = [], None
    for step in range(steps):
        out = ex.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        losses.append(float(out[0]))
        if step == 0:
            grads = out[2:]
    return losses, grads


def test_moe_training_matches_jax():
    jex, jfd, jnames, jgate = _executor(jht, jht.layers, jax_topo, False)
    weights = jex.return_tensor_values()
    jl, jg = _run(jex, jfd, 5)
    metrics.reset_moe_fallbacks()
    for sparse in (False, True):
        tex, tfd, tnames, tgate = _executor(tht, tht.layers, tht.topo_sort,
                                            sparse, device="cpu")
        assert tnames == jnames
        assert tgate.capacity == jgate.capacity == 40
        # every variable of the port's graph is in the dict it loads
        assert set(tex.var_names.values()) == set(weights), \
            set(tex.var_names.values()) ^ set(weights)
        tex.load_dict(weights)
        tl, tg = _run(tex, tfd, 5)
        np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
        for name, got, want in zip(tnames, tg, jg):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"sparse={sparse} {name}")
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert tl[-1] < tl[0]
    # the sparse graph's gathers took the plain version only because the
    # tensors are on the CPU: one counted dispatch and combine a step
    assert metrics.moe_fallback_counts() == {"dispatch:backend:cpu": 5,
                                             "combine:backend:cpu": 5}


@pytest.mark.parametrize("sparse", [False, True])
def test_moe_graph_names_match_jax(sparse):
    """Node op types and variable names line up one for one, so one JAX
    checkpoint drives both port graphs."""
    jloss, tloss = _graph(jht, jht.layers, sparse)[2], \
        _graph(tht, tht.layers, sparse)[2]
    jt, tt = jax_topo([jloss]), tht.topo_sort([tloss])
    assert [n.op_type for n in tt] == [n.op_type for n in jt]
    assert [n.name for n in tt if isinstance(n, tht.PlaceholderOp)] == \
        [n.name for n in jt if isinstance(n, jht.PlaceholderOp)]


def test_bench_configuration_shapes_and_init():
    """The MoE configuration (bench.py's build_moe_graph): capacity 1,280
    and 20,480 expert slots, as in the JAX package; the stacked expert
    weights draw He-uniform with fan_in = d x h (the conv rule of
    ``_fans`` for 3-D shapes, kept as the reference has it)."""
    from hetu_tpu_torch.tools.profile_moe import moe_graph, moe_step_flops
    jgate = jht.layers.TopKGate(512, 8192, 16, k=2, capacity_factor=1.25)
    g = moe_graph(sparse=True)
    assert g["gate"].capacity == jgate.capacity == 1280
    assert [n.op_type for n in g["route"]] == ["Item"] * 5
    assert abs(moe_step_flops() - 258.1e9) < 0.1e9
    init = tht.initializers.HeUniformInit()
    v = init.materialize((4, 16, 32), torch.Generator().manual_seed(0))
    limit = np.sqrt(3.0 * 2.0 / (16 * 32))
    assert float(v.abs().max()) <= limit
    assert float(v.abs().max()) > 0.9 * limit
