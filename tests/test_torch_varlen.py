"""Padding-masked attention (``sdpa_varlen_op``) in the port against the
JAX package.

1. The ``lengths`` specialization of the flash kernels, alone and with
   every rule the JAX kernels combine it with (causal, a key mask, a full
   mask in each group mode, a dense bias, a key-bias strip, a full mask
   with a bias): the port's ``flash_attention`` on CPU tensors
   (``FlashAttention`` over the plain versions the wrappers take there)
   against the Pallas kernels in interpret mode (``jax.vjp`` of the
   entry, as tests/test_pallas.py runs them), at lengths 0, 1, ragged, a
   whole tile, S_kv and past S_kv, S_q != S_kv; the gradient of every key
   at or past its row's length exactly 0.  Tolerance rtol = atol = 2e-4,
   tests/test_pallas.py's flash-gradient gate; bf16 within one bf16 ulp
   (tests/test_torch_flash_attention.py's ``BF16_TOL``).
2. ``sdpa_varlen_op`` through ``Executor.run``: the twin of
   tests/test_pallas.py::test_sdpa_varlen_op_graph at 2e-5.
3. The padding-masked graph of ``tools/profile_train.py``
   (:func:`varlen_graph`) cut to 2 layers, hidden 32, 2 heads: its ops
   and names line up with the JAX package's twin built below; from the
   JAX package's weights, 5 Adam steps in float32 at
   tests/test_torch_bert.py's gates (step-1 loss atol 1e-5, gradients
   ``allclose(rtol=1e-4, atol=1e-6)``, losses rtol 1e-5) and 3 in bf16
   against the JAX package's bf16 run at tests/test_torch_bf16.py's
   (losses rtol 5e-3, gradients ``allclose(rtol=2e-2, atol=1e-2)``),
   every node's dtype the JAX package's (the int32 ``lens`` feed stays
   int32 under ``compute_dtype="bfloat16"``).

Both packages take the plain attention on the CPU, so the graphs run
``sdpa_reference`` with the built column mask; the CUDA kernels are held
to the plain versions on the card (tests/test_torch_kernels_gpu.py and
chip_smoke.py).  Run::

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_varlen.py -q
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

import hetu_tpu as jht                                      # noqa: E402
from hetu_tpu.graph.node import LowerCtx as JaxLowerCtx     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo      # noqa: E402
from hetu_tpu.ops.attention import sdpa_reference as jax_sdpa_reference  # noqa: E402,E501
from hetu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402,E501
import hetu_tpu_torch as tht                               # noqa: E402
from hetu_tpu_torch import metrics                         # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from hetu_tpu_torch.tools.profile_train import varlen_graph  # noqa: E402

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
B, H, D = 3, 2, 16
SCALE = 0.37

# -- 1. the lengths specialization, alone and combined --------------------

#: (kind, S_q, S_kv, lengths of the 3 batch rows, causal, key mask, mask
#: group, bias shape).  S_kv a multiple of 128 where a length passes it: the
#: JAX entry pads a ragged S_kv with keys that a length past S_kv would see.
CASES = [("alone", 128, 128, (0, 1, 77), False, False, None, None),
         ("alone", 128, 128, (128, 999, 64), False, False, None, None),
         ("alone", 40, 100, (100, 13, 0), False, False, None, None),
         ("causal", 128, 128, (1, 128, 50), True, False, None, None),
         ("causal", 64, 192, (192, 100, 3), True, False, None, None),
         ("key_mask", 128, 128, (100, 128, 30), False, True, None, None),
         ("mask", 128, 128, (90, 0, 128), False, False, "one", None),
         ("mask", 128, 128, (70, 128, 5), True, True, "h", None),
         ("mask", 96, 128, (128, 64, 33), False, False, "b", None),
         ("mask", 128, 128, (1, 100, 999), False, True, "bh", None),
         ("bias", 128, 128, (100, 0, 128), False, False, None,
          (1, H, 128, 128)),
         ("bias", 128, 128, (64, 128, 9), True, True, None, (B, H, 128, 128)),
         ("strip", 128, 128, (128, 50, 0), True, False, None,
          (B, 1, 1, 128)),
         ("mask_bias", 128, 128, (77, 128, 2), False, False, "b",
          (1, H, 128, 128)),
         ("mask_strip", 128, 128, (0, 120, 128), True, True, "h",
          (1, 1, 1, 128))]


def _inputs(s_q, s_kv, lens, key_mask, mgroup, bias_shape, seed):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(B, H, s_q, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, s_kv, D).astype(np.float32) for _ in range(2))
    km = mask = bias = None
    if key_mask:
        km = (rng.rand(B, s_kv) < 0.7).astype(np.int32)
        km[:, 0] = 1
    if mgroup is not None:
        mask = rng.rand(B if mgroup in ("b", "bh") else 1,
                        H if mgroup in ("h", "bh") else 1, s_q, s_kv) < 0.6
        mask[0, 0, 0] = False               # a row that sees no key
    if bias_shape is not None:
        bias = rng.randn(*bias_shape).astype(np.float32)
    return q, k, v, do, np.asarray(lens, np.int32), km, mask, bias


def _both(q, k, v, do, lens, km, mask, bias, causal, dtype=np.float32):
    """out and the gradients (dq, dk, dv[, dbias]) of the port's
    ``flash_attention`` on CPU tensors and of the JAX package's Pallas
    entry in interpret mode, each as float32 numpy."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xs = (q, k, v) + ((bias,) if bias is not None else ())
    jkm = None if km is None else jnp.asarray(km)
    jmask = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v, b=None):
        return jax_flash(q, k, v, causal=causal, scale=SCALE,
                         lengths=jnp.asarray(lens), key_mask=jkm,
                         mask=jmask, bias=b, interpret=True)

    jx = [jnp.asarray(x, jdt if i < 3 else jnp.float32)
          for i, x in enumerate(xs)]
    want, vjp = jax.vjp(fn, *jx)
    wgrads = vjp(jnp.asarray(do, jdt))
    tx = [torch.from_numpy(x).to(tdt if i < 3 else torch.float32)
          .requires_grad_(True) for i, x in enumerate(xs)]
    got = fa.flash_attention(
        *tx[:3], causal=causal, scale=SCALE, lengths=torch.from_numpy(lens),
        key_mask=None if km is None else torch.from_numpy(km),
        mask=None if mask is None else torch.from_numpy(mask),
        bias=tx[3] if bias is not None else None)
    grads = torch.autograd.grad(got, tx, torch.from_numpy(do).to(tdt))
    assert got.dtype == tdt and all(g.dtype == x.dtype
                                    for g, x in zip(grads, tx))
    port = [got.detach().float().numpy()] + [g.float().numpy()
                                              for g in grads]
    return port, [np.asarray(w, np.float32) for w in (want,) + wgrads]


@pytest.mark.parametrize("kind,s_q,s_kv,lens,causal,key_mask,mgroup,bshape",
                         CASES)
def test_lengths_with_every_rule_matches_jax_pallas_interpret(
        kind, s_q, s_kv, lens, causal, key_mask, mgroup, bshape):
    """out, dQ, dK, dV and the group-summed dbias / dkbias of
    ``flash_attention(lengths=...)`` with ``kind``'s other rules against
    the Pallas kernels in interpret mode; dK and dV exactly 0 at every key
    at or past its row's length (tests/test_pallas.py:514), out and dQ 0
    on every row that sees no key."""
    q, k, v, do, lens, km, mask, bias = _inputs(
        s_q, s_kv, lens, key_mask, mgroup, bshape, seed=s_q + 3 * s_kv
        + sum(lens) % 97)
    port, want = _both(q, k, v, do, lens, km, mask, bias, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), port, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
    _, dq, dk, dv = port[:4]
    for b, n in enumerate(lens):
        assert not dk[b, :, n:].any() and not dv[b, :, n:].any()
    valid = fa._valid(B * H, s_q, s_kv, "cpu",
                      lengths=torch.from_numpy(lens),
                      key_mask=None if km is None else torch.from_numpy(km),
                      causal=causal,
                      mask=None if mask is None
                      else fa.broadcast_group(torch.from_numpy(mask), B, H,
                                              s_q, s_kv, "mask")[0],
                      gmode=fa.classify_group(torch.from_numpy(mask), B, H,
                                              s_q, s_kv, "mask")
                      if mask is not None else "bh", heads=H)
    blind = (~valid.expand(B * H, s_q, s_kv).any(-1)).numpy() \
        .reshape(B, H, s_q)
    assert not port[0][blind].any() and not dq[blind].any()


@pytest.mark.parametrize("kind,s,lens,causal,key_mask",
                         [("alone", 128, (0, 128, 50), False, False),
                          ("causal", 128, (128, 77, 1), True, True)])
def test_bf16_lengths_match_jax_pallas_interpret(kind, s, lens, causal,
                                                 key_mask):
    """bf16 q, k, v with ``lengths`` (the mixed-precision path): the bf16
    plain versions against the Pallas kernels' bf16 instantiation, within
    one bf16 ulp; padded keys' dK and dV exactly 0."""
    q, k, v, do, lens, km, _, _ = _inputs(s, s, lens, key_mask, None, None,
                                          seed=s + len(kind))
    port, want = _both(q, k, v, do, lens, km, None, None, causal, "bf16")
    for name, g, w in zip(("out", "dq", "dk", "dv"), port, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BF16_TOL)
    for b, n in enumerate(lens):
        assert not port[2][b, :, n:].any() and not port[3][b, :, n:].any()


def test_walked_tiles_stop_at_the_length():
    """With ``lengths`` the kernels walk the key tiles that start before
    the row's length, and with causal or a mask only those of them that
    hold a visible pair of the float32 forward's map."""
    lens = torch.tensor([0, 1, 64, 65, 200, 999], dtype=torch.int32)
    walk = fa.walked_tiles(12, 2, 130, 300, lengths=lens)
    assert walk.shape == (12, 3, 5)
    starts = torch.arange(5) * fa.TILE
    want = (starts[None, :] < lens.long()[:, None]).repeat_interleave(2, 0)
    assert torch.equal(walk, want[:, None, :].expand(12, 3, 5))
    causal = fa.walked_tiles(12, 2, 130, 300, causal=True, lengths=lens)
    assert torch.equal(causal, walk & fa.walked_tiles(12, 2, 130, 300,
                                                      causal=True))


def test_lengths_and_key_mask_must_agree_on_the_batch():
    q = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError, match="lengths"):
        fa.flash_fwd_masked(q, q, q, torch.ones(2, 8, dtype=torch.int32),
                            1.0, lengths=torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths"):
        fa.flash_fwd_masked(q, q, q, None, 1.0,
                            lengths=torch.ones(2, dtype=torch.int64))


# -- 2. sdpa_varlen_op through Executor.run --------------------------------

def test_sdpa_varlen_op_graph():
    """The twin of tests/test_pallas.py::test_sdpa_varlen_op_graph: the
    port's ``sdpa_varlen_op`` through ``Executor.run`` on the CPU against
    the JAX package's and its ``sdpa_reference`` with the column mask, at
    2e-5; the plain version counted as ``backend:cpu``."""
    b, h, s, d = 2, 2, 32, 16
    rng = np.random.RandomState(12)
    qv = rng.randn(b, h, s, d).astype(np.float32)
    lv = np.asarray([32, 9], np.int32)
    outs = []
    for ht in (jht, tht):
        q = ht.placeholder_op("q", shape=(b, h, s, d))
        lens = ht.placeholder_op("lens", shape=(b,), dtype=np.int32)
        out = ht.sdpa_varlen_op(q, q, q, lens, causal=False)
        kw = {} if ht is jht else {"device": "cpu"}
        metrics.reset_flash_fallbacks()
        ex = ht.Executor({"fwd": [out]}, **kw)
        outs.append(np.asarray(ex.run("fwd", feed_dict={
            q: qv, lens: lv})[0].asnumpy()))
    assert metrics.flash_fallback_counts() == {"backend:cpu": 1}
    cols = np.arange(s)[None, None, None, :]
    ref = jax_sdpa_reference(jnp.asarray(qv), jnp.asarray(qv),
                             jnp.asarray(qv),
                             mask=jnp.asarray(cols < lv[:, None, None, None]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs[1], np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


# -- 3. the padding-masked graph ------------------------------------------

GB, GS, GHIDDEN, GHEADS, GLAYERS = 2, 24, 32, 2, 2
GLENS = np.asarray([24, 9], np.int32)


def _jax_graph(batch, seq, causal, n_layer, hidden, heads):
    """The JAX package's twin of ``tools/profile_train.py::varlen_graph``."""
    ht = jht
    x = ht.placeholder_op("x", shape=(batch * seq, hidden))
    y = ht.placeholder_op("y", shape=(batch * seq, hidden))
    lens = ht.placeholder_op("lens", shape=(batch,), dtype=np.int32)
    dk = hidden // heads

    def split(t):
        t = ht.array_reshape_op(t, output_shape=(batch, seq, heads, dk))
        return ht.transpose_op(t, perm=(0, 2, 1, 3))

    h = x
    for i in range(n_layer):
        a = ht.layers.LayerNorm(hidden, name=f"layer{i}.ln")(h)
        q, k, v = (split(ht.layers.Linear(hidden, hidden,
                                          name=f"layer{i}.{n}")(a))
                   for n in "qkv")
        o = ht.ops.sdpa_varlen_op(q, k, v, lens, causal=causal)
        o = ht.transpose_op(o, perm=(0, 2, 1, 3))
        o = ht.array_reshape_op(o, output_shape=(batch * seq, hidden))
        h = h + ht.layers.Linear(hidden, hidden, name=f"layer{i}.o")(o)
    diff = h - y
    loss = ht.reduce_mean_op(ht.mul_op(diff, diff), [0, 1])
    return {"x": x, "y": y, "lens": lens}, loss


def _graph(jax_side, causal):
    args = (GB, GS, causal)
    kw = dict(n_layer=GLAYERS, hidden=GHIDDEN, heads=GHEADS)
    return _jax_graph(*args, **kw) if jax_side else varlen_graph(*args, **kw)


def _values():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(GB * GS, GHIDDEN).astype(np.float32),
            "y": rng.randn(GB * GS, GHIDDEN).astype(np.float32),
            "lens": GLENS}


def _executor(jax_side, causal, compute_dtype=None):
    ht = jht if jax_side else tht
    topo = jax_topo if jax_side else tht.topo_sort
    feeds, loss = _graph(jax_side, causal)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    fetches = {"train": [loss, ht.optim.AdamOptimizer(1e-3).minimize(loss)]
               + ht.gradients(loss, wrt)}
    kw = {} if jax_side else {"device": "cpu"}
    ex = ht.Executor(fetches, seed=0, compute_dtype=compute_dtype, **kw)
    fd = {feeds[k]: v for k, v in _values().items()}
    return ex, fd, [n.name for n in wrt]


def _train(ex, fd, steps):
    losses, grads = [], None
    for step in range(steps):
        out = ex.run("train", feed_dict=fd)
        losses.append(float(np.asarray(out[0].asnumpy())))
        if step == 0:
            grads = [np.asarray(g.asnumpy()) for g in out[2:]]
    return losses, grads


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_graph_names_match_jax(causal):
    """The port's ``varlen_graph`` and the JAX package's twin line up op
    for op, with the same variable and placeholder names."""
    _, jloss = _graph(True, causal)
    _, tloss = _graph(False, causal)
    jt, tt = jax_topo([jloss]), tht.topo_sort([tloss])
    assert [n.op_type for n in tt] == [n.op_type for n in jt]
    def names(topo):
        return [n.name for n in topo
                if getattr(n, "is_variable", None) is not None]

    assert names(tt) == names(jt)
    assert sum(n.op_type == "ScaledDotProductAttentionVarlen"
               for n in tt) == GLAYERS


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_training_matches_jax(causal):
    """Five Adam steps of the 2-layer graph from the JAX package's
    weights: step-1 loss atol 1e-5, every gradient allclose(rtol=1e-4,
    atol=1e-6), the losses rtol 1e-5; one plain attention a layer and
    step."""
    jex, jfd, jnames = _executor(True, causal)
    tex, tfd, tnames = _executor(False, causal)
    assert tnames == jnames
    assert set(tex.var_names.values()) == set(jex.var_names.values())
    tex.load_dict(jex.return_tensor_values())
    metrics.reset_flash_fallbacks()
    jl, jg = _train(jex, jfd, 5)
    tl, tg = _train(tex, tfd, 5)
    np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=1e-5)
    for name, g, w in zip(tnames, tg, jg):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    assert metrics.flash_fallback_counts() == {"backend:cpu": 5 * GLAYERS}


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_bf16_training_matches_jax(causal):
    """Three Adam steps under ``compute_dtype="bfloat16"`` from the JAX
    package's weights against its bf16 run: losses rtol 5e-3, step-1
    gradients float32 and allclose(rtol=2e-2, atol=1e-2); the masters stay
    float32."""
    jex, jfd, names = _executor(True, causal, "bfloat16")
    tex, tfd, _ = _executor(False, causal, "bfloat16")
    tex.load_dict(jex.return_tensor_values())
    jl, jg = _train(jex, jfd, 3)
    tl, tg = _train(tex, tfd, 3)
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    for name, g, w in zip(names, tg, jg):
        assert g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=1e-2, err_msg=name)
    assert all(v.dtype == torch.float32 for v in tex.var_values.values())


def _lower_all(jax_side, loss, weights):
    """Every node's value of one package's graph, lowered node by node with
    the executor's bf16 casts (float32 variables and feeds to bf16, feeds
    first in their placeholder's dtype)."""
    values = _values()
    if jax_side:
        ctx, topo = JaxLowerCtx(True, jax.random.key(0)), jax_topo

        def place(v):
            v = jnp.asarray(v)
            return v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v
    else:
        ctx, topo = tht.LowerCtx(True, torch.Generator().manual_seed(0)), \
            tht.topo_sort

        def place(v):
            v = torch.from_numpy(v)
            return v.to(torch.bfloat16) if v.dtype == torch.float32 else v
    env = {}
    for n in topo([loss]):
        if getattr(n, "is_variable", None) is None:
            env[n] = n.lower(ctx, *[env[i] for i in n.inputs])
        elif n.is_variable:
            env[n] = place(np.array(weights[n.name], np.float32))
        else:
            env[n] = place(np.asarray(values[n.name])
                           .astype(n.dtype or np.float32))
    return [env[n] for n in topo([loss])], topo([loss])


def test_every_varlen_node_has_the_jax_packages_dtype():
    """The causal graph lowered node by node in both packages at bf16:
    every node's output has the JAX package's dtype; the ``lens`` feed
    is int32 and the attention bf16."""
    _, jloss = _graph(True, True)
    _, tloss = _graph(False, True)
    jex = jht.Executor([jloss], seed=0)
    weights = {jex.var_names[n]: np.asarray(v)
               for n, v in jex.var_values.items()}
    jvals, jnodes = _lower_all(True, jloss, weights)
    tvals, tnodes = _lower_all(False, tloss, weights)
    seen = {}
    for jn, jv, tv in zip(jnodes, jvals, tvals):
        want, got = str(jv.dtype), str(tv.dtype).replace("torch.", "")
        assert got == want, (jn.op_type, jn.name, want, got)
        seen.setdefault(jn.op_type, set()).add(want)
    assert seen["ScaledDotProductAttentionVarlen"] == {"bfloat16"}
    at = [i for i, n in enumerate(tnodes) if n.name == "lens"]
    assert len(at) == 1 and tvals[at[0]].dtype == torch.int32
