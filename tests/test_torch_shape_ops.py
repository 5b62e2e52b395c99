"""The ops this slice adds to the port against the JAX package's, on the
CPU: ``exp_op`` and ``sqrt_op`` (``ops/arithmetic.py``) and
``concatenate_op``, ``broadcast_shape_op``, ``repeat_op`` (``jnp.tile``,
not ``repeat_interleave``), ``roll_op``, ``scatter1d_grad_op`` and
``indexing_op`` (``ops/transform.py``).  Each op is built in both
packages on the same seeded inputs and lowered directly: the forward
equal (``exp`` and ``sqrt`` within one float32 ulp, ``rtol=1e-6``: XLA's
and torch's elementwise functions round apart), every float input's
gradient under one seeded cotangent equal to
``jax.vjp``'s (float32, ``allclose(rtol=1e-6, atol=1e-6)``; the gathers,
scatters, copies and rolls are exact), and the port's lowering on meta
tensors (``analysis.infer_graph`` runs it) gives the JAX output's shape
and dtype."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax                                                 # noqa: E402
import jax.numpy as jnp                                    # noqa: E402
import hetu_tpu as jht                                     # noqa: E402
import hetu_tpu_torch as tht                               # noqa: E402

RNG = np.random.RandomState(0)
F = RNG.randn(3, 4, 5).astype(np.float32)
POS = (RNG.rand(6, 4) + 0.5).astype(np.float32)
# indices as the models feed them: float32 (MAE adds a float row base to
# its int32 shuffle) with repeats (the gather's gradient must add)
IDX = np.asarray([4, 0, 2, 2, 5, 1, 4], np.float32)
PERM = np.asarray([3, 0, 5, 1, 4, 2], np.float32)

#: case -> (op name, [(array, differentiable)], keyword attributes)
CASES = {
    "exp": ("exp_op", [(F, True)], {}),
    "sqrt": ("sqrt_op", [(POS, True)], {}),
    "concatenate_axis0": ("concatenate_op",
                          [(F, True), (F[:2] * 2, True), (F[:1], True)],
                          {"axis": 0}),
    "concatenate_axis1_int_float": (
        "concatenate_op", [(IDX.reshape(7, 1), False),
                           (np.arange(7, dtype=np.int32).reshape(7, 1),
                            False)], {"axis": 1}),
    "broadcast_shape": ("broadcast_shape_op", [(F[:1, :, :1], True)],
                        {"shape": (3, 4, 6)}),
    "broadcast_shape_add_axes": ("broadcast_shape_op", [(F[0], True)],
                                 {"shape": (2, 4, 3, 5), "add_axes": (0, 2)}),
    "repeat_tile": ("repeat_op", [(F[:, None], True)],
                    {"reps": (2, 1, 1, 1)}),
    "repeat_more_reps": ("repeat_op", [(F[0], True)], {"reps": (2, 3, 2)}),
    "roll_two_axes": ("roll_op", [(F, True)],
                      {"shift": (-2, 3), "axis": (1, 2)}),
    "roll_one_axis": ("roll_op", [(F, True)], {"shift": 1, "axis": 0}),
    "roll_flat": ("roll_op", [(F, True)], {"shift": 7}),
    "scatter1d_grad": ("scatter1d_grad_op", [(POS, True), (PERM, False)],
                       {"size": 6}),
    "scatter1d_grad_into_more_rows": ("scatter1d_grad_op",
                                      [(POS[:4], True), (PERM[:4], False)],
                                      {"size": 9}),
    "indexing_repeats": ("indexing_op", [(POS, True), (IDX, False)], {}),
    "indexing_int_ids": ("indexing_op",
                         [(F, True), (IDX.astype(np.int32)[:3] % 3, False)],
                         {}),
}


def _build(ht, op, arrays, kw):
    nodes = [ht.placeholder_op(f"x{i}", shape=a.shape)
             for i, (a, _) in enumerate(arrays)]
    fn = getattr(ht, op) if hasattr(ht, op) else getattr(ht.ops, op)
    return fn(nodes, **kw) if op == "concatenate_op" else fn(*nodes, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_new_op_matches_the_jax_op(case):
    op, arrays, kw = CASES[case]
    jnode = _build(jht, op, arrays, kw)
    tnode = _build(tht, op, arrays, kw)
    assert tnode.op_type == jnode.op_type
    diff = [i for i, (_, d) in enumerate(arrays) if d]

    def jfn(*xs):
        vals = [jnp.asarray(a) for a, _ in arrays]
        for i, x in zip(diff, xs):
            vals[i] = x
        return jnode.lower(None, *vals)

    jout, vjp = jax.vjp(jfn, *[jnp.asarray(arrays[i][0]) for i in diff])
    jout = np.asarray(jout)
    tvals = [torch.from_numpy(a.copy()).requires_grad_(d)
             for a, d in arrays]
    tout = tnode.lower(None, *tvals)
    assert tuple(tout.shape) == jout.shape
    assert str(tout.dtype).replace("torch.", "") == str(jout.dtype)
    if op in ("exp_op", "sqrt_op"):    # XLA's and torch's libm: an ulp
        np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_array_equal(tout.detach().numpy(), jout)
    if diff:
        cot = np.random.RandomState(1).randn(*jout.shape).astype(jout.dtype)
        jgrads = vjp(jnp.asarray(cot))
        tgrads = torch.autograd.grad(tout, [tvals[i] for i in diff],
                                     torch.from_numpy(cot))
        for g, w in zip(tgrads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    meta = tnode.lower(None, *[torch.empty(a.shape, device="meta",
                                           dtype=torch.from_numpy(a).dtype)
                               for a, _ in arrays])
    assert meta.device.type == "meta"
    assert tuple(meta.shape) == jout.shape and meta.dtype == tout.dtype
