"""Matmul pricing, copied from ``hetu_tpu/autoparallel/cost_model.py``:
the selective-remat planner (``parallel/remat.py``) prices a segment's
recompute FLOPs with exactly this table and :func:`matmul_flops`, as the
JAX package's planner does."""
from __future__ import annotations

import numpy as np

#: matmul-family op -> index of the LEFT matrix operand (Addmm / Baddbmm
#: carry the additive input first)
MATMUL_OPS = {"MatrixMult": 0, "Linear": 0, "BatchMatrixMult": 0,
              "Addmm": 1, "Baddbmm": 1}


def matmul_flops(node, gs, out_shape):
    """2·(output elements)·(contracted size) of one matmul-family node
    (or ``Einsum``) over the shapes of ``gs``, or None when a shape is
    unknown."""
    t = node.op_type
    if t == "Einsum":
        eq = node.attrs.get("subscripts", "")
        if "->" not in eq:
            return None
        lhs, out = eq.split("->")
        terms = lhs.split(",")
        shapes = [gs.shape(i) for i in node.inputs]
        sizes = {}
        for term, shp in zip(terms, shapes):
            if shp is None or len(term) != len(shp):
                return None
            sizes.update(zip(term, shp))
        contracted = [sizes[lab] for lab in set("".join(terms)) - set(out)]
        if not contracted:
            return None
        return 2.0 * float(np.prod(out_shape)) * float(np.prod(contracted))
    a_idx = MATMUL_OPS[t]
    if a_idx >= len(node.inputs):
        return None
    a = gs.shape(node.inputs[a_idx])
    if not a:
        return None
    k = a[-2] if node.attrs.get("trans_A", False) else a[-1]
    return 2.0 * float(np.prod(out_shape)) * float(k)
