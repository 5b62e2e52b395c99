"""Op factory: symbolic ops with PyTorch lowering rules (twin of
``hetu_tpu/ops/base.py``, with the same ``op_type`` strings so the two
graphs line up op for op)."""
from __future__ import annotations

import inspect

from ..graph.node import Op

OP_REGISTRY = {}


class SimpleOp(Op):
    """A node whose semantics are fully captured by a pure lowering function."""

    def __init__(self, op_type, inputs, lower_fn, shape_fn=None, name=None,
                 **attrs):
        self.op_type = op_type
        self._lower_fn = lower_fn
        self._shape_fn = shape_fn
        super().__init__(inputs, name=name, **attrs)

    def lower(self, ctx, *vals):
        return self._lower_fn(ctx, *vals, **self.attrs)

    def infer_shape(self, input_shapes):
        if input_shapes and any(s is None for s in input_shapes):
            return None   # unknown inputs stay unknown
        if self._shape_fn is None:
            # no hand rule: the lowering itself, evaluated on meta tensors
            return super().infer_shape(input_shapes)
        return self._shape_fn(*input_shapes, **self.attrs)

    @property
    def has_shape_rule(self):
        """True iff a hand-written shape rule exists: the
        ``shape-rule-mismatch`` lint cross-checks only hand rules."""
        return self._shape_fn is not None


def def_op(op_type, lower_fn, shape_fn=None):
    """Register an op kind; returns its constructor.

    The constructor accepts the graph-node inputs positionally and
    attributes as keywords; positional values after the leading ``Op``
    inputs are matched to the lowering function's parameter names in
    order.  A trailing ``ctx=`` kwarg is accepted for reference-API
    compatibility and ignored.  ``shape_fn(*input_shapes, **attrs)``: an
    optional hand shape rule.
    """
    lower_params = [p for p in inspect.signature(lower_fn).parameters
                    if p != "c" and not p.startswith("*")]

    def ctor(*args, ctx=None, name=None, **attrs):
        del ctx
        inputs = []
        i = 0
        while i < len(args) and isinstance(args[i], Op):
            inputs.append(args[i])
            i += 1
        extra = args[i:]
        if extra:
            attr_names = lower_params[len(inputs):]
            if len(extra) > len(attr_names):
                raise TypeError(
                    f"{op_type}: too many positional args {extra}")
            for pname, val in zip(attr_names, extra):
                attrs[pname] = val
        return SimpleOp(op_type, inputs, lower_fn, shape_fn, name=name,
                        **attrs)

    ctor.__name__ = op_type
    OP_REGISTRY[op_type] = ctor
    return ctor


class ItemOp(Op):
    """Extract one output of a multi-output op (tuple-valued lowering)."""

    op_type = "Item"

    def __init__(self, src, index, name=None):
        super().__init__([src], name=name)
        self.index = index

    def lower(self, ctx, val):
        return val[self.index]


def tuple_outputs(node, n):
    """Split a tuple-valued node into n single-output nodes."""
    return tuple(ItemOp(node, i, name=f"{node.name}.{i}") for i in range(n))
