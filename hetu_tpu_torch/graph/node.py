"""Graph node (Op) base for the define-then-run frontend — the PyTorch
twin of ``hetu_tpu/graph/node.py``.

Nodes are symbolic: they record the op kind, inputs and attributes.  Each
concrete op provides ``lower(ctx, *tensors) -> tensor``, a plain function
on ``torch.Tensor`` values; :func:`hetu_tpu_torch.graph.executor.lower_forward`
evaluates a fetch subgraph eagerly in topological order (PyTorch runs
eagerly, so there is no jit step).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

# Global monotonically increasing id for deterministic topo-order tie-breaking.
_NODE_COUNTER = 0

#: the package root: frames inside it are the framework's, not the user's
#: graph-building code
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _creation_site(skip=2, max_depth=25):
    """(filename, lineno, function) of the innermost frame outside the
    package: the user line that created a node.  Taken at every
    ``Op.__init__`` so that graph diagnostics (``lint``, the executor's
    ``validate=``) say where a bad node came from; a frame walk, cheap
    enough to run always."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover - shallow stack
        return None
    last = None
    for _ in range(max_depth):
        if f is None:
            break
        fn = f.f_code.co_filename
        last = (fn, f.f_lineno, f.f_code.co_name)
        if not fn.startswith(_PKG_DIR):
            return last
        f = f.f_back
    return last


def format_site(site):
    """A creation site as 'file:line in func'."""
    if not site:
        return "<unknown site>"
    fn, line, func = site
    return f"{fn}:{line} in {func}"


def _next_id() -> int:
    global _NODE_COUNTER
    _NODE_COUNTER += 1
    return _NODE_COUNTER


class LowerCtx:
    """Per-evaluation context threaded through ``Op.lower``.

    - ``training``: whether the training subgraph is being evaluated
      (dropout etc.); serving evaluates with ``training=False``.
    - ``rng()``: the step's ``torch.Generator`` (the executor seeds it
      from its seed and the step), for dropout and other stochastic ops;
      each draw advances it, as each ``c.rng()`` of the JAX package
      folds in a fresh count.
    - ``state_updates``: ``{variable node: new value}`` for non-trainable
      state written during the forward; the executor commits them after
      the step.
    - ``batch_axis``: under data parallelism, the step's
      :class:`~hetu_tpu_torch.parallel.batch_axis.BatchAxis`: which nodes
      hold this rank's rows of the batch, and the rule each op type is
      lowered by on them; None otherwise.
    """

    def __init__(self, training: bool, generator=None, batch_axis=None):
        self.training = training
        self.generator = generator
        self.state_updates = {}
        self.batch_axis = batch_axis

    def rng(self):
        if self.generator is None:
            raise RuntimeError(
                "This subgraph uses randomness (dropout etc.) but the "
                "executor did not thread a generator; pass seed= to "
                "Executor.")
        return self.generator


class Op:
    """Symbolic graph node with the reference's operator overloads."""

    #: subclasses set this; used for naming and debugging
    op_type: str = "Op"

    def __init__(self, inputs, name=None, **attrs):
        self.id = _next_id()
        self.inputs = list(inputs)
        self.attrs = attrs
        self.name = name or f"{self.op_type}_{self.id}"
        # the user line that created this node (diagnostics)
        self.creation_site = _creation_site()

    # -- lowering ---------------------------------------------------------
    def lower(self, ctx: LowerCtx, *vals):
        raise NotImplementedError(f"{self.op_type} has no lowering rule")

    def infer_shape(self, input_shapes):
        """Static output shape from input shapes: ops without a hand rule
        evaluate their own ``lower`` on meta tensors
        (:func:`hetu_tpu_torch.analysis.shapes.abstract_infer_shape`).
        None when the inputs are unknown or the lowering cannot run
        abstractly."""
        from ..analysis.shapes import abstract_infer_shape
        return abstract_infer_shape(self, input_shapes)

    # -- python operator sugar --------------------------------------------
    def __add__(self, other):
        from ..ops.arithmetic import add_op, addbyconst_op
        if isinstance(other, Op):
            return add_op(self, other)
        return addbyconst_op(self, const_attr=other)

    __radd__ = __add__

    def __sub__(self, other):
        from ..ops.arithmetic import minus_op, minusbyconst_op
        if isinstance(other, Op):
            return minus_op(self, other)
        return minusbyconst_op(self, const_attr=other)

    def __rsub__(self, other):
        from ..ops.arithmetic import minusbyconst_op, opposite_op
        return minusbyconst_op(opposite_op(self), const_attr=-other)

    def __neg__(self):
        from ..ops.arithmetic import opposite_op
        return opposite_op(self)

    def __mul__(self, other):
        from ..ops.arithmetic import mul_op, mulbyconst_op
        if isinstance(other, Op):
            return mul_op(self, other)
        return mulbyconst_op(self, const_attr=other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        from ..ops.arithmetic import div_op, div_const_op
        if isinstance(other, Op):
            return div_op(self, other)
        return div_const_op(self, const_attr=1.0 / other)

    def __rtruediv__(self, other):
        from ..ops.arithmetic import const_div_op
        return const_div_op(self, const_attr=other)

    def __pow__(self, p):
        from ..ops.arithmetic import pow_op
        return pow_op(self, p=p)

    def __matmul__(self, other):
        from ..ops.matmul import matmul_op
        return matmul_op(self, other)

    def __repr__(self):
        return f"<{self.op_type} '{self.name}' id={self.id}>"

    __str__ = __repr__


class PlaceholderOp(Op):
    """A graph input: either a fed value (placeholder) or a Variable."""

    op_type = "Placeholder"

    def __init__(self, name, value=None, initializer=None, trainable=False,
                 dtype=None, shape=None, is_embed=False):
        super().__init__([], name=name)
        self.initializer = initializer
        self.trainable = trainable
        self.is_embed = is_embed
        self.dtype = dtype
        self.shape = tuple(shape) if shape is not None else None
        self._value = None
        if value is not None:
            self.set_value(value)

    @property
    def is_variable(self):
        return self.initializer is not None or self._value is not None

    def set_value(self, value):
        value = np.asarray(value)
        self._value = value
        self.shape = value.shape
        if self.dtype is None:
            self.dtype = value.dtype

    def get_init_value(self, generator=None):
        """Materialise the initial value as a CPU tensor; ``generator`` is
        the ``torch.Generator`` the initializer draws from."""
        if self._value is not None:
            return torch.from_numpy(np.array(self._value))
        if self.initializer is not None:
            return self.initializer.materialize(self.shape, generator)
        return None

    def lower(self, ctx, *vals):  # never called: the executor feeds these
        raise RuntimeError("Placeholder values are supplied by the executor")

    def infer_shape(self, input_shapes):
        return self.shape


def Variable(name, value=None, initializer=None, trainable=True, dtype=None,
             shape=None, is_embed=False):
    """Create a trainable (or stateful) graph variable."""
    return PlaceholderOp(name, value=value, initializer=initializer,
                         trainable=trainable, dtype=dtype, shape=shape,
                         is_embed=is_embed)


def placeholder_op(name="placeholder", dtype=np.float32, shape=None):
    return PlaceholderOp(name, dtype=dtype, shape=shape)


def checkpoint_names(variables):
    """``{node: checkpoint name}``, unique even when layers share default
    names: the k-th repeat of a name gets ``~k`` (two
    ``Linear(name='linear')`` → 'linear.weight', 'linear.weight~1')."""
    names, seen = {}, {}
    for node in variables:
        count = seen.get(node.name, 0)
        seen[node.name] = count + 1
        names[node] = node.name if count == 0 else f"{node.name}~{count}"
    return names


def topo_sort(fetches):
    """Deterministic post-order topological sort of the fetch subgraph."""
    visited = set()
    order = []

    def visit(node):
        if node.id in visited:
            return
        visited.add(node.id)
        for inp in node.inputs:
            visit(inp)
        order.append(node)

    for f in fetches:
        visit(f)
    return order
