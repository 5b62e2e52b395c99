"""Elementwise / scalar ops (the operator overloads of ``Op``; twin of
``hetu_tpu/ops/arithmetic.py``).

Dtypes follow ``jnp``'s promotion, which differs from torch's in one
place these graphs reach: an integer tensor combined with a Python float
constant is a *weakly typed* float32 in ``jnp``, and a weak float takes
the dtype of the strong float it meets (``bf16 / (int32 count + 1e-6)``
is bfloat16 in ``jnp``, float32 in torch).  The port marks such a value
(:func:`weak_float`) and the binary ops cast it to the other operand's
float dtype first, so every node keeps the JAX graph's dtype under
``compute_dtype="bfloat16"``."""
import torch

from .base import def_op

_WEAK = "_hetu_weak_float"


def weak_float(t):
    """Mark ``t`` as ``jnp``'s weakly typed float32; returns ``t``."""
    setattr(t, _WEAK, True)
    return t


def is_weak(t):
    return getattr(t, _WEAK, False)


def _binary(fn):
    """``fn(a, b)`` with ``jnp``'s weak-float rule: a weak operand takes
    the other's float dtype; the result is weak if both are, or if one is
    and the other is an integer."""
    def lower(c, a, b):
        wa, wb = is_weak(a), is_weak(b)
        if wa and not wb and b.is_floating_point():
            a, wa = a.to(b.dtype), False
        elif wb and not wa and a.is_floating_point():
            b, wb = b.to(a.dtype), False
        out = fn(a, b)
        return weak_float(out) if wa or wb else out
    return lower


def _const(fn, default):
    """``fn(a, const)``: an integer ``a`` with a float constant, or a weak
    ``a``, gives a weak float, as in ``jnp``."""
    def lower(c, a, const_attr=default):
        out = fn(a, const_attr)
        if is_weak(a) or (not a.is_floating_point()
                          and isinstance(const_attr, float)):
            weak_float(out)
        return out
    return lower


# binary elementwise
add_op = def_op("AddElewise", _binary(lambda a, b: a + b))
minus_op = def_op("MinusElewise", _binary(lambda a, b: a - b))
mul_op = def_op("MultiplyElewise", _binary(lambda a, b: a * b))
div_op = def_op("Division", _binary(lambda a, b: a / b))
# the result takes the FIRST input's dtype, as the JAX op's astype(a.dtype)
ne_op = def_op("Ne", lambda c, a, b: (a != b).to(a.dtype))

# const variants
addbyconst_op = def_op("AddConst", _const(lambda a, x: a + x, 0.0))
minusbyconst_op = def_op("MinusByConst", _const(lambda a, x: a - x, 0.0))
mulbyconst_op = def_op("MultiplyConst", _const(lambda a, x: a * x, 1.0))
div_const_op = def_op("DivConst", _const(lambda a, x: a * x, 1.0))
const_div_op = def_op("ConstDiv", _const(lambda a, x: x / a, 1.0))

# unary
opposite_op = def_op("Opposite", lambda c, a: -a)
pow_op = def_op("Pow", lambda c, a, p=2.0: torch.pow(a, p))
tanh_op = def_op("Tanh", lambda c, a: torch.tanh(a))
rsqrt_op = def_op("ReciprocalSqrt", lambda c, a: torch.rsqrt(a))
exp_op = def_op("Exp", lambda c, a: torch.exp(a))
sqrt_op = def_op("Sqrt", lambda c, a: torch.sqrt(a))
sigmoid_op = def_op("Sigmoid", lambda c, a: torch.sigmoid(a))
