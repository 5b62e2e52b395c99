"""Elementwise / scalar ops (the operator overloads of ``Op``; twin of
``hetu_tpu/ops/arithmetic.py``)."""
import torch

from .base import def_op

# binary elementwise
add_op = def_op("AddElewise", lambda c, a, b: a + b)
minus_op = def_op("MinusElewise", lambda c, a, b: a - b)
mul_op = def_op("MultiplyElewise", lambda c, a, b: a * b)
div_op = def_op("Division", lambda c, a, b: a / b)

# const variants
addbyconst_op = def_op("AddConst", lambda c, a, const_attr=0.0: a + const_attr)
minusbyconst_op = def_op("MinusByConst",
                         lambda c, a, const_attr=0.0: a - const_attr)
mulbyconst_op = def_op("MultiplyConst",
                       lambda c, a, const_attr=1.0: a * const_attr)
div_const_op = def_op("DivConst", lambda c, a, const_attr=1.0: a * const_attr)
const_div_op = def_op("ConstDiv", lambda c, a, const_attr=1.0: const_attr / a)

# unary
opposite_op = def_op("Opposite", lambda c, a: -a)
pow_op = def_op("Pow", lambda c, a, p=2.0: torch.pow(a, p))
