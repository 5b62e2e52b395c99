"""Symbolic ops of the port (the decode slice of ``hetu_tpu.ops``)."""
from .base import OP_REGISTRY, SimpleOp, def_op
from .arithmetic import (add_op, minus_op, mul_op, div_op, addbyconst_op,
                         minusbyconst_op, mulbyconst_op, div_const_op,
                         const_div_op, opposite_op, pow_op)
from .matmul import matmul_op, linear_op
from .nn import gelu_op, dropout_op, layer_normalization_op
from .transform import array_reshape_op, transpose_op
from .embedding import embedding_lookup_op
from .attention import (sdpa_reference, dispatch_sdpa_decode, sdpa_decode_op,
                        kv_cache_append_op)
