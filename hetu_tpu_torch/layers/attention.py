"""Multi-head attention layer (twin of ``hetu_tpu/layers/attention.py``).

Dropout placement follows the JAX package's design note: ``dropout``
applies to the attention OUTPUT (after the o-projection), not to the
probabilities, which the flash kernels never materialise; a config's
``attention_probs_dropout_prob`` is that output-dropout rate.

``causal=True`` takes the flash kernels' causal specialization, forward
and backward, alone or with a key-padding mask.  Any other mask shape
takes the full-mask forward, whose backward is not ported (it raises in
training).  An additive ``bias`` (T5's relative position bias) takes the
bias specialization, forward and backward, alone or with ``causal`` or a
key-padding mask (``sdpa_bias_op``, ``sdpa_masked_bias_op``).  Not
ported, refused by name: ``context_parallel`` (ring / Ulysses schedules)
and a bias together with a full mask (raised by the kernel entry).
"""
from __future__ import annotations

from .base import BaseLayer
from .core import Linear, DropOut
from .. import ops


class MultiHeadAttention(BaseLayer):
    def __init__(self, hidden_size, num_heads, dropout=0.0, causal=False,
                 context_parallel=None, name="mha"):
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        if context_parallel is not None:
            raise NotImplementedError(
                "MultiHeadAttention(context_parallel=) is not ported")
        self.h = num_heads
        self.dk = hidden_size // num_heads
        self.hidden = hidden_size
        self.causal = causal
        self.q = Linear(hidden_size, hidden_size, name=name + ".q")
        self.k = Linear(hidden_size, hidden_size, name=name + ".k")
        self.v = Linear(hidden_size, hidden_size, name=name + ".v")
        self.o = Linear(hidden_size, hidden_size, name=name + ".o")
        self.drop = DropOut(dropout) if dropout else None

    def _split(self, x, batch, seq):
        x = ops.array_reshape_op(x, output_shape=(batch, seq, self.h, self.dk))
        return ops.transpose_op(x, perm=(0, 2, 1, 3))

    def __call__(self, x, batch, seq, kv=None, kv_seq=None, mask=None,
                 bias=None, scale=None):
        """x: (batch*seq, hidden); returns the same shape.  ``kv``: an
        optional (batch*kv_seq, hidden) memory for cross-attention;
        ``mask``: an optional validity mask node broadcastable to
        (B, H, S_q, S_k) — a (B, 1, 1, S_k) padding mask rides the flash
        kernels' key-mask path, any other the full-mask forward; ``bias``:
        an optional additive logit bias node broadcastable the same way."""
        kv = x if kv is None else kv
        kv_seq = seq if kv_seq is None else kv_seq
        q = self._split(self.q(x), batch, seq)
        k = self._split(self.k(kv), batch, kv_seq)
        v = self._split(self.v(kv), batch, kv_seq)
        if mask is not None and bias is not None:
            o = ops.sdpa_masked_bias_op(q, k, v, mask, bias,
                                        causal=self.causal, scale=scale)
        elif mask is not None:
            o = ops.sdpa_masked_op(q, k, v, mask, causal=self.causal,
                                   scale=scale)
        elif bias is not None:
            o = ops.sdpa_bias_op(q, k, v, bias, causal=self.causal,
                                 scale=scale)
        else:
            o = ops.sdpa_op(q, k, v, causal=self.causal, scale=scale)
        o = ops.transpose_op(o, perm=(0, 2, 1, 3))
        o = ops.array_reshape_op(o, output_shape=(batch * seq, self.hidden))
        o = self.o(o)
        if self.drop is not None:
            o = self.drop(o)
        return o
