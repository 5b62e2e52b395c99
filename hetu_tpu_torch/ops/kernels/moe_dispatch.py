"""Sparse MoE dispatch and combine for the H100: one row-gather kernel.

The sparse GShard path (``layers/moe_layer.py::SparseMoELayer``) routes
tokens through index maps instead of the dense ``(s, e, c)`` one-hot
tensors.  Every direction of both transforms is one primitive::

    row_gather(src, idx)[i] = src[idx[i]]      (a zero row where idx < 0)

* :func:`row_gather` — the hand-written CUDA kernel ``csrc/moe_dispatch.cu``
  (``hetu_row_gather`` for float32, ``hetu_row_gather_bf16`` for
  bfloat16: the output has ``src``'s dtype), which replaces the TPU kernel
  ``hetu_tpu/ops/pallas/moe_dispatch.py::_gather_kernel`` (launched by
  ``row_gather``).  Plain version: :func:`row_gather_plain`
  (``index_select`` over the clamped indices, the ``-1`` rows zeroed, in
  any dtype).
* :class:`SparseDispatch` / :class:`SparseCombine` — the autograd
  functions, with the JAX package's custom VJPs as written
  (``moe_dispatch.py:88-158``), so no direction is a scatter::

      dispatch fwd:  buffers[j]   = tokens[token_of_slot[j]]
      dispatch bwd:  d_tokens[t]  = sum_k g[slot_of_token[t, k]]
      combine  fwd:  out[t]       = 0 + sum_k w[t, k] * buffers[slot_of_token[t, k]]
      combine  bwd:  d_w[t, k]    = <g[t], buffers[slot_of_token[t, k]]>  (re-gathered)
                     d_buffers[j] = w_of_slot[j] * g[token_of_slot[j]]

  Each takes the gather to use (``gather=``, :func:`row_gather` by
  default), so a caller can run the same code with the plain version on
  the card and hold the two to each other bit for bit.

Under ``Executor(compute_dtype="bfloat16")`` the tokens and the expert
buffers are bf16 and the gate weights ``w`` float32, as in the JAX
package, so ``w * buffers[...]`` promotes the combine's output to
float32.  One step then gathers in both dtypes: bf16 in the dispatch
(forward and backward), the combine forward and d_w's re-gathers;
float32 in d_buffers' gather of the combine's (float32) gradient.
Nothing is cast to make the dtypes agree.

On the card the kernel is launched with the plan of :func:`gather_plan`
(shapes, alignment and the SM count alone), which also picks its route:
the MoE path's rows (whole 16-byte units on 16-byte-aligned buffers, a
block of them within one shared-memory stage) by TMA bulk copies through
shared-memory stages, a persistent grid walking blocks of consecutive
output rows; other rows one 16-byte chunk, or one value, a thread.
:func:`gather_runs` lists the blocks as the kernel walks them, so the
CPU tests can hold a plan to cover every row once.

On a CPU tensor :func:`row_gather` takes the plain version; on a CUDA
tensor it launches the kernel or raises.  The kernel runs on PyTorch's
current stream, the stream autograd runs ``backward`` on, so it is
ordered with the plain torch ops around it.  ``launches`` (float32) and
``bf16_launches`` count its launches by dtype (reset them by
assignment).  Index maps are int32, as in JAX; :func:`sparse_dispatch` /
:func:`sparse_combine` convert them once and lay ``slot_of_token`` out
route-major, so each launch gets a contiguous column.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made in this process by :func:`row_gather`, on
#: float32 and on bfloat16 ``src``
launches = 0
bf16_launches = 0

#: src dtype -> (C entry, launch counter)
_ENTRIES = {torch.float32: ("hetu_row_gather", "launches"),
            torch.bfloat16: ("hetu_row_gather_bf16", "bf16_launches")}
_FNS = {}


def kernel(dtype):
    """The bound C entry for ``dtype`` (``hetu_row_gather`` or
    ``hetu_row_gather_bf16``; built on first use)."""
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(_build.load("moe_dispatch"), _ENTRIES[dtype][0])
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


#: the bulk route's blocks: at most BULK_BLOCK_BYTES of rows (one of the
#: kernel's three shared-memory stages) and 32 rows (one lane an index),
#: in BULK_CTAS_PER_SM one-warp CTAs an SM (three 16 KB stages a CTA leave
#: room for four)
BULK_BLOCK_BYTES = 16384
BULK_CTAS_PER_SM = 4


def gather_plan(n, m, elem_bytes, src_ptr, out_ptr, sms,
                block_bytes=BULK_BLOCK_BYTES, ctas_per_sm=BULK_CTAS_PER_SM):
    """The launch plan ``(ctas, rows)`` of the gather of ``n`` rows of
    ``m`` values of ``elem_bytes`` bytes, on a card of ``sms`` SMs: the
    bulk route, a grid of ``ctas`` CTAs walking blocks of ``rows``
    consecutive output rows (block ``b`` by CTA ``b % ctas``), for rows of
    whole 16-byte units on 16-byte-aligned buffers whose block fits
    ``block_bytes``: at most 32 rows and ``block_bytes`` a block, at most
    ``ctas_per_sm`` CTAs an SM, the fewest rounds of such a grid that
    hold the rows, then the blocks that share those rounds evenly.
    ``(0, 0)`` for the chunk-a-thread route (any other rows, or none)."""
    row_bytes = m * elem_bytes
    if (n <= 0 or row_bytes % 16 or src_ptr % 16 or out_ptr % 16
            or row_bytes > block_bytes):
        return 0, 0
    per_max = min(32, block_bytes // row_bytes)
    cap = sms * ctas_per_sm
    rounds = -(-n // (cap * per_max))
    rows = -(-n // (rounds * cap))
    return min(-(-n // rows), cap), rows


def gather_runs(n, plan):
    """The blocks of ``plan`` as the bulk route walks them: for each CTA
    in turn, each of its blocks in its order, ``(cta, start, stop)``."""
    ctas, rows = plan
    blocks = -(-n // rows) if ctas else 0
    return [(c, b * rows, min(n, (b + 1) * rows))
            for c in range(ctas) for b in range(c, blocks, ctas)]


def row_gather_plain(src, idx):
    """Plain PyTorch version of the gather: ``index_select`` over the
    clamped indices, then the rows where ``idx < 0`` set to zero."""
    n, m = idx.shape[0], src.shape[1]
    if src.shape[0] == 0:
        return src.new_zeros((n, m))
    rows = src.index_select(0, idx.clamp_min(0).long())
    return torch.where((idx >= 0)[:, None], rows, src.new_zeros(()))


def _abstract(t):
    """A meta tensor under abstract evaluation (``analysis/shapes.py``):
    the plain version gives the shape, and nothing launches."""
    from ...metrics import counters_suppressed
    return t.device.type == "meta" and counters_suppressed()


def row_gather(src, idx):
    """``out[i] = src[idx[i]]``, zeros where ``idx[i] < 0``: src (R, m)
    float32 or bfloat16 and contiguous, idx (n,) int32 with values in
    [-1, R) (the kernel does not check the upper bound); the output has
    ``src``'s dtype."""
    if src.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"row_gather: src (R, m) and idx (n,) expected, got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if src.dtype not in _ENTRIES or idx.dtype != torch.int32:
        raise TypeError(f"row_gather: float32 or bfloat16 src and int32 idx "
                        f"expected, got {src.dtype}, {idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"row_gather: idx on {idx.device}, src on "
                         f"{src.device}")
    if src.device.type == "cpu" or _abstract(src):
        return row_gather_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"row_gather: no kernel for device {src.device}")
    n, m = idx.shape[0], src.shape[1]
    out = torch.empty((n, m), dtype=src.dtype, device=src.device)
    if n == 0 or m == 0:
        return out
    if not src.is_contiguous():
        raise ValueError("row_gather: src must be contiguous")
    idx = idx.contiguous()
    ctas, rows = gather_plan(n, m, src.element_size(), src.data_ptr(),
                             out.data_ptr(), _build.sm_count(src.device))
    with torch.cuda.device(src.device):
        rc = kernel(src.dtype)(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m,
            src.shape[0], ctas, rows,
            torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_gather: kernel launch failed (cudaError {rc})")
    globals()[_ENTRIES[src.dtype][1]] += 1
    return out


class SparseDispatch(torch.autograd.Function):
    """tokens (s, m) -> expert buffers (n_slots, m); ``sot_t`` is
    ``slot_of_token`` route-major, (k, s) int32."""

    @staticmethod
    def forward(ctx, tokens, token_of_slot, sot_t, gather):
        ctx.gather = gather
        ctx.save_for_backward(sot_t)
        return gather(tokens.contiguous(), token_of_slot)

    @staticmethod
    def backward(ctx, g):
        sot_t, = ctx.saved_tensors
        g = g.contiguous()         # e.g. a reshape's or a mean's view
        d_tokens = ctx.gather(g, sot_t[0])
        for j in range(1, sot_t.shape[0]):
            d_tokens = d_tokens + ctx.gather(g, sot_t[j])
        return d_tokens, None, None, None


class SparseCombine(torch.autograd.Function):
    """buffers (n_slots, m), gate weights w (s, k) -> tokens out (s, m);
    ``sot_t`` route-major (k, s), ``token_of_slot`` and ``k_of_slot``
    (n_slots,), all int32."""

    @staticmethod
    def forward(ctx, buffers, w, sot_t, token_of_slot, k_of_slot, gather):
        buffers = buffers.contiguous()
        ctx.gather = gather
        ctx.save_for_backward(buffers, w, sot_t, token_of_slot, k_of_slot)
        out = 0.0
        for j in range(w.shape[1]):
            out = out + w[:, j:j + 1] * gather(buffers, sot_t[j])
        return out

    @staticmethod
    def backward(ctx, g):
        buffers, w, sot_t, token_of_slot, k_of_slot = ctx.saved_tensors
        gather, k = ctx.gather, w.shape[1]
        g = g.contiguous()
        d_buffers = d_w = None
        if ctx.needs_input_grad[1]:
            # d_w[t, j] = <g[t], buffers[slot_of_token[t, j]]>: re-gathered
            d_w = torch.stack([torch.sum(g * gather(buffers, sot_t[j]), dim=-1)
                               for j in range(k)], dim=1).to(w.dtype)
        if ctx.needs_input_grad[0]:
            valid = token_of_slot >= 0
            t_safe = token_of_slot.clamp_min(0).long()
            w_of_slot = torch.where(
                valid, w[t_safe, k_of_slot.clamp(0, k - 1).long()],
                w.new_zeros(()))
            gm = gather(g, token_of_slot)
            d_buffers = (gm * w_of_slot[:, None]).to(buffers.dtype)
        return d_buffers, d_w, None, None, None, None


def _route_major(slot_of_token):
    return slot_of_token.to(torch.int32).t().contiguous()


def sparse_dispatch(tokens, token_of_slot, slot_of_token, gather=row_gather):
    """tokens (s, m) -> expert buffers (n_slots, m).  ``token_of_slot``
    (n_slots,), -1 for an empty slot; ``slot_of_token`` (s, k), -1 where
    the route was dropped."""
    return SparseDispatch.apply(tokens, token_of_slot.to(torch.int32),
                                _route_major(slot_of_token), gather)


def sparse_combine(buffers, w, slot_of_token, token_of_slot, k_of_slot,
                   gather=row_gather):
    """buffers (n_slots, m), gate weights w (s, k) -> tokens out (s, m).
    ``k_of_slot`` (n_slots,): which of its token's k routes a slot is."""
    return SparseCombine.apply(buffers, w, _route_major(slot_of_token),
                               token_of_slot.to(torch.int32),
                               k_of_slot.to(torch.int32), gather)
