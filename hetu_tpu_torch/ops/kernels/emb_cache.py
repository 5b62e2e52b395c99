"""Device-resident HET embedding-cache kernels for the H100.

The cache (``ps/dist_store.py:DistCacheTable(device=True)``) keeps its
slot table, eviction clocks and commit protocol on the host and the row
slab, ``(limit + scratch + 1, width)`` float32, on the card.  Its math:

* :func:`gather_rows` — ``out[i] = slab[slots[i]]``: the hand-written CUDA
  kernel ``csrc/emb_cache.cu`` (``hetu_emb_gather``), which replaces the
  TPU kernel ``hetu_tpu/ops/pallas/emb_cache.py::_gather_kernel``
  (launched by ``gather_rows``).  Plain version: :func:`gather_rows_plain`
  (``index_select``).
* :func:`scatter_add_grads` — the training path's grad reduction: a
  STABLE sort of the batch's unique-inverse map, the row permutation,
  then the sorted segment-sum kernel (``segment_sum.py``).  Row ``j`` of
  the result is the summed grad of the batch's ``j``-th sorted unique key.
  The sort and the permutation stay outside the kernel, as in JAX.
* :func:`fill_rows` — the miss landing ``slab[targets[i]] = rows[i]``, in
  place with ``index_copy_`` (the JAX version donates the slab to a
  jitted scatter on the TPU so it too updates in place).  Eager PyTorch
  needs no padded fill buckets: one fill per miss count is no recompile.

:func:`emb_gather` and :func:`emb_scatter_add` are the dispatchers the
cache calls: on a CUDA tensor they launch the kernels or raise; on a CPU
tensor they take the plain versions and count ``gather:backend:cpu`` /
``scatter_add:backend:cpu`` in the ``emb_fallbacks`` family.  The fill,
the gather and the scatter-add run on PyTorch's current stream, so a
later fill never overtakes an earlier gather.  ``launches`` counts
:func:`gather_rows`'s kernel launches (reset it by assignment).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .segment_sum import sorted_segment_sum

#: kernel launches made in this process by :func:`gather_rows`
launches = 0

_FN = []


def kernel():
    """The bound C entry ``hetu_emb_gather`` (built on first use)."""
    if not _FN:
        fn = _build.load("emb_cache").hetu_emb_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def gather_rows_plain(slab, slots):
    """Plain PyTorch version of the gather: ``index_select``."""
    return slab.index_select(0, slots.long())


def gather_rows(slab, slots):
    """``out[i] = slab[slots[i]]``: slab (R, w) float32, slots (n,) int32,
    every slot a valid slab row (the cache's slot plan guarantees it; the
    kernel does not check)."""
    global launches
    if slab.ndim != 2 or slots.ndim != 1:
        raise ValueError(f"gather_rows: slab (R, w) and slots (n,) "
                         f"expected, got {tuple(slab.shape)} and "
                         f"{tuple(slots.shape)}")
    if slab.dtype != torch.float32 or slots.dtype != torch.int32:
        raise TypeError(f"gather_rows: float32 slab and int32 slots "
                        f"expected, got {slab.dtype}, {slots.dtype}")
    if slots.device != slab.device:
        raise ValueError(f"gather_rows: slots on {slots.device}, slab on "
                         f"{slab.device}")
    if slab.device.type == "cpu":
        return gather_rows_plain(slab, slots)
    if slab.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for device {slab.device}")
    n, w = slots.shape[0], slab.shape[1]
    out = torch.empty((n, w), dtype=torch.float32, device=slab.device)
    if n == 0:
        return out
    if not slab.is_contiguous():
        raise ValueError("gather_rows: slab must be contiguous")
    slots = slots.contiguous()
    with torch.cuda.device(slab.device):
        rc = kernel()(slab.data_ptr(), slots.data_ptr(), out.data_ptr(), n, w,
                      slab.shape[0],
                      torch.cuda.current_stream(slab.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows: kernel launch failed "
                           f"(cudaError {rc})")
    launches += 1
    return out


def scatter_add_grads(grad, inv):
    """Per-unique-key grad sums: ``grad`` (n, w) row gradients, ``inv``
    (n,) the batch's unique-inverse map (values in [0, U)).  Returns
    (n, w): rows [0, U) hold the per-sorted-unique-key sums, the rest are
    zero (U is known on the host only)."""
    n = grad.shape[0]
    if n == 0:
        return torch.zeros_like(grad)
    # stable: each segment keeps its occurrences in batch order, the
    # order the host cache's _segment_sum adds them in
    seg, order = torch.sort(inv.to(torch.int32), stable=True)
    rows = grad.index_select(0, order)
    return sorted_segment_sum(rows, seg, n)


def fill_rows(slab, rows, targets):
    """Land freshly pulled miss rows in their committed slots, IN PLACE:
    ``slab[targets[i]] = rows[i]``.  Returns ``slab``."""
    if rows.shape[0] == 0:
        return slab
    return slab.index_copy_(0, targets.long(), rows.to(slab.dtype))


def emb_gather(slab, slots):
    """The cache's slot-indexed gather: the CUDA kernel on a CUDA slab;
    the plain version, counted, on a CPU one."""
    if slab.device.type == "cpu":
        from ...metrics import record_emb_fallback
        record_emb_fallback("gather:backend:cpu")
    return gather_rows(slab, slots.to(torch.int32))


def emb_scatter_add(grad, inv):
    """The cache's grad scatter-add (:func:`scatter_add_grads`): the CUDA
    kernel on a CUDA tensor; the plain version, counted, on a CPU one."""
    if grad.device.type == "cpu":
        from ...metrics import record_emb_fallback
        record_emb_fallback("scatter_add:backend:cpu")
    return scatter_add_grads(grad, inv)
