"""Sorted segment row-sum (the embedding grad scatter-add) for the H100.

Replaces the TPU kernel ``hetu_tpu/ops/pallas/segment_sum.py::_seg_kernel``
(launched by ``sorted_segment_sum``) with the hand-written CUDA kernel
``csrc/segment_sum.cu`` (``hetu_segment_sum``), built for ``sm_90a`` and
bound through ``ctypes``: the thread of each (segment, column) sums its
run in sorted order from the run's first row, with no atomics, so the
result is the same from run to run and equal bit for bit to the host
cache's ``_segment_sum``.  Short runs are summed four columns a thread
with their loads in flight; each run of 16 rows or more is staged through
shared memory by a whole CTA.

:func:`sorted_segment_sum_plain` is the plain PyTorch version
(``index_add_``).  :func:`sorted_segment_sum` takes it only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.  ``launches``
counts the kernel's launches (reset it by assignment).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches made in this process by :func:`sorted_segment_sum`
launches = 0

_FN = []


def kernel():
    """The bound C entry ``hetu_segment_sum`` (built on first use)."""
    if not _FN:
        fn = _build.load("segment_sum").hetu_segment_sum
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def sorted_segment_sum_plain(rows, seg_ids, num_segments):
    """Plain PyTorch version: ``index_add_`` of ``rows`` into zero rows
    by segment id (on the card it adds with atomics, in no fixed order)."""
    out = torch.zeros((num_segments, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, seg_ids.long(), rows.to(torch.float32))


def sorted_segment_sum(rows, seg_ids, num_segments):
    """Sum ``rows`` (n, d) float32 over sorted, contiguous ``seg_ids`` (n,)
    int32 starting at 0.  Returns (num_segments, d) float32; rows past the
    last segment are zero."""
    global launches
    if rows.ndim != 2 or seg_ids.shape != (rows.shape[0],):
        raise ValueError(f"sorted_segment_sum: rows (n, d) and seg_ids (n,) "
                         f"expected, got {tuple(rows.shape)} and "
                         f"{tuple(seg_ids.shape)}")
    if rows.dtype != torch.float32 or seg_ids.dtype != torch.int32:
        raise TypeError(f"sorted_segment_sum: float32 rows and int32 "
                        f"seg_ids expected, got {rows.dtype}, "
                        f"{seg_ids.dtype}")
    if seg_ids.device != rows.device:
        raise ValueError(f"sorted_segment_sum: seg_ids on {seg_ids.device}, "
                         f"rows on {rows.device}")
    n, d = rows.shape
    if rows.device.type == "cpu":
        return sorted_segment_sum_plain(rows, seg_ids, num_segments)
    if rows.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: no kernel for device "
                         f"{rows.device}")
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=rows.device)
    if n == 0 or num_segments == 0:
        return out.zero_()
    rows, seg_ids = rows.contiguous(), seg_ids.contiguous()
    with torch.cuda.device(rows.device):
        rc = kernel()(rows.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), n,
                      d, num_segments,
                      torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sorted_segment_sum: kernel launch failed "
                           f"(cudaError {rc})")
    launches += 1
    return out


def dedup_rows(ids, rows):
    """Sum rows sharing an id (the reference's ``cpu_deduplicate``).
    Returns (unique_ids (n,) int32, summed (n, d), n_unique): padded to
    the input length with id -1 and zero rows, as the JAX version's static
    shapes are; ``n_unique`` is a 0-d tensor."""
    n = ids.shape[0]
    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    r = rows.index_select(0, order)
    starts = torch.ones(n, dtype=torch.int32, device=ids.device)
    if n > 1:
        starts[1:] = (sid[1:] != sid[:-1]).to(torch.int32)
    seg = (torch.cumsum(starts, 0) - 1).to(torch.int32)
    summed = sorted_segment_sum(r, seg, n)
    n_unique = seg[-1] + 1
    uniq = torch.full((n,), -1, dtype=torch.int32, device=ids.device)
    uniq[seg.long()] = sid
    return uniq, summed, n_unique
