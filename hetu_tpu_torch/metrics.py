"""Counters, latency samples and evaluation metrics of the port's paths
(the subset of ``hetu_tpu/metrics.py`` the ported slices record into).

Families:

* ``flash_fallbacks`` — attention dispatches that took the plain
  PyTorch attention instead of the CUDA kernel, by reason
  (``backend:cpu``).  On a CUDA tensor the dispatcher never records: it
  launches the kernel or raises.
* ``emb_fallbacks`` — embedding-cache dispatches (the slab row gather,
  the grad scatter-add) that took the plain version instead of the CUDA
  kernel, by reason (``gather:backend:cpu``, ``scatter_add:backend:cpu``);
  the twin of the JAX package's ``emb_pallas_fallbacks``, with the same
  rule as flash: a CUDA tensor never records.
* ``cache`` — HET embedding-cache events (``emb_cache_hit_rows``,
  ``emb_cache_miss_rows``, ``emb_cache_evict_rows``,
  ``emb_cache_push_rows``, ``emb_cache_push_rpcs``,
  ``emb_grad_host_fallback``); a dense run records nothing.
* ``decode`` — decode-plane events (``decode_steps``, ``decode_tokens``,
  joins/leaves, prefill rows, ...); kinds ending in ``_hw`` are
  high-water gauges.
* ``serve`` — InferenceExecutor events, same gauge rule.
* decode latency samples in microseconds by kind (``step``, ``token``,
  ``ttft``, ``join_wait``), the newest :data:`LATENCY_WINDOW` kept.

All families live in one process-wide registry guarded by one lock, so
the router's loop thread and a reader thread may touch them at once.
"""
from __future__ import annotations

import collections
import threading

import numpy as np

#: latency samples kept per kind (oldest dropped first)
LATENCY_WINDOW = 65536


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts = collections.defaultdict(collections.Counter)
        self._latency = collections.defaultdict(
            lambda: collections.deque(maxlen=LATENCY_WINDOW))

    def record(self, family, kind, n=1):
        kind = str(kind)
        with self._lock:
            fam = self._counts[family]
            if kind.endswith("_hw"):
                fam[kind] = max(fam.get(kind, 0), int(n))
            elif n:
                fam[kind] += int(n)

    def counts(self, family):
        with self._lock:
            return dict(self._counts[family])

    def reset(self, family):
        with self._lock:
            self._counts.pop(family, None)

    def observe(self, kind, us):
        with self._lock:
            self._latency[kind].append(float(us))

    def samples(self, kind):
        with self._lock:
            return list(self._latency.get(kind, ()))

    def reset_latency(self):
        with self._lock:
            self._latency.clear()


_REGISTRY = _Registry()


# ------------------------------------------------------ flash fallbacks

def record_flash_fallback(reason):
    """Count one attention dispatch that took the plain version."""
    _REGISTRY.record("flash_fallbacks", reason)


def flash_fallback_counts():
    """{reason: count} snapshot of recorded fallbacks."""
    return _REGISTRY.counts("flash_fallbacks")


def reset_flash_fallbacks():
    _REGISTRY.reset("flash_fallbacks")


# ------------------------------------------------- embedding fallbacks

def record_emb_fallback(reason):
    """Count one embedding-cache dispatch that took the plain version."""
    _REGISTRY.record("emb_fallbacks", reason)


def emb_fallback_counts():
    """{reason: count} snapshot of recorded embedding-kernel fallbacks."""
    return _REGISTRY.counts("emb_fallbacks")


def reset_emb_fallbacks():
    _REGISTRY.reset("emb_fallbacks")


# ------------------------------------------------------ embedding cache

def record_cache(kind, n=1):
    """Count ``n`` cache / sparse-transport events of ``kind``."""
    if n:
        _REGISTRY.record("cache", kind, n)


def cache_counts():
    """{kind: count} snapshot of the cache counters."""
    return _REGISTRY.counts("cache")


def reset_cache_counts():
    _REGISTRY.reset("cache")


# --------------------------------------------------------- decode plane

def record_decode(kind, n=1):
    """Count ``n`` decode events of ``kind`` (``*_hw`` kinds: max gauge)."""
    _REGISTRY.record("decode", kind, n)


def decode_counts():
    """{kind: count} snapshot of decode counters."""
    return _REGISTRY.counts("decode")


def reset_decode_counts():
    """Reset the decode counters AND the decode latency samples."""
    _REGISTRY.reset("decode")
    _REGISTRY.reset_latency()


def record_decode_latency(kind, us):
    """Observe one decode latency sample in microseconds (``step`` per
    engine step, ``token`` per emitted token, ``ttft`` per stream at its
    first token, ``join_wait`` per joined request)."""
    _REGISTRY.observe(kind, us)


def decode_latency_stats():
    """{kind: {count, p50, p99, mean}} over the kept samples (us)."""
    out = {}
    for kind in ("step", "token", "ttft", "join_wait"):
        s = _REGISTRY.samples(kind)
        if s:
            a = np.asarray(s)
            out[kind] = {"count": int(a.size),
                         "p50": float(np.percentile(a, 50)),
                         "p99": float(np.percentile(a, 99)),
                         "mean": float(a.mean())}
    return out


# -------------------------------------------------------------- serving

def record_serve(kind, n=1):
    """Count ``n`` serving events of ``kind`` (``*_hw`` kinds: max gauge)."""
    _REGISTRY.record("serve", kind, n)


def serve_counts():
    return _REGISTRY.counts("serve")


def reset_serve_counts():
    _REGISTRY.reset("serve")


# ------------------------------------------------------------ evaluation

def auc(y_pred, y_true):
    """Binary ROC-AUC via the rank statistic (ties averaged); 0.5 when
    one class is absent."""
    score = np.asarray(y_pred).reshape(-1)
    label = np.asarray(y_true).reshape(-1)
    # a tied group's rank is the mean of its positions: start + (count-1)/2
    _, inv, counts = np.unique(score, return_inverse=True,
                               return_counts=True)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    ranks = (starts + (counts - 1) / 2.0 + 1.0)[inv]
    pos = label > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
