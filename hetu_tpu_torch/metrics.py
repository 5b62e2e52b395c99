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
* ``moe_fallbacks`` — sparse MoE dispatches (``dispatch:backend:cpu``,
  ``combine:backend:cpu``) that took the plain row gather instead of the
  CUDA kernel; a CUDA tensor never records.
* ``cache`` — HET embedding-cache events (``emb_cache_hit_rows``,
  ``emb_cache_miss_rows``, ``emb_cache_evict_rows``,
  ``emb_cache_push_rows``, ``emb_cache_push_rpcs``,
  ``emb_grad_host_fallback``) and the sharded store's wire batching:
  rows and bytes the client-side dedup kept off the wire before the
  shard fanout (``ps_dedup_{pull,push}_{rows,bytes}_saved``, the local
  shard's share included) and round trips where one ``OP_PUSH_PULL``
  frame carried both a push and a pull (``ps_push_pull_fused_rpcs``); a
  dense run records nothing.
* ``ps_rpc`` / ``ps_rpc_bytes`` — one count and the request bytes (keys
  and payload, header excluded) of every successful client RPC of a
  :class:`~hetu_tpu_torch.ps.dist_store.DistributedStore`, by opcode
  name (``OP_PULL``, ``OP_PUSH``, ...), with its round-trip latency in
  microseconds among the latency samples under ``rpc:<opcode>``
  (:func:`record_rpc`, :func:`rpc_stats`); counter-silent probes record
  nothing.
* ``decode`` — decode-plane events (``decode_steps``, ``decode_tokens``,
  joins/leaves, prefill rows, ...); kinds ending in ``_hw`` are
  high-water gauges.
* ``serve`` — InferenceExecutor events, same gauge rule.
* ``faults`` — fault-tolerance events by kind:
  ``preduce_dead_rank_excluded``, dead ranks a partial-reduce group left
  out (``parallel.preduce.PartialReduce``); and the checkpoint events the
  JAX package records, ``auto_save`` (a periodic checkpoint written),
  ``emergency_save`` (a SIGTERM / SIGINT save), ``resume`` (a
  checkpoint restored) and ``ckpt_incomplete_skipped`` (an incomplete
  checkpoint passed over by ``resume``); the sharded store's transport
  records ``ps_rpc_retry`` (a retried attempt), ``ps_peer_unreachable``
  (retries exhausted), ``ps_bad_frame`` (a frame length outside
  ``[0, HETU_MAX_FRAME_MB]``), ``heartbeat_send_failed`` and
  ``alive_mask_unavailable`` (``DistPartialReduce`` formed a group
  without liveness).
* ``remat`` — rematerialization: the ``'full'`` plan's segments
  (``remat_layers_total``, ``remat_layers_rematted``, once a build),
  ``remat_offload_fallback`` (``'offload'`` without a card, once a
  build) and ``remat_offload_bytes`` (bytes ``'offload'`` moved to
  pinned host memory, every step).
* ``zero`` — the ZeRO sharded update's traffic and padding, in bytes
  (``zero_reduce_scatter_bytes``: gradient slabs reduce-scattered,
  ``zero_all_gather_bytes``: updated parameter slabs gathered back,
  ``zero_pad_bytes``: zero fill that makes ragged buckets shard evenly;
  ``parallel.zero``).  The JAX package counts once per trace; the port
  has no trace and counts every step, so a run of n steps records n
  times one step's bytes.  A run without ``zero=`` records nothing.
* ``run_plan`` — the executor's cached run plans
  (``graph/run_plan.py``): ``plan_cache_hit`` / ``plan_cache_miss`` a
  plan lookup (a steady feed schema hits every step after the first),
  ``feeds_pipelined`` (feeds whose host-to-device copy was issued ahead
  of the step that read them: the dataloader double buffer and
  ``Executor.run_steps``), ``feed_pipeline_depth_hw`` (the most
  dataloader feeds with a copy in flight at once, a gauge) and
  ``async_sync_points`` (where ``run(sync=False)`` had to wait: a numpy
  conversion, the PS push boundary, a save, the window filling).
* ``prefix_cache`` — the shared-prefix KV store's reuse
  (``serving/prefix_cache.py``): lookups that found a stored prefix
  (``prefix_cache_hits``) or not (``prefix_cache_misses``), the cache
  rows those hits seated pre-filled (``prefix_cache_hit_rows``),
  snapshots inserted (``prefix_cache_inserts``) or refused as an
  exact-key duplicate (``prefix_cache_dup_inserts``), LRU evictions
  (``prefix_cache_evictions``, ``prefix_cache_evicted_bytes``) and the
  resident-bytes high-water mark (``prefix_cache_bytes_hw``).
* ``decode_recovery`` — exactly-once migration of in-flight decode
  streams off a dead replica: streams detached as continuation requests
  (``decode_recovery_detached``), reseated on a survivor
  (``decode_recovery_reseated``), the rows the survivor re-prefilled
  (``decode_recovery_replayed_rows``) and the rows a prefix-store hit
  seated for free (``decode_recovery_prefix_assisted``), second and
  later recoveries of one stream (``decode_recovery_retries``), streams
  failed fast instead (``decode_recovery_exhausted``) and stale
  emissions the epoch fence dropped (``decode_recovery_fenced``).
* ``serve_rejection_reason`` — every ``ServeRejected`` by its structured
  reason (``queue_full``, ``over_max_len``, ``deadline``, ``draining``,
  ``recovery_exhausted``, ``shed:<class>``).
* ``fleet`` — the front door's events (``serving/fleet.py``):
  admissions and dispatches, sheds by class, replicas scaled out or in,
  ejected and re-admitted, requests rescued off a dead replica, admitted
  requests that failed, autoscaler polls and refused resizes, and the
  live-replica high-water mark (``fleet_replicas_hw``).
* latency samples in microseconds, the newest :data:`LATENCY_WINDOW`
  kept of each kind: decode (``step``, ``token``, ``ttft``,
  ``join_wait``, ``recovery``: detach to reseat of a migrated stream)
  and serving (``queue_wait`` a request, ``batch`` a micro-batch, each
  suffixed ``@<replica name>`` for a named router; ``request`` the front
  door's submit to done).

Abstract evaluation (``analysis/shapes.py``) runs the ops' lowerings on
meta tensors inside :func:`suppress_perf_counters`: the dispatch-time
families (flash, embedding and MoE fallbacks, remat, ZeRO) record
nothing there, on that thread only.

All families live in one process-wide registry guarded by one lock, so
the router's loop thread and a reader thread may touch them at once.
"""
from __future__ import annotations

import collections
import contextlib
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

    def kinds(self, prefix):
        """The latency kinds that start with ``prefix``."""
        with self._lock:
            return [k for k in self._latency if k.startswith(prefix)]

    def reset_latency(self, prefix=None):
        """Drop the latency samples (of the kinds starting ``prefix``)."""
        with self._lock:
            if prefix is None:
                self._latency.clear()
                return
            for kind in [k for k in self._latency if k.startswith(prefix)]:
                del self._latency[kind]


_REGISTRY = _Registry()

# per-thread: an abstract evaluation on one thread must not silence real
# dispatches on another
_suppress = threading.local()


@contextlib.contextmanager
def suppress_perf_counters():
    """Scope in which the dispatch-time counters do not record (abstract
    shape evaluation, which runs lowerings on meta tensors).  Per
    thread."""
    _suppress.depth = getattr(_suppress, "depth", 0) + 1
    try:
        yield
    finally:
        _suppress.depth -= 1


def counters_suppressed():
    """True inside a :func:`suppress_perf_counters` scope (this thread)."""
    return getattr(_suppress, "depth", 0) > 0


# ------------------------------------------------------ flash fallbacks

def record_flash_fallback(reason):
    """Count one attention dispatch that took the plain version."""
    if counters_suppressed():
        return
    _REGISTRY.record("flash_fallbacks", reason)


def flash_fallback_counts():
    """{reason: count} snapshot of recorded fallbacks."""
    return _REGISTRY.counts("flash_fallbacks")


def reset_flash_fallbacks():
    _REGISTRY.reset("flash_fallbacks")


# ------------------------------------------------- embedding fallbacks

def record_emb_fallback(reason):
    """Count one embedding-cache dispatch that took the plain version."""
    if counters_suppressed():
        return
    _REGISTRY.record("emb_fallbacks", reason)


def emb_fallback_counts():
    """{reason: count} snapshot of recorded embedding-kernel fallbacks."""
    return _REGISTRY.counts("emb_fallbacks")


def reset_emb_fallbacks():
    _REGISTRY.reset("emb_fallbacks")


# --------------------------------------------------------- MoE fallbacks

def record_moe_fallback(reason):
    """Count one sparse MoE dispatch or combine that took the plain
    gather."""
    if counters_suppressed():
        return
    _REGISTRY.record("moe_fallbacks", reason)


def moe_fallback_counts():
    """{reason: count} snapshot of recorded MoE-gather fallbacks."""
    return _REGISTRY.counts("moe_fallbacks")


def reset_moe_fallbacks():
    _REGISTRY.reset("moe_fallbacks")


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
    _REGISTRY.reset_latency("decode:")


def record_decode_latency(kind, us):
    """Observe one decode latency sample in microseconds (``step`` per
    engine step, ``token`` per emitted token, ``ttft`` per stream at its
    first token, ``join_wait`` per joined request, ``recovery`` per
    migrated continuation at its reseat)."""
    _REGISTRY.observe("decode:" + kind, us)


def _stats(prefix):
    """{kind: {count, p50, p99, mean}} over the kept samples of every
    kind under ``prefix`` (the prefix stripped)."""
    out = {}
    for kind in _REGISTRY.kinds(prefix):
        a = np.asarray(_REGISTRY.samples(kind))
        if a.size:
            out[kind[len(prefix):]] = {
                "count": int(a.size),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "mean": float(a.mean())}
    return out


def decode_latency_stats():
    """{kind: {count, p50, p99, mean}} over the kept samples (us)."""
    return _stats("decode:")


# -------------------------------------------------------------- serving

def record_serve(kind, n=1):
    """Count ``n`` serving events of ``kind`` (``*_hw`` kinds: max gauge)."""
    _REGISTRY.record("serve", kind, n)


def serve_counts():
    return _REGISTRY.counts("serve")


def reset_serve_counts():
    _REGISTRY.reset("serve")


def record_serve_latency(kind, us):
    """Observe one serving latency sample in microseconds (``kind``:
    ``queue_wait`` per request, ``batch`` per dispatched micro-batch,
    ``request`` per front-door admission; a named router suffixes its
    kinds ``@<name>``)."""
    _REGISTRY.observe("serve:" + kind, us)


def serve_latency_stats():
    """{kind: {count, p50, p99, mean}} over the kept serving samples."""
    return _stats("serve:")


def reset_serve_latency():
    _REGISTRY.reset_latency("serve:")


def record_serve_rejection(reason, n=1):
    """Count ``n`` rejections with the structured ``reason`` (one of
    ``ServeRejected.REASONS``, or ``shed:<class>``)."""
    if n:
        _REGISTRY.record("serve_rejection_reason", str(reason), n)


def serve_rejection_counts():
    """{reason: count} snapshot of structured serving rejections."""
    return _REGISTRY.counts("serve_rejection_reason")


def reset_serve_rejection_counts():
    _REGISTRY.reset("serve_rejection_reason")


# ------------------------------------------ prefix store, recovery, fleet

def record_prefix_cache(kind, n=1):
    """Count ``n`` prefix-cache events of ``kind`` (``*_hw``: max gauge)."""
    _REGISTRY.record("prefix_cache", kind, n)


def prefix_cache_counts():
    """{kind: count} snapshot of the prefix-cache counters."""
    return _REGISTRY.counts("prefix_cache")


def reset_prefix_cache_counts():
    _REGISTRY.reset("prefix_cache")


def record_decode_recovery(kind, n=1):
    """Count ``n`` stream-recovery events of ``kind`` (``*_hw``: max
    gauge)."""
    _REGISTRY.record("decode_recovery", kind, n)


def decode_recovery_counts():
    """{kind: count} snapshot of the stream-recovery counters."""
    return _REGISTRY.counts("decode_recovery")


def reset_decode_recovery_counts():
    _REGISTRY.reset("decode_recovery")


def record_fleet(kind, n=1):
    """Count ``n`` fleet events of ``kind`` (``*_hw``: max gauge)."""
    _REGISTRY.record("fleet", kind, n)


def fleet_counts():
    """{kind: count} snapshot of the fleet counters."""
    return _REGISTRY.counts("fleet")


def reset_fleet_counts():
    _REGISTRY.reset("fleet")


# --------------------------------------------------------------- faults

def record_fault(kind, n=1):
    """Count ``n`` fault-tolerance events of ``kind`` (a detection or a
    recovery: a clean run records none)."""
    _REGISTRY.record("faults", kind, n)


def fault_counts():
    """{kind: count} snapshot of recorded fault events."""
    return _REGISTRY.counts("faults")


def reset_faults():
    _REGISTRY.reset("faults")


# ------------------------------------------------------- PS transport

def record_rpc(op, us, nbytes):
    """One successful PS client RPC of opcode name ``op``: its latency
    (``us``) among the samples, its request bytes into ``ps_rpc_bytes``."""
    _REGISTRY.record("ps_rpc", op, 1)
    if nbytes:
        _REGISTRY.record("ps_rpc_bytes", op, int(nbytes))
    _REGISTRY.observe("rpc:" + op, us)


def rpc_stats():
    """{"calls": {op: n}, "bytes": {op: total}, "latency_us": {op:
    {count, p50, p99, mean}}} over the kept samples."""
    calls = _REGISTRY.counts("ps_rpc")
    lat = {}
    for op in calls:
        s = _REGISTRY.samples("rpc:" + op)
        if s:
            a = np.asarray(s)
            lat[op] = {"count": int(a.size),
                       "p50": float(np.percentile(a, 50)),
                       "p99": float(np.percentile(a, 99)),
                       "mean": float(a.mean())}
    return {"calls": calls, "bytes": _REGISTRY.counts("ps_rpc_bytes"),
            "latency_us": lat}


def reset_rpc_stats():
    _REGISTRY.reset("ps_rpc")
    _REGISTRY.reset("ps_rpc_bytes")
    _REGISTRY.reset_latency("rpc:")


# ----------------------------------------------------------------- ZeRO

def record_remat(kind, n=1):
    """Count ``n`` rematerialization events of ``kind``."""
    if n and not counters_suppressed():
        _REGISTRY.record("remat", kind, n)


def remat_counts():
    """{kind: count} of rematerialization events."""
    return _REGISTRY.counts("remat")


def reset_remat_counts():
    _REGISTRY.reset("remat")


def record_zero(kind, n=1):
    """Count ``n`` bytes of ZeRO sharded-update traffic of ``kind``."""
    if n and not counters_suppressed():
        _REGISTRY.record("zero", kind, n)


def zero_counts():
    """{kind: bytes} snapshot of the ZeRO counters."""
    return _REGISTRY.counts("zero")


def reset_zero_counts():
    _REGISTRY.reset("zero")


# ------------------------------------------------------------- run plans

def record_run_plan(kind, n=1):
    """Count ``n`` run-plan / async-stepping events of ``kind``; kinds
    ending in ``_hw`` are high-water gauges."""
    _REGISTRY.record("run_plan", kind, n)


def run_plan_counts():
    """{kind: count} snapshot of the run-plan counters."""
    return _REGISTRY.counts("run_plan")


def reset_run_plan_counts():
    _REGISTRY.reset("run_plan")


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
