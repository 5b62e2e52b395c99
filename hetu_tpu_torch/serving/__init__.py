"""Serving plane of the port (twin of ``hetu_tpu/serving``):

* :class:`InferenceExecutor` — serving over frozen weights, one cached
  step per batch bucket; ``infer`` / ``infer_rows`` pad a request batch to
  the smallest bucket and scatter by a static plan; weights from a dict, a
  live ``Executor`` or a checkpoint directory.
* :class:`ServingRouter` — a bounded queue feeding an adaptive
  micro-batcher (arrival-anchored ``max_wait_ms``).
* :class:`DecodeEngine` / :class:`DecodeRouter` — continuous-batching
  GPT-2 decode over device-resident KV caches, with chunked prefill, the
  shared-prefix :class:`PrefixKVStore`, and the fleet replica contract.
* :class:`FrontDoor` / :class:`SLOAutoscaler` — N replicas behind one
  door: least-loaded dispatch, class shedding, deadlines, ejection and
  rescue, exactly-once recovery of in-flight decode streams, autoscaling
  and graceful drain.
* :class:`CellMap` / :class:`CellHead` — serving cells: disjoint rank
  sets, each serving its traffic off a read-only embedding cache.
"""
from .cells import CellHead, CellMap
from .decode import DecodeEngine, DecodeRouter, DecodeStream
from .executor import InferenceExecutor, default_buckets
from .fleet import CLASSES, FrontDoor, SLOAutoscaler
from .prefix_cache import PrefixKVStore
from .router import ServingRouter, ServeRejected

__all__ = ["InferenceExecutor", "ServingRouter", "ServeRejected",
           "default_buckets", "CellMap", "CellHead", "DecodeEngine",
           "DecodeRouter", "DecodeStream",
           "PrefixKVStore", "FrontDoor", "SLOAutoscaler", "CLASSES"]
