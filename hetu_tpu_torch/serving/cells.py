"""Serving cells (twin of ``hetu_tpu/serving/cells.py``).

A cell is a set of ranks that shares a failure domain: a pod, a zone.
Each cell serves its own traffic through its own
:class:`~hetu_tpu_torch.serving.ServingRouter` off a read-only
``DistCacheTable``: warm rows are answered with no cross-cell frame,
reads are unfenced (bounded staleness, the HET contract), and the write
plane converges through the store's fencing epochs — a cell that
promoted a backup made a newer lineage, so a stranded ex-primary is
refused, demotes itself and re-replicates.

:class:`CellMap` names disjoint rank sets; :meth:`CellMap.partition_spec`
formats the chaos-DSL string of a cross-cell cut
(``partition:rankA+...|rankB+...@step<n>[:heal<m>]``) — only the string:
the port has no chaos injector to play it (``HETU_CHAOS`` stays refused
by name).  :class:`CellHead` is one cell's serving head: its store
client, its read-only cache and the router in front of its
:class:`~hetu_tpu_torch.serving.InferenceExecutor`.
"""
from __future__ import annotations

import numpy as np

from .router import ServeRejected


class CellMap:
    """Disjoint, exhaustively tagged rank sets: ``{"west": [0, 1],
    "east": [2, 3]}``.  Validation is loud — an untagged or doubly
    tagged rank would silently mis-route a scenario's traffic.

    A cell value may also be the dict form ``{"ranks": [...],
    "replicas": N}``: ``replicas`` sizes the cell's serving replica set,
    the ``n_replicas`` a :class:`~hetu_tpu_torch.serving.FrontDoor`
    fronting the cell starts with (:meth:`replicas` reads it back,
    default 1)."""

    def __init__(self, cells):
        self.cells = {}
        self._replicas = {}
        for name, spec in dict(cells).items():
            name = str(name)
            if isinstance(spec, dict):
                ranks = spec["ranks"]
                n_rep = int(spec.get("replicas", 1))
                if n_rep < 1:
                    raise ValueError(
                        f"cell {name!r} asks for {n_rep} replicas — a "
                        f"cell serves with at least one")
                extra = set(spec) - {"ranks", "replicas"}
                if extra:
                    raise ValueError(
                        f"cell {name!r} spec has unknown keys "
                        f"{sorted(extra)} (known: ranks, replicas)")
                self._replicas[name] = n_rep
            else:
                ranks = spec
                self._replicas[name] = 1
            self.cells[name] = sorted(int(r) for r in ranks)
        self._cell_of = {}
        for name, ranks in self.cells.items():
            if not ranks:
                raise ValueError(f"cell {name!r} tags no ranks")
            for r in ranks:
                if r in self._cell_of:
                    raise ValueError(
                        f"rank {r} tagged in both {self._cell_of[r]!r} "
                        f"and {name!r} — cells must be disjoint")
                self._cell_of[r] = name
        self.world = len(self._cell_of)
        if sorted(self._cell_of) != list(range(self.world)):
            raise ValueError(
                f"cells must tag ranks 0..{self.world - 1} exactly once "
                f"(got {sorted(self._cell_of)})")

    def cell_of(self, rank):
        """The cell name tagging ``rank``."""
        return self._cell_of[int(rank)]

    def ranks(self, cell):
        """The ranks tagged into ``cell``."""
        return list(self.cells[cell])

    def replicas(self, cell):
        """The cell's serving replica-set size (dict-form cell specs;
        1 for plain rank-list cells)."""
        if cell not in self.cells:
            raise KeyError(cell)
        return self._replicas.get(cell, 1)

    def is_local(self, cell, rank):
        return self._cell_of.get(int(rank)) == cell

    def partition_spec(self, cell_a, cell_b, step, heal=None):
        """The chaos-DSL string of a cross-cell partition,
        ``partition:rank<a>+...|rank<b>+...@step<n>[:heal<m>]``, as the
        JAX package's chaos injector parses it (formatting only)."""
        a = "+".join(f"rank{r}" for r in self.cells[cell_a])
        b = "+".join(f"rank{r}" for r in self.cells[cell_b])
        spec = f"partition:{a}|{b}@step{int(step)}"
        return spec if heal is None else f"{spec}:heal{int(heal)}"


class CellHead:
    """One cell's serving head: the cell-local store client, its
    read-only embedding cache, and the router fronting the cell's
    :class:`InferenceExecutor` — a :class:`ServingRouter`, or a
    :class:`~hetu_tpu_torch.serving.FrontDoor` over a replica set
    (duck-typed: anything with ``submit``/``close``).

    Keeps PER-CELL counters (admitted / answered / rejections / errors)
    so a scenario can assert "the local cell kept serving: rejections=0"
    without untangling the process-global serving counters shared by
    every cell in an in-process test."""

    def __init__(self, name, store, router, cache=None):
        self.name = str(name)
        self.store = store
        self.router = router
        self.cache = cache
        self.stats = {"admitted": 0, "answered": 0, "rejections": 0,
                      "errors": 0}

    def warm(self, keys):
        """Pre-fill the read-only cache with ``keys`` (one batched
        owner-grouped pull) — a cell warmed over its working set serves
        it through a partition with zero cross-cell frames."""
        if self.cache is not None and np.asarray(keys).size:
            self.cache.lookup(np.asarray(keys, np.int64))

    def serve_wave(self, feeds, timeout=60.0):
        """Submit every feed dict in ``feeds`` to this cell's router and
        wait for the answers.  Returns ``(responses, wave_stats)`` where
        ``responses[i]`` is the request's fetch row list or None (its
        slot in a rejected/errored wave), and ``wave_stats`` counts this
        wave's admitted/answered/rejections/errors (also accumulated
        into :attr:`stats`)."""
        wave = {"admitted": 0, "answered": 0, "rejections": 0,
                "errors": 0}
        futs = []
        for fd in feeds:
            try:
                futs.append(self.router.submit(fd))
                wave["admitted"] += 1
            except ServeRejected:
                futs.append(None)
                wave["rejections"] += 1
        responses = [None] * len(feeds)
        for i, fut in enumerate(futs):
            if fut is None:
                continue
            try:
                responses[i] = fut.result(timeout=timeout)
                wave["answered"] += 1
            except Exception:   # noqa: BLE001 — per-request fate only
                wave["errors"] += 1
        for k, v in wave.items():
            self.stats[k] += v
        return responses, wave

    def catch_up(self):
        """Post-heal convergence: repair any shard this cell's
        client failed over (epoch-checked re-replication — the stranded
        ex-primary demotes and re-syncs) and re-pull whatever cached
        rows the surviving lineage advanced meanwhile.  Returns
        ``{"repaired": bool, "refreshed_rows": int}``."""
        repaired = self.store.maybe_re_replicate() \
            if getattr(self.store, "replication", 1) >= 2 else False
        refreshed = 0
        if self.cache is not None:
            try:
                refreshed = self.cache.refresh_stale()
            except (RuntimeError, OSError, ConnectionError):
                pass    # best-effort mid-partition: cached rows keep
                        # serving; the next catch_up retries the sweep
        return {"repaired": bool(repaired),
                "refreshed_rows": int(refreshed)}

    def close(self):
        self.router.close()


__all__ = ["CellMap", "CellHead"]
