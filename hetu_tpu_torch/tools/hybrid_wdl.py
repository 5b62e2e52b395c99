"""One rank of the hybrid Wide & Deep deployment: dense parameters
averaged over ``DataParallel`` ranks, embedding rows in a sharded
parameter server with a shard on every rank.  Start it through the
launcher, one process a rank:

    python -m hetu_tpu_torch.launcher -n 2 --no-ssh \\
        hetu_tpu_torch/tools/hybrid_wdl.py --ports 41000,41001 --out DIR

Each rank opens the ``torch.distributed`` world
(:func:`hetu_tpu_torch.launcher.init_distributed`, gloo: ranks may share
one card), serves shard ``rank`` of a :class:`DistributedStore`
(``--ports``, one a rank; ``HETU_PS_REPLICATION=2``, the launcher's
``--ps-replication 2``, for backups), and for every run of ``--opts`` x
``--modes`` x ``--bsps`` builds ``wdl_criteo`` over a fresh table of the
store (``embed_mode`` ``ps``: plain lookups; ``vlru``: the host-mode HET
cache over the store; ``--opts``: the table's server-side optimizer,
``sgd`` or ``adam``), whose rows rank 0 sets from a seeded table
(:func:`table0`, seed 1), and trains it ``--steps`` steps through
``Executor(dist_strategy=DataParallel(), bsp=...)``, every rank fed the
global batch of ``synthetic_criteo_skewed`` (:func:`feeds`, seed 0).
``--weights``: a pickle of the dense weights by name, loaded before the
first step (else seed 0's).  One process alone (no launcher) is a world
of one with no strategy: the same graph over a one-shard store.

Rank ``r`` writes ``DIR/rank<r>.json``: each run's losses, step
milliseconds (wall, on the host's clock), the table's digest (the sum of
its rows' absolute values), cache counters and, under SSP, every rank's
clock after the run; with ``--dump-tables`` rank 0 writes each final
table as ``DIR/<run>.npy``; with ``--profile`` rank 0 adds its device
busy and idle share over three more steps on the card
(``torch.profiler``); every rank adds its fault counters, the shards its
server serves at the end and its launches of the embedding cache's
kernels.  ``--save-resume K`` adds a run ``resume``: K steps,
``Executor.save`` on every rank, the other steps, then a fresh executor
``resume``s the checkpoint (the shards' rows included) and trains the
same steps again.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import hetu_tpu_torch as ht  # noqa: E402
from hetu_tpu_torch import launcher, metrics  # noqa: E402
from hetu_tpu_torch.ps.dist_store import DistributedStore  # noqa: E402

#: the dense and the table's learning rate (``wdl_criteo``'s default)
LR = 0.01


def table0(vocab, dim, seed):
    """The table's initial rows (every run, every deployment)."""
    return np.random.RandomState(seed).uniform(
        -0.01, 0.01, (vocab, dim)).astype(np.float32)


def feeds(steps, batch, vocab, seed):
    """``steps`` global batches: (dense, sparse, labels) each."""
    d, s, y = ht.synthetic_criteo_skewed(steps * batch, vocab=vocab,
                                         seed=seed)
    return [(d[i * batch:(i + 1) * batch], s[i * batch:(i + 1) * batch],
             y[i * batch:(i + 1) * batch]) for i in range(steps)]


class Run:
    """Wide & Deep over a new table of ``store``: the executor, its
    placeholders, its PS node."""

    def __init__(self, store, mode, opt, a, rows, **ex_kw):
        self.dense = ht.placeholder_op("dense")
        self.sparse = ht.placeholder_op("sparse", dtype=np.int64)
        self.y_ = ht.placeholder_op("y")
        loss, _ = ht.models.ctr.wdl_criteo(
            self.dense, self.sparse, self.y_, a.batch, vocab=a.vocab,
            dim=a.dim, embed_mode=mode, lr=LR, store=store, table_opt=opt)
        self.ex = ht.Executor({"train": [loss, ht.optim.SGDOptimizer(LR)
                                         .minimize(loss)]},
                              seed=0, device=a.device, **ex_kw)
        self.node = self.ex.subexecutors["train"].ps_nodes[0]
        if rows is not None:
            # rank 0 writes every shard's rows; the others wait for them
            if _rank() == 0:
                store.set_data(self.node.table, rows)
            _barrier()

    def steps(self, batches):
        """Train on ``batches``: (losses, step ms)."""
        losses, ms = [], []
        for d, s, y in batches:
            t0 = time.perf_counter()
            out = self.ex.run("train", feed_dict={
                self.dense: d, self.sparse: s, self.y_: y})
            losses.append(float(out[0].asnumpy()))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    def device_busy(self, batches):
        """(device busy ms, wall ms) a step over ``batches`` under
        ``torch.profiler``: the card's kernels and copies."""
        from hetu_tpu_torch.tools.profile_moe import device_profile
        it = iter(batches)

        def step():
            d, s, y = next(it)
            self.ex.run("train", feed_dict={self.dense: d, self.sparse: s,
                                            self.y_: y})

        kern, wall, _ = device_profile(step, len(batches))
        busy = sum(v[1] for v in kern.values()) / 1e3
        return busy / len(batches), wall * 1e3 / len(batches)

    def finish(self):
        """Land every push (ASP's, the cache's pending rows) in the
        store; returns the cache's counters (None without a cache)."""
        self.ex.ps_flush()
        cache = self.node.cache
        if cache is not None:
            cache.flush()
        _barrier()
        return None if cache is None else \
            {k: int(cache.stats[k]) for k in ("lookups", "hits", "pushes")}


def _rank():
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ports", required=True,
                    help="the store's ports, one a rank, comma-separated")
    ap.add_argument("--modes", default="ps,vlru")
    ap.add_argument("--bsps", default="0,-1",
                    help="0 BSP, -1 ASP, k > 0 SSP; comma-separated")
    ap.add_argument("--opts", default="sgd",
                    help="the table's server-side optimizers")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=100000)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--rpc-timeout", type=float, default=60.0,
                    help="the store's socket deadline (s)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--dump-tables", action="store_true")
    ap.add_argument("--save-resume", type=int, default=0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)

    launcher.init_distributed()
    rank, world = _rank(), (dist.get_world_size()
                            if dist.is_initialized() else 1)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))
    if a.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    ports = [int(p) for p in a.ports.split(",")]
    if len(ports) != world:
        raise SystemExit(f"--ports names {len(ports)} ranks, the world "
                         f"has {world}")
    store = DistributedStore(rank, world, [("127.0.0.1", p) for p in ports],
                             port=ports[rank], rpc_timeout=a.rpc_timeout)
    weights = None
    if a.weights:
        with open(a.weights, "rb") as f:
            weights = pickle.load(f)
    batches = feeds(a.steps, a.batch, a.vocab, 0)
    # the profiled steps' batches come from the next seed, so the counted
    # ones are the same with or without them
    profiled = feeds(3, a.batch, a.vocab, 1) if a.profile else []
    rows0 = table0(a.vocab, a.dim, 1)
    strategy = ht.dist.DataParallel() if world > 1 else None
    out = {"rank": rank, "world": world, "runs": {}}
    for opt in a.opts.split(","):
        for mode in a.modes.split(","):
            for bsp in (int(b) for b in a.bsps.split(",")):
                if bsp > 0:
                    # one SSP clock a rank (idempotent on every rank)
                    store.ssp_init(world)
                run = Run(store, mode, opt, a, rows0,
                          dist_strategy=strategy, bsp=bsp)
                if weights is not None:
                    run.ex.load_dict(weights)
                losses, ms = run.steps(batches)
                rec = {"losses": losses, "step_ms": ms,
                       "cache": run.finish()}
                if bsp > 0:
                    rec["clocks"] = store.clocks().tolist()
                rows = store.pull(run.node.table, np.arange(a.vocab))
                rec["digest"] = float(np.abs(rows.astype(np.float64)).sum())
                name = f"{mode}_{opt}_bsp{bsp}"
                if a.dump_tables and rank == 0:
                    np.save(os.path.join(a.out, name + ".npy"), rows)
                if a.profile and rank == 0 and a.device != "cpu":
                    busy, wall = run.device_busy(profiled)
                    rec.update(busy_ms=busy, profiled_ms=wall,
                               idle_share=max(0.0, 1.0 - busy / wall))
                elif a.profile:
                    # the other ranks take the same steps, unprofiled
                    run.steps(profiled)
                run.ex.close()
                _barrier()
                out["runs"][name] = rec
    if a.save_resume:
        out["resume"] = save_resume(store, a, rows0, weights, strategy,
                                    batches)
    out["faults"] = dict(metrics.fault_counts())
    out["serving"] = sorted(store.server._serving)
    # the embedding cache's kernels (B4, B5) run only on a device cache,
    # which the strategy refuses: none launched here
    from hetu_tpu_torch.ops.kernels import emb_cache, segment_sum
    out["launches"] = {"emb_gather": emb_cache.launches,
                       "sorted_segment_sum": segment_sum.launches}
    tmp = os.path.join(a.out, f"rank{rank}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(a.out, f"rank{rank}.json"))
    _barrier()
    store.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def save_resume(store, a, rows0, weights, strategy, batches):
    """``--save-resume K`` over the first mode and optimizer under BSP:
    the uninterrupted losses after step K and a fresh executor's from the
    checkpoint, and the step it restored."""
    k = a.save_resume
    mode, opt = a.modes.split(",")[0], a.opts.split(",")[0]
    run = Run(store, mode, opt, a, rows0, dist_strategy=strategy)
    if weights is not None:
        run.ex.load_dict(weights)
    run.steps(batches[:k])
    path = os.path.join(a.out, "ckpt")
    run.ex.save(path)
    want, _ = run.steps(batches[k:])
    run.finish()
    run.ex.close()
    fresh = Run(store, mode, opt, a, None, dist_strategy=strategy)
    # the fresh executor's table: the graph made a new one; the
    # checkpoint's rows go to it
    step = fresh.ex.resume(path)
    got, _ = fresh.steps(batches[k:])
    fresh.finish()
    fresh.ex.close()
    _barrier()
    return {"want": want, "got": got, "step": step}


if __name__ == "__main__":
    sys.exit(main())
