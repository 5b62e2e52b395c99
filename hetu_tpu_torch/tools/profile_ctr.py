"""Where the time of a Wide & Deep CTR training step goes, on the card.

Runs the CTR workload of ``chip_smoke.py`` (Wide & Deep at the
repository's WDL configuration: batch 2048, 26 Zipf fields, vocab
100,000, dim 16, MLP 429-256-256-1 plus wide 13-1, ``SGDOptimizer(0.01)``,
through the device-resident HET cache, ``embed_mode="vlru_dev"``, with
``synthetic_criteo_skewed(8 * 2048, seed=0)`` cycled) and reports per
step:

* the host time of each part of ``Executor.run``, timed by wrapping the
  functions that do it (no synchronisation is added, so a device part
  counts the time the host spends issuing it): the slot plan
  (``begin_lookup``), the miss pull and pending pushes
  (``_DevLookup.roundtrip``, on the feed thread, overlapping the feed
  placement), the wait for it, the commit and slab fill
  (``finish_lookup``), the gather (``DistCacheTable.gather``), the grad
  scatter-add (sort, permutation, kernel), the copy of the U summed rows
  to the host (the step's one sync point), ``apply_update_summed``, and
  the rest (feeds, forward, backward, optimizer);
* under ``torch.profiler``: the device busy time (the sum of kernel and
  copy durations), the device's idle share against the unprofiled step,
  the launches, the kernels that take the most device time, and the two
  embedding kernels' times inside the step.

Run from the repository root::

    python3 -m hetu_tpu_torch.tools.profile_ctr [--out DIR] [--steps N]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import threading
import time

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.graph import executor as gexec
from hetu_tpu_torch.ps import dist_store

BATCH, VOCAB, DIM, WARMUP = 2048, 100000, 16, 3
EMB_KERNELS = {"gather_rows_vec4_kernel": "gather",
               "gather_rows_scalar_kernel": "gather",
               "segment_sum_kernel": "segment_sum"}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


class _Timers:
    """Seconds per part, summed over the timed steps (thread-safe: the
    miss pull runs on the feed thread)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sums = collections.defaultdict(float)

    def add(self, part, dt):
        with self.lock:
            self.sums[part] += dt

    def wrap(self, owner, attr, part):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(part, time.perf_counter() - t0)
        setattr(owner, attr, timed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the JSON report and tables")
    ap.add_argument("--steps", type=int, default=20,
                    help="timed steps without the profiler (and the "
                         "profiled steps: 5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ctr: needs a CUDA card")
    dense = ht.placeholder_op("dense")
    sparse = ht.placeholder_op("sparse", dtype=np.int64)
    y_ = ht.placeholder_op("y")
    loss, _ = ht.wdl_criteo(dense, sparse, y_, BATCH, vocab=VOCAB, dim=DIM,
                            embed_mode="vlru_dev", lr=0.01)
    ex = ht.Executor({"train": [loss,
                                ht.optim.SGDOptimizer(0.01).minimize(loss)]},
                     seed=0, device="cuda")
    d, s, y = ht.synthetic_criteo_skewed(8 * BATCH, vocab=VOCAB, seed=0)
    feeds = [{dense: d[i * BATCH:(i + 1) * BATCH],
              sparse: s[i * BATCH:(i + 1) * BATCH],
              y_: y[i * BATCH:(i + 1) * BATCH]} for i in range(8)]
    counter = [0]

    def step():
        fd = feeds[counter[0] % len(feeds)]
        counter[0] += 1
        return float(ex.run("train", feed_dict=fd)[0].asnumpy())

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    step_s = float(np.mean(times))

    # the same steps again with every part timed on the host
    tm = _Timers()
    cache_cls, sub = dist_store.DistCacheTable, gexec.SubExecutor
    tm.wrap(cache_cls, "begin_lookup", "plan")
    tm.wrap(dist_store._DevLookup, "roundtrip", "miss_pull (feed thread)")
    tm.wrap(cache_cls, "finish_lookup", "commit_fill")
    tm.wrap(cache_cls, "gather", "gather")
    tm.wrap(gexec, "emb_scatter_add", "scatter_add")
    tm.wrap(cache_cls, "apply_update_summed", "apply_update_summed")
    tm.wrap(sub, "_ps_post_step", "_post_step")
    tm.wrap(sub, "_finish_dev_lookups", "_finish")
    wall = 0.0
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        wall += time.perf_counter() - t0
    sums = dict(tm.sums)
    n = args.steps
    parts = {k: v / n * 1e3 for k, v in sums.items()
             if not k.startswith("_")}
    parts["d2h_summed_rows"] = (sums["_post_step"]
                                - sums["apply_update_summed"]) / n * 1e3
    parts["miss_pull_wait"] = (sums["_finish"] - sums["commit_fill"]
                               - sums["gather"]) / n * 1e3
    on_main = sum(v for k, v in parts.items() if "feed thread" not in k)
    parts["rest (feeds, forward, backward, optimizer)"] = \
        wall / n * 1e3 - on_main

    psteps = 5
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(psteps):
            step()
        torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    kern = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kern[e.name]
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
    busy_us = sum(v[1] for v in kern.values())
    n_kern = sum(v[0] for v in kern.values())
    emb_us = collections.defaultdict(lambda: [0, 0.0])
    for name, (c, us) in kern.items():
        for key, short in EMB_KERNELS.items():
            if key in name:
                emb_us[short][0] += c
                emb_us[short][1] += us
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:15]
    cache = ex.subexecutors["train"].ps_nodes[0].cache
    report = {
        "card": _card(), "torch": torch.__version__, "batch": BATCH,
        "vocab": VOCAB, "dim": DIM,
        "step_ms_mean": step_s * 1e3,
        "step_ms_p50": float(np.percentile(times, 50)) * 1e3,
        "step_ms_p99": float(np.percentile(times, 99)) * 1e3,
        "samples_per_s": BATCH / step_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "host_ms_per_step": {"wall (timed parts run)": wall / n * 1e3,
                             **parts},
        "cache": cache.perf(),
        "profiled": {
            "steps": psteps, "wall_ms_per_step": pwall / psteps * 1e3,
            "device_busy_ms_per_step": busy_us / psteps / 1e3,
            "device_idle_share_unprofiled":
                1.0 - busy_us / 1e6 / psteps / step_s,
            "device_idle_share_profiled": 1.0 - busy_us / 1e6 / pwall,
            "device_ops_per_step": n_kern / psteps,
            "emb_kernels": {k: {"per_step": c / psteps,
                                "ms_per_launch": us / c / 1e3 if c else None}
                            for k, (c, us) in emb_us.items()},
            "top_kernels": [{"name": nm[:90], "count_per_step": c / psteps,
                             "ms_per_step": us / psteps / 1e3}
                            for nm, (c, us) in top]},
    }
    dev_table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=25)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_ctr.json"), "w") as f:
            json.dump(report, f, indent=1)
        with open(os.path.join(args.out, "profile_ctr_ops.txt"), "w") as f:
            f.write(dev_table + "\n\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                              row_limit=30))
    print(json.dumps(report, indent=1))
    if not kern:
        print("profile_ctr: the profiler recorded no device time")
    ex.close()


if __name__ == "__main__":
    main()
