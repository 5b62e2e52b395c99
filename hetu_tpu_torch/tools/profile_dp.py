"""Where the data-parallel strategy's extra time goes in a ResNet-18 step
at world size 1, on the card.

``chip_smoke.py``'s phase 38 times the plain executor against
``Executor(dist_strategy=DataParallel())`` on bench.py's ResNet-18 step
(:func:`~hetu_tpu_torch.tools.profile_train.resnet18_step`: batch 128,
``MomentumOptimizer(0.1)``) on an NCCL group of one rank.  This splits the
difference by taking the strategy's parts away one at a time; at world
size 1 every all-reduce is the identity, so each variant computes the
same step:

* ``plain``: the plain executor;
* ``dp``: the strategy as it is;
* ``dp-no-bn-allreduce``: sync BN's two all-reduces a BatchNorm skipped;
* ``dp-no-buckets``: the gradient buckets (``cat``, all-reduce, divide,
  ``split``) skipped;
* ``dp-plain-bn``: BatchNorm lowered as in the plain executor
  (``F.batch_norm``; no sync BN), the buckets kept;
* ``dp-plain-bn-no-buckets``: both: what is left is the batch-axis table
  and the loss's one all-reduce.

Each variant runs ``ROUNDS`` steps in turns with the others (the order
rotated each round), after ``WARMUP`` steps; reported: the p50, fastest
and slowest step.  Then ``plain`` and ``dp`` run ``PROFILED`` steps each
under ``torch.profiler``: the device busy ms and kernels a step, and the
host operators with the most self time a step.  Run from the repository
root::

    python3 -m hetu_tpu_torch.tools.profile_dp [--out DIR]

``--out`` receives ``profile_dp.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist

import hetu_tpu_torch as ht
from hetu_tpu_torch.graph import executor as executor_mod
from hetu_tpu_torch.parallel import batch_axis
from hetu_tpu_torch.tools import profile_train as pt

VARIANTS = ("plain", "dp", "dp-no-bn-allreduce", "dp-no-buckets",
            "dp-plain-bn", "dp-plain-bn-no-buckets")
WARMUP, ROUNDS, PROFILED, BATCH = 3, 15, 3, 128


@contextlib.contextmanager
def _patched(variant):
    """The strategy with the parts ``variant`` names taken away."""
    saved = (batch_axis.dist, executor_mod.all_reduce_mean_buckets,
             batch_axis.RULES["BatchNorm"])
    if variant == "dp-no-bn-allreduce":
        batch_axis.dist = types.SimpleNamespace(
            all_reduce=lambda t, group=None: None)
    if variant.endswith("no-buckets"):
        executor_mod.all_reduce_mean_buckets = lambda ts, group=None: ts
    if variant.startswith("dp-plain-bn"):
        batch_axis.RULES["BatchNorm"] = batch_axis._rowwise
    try:
        yield
    finally:
        (batch_axis.dist, executor_mod.all_reduce_mean_buckets,
         batch_axis.RULES["BatchNorm"]) = saved


def host_ops(prof, steps, top=12):
    """The host operators with the most self time, a step."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [{"name": e.key[:80], "calls_per_step": e.count / steps,
             "self_host_ms_per_step": e.self_cpu_time_total / steps / 1e3}
            for e in rows[:top]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for profile_dp.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_dp: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = pt.CUDNN_BENCHMARK
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method="file://"
                            + os.path.join(tmp, "init"), rank=0,
                            world_size=1)
    try:
        runs = {}
        for v in VARIANTS:
            strategy = None if v == "plain" else ht.dist.DataParallel()
            ex, fd, _ = pt.resnet18_step(BATCH, dist_strategy=strategy)
            runs[v] = lambda ex=ex, fd=fd: float(
                ex.run("train", feed_dict=fd)[0].asnumpy())   # waits
        times = {v: [] for v in VARIANTS}
        for r in range(WARMUP + ROUNDS):
            k = r % len(VARIANTS)
            for v in VARIANTS[k:] + VARIANTS[:k]:
                with _patched(v):
                    t0 = time.perf_counter()
                    runs[v]()
                    if r >= WARMUP:
                        times[v].append((time.perf_counter() - t0) * 1e3)
        report = {"batch": BATCH, "rounds": ROUNDS,
                  "step_ms": {v: {"p50": float(np.percentile(t, 50)),
                                  "min": min(t), "max": max(t)}
                              for v, t in times.items()}}
        for v in ("plain", "dp"):
            rep, prof = pt.profile_steps(runs[v], PROFILED)
            report[v + "_profiled"] = {
                "device_busy_ms_per_step": rep["device_busy_ms_per_step"],
                "kernels_per_step": rep["kernels_per_step"],
                "wall_ms_per_step": rep["wall_ms_per_step"],
                "host_ops": host_ops(prof, PROFILED)}
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_dp.json"), "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
