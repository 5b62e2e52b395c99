"""Where the time of a GShard MoE training step goes, on the card.

Builds the repository's MoE configuration (BASELINE config 5, the twin
of ``bench.py``'s ``build_moe_graph``): 8,192 tokens of width 512 from
``np.random.RandomState(0).randn``, ``TopKGate(512, 8192, 16, k=2,
capacity_factor=1.25)`` (capacity 1,280), ``Expert(16, 512, 2048)``
(relu), loss ``mean((h - y)^2) + 0.01 aux``, ``AdamOptimizer(1e-3)``,
``Executor(seed=0)``, float32, or with ``--compute-dtype bfloat16`` bf16
mixed precision (bench.py's accelerator setting: the row gather then runs
in bf16 and, for the combine backward's float32 gradient, in float32).
The sparse graph (``TopKGateSparse`` → ``SparseMoELayer``, the row-gather
kernel B6) is the default; ``--graph dense`` profiles the bench's own
dense ``MoELayer`` graph instead, the yardstick (it launches no gather).
Per step it reports:

* the host clock: step p50 / p99 / mean (each step ends in the loss's
  copy to the host), tokens/s, MFU against the 67 TFLOP/s float32 peak
  (bf16: the 989 TFLOP/s dense bf16 peak), peak device memory;
* under ``torch.profiler``: the device busy time (the sum of kernel and
  copy durations), the device's idle share against the unprofiled step,
  the launches, the device time of the matrix products, of B6 (by dtype)
  and of the rest, and the kernels that take the most device time.

Run from the repository root::

    python3 -m hetu_tpu_torch.tools.profile_moe [--out DIR] [--steps N]
        [--graph sparse|dense] [--compute-dtype bfloat16]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.ops.base import ItemOp
from hetu_tpu_torch.ops.kernels import moe_dispatch

TOKENS, D, EXPERTS, K, CAPACITY_FACTOR = 8192, 512, 16, 2, 1.25
WARMUP = 3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
#: the row gather's kernels in a trace, by the dtype they copy (the element
#: type is each template's argument): the bulk route for the MoE path's
#: rows, one chunk or one value a thread for others
B6_KERNELS = {"float32": ("row_gather_bulk_kernel<float>",
                          "row_gather_vec_kernel<float>",
                          "row_gather_scalar_kernel<float>"),
              "bfloat16": ("row_gather_bulk_kernel<__nv_bfloat16>",
                           "row_gather_vec_kernel<__nv_bfloat16>",
                           "row_gather_scalar_kernel<__nv_bfloat16>")}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _is_gemm(name):
    n = name.lower()
    return "gemm" in n or "cutlass" in n or "xmma" in n


def moe_graph(batch_tokens=TOKENS, sparse=True, d=D, experts=EXPERTS,
              hidden=None):
    """The MoE configuration's graph at ``batch_tokens`` tokens (width
    ``d``, ``experts`` experts of hidden width ``hidden``, 4 d by default:
    other values make a tiny slice of the same graph), as a dict: the
    placeholders ``x`` and ``y``, the ``loss``, the ``gate`` layer and
    ``route``, the gate's output nodes in order (sparse: token_of_slot,
    slot_of_token, k_of_slot, gate_w, aux; dense: dispatch, combine,
    aux)."""
    x = ht.placeholder_op("x", shape=(batch_tokens, d))
    y_ = ht.placeholder_op("y", shape=(batch_tokens, d))
    gate_cls = ht.TopKGateSparse if sparse else ht.TopKGate
    gate = gate_cls(d, batch_tokens, experts, k=K,
                    capacity_factor=CAPACITY_FACTOR)
    expert = ht.Expert(experts, d, hidden or 4 * d)
    moe = ht.SparseMoELayer(gate, expert, d) if sparse \
        else ht.MoELayer(gate, expert)
    h, aux = moe(x)
    loss = ht.reduce_mean_op(ht.mul_op(h - y_, h - y_), [0, 1]) + aux * 0.01
    route = sorted((n for n in ht.topo_sort([loss])
                    if isinstance(n, ItemOp) and n.inputs[0].op_type in
                    ("TopKGate", "TopKGateSparse")), key=lambda n: n.index)
    return {"x": x, "y": y_, "loss": loss, "gate": gate,
            "route": tuple(route)}


def moe_feeds(g, seed=0, device=None):
    """``{x: ..., y: ...}`` from ``np.random.RandomState(seed).randn``, x
    first, as the bench draws them: numpy arrays, or tensors placed on
    ``device`` once (the bench ``jax.device_put``s its feeds before the
    steps, so no step copies them from the host)."""
    rng = np.random.RandomState(seed)
    s, d = g["x"].shape
    fd = {g["x"]: rng.randn(s, d).astype(np.float32),
          g["y"]: rng.randn(s, d).astype(np.float32)}
    if device is not None:
        fd = {k: torch.from_numpy(v).to(device) for k, v in fd.items()}
    return fd


def build_moe_graph(batch_tokens=TOKENS, sparse=True, device=None,
                    compute_dtype=None):
    """The bench's MoE Adam step in the port: returns (``{"d", "experts",
    "capacity", "graph"}``, the ``Executor`` (``compute_dtype`` as given)
    with subgraph ``"train"`` = [loss, train op], the feed dict, its
    tensors on the executor's device)."""
    g = moe_graph(batch_tokens, sparse)
    opt = ht.optim.AdamOptimizer(1e-3)
    ex = ht.Executor({"train": [g["loss"], opt.minimize(g["loss"])]},
                     seed=0, device=device, compute_dtype=compute_dtype)
    return ({"d": D, "experts": EXPERTS, "capacity": g["gate"].capacity,
             "graph": g}, ex, moe_feeds(g, device=ex.device))


def moe_step_flops(batch_tokens=TOKENS):
    """Model FLOPs of one training step, counted as 3 x the forward's
    matrix products: the experts' two products over every slot
    (experts x capacity), 2 x 2 x slots x d x hidden forward, and the
    gate's 2 x tokens x d x experts."""
    cap = int(np.ceil(K * CAPACITY_FACTOR * batch_tokens / EXPERTS))
    fwd = 4.0 * EXPERTS * cap * D * (4 * D) \
        + 2.0 * batch_tokens * D * EXPERTS
    return 3.0 * fwd


def device_profile(step, steps):
    """Run ``step()`` ``steps`` times under ``torch.profiler``; returns
    (``{kernel name: [count, us]}`` of device work, wall seconds, the
    profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kern[e.name]
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
    return dict(kern), wall, prof


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the JSON report and tables")
    ap.add_argument("--steps", type=int, default=20,
                    help="timed steps without the profiler (and the "
                         "profiled steps: 5)")
    ap.add_argument("--graph", choices=("sparse", "dense"), default="sparse")
    ap.add_argument("--compute-dtype", choices=["bfloat16"], default=None,
                    help="mixed precision (default: float32)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_moe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dims, ex, fd = build_moe_graph(sparse=args.graph == "sparse",
                                   device="cuda",
                                   compute_dtype=args.compute_dtype)
    peak = ("bf16", PEAK_BF16_FLOPS) if args.compute_dtype \
        else ("fp32", PEAK_FP32_FLOPS)

    def step():
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

    psteps = 5
    moe_dispatch.launches = moe_dispatch.bf16_launches = 0
    kern, pwall, prof = device_profile(step, psteps)
    busy_us = sum(v[1] for v in kern.values())
    n_kern = sum(v[0] for v in kern.values())
    gemm = sum(v[1] for n, v in kern.items() if _is_gemm(n))
    b6 = {dt: [sum(v[i] for n, v in kern.items()
                   if any(k in n for k in names)) for i in (0, 1)]
          for dt, names in B6_KERNELS.items()}
    wrapper = {"float32": moe_dispatch.launches,
               "bfloat16": moe_dispatch.bf16_launches}
    for dt, n in wrapper.items():
        if n and not b6[dt][1] > 0:
            raise SystemExit(f"profile_moe: {n} {dt} row gathers launched, "
                             f"but no kernel named {B6_KERNELS[dt]} has "
                             f"device time")
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:15]
    flops = moe_step_flops()

    def per_step_ms(us):
        return us / psteps / 1e3

    report = {
        "card": _card(), "torch": torch.__version__, "graph": args.graph,
        "compute_dtype": args.compute_dtype or "float32",
        "tokens": TOKENS, "d": D, "experts": EXPERTS,
        "capacity": dims["capacity"],
        "step_ms_mean": step_s * 1e3,
        "step_ms_p50": float(np.percentile(times, 50)) * 1e3,
        "step_ms_p99": float(np.percentile(times, 99)) * 1e3,
        "tokens_per_s": TOKENS / step_s,
        "model_gflop_per_step": flops / 1e9,
        "mfu_" + peak[0]: flops / step_s / peak[1],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profiled": {
            "steps": psteps, "wall_ms_per_step": pwall / psteps * 1e3,
            "device_busy_ms_per_step": per_step_ms(busy_us),
            "device_idle_share_unprofiled":
                1.0 - busy_us / 1e6 / psteps / step_s,
            "device_idle_share_profiled": 1.0 - busy_us / 1e6 / pwall,
            "device_ops_per_step": n_kern / psteps,
            "gemm_ms_per_step": per_step_ms(gemm),
            "gemm_share_of_device": gemm / busy_us if busy_us else None,
            "row_gather": {dt: {"per_step": c / psteps,
                                "ms_per_step": per_step_ms(us),
                                "share_of_device":
                                    us / busy_us if busy_us else None,
                                "wrapper_launches_per_step":
                                    wrapper[dt] / psteps}
                           for dt, (c, us) in b6.items()},
            "top_kernels": [{"name": nm[:90], "count_per_step": c / psteps,
                             "ms_per_step": per_step_ms(us)}
                            for nm, (c, us) in top]},
    }
    dev_table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=25)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"profile_moe_{args.graph}" \
            + ("_bf16" if args.compute_dtype else "")
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(report, f, indent=1)
        with open(os.path.join(args.out, name + "_ops.txt"), "w") as f:
            f.write(dev_table + "\n\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                              row_limit=30))
    print(json.dumps(report, indent=1))
    if not kern:
        print("profile_moe: the profiler recorded no device time")
    ex.close()


if __name__ == "__main__":
    main()
