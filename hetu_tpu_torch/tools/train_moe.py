"""MoE transformer-block training with every gate family (the port of
``examples/moe/train_moe.py``; reference parity:
``examples/moe/test_moe_{base,top,hash,ktop1,sam}.py``, one script with a
``--gate`` flag).

One MoE layer of ``--experts`` ``Expert(e, d, 2 d)`` FFNs over ``--tokens``
tokens of width ``--dim`` (``np.random.RandomState(0).randn``; the label of
a token is the argmax of its first 8 features), a ``Linear(d, 8)`` head,
the mean softmax cross-entropy plus 0.01 x the gate's aux loss, and
``AdamOptimizer(1e-3)``, ``Executor(seed=0)``.  The gates, at the JAX
package's capacity factors: ``base`` (``BalanceAssignmentGate`` through
``BalancedMoELayer``), ``top1`` (1.5), ``top2`` (2.0), ``hash``
(``HashGate`` on the token ids ``arange(tokens) % 97``, 2.0), ``ktop1``
(k 2, 2.0), ``sam`` (k 1, 4.0, groups of 2 experts).

Run from the repository root::

    python -m hetu_tpu_torch.tools.train_moe --gate top2            # the card
    python -m hetu_tpu_torch.tools.train_moe --gate sam --device cpu
    python -m hetu_tpu_torch.launcher -n 2 --no-ssh \\
        hetu_tpu_torch/tools/train_moe.py --gate top2 --dp 2 --device cpu

``--dp N``: the ranks of a launched world of N (``launcher.
init_distributed``) train under ``DataParallel``, each fed the global
batch: NCCL with a card a rank where there are N cards, else gloo (the
ranks then share ``cuda:0``, or the CPU).  The capacity gates route over
the global batch (``parallel/batch_axis.py``); ``base`` is refused by
name.  ``--ep > 1`` (expert parallel over an ``ep`` mesh, the JAX
package's ``ModelParallel({"ep": n})``) raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import hetu_tpu_torch as ht  # noqa: E402
from hetu_tpu_torch.layers import (BalanceAssignmentGate,  # noqa: E402
                                   BalancedMoELayer, Expert, HashGate,
                                   KTop1Gate, Linear, MoELayer, SAMGate,
                                   TopKGate)

GATES = ("base", "top1", "top2", "hash", "ktop1", "sam")


class _HashGateAdapter:
    """HashGate routes on token IDS (reference HashGate.py), not embeddings;
    adapt it to the MoELayer gate(x) calling convention."""

    def __init__(self, gate, ids_node):
        self.gate = gate
        self.ids_node = ids_node

    def __call__(self, x):
        return self.gate(self.ids_node)


def build_gate(kind, d, tokens, experts, ids_node=None):
    if kind == "base":  # BASE layer: balanced assignment (auction)
        return BalanceAssignmentGate(d, tokens, experts)
    if kind == "top1":
        return TopKGate(d, tokens, experts, k=1, capacity_factor=1.5)
    if kind == "top2":
        return TopKGate(d, tokens, experts, k=2, capacity_factor=2.0)
    if kind == "hash":
        return _HashGateAdapter(
            HashGate(tokens, experts, capacity_factor=2.0), ids_node)
    if kind == "ktop1":
        return KTop1Gate(d, tokens, experts, k=2, capacity_factor=2.0)
    if kind == "sam":
        return SAMGate(d, tokens, experts, k=1, capacity_factor=4.0,
                       num_local_devices=2)
    raise ValueError(kind)


def build_graph(gate="top2", experts=4, dim=32, tokens=256, hidden=None):
    """The script's graph (``hidden``: the experts' hidden width, 2 x
    ``dim`` by default): ``{"x", "y"}`` (the placeholders), ``"loss"``,
    ``"gate"`` (the gate layer, or the hash gate's adapter) and
    ``"route"`` (the gate's output nodes: the permutation for ``base``,
    the dispatch node for ``hash``, else the gate node's items in
    order)."""
    d, e = dim, experts
    x = ht.placeholder_op("x")
    y = ht.placeholder_op("y")
    ids_node = ht.Variable("token_ids",
                           value=(np.arange(tokens) % 97).astype(np.int32),
                           trainable=False)
    g = build_gate(gate, d, tokens, e, ids_node=ids_node)
    if gate == "base":
        moe = BalancedMoELayer(g, Expert(e, d, hidden or 2 * d), e, tokens,
                               d)
    else:
        moe = MoELayer(g, Expert(e, d, hidden or 2 * d))
    h, aux = moe(x)
    logits = Linear(d, 8, name="head")(h)
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_sparse_op(logits, y), [0])
    if aux is not None:
        loss = loss + aux * 0.01
    kinds = ("KTop1Gate", "SAMGate", "TopKGate", "HashDispatch",
             "BalanceAssignment")
    route = sorted((n for n in ht.topo_sort([loss])
                    if n.op_type in kinds[3:] or n.op_type == "Item"
                    and n.inputs[0].op_type in kinds),
                   key=lambda n: getattr(n, "index", 0))
    return {"x": x, "y": y, "loss": loss, "gate": g, "route": route}


def feeds(g, tokens, dim, seed=0):
    """``{x: (tokens, dim) float32, y: (tokens,) int32}`` of the script's
    seed: x from ``randn``, y the argmax of x's first 8 features."""
    x_np = np.random.RandomState(seed).randn(tokens, dim).astype(np.float32)
    y_np = np.argmax(x_np[:, :8], axis=-1).astype(np.int32)
    return {g["x"]: x_np, g["y"]: y_np}


def build_executor(g, device=None, dp=False, extra=(), **kw):
    """``Executor({"train": [loss, Adam(1e-3) step] + extra}, seed=0)``,
    under ``DataParallel`` when ``dp`` (the caller has opened the
    ``torch.distributed`` world)."""
    opt = ht.optim.AdamOptimizer(1e-3)
    return ht.Executor({"train": [g["loss"], opt.minimize(g["loss"])]
                        + list(extra)},
                       dist_strategy=ht.dist.DataParallel() if dp else None,
                       seed=0, device=device, **kw)


def _open_world(dp, device):
    """This rank's world of ``dp`` and its device: NCCL with a card a
    rank where the host has ``dp`` cards, else gloo."""
    import torch
    import torch.distributed as dist
    from hetu_tpu_torch import launcher
    cuda = device.startswith("cuda")
    own_card = cuda and torch.cuda.device_count() >= dp
    launcher.init_distributed(backend="nccl" if own_card else "gloo")
    if not dist.is_initialized() or dist.get_world_size() != dp:
        raise SystemExit(f"train_moe: --dp {dp} needs a launched world of "
                         f"{dp} ranks (python -m hetu_tpu_torch.launcher "
                         f"-n {dp} --no-ssh ...)")
    if own_card:
        device = f"cuda:{dist.get_rank()}"
        torch.cuda.set_device(dist.get_rank())
    return dist.get_rank(), device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--gate", default="top2", choices=list(GATES))
    p.add_argument("--experts", type=int, default=4)
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel width (mesh 'ep' axis): not ported")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks of a launched world")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--tokens", type=int, default=256)
    args = p.parse_args(argv)
    device = args.device
    if args.ep > 1:
        ht.dist.ModelParallel({"ep": args.ep})      # raises: not ported
    if device.startswith("cuda"):
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = 0
    if args.dp > 1:
        rank, device = _open_world(args.dp, device)
    g = build_graph(args.gate, args.experts, args.dim, args.tokens)
    ex = build_executor(g, device=device, dp=args.dp > 1)
    fd = feeds(g, args.tokens, args.dim)
    for step in range(args.steps):
        out = ex.run("train", feed_dict=fd)
        if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step}: loss={float(out[0].asnumpy()):.4f}")
    ex.close()
    if args.dp > 1:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
