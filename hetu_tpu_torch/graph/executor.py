"""Graph evaluation (the forward half of ``hetu_tpu/graph/executor.py``).

``lower_forward`` evaluates a topologically sorted subgraph eagerly:
each node's ``lower`` runs on its inputs' tensors as soon as they exist.
Remat and sharding have no counterpart in this slice.
"""
from __future__ import annotations

from .node import PlaceholderOp


def lower_forward(topo, ctx, resolve_leaf):
    """Evaluate every node of ``topo`` into an environment
    ``{node: tensor}``; placeholders resolve through ``resolve_leaf(node)``."""
    env = {}
    for node in topo:
        if isinstance(node, PlaceholderOp):
            env[node] = resolve_leaf(node)
        else:
            env[node] = node.lower(ctx, *[env[i] for i in node.inputs])
    return env
