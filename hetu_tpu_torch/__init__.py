"""hetu_tpu_torch — the PyTorch/CUDA port of ``hetu_tpu``.

The port keeps ``hetu_tpu``'s module layout, names and define-then-run
graph API (``placeholder_op``, ``Variable``, the ``*_op`` constructors,
the same ``op_type`` strings).  Ops lower to plain PyTorch; every TPU
kernel on a ported path is a hand-written kernel for the H100
(``csrc/``).  This slice serves GPT-2 greedy decode:
``gpt2_decode_graph`` → ``DecodeEngine`` → ``DecodeRouter``, with decode
attention in the CUDA flash kernel.

It imports neither ``jax`` nor ``hetu_tpu``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
from . import initializers, metrics, ops
from .context import cpu, gpu, resolve_device
from .graph import (LowerCtx, Op, PlaceholderOp, Variable, lower_forward,
                    placeholder_op, topo_sort)
from .layers import LayerNorm, Linear
from .models import GPT2Config, gpt2_decode_graph
from .serving import (DecodeEngine, DecodeRouter, DecodeStream,
                      InferenceExecutor, ServeRejected, default_buckets)
from .weights import params_from_named_arrays
