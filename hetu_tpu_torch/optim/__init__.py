"""Optimizers of the port (``hetu_tpu.optim`` without LR schedulers)."""
from .optimizer import (Optimizer, OptimizerOp, SGDOptimizer,
                        MomentumOptimizer, AdaGradOptimizer, AdamOptimizer,
                        AdamWOptimizer, LambOptimizer)
