"""Optimizers and learning-rate schedules of the port (``hetu_tpu.optim``)."""
from .optimizer import (Optimizer, OptimizerOp, SGDOptimizer,
                        MomentumOptimizer, AdaGradOptimizer, AdamOptimizer,
                        AdamWOptimizer, LambOptimizer)
from .lr_scheduler import (LRScheduler, FixedScheduler, StepScheduler,
                           MultiStepScheduler, ExponentialScheduler,
                           ReduceOnPlateauScheduler, CosineScheduler)
