"""Learning-rate schedules (twin of ``hetu_tpu/optim/lr_scheduler.py``).

Two evaluations of one schedule, as in the JAX package:

* ``get(step)`` — the float64 host value (logging, checkpoint metadata).
* ``traced(step)`` — the float32 value the training step uses.  The JAX
  package evaluates this expression inside its jitted step, in float32;
  the port has no compiled step and evaluates the same arithmetic on the
  host, op by op, each operand an explicit ``np.float32`` (so numpy's
  promotion rules, which differ between numpy 1 and 2, never widen it),
  with the two rewrites XLA's CPU backend applies to it: a division by a
  constant becomes a product with its float32 reciprocal, and ``a * b +
  c`` is one fused multiply-add.
  The float64 ``get`` is not the same number: Cosine's ``cos`` and
  Exponential's power differ from it in the last bits.  A data-dependent
  schedule (``ReduceOnPlateauScheduler``) returns ``None``, and the step
  takes ``get`` rounded to float32, as the JAX package's host ``lrs``
  input does.

``Optimizer.step_lr`` picks between them; the executor reads it at every
step, so reassigning ``optimizer.lr`` between steps takes effect on the
next one.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def _recip(c):
    """``1 / c`` in float32: XLA rewrites a division by a constant as a
    product with its float32 reciprocal, and the step's value follows."""
    return _F(1) / _F(c)


def _cos32(x):
    """float32 cos, correctly rounded (evaluated in float64).  XLA's own
    float32 cos is an approximation that differs from this by one ulp on
    about 1 % of inputs; the rate then differs by at most one ulp."""
    return _F(np.cos(np.float64(x)))


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as XLA contracts it (the
    float32 product is exact in float64)."""
    return _F(np.float64(a) * np.float64(b) + np.float64(c))


class LRScheduler:
    def get(self, step: int) -> float:
        raise NotImplementedError

    def traced(self, step):
        """The step's float32 rate, or ``None`` when the schedule is
        data-dependent (then ``get`` is used)."""
        return None

    def on_step(self, step: int):
        pass


class FixedScheduler(LRScheduler):
    def __init__(self, learning_rate):
        self.lr = learning_rate

    def get(self, step):
        return self.lr

    def traced(self, step):
        return _F(self.lr)


class StepScheduler(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1):
        assert step_size > 0
        self.lr, self.step_size, self.gamma = learning_rate, step_size, gamma

    def get(self, step):
        return self.lr * self.gamma ** (step // self.step_size)

    def traced(self, step):
        k = _F(int(step) // self.step_size)
        return _F(self.lr) * _F(self.gamma) ** k


class MultiStepScheduler(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1):
        self.lr = learning_rate
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def get(self, step):
        k = int(np.searchsorted(self.milestones, step, side="right"))
        return self.lr * self.gamma ** k

    def traced(self, step):
        ms = np.asarray(self.milestones, np.int32)
        k = _F(np.searchsorted(ms, np.int32(step), side="right"))
        return _F(self.lr) * _F(self.gamma) ** k


class ExponentialScheduler(LRScheduler):
    def __init__(self, learning_rate, gamma=0.99):
        self.lr, self.gamma = learning_rate, gamma

    def get(self, step):
        return self.lr * self.gamma ** step

    def traced(self, step):
        return _F(self.lr) * _F(self.gamma) ** _F(step)


class ReduceOnPlateauScheduler(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0.0):
        self.lr = learning_rate
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr = cooldown, min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_left = 0

    def _better(self, metric):
        if self.best is None:
            return True
        t = self.threshold
        if self.threshold_mode == "rel":
            bound = self.best * (1 - t) if self.mode == "min" \
                else self.best * (1 + t)
        else:
            bound = self.best - t if self.mode == "min" else self.best + t
        return metric < bound if self.mode == "min" else metric > bound

    def step(self, metric):
        """Called by the user with the monitored metric (a validation
        loss, say)."""
        metric = float(metric)
        if self._better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_left = self.cooldown
                self.num_bad = 0

    def get(self, step):
        return self.lr


class CosineScheduler(LRScheduler):
    """Cosine decay with linear warm-up."""

    def __init__(self, learning_rate, warmup_steps, total_steps,
                 min_ratio=0.0):
        self.lr = learning_rate
        self.warmup = max(1, warmup_steps)
        self.total = total_steps
        self.min_ratio = min_ratio

    def get(self, step):
        if step < self.warmup:
            return self.lr * (step + 1) / self.warmup
        p = min(1.0, (step - self.warmup) / max(1, self.total - self.warmup))
        cos = 0.5 * (1 + np.cos(np.pi * p))
        return self.lr * (self.min_ratio + (1 - self.min_ratio) * cos)

    def traced(self, step):
        s = _F(step)
        if int(step) < self.warmup:
            return _F(self.lr) * (s + _F(1)) * _recip(self.warmup)
        p = np.minimum(_F(1.0), (s - _F(self.warmup))
                       * _recip(max(1, self.total - self.warmup)))
        cos = _F(0.5) * (_F(1) + _cos32(_F(np.pi) * p))
        return _F(self.lr) * _fma(_F(1 - self.min_ratio), cos,
                                  _F(self.min_ratio))


__all__ = ["LRScheduler", "FixedScheduler", "StepScheduler",
           "MultiStepScheduler", "ExponentialScheduler",
           "ReduceOnPlateauScheduler", "CosineScheduler"]
