"""Optimizers (twin of ``hetu_tpu/optim/optimizer.py``).

Each optimizer is a pure ``apply(params, grads, state, lr)`` on dicts of
tensors that returns new dicts; the executor runs it under
``torch.no_grad()`` after the backward.  ``OptimizerOp`` keeps the
graph-level contract: ``opt.minimize(loss)`` returns a fetchable node.

The arithmetic follows the JAX package line for line, in float32: Adam's
step ``t`` is an int32 tensor and its bias corrections are
``1 - beta ** float32(t)``; ``l2reg`` adds ``l2reg * p`` to the gradient;
LAMB scales the update by the trust ratio ||p|| / ||update||, whose
norms under ZeRO sum over the ranks' rows of the parameter.

The learning rate is a number or an ``LRScheduler``
(``optim/lr_scheduler.py``).  The executor asks ``step_lr(step)`` for
the step's float32 rate before every update, so a schedule advances with
the step counter and an ``opt.lr = x`` reassignment between steps is
honored on the next one (the JAX package's ``_check_lr_objs``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.gradients import gradients
from ..graph.node import Op, PlaceholderOp, topo_sort
from ..parallel.collectives import all_reduce


class OptimizerOp(Op):
    """Graph node that applies ``optimizer`` to its GradientOp inputs."""

    op_type = "OptimizerUpdate"

    def __init__(self, grad_nodes, optimizer, name=None):
        super().__init__(grad_nodes, name=name)
        self.optimizer = optimizer
        self.params = [g.wrt for g in grad_nodes]

    def lower(self, ctx, *vals):  # resolved specially by the executor
        raise RuntimeError("OptimizerOp must be resolved by the executor")


class Optimizer:
    def __init__(self, learning_rate, l2reg=0.0):
        self.lr = learning_rate  # a number or an LRScheduler
        self.l2reg = l2reg

    # -- the learning rate ------------------------------------------------
    def host_lr(self, step):
        """The float64 rate of ``step`` (logging, checkpoint metadata)."""
        from .lr_scheduler import LRScheduler
        if isinstance(self.lr, LRScheduler):
            return float(self.lr.get(step))
        return float(self.lr)

    def step_lr(self, step):
        """The float32 rate the update of ``step`` uses: a schedule's
        ``traced`` value, or, for a data-dependent schedule, its ``get``
        rounded to float32 (the JAX package's traced and host paths)."""
        from .lr_scheduler import LRScheduler
        if isinstance(self.lr, LRScheduler):
            v = self.lr.traced(step)
            return np.float32(self.lr.get(step) if v is None else v)
        return np.float32(float(self.lr))

    def on_step(self, step):
        """Called with the new step counter after every training step."""
        from .lr_scheduler import LRScheduler
        if isinstance(self.lr, LRScheduler):
            self.lr.on_step(step)

    # -- graph API --------------------------------------------------------
    def minimize(self, loss, var_list=None):
        if var_list is None:
            var_list = [n for n in topo_sort([loss])
                        if isinstance(n, PlaceholderOp) and n.is_variable
                        and n.trainable]
        return OptimizerOp(gradients(loss, var_list), self)

    # -- pure update ------------------------------------------------------
    def init_state(self, params):
        return {}

    def _reg(self, p, g):
        return g + self.l2reg * p if self.l2reg else g

    def apply(self, params, grads, state, lr):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def apply(self, params, grads, state, lr):
        new = {k: p - lr * self._reg(p, grads[k]) if k in grads else p
               for k, p in params.items()}
        return new, state


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, nesterov=False,
                 l2reg=0.0):
        super().__init__(learning_rate, l2reg)
        self.momentum = momentum
        self.nesterov = nesterov

    def init_state(self, params):
        return {"v": {k: torch.zeros_like(p) for k, p in params.items()}}

    def apply(self, params, grads, state, lr):
        new_p, new_v = {}, {}
        for k, p in params.items():
            if k not in grads:
                new_p[k] = p
                new_v[k] = state["v"][k]
                continue
            g = self._reg(p, grads[k])
            v = self.momentum * state["v"][k] - lr * g
            new_v[k] = v
            new_p[k] = p + (self.momentum * v - lr * g if self.nesterov
                            else v)
        return new_p, {"v": new_v}


class AdaGradOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, initial_accumulator_value=0.0,
                 eps=1e-7, l2reg=0.0):
        super().__init__(learning_rate, l2reg)
        self.init_acc = initial_accumulator_value
        self.eps = eps

    def init_state(self, params):
        return {"acc": {k: torch.full_like(p, self.init_acc)
                        for k, p in params.items()}}

    def apply(self, params, grads, state, lr):
        new_p, new_acc = {}, {}
        for k, p in params.items():
            if k not in grads:
                new_p[k], new_acc[k] = p, state["acc"][k]
                continue
            g = self._reg(p, grads[k])
            acc = state["acc"][k] + g * g
            new_acc[k] = acc
            new_p[k] = p - lr * g / (torch.sqrt(acc) + self.eps)
        return new_p, {"acc": new_acc}


class AdamOptimizer(Optimizer):
    weight_decay = 0.0
    lamb = False

    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, l2reg=0.0, amsgrad=False):
        super().__init__(learning_rate, l2reg)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.amsgrad = amsgrad

    def init_state(self, params):
        dev = next(iter(params.values())).device if params else None
        st = {"m": {k: torch.zeros_like(p) for k, p in params.items()},
              "v": {k: torch.zeros_like(p) for k, p in params.items()},
              "t": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.amsgrad:
            st["vmax"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return st

    def apply(self, params, grads, state, lr, group=None):
        """``group``: the process group over which each of ``params`` is
        split by rows (the ZeRO update, ``parallel/zero.py``): LAMB's two
        squared norms are then summed over it before the trust ratio."""
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1 - self.beta1 ** tf
        bc2 = 1 - self.beta2 ** tf
        new_p, new_m, new_v, new_vmax = {}, {}, {}, {}
        for k, p in params.items():
            if k not in grads:
                new_p[k], new_m[k], new_v[k] = p, state["m"][k], state["v"][k]
                if self.amsgrad:
                    new_vmax[k] = state["vmax"][k]
                continue
            g = self._reg(p, grads[k])
            m = self.beta1 * state["m"][k] + (1 - self.beta1) * g
            v = self.beta2 * state["v"][k] + (1 - self.beta2) * g * g
            new_m[k], new_v[k] = m, v
            vhat = v / bc2
            if self.amsgrad:
                vhat = torch.maximum(state["vmax"][k], vhat)
                new_vmax[k] = vhat
            upd = (m / bc1) / (torch.sqrt(vhat) + self.epsilon) \
                + self.weight_decay * p
            if self.lamb:
                sq = torch.stack([torch.sum(p * p), torch.sum(upd * upd)])
                if group is not None:
                    sq = all_reduce(sq, group)
                wn, un = torch.sqrt(sq).unbind()
                trust = torch.where((wn > 0) & (un > 0), wn / un,
                                    torch.ones_like(wn))
                upd = trust * upd
            new_p[k] = p - lr * upd
        st = {"m": new_m, "v": new_v, "t": t}
        if self.amsgrad:
            st["vmax"] = new_vmax
        return new_p, st


class AdamWOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, weight_decay=0.0, l2reg=0.0):
        super().__init__(learning_rate, beta1, beta2, epsilon, l2reg)
        self.weight_decay = weight_decay


class LambOptimizer(AdamWOptimizer):
    lamb = True
