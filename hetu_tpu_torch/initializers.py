"""Initializers of the ported graphs (subset of
``hetu_tpu/initializers.py``).

Inits draw from an explicit ``torch.Generator`` on the CPU, so a value
depends only on the generator's seed — never on the device the executor
later places it on.  The executor seeds one generator per variable from
``(seed, topo index)`` (:func:`variable_generator`).  The numbers differ
from the JAX package's ``jax.random`` draws for the same seed; parity
tests carry weights across by name instead.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph.node import Variable


def variable_generator(seed, index):
    """The CPU generator for the ``index``-th variable under ``seed``."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


class BaseInit:
    def __call__(self, shape, name=None, trainable=True, ctx=None,
                 is_embed=False):
        """Variable factory — layers call ``initializer(shape=..., name=...)``."""
        return Variable(name or "var", initializer=self, trainable=trainable,
                        shape=shape, is_embed=is_embed)

    def materialize(self, shape, generator):
        """A float32 CPU tensor of ``shape``, deterministic in ``generator``."""
        return self.init(torch.empty(tuple(shape), dtype=torch.float32),
                         generator)

    def init(self, out, generator):
        raise NotImplementedError


class ConstantInit(BaseInit):
    def __init__(self, constant=0.0):
        self.constant = constant

    def init(self, out, generator):
        return out.fill_(self.constant)


class ZerosInit(ConstantInit):
    def __init__(self):
        super().__init__(0.0)


class OnesInit(ConstantInit):
    def __init__(self):
        super().__init__(1.0)


class NormalInit(BaseInit):
    """Normal(mean, stddev), as ``mean + stddev * jax.random.normal``."""

    def __init__(self, mean=0.0, stddev=1.0):
        self.mean, self.stddev = mean, stddev

    def init(self, out, generator):
        return torch.nn.init.normal_(out, self.mean, self.stddev,
                                     generator=generator)


class TruncatedNormalInit(BaseInit):
    """Normal(mean, stddev) truncated at two standard deviations, as
    ``jax.random.truncated_normal(key, -2, 2)`` scaled."""

    def __init__(self, mean=0.0, stddev=1.0):
        self.mean, self.stddev = mean, stddev

    def init(self, out, generator):
        return torch.nn.init.trunc_normal_(
            out, self.mean, self.stddev, self.mean - 2.0 * self.stddev,
            self.mean + 2.0 * self.stddev, generator=generator)


def _fans(shape, mode):
    shape = tuple(shape)
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) >= 3:  # conv OIHW
        rf = int(np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * rf, shape[0] * rf
    else:
        fan_in = fan_out = int(np.prod(shape)) if shape else 1
    return {"fan_in": fan_in, "fan_out": fan_out,
            "avg": (fan_in + fan_out) / 2.0}[mode]


class GeneralXavierUniformInit(BaseInit):
    def __init__(self, gain=1.0, mode="avg"):
        self.gain, self.mode = gain, mode

    def init(self, out, generator):
        limit = float(np.sqrt(3.0 * self.gain / _fans(out.shape, self.mode)))
        return torch.nn.init.uniform_(out, -limit, limit, generator=generator)


class XavierUniformInit(GeneralXavierUniformInit):
    def __init__(self):
        super().__init__(1.0, "avg")


class HeUniformInit(GeneralXavierUniformInit):
    def __init__(self):
        super().__init__(2.0, "fan_in")


class XavierNormalInit(BaseInit):
    """Normal(0, sqrt(1 / fan_avg)), as the JAX package's
    ``XavierNormalInit`` (gain 1, mode "avg")."""

    def init(self, out, generator):
        std = float(np.sqrt(1.0 / _fans(out.shape, "avg")))
        return torch.nn.init.normal_(out, 0.0, std, generator=generator)


# -- Variable factories -----------------------------------------------------

def zeros(shape, name=None, trainable=True, ctx=None):
    return ZerosInit()(shape, name=name, trainable=trainable)


def ones(shape, name=None, trainable=True, ctx=None):
    return OnesInit()(shape, name=name, trainable=trainable)


def xavier_uniform(shape, name=None, trainable=True, ctx=None):
    return XavierUniformInit()(shape, name=name, trainable=trainable)


def he_uniform(shape, name=None, trainable=True, ctx=None):
    return HeUniformInit()(shape, name=name, trainable=trainable)


def truncated_normal(shape, mean=0.0, stddev=1.0, name=None, trainable=True,
                     ctx=None):
    return TruncatedNormalInit(mean, stddev)(shape, name=name,
                                             trainable=trainable)


# -- Gen* closures ----------------------------------------------------------

def GenZeros():
    return ZerosInit()


def GenNormal(mean=0.0, stddev=1.0):
    return NormalInit(mean, stddev)


def GenTruncatedNormal(mean=0.0, stddev=1.0):
    return TruncatedNormalInit(mean, stddev)


def GenXavierUniform():
    return XavierUniformInit()


def GenXavierNormal():
    return XavierNormalInit()
