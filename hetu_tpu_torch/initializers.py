"""Initializers (twin of ``hetu_tpu/initializers.py``: the init classes,
the Variable factories and the ``Gen*`` closures).

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


class UniformInit(BaseInit):
    """Uniform(low, high), as ``jax.random.uniform(minval, maxval)``."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def init(self, out, generator):
        return torch.nn.init.uniform_(out, self.low, self.high,
                                      generator=generator)


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


class OrthogonalInit(BaseInit):
    """Orthogonal init: the Q of a normal matrix's QR, its columns' signs
    set by R's diagonal, as the JAX package's."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def init(self, out, generator):
        rows = out.shape[0]
        cols = int(np.prod(out.shape[1:]))
        a = torch.randn(max(rows, cols), min(rows, cols),
                        generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return out.copy_((self.gain * q[:rows, :cols]).reshape(out.shape))


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
    """Uniform(-limit, limit), limit = sqrt(3 * gain / fan(mode))."""

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


class LecunUniformInit(GeneralXavierUniformInit):
    def __init__(self):
        super().__init__(1.0, "fan_in")


class GeneralXavierNormalInit(BaseInit):
    """Normal(0, sqrt(gain / fan(mode)))."""

    def __init__(self, gain=1.0, mode="avg"):
        self.gain, self.mode = gain, mode

    def init(self, out, generator):
        std = float(np.sqrt(self.gain / _fans(out.shape, self.mode)))
        return torch.nn.init.normal_(out, 0.0, std, generator=generator)


class XavierNormalInit(GeneralXavierNormalInit):
    def __init__(self):
        super().__init__(1.0, "avg")


class HeNormalInit(GeneralXavierNormalInit):
    def __init__(self):
        super().__init__(2.0, "fan_in")


class LecunNormalInit(GeneralXavierNormalInit):
    def __init__(self):
        super().__init__(1.0, "fan_in")


# -- Variable factories -----------------------------------------------------

def _make(init, shape, name, trainable):
    return init(shape, name=name, trainable=trainable)


def orthogonal(shape, gain=1.0, name=None, trainable=True, ctx=None):
    return _make(OrthogonalInit(gain), shape, name, trainable)


def zeros(shape, name=None, trainable=True, ctx=None):
    return _make(ZerosInit(), shape, name, trainable)


def ones(shape, name=None, trainable=True, ctx=None):
    return _make(OnesInit(), shape, name, trainable)


def constant(shape, fill_value=0.0, name=None, trainable=True, ctx=None):
    return _make(ConstantInit(fill_value), shape, name, trainable)


def truncated_normal(shape, mean=0.0, stddev=1.0, name=None, trainable=True,
                     ctx=None):
    return _make(TruncatedNormalInit(mean, stddev), shape, name, trainable)


def random_normal(shape, mean=0.0, stddev=1.0, name=None, trainable=True,
                  ctx=None):
    return _make(NormalInit(mean, stddev), shape, name, trainable)


def random_uniform(shape, minval=-1.0, maxval=1.0, name=None, trainable=True,
                   ctx=None):
    return _make(UniformInit(minval, maxval), shape, name, trainable)


def general_xavier_normal(shape, gain, mode, name=None, trainable=True,
                          ctx=None):
    return _make(GeneralXavierNormalInit(gain, mode), shape, name, trainable)


def general_xavier_uniform(shape, gain, mode, name=None, trainable=True,
                           ctx=None):
    return _make(GeneralXavierUniformInit(gain, mode), shape, name, trainable)


def xavier_normal(shape, name=None, trainable=True, ctx=None):
    return _make(XavierNormalInit(), shape, name, trainable)


def xavier_uniform(shape, name=None, trainable=True, ctx=None):
    return _make(XavierUniformInit(), shape, name, trainable)


def he_normal(shape, name=None, trainable=True, ctx=None):
    return _make(HeNormalInit(), shape, name, trainable)


def he_uniform(shape, name=None, trainable=True, ctx=None):
    return _make(HeUniformInit(), shape, name, trainable)


def lecun_normal(shape, name=None, trainable=True, ctx=None):
    return _make(LecunNormalInit(), shape, name, trainable)


def lecun_uniform(shape, name=None, trainable=True, ctx=None):
    return _make(LecunUniformInit(), shape, name, trainable)


# -- Gen* closures ----------------------------------------------------------

def GenZeros():
    return ZerosInit()


def GenOnes():
    return OnesInit()


def GenConstant(fill_value=0.0):
    return ConstantInit(fill_value)


def GenTruncatedNormal(mean=0.0, stddev=1.0):
    return TruncatedNormalInit(mean, stddev)


def GenNormal(mean=0.0, stddev=1.0):
    return NormalInit(mean, stddev)


def GenUniform(minval=-1.0, maxval=1.0):
    return UniformInit(minval, maxval)


def GenGeneralXavierNormal(gain, mode):
    return GeneralXavierNormalInit(gain, mode)


def GenGeneralXavierUniform(gain, mode):
    return GeneralXavierUniformInit(gain, mode)


def GenXavierNormal():
    return XavierNormalInit()


def GenXavierUniform():
    return XavierUniformInit()


def GenHeNormal():
    return HeNormalInit()


def GenHeUniform():
    return HeUniformInit()


def GenLecunNormal():
    return LecunNormalInit()


def GenLecunUniform():
    return LecunUniformInit()
