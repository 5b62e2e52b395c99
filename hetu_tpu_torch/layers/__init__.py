"""Layers of the decode slice."""
from .base import BaseLayer
from .core import Linear, LayerNorm
