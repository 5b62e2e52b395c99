"""Layers of the ported paths."""
from .base import BaseLayer
from .core import Linear, LayerNorm, Embedding, DropOut
from .attention import MultiHeadAttention
