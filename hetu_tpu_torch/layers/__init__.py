"""Layers of the ported paths."""
from .base import BaseLayer
from .core import Linear, LayerNorm, Embedding, DropOut
from .attention import MultiHeadAttention
from .gates import TopKGate, TopKGateSparse
from .moe_layer import Expert, MoELayer, SparseMoELayer
