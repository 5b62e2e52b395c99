"""Layers of the ported paths."""
from .base import BaseLayer
from .core import Linear, LayerNorm, RMSNorm, Embedding, DropOut
from .attention import MultiHeadAttention
from .gates import (TopKGate, TopKGateSparse, HashGate, KTop1Gate, SAMGate,
                    BalanceAssignmentGate)
from .moe_layer import Expert, MoELayer, SparseMoELayer, BalancedMoELayer
