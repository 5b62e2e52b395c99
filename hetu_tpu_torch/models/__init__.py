"""Models of the port (GPT-2 decode in this slice)."""
from .gpt2 import GPT2Config, gpt2_decode_graph
