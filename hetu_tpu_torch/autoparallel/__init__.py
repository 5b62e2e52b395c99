"""Auto-parallel planning: only the matmul pricing of the cost model is
ported (``cost_model.MATMUL_OPS`` / ``matmul_flops``), which
``remat='auto'`` prices its segments with.  The strategy search stays in
the JAX package (ROADMAP A11)."""
from .cost_model import MATMUL_OPS, matmul_flops

__all__ = ["MATMUL_OPS", "matmul_flops"]
