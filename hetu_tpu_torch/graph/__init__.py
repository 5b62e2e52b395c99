"""Define-then-run graph core of the port."""
from .node import (Op, PlaceholderOp, Variable, placeholder_op, LowerCtx,
                   topo_sort)
from .executor import lower_forward
