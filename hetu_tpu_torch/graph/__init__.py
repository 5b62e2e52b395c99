"""Define-then-run graph core of the port."""
from .node import (Op, PlaceholderOp, Variable, placeholder_op, LowerCtx,
                   topo_sort)
from .gradients import GradientOp, gradients
from .executor import Executor, SubExecutor, lower_forward
