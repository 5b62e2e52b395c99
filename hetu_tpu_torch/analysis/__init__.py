"""Static graph analysis (twin of ``hetu_tpu/analysis``): total shape and
dtype inference on meta tensors, and the lint rules.

``lint(fetches, feeds=...)`` checks a define-then-run graph before
anything runs: :func:`infer_graph` gives every node a static ``(shape,
dtype)`` by evaluating each op's own lowering on meta tensors, and the
rules of :data:`RULES` turn graph bugs into diagnostics that name the
offending node and the user line that created it.
``Executor(validate='warn'|'error'|'off')`` (default ``'warn'``) runs the
same rules at construction and checks fed shapes once per run plan.
"""
from .shapes import GraphShapes, abstract_infer_shape, infer_graph
from .lint import (RULES, Diagnostic, GraphInfo, GraphValidationError,
                   LintReport, lint, rule)

__all__ = ["GraphShapes", "abstract_infer_shape", "infer_graph",
           "RULES", "Diagnostic", "GraphInfo", "GraphValidationError",
           "LintReport", "lint", "rule"]
