"""Serving admission errors (the ``ServeRejected`` part of
``hetu_tpu/serving/router.py``; the request-level ``ServingRouter`` is
not ported yet)."""
from __future__ import annotations

from ..metrics import record_serve


class ServeRejected(RuntimeError):
    """Explicit backpressure: the request was NOT admitted — shed load
    upstream and retry later.  Carries a structured ``reason`` from the
    closed taxonomy :attr:`REASONS`; construction counts it into the
    ``serve`` family as ``rejected:<reason>``."""

    REASONS = ("queue_full", "over_max_len", "deadline", "draining")

    def __init__(self, reason, detail=""):
        reason = str(reason)
        if reason not in self.REASONS:
            raise ValueError(f"unknown ServeRejected reason {reason!r} — "
                             f"taxonomy is {list(self.REASONS)}")
        self.reason = reason
        record_serve(f"rejected:{reason}")
        super().__init__(f"{reason}: {detail}" if detail else reason)
