"""The flap-damping gate of the elastic plane (the ``FlapDamper`` of
``hetu_tpu/parallel/elastic.py``), which the serving fleet's SLO
autoscaler steers with.  The rest of the elastic plane (world resizes)
is not ported."""
from __future__ import annotations


class FlapDamper:
    """Consecutive-poll grace gate.

    A keyed condition must hold for ``grace`` CONSECUTIVE polls before
    :meth:`ready` returns True; a single False poll resets the streak.
    The autoscaler keys it by resize direction, so a noisy p99 does not
    thrash the replica set.  Poll-driven, single caller: no lock."""

    def __init__(self, grace):
        self.grace = max(1, int(grace))
        self._seen = {}

    def ready(self, key, ok):
        """Record one poll of ``key``'s condition; True once it has held
        ``grace`` consecutive polls (and while it keeps holding)."""
        if not ok:
            self._seen.pop(key, None)
            return False
        n = self._seen.get(key, 0) + 1
        self._seen[key] = n
        return n >= self.grace

    def streak(self, key):
        """Current consecutive-ok count for ``key``."""
        return self._seen.get(key, 0)

    def clear(self, key=None):
        """Reset one key's streak (or every streak)."""
        if key is None:
            self._seen.clear()
        else:
            self._seen.pop(key, None)


__all__ = ["FlapDamper"]
