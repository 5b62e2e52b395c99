"""PS wire-protocol opcode registry (twin of ``hetu_tpu/ps/opcodes.py``).

Every ``OP_*`` constant in :mod:`hetu_tpu_torch.ps.dist_store` registers
here, and the registry ASSERTS value uniqueness at import time — two
opcodes silently sharing a wire value (the classic copy-paste drift when a
new frame type is added on one side of the protocol) fails the import, not
a training run.

It also gives frames a human-readable identity: :func:`op_name` maps a wire
value back to its symbolic name, and :func:`frame_repr` renders a decoded
header for error messages — ``OP_PUSH(table=3, nkeys=128, shard=1)``
instead of ``op 2``.
"""
from __future__ import annotations

#: wire value -> symbolic name (populated by :func:`defop`)
OPCODES = {}
_BY_NAME = {}


def defop(name, value):
    """Register opcode ``name`` with wire ``value``; returns ``value``.

    Raises at import time on a duplicate value or a renamed duplicate —
    the runtime enforcement of the protocol's uniqueness invariant (the
    AST self-lint enforces the same thing without importing).
    """
    value = int(value)
    prev = OPCODES.get(value)
    if prev is not None and prev != name:
        raise AssertionError(
            f"PS opcode value collision: {name} and {prev} both claim "
            f"wire value {value}")
    prev_val = _BY_NAME.get(name)
    if prev_val is not None and prev_val != value:
        raise AssertionError(
            f"PS opcode {name} registered twice with different values "
            f"({prev_val} and {value})")
    OPCODES[value] = name
    _BY_NAME[name] = value
    return value


def op_name(value):
    """Symbolic name of a wire opcode value (unknown values keep the
    number, flagged)."""
    try:
        return OPCODES.get(int(value), f"OP_UNKNOWN({int(value)})")
    except (TypeError, ValueError):
        return f"OP_UNKNOWN({value!r})"


def frame_repr(op, table=None, nkeys=None, shard=None, client=None,
               seq=None):
    """Readable one-line description of a decoded frame header."""
    parts = []
    if table is not None:
        parts.append(f"table={table}")
    if nkeys is not None:
        parts.append(f"nkeys={nkeys}")
    if shard is not None and shard != -1:
        parts.append(f"shard={shard}")
    if client is not None:
        parts.append(f"client={client}")
    if seq is not None:
        parts.append(f"seq={seq}")
    return f"{op_name(op)}({', '.join(parts)})"
