"""Micro-operation helpers for transactional workloads (the JAX
package's `txn.py`, after jepsen's `txn/micro_op.clj`).

A micro-op is a 3-element sequence [f, k, v] with f in {"r", "w",
"append"}; a transaction is a list of micro-ops carried in an op's
value.  "append" is the list-append workload's write: it appends a
unique element to the list at key k, and a read observes the whole
list, which is what makes version orders recoverable from
observations.

"rp" is the predicate read: ["rp", pred, observed], where pred is a
predicate descriptor (canonically ["keys", [k, ...]], the explicit
match set the workload queried) and observed maps each matched key to
the version the read saw ({} on invoke)."""

from __future__ import annotations


def f(mop):
    return mop[0]


def key(mop):
    return mop[1]


def value(mop):
    return mop[2]


def is_read(mop) -> bool:
    return f(mop) in ("r", "read")


def is_write(mop) -> bool:
    return f(mop) in ("w", "write")


def is_append(mop) -> bool:
    return f(mop) == "append"


def is_predicate_read(mop) -> bool:
    return f(mop) == "rp"


def predicate_keys(mop) -> tuple:
    """The explicit match set of a ["keys", [...]] predicate read, or
    () when the descriptor is opaque (no phantom evidence derivable)."""
    pred = key(mop)
    if (isinstance(pred, (list, tuple)) and len(pred) == 2
            and pred[0] == "keys"
            and isinstance(pred[1], (list, tuple))):
        return tuple(pred[1])
    return ()


def is_op(mop) -> bool:
    return (isinstance(mop, (list, tuple)) and len(mop) == 3
            and f(mop) in ("r", "w", "read", "write", "append", "rp"))
