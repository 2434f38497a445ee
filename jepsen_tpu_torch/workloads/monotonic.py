"""Monotonic-inserts checker (the JAX package's `workloads/monotonic.py`,
after `cockroachdb/src/jepsen/cockroach/monotonic.clj:1-80`): clients
insert strictly increasing values, each stamped with the database's own
transaction timestamp; if the DB's timestamp order ever disagrees with
the insertion order, causality ran backwards.

    {f: "add",  value: None}       -> ok value [val, ts, node-idx]
    {f: "read", value: None}       -> ok value [[val, ts, node-idx], ...]

The checker sorts the last read's rows by ts and verifies vals are
strictly increasing, reporting every inversion pair plus duplicate
values; skipped values are reported informationally (failed adds
legitimately leave gaps).  Only the checker is ported."""

from __future__ import annotations

import numpy as np

from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.history import History


class MonotonicChecker(Checker):
    """Timestamp order must match value order (monotonic.clj checker)."""

    def check(self, test, history, opts=None):
        rows = None
        for o in History(history):
            if o.is_ok and o.f == "read" and o.value is not None:
                rows = o.value          # last read wins
        if rows is None:
            return {"valid?": "unknown", "error": "no reads"}

        arr = np.asarray([[r[0], r[1]] for r in rows], dtype=np.int64
                         ) if rows else np.zeros((0, 2), np.int64)
        if len(arr) == 0:
            return {"valid?": True, "count": 0, "errors": []}

        order = np.argsort(arr[:, 1], kind="stable")
        vals = arr[order, 0]
        diffs = np.diff(vals)
        bad = np.nonzero(diffs <= 0)[0]
        errors = [{"prev": [int(arr[order[i], 0]), int(arr[order[i], 1])],
                   "next": [int(arr[order[i + 1], 0]),
                            int(arr[order[i + 1], 1])]}
                  for i in bad]
        dup_vals, counts = np.unique(arr[:, 0], return_counts=True)
        dups = dup_vals[counts > 1].tolist()
        # gaps in the value sequence: informational only (failed adds
        # legitimately skip values)
        sorted_vals = np.unique(arr[:, 0])
        gaps = np.nonzero(np.diff(sorted_vals) > 1)[0]
        skipped = [int(v) for i in gaps
                   for v in range(int(sorted_vals[i]) + 1,
                                  int(sorted_vals[i + 1]))]
        valid = not errors and not dups
        return {"valid?": valid, "count": int(len(arr)),
                "errors": errors, "duplicates": dups,
                "skipped": skipped}


def checker(**kw):
    """Lattice-backed monotonic checker: the timestamped rows lower to
    one list-append session read back in ts order, so a ts/value
    inversion classifies as a `monotonic-writes` cycle;
    `MonotonicChecker` above runs alongside as the oracle.  kw goes to
    the LatticeChecker (device=, algorithm=)."""
    from jepsen_tpu_torch.lattice import adapters
    return adapters.MonotonicLatticeChecker(**kw)
