"""Workload -> lattice lowerings (the JAX package's
`lattice/adapters.py`).

The three host-side consistency checkers (`workloads.causal`,
`workloads.long_fork`, `workloads.monotonic`) each encode one slice of
the weak-consistency lattice as a bespoke host scan.  The lattice
engine subsumes all three, so the workload checkers become adapters:
lower the workload's history into a txn history whose dependency
planes carry the same information, classify it with
`lattice.checker.LatticeChecker`, and run the original host logic
alongside as the oracle (a disagreement shows in the verdict's
`oracle-agrees`).

Lowerings:

  * causal register -> list-append on one key: the register's counter
    semantics mean value v == the append log prefix [1..v], so a
    stale read becomes a read-your-writes / monotonic-reads cycle
    and a future read a writes-follow-reads cycle.
  * long fork -> identity: the workload's ops already carry micro-op
    lists; the nil-first rw augmentation (`planes._nil_read_rw`)
    supplies the anti-dependencies the reader-only shape needs and
    the wr.(rw.wr)* automaton finds the fork.
  * monotonic -> list-append: inserts (ordered by value: the shared
    monotonic source is one session) append to one log; the final
    read observes the log in DB-timestamp order.  A ts/value
    inversion becomes a monotonic-writes cycle, a duplicate value a
    duplicate-elements flag.

Each adapter takes the LatticeChecker's keywords (device=, algorithm=,
mesh_threshold=)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from jepsen_tpu_torch.checker import Checker, merge_valid
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.lattice import checker as lattice_checker

_KEY = "x"


# ---------------------------------------------------------------------------
# lowerings
# ---------------------------------------------------------------------------

def lower_causal(history) -> list:
    """Causal-register ops -> list-append txn history.  value v reads
    lower to the prefix [1..v] (counter semantics); 0/None reads to
    the None (unknown) observation so the initial state never reads
    as garbage."""
    out = []
    for o in History(history):
        if o.f not in ("write", "read", "read-init"):
            continue
        v = o.value
        if o.f == "write":
            mops = [["append", _KEY, v]]
        elif o.is_invoke or v in (0, None):
            mops = [["r", _KEY, None]]
        else:
            mops = [["r", _KEY, list(range(1, int(v) + 1))]]
        out.append({"type": o.type, "process": o.process,
                    "f": "txn", "value": mops})
    return out


def lower_long_fork(history) -> list:
    """Long-fork ops already carry micro-op lists; normalize f to
    "txn" and pass the mops through.  Legacy long-fork histories are
    often reader-only (the writes happened off-history), so any read
    observation naming no in-history writer gets a synthetic committed
    writer txn on a fresh session — without it the register inference
    would condemn those reads as garbage (G1a) instead of letting the
    wr/nil-first-rw alternation expose the fork."""
    hist = list(History(history))
    written = set()
    for o in hist:
        if o.is_invoke or not isinstance(o.value, (list, tuple)):
            continue
        for m in o.value:
            if m[0] == "w":
                written.add((m[1], m[2]))
    out = []
    proc = 10 ** 9          # fresh sessions: no so edges to real procs
    for o in hist:
        if o.is_ok and isinstance(o.value, (list, tuple)):
            for m in o.value:
                if (m[0] == "r" and m[2] is not None
                        and (m[1], m[2]) not in written):
                    written.add((m[1], m[2]))
                    mops = [["w", m[1], m[2]]]
                    out.append({"type": "invoke", "process": proc,
                                "f": "txn", "value": mops})
                    out.append({"type": "ok", "process": proc,
                                "f": "txn", "value": mops})
                    proc += 1
    # emit a fresh invoke/completion pair per completion: legacy unit
    # histories invoke reads with value None, so passing raw invokes
    # through would leave the ok ops unpaired (and dropped)
    for o in hist:
        if o.is_invoke or not isinstance(o.value, (list, tuple)):
            continue
        mops = [list(m) for m in o.value]
        out.append({"type": "invoke", "process": o.process,
                    "f": "txn", "value": mops})
        out.append({"type": o.type, "process": o.process,
                    "f": "txn", "value": mops})
    return out


def lower_monotonic(history) -> Optional[list]:
    """Monotonic rows ([val, ts, ...] of the LAST read) -> list-append:
    one append txn per row in val order on session 0 (the shared
    monotonic source is one logical session), one read txn observing
    the vals in ts order.  None when the history holds no read (the
    legacy checker's `unknown`)."""
    rows = None
    for o in History(history):
        if o.is_ok and o.f == "read" and o.value is not None:
            rows = o.value          # last read wins (legacy rule)
    if rows is None:
        return None
    out = []
    vals = [int(r[0]) for r in rows]
    for v in sorted(vals):
        mops = [["append", _KEY, v]]
        out.append({"type": "invoke", "process": 0, "f": "txn",
                    "value": mops})
        out.append({"type": "ok", "process": 0, "f": "txn",
                    "value": mops})
    ts = np.asarray([r[1] for r in rows], np.int64)
    order = np.argsort(ts, kind="stable")
    observed = [vals[i] for i in order]
    read = [["r", _KEY, observed]]
    out.append({"type": "invoke", "process": 1, "f": "txn",
                "value": [["r", _KEY, None]]})
    out.append({"type": "ok", "process": 1, "f": "txn",
                "value": read})
    return out


# ---------------------------------------------------------------------------
# adapter checkers: lattice primary, legacy host logic as pinned oracle
# ---------------------------------------------------------------------------

def _merge(lattice_v: dict, legacy_v: dict) -> dict:
    """One verdict: validity merges through the checker lattice (a
    disagreement can only make the verdict STRICTER), the lattice
    engine supplies classes/witnesses/weakest-violated, the legacy
    oracle rides along in full under "oracle"."""
    out = {
        "valid?": merge_valid(
            [lattice_v["valid?"], legacy_v.get("valid?")]),
        "anomaly-types": lattice_v["anomaly-types"],
        "anomalies": lattice_v["anomalies"],
        "weakest-violated": lattice_v["weakest-violated"],
        "not": lattice_v["not"],
        "engine": lattice_v["engine"],
        "txn-count": lattice_v["txn-count"],
        "oracle": legacy_v,
        "oracle-agrees": (
            legacy_v.get("valid?") == lattice_v["valid?"]),
    }
    if "dispatch" in lattice_v:
        out["dispatch"] = lattice_v["dispatch"]
    return out


class CausalLatticeChecker(Checker):
    """workloads.causal check(), lattice-backed."""

    def __init__(self, model=None, **kw):
        from jepsen_tpu_torch.workloads import causal
        self.oracle = causal.CausalChecker(model)
        self.sub = lattice_checker.LatticeChecker(
            workload="list-append", **kw)

    def check(self, test, history, opts=None):
        legacy = self.oracle.check(test, history, opts)
        v = self.sub.check(test, lower_causal(history), opts)
        out = _merge(v, legacy)
        # the informational fields the legacy verdict always carried
        for k in ("error", "model"):
            if k in legacy:
                out[k] = legacy[k]
        return out


class LongForkLatticeChecker(Checker):
    """workloads.long_fork checker(n), lattice-backed."""

    def __init__(self, n: int, **kw):
        from jepsen_tpu_torch.workloads import long_fork
        self.n = n
        self.oracle = long_fork.LongForkChecker(n)
        self.sub = lattice_checker.LatticeChecker(
            workload="rw-register", **kw)

    def check(self, test, history, opts=None):
        legacy = self.oracle.check(test, history, opts)
        if legacy.get("valid?") == "unknown":
            # illegal-history shapes (multi-writes, ragged groups):
            # the lowering's preconditions fail too — pass through
            return dict(legacy, engine="legacy-host")
        v = self.sub.check(test, lower_long_fork(history), opts)
        out = _merge(v, legacy)
        for k in ("reads-count", "forks"):
            if k in legacy:
                out[k] = legacy[k]
        return out


class MonotonicLatticeChecker(Checker):
    """workloads.monotonic checker(), lattice-backed."""

    def __init__(self, **kw):
        from jepsen_tpu_torch.workloads import monotonic
        self.oracle = monotonic.MonotonicChecker()
        self.sub = lattice_checker.LatticeChecker(
            workload="list-append", **kw)

    def check(self, test, history, opts=None):
        legacy = self.oracle.check(test, history, opts)
        lowered = lower_monotonic(history)
        if lowered is None:
            return dict(legacy, engine="legacy-host")
        v = self.sub.check(test, lowered, opts)
        out = _merge(v, legacy)
        # the informational fields the legacy verdict always carried
        for k in ("count", "duplicates", "skipped", "errors"):
            if k in legacy:
                out[k] = legacy[k]
        return out
