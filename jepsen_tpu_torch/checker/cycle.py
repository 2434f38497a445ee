"""Transactional dependency-cycle checker: serializability anomalies by
SCC on the card (the JAX package's `checker/cycle.py`).

The general formulation (Adya's thesis, later systematized by Elle):
build the direct serialization graph (DSG) of the history and look for
cycles.  The DSG is a boolean adjacency matrix over transactions, and
the cycle search is `ops.cycle.cycles_by_component`: the closure by
rounds of the packed product `elle_pmm`, the SCC labels by the kernel
`cycle_labels`, on `device` (the card by default).

Transactions are ok ops whose value is a list of micro-ops [f, k, v]
with f in {r, w} (`jepsen_tpu_torch.txn`).  Writes must be unique per
key (the standard jepsen workload convention, `tests/long_fork.clj`):
then every read names its writer and the dependency edges are

    wr  k: Tw wrote (k,v), Tr read (k,v)            Tw -> Tr
    ww  k: Tv, Tw consecutive in k's version order   Tv -> Tw
    rw  k: Tr read the version preceding Tw's write  Tr -> Tw
    rt:    Tw completed before Tr invoked (optional) Tw -> Tr

A key's version order is the commit (completion-index) order of its
writes.  Cycles are classified by their edge types (Adya):

    only ww                 -> G0  (write cycle)
    ww/wr, no rw            -> G1c (circular information flow)
    exactly one rw          -> G-single (read skew)
    two or more rw          -> G2  (anti-dependency cycle / write skew)

Aborted reads (G1a) and intermediate reads (G1b) are linear host
passes.
"""

from __future__ import annotations

import numpy as np

from jepsen_tpu_torch import checker as ck
from jepsen_tpu_torch import txn as mop
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.ops import cycle as cyc


def _classify(edge_types: list) -> str:
    n_rw = sum(1 for t in edge_types if t == "rw")
    if n_rw >= 2:
        return "G2"
    if n_rw == 1:
        return "G-single"
    if any(t == "wr" or t == "rt" for t in edge_types):
        return "G1c"
    return "G0"


class _Graph:
    """Adjacency + per-edge type tags over txn indices."""

    def __init__(self, n: int):
        self.n = n
        self.adj = np.zeros((n, n), bool)
        self.types: dict = {}

    def add(self, a: int, b: int, etype: str) -> None:
        if a == b:
            return
        self.adj[a, b] = True
        self.types.setdefault((a, b), set()).add(etype)

    def edge_types(self, path: list) -> list:
        out = []
        for a, b in zip(path, path[1:]):
            ts = sorted(self.types.get((a, b), {"?"}))
            # rw is the scarce/defining type for classification: prefer
            # reporting a non-rw tag when both exist so G2 counts stay
            # conservative.
            out.append(ts[0] if len(ts) == 1 else
                       next((t for t in ts if t != "rw"), ts[0]))
        return out


def build_graph(txns: list, realtime: bool = False) -> _Graph:
    """txns: list of (invoke_op, ok_op) pairs in completion order."""
    g = _Graph(len(txns))

    writes: dict = {}        # (k, v) -> txn index
    wlists: dict = {}        # k -> [(complete_index, txn_idx, v), ...]
    for i, (_, okop) in enumerate(txns):
        for m in okop.value or []:
            if mop.is_write(m):
                writes[(mop.key(m), mop.value(m))] = i
                wlists.setdefault(mop.key(m), []).append(
                    (okop.index if okop.index is not None else i, i,
                     mop.value(m)))

    version_order: dict = {}  # k -> [v0, v1, ...] in commit order
    version_writer: dict = {}  # (k, position) -> txn idx
    for k, ws in wlists.items():
        ws.sort()
        version_order[k] = [v for (_, _, v) in ws]
        for pos, (_, i, _) in enumerate(ws):
            version_writer[(k, pos)] = i

    # ww: consecutive versions
    for k, ws in wlists.items():
        for (a, b) in zip(ws, ws[1:]):
            g.add(a[1], b[1], "ww")

    for i, (_, okop) in enumerate(txns):
        for m in okop.value or []:
            if not mop.is_read(m):
                continue
            k, v = mop.key(m), mop.value(m)
            order = version_order.get(k, [])
            if v is None:
                pos = -1                     # read the initial version
            else:
                w = writes.get((k, v))
                if w is None:
                    continue                 # G1a, reported separately
                g.add(w, i, "wr")
                pos = order.index(v)
            nxt = version_writer.get((k, pos + 1))
            if nxt is not None:
                g.add(i, nxt, "rw")

    if realtime:
        # Tw's ok before Tr's invoke.  O(n log n): sweep by time.
        evs = []
        for i, (inv, okop) in enumerate(txns):
            evs.append((inv.index, 0, i))
            evs.append((okop.index, 1, i))
        evs.sort(key=lambda e: (e[0] if e[0] is not None else 0, e[1]))
        done: list = []
        for _, kind, i in evs:
            if kind == 1:
                done.append(i)
            else:
                for j in done:
                    g.add(j, i, "rt")
    return g


def _g1a(txns: list) -> list:
    """Reads of values no committed txn wrote."""
    written = {(mop.key(m), mop.value(m))
               for _, okop in txns for m in okop.value or []
               if mop.is_write(m)}
    bad = []
    for _, okop in txns:
        for m in okop.value or []:
            if (mop.is_read(m) and mop.value(m) is not None
                    and (mop.key(m), mop.value(m)) not in written):
                bad.append({"op": okop.to_dict(), "mop": list(m)})
    return bad


def _g1b(txns: list) -> list:
    """Reads by *another* txn of a txn's non-final write to a key
    (intermediate read; a txn reading its own in-progress writes is
    legal read-your-own-writes)."""
    intermediate: dict = {}   # (k, v) -> writer txn index
    for i, (_, okop) in enumerate(txns):
        lastw: dict = {}
        for m in okop.value or []:
            if mop.is_write(m):
                k = mop.key(m)
                if k in lastw:
                    intermediate[(k, lastw[k])] = i
                lastw[k] = mop.value(m)
    bad = []
    for j, (_, okop) in enumerate(txns):
        for m in okop.value or []:
            if (mop.is_read(m)
                    and intermediate.get((mop.key(m), mop.value(m)), j) != j):
                bad.append({"op": okop.to_dict(), "mop": list(m)})
    return bad


def completed_txns(history) -> list:
    """(invoke, ok) pairs for ok txn ops, in completion order."""
    hist = History(history)
    inv: dict = {}
    out = []
    for o in hist:
        if not isinstance(o.value, (list, tuple)):
            continue
        if o.value and not all(mop.is_op(m) for m in o.value):
            continue
        if o.is_invoke:
            inv[o.process] = o
        elif o.is_ok and o.process in inv:
            out.append((inv.pop(o.process), o))
    return out


class TxnCycleChecker(ck.Checker):
    """Serializability-anomaly checker over txn histories.

    anomalies: the subset of {"G0", "G1a", "G1b", "G1c", "G-single",
    "G2"} to fail on (default all); realtime: add real-time precedence
    edges (strict serializability); device: where the SCCs run (the
    card by default)."""

    def __init__(self, anomalies=None, realtime: bool = False,
                 device=None):
        self.anomalies = set(anomalies or
                             ["G0", "G1a", "G1b", "G1c", "G-single", "G2"])
        self.realtime = realtime
        self.device = device

    def check(self, test, history, opts=None):
        txns = completed_txns(history)
        found: dict = {}

        g1a = _g1a(txns)
        if g1a:
            found["G1a"] = g1a
        g1b = _g1b(txns)
        if g1b:
            found["G1b"] = g1b

        g = build_graph(txns, realtime=self.realtime)
        cycles = (cyc.cycles_by_component(g.adj, self.device) if g.n
                  else [])
        for path in cycles:
            types = g.edge_types(path)
            kind = _classify(types)
            found.setdefault(kind, []).append({
                "cycle": [txns[i][1].to_dict() for i in path],
                "edges": types})

        bad = sorted(set(found) & self.anomalies)
        return {"valid?": not bad,
                "anomaly-types": bad,
                "anomalies": {k: found[k] for k in bad},
                "txn-count": len(txns),
                "cycle-count": len(cycles)}


def checker(anomalies=None, realtime: bool = False,
            device=None) -> TxnCycleChecker:
    return TxnCycleChecker(anomalies, realtime, device)
