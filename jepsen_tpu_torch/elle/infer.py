"""Dependency inference: observed txn history -> typed edge planes
(the JAX package's `elle/infer.py`, host-side numpy).

From the observed values of a *recoverable* transactional workload
(every write unique per key: list-append, rw-register), derive per-key
version orders and emit one boolean adjacency plane per dependency type
over committed transactions:

    ww  write-write:  Tv installed a version, Tw installed a later one
    wr  write-read:   Tw installed the version Tr observed
    rw  anti-dep:     Tr observed a version preceding Tw's write
    po  process:      same worker process, consecutive txns
    rt  realtime:     Tw completed before Tr invoked

Soundness discipline (every reported cycle must exist in the real DSG):

  * list-append: the version order of key k is recovered from observed
    list states, which must form a prefix chain (longest read wins;
    a non-prefix read is itself an anomaly, `incompatible-order`).
  * rw-register: version order uses *evidence only*: the initial nil
    precedes everything, and a txn that read u before writing v
    proves u < v (write-follows-read).  An emitted ww/rw edge over a
    non-adjacent version pair stands for a real edge followed by a
    ww-path, so cycle existence and rw-edge counts (what the Adya
    classification keys on) are preserved.
  * reads already condemned as G1a (aborted/garbage read) or G1b
    (intermediate read) contribute NO dependency edges: their version
    positions are unreliable, and the direct anomaly already carries
    the report.

G1a and G1b are detected inline during this pass; cycles are the
device tiers' job (`ops.elle_graph`, `ops.elle_mesh`).  The streaming
twin (`IncrementalInference`) belongs to the live tier, ROADMAP P7."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from jepsen_tpu_torch import txn as mop
from jepsen_tpu_torch.history import History

_MISS = object()

# Fixed plane order: ops/elle_graph.py indexes by position.
PLANES = ("ww", "wr", "rw", "po", "rt")
DEP_PLANES = ("ww", "wr", "rw")

LIST_APPEND = "list-append"
RW_REGISTER = "rw-register"


@dataclasses.dataclass
class Inference:
    """Everything the cycle kernels and the report need."""

    txns: list                    # (invoke, ok) Op pairs, completion order
    planes: dict                  # plane name -> bool [n, n]
    edge_types: dict              # (a, b) -> set of dep-plane names
    direct: dict                  # anomaly name -> [witness dicts]
    workload: str
    meta: dict = dataclasses.field(default_factory=dict)
    edge_lists: Optional[dict] = None   # plane -> (src i64[], dst i64[])
    predicate: Optional[dict] = None    # {"prw": (src, dst), "reads": n}

    @property
    def n(self) -> int:
        return len(self.txns)

    def stacked(self) -> np.ndarray:
        """Planes as one [len(PLANES), n, n] bool array."""
        return np.stack([self.planes[p] for p in PLANES])

    def packed_stacked(self, n_pad: Optional[int] = None,
                       n_dev: int = 1) -> np.ndarray:
        """Planes as one bit-packed uint32 [len(PLANES), n_pad, W]
        stack, built by sparse word-insertion from the inference's
        edge lists (ops.elle_mesh.set_bits), never materializing a
        second dense [P, n, n] detour.  Equal to
        elle_mesh.pack_planes(self.stacked())."""
        from jepsen_tpu_torch.ops import elle_mesh
        if n_pad is None:
            n_pad = elle_mesh.pad_for_mesh(self.n, n_dev)
        out = np.zeros((len(PLANES), n_pad, n_pad // 32), np.uint32)
        if self.edge_lists is not None:
            for pi, p in enumerate(PLANES):
                src, dst = self.edge_lists[p]
                elle_mesh.set_bits(out[pi], src, dst)
        else:
            return elle_mesh.pack_planes(self.stacked(), n_pad=n_pad,
                                         n_dev=n_dev)
        return out


class _Edges:
    """Edge accumulator: per-plane (src, dst) lists, scattered into
    dense planes ONCE at finalize() (a per-edge `plane[a, b] = True`
    write would be the Python hot loop of large-history inference);
    the lists also feed the bit-packed layout directly
    (Inference.packed_stacked), so the packed tier never needs the
    dense detour."""

    def __init__(self, n: int):
        self.n = n
        self._src = {p: [] for p in PLANES}
        self._dst = {p: [] for p in PLANES}
        self._dense: dict = {}      # planes installed whole (rt)
        self.types: dict = {}

    def add(self, plane: str, a: int, b: int) -> None:
        if a == b or a is None or b is None:
            return
        self._src[plane].append(a)
        self._dst[plane].append(b)
        if plane in DEP_PLANES:
            self.types.setdefault((a, b), set()).add(plane)

    def set_plane(self, name: str, dense: np.ndarray) -> None:
        self._dense[name] = dense

    def edge_arrays(self) -> dict:
        """plane -> (src int64[], dst int64[]), dense-installed planes
        converted via nonzero (rt is already the vectorized O(n^2)
        pair set)."""
        out = {}
        for p in PLANES:
            if p in self._dense:
                s, d = np.nonzero(self._dense[p])
                src = s.astype(np.int64)
                dst = d.astype(np.int64)
            else:
                src = np.asarray(self._src[p], np.int64)
                dst = np.asarray(self._dst[p], np.int64)
            out[p] = (src, dst)
        return out

    def finalize(self) -> dict:
        """Materialize the dense bool planes (one vectorized scatter
        per plane)."""
        planes = {}
        for p in PLANES:
            m = self._dense.get(p)
            if m is None:
                m = np.zeros((self.n, self.n), bool)
            if self._src[p]:
                m[np.asarray(self._src[p], np.int64),
                  np.asarray(self._dst[p], np.int64)] = True
            planes[p] = m
        return planes


def txn_mops(okop) -> list:
    return [m for m in (okop.value or []) if mop.is_op(m)]


def detect_workload(history) -> str:
    """Sniff ALL ops (a failed append still marks the workload)."""
    for o in History(history):
        if isinstance(o.value, (list, tuple)):
            for m in o.value:
                if mop.is_op(m) and mop.is_append(m):
                    return LIST_APPEND
    return RW_REGISTER


def collect_txns(history):
    """(ok_pairs, failed_writes, indeterminate_writes): ok txns as
    (invoke, ok) pairs in completion order; the (k, v) write/append
    sets of failed txns (definitely didn't commit -> reading one is
    G1a) and of info txns (may have committed -> reading one is NOT an
    anomaly, but the writer isn't a graph node)."""
    hist = History(history)
    inv: dict = {}
    ok_pairs, failed, indet = [], set(), set()

    def writes_of(v):
        return {(mop.key(m), mop.value(m)) for m in (v or [])
                if mop.is_op(m) and (mop.is_write(m) or mop.is_append(m))
                and not isinstance(mop.value(m), (list, dict, set))}

    for o in hist:
        if not isinstance(o.value, (list, tuple)) or isinstance(
                o.value, str):
            continue
        if o.value and not all(mop.is_op(m) for m in o.value):
            continue
        if o.is_invoke:
            inv[o.process] = o
        elif o.process in inv:
            first = inv.pop(o.process)
            if o.is_ok:
                ok_pairs.append((first, o))
            elif o.is_fail:
                failed |= writes_of(first.value)
            else:                    # info: indeterminate
                indet |= writes_of(first.value)
    # invocations never completed are indeterminate too
    for o in inv.values():
        indet |= writes_of(o.value)
    return ok_pairs, failed, indet


def _order_planes(txns: list, edges: _Edges) -> None:
    """po: consecutive txns of one process; rt: ok strictly before
    invoke (vectorized — the O(n^2) pair set is exactly the plane)."""
    n = len(txns)
    by_proc: dict = {}
    for i, (inv, _) in enumerate(txns):
        by_proc.setdefault(inv.process, []).append(i)
    for seq in by_proc.values():
        for a, b in zip(seq, seq[1:]):
            edges.add("po", a, b)
    if n:
        inv_idx = np.array([inv.index if inv.index is not None else -1
                            for inv, _ in txns], np.int64)
        ok_idx = np.array([ok.index if ok.index is not None else -1
                           for _, ok in txns], np.int64)
        known = (inv_idx >= 0) & (ok_idx >= 0)
        rt = (ok_idx[:, None] < inv_idx[None, :]) \
            & known[:, None] & known[None, :]
        np.fill_diagonal(rt, False)
        edges.set_plane("rt", rt)


# ---------------------------------------------------------------------------
# list-append
# ---------------------------------------------------------------------------

def _infer_list_append(txns, failed, indet, edges: _Edges):
    direct: dict = {}
    meta: dict = {"keys": 0}

    def flag(name, i, m, **kw):
        direct.setdefault(name, []).append(
            dict({"op": txns[i][1].to_dict(), "mop": list(m)}, **kw))

    # per-key append bookkeeping over committed txns
    writer_of: dict = {}          # (k, v) -> txn index
    appends_by_txn: dict = {}     # (k, txn) -> [v, ...] in mop order
    for i, (_, okop) in enumerate(txns):
        for m in txn_mops(okop):
            if mop.is_append(m):
                k, v = mop.key(m), mop.value(m)
                if (k, v) in writer_of and writer_of[(k, v)] != i:
                    flag("duplicate-elements", i, m,
                         other=txns[writer_of[(k, v)]][1].to_dict())
                    continue
                writer_of[(k, v)] = i
                appends_by_txn.setdefault((k, i), []).append(v)

    # observed states per key; version order = longest prefix chain
    reads: list = []              # (txn index, key, state tuple, mop)
    for i, (_, okop) in enumerate(txns):
        for m in txn_mops(okop):
            if mop.is_read(m):
                s = mop.value(m)
                if s is None:
                    s = []
                if not isinstance(s, (list, tuple)):
                    continue
                reads.append((i, mop.key(m), tuple(s), m))

    orders: dict = {}             # key -> tuple of values, longest observed
    for i, k, s, m in reads:
        if len(s) > len(orders.get(k, ())):
            orders[k] = s
    meta["keys"] = len({k for k, _ in writer_of} | set(orders))

    # each key's appenders in the order appends_by_txn holds them, so
    # a read visits its own key's appenders only (the reference scans
    # every (key, txn) entry per read: the same visits in the same order,
    # quadratic in the history)
    by_key_appends: dict = {}
    for (k, t), vs in appends_by_txn.items():
        by_key_appends.setdefault(k, []).append((t, vs))

    # classify each read; only clean prefix reads contribute edges
    for i, k, s, m in reads:
        order = orders.get(k, ())
        bad = False
        for v in s:
            if (k, v) in failed:
                flag("G1a", i, m, kind="aborted")
                bad = True
                break
            if (writer_of.get((k, v)) is None and (k, v) not in indet):
                flag("G1a", i, m, kind="garbage")
                bad = True
                break
        if bad:
            continue
        seen = set(s)
        for t, vs in by_key_appends.get(k, ()):
            if t == i or len(vs) < 2:
                continue
            if any(v in seen for v in vs[:-1]) and vs[-1] not in seen:
                flag("G1b", i, m, writer=txns[t][1].to_dict())
                bad = True
                break
        if bad:
            continue
        if tuple(order[:len(s)]) != tuple(s):
            flag("incompatible-order", i, m, longest=list(order))
            continue
        # wr: the last element whose writer is a committed node other
        # than the reader itself (read-your-own-write is not an
        # external observation; the one before it is)
        for v in reversed(s):
            w = writer_of.get((k, v))
            if w is not None and w != i:
                edges.add("wr", w, i)
                break
        # rw: lists grow monotonically, so ANY committed append not in
        # the observed state was installed after it — the next observed
        # version plus every unobserved committed append (sound: the
        # emitted edge stands for rw + a ww-path)
        seen2 = set(s)
        for t, vs in by_key_appends.get(k, ()):
            if t != i and not seen2.issuperset(vs):
                edges.add("rw", i, t)

    # ww: consecutive committed writers along each key's version
    # order, then order-tail -> unobserved appends (same monotonicity
    # argument: absent from the longest observed state => later)
    for k, order in orders.items():
        prev = None
        for v in order:
            w = writer_of.get((k, v))
            if w is None:
                continue
            if prev is not None and prev != w:
                edges.add("ww", prev, w)
            prev = w
        if prev is not None:
            observed = set(order)
            for t, vs in by_key_appends.get(k, ()):
                if t != prev and not observed.issuperset(vs):
                    edges.add("ww", prev, t)

    # bounded: results.json must not scale with history size
    meta["version-orders"] = {
        repr(k): (list(v[:32]) + ["..."] if len(v) > 32 else list(v))
        for k, v in sorted(orders.items(),
                           key=lambda kv: repr(kv[0]))[:8]}
    return direct, meta


# ---------------------------------------------------------------------------
# rw-register
# ---------------------------------------------------------------------------

def _infer_rw_register(txns, failed, indet, edges: _Edges):
    direct: dict = {}
    meta: dict = {}

    def flag(name, i, m, **kw):
        direct.setdefault(name, []).append(
            dict({"op": txns[i][1].to_dict(), "mop": list(m)}, **kw))

    writer_of: dict = {}          # (k, v) -> txn of the FINAL write of v
    intermediate: dict = {}       # (k, v) -> txn whose non-final write v was
    finals_by_txn: list = []      # per txn: {k: final value written}
    for i, (_, okop) in enumerate(txns):
        last: dict = {}
        for m in txn_mops(okop):
            if mop.is_write(m):
                k = mop.key(m)
                if k in last:
                    intermediate[(k, last[k])] = i
                last[k] = mop.value(m)
        for k, v in list(last.items()):
            if (k, v) in writer_of and writer_of[(k, v)] != i:
                flag("duplicate-elements", i, ["w", k, v],
                     other=txns[writer_of[(k, v)]][1].to_dict())
                del last[k]
                continue
            writer_of[(k, v)] = i
        finals_by_txn.append(last)

    # clean reads + version-order evidence (write-follows-read).  A
    # read AFTER the txn's own write to the key observes itself; only
    # pre-write reads are external observations.
    clean_reads: list = []        # (txn, key, value read)
    evidence: dict = {}           # key -> {u: set of direct successors v}
    for i, (_, okop) in enumerate(txns):
        wrote: set = set()
        pre_read: dict = {}
        for m in txn_mops(okop):
            k = mop.key(m)
            if mop.is_write(m):
                wrote.add(k)
                continue
            if not mop.is_read(m) or k in wrote:
                continue
            v = mop.value(m)
            if isinstance(v, (list, dict, set)):
                continue             # not a register observation
            if v is not None:
                if (k, v) in failed:
                    flag("G1a", i, m, kind="aborted")
                    continue
                if (k, v) in intermediate:
                    t = intermediate[(k, v)]
                    if t != i:
                        flag("G1b", i, m, writer=txns[t][1].to_dict())
                        continue
                if writer_of.get((k, v)) is None:
                    if (k, v) not in indet:
                        flag("G1a", i, m, kind="garbage")
                    continue          # indeterminate writer: no edges
            clean_reads.append((i, k, v))
            pre_read.setdefault(k, v)
        for k, v in finals_by_txn[i].items():
            if k in pre_read:
                evidence.setdefault(k, {}).setdefault(
                    pre_read[k], set()).add(v)

    # per-key evidence DAG sanity: a cycle means the observations are
    # not explainable by ANY version order.  Iterative coloring — the
    # write-follows-read chain of a counter-shaped key is as long as
    # the history.
    for k, succ in evidence.items():
        color: dict = {}
        bad = False
        for root in list(succ):
            if color.get(root, 0):
                continue
            stack = [(root, iter(succ.get(root, ())))]
            color[root] = 1
            while stack and not bad:
                u, it = stack[-1]
                v = next(it, None)
                if v is None:
                    color[u] = 2
                    stack.pop()
                elif color.get(v, 0) == 1:
                    bad = True
                elif color.get(v, 0) == 0:
                    color[v] = 1
                    stack.append((v, iter(succ.get(v, ()))))
            if bad:
                break
        if bad:
            flag("cyclic-version-order", 0, ["r", k, None], key=repr(k))
            evidence[k] = {}

    # ww + wr + rw from evidence
    for k, succ in evidence.items():
        for u, vs in succ.items():
            wu = writer_of.get((k, u)) if u is not None else None
            for v in vs:
                wv = writer_of.get((k, v))
                if wu is not None and wv is not None:
                    edges.add("ww", wu, wv)
    for i, k, v in clean_reads:
        if v is not None:
            w = writer_of.get((k, v))
            if w is not None:
                edges.add("wr", w, i)
        for nxt in evidence.get(k, {}).get(v, ()):
            wv = writer_of.get((k, nxt))
            if wv is not None:
                edges.add("rw", i, wv)

    meta["evidence-keys"] = len(evidence)
    return direct, meta


# ---------------------------------------------------------------------------
# predicate reads: phantom evidence for G1/G2-predicate
# ---------------------------------------------------------------------------

def _infer_predicate(txns, failed, indet, edges: _Edges):
    """Evidence from ["rp", pred, observed] micro-ops, workload-
    independent (runs after either item pass; zero rp mops => no-op).

      * an observed (k, v) whose writer failed (or doesn't exist and
        isn't indeterminate) is a DIRECT G1-predicate flag — a dirty/
        garbage predicate read breaks read-committed on its own;
      * an observed (k, v) with a committed writer is an ordinary wr
        observation (the predicate read read that version);
      * a committed final write to a key INSIDE the predicate's match
        set (`txn.predicate_keys`) that the read observed NOTHING for
        is a phantom: the write can only have been installed after
        the read's snapshot (nil-first version order), so it emits a
        predicate anti-dependency `prw` read -> writer.  Non-nil
        mismatches get no edge (conservative: without a version-order
        witness the unseen version could be older).

    Returns (direct, (prw_src, prw_dst)); prw is NOT one of PLANES —
    the lattice engine (ROADMAP P7) carries it as its own packed plane.
    """
    direct: dict = {}

    def flag(name, i, m, **kw):
        direct.setdefault(name, []).append(
            dict({"op": txns[i][1].to_dict(), "mop": list(m)}, **kw))

    any_rp = any(mop.is_predicate_read(m)
                 for _, okop in txns for m in txn_mops(okop))
    if not any_rp:
        return direct, ([], [])

    writer_of: dict = {}          # (k, v) -> committed writer txn
    finals: dict = {}             # key -> {txn: final value written}
    for i, (_, okop) in enumerate(txns):
        last: dict = {}
        for m in txn_mops(okop):
            if mop.is_write(m):
                last[mop.key(m)] = mop.value(m)
            elif mop.is_append(m):
                k, v = mop.key(m), mop.value(m)
                writer_of.setdefault((k, v), i)
                finals.setdefault(k, {})[i] = v
        for k, v in last.items():
            writer_of.setdefault((k, v), i)
            finals.setdefault(k, {})[i] = v

    prw_src: list = []
    prw_dst: list = []
    for i, (_, okop) in enumerate(txns):
        for m in txn_mops(okop):
            if not mop.is_predicate_read(m):
                continue
            observed = mop.value(m)
            if not isinstance(observed, dict):
                observed = {}
            for k, v in observed.items():
                if v is None:
                    continue
                if (k, v) in failed:
                    flag("G1-predicate", i, m, kind="aborted",
                         key=repr(k))
                    continue
                w = writer_of.get((k, v))
                if w is None:
                    if (k, v) not in indet:
                        flag("G1-predicate", i, m, kind="garbage",
                             key=repr(k))
                    continue
                if w != i:
                    edges.add("wr", w, i)
            for k in mop.predicate_keys(m):
                if observed.get(k) is not None:
                    continue       # saw a version; no phantom for k
                for t in finals.get(k, ()):
                    if t != i:
                        prw_src.append(i)
                        prw_dst.append(t)
    return direct, (prw_src, prw_dst)


# ---------------------------------------------------------------------------
# session-order plane families
# ---------------------------------------------------------------------------

SESSION_PLANES = ("so_ww", "so_wr", "so_rw", "so_rr")


def txn_roles(txns) -> tuple:
    """(wrote, read) bool indicator vectors over committed txns — a
    predicate read counts as a read."""
    n = len(txns)
    wrote = np.zeros(n, bool)
    read = np.zeros(n, bool)
    for i, (_, okop) in enumerate(txns):
        for m in txn_mops(okop):
            if mop.is_write(m) or mop.is_append(m):
                wrote[i] = True
            elif mop.is_read(m) or mop.is_predicate_read(m):
                read[i] = True
    return wrote, read


def session_planes(txns) -> dict:
    """The transitively-closed session order (every ordered pair of
    one process's committed txns — `po`'s closure, built closed by
    construction) split into endpoint-role families:

        so_ww  writer -> writer     (monotonic-writes' defining edges)
        so_wr  writer -> reader     (read-your-writes')
        so_rw  reader -> writer     (writes-follow-reads')
        so_rr  reader -> reader     (monotonic-reads')

    A txn that both reads and writes puts its edges in every matching
    family; the lattice masks' priority chain disambiguates.  Returns
    {"planes": {name: bool [n, n]}, "edge_lists": {name: (src, dst)},
    "wrote": bool [n], "read": bool [n]}.
    """
    n = len(txns)
    wrote, read = txn_roles(txns)
    so = np.zeros((n, n), bool)
    by_proc: dict = {}
    for i, (inv, _) in enumerate(txns):
        by_proc.setdefault(inv.process, []).append(i)
    for seq in by_proc.values():
        for ai, a in enumerate(seq):
            for b in seq[ai + 1:]:
                so[a, b] = True
    fams = {"so_ww": so & np.outer(wrote, wrote),
            "so_wr": so & np.outer(wrote, read),
            "so_rw": so & np.outer(read, wrote),
            "so_rr": so & np.outer(read, read)}
    lists = {}
    for name, plane in fams.items():
        s, d = np.nonzero(plane)
        lists[name] = (s.astype(np.int64), d.astype(np.int64))
    return {"planes": fams, "edge_lists": lists,
            "wrote": wrote, "read": read}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def infer(history, workload: str = "auto") -> Inference:
    """Infer dependency planes + direct anomalies from a history.
    `workload`: "list-append", "rw-register", or "auto" (sniff for
    append micro-ops)."""
    if workload == "auto":
        workload = detect_workload(history)
    txns, failed, indet = collect_txns(history)
    edges = _Edges(len(txns))
    if workload == LIST_APPEND:
        direct, meta = _infer_list_append(txns, failed, indet, edges)
    elif workload == RW_REGISTER:
        direct, meta = _infer_rw_register(txns, failed, indet, edges)
    else:
        raise ValueError(f"unknown elle workload {workload!r}")
    pred_direct, (prw_src, prw_dst) = _infer_predicate(
        txns, failed, indet, edges)
    for name, flags in pred_direct.items():
        direct.setdefault(name, []).extend(flags)
    _order_planes(txns, edges)
    planes = edges.finalize()
    meta["txn-count"] = len(txns)
    meta["edge-counts"] = {p: int(planes[p].sum()) for p in PLANES}
    predicate = None
    if prw_src or "G1-predicate" in pred_direct:
        predicate = {"prw": (np.asarray(prw_src, np.int64),
                             np.asarray(prw_dst, np.int64)),
                     "reads": sum(
                         1 for _, okop in txns
                         for m in txn_mops(okop)
                         if mop.is_predicate_read(m))}
        meta["predicate-reads"] = predicate["reads"]
    return Inference(txns=txns, planes=planes,
                     edge_types=edges.types, direct=direct,
                     workload=workload, meta=meta,
                     edge_lists=edges.edge_arrays(),
                     predicate=predicate)
