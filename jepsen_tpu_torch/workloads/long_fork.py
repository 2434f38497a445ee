"""Long-fork anomaly detection, parallel snapshot isolation's signature
violation (the JAX package's `workloads/long_fork.py`, after jepsen's
`tests/long_fork.clj`): concurrent write transactions observed in
conflicting orders by different readers.

Writes are single-key [[w k 1]] txns (each key written at most once);
reads scan a key *group*.  A long fork exists iff two reads of the same
group are mutually incomparable under the value-dominance order.  The
pairwise comparability scan (long_fork.clj find-forks :216-224) becomes
a dominance matrix past 8 reads.  Only the checker is ported: the
generator and workload are not."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from jepsen_tpu_torch import txn as mop
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.history import History


class IllegalHistory(Exception):
    def __init__(self, info: dict):
        super().__init__(info.get("msg"))
        self.info = info


def group_for(n: int, k: int) -> range:
    """The key group containing k (long_fork.clj:98-104)."""
    lower = k - (k % n)
    return range(lower, lower + n)


def read_txn_for(n: int, k: int) -> list:
    """Shuffled group read (long_fork.clj:106-112)."""
    ks = list(group_for(n, k))
    random.shuffle(ks)
    return [["r", k2, None] for k2 in ks]


def read_op_value_map(op) -> dict:
    """long_fork.clj:226-235."""
    return {mop.key(m): mop.value(m) for m in (op.value or [])}


def read_compare(a: dict, b: dict) -> Optional[int]:
    """-1 if a dominates, 0 equal, 1 if b dominates, None incomparable
    (long_fork.clj read-compare :158-203)."""
    if len(a) != len(b):
        raise IllegalHistory(
            {"type": "illegal-history", "reads": [a, b],
             "msg": "These reads did not query for the same keys, and "
                    "therefore cannot be compared."})
    res = 0
    for k, va in a.items():
        if k not in b:
            raise IllegalHistory(
                {"type": "illegal-history", "reads": [a, b], "key": k,
                 "msg": "These reads did not query for the same keys, and "
                        "therefore cannot be compared."})
        vb = b[k]
        if va == vb:
            continue
        if vb is None:
            if res > 0:
                return None
            res = -1
        elif va is None:
            if res < 0:
                return None
            res = 1
        else:
            raise IllegalHistory(
                {"type": "illegal-history", "key": k, "reads": [a, b],
                 "msg": "These two read states contain distinct values for "
                        "the same key; this checker assumes only one write "
                        "occurs per key."})
    return res


def find_forks(ops) -> list:
    """Mutually incomparable read pairs.  Small groups use the pairwise
    host loop; larger sets vectorize to a dominance matrix
    (one broadcasted comparison per group — the device path)."""
    ops = list(ops)
    if len(ops) < 2:
        return []
    maps = [read_op_value_map(o) for o in ops]
    if len(ops) <= 8:
        out = []
        for i in range(len(ops)):
            for j in range(i + 1, len(ops)):
                if read_compare(maps[i], maps[j]) is None:
                    out.append([ops[i], ops[j]])
        return out
    return _find_forks_matrix(ops, maps)


def _find_forks_matrix(ops, maps) -> list:
    """Dominance-matrix formulation: M[i, k] = 1 if read i saw key k
    else 0 (validating single-write-per-key first).  Reads i, j are
    incomparable iff ∃k: M[i,k]>M[j,k] and ∃k: M[i,k]<M[j,k]."""
    keys = sorted({k for m in maps for k in m})
    kidx = {k: i for i, k in enumerate(keys)}
    M = np.zeros((len(maps), len(keys)), np.int8)
    for i, m in enumerate(maps):
        if set(m) != set(keys):
            raise IllegalHistory(
                {"type": "illegal-history", "reads": [m],
                 "msg": "These reads did not query for the same keys, and "
                        "therefore cannot be compared."})
        for k, v in m.items():
            if v is not None:
                if v != 1 and any(mm.get(k) not in (None, v)
                                  for mm in maps):
                    raise IllegalHistory(
                        {"type": "illegal-history", "key": k,
                         "msg": "Distinct values for one key."})
                M[i, kidx[k]] = 1
    gt = (M[:, None, :] > M[None, :, :]).any(-1)
    lt = (M[:, None, :] < M[None, :, :]).any(-1)
    inc = np.triu(gt & lt, k=1)
    return [[ops[i], ops[j]] for i, j in zip(*np.nonzero(inc))]


def is_read_txn(txn) -> bool:
    return all(mop.is_read(m) for m in txn or [])


def is_write_txn(txn) -> bool:
    return len(txn or []) == 1 and mop.is_write(txn[0])


def op_read_keys(op):
    return tuple(mop.key(m) for m in (op.value or []))


def groups(n: int, read_ops) -> list:
    """Partition reads by group; throw on wrong-size groups
    (long_fork.clj:258-271)."""
    by_group: dict = {}
    for op in read_ops:
        by_group.setdefault(frozenset(op_read_keys(op)), []).append(op)
    out = []
    for group, ops in by_group.items():
        if len(group) != n:
            raise IllegalHistory(
                {"type": "illegal-history", "op": ops[0],
                 "msg": f"Every read in this history should have observed "
                        f"exactly {n} keys, but this read observed "
                        f"{len(group)} instead: {sorted(group)}"})
        out.append(ops)
    return out


def ensure_no_long_forks(n: int, reads) -> Optional[dict]:
    forks = []
    for ops in groups(n, reads):
        forks.extend(find_forks(ops))
    if forks:
        return {"valid?": False,
                "forks": [[a.to_dict(), b.to_dict()] for a, b in forks]}
    return None


def ensure_no_multiple_writes_to_one_key(history) -> Optional[dict]:
    seen = set()
    for o in History(history):
        if o.is_invoke and is_write_txn(o.value):
            k = mop.key(o.value[0])
            if k in seen:
                return {"valid?": "unknown",
                        "error": ["multiple-writes", k]}
            seen.add(k)
    return None


def reads_of(history) -> list:
    return [o for o in History(history)
            if o.is_ok and is_read_txn(o.value)]


def early_reads(reads) -> list:
    """All-nil reads: too early to tell us anything."""
    return [r.value for r in reads
            if not any(mop.value(m) for m in r.value)]


def late_reads(reads) -> list:
    return [r.value for r in reads
            if all(mop.value(m) for m in r.value)]


class LongForkChecker(Checker):
    """long_fork.clj checker :311-324."""

    def __init__(self, n: int):
        self.n = n

    def check(self, test, history, opts=None):
        try:
            reads = reads_of(history)
            out = {"reads-count": len(reads),
                   "early-read-count": len(early_reads(reads)),
                   "late-read-count": len(late_reads(reads))}
            err = (ensure_no_multiple_writes_to_one_key(history)
                   or ensure_no_long_forks(self.n, reads))
            out.update(err or {"valid?": True})
            return out
        except IllegalHistory as e:
            return {"valid?": "unknown", "error": e.info}


def checker(n: int, **kw):
    """Lattice-backed long-fork checker: the group-read history
    classifies on the plane engine (the nil-first rw augmentation
    supplies the anti-dependencies; the wr.(rw.wr)* automaton finds the
    fork as a `long-fork` class, weakest-violated
    parallel-snapshot-isolation); `LongForkChecker` above runs alongside
    as the oracle.  kw goes to the LatticeChecker (device=,
    algorithm=)."""
    from jepsen_tpu_torch.lattice import adapters
    return adapters.LongForkLatticeChecker(n, **kw)
