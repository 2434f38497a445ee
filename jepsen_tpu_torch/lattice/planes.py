"""Lattice plane stacks (the JAX package's `lattice/planes.py`).

Lowers an `elle.infer.Inference` into the 8-plane stack the lattice
engine classifies:

    LATTICE_PLANES = (ww, wr, rw,            # Adya item dependencies
                      so_ww, so_wr, so_rw,   # session order by
                      so_rr,                 #   endpoint role
                      prw)                   # predicate anti-deps

Unlike Elle's po/rt order planes, the session planes are transitively
closed at construction (every ordered pair within one process's
committed txns), so the class masks never need to close them again.
Dense and bit-packed forms share `ops.elle_mesh`'s word layout (the
packed stack is built by `set_bits` from the edge lists, never through
a dense detour)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from jepsen_tpu_torch import txn as mop
from jepsen_tpu_torch.elle import infer as infer_mod

LATTICE_PLANES = ("ww", "wr", "rw",
                  "so_ww", "so_wr", "so_rw", "so_rr", "prw")

DEP = slice(0, 3)                  # ww | wr | rw
SO = slice(3, 7)                   # the four session families
PRW = 7


@dataclasses.dataclass
class LatticePlanes:
    """One history's lattice planes and their provenance."""

    n: int
    planes: dict                   # name -> bool [n, n]
    edge_lists: dict               # name -> (src i64[], dst i64[])
    meta: dict = dataclasses.field(default_factory=dict)

    def stacked(self) -> np.ndarray:
        """[len(LATTICE_PLANES), n, n] bool."""
        return np.stack([self.planes[p] for p in LATTICE_PLANES]) \
            if self.n else np.zeros(
                (len(LATTICE_PLANES), 0, 0), bool)

    def packed_stacked(self, n_pad: Optional[int] = None,
                       n_dev: int = 1) -> np.ndarray:
        """Bit-packed uint32 [len(LATTICE_PLANES), n_pad, W] by sparse
        word insertion from the edge lists, equal to
        elle_mesh.pack_planes(self.stacked())."""
        from jepsen_tpu_torch.ops import elle_mesh
        if n_pad is None:
            n_pad = elle_mesh.pad_for_mesh(max(self.n, 1), n_dev)
        out = np.zeros((len(LATTICE_PLANES), n_pad, n_pad // 32),
                       np.uint32)
        for pi, p in enumerate(LATTICE_PLANES):
            src, dst = self.edge_lists[p]
            if len(src):
                elle_mesh.set_bits(out[pi], src, dst)
        return out


def _nil_read_rw(inf: infer_mod.Inference) -> np.ndarray:
    """Nil-first anti-dependencies for rw-register histories: the
    register starts nil, so a committed read that observed nil for a
    key it hadn't written precedes EVERY committed final write of that
    key, an rw edge read -> writer.  Elle's inference leaves these out
    (its rw edges need write-follows-read evidence inside one txn); the
    lattice needs them for the reader-only shapes where long forks live
    (two group reads, writers who never read)."""
    n = inf.n
    extra = np.zeros((n, n), bool)
    writers: dict = {}             # key -> committed final writers
    for i, (_, okop) in enumerate(inf.txns):
        last: dict = {}
        for m in infer_mod.txn_mops(okop):
            if mop.is_write(m):
                last[mop.key(m)] = mop.value(m)
        for k, v in last.items():
            if v is not None and not isinstance(v, (list, dict, set)):
                writers.setdefault(k, set()).add(i)
    for i, (_, okop) in enumerate(inf.txns):
        wrote: set = set()
        for m in infer_mod.txn_mops(okop):
            if mop.is_write(m):
                wrote.add(mop.key(m))
                continue
            if not mop.is_read(m):
                continue
            k = mop.key(m)
            if k in wrote or mop.value(m) is not None:
                continue
            for j in writers.get(k, ()):
                if j != i:
                    extra[i, j] = True
    return extra


def from_inference(inf: infer_mod.Inference) -> LatticePlanes:
    """The lattice stack of a base inference: the dependency planes
    verbatim (rw-register's rw with the nil-first edges), the session
    families from `session_planes`, prw from the predicate pass."""
    n = inf.n
    planes = {p: inf.planes[p] for p in ("ww", "wr", "rw")}
    nil_rw = 0
    if inf.workload == infer_mod.RW_REGISTER and n:
        extra = _nil_read_rw(inf)
        if extra.any():
            planes["rw"] = planes["rw"] | extra
            nil_rw = int(extra.sum())
    sess = infer_mod.session_planes(inf.txns)
    planes.update(sess["planes"])
    prw = np.zeros((n, n), bool)
    prw_lists = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    if inf.predicate is not None:
        src, dst = inf.predicate["prw"]
        if len(src):
            prw[src, dst] = True
            np.fill_diagonal(prw, False)
            s, d = np.nonzero(prw)
            prw_lists = (s.astype(np.int64), d.astype(np.int64))
    planes["prw"] = prw
    lists = {p: inf.edge_lists[p] for p in ("ww", "wr", "rw")} \
        if inf.edge_lists is not None else {
            p: tuple(a.astype(np.int64)
                     for a in np.nonzero(planes[p]))
            for p in ("ww", "wr", "rw")}
    if nil_rw:
        lists["rw"] = tuple(a.astype(np.int64)
                            for a in np.nonzero(planes["rw"]))
    lists.update(sess["edge_lists"])
    lists["prw"] = prw_lists
    meta = {"wrote": int(sess["wrote"].sum()),
            "read": int(sess["read"].sum()),
            "nil-first-rw": nil_rw,
            "edge-counts": {p: int(planes[p].sum())
                            for p in LATTICE_PLANES}}
    return LatticePlanes(n=n, planes=planes, edge_lists=lists,
                         meta=meta)


def from_history(history, workload: str = "auto") -> tuple:
    """(LatticePlanes, Inference) straight from a history."""
    inf = infer_mod.infer(history, workload=workload)
    return from_inference(inf), inf
