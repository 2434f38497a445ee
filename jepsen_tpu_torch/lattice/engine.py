"""Masked-closure classification over the full lattice (the JAX
package's `lattice/engine.py`).

Close a handful of typed path relations once, then every anomaly class
is a boolean mask `defining_plane & closure.T`: an edge (a, b) with a
matching return path b -> a closes a cycle of exactly that class.  Seven
relations cover all twelve classes:

    Cww          ww paths                    (G0)
    P0a / P1a    zero-rw / >=1-rw paths over ww|wr (+rw)
                                             (G1c, G-single, G2-item,
                                              session-guarantee returns)
    P0s / P1s    the same pair closure with the session order joined
                 into the base                (PRAM / causal residuals)
    Cpred        paths over ww|wr|rw|prw      (G2-predicate)
    LF           wr.(rw.wr)* alternating paths (long-fork)

The masks are priority-subtracted in `lattice.LATTICE_CLASSES` order,
so one defining edge belongs to exactly one class: the four session
guarantees (typed by the so edge's endpoint roles) shadow PRAM, PRAM
shadows causal, and long-fork claims its rw edges before G2-item.
Adya's item classes run over the pure dependency planes.

Three tiers with equal verdicts and defining edges (the lowest (a, b)
row-major, as `ops.elle_graph` and `ops.elle_mesh` pick):

    lattice-host     the numpy oracle, run only when the caller asks;
    lattice-device   dense bool planes on the card: `torch.matmul` on
                     bf16 0/1 operands, each closure to its fixpoint
                     (never past the reference's ceil(log2(n_pad - 1))
                     steps);
    lattice-mesh     bit-packed planes at one card: Jacobi rounds of the
                     seven closures on `elle_pmm` with an early exit
                     (`ops.lattice_kernel.lattice_round`), then the class
                     masks and picks in the kernel `lattice_masks`;

plus per-class witness recovery (`find_witness`) by the BFS each
class's return-path relation calls for.  `classify` runs the planned
tier and raises on a failure; no tier degrades to another.  More than
one device is ROADMAP P8."""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.lattice.lattice import LATTICE_CLASSES
from jepsen_tpu_torch.lattice.planes import LATTICE_PLANES, LatticePlanes
from jepsen_tpu_torch.ops import (elle_kernel, elle_mesh, lattice_kernel,
                                  planner)
from jepsen_tpu_torch.ops.elle_graph import _add, _pad_to_tile, _sq, _steps

_SESSION4 = ("monotonic-writes", "writes-follow-reads",
             "read-your-writes", "monotonic-reads")


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------

def _mm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.float32) @ b.astype(np.float32)) > 0.5


def _closure(m: np.ndarray) -> np.ndarray:
    """Strict transitive closure (paths of >= 1 edge), log-squaring."""
    r = m.copy()
    while True:
        nr = r | _mm(r, r)
        if (nr == r).all():
            return r
        r = nr


def _reflexive(m: np.ndarray) -> np.ndarray:
    return _closure(m | np.eye(m.shape[0], dtype=bool)) \
        if m.shape[0] else m


def _pair(base: np.ndarray, rw: np.ndarray) -> tuple:
    """(p0, p1): zero-rw reflexive closure of `base`, and >=1-rw
    paths over base|rw (Elle's pair-closure update rule)."""
    p0 = _reflexive(base)
    p1 = rw.copy()
    while True:
        q = p0 | p1
        np1 = p1 | _mm(q, p1) | _mm(p1, q)
        if (np1 == p1).all():
            return p0, p1
        p1 = np1


def _host_masks(stack: np.ndarray) -> dict:
    """Class name -> bool [n, n] mask of defining edges, priority-
    subtracted in LATTICE_CLASSES order: the oracle the card tiers are
    held against."""
    ww, wr, rw = stack[0], stack[1], stack[2]
    so_ww, so_wr, so_rw, so_rr = stack[3], stack[4], stack[5], stack[6]
    prw = stack[7]
    so = so_ww | so_wr | so_rw | so_rr
    base_a = ww | wr
    cww = _closure(ww)
    p0a, p1a = _pair(base_a, rw)
    p0s, p1s = _pair(base_a | so, rw)
    cpred = _closure(ww | wr | rw | prw)
    lf = _mm(_reflexive(_mm(wr, rw)), wr)

    tdep = (p0a | p1a).T               # any-dep return (eye is inert:
    m: dict = {}                       # every mask ANDs a loop-free plane)
    m["monotonic-writes"] = so_ww & tdep
    m["writes-follow-reads"] = so_rw & tdep \
        & ~m["monotonic-writes"]
    m["read-your-writes"] = so_wr & tdep \
        & ~m["monotonic-writes"] & ~m["writes-follow-reads"]
    m["monotonic-reads"] = so_rr & tdep \
        & ~m["monotonic-writes"] & ~m["writes-follow-reads"] \
        & ~m["read-your-writes"]
    sess = (m["monotonic-writes"] | m["writes-follow-reads"]
            | m["read-your-writes"] | m["monotonic-reads"])
    m["PRAM"] = so & p0s.T & ~sess
    m["causal"] = so & p1s.T & ~p0s.T & ~sess & ~m["PRAM"]
    m["long-fork"] = rw & lf.T & ~p0a.T
    m["G0"] = ww & cww.T
    m["G1c"] = wr & p0a.T
    m["G-single"] = rw & p0a.T
    m["G2-item"] = rw & p1a.T & ~p0a.T & ~m["long-fork"]
    m["G2-predicate"] = prw & cpred.T
    return m


def _pick(mask: np.ndarray) -> Optional[tuple]:
    if not mask.any():
        return None
    flat = int(np.argmax(mask))
    n = mask.shape[1]
    return (flat // n, flat % n)


def classify_host(stack: np.ndarray, n: Optional[int] = None) -> dict:
    """Numpy oracle over a dense [8, n, n] lattice stack."""
    if n is None:
        n = stack.shape[1]
    found: dict = {}
    if n:
        for cls, mask in _host_masks(np.asarray(stack, bool)).items():
            e = _pick(mask)
            if e is not None:
                found[cls] = e
    return {"anomalies": found, "n": int(n), "n_pad": int(n)}


# ---------------------------------------------------------------------------
# dense tier (torch on the card)
# ---------------------------------------------------------------------------

def _closure_dense(m, steps: int):
    """r | r.r to its fixpoint, at most `steps` rounds (the reference's
    fori_loop of `steps`, which the fixpoint leaves unchanged)."""
    for _ in range(steps):
        nxt = m | _sq(m, m)
        if torch.equal(nxt, m):
            break
        m = nxt
    return m


def _pair_dense(base, rwp, eye, steps: int):
    """The reference's `pair`: p0 closed first and held fixed while p1
    iterates p1 | q.p1 | p1.q (q = p0 | p1), at most `steps` rounds."""
    p0 = _closure_dense(base | eye, steps)
    p1 = rwp
    for _ in range(steps):
        q = p0 | p1
        nxt = p1 | _sq(q, p1) | _sq(p1, q)
        if torch.equal(nxt, p1):
            break
        p1 = nxt
    return p0, p1


def _dense_masks(stack):
    """The twelve masks of a padded bool [8, n_pad, n_pad] stack on its
    device (`engine.py::_dense_kernel`'s `kernel`)."""
    n_pad = stack.shape[-1]
    steps = _steps(n_pad)
    eye = torch.eye(n_pad, dtype=torch.bool, device=stack.device)
    ww, wr, rw = stack[0], stack[1], stack[2]
    so = stack[3] | stack[4] | stack[5] | stack[6]
    prw = stack[7]
    base_a = ww | wr
    cww = _closure_dense(ww, steps)
    p0a, p1a = _pair_dense(base_a, rw, eye, steps)
    p0s, p1s = _pair_dense(base_a | so, rw, eye, steps)
    cpred = _closure_dense(base_a | rw | prw, steps)
    lf = _sq(_closure_dense(_sq(wr, rw) | eye, steps), wr)
    return lattice_kernel.class_masks(
        *stack, p0a.T, p1a.T, p0s.T, p1s.T, cww.T, cpred.T, lf.T)


def classify_device(stack: np.ndarray, n: Optional[int] = None,
                    device=None, stats: Optional[dict] = None) -> dict:
    """The dense tier on `device` (the card by default): the stack
    padded to a multiple of 128, closures as bf16 products, each class's
    flat argmax, one copy to the host.  `stats`, a dict, gains transfer_s
    (pad and copy to the device) and closure_s (closures, masks and
    picks, to the edges on the host)."""
    dev = resolve_device(device)
    stack = np.asarray(stack, bool)
    if n is None:
        n = stack.shape[1]
    if not n:
        return {"anomalies": {}, "n": 0, "n_pad": 0}
    t = time.perf_counter()
    n_pad = _pad_to_tile(n)
    padded = np.zeros((len(LATTICE_PLANES), n_pad, n_pad), bool)
    padded[:, :n, :n] = stack
    planes = torch.from_numpy(padded).to(dev)
    t = _add(stats, "transfer_s", t)
    found, idx = [], []
    for mask in _dense_masks(planes):
        flat = mask.reshape(-1)
        i = torch.argmax(flat.to(torch.uint8))
        found.append(flat[i])
        idx.append(i)
    host = torch.stack([torch.stack(found).to(torch.int64),
                        torch.stack(idx)]).cpu().tolist()
    _add(stats, "closure_s", t)
    out = {cls: (i // n_pad, i % n_pad)
           for cls, f, i in zip(LATTICE_CLASSES, *host) if f}
    return {"anomalies": out, "n": int(n), "n_pad": n_pad}


# ---------------------------------------------------------------------------
# packed tier (elle_pmm rounds and lattice_masks at one card)
# ---------------------------------------------------------------------------

def closures(planes, stats: Optional[dict] = None) -> tuple:
    """(tposes, rounds): the packed transposes `lattice_kernel.masks`
    reads (p0a, p1a, p0s, p1s, cww, cpred, lf) of the eight packed
    planes (int32 [8, n_pad, W] on one device), and the rounds taken.
    The seven closures run in Jacobi rounds while a round changes
    something and rounds < ceil(log2(n_pad - 1)); then lf = cm.wr.
    `stats`, a dict, gains rounds_s (each round reads its flag on the
    host) and tpose_s (lf and the transposes, enqueued)."""
    t = time.perf_counter()
    ww, wr, rw, so_ww, so_wr, so_rw, so_rr, prw = planes
    n_pad = ww.shape[0]
    steps = _steps(n_pad)
    eye = elle_mesh._eye(n_pad, ww.device)
    base_a = ww | wr
    base_s = base_a | so_ww | so_wr | so_rw | so_rr
    state = (ww.clone(), base_a | eye, rw.clone(), base_s | eye, rw.clone(),
             base_a | rw | prw, elle_kernel.product(wr, rw) | eye)
    rounds, done, tposes = 0, False, None
    while not done and rounds < steps:
        *state, changed, tposes = lattice_kernel.lattice_round(*state)
        done = not bool(changed)
        rounds += 1
    cww, p0a, p1a, p0s, p1s, cpred, cm = state
    t = _add(stats, "rounds_s", t)
    lf = elle_kernel.product(cm, wr)
    if done:
        # the settled round's right planes are its unchanged inputs
        t_cww, t_p0a, t_p1a, t_p0s, t_p1s, t_cpred, _ = tposes
        _, (t_lf,) = elle_kernel.prepare([(lf, None)], [lf])
    else:
        # stopped at the cap: the last transposes are the previous
        # round's planes'
        _, (t_cww, t_p0a, t_p1a, t_p0s, t_p1s, t_cpred, t_lf) = \
            elle_kernel.prepare([(lf, None)],
                                [cww, p0a, p1a, p0s, p1s, cpred, lf])
    _add(stats, "tpose_s", t)
    return (t_p0a, t_p1a, t_p0s, t_p1s, t_cww, t_cpred, t_lf), rounds


def classify_packed(packed_stack: np.ndarray, n: int, device=None,
                    stats: Optional[dict] = None) -> dict:
    """The packed tier over an already-packed [8, n_pad, W] uint32 stack
    (`LatticePlanes.packed_stacked` layout, n_pad a multiple of
    `elle_mesh.mesh_tile(1)`) on `device` (the card by default): the
    closures (`closures`), the masks and one copy of the twelve edges.
    `stats`, a dict, gains transfer_s, `closures`' rounds_s and tpose_s,
    and masks_s (the masks, to the edges on the host)."""
    dev = resolve_device(device)
    packed = np.asarray(packed_stack, np.uint32)
    n_pad = packed.shape[-2]
    if n_pad % elle_mesh.mesh_tile(1):
        raise ValueError(
            f"n_pad={n_pad} not a multiple of mesh_tile(1)="
            f"{elle_mesh.mesh_tile(1)}; pad with pad_for_mesh")
    t = time.perf_counter()
    planes = elle_mesh._to_device(packed, dev)
    _add(stats, "transfer_s", t)
    tposes, rounds = closures(planes, stats)
    t = time.perf_counter()
    idx = lattice_kernel.masks(planes, tposes).tolist()
    _add(stats, "masks_s", t)
    found = {cls: (i // n_pad, i % n_pad)
             for cls, i in zip(LATTICE_CLASSES, idx)
             if i != lattice_kernel.NONE}
    return {"anomalies": found, "n": int(n), "n_pad": n_pad,
            "rounds": rounds, "shards": 1}


# ---------------------------------------------------------------------------
# witness recovery
# ---------------------------------------------------------------------------

def _bfs(adj: np.ndarray, src: int, dst: int) -> Optional[list]:
    """Shortest src -> dst path (>= 1 edge) as a node list."""
    n = adj.shape[0]
    prev = np.full(n, -1, np.int64)
    dq = deque([src])
    seen = {src}
    while dq:
        u = dq.popleft()
        for v in np.nonzero(adj[u])[0]:
            if v == dst:
                path = [int(dst), int(u)]
                while path[-1] != src:
                    path.append(int(prev[path[-1]]))
                return path[::-1]
            if int(v) not in seen:
                seen.add(int(v))
                prev[v] = u
                dq.append(int(v))
    return None


def _bfs_rw(base: np.ndarray, rw: np.ndarray, src: int,
            dst: int) -> Optional[list]:
    """Shortest src -> dst path over base|rw containing >= 1 rw edge
    (product BFS over (node, seen-rw))."""
    both = base | rw
    prev: dict = {}
    start = (src, 0)
    dq = deque([start])
    seen = {start}
    while dq:
        u, got = dq.popleft()
        for v in np.nonzero(both[u])[0]:
            v = int(v)
            g2 = 1 if (got or rw[u, v]) else 0
            if v == dst and g2:
                path = [v]
                cur = (u, got)
                while cur is not None:
                    path.append(cur[0])
                    cur = prev.get(cur)
                return path[::-1]
            st = (v, g2)
            if st not in seen:
                seen.add(st)
                prev[st] = (u, got)
                dq.append(st)
    return None


def _bfs_alt(wr: np.ndarray, rw: np.ndarray, src: int,
             dst: int) -> Optional[list]:
    """Shortest src -> dst path of shape wr.(rw.wr)*, the long-fork
    return: an automaton BFS alternating wr / rw, starting and ending
    on a wr edge."""
    prev: dict = {}
    start = (src, "wr")                # next edge must be wr
    dq = deque([start])
    seen = {start}
    while dq:
        u, expect = dq.popleft()
        plane = wr if expect == "wr" else rw
        for v in np.nonzero(plane[u])[0]:
            v = int(v)
            if v == dst and expect == "wr":
                path = [v]
                cur = (u, expect)
                while cur is not None:
                    path.append(cur[0])
                    cur = prev.get(cur)
                return path[::-1]
            st = (v, "rw" if expect == "wr" else "wr")
            if st not in seen:
                seen.add(st)
                prev[st] = (u, expect)
                dq.append(st)
    return None


def find_witness(stack: np.ndarray, cls: str, edge) -> Optional[list]:
    """A concrete cycle [a, b, ..., a] for a flagged class: the defining
    edge followed by the class's return-path relation.  None only if the
    flag was wrong (tests treat that as a failure)."""
    stack = np.asarray(stack, bool)
    ww, wr, rw = stack[0], stack[1], stack[2]
    so = stack[3] | stack[4] | stack[5] | stack[6]
    prw = stack[7]
    a, b = int(edge[0]), int(edge[1])
    if cls in _SESSION4:
        back = _bfs(ww | wr | rw, b, a)
    elif cls == "PRAM":
        back = _bfs(ww | wr | so, b, a)
    elif cls == "causal":
        back = _bfs_rw(ww | wr | so, rw, b, a)
    elif cls == "long-fork":
        back = _bfs_alt(wr, rw, b, a)
    elif cls == "G0":
        back = _bfs(ww, b, a)
    elif cls in ("G1c", "G-single"):
        back = _bfs(ww | wr, b, a)
    elif cls == "G2-item":
        back = _bfs_rw(ww | wr, rw, b, a)
    elif cls == "G2-predicate":
        back = _bfs(ww | wr | rw | prw, b, a)
    else:
        return None
    return [a] + back if back else None


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def classify(lp: LatticePlanes, algorithm: str = "auto",
             mesh_threshold: int = 4096, device=None,
             stats: Optional[dict] = None) -> tuple:
    """(row, engine, record): the planner's tier (`plan_lattice`) run on
    `device` (the card by default; not read for "host").  A failure
    raises.  `stats`, a dict, gains pack_s or stack_s (the host's
    planes for the tier) and the tier's stages."""
    record = planner.plan_lattice(lp.n, algorithm=algorithm,
                                  mesh_threshold=mesh_threshold)
    engine = record["engine"]
    t = time.perf_counter()
    if engine == "lattice-mesh":
        dev = resolve_device(device)
        packed = lp.packed_stacked(n_dev=1)
        _add(stats, "pack_s", t)
        row = classify_packed(packed, lp.n, device=dev, stats=stats)
    elif engine == "lattice-device":
        dev = resolve_device(device)
        stack = lp.stacked()
        _add(stats, "stack_s", t)
        row = classify_device(stack, lp.n, device=dev, stats=stats)
    else:
        stack = lp.stacked()
        _add(stats, "stack_s", t)
        row = classify_host(stack, lp.n)
    return row, engine, record
