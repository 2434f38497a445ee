"""Typed-cycle classification on the card: Elle's DSG phase as batched
boolean products (the JAX package's `ops/elle_graph.py`, the dense
tier).

Isolation classification needs to know which **edge-type combination**
closes a cycle (Adya):

    G0        cycle of ww edges only
    G1c       cycle of ww ∪ wr containing ≥ 1 wr
    G-single  cycle containing exactly one rw (anti-dependency)
    G2-item   cycle containing ≥ 2 rw

Each history arrives as a stack of boolean adjacency planes
(`elle.infer.PLANES`: ww, wr, rw, po, rt); planes pad to 128-aligned
tiles and histories group by their own tile size, so one bucket is one
batch of products over its histories.

The classification trick, *masked closures*: each class is decided by
whether some defining edge (a, b) has a return path b ⇒ a through a
restricted plane union:

    G0        (a,b) ∈ ww,  b ⇒ a via ww ∪ O          (O = po/rt planes)
    G1c       (a,b) ∈ wr,  b ⇒ a via ww ∪ wr ∪ O
    G-single  (a,b) ∈ rw,  b ⇒ a via ww ∪ wr ∪ O     (zero further rw)
    G2-item   (a,b) ∈ rw,  b ⇒ a via the full plane **using ≥ 1 rw**,
              and (a,b) closes NO zero-rw return (priority: an edge
              already explained as G-single cannot define a G2;
              closures count walks, and a single-rw cycle walked twice
              would otherwise masquerade as a ≥2-rw cycle)

The ≥1-rw reachability is a two-plane closure: carry (P0, P1) =
(paths with zero rw, paths with ≥ one rw) and square the pair:
P1 ← P1 ∨ P0·P1 ∨ P1·P0 ∨ P1·P1.  The card returns only per-class flags
and ONE defining edge per class (the flat argmax over the mask, the
lowest (a, b) in row-major order), so the copy to the host is O(B), not
O(B·n²); the host then walks one explicit cycle witness per anomaly
over the planes it already holds (`find_witness`).

The products are plain large matrix products, as the reference left
them to XLA: `torch.matmul` on bf16 0/1 operands (a positive count
never rounds to zero, so the `> 0.5` threshold is exact), batched over
a bucket's histories.  Each closure stops at its fixpoint (at most
ceil(log2(n_pad - 1)) rounds); the reference always runs that many, and
the closure is the same.

`classify_host` is the independent naive oracle (numpy closures + BFS)
the tests hold the tiers against, and the engine of
`Elle(algorithm="host")`."""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.elle.infer import PLANES

_TILE = 128

ANOMALY_CLASSES = ("G0", "G1c", "G-single", "G2-item")


def _add(stats, key, t0) -> float:
    """Add the seconds since t0 to stats[key] (stats may be None);
    returns now."""
    t = time.perf_counter()
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + t - t0
    return t


def _pad_to_tile(n: int) -> int:
    return max(_TILE, _TILE * math.ceil(n / _TILE))


def _steps(n_pad: int) -> int:
    return max(1, math.ceil(math.log2(max(n_pad - 1, 2))))


def _sq(a, b):
    """Boolean product of two bool [B, n, n] batches: bf16 0/1 operands
    through torch.matmul, thresholded."""
    return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)) > 0.5


def _closure(adj, steps: int):
    """Transitive closure of a bool [B, n, n] batch: r | r.r to its
    fixpoint, at most `steps` rounds."""
    for _ in range(steps):
        nxt = adj | _sq(adj, adj)
        if torch.equal(nxt, adj):
            break
        adj = nxt
    return adj


def _pair_closure(a, r, steps: int):
    """(reach with 0 rw, reach with ≥1 rw) over plane a ∪ r where only
    r-edges count as rw.  P0 seeds with identity so length-0
    prefixes/suffixes compose."""
    n_pad = a.shape[-1]
    p0 = a | torch.eye(n_pad, dtype=torch.bool, device=a.device)
    p1 = r
    for _ in range(steps):
        n0 = p0 | _sq(p0, p0)
        n1 = p1 | _sq(p0, p1) | _sq(p1, p0) | _sq(p1, p1)
        if torch.equal(n0, p0) and torch.equal(n1, p1):
            break
        p0, p1 = n0, n1
    return p0, p1


def _pick(masks):
    """(found bool [B, C], edges int64 [B, C, 2]) for one edge of each
    bool [B, C, n, n] mask: the flat argmax, the lowest (a, b) in
    row-major order."""
    b, c, n_pad, _ = masks.shape
    flat = masks.reshape(b, c, -1)
    idx = torch.argmax(flat.to(torch.uint8), dim=-1)
    found = flat.gather(-1, idx[..., None])[..., 0]
    return found, torch.stack([idx // n_pad, idx % n_pad], dim=-1)


def _classify(planes):
    """Flags and defining edges of a padded bool [B, len(PLANES), n, n]
    batch on its device."""
    ww, wr, rw, po, rt = (planes[:, i] for i in range(len(PLANES)))
    steps = _steps(planes.shape[-1])
    order = po | rt
    c_ww = _closure(ww | order, steps)
    c_wwr = _closure(ww | wr | order, steps)
    _, p1 = _pair_closure(ww | wr | order, rw, steps)
    c_ww_t, c_wwr_t = c_ww.transpose(1, 2), c_wwr.transpose(1, 2)
    # Priority masking (the "which combination first closes a cycle"
    # rule): the pair closure counts WALKS, so a G-single cycle
    # traversed twice would read as a ≥2-rw cycle; an rw edge that
    # already closes with zero further rw (G-single) therefore cannot
    # define a G2-item.
    masks = torch.stack([ww & c_ww_t,                       # G0
                         wr & c_wwr_t,                      # G1c
                         rw & c_wwr_t,                      # G-single
                         rw & p1.transpose(1, 2) & ~c_wwr_t],  # G2-item
                        dim=1)
    return _pick(masks)


def _pad_stack(stacks: Sequence[np.ndarray], n_pad: int) -> np.ndarray:
    out = np.zeros((len(stacks), len(PLANES), n_pad, n_pad), bool)
    for i, s in enumerate(stacks):
        n = s.shape[-1]
        out[i, :, :n, :n] = s
    return out


def classify_batch(stacks: Sequence[np.ndarray], include_order: bool = True,
                   device=None, stats: Optional[dict] = None) -> list:
    """Classify MANY histories on `device` (the card by default), one
    batch of products per SHAPE BUCKET.

    stacks: one [len(PLANES), n, n] bool array per history (n may
    differ).  Histories group by their own 128-aligned tile size, so a
    stray 10k-txn history costs its 1k-txn batchmates nothing.
    include_order: include the po/rt planes in every combination
    (strict/strong-session variants); when False they are zeroed.

    Returns one dict per history (input order preserved):
      {"anomalies": {cls: (a, b) defining edge}, "n": n, "n_pad": int}
    `stats`, a dict, gains the seconds of each stage: pack_s (padding
    the stacks on the host), transfer_s (to the device) and closure_s
    (the closures, masks and picks, to the edges on the host).
    """
    if not stacks:
        return []
    dev = resolve_device(device)
    buckets: dict = {}
    for i, s in enumerate(stacks):
        buckets.setdefault(_pad_to_tile(s.shape[-1]), []).append(i)
    out: list = [None] * len(stacks)
    for n_pad in sorted(buckets):
        idxs = buckets[n_pad]
        t = time.perf_counter()
        batch = _pad_stack([stacks[i] for i in idxs], n_pad)
        if not include_order:
            batch[:, 3:, :, :] = False
        t = _add(stats, "pack_s", t)
        planes = torch.from_numpy(batch).to(dev)
        t = _add(stats, "transfer_s", t)
        found, edges = _classify(planes)
        found, edges = found.cpu().numpy(), edges.cpu().numpy()
        _add(stats, "closure_s", t)
        for j, i in enumerate(idxs):
            anomalies = {cls: (int(edges[j, c, 0]), int(edges[j, c, 1]))
                         for c, cls in enumerate(ANOMALY_CLASSES)
                         if bool(found[j, c])}
            out[i] = {"anomalies": anomalies, "n": stacks[i].shape[-1],
                      "n_pad": n_pad}
    return out


# ---------------------------------------------------------------------------
# Host oracle: an independent formulation (numpy closure + BFS), the
# differential baseline and the engine of algorithm="host".
# ---------------------------------------------------------------------------

def _mm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # f32, not uint8: path counts overflow a byte past n=255 and can
    # wrap to exactly 0, silently erasing reachability
    return a.astype(np.float32) @ b.astype(np.float32) > 0


def closure_reference(stack: np.ndarray,
                      include_order: bool = True) -> tuple:
    """Cold pair-closure triple (cww, p0, p1) of one dense
    [len(PLANES), n, n] bool stack, computed to the unconditional
    fixpoint with the packed tier's exact update rule (the oracle the
    packed closure is held against)."""
    ww, wr, rw, po, rt = (np.asarray(stack[i], bool)
                          for i in range(len(PLANES)))
    n = ww.shape[-1]
    order = (po | rt) if include_order else np.zeros_like(ww)
    eye = np.eye(n, dtype=bool)
    cww = ww | order
    p0 = ww | wr | order | eye
    p1 = rw.copy()
    while True:
        q = p0 | p1
        cww2 = cww | _mm(cww, cww)
        p0n = p0 | _mm(p0, p0)
        p1n = p1 | _mm(q, p1) | _mm(p1, q)
        if (np.array_equal(cww2, cww) and np.array_equal(p0n, p0)
                and np.array_equal(p1n, p1)):
            return cww, p0, p1
        cww, p0, p1 = cww2, p0n, p1n


class _HostDeadline(Exception):
    pass


def classify_host(stack: np.ndarray, include_order: bool = True,
                  deadline_s: Optional[float] = None) -> dict:
    """Naive host classification of ONE history's plane stack —
    same output row shape as classify_batch.

    deadline_s caps the wall clock: the O(n^3 log n) numpy closure
    takes minutes at large sizes, so past the budget it returns an
    `unknown` degradation row ({"unknown": True, "degraded":
    "host-deadline"}) instead of finishing hours later or passing."""
    t0 = time.monotonic()

    def tick():
        if (deadline_s is not None
                and time.monotonic() - t0 > deadline_s):
            raise _HostDeadline

    ww, wr, rw, po, rt = (stack[i] for i in range(len(PLANES)))
    n = ww.shape[-1]
    if n == 0:
        return {"anomalies": {}, "n": 0, "n_pad": 0}
    order = (po | rt) if include_order else np.zeros_like(ww)
    steps = max(1, math.ceil(math.log2(max(n - 1, 2))))
    try:
        tick()
        c_ww = ww | order
        for _ in range(steps):
            c_ww = c_ww | _mm(c_ww, c_ww)
            tick()
        c_wwr = ww | wr | order
        for _ in range(steps):
            c_wwr = c_wwr | _mm(c_wwr, c_wwr)
            tick()
        # ≥1-rw reachability via the same pair recurrence
        p0 = (ww | wr | order) | np.eye(n, dtype=bool)
        p1 = rw.copy()
        for _ in range(steps):
            n0 = p0 | _mm(p0, p0)
            n1 = p1 | _mm(p0, p1) | _mm(p1, p0) | _mm(p1, p1)
            p0, p1 = n0, n1
            tick()
    except _HostDeadline:
        return {"anomalies": {}, "n": n, "n_pad": n, "unknown": True,
                "degraded": "host-deadline", "deadline_s": deadline_s,
                "elapsed_s": round(time.monotonic() - t0, 3)}
    masks = {"G0": ww & c_ww.T, "G1c": wr & c_wwr.T,
             "G-single": rw & c_wwr.T,
             "G2-item": rw & p1.T & ~c_wwr.T}
    found = {}
    for cls, m in masks.items():
        if m.any():
            a, b = np.unravel_index(int(np.argmax(m)), m.shape)
            found[cls] = (int(a), int(b))
    return {"anomalies": found, "n": n, "n_pad": n}


# ---------------------------------------------------------------------------
# Witness recovery: a host walk, O(cycle), after the device proved it
# ---------------------------------------------------------------------------

def _bfs_path(adj: np.ndarray, src: int, dst: int) -> Optional[list]:
    """Shortest path src -> dst (length ≥ 1) over a boolean adjacency
    matrix, or None."""
    parent = {src: None}
    frontier = [src]
    while frontier:
        nxt = []
        for u in frontier:
            for v in map(int, np.nonzero(adj[u])[0]):
                if v == dst:
                    path = [v, u]
                    while parent[path[-1]] is not None:
                        path.append(parent[path[-1]])
                    path.reverse()
                    return path
                if v not in parent:
                    parent[v] = u
                    nxt.append(v)
        frontier = nxt
    return None


def _bfs_path_with_rw(base: np.ndarray, rw: np.ndarray,
                      src: int, dst: int) -> Optional[list]:
    """Path src -> dst over base ∪ rw that uses ≥ 1 rw edge: BFS over
    the (node, seen-rw) product graph."""
    full = base | rw
    start = (src, False)
    parent: dict = {start: None}
    frontier = [start]
    while frontier:
        nxt = []
        for u, seen in frontier:
            for v in map(int, np.nonzero(full[u])[0]):
                s2 = seen or bool(rw[u, v])
                if v == dst and s2:
                    path = [(v, s2), (u, seen)]
                    while parent[path[-1]] is not None:
                        path.append(parent[path[-1]])
                    path.reverse()
                    return [p for p, _ in path]
                if (v, s2) not in parent:
                    parent[(v, s2)] = (u, seen)
                    nxt.append((v, s2))
        frontier = nxt
    return None


def find_witness(stack: np.ndarray, cls: str, edge,
                 include_order: bool = True) -> Optional[list]:
    """One explicit cycle [a, b, ..., a] for a device-found anomaly:
    the defining edge (a, b) plus the restricted return path b ⇒ a.
    G-single's return path must avoid rw; G2-item's must include one."""
    ww, wr, rw, po, rt = (stack[i] for i in range(len(PLANES)))
    order = (po | rt) if include_order else np.zeros_like(ww)
    a, b = int(edge[0]), int(edge[1])
    if cls == "G0":
        back = _bfs_path(ww | order, b, a)
    elif cls in ("G1c", "G-single"):
        back = _bfs_path(ww | wr | order, b, a)
    elif cls == "G2-item":
        back = _bfs_path_with_rw(ww | wr | order, rw, b, a)
    else:
        raise ValueError(f"unknown anomaly class {cls!r}")
    if back is None:
        return None
    return [a] + back
