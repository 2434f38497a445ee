"""Cycles and strongly connected components of a digraph on the card (the
JAX package's `ops/cycle.py`).

A transaction history's dependency graph becomes a boolean adjacency
matrix, and reachability and SCCs come from its transitive closure:

    closure:  R <- R | R.R    (rounds until one changes nothing)
    on-cycle: diag(R+)        (a node reaches itself in >= 1 step)
    SCC:      label i = min { j : R+[i,j] & R+[j,i] }  (or i itself)

The adjacency is padded to a multiple of 128 and bit-packed into int32
words by `elle_mesh.pack_planes` (bit b of word w is column 32 w + b).
Each closure round is `elle_kernel.square`: the kernels `elle_tile_bits`
and `elle_pmm` (`csrc/elle_pmm.cu`) with its change flag; the reference
runs a fixed ceil(log2(n_pad - 1)) squarings, which reach the same
closure.  The last round's `elle_tile_bits` launch also writes the
closure's packed transpose, and the hand-written kernel `cycle_labels`
(`csrc/cycle.cu`) reads both planes for the labels and the diagonal.
The closure comes to the host packed and is unpacked there in the
port's word order (`elle_mesh.unpack_bits`).

Host helpers recover one explicit cycle per SCC for error reports, by
a BFS after the device has proved a cycle exists.

Every function takes `device`, the card by default; `device="cpu"` runs
the kernels' plain versions.  `LAUNCHES` counts `cycle_labels`'
launches (the closure's are `elle_kernel.LAUNCHES`)."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.ops import cuda_build, elle_kernel, elle_mesh

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"cycle_labels": 0}


def _declare(lib):
    ptr = ctypes.c_void_p
    lib.cycle_labels_launch.argtypes = [ptr, ptr, ctypes.c_int, ptr, ptr]
    lib.cycle_labels_launch.restype = ctypes.c_int


def labels(r, t):
    """int32 [2, n_pad]: the SCC label of each node (row 0) and the
    closure's diagonal (row 1), from the packed closure r and its packed
    transpose t.  The plain version for CPU tensors, one launch of
    `cycle_labels` for CUDA tensors (or raise)."""
    dev = r.device
    n_pad = elle_kernel._check([r, t], dev)
    if dev.type == "cpu":
        return labels_plain(r, t)
    if dev.type != "cuda":
        raise ValueError(f"no cycle_labels kernel for device {dev}")
    out = torch.empty((2, n_pad), dtype=torch.int32, device=dev)
    lib = cuda_build.load("cycle", _declare)
    err = lib.cycle_labels_launch(r.data_ptr(), t.data_ptr(), n_pad,
                                  out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cycle_labels launch failed: cudaError {err} "
                           f"(n_pad={n_pad})")
    LAUNCHES["cycle_labels"] += 1
    return out


def labels_plain(r, t):
    """`labels` in plain PyTorch on r's device: unpack, (R & R.T) | eye,
    the least column of each row."""
    n_pad = r.shape[0]
    idx = torch.arange(n_pad, device=r.device)
    rb = elle_kernel.unpack(r)
    both = (rb & elle_kernel.unpack(t)) | (idx[:, None] == idx[None, :])
    lab = torch.where(both, idx[None, :], n_pad).min(1).values
    return torch.stack([lab, rb.diagonal().to(lab.dtype)]).to(torch.int32)


def closure_planes(adj: np.ndarray, dev):
    """(R+, its packed transpose, rounds) of a bool adjacency on dev, both
    packed int32 [n_pad, n_pad / 32]: rounds of `elle_kernel.square` up
    to the first that changes nothing."""
    r = torch.from_numpy(
        elle_mesh.pack_planes(adj[None])[0].view(np.int32)).to(dev)
    rounds = 0
    while True:
        nxt, changed, t = elle_kernel.square(r)
        rounds += 1
        if not bool(changed):
            return r, t, rounds
        r = nxt


def transitive_closure(adj: np.ndarray, device=None) -> np.ndarray:
    """R+ (paths of length >= 1) of a boolean adjacency matrix."""
    n = adj.shape[0]
    if n == 0:
        return np.zeros((0, 0), bool)
    r, _, _ = closure_planes(adj, resolve_device(device))
    return elle_mesh.unpack_bits(r[:n].cpu().numpy(), n)


def scc(adj: np.ndarray, device=None):
    """(labels, on_cycle, closure): the SCC label of each node (the least
    node of its component), the nodes on some cycle of length >= 1, and
    R+ (bool [n, n]), in one copy to the host."""
    n = adj.shape[0]
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, bool),
                np.zeros((0, 0), bool))
    r, t, _ = closure_planes(adj, resolve_device(device))
    n_pad = r.shape[0]
    host = torch.cat([labels(r, t).reshape(-1), r.reshape(-1)]).cpu().numpy()
    lab, diag = host[:n_pad], host[n_pad:2 * n_pad]
    closure = elle_mesh.unpack_bits(host[2 * n_pad:].reshape(n_pad, -1)[:n],
                                    n)
    return lab[:n].astype(np.int64), diag[:n].astype(bool), closure


def find_cycle(adj: np.ndarray, closure: Optional[np.ndarray] = None,
               device=None) -> Optional[list]:
    """One explicit cycle [v0, v1, ..., v0] if the graph has any, else
    None: a BFS from the lowest-indexed on-cycle node back to itself
    (the shortest such loop; parent pointers end the walk)."""
    adj = np.asarray(adj, bool)
    n = adj.shape[0]
    if n == 0:
        return None
    if closure is None:
        closure = transitive_closure(adj, device)
    diag = np.diagonal(closure)
    if not diag.any():
        return None
    start = int(np.argmax(diag))
    if adj[start, start]:
        return [start, start]
    parent = {}
    frontier = [start]
    while frontier:
        nxt = []
        for u in frontier:
            for v in map(int, np.nonzero(adj[u])[0]):
                if v == start:
                    path = [u]
                    while path[-1] != start:
                        path.append(parent[path[-1]])
                    path.reverse()
                    path.append(start)
                    return path
                if v not in parent:
                    parent[v] = u
                    nxt.append(v)
        frontier = nxt
    return None


def cycles_by_component(adj: np.ndarray, device=None) -> list:
    """One explicit cycle per non-trivial SCC (every independent anomaly,
    not just the first)."""
    adj = np.asarray(adj, bool)
    lab, on_cycle, closure = scc(adj, device)
    out = []
    for comp in np.unique(lab[on_cycle]):
        members = np.nonzero(lab == comp)[0]
        sub = adj[np.ix_(members, members)]
        cyc = find_cycle(sub, closure[np.ix_(members, members)])
        if cyc is not None:
            out.append([int(members[i]) for i in cyc])
    return out


def reachability_from(adj: np.ndarray, sources: np.ndarray,
                      device=None) -> np.ndarray:
    """Reachability of every node from a set of sources, from one
    closure."""
    closure = transitive_closure(adj, device)
    src = np.asarray(sources, bool)
    return src @ closure | src
