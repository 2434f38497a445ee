"""The bit-packed Elle closure tier on one card (the JAX package's
`ops/elle_mesh.py` at one device).

`ops.elle_graph` decides the Adya classes on dense plane stacks; its
products hold n x n bf16 operands.  This tier keeps every plane
bit-packed and decides the same classes with the same masked-closure
semantics:

**Bit-packed planes.**  A boolean plane row packs 32 columns a word
(bit b of word w is column w*32 + b), so a resident plane costs n^2/8
bytes, 8x below the dense bool stack and 16x below a bf16 operand.
Plane unions (ww|wr|order...) are bitwise ORs on the packed words.  The
closure's products run on the packed words in the hand-written kernel
`elle_pmm` (`ops.elle_kernel`), so device memory never holds a dense
plane during the rounds.

**Early exit.**  The closure state is monotone, so the fixpoint is
detected exactly: a round that changes nothing ends the loop.  Clean
histories with short dependency diameters settle in about
log2(diameter) rounds instead of the full log2(n) schedule; `rounds`
is reported per history.

One pair closure carries everything the four class masks need:

    cww       closure of ww|order                 (G0)
    p0        reflexive closure of ww|wr|order    (zero-rw paths;
              off-diagonal it IS c_wwr, and defining edges are never
              diagonal)                            (G1c, G-single)
    p1        >=1-rw paths over ww|wr|order|rw    (G2-item, priority-
              masked by ~p0.T exactly as the dense engine)

    round:  cww <- cww | cww.cww
            p0  <- p0  | p0.p0
            p1  <- p1  | q.p1 | p1.q      (q = p0|p1)

Each round reads the old triple and writes a new one (Jacobi), as the
reference's while_loop does, so `rounds` equals the reference's.  The
transpose, the masks and the defining-edge pick after the last round
are torch ops over the packed words.  The rows are the reference's
`classify_packed` rows at one device (`shards: 1`).  The warm and
incremental entries, the packed host oracle and witness, and more than
one device are ROADMAP P7 and P8."""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.ops import elle_kernel
from jepsen_tpu_torch.ops.elle_graph import _add

_TILE = 128
#: Rows of a plane the transpose unpacks at a time.
_TPOSE_ROWS = 1024

ANOMALY_CLASSES = ("G0", "G1c", "G-single", "G2-item")


# ---------------------------------------------------------------------------
# Packed layout (host side, numpy)
# ---------------------------------------------------------------------------

def mesh_tile(n_dev: int) -> int:
    """Row-count granularity a D-device mesh needs (rows split evenly,
    every shard offset on a word boundary); 128 at one device."""
    return int(np.lcm(_TILE, 32 * max(1, int(n_dev))))


def pad_for_mesh(n: int, n_dev: int = 1) -> int:
    t = mesh_tile(n_dev)
    return max(t, t * math.ceil(n / t))


def plane_nbytes(n: int, packed: bool = True) -> int:
    """Resident bytes for one n x n boolean plane."""
    return (n * n) // 8 if packed else n * n


def pack_bits(dense) -> np.ndarray:
    """bool [..., n] -> uint32 [..., ceil32(n)] (bit b of word w is
    column w*32+b): little-endian bit order within little-endian bytes,
    viewed as words."""
    dense = np.asarray(dense, bool)
    n = dense.shape[-1]
    out = np.zeros(dense.shape[:-1] + (4 * math.ceil(n / 32),), np.uint8)
    out[..., :math.ceil(n / 8)] = np.packbits(dense, axis=-1,
                                              bitorder="little")
    return out.view("<u4").astype(np.uint32, copy=False)


def unpack_bits(packed, n: int) -> np.ndarray:
    """uint32 (or int32) [..., W] -> bool [..., n], the inverse of
    `pack_bits`."""
    packed = np.asarray(packed)
    if packed.dtype != np.int32:
        packed = packed.astype(np.uint32, copy=False)
    raw = np.ascontiguousarray(packed, packed.dtype.newbyteorder("<"))
    return np.unpackbits(raw.view(np.uint8), axis=-1, count=n,
                         bitorder="little").view(bool)


def pack_planes(stack, n_pad: Optional[int] = None,
                n_dev: int = 1) -> np.ndarray:
    """Dense [P, n, n] bool plane stack -> packed uint32
    [P, n_pad, n_pad/32] padded for an n_dev-row mesh."""
    stack = np.asarray(stack, bool)
    p, n, _ = stack.shape
    if n_pad is None:
        n_pad = pad_for_mesh(n, n_dev)
    out = np.zeros((p, n_pad, n_pad // 32), np.uint32)
    if n:
        out[:, :n, :math.ceil(n / 32)] = pack_bits(stack)
    return out


def set_bits(plane: np.ndarray, src, dst) -> None:
    """Sparse edge insertion into one packed plane [n_pad, W]:
    plane[src, dst//32] |= 1 << (dst%32), as np.bitwise_or.at over
    raveled word indices (the reference's numpy form; its native
    word-OR gives the same bytes)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if not len(src):
        return
    W = plane.shape[-1]
    masks = (np.uint32(1) << (dst & 31).astype(np.uint32))
    if plane.flags.c_contiguous:
        words = src * np.int64(W) + (dst >> 5)
        np.bitwise_or.at(plane.reshape(-1), words, masks)
        return
    np.bitwise_or.at(plane, (src, dst >> 5), masks)


# ---------------------------------------------------------------------------
# On the device (torch over int32 words)
# ---------------------------------------------------------------------------

def _to_device(packed: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(packed, np.uint32).view(np.int32)).to(dev)


def _eye(n_pad: int, dev) -> torch.Tensor:
    rows = torch.arange(n_pad, device=dev)
    out = torch.zeros((n_pad, n_pad // 32), dtype=torch.int32, device=dev)
    bit = torch.ones(n_pad, dtype=torch.int64, device=dev) << (rows % 32)
    out[rows, rows // 32] = torch.where(bit >= 1 << 31, bit - (1 << 32),
                                        bit).to(torch.int32)
    return out


def tpose(plane: torch.Tensor) -> torch.Tensor:
    """Packed transpose: out[a, bit b] = plane[b, bit a], unpacking
    at most _TPOSE_ROWS rows at a time."""
    n_pad, w = plane.shape
    out = torch.empty_like(plane)
    for k0 in range(0, n_pad, _TPOSE_ROWS):
        k1 = min(k0 + _TPOSE_ROWS, n_pad)
        bits = elle_kernel.unpack(plane[k0:k1])        # [k1 - k0, n_pad]
        out[:, k0 // 32:k1 // 32] = elle_kernel.pack(bits.T)
    return out


def pick(masks: torch.Tensor) -> list:
    """[(found, a, b)] of each packed mask [C, n_pad, W]: the lowest
    (a, b) in row-major order, as the reference's `pick` and the dense
    tier's flat argmax (one copy to the host)."""
    c, n_pad, w = masks.shape
    flat = masks.reshape(c, -1)
    nz = (flat != 0).to(torch.uint8)
    idx = torch.argmax(nz, dim=1)
    word = flat.gather(1, idx[:, None])[:, 0]
    host = torch.stack([idx.to(torch.int64), word.to(torch.int64)]).cpu()
    out = []
    for i, wd in zip(host[0].tolist(), host[1].tolist()):
        wd &= 0xFFFFFFFF
        if not wd:
            out.append((False, 0, 0))
            continue
        bit = (wd & -wd).bit_length() - 1
        out.append((True, i // w, (i % w) * 32 + bit))
    return out


def closure(ww, wr, rw, od, steps: int):
    """The pair closure's Jacobi rounds with the early exit: (cww, p0,
    p1, rounds)."""
    n_pad = ww.shape[0]
    cww = ww | od
    p0 = ww | wr | od | _eye(n_pad, ww.device)
    p1 = rw.clone()
    rounds, done = 0, False
    while not done and rounds < steps:
        cww, p0, p1, changed = elle_kernel.closure_round(cww, p0, p1)
        done = not bool(changed)
        rounds += 1
    return cww, p0, p1, rounds


def classify_packed(packed_stacks: Sequence[np.ndarray], ns: Sequence[int],
                    include_order: bool = True, device=None,
                    stats: Optional[dict] = None) -> list:
    """Classify histories whose planes are ALREADY bit-packed
    ([len(PLANES), n_pad, n_pad/32] uint32 each, `pack_planes` /
    `set_bits` layout, n_pad a multiple of `mesh_tile(1)`), one history
    at a time on `device` (the card by default).  Returns one row per
    history: {"anomalies": {cls: (a, b)}, "n", "n_pad", "rounds",
    "shards"}.  `stats`, a dict, gains the seconds of each stage:
    transfer_s (the packed planes to the device), rounds_s (the closure;
    each round reads its change flag on the host) and tpose_pick_s (the
    transposes, masks and picks, to the edges on the host)."""
    dev = resolve_device(device)
    out = []
    for packed, n in zip(packed_stacks, ns):
        packed = np.asarray(packed, np.uint32)
        n_pad = packed.shape[-2]
        if n_pad % mesh_tile(1):
            raise ValueError(
                f"n_pad={n_pad} not a multiple of mesh_tile(1)="
                f"{mesh_tile(1)}; pad with pad_for_mesh")
        t = time.perf_counter()
        planes = _to_device(packed, dev)
        ww, wr, rw = planes[0], planes[1], planes[2]
        od = (planes[3] | planes[4]) if include_order \
            else torch.zeros_like(ww)
        t = _add(stats, "transfer_s", t)
        steps = max(1, math.ceil(math.log2(max(n_pad - 1, 2))))
        cww, p0, p1, rounds = closure(ww, wr, rw, od, steps)
        t = _add(stats, "rounds_s", t)
        t_cww, t_p0, t_p1 = tpose(cww), tpose(p0), tpose(p1)
        # G0, G1c, G-single, G2-item; the planes have no diagonal, so
        # p0's eye is inert
        masks = torch.stack([ww & t_cww, wr & t_p0, rw & t_p0,
                             rw & t_p1 & ~t_p0])
        found = {cls: (a, b) for cls, (f, a, b)
                 in zip(ANOMALY_CLASSES, pick(masks)) if f}
        _add(stats, "tpose_pick_s", t)
        out.append({"anomalies": found, "n": int(n), "n_pad": n_pad,
                    "rounds": rounds, "shards": 1})
    return out


def classify_mesh(stacks: Sequence[np.ndarray], include_order: bool = True,
                  device=None, inferences=None,
                  stats: Optional[dict] = None) -> list:
    """Dense-stack front door (the checker's path): packs each
    [len(PLANES), n, n] bool stack and classifies it on the packed tier.
    Output rows match `elle_graph.classify_batch` plus `rounds` and
    `shards`.  With `inferences` (the elle.infer.Inference objects the
    stacks came from), the packed planes are built by sparse word
    insertion from their edge lists (Inference.packed_stacked) instead
    of re-packing the dense stacks; the bytes are equal.  `stats` gains
    pack_s (the host packing) and `classify_packed`'s stages."""
    t = time.perf_counter()
    if inferences is not None:
        packed = [inf.packed_stacked(n_dev=1) for inf in inferences]
    else:
        packed = [pack_planes(s, n_dev=1) for s in stacks]
    _add(stats, "pack_s", t)
    return classify_packed(packed, [s.shape[-1] for s in stacks],
                           include_order=include_order, device=device,
                           stats=stats)


def packed_product(a_dense, b_dense, device=None) -> np.ndarray:
    """Test pin: the packed boolean product of two dense bool matrices
    on `device`, returned dense (must equal `(a @ b) > 0`)."""
    dev = resolve_device(device)
    a = np.asarray(a_dense, bool)
    n = a.shape[0]
    ap = _to_device(pack_planes(a[None])[0], dev)
    bp = _to_device(pack_planes(np.asarray(b_dense, bool)[None])[0], dev)
    out = elle_kernel.product(ap, bp).cpu().numpy().view(np.uint32)
    return unpack_bits(out, n)[:n]
