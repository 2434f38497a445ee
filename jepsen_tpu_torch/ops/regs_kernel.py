"""The register-delta segment scan: the CUDA kernel's wrapper, its plain
PyTorch version, the segment wire and the composition of the transfer
matrices.

Replaces `jepsen_tpu/ops/wgl_seg.py::_build_kernel_regs` (:258, an XLA
`lax.scan`) for its nc = 0 callers, with the compact-wire unpack of
`_unpack_transfer_bufs` (:522) and `_build_kernel_regs_group_c` (:641)
folded into the kernel's staging.  For every lane (segment k, entry
state j) the kernel (`jepsen_tpu_torch/csrc/wgl_regs.cu`) walks the
segment's event rows from the unit config (state j, mask 0) and writes
the transfer row T[k, j, :], the states reachable at the segment's end.

What bounds it on the H100: integer operations, and one segment's rows
walked as a dependent chain.  A lane's plane is at most 32 states by 2
words; the walk costs CLOSE_OPS operations per plane word of each
closure pass (CLOSE5_OPS per state row at slot 5) and PRUNE_OPS per
word of each prune; the wire is seven bytes a row.  The kernel puts one
CTA on each segment and one thread on each (lane, state row), so a
thread holds one row's words in registers and the OR over states is a
few shuffles inside the lane; a row's rounds stop at the fixpoint (the
source note says more).

The composition (`compose`, kernel `wgl_compose` in the same source)
steps each history's vector of entry configs through its segments'
matrices to the first that empties it: the reference's six verdict
words.

The key launch (`keys_scan`, kernel `wgl_regs_keys` in the same
source) walks many independent keys, one segment and one lane entering
state 0 a key, at exact rounds: G = 32 / SnP keys a warp and one thread
per (key, state row), each key's decisions (open slots, the rank-1
term, the returning slot) its own data under the warp's one control
flow.  It replaces `jepsen_tpu/ops/wgl_seg.py::_build_kernel_regs_many_c`
(:725).

`regs_scan`, `keys_scan` and `compose` take their plain versions
(`scan_plain`, `compose_plain`) only for tensors on the CPU; for CUDA
tensors they launch their kernels on the current stream or raise.
`LAUNCHES`, `KEYS_LAUNCHES` and `COMPOSE_LAUNCHES` count the launches
of each kernel."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from jepsen_tpu_torch.ops import cuda_build, planner
from jepsen_tpu_torch.ops.deep_kernel import _FULL, _INTRA, _check
from jepsen_tpu_torch.ops.wgl_deep import _snp as snp

#: Kernel launches since import (or since a caller reset it to 0): the
#: segment scan's, the key launch's and the composition's.
LAUNCHES = 0
KEYS_LAUNCHES = 0
COMPOSE_LAUNCHES = 0

J_MAX = 32                      # entry states per segment
J_COMPOSE_MAX = 128             # entry configs of a composed matrix
I = 2                           # invoke columns per event row of the wire
ROW_BYTES = 1 + 3 * I           # ret, I slots, I u16 uop ids
CROW_ROW_BYTES = ROW_BYTES + 2  # and an i16 crash-prefix index
#: Integer operations of the `work=` count (the bound model of PERF.md,
#: equal to the kernel's constants).  Per plane word of a closure pass of
#: slot b < 5: the lacks-slot select, the diagonal select, the shift, the
#: OR into the round's sum, the rank-1 select and the OR over states.
CLOSE_OPS = 6
#: Per state row of a slot 5 pass: no lack mask and no shift.
CLOSE5_OPS = 4
#: Per plane word of a prune: the and-not and the shift (at slot 5, per
#: state row: the move and the clear).
PRUNE_OPS = 2


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`; to a card through pinned memory, without
    waiting for the card (the caching host allocator keeps the pinned
    block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def plane_width(R: int) -> int:
    """Words per state row of a lane's plane: max(1, 2^R / 32)."""
    return max(1, (1 << R) >> 5)


def pack_stream(fk, seg_ends, n_in: int, crow=None):
    """The segment wire of one history cut at `seg_ends`, with n_in (1
    or 2) invoke columns in use: segment k's rows, up to its last
    return, in the compact layout of `wgl_deep.pack_events_compact`
    (ret+1 u8[L] ++ islot+1 u8[L*2] ++ iuop u16-LE[L*2]) with no row
    padding; an empty cell is 0.  The deltas come from
    `planner._stream_deltas`, or, for a scan that carries crashed calls
    (fk.nc > 0), from `planner._snapshot_deltas`.  With `crow` (one
    int per return: the relaxed crash tier's crash-prefix index), each
    segment's rows also carry an i16-LE index after the uop ids, 0 on
    virtual rows: CROW_ROW_BYTES a row.  Returns (cbuf u8, offs
    int64[K], nrows int32[K])."""
    if fk.nc:
        d = planner._snapshot_deltas(fk, seg_ends, fk.rn + fk.nc, n_in)
    else:
        d = planner._stream_deltas(fk, seg_ends, n_in)
    rows, rkey, rho, rs, dkey, row, col, dslot, duop = d
    size = (ROW_BYTES if crow is None else CROW_ROW_BYTES) * rows
    offs = (np.cumsum(size) - size).astype(np.int64)
    buf = np.zeros(int(size.sum()), np.uint8)
    buf[offs[rkey] + rho] = (rs + 1).astype(np.uint8)
    base, L = offs[dkey], rows[dkey]
    cell = I * row + col
    buf[base + L + cell] = (dslot + 1).astype(np.uint8)
    p = base + 3 * L + 2 * cell
    buf[p] = (duop & 0xFF).astype(np.uint8)
    buf[p + 1] = (duop >> 8).astype(np.uint8)
    if crow is not None:
        c = np.asarray(crow, np.int64)
        p = offs[rkey] + ROW_BYTES * rows[rkey] + 2 * rho
        buf[p] = (c & 0xFF).astype(np.uint8)
        buf[p + 1] = ((c >> 8) & 0xFF).astype(np.uint8)
    return buf, offs, rows.astype(np.int32)


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wgl_regs_launch.argtypes = ([ptr, ctypes.c_longlong] + [ptr] * 3
                                    + [i32] * 7 + [ptr] * 4)
    lib.wgl_regs_launch.restype = i32
    lib.wgl_keys_launch.argtypes = ([ptr, ctypes.c_longlong] + [ptr] * 3
                                    + [i32] * 5 + [ptr] * 4)
    lib.wgl_keys_launch.restype = i32
    lib.wgl_compose_launch.argtypes = [ptr, i32, ptr, ptr, i32, ptr, ptr]
    lib.wgl_compose_launch.restype = i32


def regs_scan(cbuf: torch.Tensor, offs: torch.Tensor, nrows: torch.Tensor,
              aux: torch.Tensor, *, R: int, Sn: int, UP: int, J: int,
              rounds: int, work: torch.Tensor | None = None):
    """Transfer rows of the K segments whose wires lie in `cbuf` (u8) at
    byte offsets `offs` (int64), `nrows` (int32) rows each, under one
    aux table (int32 view of diag[UP] ++ const[UP] ++ t0[UP]): overlap
    depth R (1..6), Sn model states, J entry states per segment (lane j
    enters in state j), `rounds` closure rounds per row (R is exact).
    Returns (T u8[K, J, Sn], bad i32[1]): bad counts segments the kernel
    refused (rows outside cbuf, a uop id outside the table, a slot at or
    past R) and whose rows it did not write; on the CPU such input
    raises instead.  `work`, an optional int64[K], receives the integer
    operations of each segment's walk over its J lanes (CLOSE_OPS,
    CLOSE5_OPS and PRUNE_OPS per plane word or state row, over the Sn
    rows that hold configs; each lane's rounds up to the first that
    leaves its plane unchanged).  CUDA tensors launch on the current
    stream and do not synchronise; CPU tensors run the plain version."""
    global LAUNCHES
    dev, K = _check_wire(cbuf, offs, nrows, aux, R=R, Sn=Sn, UP=UP, J=J,
                         rounds=rounds, work=work)
    if dev.type == "cpu":
        out = scan_plain(cbuf, offs, nrows, aux, R=R, Sn=Sn, UP=UP, J=J,
                         rounds=rounds, work=work)
        return out, torch.zeros(1, dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no segment kernel for device {dev}")
    out = torch.empty((K, J, Sn), dtype=torch.uint8, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    if K == 0:
        return out, bad
    lib = cuda_build.load("wgl_regs", _declare)
    err = lib.wgl_regs_launch(
        cbuf.data_ptr(), cbuf.numel(), offs.data_ptr(), nrows.data_ptr(),
        aux.data_ptr(), UP, K, R, snp(Sn), Sn, J, rounds, out.data_ptr(),
        None if work is None else work.data_ptr(), bad.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgl_regs launch failed: cudaError {err} "
                           f"(K={K} R={R} Sn={Sn} J={J} rounds={rounds})")
    LAUNCHES += 1
    return out, bad


def keys_scan(cbuf: torch.Tensor, offs: torch.Tensor, nrows: torch.Tensor,
              aux: torch.Tensor, *, R: int, Sn: int, UP: int,
              work: torch.Tensor | None = None):
    """The key launch: `regs_scan`'s function at J = 1 and rounds = R,
    each of the K segments a key (lane 0 enters state 0), through the key
    kernel (`wgl_regs_keys`: 32 / snp(Sn) keys a warp, one warp a CTA).
    Returns (T u8[K, 1, Sn], bad i32[1]): bad counts the keys the kernel
    refused (rows outside cbuf, a uop id outside the table, a slot
    at or past R), whose rows and counts it did not write; on the CPU
    such input raises instead.
    `work`, an optional int64[K], receives each key's integer operations
    as `regs_scan` counts them.  CUDA tensors launch on the current
    stream and do not synchronise; CPU tensors run the plain version
    (`scan_plain` at J = 1)."""
    global KEYS_LAUNCHES
    dev, K = _check_wire(cbuf, offs, nrows, aux, R=R, Sn=Sn, UP=UP, J=1,
                         rounds=R, work=work)
    if dev.type == "cpu":
        out = scan_plain(cbuf, offs, nrows, aux, R=R, Sn=Sn, UP=UP, J=1,
                         rounds=R, work=work)
        return out, torch.zeros(1, dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no key kernel for device {dev}")
    out = torch.empty((K, 1, Sn), dtype=torch.uint8, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    if K == 0:
        return out, bad
    lib = cuda_build.load("wgl_regs", _declare)
    err = lib.wgl_keys_launch(
        cbuf.data_ptr(), cbuf.numel(), offs.data_ptr(), nrows.data_ptr(),
        aux.data_ptr(), UP, K, R, snp(Sn), Sn, out.data_ptr(),
        None if work is None else work.data_ptr(), bad.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgl_regs_keys launch failed: cudaError {err} "
                           f"(K={K} R={R} Sn={Sn})")
    KEYS_LAUNCHES += 1
    return out, bad


def _check_wire(cbuf, offs, nrows, aux, *, R, Sn, UP, J, rounds, work):
    """The device and segment count K of a scan's inputs; raises
    ValueError on a type, device or size the kernels do not take."""
    dev = cbuf.device
    _check(cbuf, "cbuf", torch.uint8, dev)
    _check(offs, "offs", torch.int64, dev)
    _check(nrows, "nrows", torch.int32, dev)
    _check(aux, "aux", torch.int32, dev)
    K = offs.numel()
    if nrows.numel() != K or aux.numel() != 3 * UP:
        raise ValueError("offs/nrows/aux sizes disagree")
    if work is not None:
        _check(work, "work", torch.int64, dev)
        if work.numel() != K:
            raise ValueError("work must hold one count per segment")
    if not (1 <= R <= planner.REGS_R_MAX and 1 <= Sn <= planner.REGS_SN_MAX
            and 1 <= J <= J_MAX and 1 <= rounds <= R and UP >= 1):
        raise ValueError(f"unsupported kernel shape R={R} Sn={Sn} J={J} "
                         f"rounds={rounds} UP={UP}")
    return dev, K


# ---------------------------------------------------------------------------
# The plain version: the same walk in PyTorch, every segment at once
# ---------------------------------------------------------------------------

def _or_states(x: torch.Tensor) -> torch.Tensor:
    """OR over dim 2 (the SnP state rows, a power of two)."""
    while x.shape[2] > 1:
        h = x.shape[2] // 2
        x = x[:, :, :h] | x[:, :, h:]
    return x[:, :, 0]


class Wire(NamedTuple):
    """A segment wire decoded for the plain versions: row r of segment k
    is live when r < nrows[k]; ret, isl[i] and iu[i] are [K, Lmax]
    (slot returned or registered, -1 for none, and the uop id), and
    crow the rows' crash-prefix indices (with `crow=True`)."""
    Lmax: int
    live: torch.Tensor
    ret: torch.Tensor
    isl: list
    iu: list
    crow: Optional[torch.Tensor]


def decode_wire(cbuf, offs, nrows, *, R: int, UP: int,
                crow: bool = False) -> Wire:
    """Decode K segments of the wire (ROW_BYTES a row, CROW_ROW_BYTES
    with `crow`).  Raises ValueError where a kernel counts a bad
    segment: rows outside cbuf, a uop id outside the table, a slot at or
    past R."""
    dev = cbuf.device
    K = offs.numel()
    L = nrows.to(torch.int64)
    n = cbuf.numel()
    rb = CROW_ROW_BYTES if crow else ROW_BYTES
    if K and bool(((L < 0) | (offs < 0) | (offs + rb * L > n)).any()):
        raise ValueError("a segment's rows lie outside cbuf")
    Lmax = int(L.max()) if K else 0
    r = torch.arange(Lmax, device=dev)
    live = r[None, :] < L[:, None]                       # [K, Lmax]
    wire = cbuf.to(torch.int64)

    def at(pos):
        return torch.where(live, wire[pos.clamp(0, max(n - 1, 0))], 0)

    def u16(pos):
        return at(pos) | (at(pos + 1) << 8)

    o2, L2 = offs[:, None], L[:, None]
    ret = at(o2 + r) - 1
    isl = [at(o2 + L2 + I * r + i) - 1 for i in range(I)]
    iu = [u16(o2 + 3 * L2 + 2 * (I * r + i)) for i in range(I)]
    for i in range(I):
        if bool(((isl[i] >= 0) & ((iu[i] >= UP) | (isl[i] >= R))).any()):
            raise ValueError("an invoke names a uop outside the table or a "
                             "slot past R")
    if bool((ret >= R).any()):
        raise ValueError("a return names a slot past R")
    cr = None
    if crow:
        cr = u16(o2 + ROW_BYTES * L2 + 2 * r)
        cr = torch.where(cr >= 1 << 15, cr - (1 << 16), cr)
    return Wire(Lmax, live, ret, isl, iu, cr)


def uop_table(aux, UP: int):
    """(a1, a2, t0) int64[UP] each from the aux table: the diagonal and
    rank-1 masks and the rank-1 target state of every uop."""
    tab = aux.to(torch.int64) & _FULL
    return tab[:UP], tab[UP:2 * UP], tab[2 * UP:3 * UP]


def new_slots(K: int, R: int, dev):
    """Empty slot registers: (a1, a2, t0 int64[K, R], open bool[K, R])."""
    return tuple(torch.zeros((K, R), dtype=torch.int64, device=dev)
                 for _ in range(3)) + (
        torch.zeros((K, R), dtype=torch.bool, device=dev),)


def register(wire: Wire, row: int, tab, UP: int, slots):
    """The slot registers (a1, a2, t0 int64[K, R], open bool[K, R])
    after the row's invokes."""
    a1r, a2r, t0r, openr = slots
    bits = torch.arange(a1r.shape[1], device=a1r.device)
    for i in range(I):
        m = wire.isl[i][:, row, None] == bits           # [K, R]
        u = wire.iu[i][:, row].clamp(0, UP - 1)
        a1r = torch.where(m, tab[0][u][:, None], a1r)
        a2r = torch.where(m, tab[1][u][:, None], a2r)
        t0r = torch.where(m, tab[2][u][:, None], t0r)
        openr = openr | m
    return a1r, a2r, t0r, openr


def _half_words(WD: int, q: int):
    """The word columns that hold bit q of the word index, and their
    partners that lack it."""
    hi = [w for w in range(WD) if (w >> q) & 1]
    return hi, [w ^ (1 << q) for w in hi]


def slot_pass(fr: torch.Tensor, b: int, a1, a2, t0) -> torch.Tensor:
    """The configs one pass of slot b adds to the planes fr (int64[K, J,
    SnP, WD] of 32-bit words; a1, a2, t0 int64[K], the slot's uop): the
    configs lacking b, moved along the diagonal (a1) and into state t0
    (the OR over the states of a2), with b set.  Slot b < 5 moves bits
    inside a word, slot b >= 5 between the words of bit b - 5."""
    zero = torch.zeros((), dtype=torch.int64, device=fr.device)
    s_idx = torch.arange(fr.shape[2], device=fr.device)
    dm = ((a1[:, None] >> s_idx) & 1).bool()[:, None, :, None]
    cm = ((a2[:, None] >> s_idx) & 1).bool()[:, None, :, None]
    tm = (s_idx[None, :] == t0[:, None])[:, None, :, None]
    if b < 5:
        c = fr & _INTRA[b]
    else:
        hi, lo = _half_words(fr.shape[3], b - 5)
        c = fr[..., lo]
    red = _or_states(torch.where(cm, c, zero))
    moved = torch.where(dm, c, zero) | torch.where(tm, red[:, :, None, :],
                                                   zero)
    if b < 5:
        return (moved << (1 << b)) & _FULL
    out = torch.zeros_like(fr)
    out[..., hi] = moved
    return out


def retire(fr: torch.Tensor, b: int) -> torch.Tensor:
    """The planes after slot b returns: the configs lacking b pruned and
    b's bit cleared."""
    if b < 5:
        return (fr & (_INTRA[b] ^ _FULL)) >> (1 << b)
    hi, lo = _half_words(fr.shape[3], b - 5)
    out = torch.zeros_like(fr)
    out[..., lo] = fr[..., hi]
    return out


def round_ops(opened: torch.Tensor, Sn: int, WD: int) -> torch.Tensor:
    """Integer operations of one round of the open slots (bool[K, R]),
    per lane: CLOSE_OPS per word of a slot b < 5 pass, CLOSE5_OPS per
    state row of each receiving word (half the words) at b >= 5."""
    lo = opened[:, :5].sum(1)
    return (lo * CLOSE_OPS * Sn * WD
            + (opened.sum(1) - lo) * CLOSE5_OPS * Sn * max(1, WD // 2))


def prune_ops(rs: torch.Tensor, Sn: int, WD: int) -> torch.Tensor:
    """Integer operations of the returns rs (int64[K], -1 for none), per
    lane: PRUNE_OPS per word (per receiving word at b >= 5)."""
    return torch.where(rs >= 5, PRUNE_OPS * Sn * max(1, WD // 2),
                       torch.where(rs >= 0, PRUNE_OPS * Sn * WD, 0))


def scan_plain(cbuf: torch.Tensor, offs: torch.Tensor, nrows: torch.Tensor,
               aux: torch.Tensor, *, R: int, Sn: int, UP: int, J: int,
               rounds: int, work: torch.Tensor | None = None,
               need: torch.Tensor | None = None):
    """`regs_scan`'s function in plain PyTorch on cbuf's device: all K
    segments walk their rows in step, a segment past its own row count
    standing still.  The planes are int64[K, J, SnP, WD] holding 32-bit
    words; a round is the reference's Jacobi round (every open slot's
    pass reads the plane before the round), and a row's rounds end once
    a round changes no lane (a round that adds nothing leaves every
    later one nothing to add).  Each lane's count charges its rounds up
    to the first that leaves its plane unchanged, at most `rounds`.
    `need`, an optional int64[K], receives the same count without the
    rounds past a row's open-slot count: a config takes at most one
    linearization a round and one a slot, so those rounds add nothing
    and the walk does not need them (the key kernel skips them; the
    segment kernel runs them).  Raises ValueError where the kernel would
    count a bad segment."""
    dev = cbuf.device
    K = offs.numel()
    SnP, WD = snp(Sn), plane_width(R)
    wire = decode_wire(cbuf, offs, nrows, R=R, UP=UP)
    tab = uop_table(aux, UP)
    fr = torch.zeros((K, J, SnP, WD), dtype=torch.int64, device=dev)
    for j in range(min(J, SnP)):
        fr[:, j, j, 0] = 1
    slots = new_slots(K, R, dev)
    ops = torch.zeros((K, J), dtype=torch.int64, device=dev)
    nops = torch.zeros((K, J), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    for row in range(wire.Lmax):
        slots = register(wire, row, tab, UP, slots)
        a1r, a2r, t0r, openr = slots
        opened = openr & wire.live[:, row, None]
        if bool(opened.any()):
            per_round = round_ops(opened, Sn, WD)[:, None]
            run = opened.any(1)[:, None].expand(K, J)
            nopen = opened.sum(1)[:, None]
            for rd in range(rounds):
                add = torch.zeros_like(fr)
                for b in range(R):
                    ob = opened[:, b]
                    if bool(ob.any()):
                        lin = slot_pass(fr, b, a1r[:, b], a2r[:, b],
                                        t0r[:, b])
                        add = add | torch.where(ob[:, None, None, None],
                                                lin, zero)
                ops += torch.where(run, per_round, 0)
                nops += torch.where(run & (rd < nopen), per_round, 0)
                run = run & (add & ~fr != 0).flatten(2).any(2)
                fr = fr | add
                if not bool(run.any()):
                    break               # every lane at its fixpoint
        rs = wire.ret[:, row]
        for b in range(R):
            mb = rs == b
            if bool(mb.any()):
                fr = torch.where(mb[:, None, None, None], retire(fr, b), fr)
                openr[:, b] &= ~mb
        pruned = prune_ops(rs, Sn, WD)[:, None]
        ops += pruned
        nops += pruned
    if work is not None:
        work.copy_(ops.sum(1))
    if need is not None:
        need.copy_(nops.sum(1))
    return (fr[:, :, :Sn, 0] & 1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Composition: each history's chain of transfer matrices
# ---------------------------------------------------------------------------

def compose(T: torch.Tensor, seg_counts) -> torch.Tensor:
    """The reference's six verdict words per history from the transfer
    matrices of its segments: T is u8[sum(seg_counts), J, J] (0/1, the
    segments of history b consecutive, seg_counts[b] >= 1 of them, J <=
    128: the crash variant's Sn * 2^nc entry configs).  Returns
    int32[B, 6]: valid, the first dead segment (-1 if valid), and the
    128-bit entry-config mask of the dead segment (the configs reachable
    at the cut before it; entry config 0 when it is the first; 0 when
    valid).

    Only row 0 of the reference's prefix products is read, so each
    history is a chain of one vector through its matrices (kernel
    `wgl_compose` in csrc/wgl_regs.cu, one CTA per history: every warp
    stages the matrices as bits, one warp walks the chain).  CUDA
    tensors launch it on the current stream without synchronising; CPU
    tensors run the plain version (`compose_plain`)."""
    global COMPOSE_LAUNCHES
    dev = T.device
    counts = [int(c) for c in seg_counts]
    B = len(counts)
    if (T.dtype != torch.uint8 or T.dim() != 3 or T.shape[1] != T.shape[2]
            or not T.is_contiguous()):
        raise ValueError(f"T must be a contiguous u8[K, J, J] tensor, got "
                         f"{T.dtype} {tuple(T.shape)}")
    J = T.shape[1]
    if not (B and 1 <= J <= J_COMPOSE_MAX and min(counts) >= 1
            and sum(counts) == T.shape[0]):
        raise ValueError(f"unsupported composition: J={J}, {T.shape[0]} "
                         f"matrices for segment counts {counts[:8]}")
    if dev.type == "cpu":
        return compose_plain(T, counts)
    if dev.type != "cuda":
        raise ValueError(f"no composition kernel for device {dev}")
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    first_t = to_device(first, dev)
    count_t = to_device(np.asarray(counts, np.int32), dev)
    out = torch.empty((B, 6), dtype=torch.int32, device=dev)
    lib = cuda_build.load("wgl_regs", _declare)
    err = lib.wgl_compose_launch(
        T.data_ptr(), J, first_t.data_ptr(), count_t.data_ptr(), B,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgl_compose launch failed: cudaError {err} "
                           f"(B={B} J={J})")
    COMPOSE_LAUNCHES += 1
    return out


def compose_plain(T: torch.Tensor, seg_counts) -> torch.Tensor:
    """`compose`'s function in plain PyTorch on T's device: every
    history's vector steps through its segments together, v <- (v @
    T_k) > 0, a history past its own count standing still."""
    dev = T.device
    counts = torch.as_tensor(list(seg_counts), dtype=torch.int64,
                             device=dev)
    B, J = counts.numel(), T.shape[1]
    first = torch.cumsum(counts, 0) - counts
    Tb = T.bool()
    v = torch.zeros((B, J), dtype=torch.bool, device=dev)
    v[:, 0] = True
    entry = torch.zeros_like(v)
    dead = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for k in range(int(counts.max())):
        on = k < counts
        Tk = Tb[first + torch.minimum(counts - 1,
                                      torch.full_like(counts, k))]
        nv = torch.where(on[:, None], (v[:, :, None] & Tk).any(1), v)
        died = on & (dead < 0) & ~nv.any(1)
        entry = torch.where(died[:, None], v, entry)
        dead = torch.where(died, k, dead)
        v = nv
    valid = dead < 0
    jj = torch.arange(J, device=dev)
    bit = entry.to(torch.int64) << (jj % 32)
    words = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    words.index_add_(1, jj // 32, bit)
    words = (words + 2 ** 31) % 2 ** 32 - 2 ** 31        # as int32 bits
    return torch.cat([valid.to(torch.int64)[:, None], dead[:, None],
                      words], 1).to(torch.int32)
