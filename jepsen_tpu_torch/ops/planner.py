"""Host-side planning of the device path: the scope gates of both
kernels, the fused history scan, quiescent-cut segmentation, state
enumeration, the transition decomposition and the table packers.
Copies of the numpy code in `jepsen_tpu.ops.planner` (kept
byte-identical, and tested so), with the state enumeration's
jitted vmap replaced by the model's torch `step` over a written-out
[states x ops] batch on the CPU.

The scan of a history without crashed calls runs in C
(`jepsen_tpu_torch/native/histscan.c`, built at first use): over the
history's columns when it carries them (`_native_scan_cols`, and
`_native_scan_streams`, which also writes the segment wire), else over
its Op objects (`_native_scan`); `_scan_history` picks.  A history the
C scan refuses raises what the pure-Python `_fast_scan` raises for it;
`_fast_scan` stays as the plain version the C scan is held against and
as the scan that carries crashed calls.

Routing is the reference's: the register-delta segment kernel where
`regs_gate` passes (R <= 6), the deep kernel where `deep_gate` passes
(R 7..16), the candidate-table kernels of `plan`'s tables where
`cand_gate` names a form (R <= 10, Sn <= 64), and every other shape
raises `Unsupported` naming the ROADMAP item that will cover it.  Crashed calls (an :info completion,
or none) are found by `_split_crashed`; the scan carries up to
MAX_CRASHED of them as permanent slots above the normal ones when asked
(`_fast_scan(max_crashed=...)`), `crash_gate` says whether the segment
kernel's crash variant takes them, and `_snapshot_deltas` writes their
segment wire.

`plan_elle` picks the Elle checker's tier (dense or bit-packed closure
on the card, or the numpy oracle when asked), as the reference's
`plan_elle` heads its chain."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from jepsen_tpu_torch import native
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.history import History

# ROADMAP items that own the shapes the port refuses.  The batched
# engines' refusals name P5: the serial frontier engine (ops.wgl), which
# Linearizable, check_many and the deep pipeline fall to, and the
# candidate-table engines still to port.
ITEM_SERIAL = ("ROADMAP P5 (the serial frontier engine ops.wgl, and the "
               "wgl_batch and candidate-table engines)")
ITEM_CPU_AUTO = ("ROADMAP P6 (competition mode and auto routing to the "
                 "CPU oracle)")
ITEM_RUNNER = ("ROADMAP P4R (the resilient batch runner: OOM bisection, "
               "quarantine, deadlines, checkpoints)")
ITEM_ANALYSES = ("ROADMAP P7 (the other analyses, with the checkers above "
                 "them)")
ITEM_MESH = "ROADMAP P8 (multi-device tiers)"

#: Overlap depth one [Sn, 512]-word plane covers; past it the plane is
#: a stack of DEEP_SPLIT_MAX base-sized sub-planes (R = 15/16).
DEEP_R_BASE = 14
DEEP_SPLIT_MAX = 4
DEEP_SN_MAX = 32


def deep_split_planes(R: int) -> int:
    """Sub-plane count of the word-split plane at overlap depth R
    (1 = a single plane).  The CUDA kernel keeps one flat plane of
    2^R / 32 words per state row; this count is kept for the result's
    provenance keys, which the reference reports."""
    return 1 << max(0, int(R) - DEEP_R_BASE)


def deep_r_max() -> int:
    """The deepest overlap one device checks: the base plane plus the
    word-split stack."""
    return DEEP_R_BASE + (DEEP_SPLIT_MAX.bit_length() - 1)


def deep_gate(R: int, Sn: int, U: int, decomposed: bool) -> Optional[str]:
    """Why the deep kernel cannot check this shape exactly, or None:
    it takes decomposable models with Sn <= 32 at any R <= deep_r_max().
    Which device runs it is `backend.resolve_device`'s decision: the
    card, or the CPU (the plain version) only when the caller names
    it; no env knob widens or narrows either."""
    if not decomposed:
        return ("model transitions are not diagonal + rank-1 "
                f"decomposable: {ITEM_SERIAL}")
    if not 0 < R <= deep_r_max():
        return (f"overlap depth R={R} is outside 1..{deep_r_max()}: "
                f"{ITEM_SERIAL}")
    if Sn > DEEP_SN_MAX:
        return (f"{Sn} model states exceed the deep kernel's "
                f"{DEEP_SN_MAX}: {ITEM_SERIAL}")
    if U > 32767:
        return f"{U} distinct ops exceed the u16 wire: {ITEM_SERIAL}"
    return None


#: Deepest overlap the register-delta segment kernel takes (fixed
#: closure rounds stay exact there, and a lane's plane is at most two
#: words per state), and the most model states its masks hold.
REGS_R_MAX = 6
REGS_SN_MAX = 32


def regs_gate(R: int, Sn: int, U: int, decomposed: bool) -> Optional[str]:
    """Why the register-delta segment kernel cannot take this shape, or
    None: the reference's `_regs_eligible` at its defaults (R <= 6, uop
    ids in the u16 wire, a decomposed model with Sn <= 32).  The
    reference's nibble form for undecomposed models (Sn <= 8) has no
    model in this package and is not ported."""
    return _segment_gate(R, REGS_R_MAX, Sn, U, decomposed)


def _segment_gate(R: int, r_max: int, Sn: int, U: int, decomposed: bool,
                  sn_max: int = REGS_SN_MAX) -> Optional[str]:
    """The gate of the register-delta kernels; `sn_max` 64 is the
    relaxed crash tier's two-word lift."""
    if not decomposed:
        return ("model transitions are not diagonal + rank-1 "
                f"decomposable: {ITEM_SERIAL}")
    if not 0 < R <= r_max:
        return (f"overlap depth R={R} is outside the segment kernel's "
                f"1..{r_max}")
    if Sn > sn_max:
        return (f"{Sn} model states exceed the segment kernel's "
                f"{sn_max}: {ITEM_SERIAL}")
    if U > 32767:
        return f"{U} distinct ops exceed the u16 wire: {ITEM_SERIAL}"
    return None


#: Crashed calls the segment kernel carries as permanent slots (each
#: doubles its entry axis, J = Sn * 2^nc), the deepest R + nc it walks
#: with them, and the widest entry axis (the reference's _MAX_CRASHED,
#: r_cap = 8 and Sn * 2^nc <= 128).
MAX_CRASHED = 4
CRASH_R_MAX = 8
CRASH_J_MAX = 128


def crash_gate(R: int, nc: int, Sn: int, U: int,
               decomposed: bool) -> Optional[str]:
    """Why the segment kernel cannot carry nc crashed calls as permanent
    slots above a normal overlap depth R, or None: the reference's
    `_linear_candidates` for its register-delta engine with crashes
    (nc <= 4, R + nc <= 8, a decomposed model with Sn <= 32, uop ids in
    the u16 wire, Sn * 2^nc <= 128).  A refused shape goes to the deep
    kernel at R + nc when `deep_gate` passes."""
    if nc > MAX_CRASHED:
        return (f"{nc} crashed calls exceed the segment kernel's "
                f"{MAX_CRASHED}")
    why = _segment_gate(R + nc, CRASH_R_MAX, Sn, U, decomposed)
    if why is None and (Sn << nc) > CRASH_J_MAX:
        why = (f"the crash entry axis Sn*2^nc={Sn << nc} exceeds "
               f"{CRASH_J_MAX}")
    return why


class CrashedCalls(Unsupported):
    """The history has crashed calls (an :info completion, or none) and
    the scan was not asked to carry them, or more than it was asked to:
    `wgl_seg.check`'s crash tiers take such a history."""


class _FastKey:
    """One scanned history: rets[r] = (slot, [(open_slot, open_uop),
    ...]) per return event, the open set at that return (target
    included), or, from the C scanners, the same as flat int32 arrays
    (ret_slots, cand_counts, cand_slots, cand_uops); `deltas` (C only)
    holds (d_counts, d_slots, d_uops), the calls invoked since the
    previous return, per return in invocation order.  `cuts[r]` marks
    returns after which no normal call is open; `positions[r]` is the op
    position of return r in history.ops, which names the failing call of
    an invalid verdict exactly.  A scan that carries crashed calls sets
    `nc` (their count) and `rn` (the first crashed slot, the normal
    overlap depth): crashed call j holds slot rn + j and joins every
    open set from its invoke onward."""

    __slots__ = ("rets", "max_open", "n_calls", "cuts", "positions", "nc",
                 "rn", "arrays", "deltas")

    def __init__(self, rets, max_open, n_calls, cuts=None, positions=None,
                 nc=0, rn=None, arrays=None, deltas=None):
        self.rets = rets
        self.max_open = max_open
        self.n_calls = n_calls
        self.cuts = cuts
        self.positions = positions
        self.nc = nc
        self.rn = rn
        self.arrays = arrays
        self.deltas = deltas

    @property
    def n_rets(self):
        return (len(self.arrays[0]) if self.arrays is not None
                else len(self.rets))


def _fast_scan(history, spec, seen: dict, rows: list,
               max_open_bits: int, max_crashed: int = 0) -> _FastKey:
    """Pairing + slot assignment + op interning in one pass over the
    ops, in Python: the plain version of the C scanners, and the scan
    that carries crashed calls (`max_crashed`).  Raises CrashedCalls
    for more than `max_crashed` crashed calls, Unsupported for another
    history outside the slice (overlap past
    max_open_bits, ops the model cannot encode) and ValueError for a
    malformed one (a process invoked twice).  Up to `max_crashed`
    crashed calls take permanent slots above the normal ones (see
    _FastKey.nc / .rn); cuts count normal open calls only.  The shared
    seen/rows interning is touched only on success."""
    ops = history.ops if isinstance(history, History) else \
        History(history).ops
    f_codes = spec.f_codes

    # Pass 1: completion for each invocation position.
    open_by_process: dict = {}
    fate: dict = {}
    n_client = 0
    for pos, o in enumerate(ops):
        p = o.process
        if not (type(p) is int and p >= 0):
            continue
        n_client += 1
        if o.type == "invoke":
            if p in open_by_process:
                raise ValueError(f"process {p} double-invoked at {pos}")
            open_by_process[p] = pos
        else:
            ip = open_by_process.pop(p, None)
            if ip is not None:
                fate[ip] = o
    if open_by_process and max_crashed == 0:
        raise CrashedCalls("history has calls that never return")
    if n_client == 0:
        return _FastKey([], 0, 0, cuts=np.zeros(0, np.int32),
                        positions=np.zeros(0, np.int32))

    # Pass 2: slots + interning + return records.
    new_seen: dict = {}
    new_rows: list = []
    free: list = []
    next_slot = 0
    slot_of: dict = {}
    uop_of: dict = {}
    open_list: list = []
    crashed_list: list = []          # [(pseudo-slot -2 - j, uop), ...]
    rets: list = []
    cuts: list = []
    positions: list = []
    max_open = 0
    n_calls = 0
    INT32 = 2 ** 31
    for pos, o in enumerate(ops):
        p = o.process
        if not (type(p) is int and p >= 0):
            continue
        t = o.type
        if t == "invoke":
            comp = fate.get(pos)
            crashed = comp is None or comp.type == "info"
            if crashed and len(crashed_list) >= max_crashed:
                raise CrashedCalls("history has crashed (:info) calls")
            if not crashed and comp.type == "fail":
                continue             # the pair never happened: dropped
            v = o.value if (o.value is not None or comp is None) \
                else comp.value
            fc = f_codes.get(o.f, -1)
            if fc < 0:
                raise Unsupported(f"model has no f-code for {o.f!r}: "
                                  f"{ITEM_SERIAL}")
            # isinstance (not exact-type) checks, so int subclasses
            # encode by value as the oracle compares them
            if isinstance(v, bool):
                av, bv, okv = int(v), 0, True
            elif isinstance(v, int):
                av, bv, okv = v, 0, True
            elif isinstance(v, (list, tuple)) and len(v) == 2 \
                    and isinstance(v[0], int) and isinstance(v[1], int) \
                    and not isinstance(v[0], bool) \
                    and not isinstance(v[1], bool):
                av, bv, okv = v[0], v[1], True
            else:
                av, bv, okv = 0, 0, False
            if not (-INT32 <= av < INT32 and -INT32 <= bv < INT32):
                raise Unsupported(f"op value {v!r} exceeds the int32 "
                                  f"device range: {ITEM_SERIAL}")
            key = (fc, av, bv, okv)
            u = seen.get(key)
            if u is None:
                u = new_seen.get(key)
            if u is None:
                u = new_seen[key] = len(rows) + len(new_rows)
                new_rows.append(key)
            if crashed:
                # a permanent pseudo-slot, remapped to rn + j at the end
                crashed_list.append((-2 - len(crashed_list), u))
                n_calls += 1
                continue
            s = free.pop() if free else next_slot
            if s == next_slot:
                next_slot += 1
            slot_of[p] = s
            uop_of[p] = u
            open_list.append(p)
            if len(open_list) > max_open:
                max_open = len(open_list)
                if max_open > max_open_bits:
                    raise Unsupported(
                        f"more than max_open_bits={max_open_bits} "
                        f"simultaneously-open calls: {ITEM_SERIAL}")
            n_calls += 1
        elif t == "ok":
            s = slot_of.get(p)
            if s is None:
                continue
            rets.append((s, [(slot_of[q], uop_of[q])
                             for q in open_list] + crashed_list))
            positions.append(pos)
            open_list.remove(p)
            del slot_of[p]
            del uop_of[p]
            free.append(s)
            cuts.append(1 if not open_list else 0)

    seen.update(new_seen)
    rows.extend(new_rows)
    nc = len(crashed_list)
    if nc:
        rn = max_open
        rets = [(s, [(q if q >= 0 else rn - 2 - q, u) for q, u in cands])
                for s, cands in rets]
        return _FastKey(rets, max_open, n_calls,
                        cuts=np.asarray(cuts, np.int32),
                        positions=np.asarray(positions, np.int32), nc=nc,
                        rn=rn)
    return _FastKey(rets, max_open, n_calls,
                    cuts=np.asarray(cuts, np.int32),
                    positions=np.asarray(positions, np.int32))


def _split_crashed(ops):
    """The crashed client calls of one history (an :info completion, or
    no completion), in invocation order: (drop bool[n], crashed), where
    drop marks each crashed invoke and its :info completion and crashed
    lists (invoke position, :info position or -1, invoke op).  Raises
    ValueError for a process invoked twice."""
    open_by_process: dict = {}
    info_of: dict = {}
    for pos, o in enumerate(ops):
        p = o.process
        if not (type(p) is int and p >= 0):
            continue
        if o.type == "invoke":
            if p in open_by_process:
                raise ValueError(f"process {p} double-invoked at {pos}")
            open_by_process[p] = pos
        else:
            ip = open_by_process.pop(p, None)
            if ip is not None and o.type == "info":
                info_of[ip] = pos
    crashed_pos = sorted(set(open_by_process.values()) | set(info_of))
    drop = np.zeros(len(ops), bool)
    crashed = []
    for ip in crashed_pos:
        cp = info_of.get(ip, -1)
        drop[ip] = True
        if cp >= 0:
            drop[cp] = True
        crashed.append((ip, cp, ops[ip]))
    return drop, crashed


def _encode_op(op, f_codes) -> tuple[int, int, int, bool]:
    """An op's (f, a, b, a_ok) encoding from its own value: an int in a,
    an [a, b] pair across both, None or anything else not-ok (the
    reference's `wgl._generic_encode_op`)."""
    fc = f_codes.get(op.f, -1)
    v = op.value
    if isinstance(v, bool):
        return fc, int(v), 0, True
    if isinstance(v, int):
        return fc, v, 0, True
    if (isinstance(v, (list, tuple)) and len(v) == 2
            and all(isinstance(x, int) and not isinstance(x, bool)
                    for x in v)):
        return fc, v[0], v[1], True
    return fc, 0, 0, False


def _intern_crashed(crashed, spec, seen: dict, rows: list) -> list:
    """Intern each crashed call's invoke op beside the scanned ops, so
    the state enumeration closes over both.  Returns one uop id per
    crashed call, -1 for an op the model cannot encode (never inert)."""
    out = []
    INT32 = 2 ** 31
    for _, _, o in crashed:
        fc, av, bv, okv = _encode_op(o, spec.f_codes)
        if fc < 0 or not (-INT32 <= av < INT32 and -INT32 <= bv < INT32):
            out.append(-1)
            continue
        key = (fc, av, bv, okv)
        u = seen.get(key)
        if u is None:
            u = seen[key] = len(rows)
            rows.append(key)
        out.append(u)
    return out


def _segment_ends(cut_flags: np.ndarray, target: int) -> list:
    """Greedy quiescent-cut segmentation over returns: cut_flags[r]
    marks quiescence after return r; a segment closes at the first
    quiescent return >= `target` returns in, and the last cut always
    closes the tail.  Returns the exclusive end return of each
    segment."""
    target = max(int(target), 1)
    pos = np.nonzero(np.asarray(cut_flags))[0]
    if not len(pos):
        return []
    last = int(pos[-1])
    ends: list = []
    start = 0
    while True:
        j = np.searchsorted(pos, start + target - 1, side="left")
        if j >= len(pos):
            break
        c = int(pos[j])
        ends.append(c + 1)
        start = c + 1
    if not ends or ends[-1] != last + 1:
        ends.append(last + 1)
    return ends


def _compose_transfer(T: np.ndarray, Sn: int) -> int:
    """Compose transfer matrices left-to-right from entry state 0
    (K tiny matvecs); returns the first dead segment or -1."""
    v = np.zeros(Sn, bool)
    v[0] = True
    for k in range(T.shape[0]):
        v = v @ T[k]
        if not v.any():
            return k
    return -1


def _fk_arrays(fk: _FastKey):
    """Flat (ret_slots, cand_counts, cand_slots, cand_uops) arrays of
    either scanner form."""
    if fk.arrays is not None:
        return fk.arrays
    rs = np.fromiter((r[0] for r in fk.rets), np.int32,
                     count=len(fk.rets))
    counts = np.fromiter((len(r[1]) for r in fk.rets), np.int32,
                         count=len(fk.rets))
    cs = np.fromiter((s for _, cands in fk.rets for s, _ in cands),
                     np.int32)
    cu = np.fromiter((u for _, cands in fk.rets for _, u in cands),
                     np.int32)
    return rs, counts, cs, cu


# ---------------------------------------------------------------------------
# The C scanners' wrappers
# ---------------------------------------------------------------------------

def columns_of(history):
    """The history's attached (or journaled) columns, or None."""
    return history.packed_columns() if isinstance(history, History) \
        else None


def _refuse(why: int, at: int, ops, max_open_bits: int):
    """The exception `_fast_scan` raises for a C scan's refusal (reason
    code `why` of histscan.c at op position `at`)."""
    if why == 1:
        return ValueError(f"process {ops[at].process} double-invoked at "
                          f"{at}")
    if why == 2:
        return CrashedCalls("history has calls that never return")
    if why == 3:
        return CrashedCalls("history has crashed (:info) calls")
    if why == 4:
        return Unsupported(f"model has no f-code for {ops[at].f!r}: "
                           f"{ITEM_SERIAL}")
    if why == 5:
        return Unsupported(f"op value {ops[at].value!r} exceeds the int32 "
                           f"device range: {ITEM_SERIAL}")
    if why == 6:
        return Unsupported(f"more than max_open_bits={max_open_bits} "
                           f"simultaneously-open calls: {ITEM_SERIAL}")
    raise AssertionError(f"unknown scan refusal {why}")


def _i32(b) -> np.ndarray:
    return np.frombuffer(b, np.int32)


def _fastkey_from_native(out) -> _FastKey:
    n_calls, max_open, rs, counts, cs, cu, cuts, dc, ds, du, pos = out
    return _FastKey(None, max_open, n_calls, cuts=_i32(cuts),
                    positions=_i32(pos),
                    arrays=(_i32(rs), _i32(counts), _i32(cs), _i32(cu)),
                    deltas=(_i32(dc), _i32(ds), _i32(du)))


def _op_list(ops) -> list:
    if isinstance(ops, History):
        return ops.ops
    return ops if isinstance(ops, list) else list(ops)


def _native_scan(ops, spec, seen: dict, rows: list,
                 max_open_bits: int) -> _FastKey:
    """`_fast_scan` of a crash-free history in C, over its Op objects
    (histscan.c `fast_scan`): the same fields, and the same exception
    where the history is outside the scan."""
    ops = _op_list(ops)
    why, out = native.histscan().fast_scan(ops, spec.f_codes, seen, rows,
                                           max_open_bits)
    if why:
        raise _refuse(why, out, ops, max_open_bits)
    return _fastkey_from_native(out)


def _cols_args(packed, spec):
    """The six contiguous column buffers the C column scanners take, or
    None for columns packed without value kinds (a custom encoder).  The
    spec-independent casts are cached on `packed` (`_scan_cols`), keyed
    by (packed.version, len(packed)): an in-place edit that bumps the
    version (History.invalidate_packed), or a length change, rebuilds
    them.  Only fmap, each op's model f-code, depends on the spec."""
    if packed is None or packed.vkind is None:
        return None
    nf = len(packed.f_codes)
    fcol = packed.f
    if nf == 0:
        fmap = np.full(len(fcol), -1, np.int32)
    else:
        f2spec = np.full(nf, -1, np.int32)
        for tag, hid in packed.f_codes.items():
            code = spec.f_codes.get(tag)
            if code is not None and 0 <= hid < nf:
                f2spec[hid] = code
        fmap = np.where((fcol >= 0) & (fcol < nf),
                        f2spec[np.clip(fcol, 0, nf - 1)],
                        np.int32(-1)).astype(np.int32, copy=False)
    tag = (packed.version, len(packed))
    cached = getattr(packed, "_scan_cols", None)
    fixed = cached[1] if cached is not None and cached[0] == tag else None
    if fixed is None:
        # values of vkind 4 wrap here; the scan refuses them unread
        fixed = (np.ascontiguousarray(packed.process, dtype=np.int32),
                 np.ascontiguousarray(packed.type, dtype=np.uint8),
                 np.ascontiguousarray(packed.value[:, 0].astype(np.int32)),
                 np.ascontiguousarray(packed.value[:, 1].astype(np.int32)),
                 np.ascontiguousarray(packed.vkind, dtype=np.uint8))
        packed._scan_cols = (tag, fixed)
    return (fixed[0], fixed[1], np.ascontiguousarray(fmap), fixed[2],
            fixed[3], fixed[4])


#: histscan.c's refusal of columns that cannot name a client process
#: (history.P_OUT_OF_RANGE): the object scan takes the history.
_REFUSE_COLUMNS = 7


def _native_scan_cols(packed, ops, spec, seen: dict, rows: list,
                      max_open_bits: int,
                      want_snaps: bool = True) -> Optional[_FastKey]:
    """`_native_scan` over the history's columns (histscan.c
    `fast_scan_cols`): no Op object is read unless the history is
    refused, when `ops` (the same history's ops) name the op in the
    message.  Returns None where the columns cannot carry the history
    (no value kinds, a client process outside int32): the object scan
    takes it.  `want_snaps=False` leaves cand_slots and cand_uops empty,
    for callers that read only the delta stream."""
    cols = _cols_args(packed, spec)
    if cols is None:
        return None
    why, out = native.histscan().fast_scan_cols(
        *cols, seen, rows, max_open_bits, 1 if want_snaps else 0)
    if why == _REFUSE_COLUMNS:
        return None
    if why:
        raise _refuse(why, out, _op_list(ops), max_open_bits)
    return _fastkey_from_native(out)


class _StreamKey:
    """The stream scan's product: one crash-free history's scan already
    cut into segments and written as the segment wire
    (`regs_kernel.pack_stream(fk, seg_ends, 1)`'s layout), with the
    fields of a _FastKey that the pipeline reads."""

    __slots__ = ("n_calls", "max_open", "n_rets", "wire", "seg_ends",
                 "positions")
    nc = 0

    def __init__(self, n_calls, max_open, n_rets, wire, seg_ends,
                 positions):
        self.n_calls = n_calls
        self.max_open = max_open
        self.n_rets = n_rets
        self.wire = wire            # (cbuf u8, offs int64[K], nrows i32[K])
        self.seg_ends = seg_ends
        self.positions = positions


def _native_scan_streams(packed, ops, spec, seen: dict, rows: list,
                         max_open_bits: int,
                         target: int) -> Optional[_StreamKey]:
    """One C pass from the history's columns to its segment wire
    (histscan.c `fast_scan_streams`): the scan, the quiescent cuts of
    `_segment_ends(cuts, target)` and the I = 1 wire, each return's new
    invokes in invocation order.  Returns None where the columns cannot
    carry the history; raises as `_native_scan_cols`."""
    cols = _cols_args(packed, spec)
    if cols is None:
        return None
    why, out = native.histscan().fast_scan_streams(
        *cols, seen, rows, max_open_bits, target)
    if why == _REFUSE_COLUMNS:
        return None
    if why:
        raise _refuse(why, out, _op_list(ops), max_open_bits)
    n_calls, max_open, n_rets, cbuf, offs, nrows, seg_ends, pos = out
    return _StreamKey(n_calls, max_open, n_rets,
                      (np.frombuffer(cbuf, np.uint8),
                       np.frombuffer(offs, np.int64), _i32(nrows)),
                      _i32(seg_ends), _i32(pos))


def _scan_history(packed, ops, spec, seen: dict, rows: list,
                  max_open_bits: int, want_snaps: bool = True) -> _FastKey:
    """The scan every entry point runs on a history without crashed
    calls: the C column scan when the history carries columns
    (`packed`, from `columns_of`), else (or where the columns cannot
    carry it) the C object scan over `ops`.  Raises as `_fast_scan`:
    CrashedCalls, Unsupported, or ValueError for a double invoke."""
    fk = None
    if packed is not None:
        fk = _native_scan_cols(packed, ops, spec, seen, rows,
                               max_open_bits, want_snaps)
    if fk is None:
        fk = _native_scan(ops, spec, seen, rows, max_open_bits)
    return fk


def _enumerate_states(spec, init_state: np.ndarray, uops: np.ndarray,
                      max_states: int):
    """Close {init} under every distinct op's legal transition.  Returns
    (states int32[Sn, S], legal bool[U, Sn], next int32[U, Sn]).  The
    model step runs on CPU tensors: the state space is tiny."""
    U = uops.shape[0]
    cols = torch.from_numpy(np.ascontiguousarray(uops, np.int32))
    f, a, b, ok = cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3] != 0

    def expand(states: np.ndarray):
        # [n, S] -> ([U, n, S] states', [U, n] legal), op-major
        n, S = states.shape
        st = torch.from_numpy(states).repeat(U, 1)
        st2, legal = spec.step(st, f.repeat_interleave(n),
                               a.repeat_interleave(n),
                               b.repeat_interleave(n),
                               ok.repeat_interleave(n))
        return (st2.reshape(U, n, S).numpy(),
                legal.reshape(U, n).numpy())

    table: dict[bytes, int] = {}
    states: list[np.ndarray] = []

    def intern(row: np.ndarray) -> int:
        key = row.tobytes()
        idx = table.get(key)
        if idx is None:
            idx = table[key] = len(states)
            states.append(row)
        return idx

    intern(np.asarray(init_state, np.int32))
    frontier = 0
    while frontier < len(states):
        if len(states) > max_states:
            raise Unsupported(
                f"model state space exceeds max_states={max_states}: "
                f"{ITEM_SERIAL}")
        batch = np.stack(states[frontier:], 0)
        frontier = len(states)
        st2, legal = expand(batch)
        for u in range(U):
            for j in range(st2.shape[1]):
                if legal[u, j]:
                    intern(st2[u, j].astype(np.int32))

    state_arr = np.stack(states, 0).astype(np.int32)
    Sn = state_arr.shape[0]
    st2, legal = expand(state_arr)
    next_state = np.zeros((U, Sn), np.int32)
    for u in range(U):
        for s in range(Sn):
            if legal[u, s]:
                next_state[u, s] = table[
                    st2[u, s].astype(np.int32).tobytes()]
    return state_arr, legal.astype(bool), next_state


def _decompose(legal: np.ndarray, next_state: np.ndarray):
    """Diagonal + rank-1 decomposition: decomposable iff each op's
    state-changing transitions all target one state.  Returns
    (diag_w, const_w, const_t0) or (None, None, None)."""
    U, Sn = legal.shape
    diag_w = np.zeros((U, Sn), np.float32)
    const_w = np.zeros((U, Sn), np.float32)
    const_t0 = np.zeros(U, np.int32)
    for u in range(U):
        targets = set()
        for s in range(Sn):
            if not legal[u, s]:
                continue
            if next_state[u, s] == s:
                diag_w[u, s] = 1.0
            else:
                const_w[u, s] = 1.0
                targets.add(int(next_state[u, s]))
        if len(targets) > 1:
            return None, None, None
        if targets:
            const_t0[u] = targets.pop()
    return diag_w, const_w, const_t0


def _next_pow2(x: int) -> int:
    b = 1
    while b < x:
        b *= 2
    return b


def _pad_len(x: int) -> int:
    """Event-axis padding: pow2 below 64, 64-multiples above."""
    return _next_pow2(x) if x <= 64 else ((x + 63) // 64) * 64


def _pack_uop_tables(legal: np.ndarray, next_state: np.ndarray,
                     diag_w, const_w, const_t0, sn_words: int = 1):
    """[U]-indexed transition tables: for a decomposable model the
    diagonal and rank-1 state bitmasks and the rank-1 target; otherwise
    the legal bitmask and the nibble-packed next states.  With
    sn_words = W > 1 (the relaxed crash tier's wide-state lift) the
    decomposed bitmasks come back as [U, W] uint32, state s in word
    s // 32, bit s % 32."""
    U, Sn = legal.shape
    if sn_words > 1:
        assert diag_w is not None
        a1 = np.zeros((U, sn_words), np.uint32)
        a2 = np.zeros((U, sn_words), np.uint32)
        for sw in range(sn_words):
            lo, hi = sw * 32, min((sw + 1) * 32, Sn)
            pw = (1 << np.arange(hi - lo, dtype=np.uint64)) \
                .astype(np.uint64)
            a1[:, sw] = ((diag_w[:, lo:hi] > 0).astype(np.uint64)
                         * pw).sum(1).astype(np.uint32)
            a2[:, sw] = ((const_w[:, lo:hi] > 0).astype(np.uint64)
                         * pw).sum(1).astype(np.uint32)
        return a1, a2, const_t0.astype(np.int32)
    pow2 = (1 << np.arange(Sn, dtype=np.uint64)).astype(np.uint64)
    if diag_w is not None:
        aux1 = ((diag_w > 0).astype(np.uint64) * pow2).sum(1)
        aux2 = ((const_w > 0).astype(np.uint64) * pow2).sum(1)
        t0 = const_t0.astype(np.int32)
    else:
        aux1 = (legal.astype(np.uint64) * pow2).sum(1)
        nib = (1 << (4 * np.arange(Sn, dtype=np.uint64))).astype(np.uint64)
        aux2 = (next_state.astype(np.uint64) * nib).sum(1)
        t0 = np.zeros(U, np.int32)
    return (aux1.astype(np.uint32), aux2.astype(np.uint32), t0)


def _pack_regs(batch, Kp: int, R: int, U: int, I: int):
    """Delta-encode the batch: per return, only the calls invoked since
    the previous return (derived from consecutive candidate snapshots:
    between two returns a slot hosts at most one new occupant, so a
    changed (slot -> uop) cell IS the new invoke).  Bursts beyond I
    spill into virtual rows (ret -1) BEFORE their return's row.
    Returns (ret_t [L', K], islot_t, iuop_t [L', K, I], L')."""
    rs_parts, cnt_parts, cs_parts, cu_parts, nr_parts = [], [], [], [], []
    for _, fk in batch:
        rs, counts, cs, cu = _fk_arrays(fk)
        rs_parts.append(rs)
        cnt_parts.append(counts)
        cs_parts.append(cs)
        cu_parts.append(cu)
        nr_parts.append(len(rs))
    rs_all = np.concatenate(rs_parts)
    cnt_all = np.concatenate(cnt_parts)
    cs_all = np.concatenate(cs_parts).astype(np.int64)
    cu_all = np.concatenate(cu_parts)
    nr_all = np.asarray(nr_parts, np.int64)
    NR = len(rs_all)
    ret_key = np.repeat(np.arange(len(batch)), nr_all)
    key_start = np.concatenate([[0], np.cumsum(nr_all)[:-1]])
    first_ret = key_start

    # dense snapshot matrix M[r, slot] = uop at return r, -1 empty
    M = np.full((NR, R), -1, np.int64)
    rowidx = np.repeat(np.arange(NR), cnt_all)
    M[rowidx, cs_all] = cu_all
    # previous snapshot with the returning slot freed
    Oprev = np.full_like(M, -1)
    Oprev[1:] = M[:-1]
    idx = np.arange(1, NR)
    Oprev[idx, rs_all[:-1].astype(np.int64)] = -1
    Oprev[first_ret] = -1
    D = (M != -1) & (M != Oprev)
    c = D.sum(1).astype(np.int64)               # deltas per return

    # row layout with virtual spill rows
    e = np.maximum(0, (c + I - 1) // I - 1)     # virtual rows per return
    ecum = np.cumsum(e)
    ebase = np.concatenate([[0], ecum])[key_start]
    r_local = np.arange(NR) - key_start[ret_key]
    rho = r_local + (ecum - ebase[ret_key])     # local row of return r
    rows_per_key = np.zeros(len(batch), np.int64)
    np.maximum.at(rows_per_key, ret_key, rho + 1)
    Lp = _pad_len(int(rows_per_key.max()))

    ret_slot = np.full((Kp, Lp), -1, np.int8)
    ret_slot[ret_key, rho] = rs_all.astype(np.int8)

    # scatter delta entries into (row, col)
    ent_ret, ent_slot = np.nonzero(D)           # ordered by (ret, slot)
    ent_uop = M[ent_ret, ent_slot]
    starts = np.cumsum(c) - c
    j = np.arange(len(ent_ret)) - starts[ent_ret]
    from_end = c[ent_ret] - 1 - j
    row = rho[ent_ret] - from_end // I
    col = from_end % I
    uop_dtype = np.int8 if U <= 127 else np.int16
    inv_slot = np.full((Kp, Lp, I), -1, np.int8)
    inv_uop = np.full((Kp, Lp, I), -1, uop_dtype)
    inv_slot[ret_key[ent_ret], row, col] = ent_slot.astype(np.int8)
    inv_uop[ret_key[ent_ret], row, col] = ent_uop.astype(uop_dtype)

    ret_t = np.ascontiguousarray(ret_slot.T)
    islot_t = np.ascontiguousarray(inv_slot.transpose(1, 0, 2))
    iuop_t = np.ascontiguousarray(inv_uop.transpose(1, 0, 2))
    return ret_t, islot_t, iuop_t, Lp


def _deltas(fk: _FastKey):
    """(ret_slots, deltas per return, delta slots, delta uops), int64:
    the C scan's delta stream as it is, or, from the Python scan, taken
    from its open lists (in invocation order: the calls invoked since
    return r - 1 are the last len(open_r) - (len(open_{r-1}) - 1)
    entries of return r's list)."""
    if fk.deltas is not None:
        rs = fk.arrays[0]
        return (rs.astype(np.int64),) + tuple(x.astype(np.int64)
                                              for x in fk.deltas)
    rs, counts, cs, cu = _fk_arrays(fk)
    counts = counts.astype(np.int64)
    prev = np.concatenate([[0], counts[:-1] - 1])
    c = counts - prev                            # deltas per return
    first = np.cumsum(counts) - counts
    pos_in = np.arange(len(cs)) - np.repeat(first, counts)
    keep = pos_in >= np.repeat(counts - c, counts)
    return (rs.astype(np.int64), c, cs[keep].astype(np.int64),
            cu[keep].astype(np.int64))


def _pack_regs_single(fk: _FastKey, R: int, U: int, I: int):
    """`_pack_regs([(0, fk)], 1, R, U, I)` from the scan's delta stream
    (the reference's `_pack_regs_single`), without the dense snapshot
    matrices: one history as one key, bursts beyond I in virtual rows
    before their return's row.  A return's deltas take slot order here,
    as `_pack_regs` gives them, so the tables are equal.  Returns
    (ret_t [L', 1], islot_t, iuop_t [L', 1, I], L')."""
    rs, c, dslot, duop = _deltas(fk)
    NR = len(rs)
    ent_ret = np.repeat(np.arange(NR), c)
    order = np.lexsort((dslot, ent_ret))         # by (return, slot)
    dslot, duop = dslot[order], duop[order]
    e = np.maximum(0, (c + I - 1) // I - 1)     # virtual rows per return
    rho = np.arange(NR) + np.cumsum(e)          # row of return r
    Lp = _pad_len(int(rho[-1]) + 1 if NR else 1)
    ret_t = np.full((Lp, 1), -1, np.int8)
    ret_t[rho, 0] = rs.astype(np.int8)
    j = np.arange(len(dslot)) - (np.cumsum(c) - c)[ent_ret]
    from_end = c[ent_ret] - 1 - j
    row = rho[ent_ret] - from_end // I
    col = from_end % I
    uop_dtype = np.int8 if U <= 127 else np.int16
    islot_t = np.full((Lp, 1, I), -1, np.int8)
    iuop_t = np.full((Lp, 1, I), -1, uop_dtype)
    islot_t[row, 0, col] = dslot.astype(np.int8)
    iuop_t[row, 0, col] = duop.astype(uop_dtype)
    return ret_t, islot_t, iuop_t, Lp


def _stream_deltas(fk: _FastKey, seg_ends, I: int):
    """Delta-encode one history split at `seg_ends` (quiescent cuts),
    one segment-local row layout per segment: the twin of the
    reference's `_pack_regs_single`, over the scan's invoke-delta stream
    (`_deltas`).  The deltas of a return are in invocation order (where
    `_pack_regs` orders them by slot), which the pipeline's
    speculative rounds depend on; at exact rounds the transfer matrices
    are the same either way.  Bursts beyond I spill into virtual rows
    (no return) before their return's row.  Returns int64 arrays
    (rows [K]: rows per segment; ret_key, rho, rs [NR]: each return's
    segment, row and slot; ent_key, row, col, dslot, duop: each delta's
    segment, row, column, slot and uop)."""
    rs, c, dslot, duop = _deltas(fk)
    NR = len(rs)
    K = len(seg_ends)
    nr_all = np.diff(np.concatenate([[0], seg_ends])).astype(np.int64)
    key_end = np.cumsum(nr_all)
    ret_key = np.repeat(np.arange(K), nr_all)
    key_start = np.concatenate([[0], key_end[:-1]])
    e = np.maximum(0, (c + I - 1) // I - 1)     # virtual rows per return
    ecum = np.cumsum(e)
    ebase = np.concatenate([[0], ecum])[key_start]
    rho = np.arange(NR) - key_start[ret_key] + (ecum - ebase[ret_key])
    ent_ret = np.repeat(np.arange(NR), c)
    j = np.arange(len(dslot)) - (np.cumsum(c) - c)[ent_ret]
    from_end = c[ent_ret] - 1 - j
    row = rho[ent_ret] - from_end // I
    col = from_end % I
    return (rho[key_end - 1] + 1, ret_key, rho, rs.astype(np.int64),
            ret_key[ent_ret], row, col, dslot, duop)


def _snapshot_deltas(fk: _FastKey, seg_ends, R: int, I: int):
    """The delta layout of `_stream_deltas` for a scan that carries
    crashed calls, each segment a key of the reference's snapshot-diff
    `_pack_regs(_segments_from_fk(fk, R, seg_ends))`: a return's deltas
    are the (slot -> uop) cells of its open set that the previous
    return's set (with that return's slot freed) lacks, in slot order,
    and a segment's first return registers its whole open set.  So
    every crashed call open at a segment is registered on its permanent
    slot before the segment's first return, in virtual rows where the
    burst spills past I, and is never returned.  R is the slot count
    (rn + nc).  Returns the arrays of `_stream_deltas`."""
    rs, counts, cs, cu = _fk_arrays(fk)
    NR = len(rs)
    K = len(seg_ends)
    nr_all = np.diff(np.concatenate([[0], seg_ends])).astype(np.int64)
    key_end = np.cumsum(nr_all)
    key_start = np.concatenate([[0], key_end[:-1]])
    ret_key = np.repeat(np.arange(K), nr_all)
    M = np.full((NR, R), -1, np.int64)           # M[r, slot] = uop
    M[np.repeat(np.arange(NR), counts), cs.astype(np.int64)] = cu
    Oprev = np.full_like(M, -1)
    Oprev[1:] = M[:-1]
    Oprev[np.arange(1, NR), rs[:-1].astype(np.int64)] = -1
    Oprev[key_start] = -1
    D = (M != -1) & (M != Oprev)
    c = D.sum(1).astype(np.int64)                # deltas per return
    e = np.maximum(0, (c + I - 1) // I - 1)     # virtual rows per return
    ecum = np.cumsum(e)
    ebase = np.concatenate([[0], ecum])[key_start]
    rho = np.arange(NR) - key_start[ret_key] + (ecum - ebase[ret_key])
    ent_ret, dslot = np.nonzero(D)               # ordered by (ret, slot)
    duop = M[ent_ret, dslot]
    j = np.arange(len(ent_ret)) - (np.cumsum(c) - c)[ent_ret]
    from_end = c[ent_ret] - 1 - j
    row = rho[ent_ret] - from_end // I
    col = from_end % I
    return (rho[key_end - 1] + 1, ret_key, rho, rs.astype(np.int64),
            ret_key[ent_ret], row, col, dslot.astype(np.int64),
            duop.astype(np.int64))


# -- The candidate-table plan -------------------------------------------------

#: Deepest overlap the candidate-table kernels walk (one thread a mask,
#: 2^R of them in one CTA) and the most model states a mask's state set
#: holds (one 64-bit word).
CAND_R_MAX = 10
CAND_SN_MAX = 64
CAND_FORMS = ("bits", "dense")


def cand_gate(R: int, Sn: int, decomposed: bool) -> str:
    """The candidate-table kernel that takes this shape, "bits" or
    "dense" (the reference's `_dispatch_kernel` split: the bits form for
    a decomposed model with Sn <= 32 or an undecomposed one with Sn <=
    8, the dense form for every wider shape), or why neither does."""
    if not 0 < R <= CAND_R_MAX:
        return (f"overlap depth R={R} is outside the candidate-table "
                f"kernels' 1..{CAND_R_MAX}: {ITEM_SERIAL}")
    if Sn > CAND_SN_MAX:
        return (f"{Sn} model states exceed the candidate-table kernels' "
                f"{CAND_SN_MAX}: {ITEM_SERIAL}")
    if (decomposed and Sn <= 32) or (not decomposed and Sn <= 8):
        return "bits"
    return "dense"


class SegPlan(NamedTuple):
    """K segments, each a padded table of return events: L return
    events per segment, C candidate slots per event, R = max_open mask
    bits, Sn states, U distinct ops (the reference's `SegPlan`).
    `seg_fk` holds one flat-array _FastKey per segment where the
    register-delta kernel's gate passes, else None."""
    ret_slot: np.ndarray    # int32 [K, L] (-1 = padding)
    cand_slot: np.ndarray   # int32 [K, L, C]
    cand_uop: np.ndarray    # int32 [K, L, C] (-1 = none)
    legal: np.ndarray       # bool [U, Sn]
    next_state: np.ndarray  # int32 [U, Sn]
    states: np.ndarray      # int32 [Sn, S]
    seg_end_call: np.ndarray  # int32 [K]: call id of each last return
    n_calls: int
    max_open: int
    diag_w: Optional[np.ndarray] = None     # f32 [U, Sn]
    const_w: Optional[np.ndarray] = None    # f32 [U, Sn]
    const_t0: Optional[np.ndarray] = None   # int32 [U]
    seg_fk: Optional[list] = None


def _encode_calls(calls, spec, seen: Optional[dict] = None,
                  rows: Optional[list] = None):
    """Encode each call's op as (f, a, b, ok) and dedupe to U distinct
    rows.  Returns (uops int32[U, 4], call -> uop int32[n]).  Shared
    `seen` / `rows` intern across histories; a history that raises
    Unsupported leaves them as they were."""
    seen = {} if seen is None else seen
    rows = [] if rows is None else rows
    call_uop = np.zeros(len(calls), np.int32)
    new_seen: dict = {}
    new_rows: list = []
    for c in calls:
        fc, av, bv, okv = _encode_op(c.op, spec.f_codes)
        if fc < 0:
            raise Unsupported(f"model has no f-code for {c.op.f!r}")
        if not (-2 ** 31 <= av < 2 ** 31 and -2 ** 31 <= bv < 2 ** 31):
            raise Unsupported(
                f"op value {c.op.value!r} exceeds the int32 device range")
        key = (fc, av, bv, okv)
        u = seen.get(key)
        if u is None:
            u = new_seen.get(key)
        if u is None:
            u = new_seen[key] = len(rows) + len(new_rows)
            new_rows.append(key)
        call_uop[c.id] = u
    seen.update(new_seen)
    rows.extend(new_rows)
    return np.asarray(rows, np.int32).reshape(len(rows), 4), call_uop


def _assign_slots(events):
    """Free-list slot assignment over (pos, kind, call_id) events.
    Returns (rets, n_slots, still_open), each ret (call_id, slot,
    [(open_call_id, open_slot), ...]): the open set at that return,
    target included, in invocation order."""
    free: list = []
    next_slot = 0
    slot_of: dict = {}
    open_calls: list = []
    rets: list = []
    for _, kind, cid in events:
        if kind == 0:
            s = free.pop() if free else next_slot
            if s == next_slot:
                next_slot += 1
            slot_of[cid] = s
            open_calls.append(cid)
        else:
            rets.append((cid, slot_of[cid],
                         [(c2, slot_of[c2]) for c2 in open_calls]))
            open_calls.remove(cid)
            free.append(slot_of[cid])
    return rets, next_slot, open_calls


def plan(prep, spec, model, *, max_states: int = 64,
         max_open_bits: int = 10, target_returns_per_segment: int = 256,
         pad_segments_pow2: bool = True) -> SegPlan:
    """The candidate tables of a crash-free PreparedHistory (the
    reference's `plan`, table for table): segments cut at quiescent
    returns, each return's open set as (slot, uop) candidates, the
    enumerated states and the transition tables.  Raises Unsupported
    for crashed calls, an overlap past max_open_bits, an op without an
    encoding, or a state space past max_states."""
    calls = prep.calls
    if any(c.is_crashed for c in calls):
        raise Unsupported("history has crashed (:info) calls")
    if prep.max_open > max_open_bits:
        raise Unsupported(
            f"max {prep.max_open} simultaneously-open calls exceeds "
            f"max_open_bits={max_open_bits}: {ITEM_SERIAL}")
    uops, call_uop = _encode_calls(calls, spec)
    init = np.asarray(spec.encode(model), np.int32)
    states, legal, next_state = _enumerate_states(spec, init, uops,
                                                  max_states)
    cut_flags = []
    ret_event_end = []
    open_count = 0
    for i, (_, kind, _) in enumerate(prep.events):
        open_count += 1 if kind == 0 else -1
        if kind == 1:
            cut_flags.append(1 if open_count == 0 else 0)
            ret_event_end.append(i + 1)
    if open_count != 0:
        raise Unsupported("history ends with open calls")
    seg_ret_ends = _segment_ends(cut_flags, target_returns_per_segment)
    seg_bounds = [0] + [ret_event_end[r - 1] for r in seg_ret_ends]
    if len(seg_bounds) < 2:
        seg_bounds = [0, len(prep.events)]
    segments = list(zip(seg_bounds[:-1], seg_bounds[1:]))
    K = len(segments)
    seg_tables = []
    L = C = 1
    for lo, hi in segments:
        rets, _, open_calls = _assign_slots(prep.events[lo:hi])
        assert not open_calls, "cut was not quiescent"
        seg_tables.append(rets)
        L = max(L, len(rets))
        C = max(C, max((len(cs) for _, _, cs in rets), default=1))
    if pad_segments_pow2:
        L = _pad_len(L)
        C = _next_pow2(C)
    diag_w, const_w, const_t0 = _decompose(legal, next_state)
    # the reference's _regs_eligible: the nibble form (undecomposed, Sn
    # <= 8) is in it, though this package's register kernel lacks it
    Sn = states.shape[0]
    want_fk = (prep.max_open <= REGS_R_MAX and uops.shape[0] <= 32767
               and (Sn <= REGS_SN_MAX if diag_w is not None else Sn <= 8))
    ret_slot = np.full((K, L), -1, np.int32)
    cand_slot = np.zeros((K, L, C), np.int32)
    cand_uop = np.full((K, L, C), -1, np.int32)
    seg_end_call = np.zeros(K, np.int32)
    seg_fk = [] if want_fk else None
    for k, rets in enumerate(seg_tables):
        rs_f, cnt_f, cs_f, cu_f = [], [], [], []
        for r, (cid, slot, cands) in enumerate(rets):
            ret_slot[k, r] = slot
            for j, (c2, s2) in enumerate(cands):
                cand_slot[k, r, j] = s2
                cand_uop[k, r, j] = call_uop[c2]
            if want_fk:
                rs_f.append(slot)
                cnt_f.append(len(cands))
                cs_f += [s2 for _, s2 in cands]
                cu_f += [int(call_uop[c2]) for c2, _ in cands]
        seg_end_call[k] = rets[-1][0] if rets else -1
        if want_fk:
            seg_fk.append(_FastKey(
                None, prep.max_open, len(rets),
                arrays=(np.asarray(rs_f, np.int32),
                        np.asarray(cnt_f, np.int32),
                        np.asarray(cs_f, np.int32),
                        np.asarray(cu_f, np.int32))))
    return SegPlan(ret_slot, cand_slot, cand_uop, legal, next_state, states,
                   seg_end_call, n_calls=len(calls), max_open=prep.max_open,
                   diag_w=diag_w, const_w=const_w, const_t0=const_t0,
                   seg_fk=seg_fk)


def _pack_cand_tables(cand_uop: np.ndarray, legal: np.ndarray,
                      next_state: np.ndarray, diag_w, const_w, const_t0):
    """Per-candidate transition tables in the bits kernel's form (aux1,
    aux2, t0, each shaped like cand_uop; the reference's
    `_pack_cand_tables`, dtype for dtype).  Decomposed: aux1 / aux2 the
    diagonal and rank-1 state bitmasks; undecomposed (Sn <= 8): aux1
    the legal bitmask, aux2 the next states packed in nibbles.  A
    candidate -1 has zero masks."""
    U, Sn = legal.shape
    ju = np.clip(cand_uop, 0, None)
    live = cand_uop >= 0
    pow2 = (1 << np.arange(Sn, dtype=np.uint64)).astype(np.uint64)
    bm_dtype = (np.uint8 if Sn <= 8 else
                np.uint16 if Sn <= 16 else np.uint32)
    if diag_w is not None:
        diag_u = ((diag_w > 0).astype(np.uint64) * pow2).sum(1)
        const_u = ((const_w > 0).astype(np.uint64) * pow2).sum(1)
        aux1 = (diag_u[ju] * live).astype(bm_dtype)
        aux2 = (const_u[ju] * live).astype(bm_dtype)
        t0 = const_t0[ju].astype(np.int8)
    else:
        legal_u = (legal.astype(np.uint64) * pow2).sum(1)
        nib = (1 << (4 * np.arange(Sn, dtype=np.uint64))).astype(np.uint64)
        next_u = (next_state.astype(np.uint64) * nib).sum(1)
        aux1 = (legal_u[ju] * live).astype(bm_dtype)
        aux2 = (next_u[ju] * live).astype(np.uint32)
        t0 = np.zeros_like(cand_uop, dtype=np.int8)
    return aux1, aux2, t0


# -- Elle routing -------------------------------------------------------------

#: The Elle tiers' engine names and what each runs.
ELLE_WHY = {
    "elle-mesh": "bit-packed planes, closure rounds on elle_pmm with "
                 "early exit",
    "elle-device": "typed-plane closure on the card (dense, torch.matmul)",
    "elle-host": "host closure oracle (numpy)",
}


def plan_elle(n_max: int, batch: int = 1, *, algorithm: str = "auto",
              mesh_threshold: int = 8192) -> dict:
    """The Elle tier for a batch whose largest history has n_max
    transactions (the reference's `plan_elle`, one tier and no chain):
    `auto` takes the packed tier at n_max >= mesh_threshold and the
    dense tier below it; "mesh", "device" and "host" are strict.
    Returns the start of the dispatch record: engine, why, batch,
    n_max."""
    if algorithm == "host":
        engine, why = "elle-host", "host oracle requested (algorithm='host')"
    elif algorithm == "mesh":
        engine, why = "elle-mesh", "packed tier requested (algorithm='mesh')"
    elif algorithm == "device":
        engine, why = ("elle-device",
                       "dense tier requested (algorithm='device')")
    elif algorithm == "auto":
        if n_max >= mesh_threshold:
            engine = "elle-mesh"
            why = (f"n_max={n_max} >= mesh_threshold={mesh_threshold}: "
                   f"{ELLE_WHY[engine]}")
        else:
            engine = "elle-device"
            why = (f"n_max={n_max} < mesh_threshold={mesh_threshold}: "
                   f"{ELLE_WHY[engine]}")
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return {"engine": engine, "why": why, "batch": int(batch),
            "n_max": int(n_max)}


# -- lattice routing ----------------------------------------------------------

#: The lattice tiers' engine names and what each runs.
LATTICE_WHY = {
    "lattice-mesh": "bit-packed planes, seven closures in rounds on "
                    "elle_pmm with early exit, class masks on "
                    "lattice_masks",
    "lattice-device": "dense lattice closures on the card (torch.matmul)",
    "lattice-host": "host lattice oracle (numpy)",
}


def plan_lattice(n_max: int, batch: int = 1, *, algorithm: str = "auto",
                 mesh_threshold: int = 4096) -> dict:
    """The full-lattice tier for a history of n_max transactions (the
    reference's `plan_lattice`, one tier and no chain, as `plan_elle`):
    `auto` takes the packed tier at n_max >= mesh_threshold and the
    dense tier below it; "mesh", "device" and "host" are strict.
    Returns the start of the dispatch record: engine, why, batch,
    n_max."""
    if algorithm == "host":
        engine = "lattice-host"
        why = "host oracle requested (algorithm='host')"
    elif algorithm == "mesh":
        engine = "lattice-mesh"
        why = "packed tier requested (algorithm='mesh')"
    elif algorithm == "device":
        engine = "lattice-device"
        why = "dense tier requested (algorithm='device')"
    elif algorithm == "auto":
        engine = ("lattice-mesh" if n_max >= mesh_threshold
                  else "lattice-device")
        rel = ">=" if n_max >= mesh_threshold else "<"
        why = (f"n_max={n_max} {rel} mesh_threshold={mesh_threshold}: "
               f"{LATTICE_WHY[engine]}")
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return {"engine": engine, "why": why, "batch": int(batch),
            "n_max": int(n_max)}
