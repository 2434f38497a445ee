"""The serial frontier engine: linearizability of one history by a
breadth-first walk over a row frontier, on the card.

The port of `jepsen_tpu/ops/wgl.py`.  A configuration is (bitmask over
the open-call slots, model state); the frontier holds at most F of them.
The walk follows the return events in history order (just-in-time
linearization, knossos :linear / Lowe's algorithm): at the return of
call i, configurations that have not linearized i are closed under
linearizing any open call, deduped exactly (a full-content sort, never
a hash), and those that cannot contain i are pruned.  The walk itself
is `ops.frontier_kernel.walk` (the CUDA kernel `wgl_frontier`, or its
plain version for CPU tensors); this module plans it on the host.

Slots: a call holds a slot while it is open; once its return is
processed every surviving configuration has it, so the slot is
recycled.  Crashed (:info or unreturned) calls never return and hold
dedicated slots above the normal range, grouped by identical op
encoding so the kernel can canonicalize and dominance-prune them.

Capacity: the frontier can overflow (the search is NP-hard).  A valid
verdict with an overflow is still exact (the survivors are real
linearizations); an invalid one is retried at the next of
`frontier_sizes`, and past the last comes back {"valid?": "unknown",
"cause": "frontier-overflow"}.

It is the engine the reference falls to wherever its batched kernels
refuse a history, and the port routes to it in the same places:
`Linearizable` on `wgl_seg.Unsupported`, `wgl_seg.check_many`'s
fallback, and `wgl_deep.check_pipeline`'s stragglers."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.errors import Unencodable, Unsupported
from jepsen_tpu_torch.ops import frontier_kernel, planner
from jepsen_tpu_torch.ops.prep import PreparedHistory, prepare

WHY = ("serial frontier engine (ops.wgl, kernel wgl_frontier): a row "
       "frontier of (open-call mask, state) configs walked return by "
       "return, any overlap depth, crashed calls on dedicated slots")


@dataclasses.dataclass
class WGLPlan:
    """Static arrays of the walk.  R return events, C max candidates per
    event, W mask bits (= max simultaneously-open calls), S model-state
    words."""

    ret_call: np.ndarray     # int32 [R]   returning call id (-1 = padding)
    ret_slot: np.ndarray     # int32 [R]
    cand_call: np.ndarray    # int32 [R, C] open-call ids (-1 = none)
    cand_slot: np.ndarray    # int32 [R, C]
    f: np.ndarray            # int32 [n_calls]
    a: np.ndarray            # int32 [n_calls]
    b: np.ndarray            # int32 [n_calls]
    a_ok: np.ndarray         # bool  [n_calls]
    init_state: np.ndarray   # int32 [S]
    n_calls: int
    n_events: int            # real (unpadded) return events
    max_open: int
    # crashed calls' permanent slots, grouped by identical op encoding
    # (interchangeable tokens), each group in invoke order
    crash_groups: tuple = ()


def _generic_encode_op(op, f_codes) -> tuple[int, int, int, bool]:
    """op -> (f, a, b, a_ok): int values in slot a, [a, b] pairs across
    both, None or an unencodable value marked not-ok (the read with an
    unknown value of the register step)."""
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


def plan(prep: PreparedHistory, spec, model,
         pad_events_to: Optional[int] = None,
         pad_cands_to: Optional[int] = None) -> WGLPlan:
    """The walk's arrays for a prepared history (the reference's
    `plan`, array for array).  Raises Unencodable (a ValueError, as
    the reference raises) for an op the model has no f-code for, or a
    value past int32."""
    calls = prep.calls
    n = len(calls)

    f = np.zeros(n, np.int32)
    a = np.zeros(n, np.int32)
    b = np.zeros(n, np.int32)
    a_ok = np.zeros(n, bool)
    for c in calls:
        fc, av, bv, okv = _generic_encode_op(c.op, spec.f_codes)
        if fc < 0:
            raise Unencodable(f"model has no f-code for {c.op.f!r}")
        if not (-2 ** 31 <= av < 2 ** 31 and -2 ** 31 <= bv < 2 ** 31):
            raise Unencodable(
                f"op value {c.op.value!r} exceeds the device kernel's "
                f"int32 range; use ops.wgl_cpu.check for this history")
        f[c.id], a[c.id], b[c.id], a_ok[c.id] = fc, av, bv, okv

    # Slots, and each return event's open set.  A crashed call gets a
    # dedicated slot above the normal range (placeholders, remapped
    # below): its slot must name the same call all the way, or the
    # kernel's crash-bit pruning would alias the normal calls that held
    # a recycled slot earlier.
    free: list[int] = []
    next_slot = 0
    n_crashed = 0
    slot_of: dict[int, int] = {}
    open_calls: list[int] = []
    rets: list[tuple[int, int, list[int]]] = []
    for _, kind, cid in prep.events:
        if kind == 0:
            if calls[cid].is_crashed:
                slot_of[cid] = -2 - n_crashed
                n_crashed += 1
            else:
                s = free.pop() if free else next_slot
                if s == next_slot:
                    next_slot += 1
                slot_of[cid] = s
            open_calls.append(cid)
        else:
            rets.append((cid, slot_of[cid], list(open_calls)))
            open_calls.remove(cid)
            free.append(slot_of[cid])
    if n_crashed:
        rn = next_slot
        slot_of = {cid: (s if s >= 0 else rn + (-2 - s))
                   for cid, s in slot_of.items()}
        rets = [(cid, s if s >= 0 else rn + (-2 - s), cands)
                for cid, s, cands in rets]

    # crashed calls with the same encoding are interchangeable tokens:
    # grouped in invoke order for the kernel's canonicalization
    groups: dict = {}
    for c in calls:
        if c.is_crashed:
            groups.setdefault(
                (int(f[c.id]), int(a[c.id]), int(b[c.id]),
                 bool(a_ok[c.id])), []).append(slot_of[c.id])
    crash_groups = tuple(tuple(g) for g in groups.values())

    R = len(rets)
    C = max((len(cands) for _, _, cands in rets), default=1)
    C = max(C, 1)
    if pad_cands_to is not None:
        C = max(C, pad_cands_to)
    Rp = max(R, 1)
    if pad_events_to is not None:
        Rp = max(Rp, pad_events_to)

    ret_call = np.full(Rp, -1, np.int32)
    ret_slot = np.zeros(Rp, np.int32)
    cand_call = np.full((Rp, C), -1, np.int32)
    cand_slot = np.zeros((Rp, C), np.int32)
    for r, (cid, slot, cands) in enumerate(rets):
        ret_call[r] = cid
        ret_slot[r] = slot
        for k, j in enumerate(cands):
            cand_call[r, k] = j
            cand_slot[r, k] = slot_of[j]

    return WGLPlan(ret_call, ret_slot, cand_call, cand_slot,
                   f, a, b, a_ok, np.asarray(spec.encode(model), np.int32),
                   n_calls=n, n_events=R,
                   max_open=max(next_slot + n_crashed, 1),
                   crash_groups=crash_groups)


def _bucket(x: int, minimum: int = 1) -> int:
    b = minimum
    while b < x:
        b *= 2
    return b


def crash_args(pl: WGLPlan, W: int):
    """(crash_sizes, cw, gws, luts) of a plan with crashed calls, as the
    reference builds them: the multi-slot groups largest first, each
    size bucketed to a power of two and the group count padded to one
    (padded groups are inert); cw u32[Wd] every crashed slot, gws
    u32[G, Wd] each group's slots, luts u32[sum(size + 1), Wd] each
    group's invoke-order prefixes.  None without crashed calls."""
    if not pl.crash_groups:
        return None
    Wd = max((int(W) + 31) // 32, 1)
    multi = sorted((g for g in pl.crash_groups if len(g) >= 2),
                   key=len, reverse=True)
    G_pad = _bucket(max(len(multi), 1))
    sizes = tuple(_bucket(len(g)) for g in multi) \
        + (0,) * (G_pad - len(multi))
    cw = np.zeros(Wd, np.uint32)
    for g in pl.crash_groups:
        for slot in g:
            cw[slot // 32] |= np.uint32(1) << (slot % 32)
    gws = np.zeros((G_pad, Wd), np.uint32)
    luts = np.zeros((max(sum(z + 1 for z in sizes), 1), Wd), np.uint32)
    off = 0
    for gi, g in enumerate(multi):
        for i, slot in enumerate(g):
            gws[gi, slot // 32] |= np.uint32(1) << (slot % 32)
            luts[off + i + 1] = luts[off + i]
            luts[off + i + 1, slot // 32] |= np.uint32(1) << (slot % 32)
        for i in range(len(g), sizes[gi]):
            luts[off + i + 1] = luts[off + i]
        off += sizes[gi] + 1
    return sizes, cw, gws, luts


def init_frontier(F: int, W: int, S: int, init_state, device="cpu"):
    """(masks int32[F, Wd], states int32[F, S], valid bool[F]): row 0
    the initial state at mask 0, the rest empty."""
    Wd = max((int(W) + 31) // 32, 1)
    masks = torch.zeros((F, Wd), dtype=torch.int32, device=device)
    states = torch.zeros((F, S), dtype=torch.int32, device=device)
    states[0] = torch.as_tensor(np.asarray(init_state, np.int32),
                                device=device)
    valid = torch.zeros(F, dtype=torch.bool, device=device)
    valid[0] = True
    return masks, states, valid


def _words(x: np.ndarray, dev) -> torch.Tensor:
    """u32 words as an int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)


def walk_inputs(model, prep: PreparedHistory, *, pad: bool = True,
                device="cpu"):
    """What `check` walks for a prepared history, as the reference
    builds it: (plan, Tables on `device`, Crash or None, W mask bits).
    With `pad`, the event, candidate and call counts are bucketed to
    powers of two (C and W at least 4), as the reference pads them for
    its compile cache."""
    spec = model.device_spec()
    n_events = sum(1 for _, kind, _ in prep.events if kind == 1)
    pl = plan(prep, spec, model,
              pad_events_to=_bucket(n_events) if pad else None,
              pad_cands_to=_bucket(prep.max_open, 4) if pad else None)
    C = pl.cand_call.shape[1]
    # crashed calls' dedicated slots can pass the candidate count C
    W = _bucket(max(C, pl.max_open), 4) if pad else max(C, pl.max_open)
    fv, av, bv, okv = pl.f, pl.a, pl.b, pl.a_ok
    if pad:
        Np = _bucket(pl.n_calls)
        if Np != len(fv):
            z = Np - len(fv)
            fv = np.concatenate([fv, np.zeros(z, np.int32)])
            av = np.concatenate([av, np.zeros(z, np.int32)])
            bv = np.concatenate([bv, np.zeros(z, np.int32)])
            okv = np.concatenate([okv, np.zeros(z, bool)])
    arrays = [torch.from_numpy(x).to(device)
              for x in (pl.ret_call, pl.ret_slot, pl.cand_call,
                        pl.cand_slot, fv, av, bv, okv)]
    tables = frontier_kernel.Tables(
        *arrays, frontier_kernel.pure_table(spec, *arrays[4:]))
    crash = None
    ca = crash_args(pl, W)
    if ca is not None:
        crash = frontier_kernel.Crash(ca[0], *(_words(x, device)
                                               for x in ca[1:]))
    return pl, tables, crash, W


def check(model, history, *,
          frontier_sizes: Sequence[int] = (1024, 8192, 65536),
          pad: bool = True, events_per_call: int = 2048,
          device=None, stats=None) -> dict[str, Any]:
    """Linearizability of `history` (or a PreparedHistory) against
    `model` by the serial frontier walk on `device` (the card by
    default; "cpu" runs the plain version), in launches of at most
    `events_per_call` events with the frontier carried across.  Returns
    the reference's analysis map: valid?, op_count, backend,
    frontier_size, final_frontier, time_plan_s, time_kernel_s, and on a
    death op, op_index and anomaly; {"valid?": "unknown", "cause":
    "frontier-overflow"} when every size overflows.  Raises Unsupported
    for a model without a device spec, or on the card for one the
    kernel has no transition for, before any launch; Unencodable (a
    ValueError) where the reference raises ValueError (an op past
    int32, an unknown f).  `stats`, when
    given a dict, receives the launches and the walk's `work=` counts
    summed over them (expansions, sorted row-levels, dominance
    pairs)."""
    if events_per_call < 1:
        raise ValueError("events_per_call must be >= 1")
    dev = resolve_device(device)
    spec = model.device_spec()
    if spec is None:
        raise Unsupported(f"model {model!r} has no device spec: "
                          f"{planner.ITEM_CPU_AUTO}")
    frontier_kernel.require(spec, dev)

    t0 = time.monotonic()
    prep = history if isinstance(history, PreparedHistory) \
        else prepare(history)
    if not prep.calls:
        return {"valid?": True, "op_count": 0, "backend": dev.type}

    pl, tables, crash, W = walk_inputs(model, prep, pad=pad, device=dev)
    S = pl.init_state.shape[0]
    work = torch.zeros(3, dtype=torch.int64, device=dev) \
        if stats is not None else None
    t_plan = time.monotonic() - t0

    for F in frontier_sizes:
        if F < 1:
            continue
        masks, states, valid = init_frontier(F, W, S, pl.init_state, dev)
        t1 = time.monotonic()
        r = 0
        overflow = False
        while True:
            res = frontier_kernel.walk(
                tables, masks, states, valid, r0=r, n_events=pl.n_events,
                stop_r=r + events_per_call, spec=spec, crash=crash,
                work=work)
            ok, failed_event, ovf, n_front, r = res["out"].tolist()
            if stats is not None:
                stats["launches"] = stats.get("launches", 0) + 1
                w = stats.setdefault("work", [0, 0, 0])
                for k, x in enumerate(work.tolist()):
                    w[k] += x
            overflow = overflow or bool(ovf)
            if not ok or r >= pl.n_events:
                break
            masks, states, valid = (res["final_masks"],
                                    res["final_states"], res["final_valid"])
        t_kernel = time.monotonic() - t1
        if ok or not overflow:
            result: dict[str, Any] = {
                "valid?": bool(ok),
                "op_count": pl.n_calls,
                "backend": dev.type,
                "frontier_size": F,
                "final_frontier": n_front,
                "time_plan_s": t_plan,
                "time_kernel_s": t_kernel,
            }
            if not ok:
                cid = int(pl.ret_call[failed_event]) \
                    if failed_event >= 0 else -1
                if 0 <= cid < len(prep.calls):
                    call = prep.calls[cid]
                    result["op"] = call.op.to_dict()
                    result["op_index"] = call.op.index
                result["anomaly"] = "nonlinearizable"
            return result
    return {"valid?": "unknown", "cause": "frontier-overflow",
            "op_count": pl.n_calls, "backend": dev.type,
            "frontier_size": frontier_sizes[-1]}


def dispatched(res: dict, engine: str, why: str, batch: int,
               device) -> dict:
    """`res` with its engine (kept if it names one) and the dispatch
    record of a result the serial route gave: why the batched engines
    passed it on."""
    res.setdefault("engine", engine)
    res["dispatch"] = {"engine": res["engine"], "why": why, "batch": batch,
                       "device": str(resolve_device(device)), "R": None}
    return res


def decide(model, history, *, why: str, batch: int = 1, device=None,
           **kw) -> dict:
    """`check` (keyword options `kw`) of a history a batched engine
    refused, as engine "wgl" with the dispatch record naming `why`."""
    return dispatched(check(model, history, device=device, **kw), "wgl",
                      f"{WHY}; {why}", batch, device)
