"""Linearizability checking of register histories: `check()`, the entry
point the `Linearizable` checker calls, `check_pipeline()` for many
histories, and `check_many()` for many short independent keys (the
`jepsen.independent` workload: each key one lane of the segment
kernel).

Routing is the reference's (`jepsen_tpu/ops/wgl_seg.py::_check_fast`,
then `_check_impl`'s plan route): a history over a decomposed model
with Sn <= 32 runs the register-delta segment kernel at overlap depth
R <= 6 (`engine: "wgl_seg"`) and the deep kernel at R 7..16 (`engine:
"wgl_deep"`); a crash-free one past both (up to 64 states, or a model
without the decomposition, at R <= 10) runs the plan route
(`_check_plan`: `planner.plan`'s candidate tables through the
candidate-table kernels of `ops.cand_kernel`, `engine: "wgl_seg"`), as
does a PreparedHistory.  A history with crashed
calls (an :info completion, or none) goes through the reference's crash
tiers (`_check_crashed`): inert crashed calls are dropped (tier 1); up
to planner.MAX_CRASHED others ride as permanent slots, in the segment
kernel's crash variant while R + nc <= 8 and Sn * 2^nc <= 128, else in
the deep kernel (tier 2); past that, a valid verdict on the history
with every crash stripped is the history's (tier 3), and an invalid one
is followed by a sound refutation under relaxed crash semantics (tier
4).  Shapes outside all of these raise `Unsupported` naming the ROADMAP
item that covers them; as in the reference, `check()` itself falls to
no other engine, and its callers that do (`Linearizable`,
`check_many`'s fallback) run the serial frontier engine (`ops.wgl`).

The segment route cuts a history at its quiescent returns (no normal
call open) into segments of at least TARGET_RETURNS returns.
Only the model state (and which crashed calls took effect) crosses such
a cut, so each segment is a boolean transfer matrix T_k over entry
configs, computed by one kernel lane per (segment, entry config)
(`ops.regs_kernel`, `ops.crash_kernel`), and the history is
linearizable iff a config survives the chained product from the
initial one.  The composition runs on the device and returns six words:
valid, the first dead segment and the entry configs reachable at the
cut before it, from which `_localize_segment` replays only the dead
segment through the CPU oracle to name the exact failing op."""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.errors import Unencodable, Unsupported
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.ops import (cand_kernel, crash_kernel, deep_kernel,
                                  planner, regs_kernel, wgl, wgl_cpu,
                                  wgl_deep)
from jepsen_tpu_torch.ops.prep import PreparedHistory, prepare

WHY = ("register-delta segment kernel: decomposable model with Sn <= 32 and "
       "overlap depth R <= 6, one lane per (quiescent segment, entry "
       "state), composed on the device")
WHY_CRASH = ("crash tier 2: {nc} crashed calls as permanent slots "
             "{rn}..{top} of the {kernel} (R = {R} with them)")
WHY_INERT = "crash tier 1: {n} inert crashed calls dropped; "
WHY_STRIPPED = ("crash tier 3: the history with its {n} crashed calls "
                "stripped is valid, so it is; ")
WHY_CAND = ("candidate-table kernel, {form} form ({why}): the plan route "
            "(prepare, plan), one lane per (quiescent segment, entry "
            "state) through wgl_cand_{form}, composed on the device")
WHY_PREPARED = ("register-delta segment kernel over the plan's segments: "
                "the plan's shape is in its reach")
WHY_RELAXED = ("crash tier 4: refuted under relaxed crash semantics (the "
               "segment kernel with crash-prefix closures, then the death "
               "row of the dead segment)")
#: Caps of the CPU oracle where it only adds artifacts or a witness the
#: device cannot name (deep prefixes, crashed-call segments).
ORACLE_CAPS = {"time_limit": 15, "max_configs": 500_000}

#: Returns per segment: a segment closes at the first quiescent return
#: at least this many returns in (the reference's
#: target_returns_per_segment default).
TARGET_RETURNS = 256
#: Histories scanned, packed and launched together by check_pipeline
#: (the reference's JEPSEN_TPU_PIPE_GROUP default).
PIPE_GROUP = 4
#: Closure rounds of the pipeline's speculative pass (the reference's
#: JEPSEN_TPU_SPEC_ROUNDS default); a death there is re-checked exactly.
SPEC_ROUNDS = 2
WHY_KEYS = ("register-delta key lanes: each crash-free key (or the "
            "crash-stripped twin of a key with crashed calls) at overlap "
            "depth R <= 6 is one segment and one lane of the key kernel, "
            "entering state 0, several keys a warp; every key in one "
            "launch at exact rounds, the verdicts in one copy")
WHY_KEYS_DEEP = ("deep-overlap kernel: the keys at overlap depth 7..16 in "
                 "one wgl_deep.check_pipeline grid (the reference's "
                 "candidate-table lanes are ROADMAP P5)")
WHY_KEYS_CAND = ("candidate-table key lanes: the crash-free keys (and "
                 "crash-stripped twins) at overlap depth R <= 6, whose "
                 "shared state space the key kernel refuses (past 32 "
                 "states, or undecomposed), as one J = 1 launch of "
                 "wgl_cand_{form}, each key one lane entering state 0")
WHY_KEYS_HOST = ("decided on the host: the key has no client call, or "
                 "every client call of it crashed")
WHY_FALLBACK = ("check_many's fallback (the serial frontier engine "
                "ops.wgl; the CPU oracle for an op past its int32 "
                "encoding): a key the "
                "scan refuses, a PreparedHistory, a crash key every crash "
                "tier leaves open, or every lane key when the lanes' state "
                "space outgrows max_states or both the key kernel's and "
                "the candidate-table kernels' gates")


class _SegGrid:
    """The segments of one launch: the wires of one or more histories'
    segments under one aux table, and each history's segment count (its
    segments are consecutive)."""

    def __init__(self):
        self.bufs: list = []
        self.offs: list = []
        self.rows: list = []
        self.seg_counts: list = []
        self.size = 0

    def add(self, fk, seg_ends, n_in: int):
        """One history's segments, n_in invoke columns per row."""
        self.add_wire(*regs_kernel.pack_stream(fk, seg_ends, n_in))

    def add_wire(self, cbuf, offs, rows):
        """One history's segments as a written wire: (cbuf u8, offs
        int64[K] from its start, nrows int32[K]), the layout of
        `regs_kernel.pack_stream` (the stream scan writes it)."""
        self.bufs.append(cbuf)
        self.offs.append(offs + self.size)
        self.rows.append(rows)
        self.seg_counts.append(len(rows))
        self.size += cbuf.nbytes

    def wire(self):
        """(cbuf u8, offs int64[K], nrows int32[K]) as host arrays."""
        return (np.concatenate(self.bufs), np.concatenate(self.offs),
                np.concatenate(self.rows))

    def to_device(self, aux: np.ndarray, dev: torch.device):
        """The wire and the aux table on `dev`, copied without waiting."""
        return tuple(regs_kernel.to_device(x, dev)
                     for x in self.wire() + (aux,))


def _aux(tables) -> tuple[np.ndarray, int]:
    """The kernels' aux table of `planner._pack_uop_tables`' output, its
    uop rows padded to UP: a1[UP] ++ a2[UP] ++ t0[UP], or with W-word
    masks ([U, W], the relaxed tier's lift) a1[UP, W] ++ a2[UP, W] ++
    t0[UP]."""
    a1t, a2t, t0t = tables
    UP = wgl_deep._pad_u(a1t.shape[0])
    if a1t.ndim == 1:
        return wgl_deep.pack_aux(a1t, a2t, t0t, UP).view(np.int32), UP
    U, W = a1t.shape
    aux = np.zeros((2 * W + 1) * UP, np.uint32)
    aux[:U * W] = a1t.ravel()
    aux[UP * W:UP * W + U * W] = a2t.ravel()
    aux[2 * UP * W:2 * UP * W + U] = t0t.astype(np.uint32)
    return aux.view(np.int32), UP


def _launch(wire, seg_counts, UP: int, *, R: int, Sn: int, rounds: int,
            events=None):
    """Scan and compose one grid's wire (cbuf, offs, nrows, aux on the
    device) without synchronising: returns (verdicts int32[B, 6], bad
    int32[1]) as device tensors.  `events`, when given a list, receives
    the (start, scanned, composed) CUDA events of the launch."""
    cbuf, offs, rows, aux_t = wire
    ev = None
    if events is not None:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    T, bad = regs_kernel.regs_scan(cbuf, offs, rows, aux_t, R=R, Sn=Sn,
                                   UP=UP, J=Sn, rounds=rounds)
    if ev is not None:
        ev[1].record()
    vd = regs_kernel.compose(T, seg_counts)
    if ev is not None:
        ev[2].record()
        events.append(ev)
    return vd, bad


def _fetch(vds: list, bads: list) -> np.ndarray:
    """Every launch's verdicts in one copy to the host: int32[sum B, 6].
    Raises when the kernel refused a segment."""
    flat = torch.cat([torch.cat(bads)] + [v.reshape(-1) for v in vds])
    host = flat.cpu().numpy()
    n_bad = int(host[:len(bads)].sum())
    if n_bad:
        raise RuntimeError(f"the segment kernel refused {n_bad} segments")
    return host[len(bads):].reshape(-1, 6)


def _localize_segment(spec, ops, fk, seg_ends, dead: int, mask_words,
                      states) -> Optional[dict]:
    """Exact witness localization confined to the DEAD segment: replay
    only that segment's ops through the CPU oracle, in one walk seeded
    with every entry state the device's composed verdict marks reachable.
    Configs before a quiescent cut are summarized by the reachable state
    set, so the first return at which the union config set empties is
    the whole history's witness.  Returns the oracle's result, or None
    when the model cannot decode states or the oracle disagrees (callers
    fall back to the whole-history oracle)."""
    end_ret = int(seg_ends[dead]) - 1
    start_pos = (int(fk.positions[int(seg_ends[dead - 1]) - 1]) + 1
                 if dead > 0 else 0)
    end_pos = int(fk.positions[end_ret])
    return _replay_segment(spec, ops, start_pos, end_pos, mask_words, states)


def _replay_segment(spec, ops, start_pos: int, end_pos: int, mask_words,
                    states) -> Optional[dict]:
    """The union replay of ops[start_pos..end_pos] (a segment between
    quiescent cuts) from the entry states set in mask_words (bit j of
    word j // 32: state j), through the CPU oracle; None when the model
    cannot decode states or the replay survives."""
    if spec.decode is None:
        return None
    # Quiescent cuts count ok-open calls only, so fail pairs may straddle
    # either boundary; an unpaired half inside the slice would read to
    # the oracle as a crashed call.  A failed call is never linearized,
    # so dropping the stray halves is exact.
    seg_ops = []
    open_at: dict = {}
    for o in ops[start_pos:end_pos + 1]:
        p = o.process
        if type(p) is int and p >= 0:
            if o.type == "invoke":
                open_at[p] = len(seg_ops)
            elif p not in open_at:
                continue             # completion of a pre-slice invoke
            else:
                del open_at[p]
        seg_ops.append(o)
    if open_at:                      # invokes completing past the slice
        drop = set(open_at.values())
        seg_ops = [o for i, o in enumerate(seg_ops) if i not in drop]
    Sn = states.shape[0]
    entry = [j for j in range(Sn)
             if (int(mask_words[j // 32]) >> (j % 32)) & 1]
    if not entry:
        return None
    o = wgl_cpu.check(None, History(seg_ops),
                      initial_models=[spec.decode(states[j])
                                      for j in entry])
    if o.get("valid?") is not False:
        return None
    return o


def _mark_dead(result: dict, vd, localize: bool, model, spec, history,
               ops, fk, seg_ends, states):
    """Add an invalid verdict's keys to `result`, and with `localize`
    the exact witness and the oracle's artifacts.  With crashed calls in
    the walk (fk.nc > 0) the entry configs are (crashed mask, state)
    pairs the segment replay cannot seed, so the whole history goes to
    the capped oracle, which names the witness when it finishes."""
    result["anomaly"] = "nonlinearizable"
    result["dead_segment"] = int(vd[1])
    if not localize:
        return
    if fk.nc:
        oracle = wgl_cpu.check(model, history, **ORACLE_CAPS)
        if oracle.get("valid?") is not False:
            return
    else:
        oracle = _localize_segment(spec, ops, fk, seg_ends, int(vd[1]),
                                   vd[2:6], states)
    if oracle is None:
        # the whole-history oracle stops at the first non-linearizable op
        oracle = wgl_cpu.check(model, history)
    for key in ("op", "op_index", "final-paths", "configs"):
        if key in oracle:
            result[key] = oracle[key]


def _check_regs(model, spec, history, ops, fk, states, legal, next_state,
                decomposition, *, R, Sn, localize, dev, t0,
                seg_ends=None) -> dict[str, Any]:
    """One history on the segment kernel at exact rounds (R), its crashed
    calls (fk.nc) on permanent slots fk.rn.. of the crash variant; cut
    at its quiescent returns, or at `seg_ends` when given."""
    if seg_ends is None:
        seg_ends = planner._segment_ends(fk.cuts, TARGET_RETURNS)
    aux, UP = _aux(planner._pack_uop_tables(legal, next_state,
                                            *decomposition))
    grid = _SegGrid()
    grid.add(fk, seg_ends, min(2, R))
    t_plan = time.monotonic() - t0
    t1 = time.monotonic()
    wire = grid.to_device(aux, dev)
    if fk.nc:
        T, bad = crash_kernel.crash_scan(*wire, R=R, Sn=Sn, UP=UP, nc=fk.nc,
                                         rn=fk.rn)
        vd = regs_kernel.compose(T, grid.seg_counts)
    else:
        vd, bad = _launch(wire, grid.seg_counts, UP, R=R, Sn=Sn, rounds=R)
    vd = _fetch([vd], [bad])[0]
    result: dict[str, Any] = {
        "valid?": int(vd[1]) < 0,
        "op_count": fk.n_calls,
        "backend": dev.type,
        "engine": "wgl_seg",
        "segments": len(seg_ends),
        "states": Sn,
        "sharded": False,
        "max_open": R,
        "time_plan_s": t_plan,
        "time_kernel_s": time.monotonic() - t1,
    }
    if int(vd[1]) >= 0:
        _mark_dead(result, vd, localize, model, spec, history, ops, fk,
                   seg_ends, states)
    return result


def _check_deep(model, ops, fk, legal, next_state, diag_w, const_w,
                const_t0, *, R, Sn, localize, device, t0):
    """One history on the deep kernel; a knossos-shaped result."""
    ret_t, islot_t, iuop_t, _ = planner._pack_regs(
        [(0, fk)], 1, R, int(legal.shape[0]), deep_kernel.I)
    a1t, a2t, t0t = planner._pack_uop_tables(
        legal, next_state, diag_w, const_w, const_t0)
    t_plan = time.monotonic() - t0
    res = wgl_deep.check_tables(ret_t, islot_t, iuop_t, a1t, a2t, t0t,
                                R, Sn, device=device)
    result: dict[str, Any] = {
        "valid?": res["valid?"],
        "op_count": fk.n_calls,
        "backend": device.type,
        "engine": "wgl_deep",
        "max_open": R,
        "states": Sn,
        "time_plan_s": t_plan,
        "time_kernel_s": res["time_kernel_s"],
    }
    for key in ("deep_variant", "shards"):
        if key in res:
            result[key] = res[key]
    if res["valid?"]:
        return result
    result["anomaly"] = "nonlinearizable"
    # exact witness: the failing event row names the failing call
    w = wgl_deep.map_witness(ret_t, fk, ops, res["failed_row"])
    pos = None
    if w is not None:
        result["op"] = w[0].to_dict()
        result["op_index"] = w[1]
        pos = w[2]
    if localize:
        # artifacts (final-paths/configs) from a CAPPED oracle on the
        # prefix through the witness: deep overlap is where an uncapped
        # oracle can spin, and the verdict and witness are exact without
        result["localized"] = True
        prefix = ops if pos is None else ops[:pos + 1]
        oracle = wgl_cpu.check(model, History(list(prefix)),
                               **ORACLE_CAPS)
        if oracle.get("valid?") is False:
            for key in ("final-paths", "configs"):
                if key in oracle:
                    result[key] = oracle[key]
    return result


def _model_tables(spec, model, rows: list, max_states: int):
    """(states, legal, next_state, (diag_w, const_w, const_t0)) of the
    interned ops."""
    uops = np.asarray(rows, np.int32).reshape(len(rows), 4)
    init = np.asarray(spec.encode(model), np.int32)
    states, legal, next_state = planner._enumerate_states(
        spec, init, uops, max_states)
    return states, legal, next_state, planner._decompose(legal, next_state)


def _check_scanned(model, spec, history, ops, fk, rows, *, max_states,
                   max_open_bits, localize, dev, t0,
                   plan_route: bool = True) -> dict[str, Any]:
    """One scanned history: the segment kernel where its gate passes
    (`regs_gate`, or `crash_gate` with the scan's crashed calls on
    permanent slots), else the deep kernel at R (+ nc), else (no crashed
    calls) the plan route's candidate-table kernels (`_check_plan`; not
    for crash tier 2, as in the reference).  Raises Unsupported outside
    all of them."""
    record = {"engine": "wgl_seg", "why": WHY, "batch": 1,
              "device": str(dev)}
    if fk.n_calls == 0:
        return {"valid?": True, "op_count": 0, "backend": dev.type,
                "engine": "wgl_seg", "dispatch": record}
    states, legal, next_state, dec = _model_tables(spec, model, rows,
                                                   max_states)
    Sn = states.shape[0]
    nc = fk.nc
    R = fk.rn + nc if nc else int(fk.max_open)
    U = int(legal.shape[0])
    decomposed = dec[0] is not None
    if nc:
        gate = planner.crash_gate(fk.rn, nc, Sn, U, decomposed)
    else:
        gate = planner.regs_gate(R, Sn, U, decomposed)
    if gate is None:
        if nc and (not fk.n_rets or fk.cuts[-1] != 1):
            raise Unsupported("no quiescent return to close a segment at")
        result = _check_regs(
            model, spec, history, ops, fk, states, legal, next_state, dec,
            R=R, Sn=Sn, localize=localize, dev=dev, t0=t0)
        kernel = "segment kernel, J = Sn * 2^nc = " + str(Sn << nc)
    else:
        why = planner.deep_gate(R, Sn, U, decomposed)
        if why is not None:
            if nc or not plan_route:
                raise Unsupported(why)
            form = planner.cand_gate(R, Sn, decomposed)
            if form not in planner.CAND_FORMS:
                raise Unsupported(form)
            return _check_plan(model, spec, history, ops, prepare(ops),
                               max_states=max_states,
                               max_open_bits=max_open_bits,
                               localize=localize, dev=dev, t0=t0,
                               why=f"Sn = {Sn}, R = {R}, "
                               f"{'' if decomposed else 'un'}decomposed: "
                               "past the segment and deep kernels")
        result = _check_deep(model, ops, fk, legal, next_state, *dec, R=R,
                             Sn=Sn, localize=localize, device=dev, t0=t0)
        record = dict(record, engine="wgl_deep", why=wgl_deep.WHY)
        kernel = "deep kernel"
    if nc:
        result["crashed"] = nc
        record["why"] = WHY_CRASH.format(nc=nc, rn=fk.rn, top=R - 1,
                                         kernel=kernel, R=R)
    result["dispatch"] = dict(record, R=R)
    return result


def _cand_scan(ret_slot, cand_slot, cand_uop, legal, next_state, dec, *,
               R: int, Sn: int, J: int, dev):
    """Transfer rows of candidate tables ([K, L] and [K, L, C], the
    layout of `planner.plan`) on the candidate-table kernel `cand_gate`
    picks, at J = Sn (a history's segments) or J = 1 (keys entering
    state 0).  Returns (T u8[K, J, Sn] and bad int32[1] on `dev`, the
    form).  Raises Unsupported where neither form takes the shape."""
    form = planner.cand_gate(R, Sn, dec[0] is not None)
    if form not in planner.CAND_FORMS:
        raise Unsupported(form)
    ret_t = np.ascontiguousarray(ret_slot.T, np.int32)
    cslot_t = np.ascontiguousarray(cand_slot.transpose(1, 0, 2), np.int32)
    cuop_t = np.ascontiguousarray(cand_uop.transpose(1, 0, 2), np.int32)

    def put(*xs):
        return [regs_kernel.to_device(x, dev) for x in xs]

    if form == "bits":
        T, bad = cand_kernel.cand_bits(
            *put(ret_t, cslot_t, *cand_kernel.bits_tables(
                cuop_t, legal, next_state, *dec)),
            R=R, Sn=Sn, J=J, decomposed=dec[0] is not None)
    else:
        T, bad = cand_kernel.cand_dense(
            *put(ret_t, cslot_t, cuop_t, *cand_kernel.dense_tables(
                legal, next_state, *dec)), R=R, Sn=Sn, J=J)
    return T, bad, form


def _check_plan(model, spec, history, ops, prep, *, max_states,
                max_open_bits, localize, dev, t0, why) -> dict[str, Any]:
    """The plan route (the reference's `_check_impl` past its fast path):
    `planner.plan`'s candidate tables, one lane per (segment, entry
    state) through the candidate-table kernel `cand_gate` picks, the
    transfer matrices composed by `wgl_compose` (the verdict and the dead
    segment).  A PreparedHistory whose shape the register-delta kernel
    takes runs that kernel over the plan's segments instead, as in the
    reference.  An invalid history (not a PreparedHistory) with
    `localize` gets its witness from a union replay of the dead segment
    from the entry states the composition marks (`_replay_segment`), or,
    where that cannot run, the CPU oracle under ORACLE_CAPS on the prefix
    through the dead segment's last call."""
    if not prep.calls:
        return {"valid?": True, "op_count": 0, "backend": dev.type,
                "engine": "wgl_seg",
                "dispatch": {"engine": "wgl_seg", "why": WHY, "batch": 1,
                             "device": str(dev)}}
    pl = planner.plan(prep, spec, model, max_states=max_states,
                      max_open_bits=max_open_bits,
                      target_returns_per_segment=TARGET_RETURNS)
    K = pl.ret_slot.shape[0]
    Sn = int(pl.states.shape[0])
    R = int(pl.max_open)
    U = int(pl.legal.shape[0])
    dec = (pl.diag_w, pl.const_w, pl.const_t0)
    if pl.seg_fk is not None and \
            planner.regs_gate(R, Sn, U, dec[0] is not None) is None:
        # a PreparedHistory in the register kernel's reach: its
        # segments' open lists as one scan, cut where the plan cut it
        arrs = [planner._fk_arrays(f) for f in pl.seg_fk]
        fk = planner._FastKey(None, R, pl.n_calls, arrays=tuple(
            np.concatenate([a[i] for a in arrs]) for i in range(4)))
        seg_ends = list(np.cumsum([len(a[0]) for a in arrs]))
        res = _check_regs(model, spec, None, ops, fk, pl.states, pl.legal,
                          pl.next_state, dec, R=R, Sn=Sn, localize=False,
                          dev=dev, t0=t0, seg_ends=seg_ends)
        res["op_count"] = pl.n_calls
        res["dispatch"] = {"engine": "wgl_seg", "why": WHY_PREPARED,
                           "batch": 1, "device": str(dev), "R": R}
        return res
    t_plan = time.monotonic() - t0
    t1 = time.monotonic()
    T, bad, form = _cand_scan(pl.ret_slot, pl.cand_slot, pl.cand_uop,
                              pl.legal, pl.next_state, dec, R=R, Sn=Sn,
                              J=Sn, dev=dev)
    vd = regs_kernel.compose(T, [K])
    host = torch.cat([bad, vd.reshape(-1)]).cpu().numpy()     # one copy
    if host[0]:
        raise RuntimeError(f"wgl_cand_{form} refused {int(host[0])} CTAs")
    vd = host[1:]
    dead = int(vd[1])
    result: dict[str, Any] = {
        "valid?": dead < 0,
        "op_count": pl.n_calls,
        "backend": dev.type,
        "engine": "wgl_seg",
        "segments": K,
        "states": Sn,
        "sharded": False,
        "max_open": R,
        "time_plan_s": t_plan,
        "time_kernel_s": time.monotonic() - t1,
        "dispatch": {"engine": "wgl_seg", "batch": 1, "device": str(dev),
                     "R": R, "kernel": f"wgl_cand_{form}", "form": form,
                     "why": WHY_CAND.format(form=form, why=why)},
    }
    if dead < 0:
        return result
    result["anomaly"] = "nonlinearizable"
    result["dead_segment"] = dead
    if not localize or ops is None:
        return result
    pos = {id(o): i for i, o in enumerate(ops)}

    def end_pos(k):
        return pos[id(prep.calls[int(pl.seg_end_call[k])].completion)]

    oracle = _replay_segment(spec, ops, end_pos(dead - 1) + 1 if dead else 0,
                             end_pos(dead), vd[2:6], pl.states)
    if oracle is None:
        oracle = wgl_cpu.check(model, History(ops[:end_pos(dead) + 1]),
                               **ORACLE_CAPS)
    if oracle.get("valid?") is False:
        for key in ("op", "op_index", "final-paths", "configs"):
            if key in oracle:
                result[key] = oracle[key]
    return result


def check(model, history, *, max_states: int = 64, max_open_bits: int = 10,
          localize: bool = True, device=None, stats=None) -> dict[str, Any]:
    """Linearizability of one history: the segment kernel at R <= 6,
    the deep kernel at 7..16, the plan route's candidate-table kernels
    past both (and for a PreparedHistory), and the crash tiers for a
    history with crashed calls.  Returns a knossos-shaped analysis map with a
    `dispatch` record (engine, why, R).  Raises Unsupported for a
    history or model outside the port and BackendUnavailable when the
    device is missing.  `stats`, when given a dict, receives host
    seconds per stage of a history with crashed calls (scan, split,
    tier2, stripped, relaxed, oracle)."""
    dev = resolve_device(device)
    spec = model.device_spec()
    if spec is None:
        raise Unsupported(f"model {model!r} has no device spec: "
                          f"{planner.ITEM_CPU_AUTO}")
    t0 = time.monotonic()
    if isinstance(history, PreparedHistory):
        return _check_plan(model, spec, None, None, history,
                           max_states=max_states,
                           max_open_bits=max_open_bits, localize=False,
                           dev=dev, t0=t0, why="a PreparedHistory")
    seen: dict = {}
    rows: list = []
    ops = history.ops if isinstance(history, History) else \
        History(history).ops
    lap = wgl_deep._laps({} if stats is None else stats)
    try:
        fk = planner._scan_history(planner.columns_of(history), ops, spec,
                                   seen, rows, max_open_bits)
    except planner.CrashedCalls:
        lap("scan")
        return _check_crashed(model, spec, history, ops,
                              max_states=max_states,
                              max_open_bits=max_open_bits,
                              localize=localize, dev=dev, t0=t0, lap=lap)
    return _check_scanned(model, spec, history, ops, fk, rows,
                          max_states=max_states, max_open_bits=max_open_bits,
                          localize=localize, dev=dev, t0=t0)


class _Crashes(NamedTuple):
    """Tier 1's reading of a history with crashed calls: drop marks each
    crashed invoke and its :info completion, crashed lists them
    (`planner._split_crashed`), fk is the stripped history's scan, whose
    ops are the first n_rows of rows, and the crashed ops are interned
    after them (crash_uop[i] = -1 for an op the model cannot encode) over
    one state enumeration; inert[i] says the crashed op is legal and the
    identity on every state."""
    drop: np.ndarray
    crashed: list
    stripped: list
    fk: Any
    n_rows: int
    rows: list
    crash_uop: list
    inert: list
    states: np.ndarray
    legal: np.ndarray
    next_state: np.ndarray


def _split(model, spec, ops, *, max_states, max_open_bits,
           packed=None) -> _Crashes:
    """Tier 1's reading (see _Crashes).  The stripped history is scanned
    in C: over `packed`, the history's columns, at the kept positions,
    or over its ops when it has none."""
    drop, crashed = planner._split_crashed(ops)
    keep = np.nonzero(~drop)[0]
    stripped = [ops[pos] for pos in keep]
    seen: dict = {}
    rows: list = []
    fk = planner._scan_history(None if packed is None else packed.take(keep),
                               stripped, spec, seen, rows, max_open_bits)
    n_rows = len(rows)
    crash_uop = planner._intern_crashed(crashed, spec, seen, rows)
    states, legal, next_state, _ = _model_tables(spec, model, rows,
                                                 max_states)
    eye = np.arange(legal.shape[1])
    inert = [u >= 0 and bool(legal[u].all())
             and bool((next_state[u] == eye).all()) for u in crash_uop]
    return _Crashes(drop, crashed, stripped, fk, n_rows, rows,
                    crash_uop, inert, states, legal, next_state)


def _check_crashed(model, spec, history, ops, *, max_states, max_open_bits,
                   localize, dev, t0, lap) -> dict[str, Any]:
    """A history with crashed calls, in the reference's tiers
    (`_check_crashed_fast`; a crashed call may be linearized at any
    point after its invoke, or never):

    1. a crashed call whose op is legal and the identity on every state
       constrains nothing and is dropped;
    2. up to planner.MAX_CRASHED others ride as permanent slots
       (`_check_scanned` on the history without the inert ones): exact;
    3. past that (or where tier 2's kernels refuse the shape), a valid
       verdict on the history with every crashed call stripped is the
       history's, since no crashed call must be linearized;
    4. a stripped history that dies is refuted, where it can be, under
       relaxed crash semantics (`_relaxed_refute`): sound.

    Raises Unsupported naming the serial engines (ROADMAP P5) when every
    tier leaves the history open.  `lap(stage)` adds the seconds since
    its last call to a stage: split, tier2, stripped, relaxed, oracle."""
    c = _split(model, spec, ops, max_states=max_states,
               max_open_bits=max_open_bits,
               packed=planner.columns_of(history))
    lap("split")
    n_inert = sum(c.inert)
    if len(c.crashed) - n_inert <= planner.MAX_CRASHED:
        red_drop = np.zeros(len(ops), bool)
        for (ip, cp, _), ine in zip(c.crashed, c.inert):
            if ine:
                red_drop[ip] = True
                if cp >= 0:
                    red_drop[cp] = True
        reduced = [o for pos, o in enumerate(ops) if not red_drop[pos]]
        res = _tier2(model, spec, History(reduced), max_states=max_states,
                     max_open_bits=max_open_bits, localize=localize, dev=dev,
                     t0=t0)
        lap("tier2")
        if res is not None:
            if n_inert:
                res["crashed_dropped"] = n_inert
                res["dispatch"]["why"] = (WHY_INERT.format(n=n_inert)
                                          + res["dispatch"]["why"])
            return res
    try:
        res = _check_scanned(model, spec, History(c.stripped), c.stripped,
                             c.fk, c.rows[:c.n_rows], max_states=max_states,
                             max_open_bits=max_open_bits, localize=False,
                             dev=dev, t0=time.monotonic())
    except Unsupported:
        res = None
    lap("stripped")
    if res is not None and res.get("valid?") is True:
        res["crashed_ignored"] = len(c.crashed)
        res["dispatch"]["why"] = (WHY_STRIPPED.format(n=len(c.crashed))
                                  + res["dispatch"]["why"])
        return res
    res = _relaxed_refute(model, history, ops, c, localize=localize,
                          dev=dev, lap=lap)
    if res is None:
        raise Unsupported(
            f"{len(c.crashed)} crashed calls: the stripped history dies "
            f"and the relaxed refutation does not: {planner.ITEM_SERIAL}")
    return res


def _tier2(model, spec, history, *, max_states, max_open_bits, localize,
           dev, t0) -> Optional[dict]:
    """Tier 2: the history (its inert crashed calls dropped) with up to
    MAX_CRASHED crashed calls on permanent slots, or None where the scan
    or the kernels' gates refuse it."""
    seen: dict = {}
    rows: list = []
    ops = history.ops
    try:
        # the crash-carrying scan is the Python one, as in the reference:
        # the C scanners refuse crashed calls
        fk = planner._fast_scan(ops, spec, seen, rows, max_open_bits,
                                max_crashed=planner.MAX_CRASHED)
        return _check_scanned(model, spec, history, ops, fk, rows,
                              max_states=max_states,
                              max_open_bits=max_open_bits,
                              localize=localize, dev=dev, t0=t0,
                              plan_route=False)
    except Unsupported:
        return None


def _prefix_closures(eff, legal, next_state) -> np.ndarray:
    """int32[nC * Sn * W] with nC = len(eff) + 1 and W = sn_words(Sn):
    row c holds, for each state s, the mask of states t reachable from s
    by the first c effective crashed ops (each any number of times, or
    not at all), a reflexive and transitive closure (boolean matrix
    products), state t in word t // 32."""
    Sn = legal.shape[1]
    W = crash_kernel.sn_words(Sn)
    C = np.eye(Sn, dtype=bool)
    rows = [C]
    for _, u in eff:
        rel = np.zeros((Sn, Sn), bool)
        lg = legal[u].astype(bool)
        rel[np.arange(Sn)[lg], next_state[u][lg]] = True
        C = C | rel
        while True:
            C2 = C | ((C.astype(np.int64) @ C.astype(np.int64)) > 0)
            if (C2 == C).all():
                break
            C = C2
        rows.append(C)
    out = np.zeros((len(rows), Sn, W), np.uint32)
    for w in range(W):
        lo, hi = 32 * w, min(32 * (w + 1), Sn)
        pw = (1 << np.arange(hi - lo, dtype=np.uint64)).astype(np.uint64)
        for c, M in enumerate(rows):
            out[c, :, w] = (M[:, lo:hi].astype(np.uint64) * pw).sum(1)
    return out.ravel().view(np.int32)


class _RelaxedWire(NamedTuple):
    """The relaxed tier's input: the stripped history's scan, segments
    and wire with each return's crash-prefix index, the closures, the
    uop table, and the original position of each return."""
    fk: Any
    seg_ends: list
    orig_ret_pos: np.ndarray
    wire: tuple                 # (cbuf u8, offs int64, nrows int32)
    aux: np.ndarray
    UP: int
    ctab: np.ndarray
    R: int
    Sn: int


def _relaxed_wire(c: _Crashes) -> Optional[_RelaxedWire]:
    """The relaxed tier's wire over the stripped history's scan, or None
    where the tier does not apply (an unencodable crashed op, Sn > 64, a
    stripped shape outside the segment kernel's nc = 0 gate, which past
    32 states takes two-word masks of a decomposed model)."""
    Sn = c.states.shape[0]
    if Sn > 2 * planner.REGS_SN_MAX:
        return None                  # closure masks cap at two words
    W = crash_kernel.sn_words(Sn)
    eff = [(ip, u) for (ip, _, _), ine, u in zip(c.crashed, c.inert,
                                                 c.crash_uop) if not ine]
    if any(u < 0 for _, u in eff) or len(eff) > 32767:
        return None
    fk = c.fk
    if fk.n_calls == 0:
        return None
    R = int(fk.max_open)
    dec = planner._decompose(c.legal, c.next_state)
    if planner._segment_gate(R, planner.REGS_R_MAX, Sn, len(c.rows),
                             dec[0] is not None,
                             sn_max=planner.REGS_SN_MAX * W) is not None \
            or not fk.n_rets or fk.cuts[-1] != 1:
        return None
    seg_ends = planner._segment_ends(fk.cuts, TARGET_RETURNS)
    crash_pos = np.asarray([ip for ip, _ in eff], np.int64)
    keep = np.nonzero(~c.drop)[0]
    orig_ret_pos = keep[np.asarray(fk.positions, np.int64)]
    crow = np.searchsorted(crash_pos, orig_ret_pos, side="left")
    aux, UP = _aux(planner._pack_uop_tables(c.legal, c.next_state, *dec,
                                            sn_words=W))
    wire = regs_kernel.pack_stream(fk, seg_ends, min(2, R), crow=crow)
    return _RelaxedWire(fk, seg_ends, orig_ret_pos, wire, aux, UP,
                        _prefix_closures(eff, c.legal, c.next_state), R, Sn)


def _relaxed_refute(model, history, ops, c: _Crashes, *, localize, dev,
                    lap) -> Optional[dict]:
    """Tier 4: a sound refutation under relaxed crash semantics (the
    reference's `_relaxed_refute`, up to 64 states: past 32 every state
    mask takes two words).  Every effect-bearing
    crashed call becomes a jump between states available any number of
    times from its invoke on: a true linearization uses each crashed op
    at most once, after its invoke, so the relaxed config set holds the
    true one at every return, and a relaxed death is a true death.
    Availability only grows with position, so each return's row names
    the closure of the crashed ops invoked before it (one reflexive and
    transitive mask table per crash prefix, built on the host), and the
    segment kernel's relaxed variant applies it around every round of
    the stripped history's walk.  The dead segment's death row names the
    first return at which even the relaxation dies: its call is the
    witness (`relaxed-exact`); without one, the dead segment's last
    return bounds it (`segment-bound`).  With `localize` the capped
    oracle adds artifacts and, when it finishes, the minimal witness.
    Returns None where it proves nothing or does not apply."""
    if all(c.inert):
        return None                  # nothing effect-bearing to relax
    rw = _relaxed_wire(c)
    if rw is None:
        return None
    R, Sn, UP = rw.R, rw.Sn, rw.UP
    wire = tuple(regs_kernel.to_device(x, dev)
                 for x in rw.wire + (rw.aux, rw.ctab))
    T, bad = crash_kernel.relaxed_scan(*wire, R=R, Sn=Sn, UP=UP)
    vd = _fetch([regs_kernel.compose(T, [len(rw.seg_ends)])], [bad])[0]
    if int(vd[0]) == 1:
        lap("relaxed")
        return None                  # relaxed-valid: proves nothing
    dead = int(vd[1])
    seg_lo = int(rw.seg_ends[dead - 1]) if dead > 0 else 0
    bound_pos = int(rw.orig_ret_pos[int(rw.seg_ends[dead]) - 1])
    seed = (int(vd[2]) & 0xFFFFFFFF) | (int(vd[3]) & 0xFFFFFFFF) << 32
    drow, bad = crash_kernel.death_row(
        wire[0], wire[1][dead:dead + 1], wire[2][dead:dead + 1], wire[3],
        wire[4], seed, R=R, Sn=Sn, UP=UP)
    bad, drow = (int(x) for x in torch.cat([bad, drow]).cpu())
    if bad:
        raise RuntimeError("the relaxed kernel refused the dead segment")
    if drow >= 0:
        o = int(rw.wire[1][dead])
        local = int((rw.wire[0][o:o + drow + 1] > 0).sum()) - 1
        g = seg_lo + local
        if 0 <= g < len(rw.orig_ret_pos):
            bound_pos = int(rw.orig_ret_pos[g])
    lap("relaxed")
    p = ops[bound_pos].process
    inv = bound_pos
    while inv >= 0 and not (ops[inv].process == p
                            and ops[inv].type == "invoke"):
        inv -= 1
    bound_op = ops[max(inv, 0)]
    bound_idx = (bound_op.index if bound_op.index is not None
                 else max(inv, 0))
    result: dict[str, Any] = {
        "valid?": False,
        "op_count": rw.fk.n_calls + len(c.crashed),
        "backend": dev.type,
        "engine": "wgl_seg",
        "anomaly": "nonlinearizable",
        "refutation": "crash-relaxed",
        "crashed": len(c.crashed),
        "dead_segment": dead,
        "segments": len(rw.seg_ends),
        "states": Sn,
        "max_open": R,
        "op": bound_op.to_dict(),
        "op_index": bound_idx,
        "witness": "relaxed-exact" if drow >= 0 else "segment-bound",
        "witness_bound_index": bound_idx,
        "dispatch": {"engine": "wgl_seg", "why": WHY_RELAXED, "batch": 1,
                     "device": str(dev), "R": R},
    }
    if localize:
        _localize_key(result, model, history)
        lap("oracle")
    return result


def check_pipeline(model, histories, *, max_states: int = 64,
                   max_open_bits: int = 10, localize: bool = True,
                   stats=None, device=None) -> list:
    """Check many histories: scan and segment them in groups of
    PIPE_GROUP, launch each group's segments (one kernel launch, then
    the composition) on the current stream without waiting, and fetch
    every verdict in one copy at the end.  A history with columns
    (`History.attach_packed`, or a journal) is scanned, cut and written
    as the segment wire in one C pass (`planner._native_scan_streams`);
    one without takes the C object scan, `_segment_ends` and
    `pack_stream`.

    The group kernel runs SPEC_ROUNDS speculative closure rounds (the
    reference's `check_pipeline`): fewer rounds than R only
    under-approximate each transfer matrix, so a surviving verdict is an
    exact valid, and a death is re-checked through `check()` at exact
    rounds (`speculation: "exact-rerun"`).  A group whose depth
    (with the deepest group so far) or model falls outside the segment
    kernel, and a history the scan refuses, go through `check()` one by
    one: R 7..16 to the deep kernel, histories with crashed calls to
    the crash tiers, and shapes `check()` refuses to an entry
    {"valid?": "unknown", "cause": "unsupported", "error": {...}}
    naming the ROADMAP item (where the reference's `check()` raises out
    of the whole pipeline).  The uop tables are rebuilt only when the
    alphabet grows.

    `stats`, when given a dict, receives host seconds per stage (scan,
    segment, tables, pack, copy, launch, sync, assemble, stragglers;
    the stream pass counts under scan, with no segment stage, and pack
    is then the grid's concatenation) and, on a CUDA device,
    `kernel_ms` and `compose_ms`, the device time of the segment kernel
    and of the composition (CUDA events)."""
    dev = resolve_device(device)
    spec = model.device_spec()
    if spec is None:
        raise Unsupported(f"model {model!r} has no device spec: "
                          f"{planner.ITEM_CPU_AUTO}")
    stats = {} if stats is None else stats
    lap = wgl_deep._laps(stats)
    n = len(histories)
    results: list = [None] * n
    seen: dict = {}
    rows: list = []
    strag: list = []
    U_at = -1
    Sn = 0
    states = legal = next_state = dec = None
    aux = UP = None
    R_cur = 0
    events: Optional[list] = [] if dev.type == "cuda" else None
    launched: list = []      # (verdicts, bad, idxs, rounds, R, Sn, states)
    metas: dict = {}         # i -> (fk, seg_ends, ops)
    pos = 0
    while pos < n:
        grp: list = []
        while pos < n and len(grp) < PIPE_GROUP:
            i = pos
            pos += 1
            h = histories[i]
            ops = h.ops if isinstance(h, History) else History(h).ops
            packed = planner.columns_of(h)
            try:
                # one C pass from the columns to the segment wire; a
                # history the columns cannot carry takes the C object
                # scan and the numpy wire
                fk = None
                if packed is not None:
                    fk = planner._native_scan_streams(
                        packed, ops, spec, seen, rows, max_open_bits,
                        TARGET_RETURNS)
                if fk is None:
                    fk = planner._native_scan(ops, spec, seen, rows,
                                              max_open_bits)
            except Unsupported:
                strag.append(i)
                lap("scan")
                continue
            lap("scan")
            if fk.n_calls == 0:
                results[i] = {"valid?": True, "op_count": 0,
                              "backend": dev.type, "engine": "wgl_seg"}
                continue
            if isinstance(fk, planner._StreamKey):
                seg_ends = fk.seg_ends
            else:
                seg_ends = planner._segment_ends(fk.cuts, TARGET_RETURNS)
                lap("segment")
            grp.append((i, fk, seg_ends, ops))
        if not grp:
            continue
        if len(rows) != U_at:
            try:
                states, legal, next_state, dec = _model_tables(
                    spec, model, rows, max_states)
            except Unsupported:
                # the state space outgrew max_states: this group (and
                # every later one: the alphabet only grows) goes through
                # check(), which names the limit
                strag.extend(i for i, *_ in grp)
                lap("tables")
                continue
            Sn = states.shape[0]
            U_at = len(rows)
            if dec[0] is not None:
                aux, UP = _aux(planner._pack_uop_tables(legal, next_state,
                                                        *dec))
        lap("tables")
        R_g = max(fk.max_open for _, fk, _, _ in grp)
        if planner.regs_gate(max(R_g, R_cur), Sn, U_at,
                             dec[0] is not None) is not None:
            strag.extend(i for i, *_ in grp)
            continue
        R_cur = max(R_cur, R_g)
        rounds = min(R_cur, SPEC_ROUNDS)
        grid = _SegGrid()
        for i, fk, seg_ends, ops in grp:
            # the reference's pipeline wire carries one invoke per row
            if isinstance(fk, planner._StreamKey):
                grid.add_wire(*fk.wire)
            else:
                grid.add(fk, seg_ends, 1)
            metas[i] = (fk, seg_ends, ops)
        host_wire = grid.wire() + (aux,)
        lap("pack")
        wire = tuple(regs_kernel.to_device(x, dev) for x in host_wire)
        lap("copy")
        vd, bad = _launch(wire, grid.seg_counts, UP, R=R_cur, Sn=Sn,
                          rounds=rounds, events=events)
        launched.append((vd, bad, [i for i, *_ in grp], rounds, R_cur, Sn,
                         states))
        lap("launch")
    if launched:
        host = _fetch([v for v, *_ in launched],
                      [b for _, b, *_ in launched])      # the one sync
        lap("sync")
        if events:
            stats["kernel_ms"] = stats.get("kernel_ms", 0.0) + sum(
                e[0].elapsed_time(e[1]) for e in events)
            stats["compose_ms"] = stats.get("compose_ms", 0.0) + sum(
                e[1].elapsed_time(e[2]) for e in events)
        row = 0
        for _, _, idxs, rounds, R_g, Sn_g, states_g in launched:
            for i in idxs:
                vd = host[row]
                row += 1
                fk, seg_ends, ops = metas[i]
                valid = bool(vd[0])
                if not valid and rounds < R_g:
                    # a speculative death is inconclusive: exact rerun
                    res = check(model, histories[i], max_states=max_states,
                                max_open_bits=max_open_bits,
                                localize=localize, device=dev)
                    res["pipelined"] = True
                    res["speculation"] = "exact-rerun"
                    results[i] = res
                    continue
                res = {"valid?": valid, "op_count": fk.n_calls,
                       "backend": dev.type, "engine": "wgl_seg",
                       "segments": len(seg_ends), "states": int(Sn_g),
                       "pipelined": True}
                if not valid:
                    _mark_dead(res, vd, localize, model, spec,
                               histories[i], ops, fk, seg_ends, states_g)
                results[i] = res
        lap("assemble")
    record = {"engine": "wgl_seg", "why": WHY, "batch": n,
              "device": str(dev), "R": R_cur or None,
              "stragglers": len(strag) or None}
    for r in results:
        if r is not None and "dispatch" not in r:
            r["dispatch"] = record
    for i in strag:
        try:
            results[i] = check(model, histories[i], max_states=max_states,
                               max_open_bits=max_open_bits,
                               localize=localize, device=dev)
        except Unsupported as e:
            results[i] = wgl_deep._unsupported(e, i)
    lap("stragglers")
    return results


# ---------------------------------------------------------------------------
# Many independent keys: one lane of the key kernel a key
# ---------------------------------------------------------------------------

def _scan_key(hist: History, spec, seen: dict, rows: list,
              max_open_bits: int):
    """One key scanned as one segment: with columns, the C stream pass at
    a target past its returns (so the only segment closes at its last
    return, which is quiescent in a history without crashed calls) and
    its wire; without, the C object scan (the caller packs the wire).
    Raises as `_scan_history`."""
    packed = planner.columns_of(hist)
    fk = None
    if packed is not None:
        fk = planner._native_scan_streams(packed, hist.ops, spec, seen,
                                          rows, max_open_bits,
                                          len(hist.ops) + 1)
    if fk is None:
        fk = planner._native_scan(hist.ops, spec, seen, rows, max_open_bits)
    return fk


def _key_wire(fk):
    """A scanned key's wire as one segment: the stream pass's, or, for a
    key scanned without columns, written here."""
    if isinstance(fk, planner._StreamKey):
        return fk.wire
    return regs_kernel.pack_stream(fk, [fk.n_rets], 1)


class _KeySort(NamedTuple):
    """The keys of a check_many batch sorted by where they go: results
    already decided on the host (None elsewhere), the key lanes and the
    deep keys as (i, scan, History), the crashed-call count of each key
    whose crash-stripped twin stands for it, the keys that go through
    check(), the lane keys' interned ops, and the keys that go to the
    fallback (a PreparedHistory, a key the scan refuses)."""
    results: list
    lanes: list
    deep: list
    twins: dict
    crash: list
    rows: list
    fall: list


def _sort_keys(spec, histories, max_open_bits: int,
               backend: str) -> _KeySort:
    """Scan every key and sort it (see check_many).  The lane keys share
    one alphabet: a key that turns out deeper than the lanes gives back
    the ops it interned, since the deep grid scans it again with its
    own, so it cannot grow the lanes' state space."""
    results: list = [None] * len(histories)
    seen: dict = {}
    rows: list = []
    lanes, deep, crash, twins, fall = [], [], [], {}, []
    host = {"valid?": True, "op_count": 0, "backend": backend,
            "engine": "wgl_seg_batch", "time_kernel_s": 0.0}
    for i, h in enumerate(histories):
        if isinstance(h, PreparedHistory):
            fall.append(i)
            continue
        hist = h if isinstance(h, History) else History(h)
        n0 = len(rows)
        try:
            fk = _scan_key(hist, spec, seen, rows, max_open_bits)
        except planner.CrashedCalls:
            drop, crashed = planner._split_crashed(hist.ops)
            keep = np.nonzero(~drop)[0]
            packed = planner.columns_of(hist)
            hist = History([hist.ops[p] for p in keep])
            if packed is not None:
                hist.attach_packed(packed.take(keep))
            try:
                fk = _scan_key(hist, spec, seen, rows, max_open_bits)
            except Unsupported:
                crash.append(i)
                continue
            if fk.n_calls == 0:
                results[i] = dict(host, crashed_ignored=len(crashed))
                continue
            twins[i] = len(crashed)
        except Unsupported:
            fall.append(i)
            continue
        if fk.n_calls == 0:
            results[i] = dict(host)
        elif fk.max_open <= planner.REGS_R_MAX:
            lanes.append((i, fk, hist))
        else:
            for op in rows[n0:]:
                del seen[op]
            del rows[n0:]
            deep.append((i, fk, hist))
    return _KeySort(results, lanes, deep, twins, crash, rows, fall)


class _KeyLaunch(NamedTuple):
    """The key launch's inputs on the host: the lane keys' wires, one
    segment a key (cbuf u8 in key order; offs int64[K] and nrows
    int32[K] in launch order, the longest key first, so that a warp's
    keys end together), the uop tables (aux), keys_scan's shapes, and
    `order`: launch position p holds lane key order[p]."""
    cbuf: np.ndarray
    offs: np.ndarray
    nrows: np.ndarray
    aux: np.ndarray
    R: int
    Sn: int
    UP: int
    order: np.ndarray


def _key_launch(model, spec, keys: _KeySort, max_states: int,
                lap, tables=None) -> _KeyLaunch:
    """The key launch over `keys.lanes` at the deepest lane key's R
    (`tables`: the lanes' `_model_tables`, when the caller has them).
    Raises Unsupported when their state space outgrows `max_states` or
    the segment kernel's gate."""
    R = max(int(fk.max_open) for _, fk, _ in keys.lanes)
    states, legal, next_state, dec = tables or _model_tables(
        spec, model, keys.rows, max_states)
    why = planner.regs_gate(R, states.shape[0], len(keys.rows),
                            dec[0] is not None)
    if why is not None:
        raise Unsupported(why)
    lap("tables")
    aux, UP = _aux(planner._pack_uop_tables(legal, next_state, *dec))
    grid = _SegGrid()
    for _, fk, _ in keys.lanes:
        grid.add_wire(*_key_wire(fk))
    cbuf, offs, nrows = grid.wire()
    order = np.argsort(-nrows, kind="stable")
    launch = _KeyLaunch(cbuf, offs[order], nrows[order], aux, R,
                        states.shape[0], UP, order)
    lap("pack")
    return launch


def key_launch_inputs(model, histories, *, max_states: int = 64,
                      max_open_bits: int = 10) -> _KeyLaunch:
    """The key launch check_many makes over `histories`, without
    launching it."""
    spec = model.device_spec()
    keys = _sort_keys(spec, histories, max_open_bits, "cpu")
    return _key_launch(model, spec, keys, max_states, lambda _: None)


def _run_keys(launch: _KeyLaunch, *, dev: torch.device, lap,
              stats: dict) -> tuple[np.ndarray, float]:
    """Every lane key's verdict from one key launch (`keys_scan`, exact
    rounds R): each key's wire is one segment (entering state 0), alive
    where a state survives its last row.  The verdicts and the kernel's
    refusal count come back in one copy.  Returns (alive bool[K] in lane
    key order, seconds from the launch to the end of that copy).  Raises
    when the kernel refused a key."""
    wire = tuple(regs_kernel.to_device(x, dev)
                 for x in launch[:4])
    ev = None
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.monotonic()
    if ev is not None:
        ev[0].record()
    T, bad = regs_kernel.keys_scan(*wire, R=launch.R, Sn=launch.Sn,
                                   UP=launch.UP)
    if ev is not None:
        ev[1].record()
    alive = T[:, 0, :].any(-1).to(torch.int32)
    stats["launches"] = stats.get("launches", 0) + 1
    lap("launch")
    host = torch.cat([bad, alive]).cpu().numpy()          # the one sync
    seconds = time.monotonic() - t0
    lap("sync")
    if ev is not None:
        stats["kernel_ms"] = (stats.get("kernel_ms", 0.0)
                              + ev[0].elapsed_time(ev[1]))
    if host[0]:
        raise RuntimeError(f"the key kernel refused {int(host[0])} keys")
    alive = np.empty(len(launch.order), bool)
    alive[launch.order] = host[1:] != 0
    return alive, seconds


def _cand_key_tables(keys: _KeySort, R: int):
    """The lane keys' candidate tables in `planner.plan`'s layout: each
    key one lane, its open sets padded to C = R candidates, the keys
    padded to a multiple of 128 (ret_slot int32[Kp, L], cand_slot and
    cand_uop int32[Kp, L, C])."""
    n = len(keys.lanes)
    Kp = max(128, -(-n // 128) * 128)
    L = planner._pad_len(max(fk.n_rets for _, fk, _ in keys.lanes))
    C = R
    ret_slot = np.full((Kp, L), -1, np.int32)
    cand_slot = np.zeros((Kp, L, C), np.int32)
    cand_uop = np.full((Kp, L, C), -1, np.int32)
    for kk, (_, fk, _) in enumerate(keys.lanes):
        rs, counts, cs, cu = planner._fk_arrays(fk)
        nr = len(rs)
        ret_slot[kk, :nr] = rs
        if len(cs):
            ends = np.cumsum(counts)
            r_idx = np.repeat(np.arange(nr), counts)
            j_idx = np.arange(ends[-1]) - np.repeat(ends - counts, counts)
            cand_slot[kk, r_idx, j_idx] = cs
            cand_uop[kk, r_idx, j_idx] = cu
    return ret_slot, cand_slot, cand_uop


def _cand_keys(keys: _KeySort, tables, *, dev, lap, stats: dict):
    """The lane keys the key launch refuses (Sn past 32, or a model
    without the decomposition) as one J = 1 launch of the candidate-table
    kernel `cand_gate` picks over their shared alphabet (the reference's
    `check_many` candidate lanes, tables of `_cand_key_tables`).  Returns
    (alive bool[n lanes], seconds from the launch to the end of the
    verdicts' copy, the form), or None where neither form takes the
    shape."""
    states, legal, next_state, dec = tables
    Sn = int(states.shape[0])
    R = max(int(fk.max_open) for _, fk, _ in keys.lanes)
    if planner.cand_gate(R, Sn, dec[0] is not None) not in \
            planner.CAND_FORMS:
        return None
    n = len(keys.lanes)
    ret_slot, cand_slot, cand_uop = _cand_key_tables(keys, R)
    lap("pack")
    ev = None
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.monotonic()
    if ev is not None:
        ev[0].record()
    T, bad, form = _cand_scan(ret_slot, cand_slot, cand_uop, legal,
                              next_state, dec, R=R, Sn=Sn, J=1, dev=dev)
    if ev is not None:
        ev[1].record()
    alive = T[:, 0, :].any(-1).to(torch.int32)
    stats["launches"] = stats.get("launches", 0) + 1
    lap("launch")
    host = torch.cat([bad, alive]).cpu().numpy()          # the one sync
    seconds = time.monotonic() - t0
    lap("sync")
    if ev is not None:
        stats["kernel_ms"] = (stats.get("kernel_ms", 0.0)
                              + ev[0].elapsed_time(ev[1]))
    if host[0]:
        raise RuntimeError(f"wgl_cand_{form} refused {int(host[0])} CTAs")
    return host[1:1 + n] != 0, seconds, form


def _localize_key(result: dict, model, hist) -> None:
    """An invalid key's witness and artifacts from the capped CPU oracle
    (ORACLE_CAPS); when the cap is hit the verdict stands without
    them."""
    oracle = wgl_cpu.check(model, hist, **ORACLE_CAPS)
    if oracle.get("valid?") is False:
        for key in ("op", "op_index", "final-paths", "configs"):
            if key in oracle:
                result[key] = oracle[key]


def check_many(model, histories, *, max_states: int = 64,
               max_open_bits: int = 10, localize: bool = True, device=None,
               stats=None, mesh=None, mesh_axis=None,
               fallback=None) -> list:
    """Check many independent histories (the keys of a
    `jepsen.independent` test; the reference's `check_many`): one result
    per key, in order.

    Every key is scanned in C.  A key without crashed calls at overlap
    depth R <= 6 is one segment and one lane of the key kernel
    (`regs_kernel.keys_scan`, `engine: "wgl_seg_batch_regs"`); these keys
    share one alphabet and one uop table, all run in one launch at exact
    rounds (the deepest such key's R), the longest first, and their
    verdicts come back in one copy.  Where their shared state space is
    past the key kernel's (more than 32 states, or a model without the
    diagonal + rank-1 decomposition), they run instead as one J = 1
    launch of a candidate-table kernel (`engine: "wgl_seg_batch"`, the
    reference's candidate lanes).  Keys at R
    7..16 go together through one `wgl_deep.check_pipeline` grid, which
    scans them with an alphabet of their own.  A key with crashed calls rides as
    its crash-stripped twin: a twin proved valid is the key's verdict
    (`crashed_ignored`), since no crashed call must be linearized; a
    key whose calls all crashed is valid; any other goes through
    `check()`'s crash tiers.  A key with no client call is valid.

    An invalid key's witness and artifacts (op, op_index, final-paths,
    configs) come from the CPU oracle under ORACLE_CAPS when `localize`
    is set (not for keys that went through `check()`, which localizes
    its own).  As in the reference, `fallback(model, prepared) -> dict`
    decides the keys the batched engines refuse (`engine: "fallback"`
    unless the result names its own): one the scan refuses, a
    PreparedHistory, one every crash tier leaves open, and every lane
    key when the batch's state space outgrows `max_states` or both
    lane kernels' gates.  The default is the serial frontier engine
    (`wgl.check` on `device`), and the CPU oracle where that raises
    ValueError.  A double invoke raises ValueError; a model without a
    device spec and `mesh` / `mesh_axis` (P8) raise Unsupported.

    A lane key's `time_kernel_s` is the key launch's, from the launch
    to the end of the verdicts' copy (the host wait included).
    `stats`, when given a dict, receives host seconds per stage (scan,
    tables, pack, launch, sync, assemble, deep, crash, fallback,
    localize), the key launches (`launches`) and, on a CUDA device,
    `kernel_ms`, the key launch's device time (CUDA events)."""
    if mesh is not None or mesh_axis is not None:
        raise Unsupported(f"check_many(mesh=..., mesh_axis=...): "
                          f"{planner.ITEM_MESH}")
    dev = resolve_device(device)
    spec = model.device_spec()
    if spec is None:
        raise Unsupported(f"model {model!r} has no device spec: "
                          f"{planner.ITEM_CPU_AUTO}")
    t0 = time.monotonic()
    stats = {} if stats is None else stats
    lap = wgl_deep._laps(stats)
    n = len(histories)
    keys = _sort_keys(spec, histories, max_open_bits, dev.type)
    results, lanes, deep, twins, crash = keys[:5]
    fall = list(keys.fall)
    lap("scan")

    R_lanes = max((int(fk.max_open) for _, fk, _ in lanes), default=0)
    invalid: list = []        # (i, History) to localize
    launch = tables = cand = None
    if lanes:
        try:
            tables = _model_tables(spec, model, keys.rows, max_states)
            launch = _key_launch(model, spec, keys, max_states, lap,
                                 tables=tables)
        except Unsupported:
            lap("tables")
    if lanes and launch is None and tables is not None:
        cand = _cand_keys(keys, tables, dev=dev, lap=lap, stats=stats)
    if lanes and launch is None and cand is None:
        fall.extend(i for i, _, _ in lanes)
    if launch is not None or cand is not None:
        if launch is not None:
            alive, t_kernel = _run_keys(launch, dev=dev, lap=lap,
                                        stats=stats)
            engine, record = "wgl_seg_batch_regs", None
        else:
            alive, t_kernel, form = cand
            engine = "wgl_seg_batch"
            record = {"engine": engine, "batch": n, "device": str(dev),
                      "R": R_lanes, "kernel": f"wgl_cand_{form}",
                      "form": form, "why": WHY_KEYS_CAND.format(form=form)}
        for (i, fk, hist), ok in zip(lanes, alive):
            res = {"valid?": bool(ok), "op_count": fk.n_calls,
                   "backend": dev.type, "engine": engine,
                   "time_kernel_s": t_kernel}
            if record is not None:
                res["dispatch"] = record
            results[i] = res
            if i in twins:
                if ok:
                    res["crashed_ignored"] = twins[i]
                else:
                    crash.append(i)
            elif not ok:
                res["anomaly"] = "nonlinearizable"
                invalid.append((i, hist))
        lap("assemble")

    R_deep = max((int(fk.max_open) for _, fk, _ in deep), default=0)
    if deep:
        dst: dict = {}
        out = wgl_deep.check_pipeline(
            model, [hist for _, _, hist in deep], max_open_bits=max_open_bits,
            max_states=max_states, stats=dst, device=dev)
        t_kernel = dst.get("launch", 0.0) + dst.get("sync", 0.0)
        for (i, _, hist), res in zip(deep, out):
            results[i] = res
            res.setdefault("time_kernel_s", t_kernel)
            if res.get("pipelined"):     # the grid's, not check()'s
                del res["dispatch"]
            if i in twins:
                if res["valid?"] is True:
                    res["crashed_ignored"] = twins[i]
                else:
                    crash.append(i)
            elif res["valid?"] is False:
                invalid.append((i, hist))
        lap("deep")

    for i in crash:
        t1 = time.monotonic()
        try:
            res = check(model, histories[i], max_states=max_states,
                        max_open_bits=max_open_bits, localize=localize,
                        device=dev)
        except Unsupported:
            fall.append(i)
            continue
        # the relaxed tier reports no kernel time: the call's own
        res.setdefault("time_kernel_s", time.monotonic() - t1)
        results[i] = res
    lap("crash")
    if fall:
        if fallback is None:
            fallback = _serial_fallback(dev)
        for i in fall:
            t1 = time.monotonic()
            h = histories[i]
            res = fallback(model, h if isinstance(h, PreparedHistory)
                           else prepare(h))
            res.setdefault("time_kernel_s", time.monotonic() - t1)
            results[i] = wgl.dispatched(res, "fallback", WHY_FALLBACK, n,
                                        dev)
    lap("fallback")
    if localize:
        for i, hist in invalid:
            _localize_key(results[i], model, hist)
    lap("localize")

    t_total = time.monotonic() - t0
    records = {eng: {"engine": eng, "why": why, "batch": n,
                     "device": str(dev), "R": R}
               for eng, why, R in (
                   ("wgl_seg_batch_regs", WHY_KEYS, R_lanes or None),
                   ("wgl_deep", WHY_KEYS_DEEP, R_deep or None),
                   ("wgl_seg_batch", WHY_KEYS_HOST, None))}
    for r in results:
        r["time_total_s"] = t_total
        if "dispatch" not in r:
            r["dispatch"] = records[r["engine"]]
    return results


def _serial_fallback(dev):
    """check_many's default fallback, the reference's: the serial
    frontier engine on `dev`, and the exact CPU oracle for a key whose
    plan that engine refuses as the reference's does with ValueError (an
    op past int32, or one the model has no f-code for: Unencodable).
    Nothing else reaches the CPU oracle: the kernel's own refusals
    (Unsupported) and failures raise."""
    def fallback(model, prep):
        try:
            return wgl.check(model, prep, device=dev)
        except Unencodable:
            return wgl_cpu.check(model, prep)
    return fallback
