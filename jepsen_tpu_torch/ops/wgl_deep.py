"""Deep-overlap linearizability checking: the host side of the deep
kernel (`ops.deep_kernel`), from packed register-delta tables or whole
histories to verdicts and exact witnesses.

Semantics are just-in-time linearization (Lowe / knossos :linear): at
the return of call t, configurations lacking t are closed under
linearizing any open call (to a fixpoint, with expansion sources
restricted to configurations still lacking t), then pruned to those
containing t.  A pure op legal on every configuration lacking it skips
the closure.  The frontier is the full powerset of open calls times the
model states, so verdicts are exact in both directions, and an invalid
verdict names the exact failing event, which `map_witness` maps to the
failing call's invoke op.

The model must decompose into diagonal + rank-1 transitions with at
most 32 states, at overlap depth R <= 16; crashed calls ride as
permanent slots, counted in R (`ops.wgl_seg`'s crash tier 2).
Everything else raises `Unsupported` (see ops.planner), except in
`check_pipeline`, whose stragglers go on to the serial frontier engine
(`ops.wgl`) as the reference's do.  `ops.wgl_seg` routes only R 7..16
here, as the reference does; this module's own entry points
(`check_tables`, `check_pipeline`) walk any depth 1..16 a caller hands
them."""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.ops import deep_kernel, planner, wgl

EB = deep_kernel.EB

WHY = ("deep-overlap kernel: decomposable model with Sn <= 32 and overlap "
       "depth 7 <= R <= 16 (R <= 6 runs the register-delta segment "
       "kernel, ops.wgl_seg)")


def _snp(Sn: int) -> int:
    return 8 if Sn <= 8 else 16 if Sn <= 16 else 32


def _pad_g(g: int) -> int:
    """Event-block count bucketing: pow2 to 16, then 8-multiples."""
    if g <= 1:
        return 1
    b = 1
    while b < g and b < 16:
        b *= 2
    return b if g <= 16 else ((g + 7) // 8) * 8


def pack_events_compact(ret_t: np.ndarray, islot_t: np.ndarray,
                        iuop_t: np.ndarray) -> tuple[np.ndarray, int]:
    """The u8 compact wire of one history's event rows: ret+1 u8[L2]
    (0 = no return) ++ islot+1 u8[L2*I] ++ iuop u16-LE bytes[2*L2*I],
    with L2 = G * EB rows and I = islot_t.shape[2] (the kernel reads
    I = 2; `_widen` brings I = 1 tables there).  Padding uops are
    clamped to 0: the kernel reads a row's uop only where its
    islot >= 0."""
    Lp = ret_t.shape[0]
    I = islot_t.shape[2]
    G = _pad_g((Lp + EB - 1) // EB)
    L2 = G * EB
    ret = np.zeros(L2, np.uint8)
    ret[:Lp] = (ret_t[:, 0].astype(np.int32) + 1).astype(np.uint8)
    islot = np.zeros((L2, I), np.uint8)
    islot[:Lp] = (islot_t[:, 0, :].astype(np.int32) + 1).astype(np.uint8)
    iuop = np.zeros((L2, I), np.uint16)
    iuop[:Lp] = np.maximum(
        iuop_t[:, 0, :].astype(np.int32), 0).astype(np.uint16)
    return np.concatenate([ret, islot.ravel(),
                           iuop.ravel().view(np.uint8)]), G


def pack_aux(a1t: np.ndarray, a2t: np.ndarray, t0t: np.ndarray,
             UP: int) -> np.ndarray:
    """[U] uop tables -> u32[3*UP]: diag ++ const ++ t0, the first
    3*UP words of the reference's aux layout (the kernel keeps the
    lacks-bit patterns the reference appends in constant memory)."""
    U = a1t.shape[0]
    aux = np.zeros(3 * UP, np.uint32)
    aux[:U] = a1t
    aux[UP:UP + U] = a2t
    aux[2 * UP:2 * UP + U] = t0t.astype(np.uint32)
    return aux


def _pad_u(u: int) -> int:
    b = 8
    while b < u:
        b *= 2
    return b


def _as_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _widen(islot_t: np.ndarray, iuop_t: np.ndarray):
    """Register tables with I = 1 (the reference's I = min(2, R) at
    R = 1) as I = 2 tables whose second invoke column is empty."""
    if islot_t.shape[2] == deep_kernel.I:
        return islot_t, iuop_t
    if islot_t.shape[2] != 1:
        raise ValueError(f"register tables with I = {islot_t.shape[2]}")
    return (np.concatenate([islot_t, np.full_like(islot_t, -1)], axis=2),
            np.concatenate([iuop_t, np.zeros_like(iuop_t)], axis=2))


class _Grid:
    """The histories of one kernel grid: their compact wires, each with
    its own overlap depth, under one aux table (`set_tables`).  The
    depths are checked here, on the host, before any pointer reaches
    the kernel."""

    def __init__(self):
        self.bufs: list = []
        self.offs: list = []
        self.rows: list = []
        self.depth: list = []
        self.size = 0
        self.aux = None
        self.UP = 0
        self.Sn = 0

    @property
    def R(self) -> int:
        return max(self.depth)

    def add(self, cbuf: np.ndarray, G: int, R: int):
        if not 1 <= R <= planner.deep_r_max():
            raise ValueError(f"overlap depth {R} outside the kernel")
        self.offs.append(self.size)
        self.rows.append(G * EB)
        self.depth.append(R)
        self.bufs.append(cbuf)
        self.size += cbuf.nbytes

    def set_tables(self, a1t, a2t, t0t, Sn: int):
        self.UP = _pad_u(a1t.shape[0])
        self.aux = pack_aux(_as_numpy(a1t), _as_numpy(a2t), _as_numpy(t0t),
                            self.UP)
        self.Sn = Sn

    def shape(self) -> dict:
        """deep_walk's shape arguments for this grid."""
        return dict(R=self.R, SnP=_snp(self.Sn), UP=self.UP)

    def to_device(self, dev: torch.device):
        """deep_walk's tensors (cbuf, offs, nrows, depth, aux) on `dev`:
        copies that finish before the host goes on, so launch after
        every copy."""
        return (torch.from_numpy(np.concatenate(self.bufs)).to(dev),
                torch.tensor(self.offs, dtype=torch.int64, device=dev),
                torch.tensor(self.rows, dtype=torch.int32, device=dev),
                torch.tensor(self.depth, dtype=torch.int32, device=dev),
                torch.from_numpy(self.aux.view(np.int32)).to(dev))


def check_tables(ret_t, islot_t, iuop_t, a1t, a2t, t0t, R: int, Sn: int,
                 *, device=None) -> dict[str, Any]:
    """Run the deep kernel on one history's register-delta tables
    (numpy arrays or tensors, from planner._pack_regs with K = 1 and
    planner._pack_uop_tables) and fetch the verdict: {"valid?": bool,
    "failed_row": int | None, ...}; failed_row indexes ret_t's rows."""
    dev = resolve_device(device)
    t1 = time.monotonic()
    ret_t, islot_t, iuop_t = (_as_numpy(x) for x in (ret_t, islot_t,
                                                      iuop_t))
    cbuf, G = pack_events_compact(ret_t, *_widen(islot_t, iuop_t))
    grid = _Grid()
    grid.add(cbuf, G, R)
    grid.set_tables(a1t, a2t, t0t, Sn)
    out = deep_kernel.deep_walk(*grid.to_device(dev), **grid.shape()).cpu()
    alive = bool(out[0, 0])
    res = {"valid?": alive,
           "failed_row": None if alive else int(out[0, 1]),
           "time_kernel_s": time.monotonic() - t1,
           "grid": G}
    P = planner.deep_split_planes(R)
    if P > 1:
        res["deep_variant"] = "word-split"
        res["shards"] = P
    return res


def map_witness(ret_t, fk, ops, failed_row):
    """Map a failing event row to the failing call's INVOKE op, the
    witness the oracle names.  Returns (op, op_index, return_position),
    or None when there is no row."""
    if failed_row is None or not len(fk.positions):
        return None
    ordinal = int((_as_numpy(ret_t)[:failed_row + 1, 0] >= 0).sum()) - 1
    if not (0 <= ordinal < len(fk.positions)):
        return None
    pos = int(fk.positions[ordinal])
    p = ops[pos].process
    inv = pos
    while inv >= 0 and not (ops[inv].process == p
                            and ops[inv].type == "invoke"):
        inv -= 1
    op = ops[max(inv, 0)]
    return op, (op.index if op.index is not None else max(inv, 0)), pos


def _unsupported(e: Unsupported, i: int) -> dict[str, Any]:
    e.history_index = i
    return {"valid?": "unknown", "cause": "unsupported",
            "error": e.to_dict()}


def _laps(stats: dict):
    """A function that adds the seconds since its last call to
    stats[key]."""
    clock = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        stats[key] = stats.get(key, 0.0) + now - clock[0]
        clock[0] = now
    return lap


def pack_pipeline(model, histories, *, max_open_bits=None,
                  max_states: int = 64, stats=None, device=None):
    """The host half of `check_pipeline`: scan (in C), gate and pack
    every history into one grid, each history's tables from the scan's
    delta stream (`planner._pack_regs_single`).  Returns (results,
    grid, pend): `results` holds the entries already decided on the
    host (empty histories) and None for the rest; `grid` is the `_Grid`
    to launch; pend[k] = (i, fk, ret_t, ops, R, Sn) describes the grid's
    k-th CTA, history i.  A straggler is in neither: its entry stays
    None.  These are a history with crashed calls, one the scan or the
    deep gate refuses, and every history from the one whose alphabet
    the batch's state space could not take."""
    dev = resolve_device(device)
    spec = model.device_spec()
    if spec is None:
        raise Unsupported(f"model {model!r} has no device spec: "
                          f"{planner.ITEM_CPU_AUTO}")
    lap = _laps({} if stats is None else stats)
    if max_open_bits is None:
        max_open_bits = planner.deep_r_max()
    results: list = [None] * len(histories)
    seen: dict = {}
    rows: list = []
    U_at = -1
    Sn = 0
    tables = None
    batch_tables = None
    pend: list = []
    grid = _Grid()
    init = np.asarray(spec.encode(model), np.int32)
    for i, h in enumerate(histories):
        ops = h.ops
        try:
            fk = planner._scan_history(planner.columns_of(h), ops, spec,
                                       seen, rows, max_open_bits,
                                       want_snaps=False)
        except Unsupported:
            # crashed calls (check_pipeline's crash tiers take them) or a
            # history the scan refuses (R past max_open_bits): stragglers
            lap("scan")
            continue
        lap("scan")
        if fk.n_calls == 0:
            results[i] = {"valid?": True, "op_count": 0,
                          "backend": dev.type, "engine": "wgl_deep"}
            continue
        R = int(fk.max_open)
        if len(rows) != U_at:
            uops = np.asarray(rows, np.int32).reshape(len(rows), 4)
            # the alphabet, and with it the state space, only grows (and
            # an undecomposable one stays so): past a failure this
            # history and every later one stay None, stragglers that
            # check_pipeline checks one by one on their own alphabets
            try:
                states, legal, next_state = planner._enumerate_states(
                    spec, init, uops, max_states)
            except Unsupported:
                break
            dw, cw, t0c = planner._decompose(legal, next_state)
            if dw is None:
                break
            Sn = states.shape[0]
            tables = planner._pack_uop_tables(legal, next_state, dw, cw,
                                              t0c)
            U_at = len(rows)
        lap("tables")
        if planner.deep_gate(R, Sn, len(rows), True) is not None:
            continue                 # a straggler
        # the grid runs under the newest uop tables an in-scope history
        # was gated with: interning only appends uops and enumeration
        # only adds states, so this version covers every earlier
        # in-scope history's ops with the same transitions (state
        # indices may differ, but the walk only tests legality and
        # targets, and init is index 0 in every version), and unreached
        # states stay empty rows: one aux table serves the batch with
        # unchanged (alive, first dead row)
        batch_tables = (*tables, Sn)
        # every wire has I = 2 invoke columns: an R = 1 history packs as
        # exactly as under the reference's I = 1 (the second stays empty)
        ret_t, islot_t, iuop_t, _ = planner._pack_regs_single(
            fk, R, len(rows), deep_kernel.I)
        cbuf, G = pack_events_compact(ret_t, islot_t, iuop_t)
        grid.add(cbuf, G, R)
        pend.append((i, fk, ret_t, ops, R, Sn))
        lap("pack")
    if pend:
        grid.set_tables(*batch_tables)
    return results, grid, pend


def check_pipeline(model, histories, *, max_open_bits=None,
                   max_states: int = 64, stats=None,
                   device=None) -> list:
    """Check many histories at once: scan and pack every history on the
    host (`pack_pipeline`), copy all wires, launch one grid (one CTA per
    history, each at its own overlap depth) on the current stream, and
    synchronise once for all verdicts.

    The stragglers, as in the reference: a history with crashed calls,
    one the scan refuses (R past `max_open_bits`, by default 16) or the
    deep gate refuses, and, once the shared alphabet's state space
    fails (too many states, undecomposable), that history and every
    later one.  Each goes through `wgl_seg.check` after the grid, on its
    own alphabet, and where that raises Unsupported through the serial
    frontier engine (`wgl.check`, `engine: "wgl"`), which has no
    overlap-depth limit; a straggler never poisons the batch.

    `stats`, when given a dict, receives host seconds per stage (scan,
    tables, pack, copy, launch, sync, assemble) and, on a CUDA device,
    `kernel_ms`, the grid's device time (CUDA events)."""
    dev = resolve_device(device)
    stats = {} if stats is None else stats
    results, grid, pend = pack_pipeline(
        model, histories, max_open_bits=max_open_bits,
        max_states=max_states, stats=stats, device=dev)
    lap = _laps(stats)
    if pend:
        wire = grid.to_device(dev)
        lap("copy")
        timed = dev.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        out = deep_kernel.deep_walk(*wire, **grid.shape())
        if timed:
            ev1.record()
        lap("launch")
        host = out.cpu()                                # the one sync
        if timed:
            stats["kernel_ms"] = stats.get("kernel_ms", 0.0) + \
                ev0.elapsed_time(ev1)
        lap("sync")
        for k, (i, fk, ret_t, ops, R, Sn_i) in enumerate(pend):
            alive = bool(host[k, 0])
            res = {"valid?": alive, "op_count": fk.n_calls,
                   "backend": dev.type, "engine": "wgl_deep",
                   "max_open": R, "states": Sn_i, "pipelined": True}
            P = planner.deep_split_planes(R)
            if P > 1:
                res["deep_variant"] = "word-split"
                res["shards"] = P
            if not alive:
                res["anomaly"] = "nonlinearizable"
                w = map_witness(ret_t, fk, ops, int(host[k, 1]))
                if w is not None:
                    res["op"] = w[0].to_dict()
                    res["op_index"] = w[1]
            results[i] = res
        lap("assemble")
    record = {"engine": "wgl_deep", "why": WHY, "batch": len(histories),
              "device": str(dev)}
    for r in results:
        if r is not None and r.get("engine") == "wgl_deep":
            r["dispatch"] = record
    from jepsen_tpu_torch.ops import wgl_seg    # wgl_seg imports this module
    for i, r in enumerate(results):
        if r is None:
            try:
                results[i] = wgl_seg.check(
                    model, histories[i], max_states=max_states,
                    max_open_bits=(planner.deep_r_max() if max_open_bits
                                   is None else max_open_bits), device=dev)
                continue
            except Unsupported as e:
                why = e
            results[i] = wgl.decide(
                model, histories[i], device=dev,
                why=f"deep straggler beyond every batched gate ({why})")
    lap("stragglers")
    return results
