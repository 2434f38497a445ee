"""Single-history linearizability check: `check()`, the entry point the
`Linearizable` checker calls.

The reference routes a history by its overlap depth R: the register-
delta segment kernel at R <= 6, the deep kernel at 7..16.  Only the
deep kernel is ported so far, and it is exact at every R, so every
in-scope history runs it (`engine: "wgl_deep"`; the dispatch record's
`why` says so).  Shapes outside the slice raise `Unsupported` naming
the ROADMAP item that will cover them; nothing falls through to another
engine."""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.ops import deep_kernel, planner, wgl_cpu, wgl_deep


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
                               time_limit=15, max_configs=500_000)
        if oracle.get("valid?") is False:
            for key in ("final-paths", "configs"):
                if key in oracle:
                    result[key] = oracle[key]
    return result


def check(model, history, *, max_states: int = 64, max_open_bits: int = 10,
          localize: bool = True, device=None) -> dict[str, Any]:
    """Linearizability of one history on the deep kernel.  Returns a
    knossos-shaped analysis map with a `dispatch` record.  Raises
    Unsupported for a history or model outside the slice and
    BackendUnavailable when the device is missing."""
    dev = resolve_device(device)
    spec = model.device_spec()
    if spec is None:
        raise Unsupported(f"model {model!r} has no device spec: "
                          f"{planner.ITEM_CPU_AUTO}")
    t0 = time.monotonic()
    seen: dict = {}
    rows: list = []
    ops = history.ops if isinstance(history, History) else \
        History(history).ops
    fk = planner._fast_scan(ops, spec, seen, rows, max_open_bits)
    record = {"engine": "wgl_deep", "why": wgl_deep.WHY, "batch": 1,
              "device": str(dev)}
    if fk.n_calls == 0:
        return {"valid?": True, "op_count": 0, "backend": dev.type,
                "engine": "wgl_deep", "dispatch": record}
    uops = np.asarray(rows, np.int32).reshape(len(rows), 4)
    init = np.asarray(spec.encode(model), np.int32)
    states, legal, next_state = planner._enumerate_states(
        spec, init, uops, max_states)
    Sn = states.shape[0]
    R = int(fk.max_open)
    diag_w, const_w, const_t0 = planner._decompose(legal, next_state)
    why = planner.deep_gate(R, Sn, int(legal.shape[0]),
                            diag_w is not None)
    if why is not None:
        raise Unsupported(why)
    result = _check_deep(model, ops, fk, legal, next_state, diag_w,
                         const_w, const_t0, R=R, Sn=Sn,
                         localize=localize, device=dev, t0=t0)
    result["dispatch"] = dict(record, R=R)
    return result
