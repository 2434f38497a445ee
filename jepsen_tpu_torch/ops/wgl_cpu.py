"""CPU linearizability oracle: just-in-time linearization with memoization.

The knossos-equivalent exact oracle, a copy of `jepsen_tpu.ops.wgl_cpu`.
In this package it serves three callers:

  1. `Linearizable(algorithm="cpu")`, when the caller asks for it;
  2. the final-paths / configs artifacts of an invalid device verdict,
     computed on the prefix through the witness;
  3. `wgl_seg.check_many`'s default fallback, for a key the serial
     frontier engine raises ValueError on (a value past int32), as in
     the reference.

Algorithm (Lowe-style JIT linearization, equivalent to knossos :linear):
walk history events in order keeping a set of *configurations*
(frozenset-of-linearized-open-calls, model).  When a call returns, expand
each configuration by linearizing pending calls until every surviving
configuration contains the returning call; configurations that cannot are
pruned.  If the set empties, the history is not linearizable and the
current op is the witness.  Crashed (:info) calls stay pending forever and
may be linearized at any later point or never
(`doc/tutorial/06-refining.md:12-19`).
"""

from __future__ import annotations

import time
from typing import Any, Optional

from jepsen_tpu_torch.models import is_inconsistent
from jepsen_tpu_torch.ops.prep import PreparedHistory, prepare


def check(model, history, *,
          max_configs: int = 1_000_000,
          time_limit: Optional[float] = None,
          cancel=None, initial_models=None) -> dict[str, Any]:
    """cancel: optional threading.Event — when set, the walk stops and
    returns {'valid?': 'cancelled'} (competition-mode loser).

    initial_models: optional list of models to seed the config set with
    INSTEAD of `model` — the segment-local witness replay passes every
    reachable entry state of the dead segment here, so the walk IS the
    union of the per-entry-state searches and its witness (first return
    at which the union empties) matches the whole-history oracle's by
    quiescent-cut compositionality.

    Returns a knossos-shaped analysis map:
    {'valid?': True|False|'unknown', 'op_count', 'configs', 'final_model'?,
     'op'? (witness), 'anomaly'?}."""
    t0 = time.monotonic()
    prep = history if isinstance(history, PreparedHistory) else prepare(history)
    calls = prep.calls

    configs: set[tuple[frozenset, Any]] = {
        (frozenset(), m)
        for m in (initial_models if initial_models is not None
                  else [model])}
    pending: set[int] = set()

    events_done = 0
    for ev, kind, cid in prep.events:
        events_done += 1
        if kind == 0:
            pending.add(cid)
            continue

        # Return of call `cid`: close configurations over one-step
        # linearizations of pending calls until all contain cid.
        done: set[tuple[frozenset, Any]] = set()
        frontier = configs
        seen = set(configs)
        while frontier:
            if cancel is not None and cancel.is_set():
                # competition mode lost the race: stop burning CPU
                return {"valid?": "cancelled", "op_count": len(calls)}
            if time_limit is not None and time.monotonic() - t0 > time_limit:
                return {"valid?": "unknown", "cause": "timeout",
                        "op_count": len(calls),
                        "events_done": events_done,
                        "events_total": len(prep.events)}
            nxt: set[tuple[frozenset, Any]] = set()
            for mask, m in frontier:
                if cid in mask:
                    done.add((mask, m))
                    continue
                for j in pending:
                    if j in mask:
                        continue
                    m2 = m.step(calls[j].op)
                    if is_inconsistent(m2):
                        continue
                    c2 = (mask | {j}, m2)
                    if c2 not in seen:
                        seen.add(c2)
                        nxt.add(c2)
            if len(seen) > max_configs:
                return {"valid?": "unknown", "cause": "config-explosion",
                        "op_count": len(calls), "configs": len(seen),
                        "events_done": events_done,
                        "events_total": len(prep.events)}
            frontier = nxt

        call = calls[cid]
        if not done:
            return {"valid?": False,
                    "op": call.op.to_dict(),
                    "op_index": call.op.index,
                    "op_count": len(calls),
                    "anomaly": "nonlinearizable",
                    "configs": _render_configs(configs, calls),
                    "final-paths": _final_paths(configs, calls, cid,
                                                pending)}
        # cid's slot retires: drop it from masks (it is now linearized in
        # every surviving configuration, so the bit carries no information).
        pending.discard(cid)
        configs = {(mask - {cid}, m) for mask, m in done}

    return {"valid?": True, "op_count": len(calls),
            "configs": _render_configs(configs, calls, limit=10)}


def _final_paths(configs, calls, failing_cid: int, pending,
                 limit: int = 10):
    """Why each surviving configuration could not linearize the failing
    call: for every config (truncated to `limit`, the reference's own
    cap — knossos final-paths 'can take *hours*' to write,
    checker.clj:155-158), the one-step expansion attempts from it and
    the inconsistency each produced."""
    from jepsen_tpu_torch.models import is_inconsistent

    paths = []
    for mask, m in list(configs)[:limit]:
        attempts = []
        for j in sorted(pending):
            if j in mask:
                continue
            m2 = m.step(calls[j].op)
            attempts.append({
                "op": calls[j].op.to_dict(),
                "result": (m2.msg if is_inconsistent(m2) else repr(m2)),
                "inconsistent": is_inconsistent(m2),
            })
        paths.append({
            "model": m,
            "pending-linearized": sorted(
                calls[c].op.index for c in mask
                if calls[c].op.index is not None),
            "attempts": attempts,
        })
    return paths


def _render_configs(configs, calls, limit: int = 10):
    """Human-readable configurations, truncated like the reference
    (checker.clj:155-158: writing them all 'can take *hours*')."""
    out = []
    for mask, m in list(configs)[:limit]:
        out.append({"model": m,
                    "pending-linearized": sorted(
                        calls[c].op.index for c in mask
                        if calls[c].op.index is not None)})
    return out
