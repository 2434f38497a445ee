"""History -> call-record preprocessing shared by the CPU oracle and the
device engines.

Semantics (knossos parity, see `doc/tutorial/06-refining.md:7-22`):
  * invoke/completion pairs are matched per process;
  * :fail completions mean the op never happened — the pair is dropped
    entirely (it must never be linearized);
  * :ok completions close the op; reads take their observed value from
    the completion (invoke carries None);
  * :info completions (and invokes that never complete) crash the op: it
    remains concurrent with *everything after it* and may be linearized
    at any later point, or never.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from jepsen_tpu_torch.history import History, Op

INF = 2 ** 62


@dataclasses.dataclass
class Call:
    """One logical operation: an invocation plus its (possible) completion."""

    id: int                 # dense call id, in invocation order
    process: int
    inv: int                # index of invocation event in the filtered history
    ret: int                # index of ok-completion event, or INF if crashed
    op: Op                  # invocation op with resolved value
    completion: Optional[Op]

    @property
    def is_crashed(self):
        return self.ret >= INF


@dataclasses.dataclass
class PreparedHistory:
    calls: list[Call]
    # events: (event_index, kind, call_id); kind 0=invoke 1=return.
    events: list[tuple[int, int, int]]
    max_open: int           # max simultaneously-open calls = mask width bound
    skipped: int            # ops dropped (fail pairs, nemesis, unpaired)


def prepare(history, client_only: bool = True) -> PreparedHistory:
    h = history if isinstance(history, History) else History(history)
    calls: list[Call] = []
    events: list[tuple[int, int, int]] = []
    skipped = 0

    # Filter to client ops ONCE (this function is the host-side hot
    # path for 1M-op histories; the old two-pass per-op type checks
    # dominated multi-key bench wall time).
    if client_only:
        flt = []
        append = flt.append
        for pos, o in enumerate(h.ops):
            p = o.process
            if type(p) is int and p >= 0:
                append((pos, o))
            else:
                skipped += 1
    else:
        flt = list(enumerate(h.ops))

    # First pass: pair ops and decide each invocation's fate.
    open_by_process: dict = {}
    fate: dict[int, tuple[str, Optional[Op]]] = {}  # pos -> (fate, completion)
    for pos, o in flt:
        t = o.type
        if t == "invoke":
            if o.process in open_by_process:
                raise ValueError(f"process {o.process} double-invoked at {pos}")
            open_by_process[o.process] = pos
        else:
            inv_pos = open_by_process.pop(o.process, None)
            if inv_pos is None:
                # Completion without invocation (e.g. history truncation):
                # treat like the reference does — ignore.
                skipped += 1
                continue
            fate[inv_pos] = (t, o)
    for inv_pos in open_by_process.values():
        fate[inv_pos] = ("info", None)  # never completed => crashed

    # Second pass: build calls + events, excluding fail pairs.
    open_count = 0
    max_open = 0
    open_call: dict = {}  # process -> call id of its currently-open call
    no_fate = ("info", None)
    for pos, o in flt:
        t = o.type
        if t == "invoke":
            kind, completion = fate.get(pos, no_fate)
            if kind == "fail":
                skipped += 2
                continue
            cid = len(calls)
            open_call[o.process] = cid
            value = o.value
            if completion is not None and completion.type == "ok" \
                    and value is None:
                value = completion.value
            inv_ev = len(events)
            # copy only when the resolved value differs (reads) — the
            # per-op assoc was the other prep hot spot
            inv_op = o if value is o.value else o.assoc(value=value)
            calls.append(Call(cid, o.process, inv_ev, INF,
                              inv_op, completion))
            events.append((inv_ev, 0, cid))
            open_count += 1
            if open_count > max_open:
                max_open = open_count
        elif t == "ok":
            cid = open_call.pop(o.process, None)
            if cid is None:
                continue
            ev = len(events)
            calls[cid].ret = ev
            events.append((ev, 1, cid))
            open_count -= 1
        elif t == "info":
            # Crashed: the process moves on but the call stays open for
            # linearization purposes forever (its slot is never freed).
            open_call.pop(o.process, None)

    return PreparedHistory(calls, events, max_open, skipped)
