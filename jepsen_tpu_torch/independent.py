"""Key-independent checking (the reference's `jepsen_tpu/independent.py`,
after jepsen's `independent.clj`): a test over many keys records op
values as [key value] tuples, and the checker splits the history into
one subhistory per key.  Short per-key histories are what keeps
linearizability checking cheap.

`batch_checker(model)` checks every key's subhistory in one
`ops.wgl_seg.check_many` call: each key one lane of the key kernel
(`wgl_regs_keys`, several keys a warp) on the card (or the kernels'
plain versions on a CPU device the caller names).
`batch_checker(Elle())` checks them through the Elle checker's
`check_many` (`checker.elle.BatchedElleChecker`).  The key generators
are workload code and are not here; the host-parallel `IndependentChecker` and the resilient runner behind the
reference's batch checker (OOM bisection, quarantine, deadlines,
checkpoints) are ROADMAP P4R, and the failing-window SVG is P6, as in
`checker.Linearizable`."""

from __future__ import annotations

from typing import Optional

from jepsen_tpu_torch.checker import Checker, merge_valid
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.ops import planner, wgl_seg


class KV(tuple):
    """A key/value tuple marking an op value as belonging to an
    independent key (independent.clj tuple :21-29)."""

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"[{self[0]!r} {self[1]!r}]"


def tuple_(k, v) -> KV:
    return KV(k, v)


def is_tuple(v) -> bool:
    return isinstance(v, KV)


def history_keys(history) -> set:
    return {o.value.key for o in History(history) if is_tuple(o.value)}


def subhistory(k, history) -> History:
    """All ops without a differing key; KV values unwrapped.  Un-keyed
    ops (nemesis, info) appear in every subhistory."""
    out = []
    for o in History(history):
        v = o.value
        if not is_tuple(v):
            out.append(o)
        elif v.key == k:
            out.append(o.assoc(value=v.value))
    return History(out)


class BatchedLinearizableChecker(Checker):
    """Every key's subhistory checked in one `wgl_seg.check_many` call on
    `device` (the card by default), keys in `repr` order: valid iff every
    key is, with each key's result under "results" and the keys not
    proved valid under "failures".  The reference's options that need
    what the port lacks raise Unsupported: `mesh` (P8), `deadline_s`,
    `max_retries` and `opts["checkpoint_dir"]` (the runner, P4R).
    `frontier_size` is advisory, as in the reference."""

    def __init__(self, model, frontier_size: int = 256, mesh=None,
                 deadline_s: Optional[float] = None, max_retries: int = 2,
                 device=None):
        if mesh is not None:
            raise Unsupported(f"a batch checker over a mesh: "
                              f"{planner.ITEM_MESH}")
        if deadline_s is not None or max_retries != 2:
            raise Unsupported(f"deadline_s / max_retries: "
                              f"{planner.ITEM_RUNNER}")
        self.model = model
        self.frontier_size = frontier_size
        self.device = device

    def check(self, test, history, opts=None):
        if (opts or {}).get("checkpoint_dir"):
            raise Unsupported(f"checkpoint_dir: {planner.ITEM_RUNNER}")
        ks = sorted(history_keys(history), key=repr)
        if not ks:
            return {"valid?": True, "results": {}, "failures": []}
        subs = [subhistory(k, history) for k in ks]
        results = dict(zip(ks, wgl_seg.check_many(self.model, subs,
                                                  device=self.device)))
        failures = [k for k, r in results.items() if r["valid?"] is not True]
        return {"valid?": merge_valid(r["valid?"] for r in results.values()),
                "results": results,
                "failures": failures}


def batch_checker(model_or_checker, frontier_size: int = 256, mesh=None,
                  device=None):
    """The batched independent checker.  Handed a model, every key's
    subhistory is one lane of `wgl_seg.check_many` on `device`.  Handed
    a Checker that batches through its own `check_many` (`checker.elle.
    Elle`), the same key split batches through that checker, which
    carries its own device (so `device` must be None there), as the
    reference routes it."""
    if isinstance(model_or_checker, Checker) \
            and callable(getattr(model_or_checker, "check_many", None)):
        if device is not None:
            raise ValueError("pass the device to the checker itself, "
                             "not to batch_checker")
        from jepsen_tpu_torch.checker.elle import BatchedElleChecker
        return BatchedElleChecker(model_or_checker)
    return BatchedLinearizableChecker(model_or_checker, frontier_size, mesh,
                                      device=device)
