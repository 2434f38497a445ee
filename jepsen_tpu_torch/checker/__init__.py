"""Checkers: validate that a history is correct.

The `Checker` protocol and the linearizability checker, which runs
`ops.wgl_seg.check` on the card (or the kernels' plain versions on a CPU
device the caller names) instead of knossos: the register-delta segment
kernel at overlap depth R <= 6, the deep-overlap kernel at 7..16, and
the crash tiers for histories with crashed (:info) calls.  A history
those refuse (`Unsupported`) goes to the serial frontier engine
(`ops.wgl.check`), as in the reference.  Every checker returns a dict
with at least a "valid?" key: True, False or "unknown"."""

from __future__ import annotations

from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.ops import planner, wgl, wgl_cpu, wgl_seg

UNKNOWN = "unknown"

#: Larger numbers dominate when checkers compose (the reference's
#: checker.clj:26-31).
VALID_PRIORITIES = {True: 0, False: 1, UNKNOWN: 0.5}


def merge_valid(valids):
    """Merge n valid? values, yielding the highest-priority one
    (checker.clj:33-47)."""
    out = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid? value")
        if VALID_PRIORITIES[out] < VALID_PRIORITIES[v]:
            out = v
    return out


class Checker:
    """`test` is the test map (may be None for pure checkers); `opts`
    carries e.g. :subdirectory for artifact output."""

    def check(self, test, history, opts=None) -> dict:
        raise NotImplementedError


class Linearizable(Checker):
    """algorithm: 'device' (or 'auto', the same here) checks on
    `device`, the card by default: `wgl_seg.check` first, and a history
    it refuses (`Unsupported`: overlap past max_open_bits or 16, states
    past max_states, crashed calls no crash tier settles) through the
    serial frontier engine `wgl.check`, as the reference's
    `_device_check` does.  'cpu' runs the exact CPU oracle because the
    caller asks for it.  A model without a device spec raises
    Unsupported under 'device'/'auto'.

    Keyword options: max_states, max_open_bits, localize (the segment
    check); frontier_sizes, pad (the serial engine); stats (either);
    max_configs, time_limit (the CPU oracle)."""

    _SEG_KEYS = ("max_states", "max_open_bits", "localize", "stats")
    _SER_KEYS = ("frontier_sizes", "pad")
    _CPU_KEYS = ("max_configs", "time_limit")

    def __init__(self, model=None, algorithm: str = "auto", device=None,
                 **kw):
        if model is None:
            raise ValueError(
                "The linearizable checker requires a model. It received: "
                "None instead.")
        if algorithm == "competition":
            raise Unsupported(f"competition mode: {planner.ITEM_CPU_AUTO}")
        if algorithm not in ("auto", "device", "cpu"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        unknown = (set(kw) - set(self._SEG_KEYS) - set(self._SER_KEYS)
                   - set(self._CPU_KEYS))
        if unknown:
            raise TypeError(f"unknown linearizable checker option(s): "
                            f"{sorted(unknown)}")
        self.model = model
        self.algorithm = algorithm
        self.device = device
        self.kw = kw

    def check(self, test, history, opts=None):
        if self.algorithm == "cpu":
            a = wgl_cpu.check(self.model, history,
                              **{k: v for k, v in self.kw.items()
                                 if k in self._CPU_KEYS})
        else:
            try:
                a = wgl_seg.check(self.model, history, device=self.device,
                                  **{k: v for k, v in self.kw.items()
                                     if k in self._SEG_KEYS})
            except Unsupported as e:
                a = wgl.decide(self.model, history, device=self.device,
                               why=f"the batched engines refuse it: {e}",
                               **{k: v for k, v in self.kw.items()
                                  if k in self._SER_KEYS + ("stats",)})
        if (a.get("valid?") is False and "final-paths" not in a
                and not a.get("localized")
                and a.get("op_index") is not None):
            # artifact parity: device verdicts name a witness but carry
            # no configs or final-paths; rebuild both from the CPU oracle
            # on the prefix through the witness's COMPLETION (cut at its
            # invocation and the call looks crashed)
            try:
                hist = History(history)
                wit = next((o for o in hist
                            if o.index == a["op_index"]), None)
                cutoff = a["op_index"]
                if wit is not None:
                    for o in hist:
                        if (o.index is not None
                                and o.index > a["op_index"]
                                and o.process == wit.process
                                and not o.is_invoke):
                            cutoff = o.index
                            break
                prefix = History(
                    [o for o in hist
                     if o.index is not None and o.index <= cutoff])
                oracle = wgl_cpu.check(self.model, prefix, time_limit=15,
                                       max_configs=500_000)
                for key in ("configs", "final-paths"):
                    if key in oracle and key not in a:
                        a[key] = oracle[key]
            except ValueError as e:
                a["final-paths-error"] = str(e)
        # writing every config "can take hours": keep the first ten; the
        # config-explosion verdict sets 'configs' to a count
        if isinstance(a.get("configs"), list):
            a["configs"] = a["configs"][:10]
        if isinstance(a.get("final-paths"), list):
            a["final-paths"] = a["final-paths"][:10]
        return a


def linearizable(opts_or_model=None, **kw) -> Checker:
    """linearizable({'model': m, 'algorithm': ...}) or
    linearizable(model, ...)."""
    if isinstance(opts_or_model, dict):
        o = dict(opts_or_model)
        return Linearizable(o.pop("model", None), o.pop("algorithm", "auto"),
                            **o, **kw)
    return Linearizable(opts_or_model, **kw)
