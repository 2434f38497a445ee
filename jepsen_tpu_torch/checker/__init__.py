"""Checkers: validate that a history is correct.

The `Checker` protocol, `check_safe`, the `merge_valid` lattice,
`compose` and the built-in checkers of the reference's `checker.clj`:

- `Linearizable` runs `ops.wgl_seg.check` on the card (or the kernels'
  plain versions on a CPU device the caller names) instead of knossos:
  the register-delta segment kernel at overlap depth R <= 6, the
  deep-overlap kernel at 7..16, and the crash tiers for histories with
  crashed (:info) calls.  A history those refuse (`Unsupported`) goes to
  the serial frontier engine (`ops.wgl.check`), as in the reference.
- `Set` and `UniqueIds` run their set algebra on the card through
  `ops.fold` (the kernel `fold_member`) when every value is an int and
  the history is large (`DEVICE_THRESHOLD`), and on host sets otherwise,
  as the reference routes them; they take `device`.
- `Queue`, `SetFull`, `TotalQueue` and `CounterChecker` are host loops,
  as in the reference.

Every checker returns a dict with at least a "valid?" key: True, False
or "unknown".  The render checkers (latency, rate and clock plots) are
ROADMAP P6."""

from __future__ import annotations

import threading
import traceback
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import is_inconsistent
from jepsen_tpu_torch.ops import fold, planner, wgl, wgl_cpu, wgl_seg

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


def check_safe(checker, test, history, opts=None) -> dict:
    """checker.clj:77-88: a checker's exception becomes {"valid?":
    "unknown", "error": the traceback}."""
    try:
        return checker.check(test, history, opts or {})
    except Exception:
        return {"valid?": UNKNOWN, "error": traceback.format_exc()}


class Noop(Checker):
    def check(self, test, history, opts=None):
        return None


def noop():
    return Noop()


class UnbridledOptimism(Checker):
    """Everything is awesoooommmmme! (checker.clj:120-124)"""

    def check(self, test, history, opts=None):
        return {"valid?": True}


def unbridled_optimism():
    return UnbridledOptimism()


class Compose(Checker):
    """checker.clj:90-102: runs a map of checkers in parallel (threads,
    each through `check_safe`); the result map plus a merged "valid?"."""

    def __init__(self, checker_map: dict):
        self.checker_map = dict(checker_map)

    def check(self, test, history, opts=None):
        if not self.checker_map:
            return {"valid?": True}
        with ThreadPoolExecutor(max_workers=len(self.checker_map)) as ex:
            futs = {k: ex.submit(check_safe, c, test, history, opts)
                    for k, c in self.checker_map.items()}
            results = {k: f.result() for k, f in futs.items()}
        out: dict = dict(results)
        out["valid?"] = merge_valid(
            r["valid?"] for r in results.values() if r is not None)
        return out


def compose(checker_map: dict) -> Checker:
    return Compose(checker_map)


class ConcurrencyLimit(Checker):
    """checker.clj:104-119: at most `limit` concurrent checks of a
    memory-heavy checker."""

    def __init__(self, limit: int, checker: Checker):
        self.sem = threading.Semaphore(limit)
        self.checker = checker

    def check(self, test, history, opts=None):
        with self.sem:
            return self.checker.check(test, history, opts)


def concurrency_limit(limit: int, checker: Checker) -> Checker:
    return ConcurrencyLimit(limit, checker)


class Linearizable(Checker):
    """algorithm: 'device' (or 'auto', the same here) checks on
    `device`, the card by default: `wgl_seg.check` first (its results,
    the candidate-table route's included, carry their dispatch record),
    and a history it refuses (`Unsupported`: overlap past max_open_bits
    or 16, or past 10 beyond the deep kernel's states, states past
    max_states, crashed calls no crash tier settles) through the
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


# ---------------------------------------------------------------------------
# Queue (model reduction), checker.clj:160-180
# ---------------------------------------------------------------------------

class Queue(Checker):
    """Every dequeue must come from somewhere: every non-failing enqueue
    is assumed to have happened and only ok dequeues; the model is
    stepped through them."""

    def __init__(self, model):
        self.model = model

    def check(self, test, history, opts=None):
        m = self.model
        for o in History(history):
            if (o.f == "enqueue" and o.is_invoke) or \
                    (o.f == "dequeue" and o.is_ok):
                if m is None:
                    continue
                m = m.step(o)
                if is_inconsistent(m):
                    return {"valid?": False, "error": m.msg}
        return {"valid?": True, "final-queue": m}


def queue(model):
    return Queue(model)


# ---------------------------------------------------------------------------
# Set, checker.clj:182-233
# ---------------------------------------------------------------------------

def integer_interval_set_str(xs) -> str:
    """Compact sorted form, #{1..3 5} (util.clj:528-553)."""
    xs = sorted(xs)
    if any(not isinstance(x, int) or isinstance(x, bool) for x in xs):
        return "#{" + " ".join(str(x) for x in xs) + "}"
    runs = []
    start = end = None
    for cur in xs:
        if start is None:
            start = end = cur
        elif cur == end + 1:
            end = cur
        else:
            runs.append((start, end))
            start = end = cur
    if start is not None:
        runs.append((start, end))
    return "#{" + " ".join(
        str(s) if s == e else f"{s}..{e}" for s, e in runs) + "}"


class Set(Checker):
    """Adds followed by a final read: every acknowledged add must be
    present, and nothing unattempted may appear.  Integer histories of
    at least DEVICE_THRESHOLD attempts and read elements run the
    membership algebra on `device` (`ops.fold.set_masks`, the card by
    default); the others run host sets, as the reference routes them."""

    DEVICE_THRESHOLD = 4096

    def __init__(self, device=None):
        self.device = device

    def check(self, test, history, opts=None):
        attempts, adds, final_read = [], [], None
        for o in History(history):
            if o.f == "add" and o.is_invoke:
                attempts.append(o.value)
            elif o.f == "add" and o.is_ok:
                adds.append(o.value)
            elif o.f == "read" and o.is_ok:
                final_read = o.value
        if final_read is None:
            return {"valid?": UNKNOWN, "error": "Set was never read"}

        final_read = list(set(final_read))
        if (fold.all_ints(attempts) and fold.all_ints(adds)
                and fold.all_ints(final_read)
                and len(attempts) + len(final_read) >= self.DEVICE_THRESHOLD):
            ok_m, unexpected_m, lost_m, recovered_m = fold.set_masks(
                attempts, adds, final_read, device=self.device)
            ok = {v for v, m in zip(final_read, ok_m) if m}
            unexpected = {v for v, m in zip(final_read, unexpected_m) if m}
            lost = {v for v, m in zip(adds, lost_m) if m}
            recovered = {v for v, m in zip(final_read, recovered_m) if m}
        else:
            attempts_s, adds_s, read_s = \
                set(attempts), set(adds), set(final_read)
            ok = read_s & attempts_s
            unexpected = read_s - attempts_s
            lost = adds_s - read_s
            recovered = ok - adds_s

        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "recovered-count": len(recovered),
            "unexpected-count": len(unexpected),
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
        }


def set_checker(device=None):
    return Set(device)


# ---------------------------------------------------------------------------
# Set-full, checker.clj:364-533
# ---------------------------------------------------------------------------

class _SetFullElement:
    """One element's timeline (checker.clj SetFullElement :255-282)."""

    __slots__ = ("element", "known", "last_present", "last_absent")

    def __init__(self, element):
        self.element = element
        self.known: Optional[Op] = None
        self.last_present: Optional[Op] = None
        self.last_absent: Optional[Op] = None

    def add(self, op: Op):
        if op.is_ok and self.known is None:
            self.known = op

    def read_present(self, inv: Op, op: Op):
        if self.known is None:
            self.known = op
        if self.last_present is None or \
                self.last_present.index < inv.index:
            self.last_present = inv

    def read_absent(self, inv: Op, op: Op):
        if self.last_absent is None or self.last_absent.index < inv.index:
            self.last_absent = inv

    def results(self) -> dict:
        def idx(o, default=-1):
            return o.index if o is not None else default

        stable = self.last_present is not None and \
            idx(self.last_absent) < idx(self.last_present)
        lost = (self.known is not None and self.last_absent is not None
                and idx(self.last_present) < idx(self.last_absent)
                and idx(self.known) < idx(self.last_absent))
        known_time = self.known.time if self.known is not None else None
        stable_time = ((self.last_absent.time + 1)
                       if stable and self.last_absent is not None else
                       0 if stable else None)
        lost_time = ((self.last_present.time + 1)
                     if lost and self.last_present is not None else
                     0 if lost else None)
        stable_latency = (max(stable_time - known_time, 0) // 1_000_000
                          if stable and known_time is not None else None)
        lost_latency = (max(lost_time - known_time, 0) // 1_000_000
                        if lost and known_time is not None else None)
        return {"element": self.element,
                "outcome": ("stable" if stable else
                            "lost" if lost else "never-read"),
                "stable-latency": stable_latency,
                "lost-latency": lost_latency,
                "known": self.known,
                "last-absent": self.last_absent}


def frequency_distribution(points, xs):
    """Percentile map (0-1) of a collection (checker.clj:305-316)."""
    xs = sorted(xs)
    if not xs:
        return None
    n = len(xs)
    return {p: xs[min(n - 1, int(n * p))] for p in points}


class SetFull(Checker):
    """Each element's stable / lost timeline (checker.clj:364-533)."""

    def __init__(self, checker_opts=None):
        self.opts = {"linearizable?": False}
        self.opts.update(checker_opts or {})

    def check(self, test, history, opts=None):
        elements: dict = {}
        reads: dict = {}
        dups: dict = {}
        for o in History(history):
            if not isinstance(o.process, int) or isinstance(o.process, bool) \
                    or o.process < 0:
                continue
            if o.f == "add":
                if o.is_invoke:
                    elements.setdefault(o.value, _SetFullElement(o.value))
                elif o.value in elements:
                    elements[o.value].add(o)
            elif o.f == "read":
                if o.is_invoke:
                    reads[o.process] = o
                elif o.is_fail:
                    reads.pop(o.process, None)
                elif o.is_ok:
                    inv = reads.get(o.process)
                    v = o.value or []
                    for el, n in Counter(v).items():
                        if n > 1:
                            dups[el] = max(dups.get(el, 0), n)
                    vs = set(v)
                    for el, state in elements.items():
                        if el in vs:
                            state.read_present(inv, o)
                        else:
                            state.read_absent(inv, o)

        rs = [e.results() for e in elements.values()]
        outcomes: dict = {}
        for r in rs:
            outcomes.setdefault(r["outcome"], []).append(r)
        stable = outcomes.get("stable", [])
        lost = outcomes.get("lost", [])
        never_read = outcomes.get("never-read", [])
        stale = [r for r in stable if r["stable-latency"]]
        worst_stale = sorted(stale, key=lambda r: r["stable-latency"],
                             reverse=True)[:8]
        stable_latencies = [r["stable-latency"] for r in rs
                            if r["stable-latency"] is not None]
        lost_latencies = [r["lost-latency"] for r in rs
                          if r["lost-latency"] is not None]
        if lost:
            valid: Any = False
        elif not stable:
            valid = UNKNOWN
        elif self.opts.get("linearizable?") and stale:
            valid = False
        else:
            valid = True
        out = {
            "valid?": valid if not dups else False,
            "attempt-count": len(rs),
            "stable-count": len(stable),
            "lost-count": len(lost),
            "lost": sorted(r["element"] for r in lost),
            "never-read-count": len(never_read),
            "never-read": sorted(r["element"] for r in never_read),
            "stale-count": len(stale),
            "stale": sorted(r["element"] for r in stale),
            "worst-stale": worst_stale,
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items())),
        }
        points = (0, 0.5, 0.95, 0.99, 1)
        if stable_latencies:
            out["stable-latencies"] = frequency_distribution(
                points, stable_latencies)
        if lost_latencies:
            out["lost-latencies"] = frequency_distribution(
                points, lost_latencies)
        return out


def set_full(checker_opts=None):
    return SetFull(checker_opts)


# ---------------------------------------------------------------------------
# Total queue, checker.clj:534-628
# ---------------------------------------------------------------------------

def expand_queue_drain_ops(history) -> History:
    """Ok :drain ops as dequeue invoke / ok pairs (checker.clj:534-564)."""
    out = []
    for o in History(history):
        if o.f != "drain":
            out.append(o)
        elif o.is_invoke or o.is_fail:
            continue
        elif o.is_ok:
            for el in o.value or []:
                out.append(o.assoc(type="invoke", f="dequeue", value=None))
                out.append(o.assoc(type="ok", f="dequeue", value=el))
        else:
            raise ValueError(
                f"Not sure how to handle a crashed drain operation: {o}")
    return History(out)


class TotalQueue(Checker):
    """What goes in must come out (checker.clj:566-628): multiset algebra
    over Counters on the host, as the reference runs it."""

    def check(self, test, history, opts=None):
        h = expand_queue_drain_ops(history)
        attempts: Counter = Counter()
        enqueues: Counter = Counter()
        dequeues: Counter = Counter()
        for o in h:
            if o.f == "enqueue" and o.is_invoke:
                attempts[o.value] += 1
            elif o.f == "enqueue" and o.is_ok:
                enqueues[o.value] += 1
            elif o.f == "dequeue" and o.is_ok:
                dequeues[o.value] += 1

        ok = dequeues & attempts
        unexpected = Counter({k: v for k, v in dequeues.items()
                              if k not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues

        def total(c):
            return sum(c.values())

        return {
            "valid?": not lost and not unexpected,
            "attempt-count": total(attempts),
            "acknowledged-count": total(enqueues),
            "ok-count": total(ok),
            "unexpected-count": total(unexpected),
            "duplicated-count": total(duplicated),
            "lost-count": total(lost),
            "recovered-count": total(recovered),
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
        }


def total_queue():
    return TotalQueue()


# ---------------------------------------------------------------------------
# Unique ids, checker.clj:630-676
# ---------------------------------------------------------------------------

class UniqueIds(Checker):
    """Every acknowledged generate returns a distinct id.  At least
    DEVICE_THRESHOLD integer ids count their duplicates on `device`
    (`ops.fold.duplicate_counts`, the card by default); fewer, or ids
    that are not all ints, are counted on the host."""

    DEVICE_THRESHOLD = 4096

    def __init__(self, device=None):
        self.device = device

    def check(self, test, history, opts=None):
        attempted = 0
        acks = []
        for o in History(history):
            if o.f == "generate" and o.is_invoke:
                attempted += 1
            elif o.f == "generate" and o.is_ok:
                acks.append(o.value)

        if fold.all_ints(acks) and len(acks) >= self.DEVICE_THRESHOLD:
            counts, mask = fold.duplicate_counts(acks, device=self.device)
            dups = {v: int(c) for v, c, m in zip(acks, counts, mask) if m}
        else:
            dups = {k: v for k, v in Counter(acks).items() if v > 1}
        rng = [min(acks), max(acks)] if acks else [None, None]
        return {
            "valid?": not dups,
            "attempted-count": attempted,
            "acknowledged-count": len(acks),
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items(),
                                      key=lambda kv: -kv[1])[:48]),
            "range": rng,
        }


def unique_ids(device=None):
    return UniqueIds(device)


# ---------------------------------------------------------------------------
# Counter, checker.clj:678-755
# ---------------------------------------------------------------------------

class CounterChecker(Checker):
    """Interval-bound counter analysis (checker.clj:678-755): each read
    must lie within [lower, upper], where `lower` tracks ok'd increments
    and attempted decrements and `upper` attempted increments and ok'd
    decrements, widened over the read's concurrency window; a read is
    [min lower in its window, v, max upper in its window], as the
    reference's golden fixtures (checker_test.clj:88-163).  A host loop,
    as the reference runs it."""

    def check(self, test, history, opts=None):
        h = History(history)
        # failed pairs drop out entirely (checker.clj:696-699)
        failed_inv = set()
        open_inv: dict = {}
        for pos, o in enumerate(h):
            if o.is_invoke:
                open_inv[o.process] = pos
            elif o.is_fail and o.process in open_inv:
                failed_inv.add(open_inv.pop(o.process))

        lower = upper = 0
        pending_reads: dict = {}  # process -> [min_lower, max_upper]
        reads = []
        for pos, o in enumerate(h):
            if pos in failed_inv or o.is_fail:
                continue
            if o.f == "read" and o.is_invoke:
                pending_reads[o.process] = [lower, upper]
            elif o.f == "read" and o.is_ok:
                lo, hi = pending_reads.pop(o.process, [lower, upper])
                reads.append((lo, o.value, hi))
            elif o.f == "add" and (o.is_invoke or o.is_ok):
                v = o.value
                if o.is_invoke:
                    lower, upper = ((lower, upper + v) if v > 0 else
                                    (lower + v, upper))
                else:
                    lower, upper = ((lower + v, upper) if v > 0 else
                                    (lower, upper + v))
                for rs in pending_reads.values():
                    rs[0] = min(rs[0], lower)
                    rs[1] = max(rs[1], upper)
        errors = [r for r in reads if not r[0] <= r[1] <= r[2]]
        return {"valid?": not errors,
                "reads": [list(r) for r in reads],
                "errors": [list(r) for r in errors]}


def counter():
    return CounterChecker()
