"""The port's checker library (`jepsen_tpu_torch.checker`: Queue, Set,
SetFull, TotalQueue, UniqueIds, CounterChecker, Compose, check_safe and
the rest) against the JAX package's `checker` on the CPU, exactly: every
case of tests/test_checker.py (the reference's golden fixtures) goes
through both packages from the same op dicts, and seeded random
histories of each checker, above `DEVICE_THRESHOLD` for Set and
UniqueIds (their fold on the CPU device, the reference's under
`jax.enable_x64` where values pass int32).  Results holding Op objects
or models are compared through `to_dict()` and the dataclass fields."""

import dataclasses
import random

import jax
import numpy as np
import pytest

from jepsen_tpu import checker as ref_ck
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import checker as ck
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported


def norm(x):
    """Plain data of a checker result: Ops as their dicts, models as
    their class name and fields."""
    if hasattr(x, "to_dict") and hasattr(x, "is_invoke"):
        return ("op", x.to_dict())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, norm(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def indexed(ops):
    """(type, process, f, value) tuples as op dicts with index i and time
    i * 1e6 ns, as tests/test_checker.py's `indexed` gives them."""
    return [{"index": i, "process": p, "type": t, "f": f, "value": v,
             "time": i * 1_000_000} for i, (t, p, f, v) in enumerate(ops)]


def run_both(port, ref, dicts, wide=False):
    h = convert.history_from_dicts(dicts)
    rh = RefHistory([dict(d) for d in dicts])
    got = port.check(None, h, {})
    if wide:
        with jax.enable_x64(True):
            want = ref.check(None, rh, {})
    else:
        want = ref.check(None, rh, {})
    return norm(got), norm(want)


def same(port, ref, ops, wide=False):
    got, want = run_both(port, ref, indexed(ops) if ops and isinstance(
        ops[0], tuple) else ops, wide)
    assert got == want
    return got


def I(p, f, v):                                       # noqa: E743
    return ("invoke", p, f, v)


def O(p, f, v):                                       # noqa: E743
    return ("ok", p, f, v)


def F(p, f, v):                                       # noqa: E743
    return ("fail", p, f, v)


def N(p, f, v):                                       # noqa: E743
    return ("info", p, f, v)


# ---------------------------------------------------------------------------
# merge-valid, compose, check-safe
# ---------------------------------------------------------------------------

def test_merge_valid():
    for vs in ([], [True, True], [True, "unknown"],
               [True, "unknown", False]):
        assert ck.merge_valid(vs) == ref_ck.merge_valid(vs)
    with pytest.raises(ValueError):
        ck.merge_valid([None])


def test_compose():
    same(ck.compose({"a": ck.unbridled_optimism(),
                     "b": ck.unbridled_optimism()}),
         ref_ck.compose({"a": ref_ck.unbridled_optimism(),
                         "b": ref_ck.unbridled_optimism()}), [])


def test_compose_empty_and_noop():
    same(ck.compose({}), ref_ck.compose({}), [])
    same(ck.compose({"n": ck.noop(), "u": ck.unbridled_optimism()}),
         ref_ck.compose({"n": ref_ck.noop(),
                         "u": ref_ck.unbridled_optimism()}), [])


def test_compose_merges_invalid():
    class Bad(ck.Checker):
        def check(self, test, history, opts=None):
            return {"valid?": False}

    class RefBad(ref_ck.Checker):
        def check(self, test, history, opts=None):
            return {"valid?": False}

    got = same(ck.compose({"good": ck.unbridled_optimism(), "bad": Bad()}),
               ref_ck.compose({"good": ref_ck.unbridled_optimism(),
                               "bad": RefBad()}), [])
    assert got["valid?"] is False


def test_check_safe_wraps_errors():
    class Boom(ck.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("kaboom")

    r = ck.check_safe(Boom(), None, convert.history_from_dicts([]))
    assert r["valid?"] == "unknown" and "kaboom" in r["error"]
    assert set(r) == {"valid?", "error"}


def test_compose_turns_a_failing_checker_into_unknown():
    class Boom(ck.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("kaboom")

    r = ck.compose({"boom": Boom(), "ok": ck.unbridled_optimism()}).check(
        None, convert.history_from_dicts([]))
    assert r["valid?"] == "unknown"
    assert "kaboom" in r["boom"]["error"]


def test_concurrency_limit():
    same(ck.concurrency_limit(1, ck.unbridled_optimism()),
         ref_ck.concurrency_limit(1, ref_ck.unbridled_optimism()), [])


# ---------------------------------------------------------------------------
# queue (checker_test.clj:11-31)
# ---------------------------------------------------------------------------

QUEUE_CASES = {
    "empty": [],
    "possible-enqueue": [I(1, "enqueue", 1)],
    "definite-enqueue": [O(1, "enqueue", 1)],
    "concurrent": [I(2, "dequeue", None), I(1, "enqueue", 1),
                   O(2, "dequeue", 1)],
    "dequeue-no-enqueue": [O(1, "dequeue", 1)],
}


@pytest.mark.parametrize("name", sorted(QUEUE_CASES))
@pytest.mark.parametrize("model", ["none", "unordered-queue",
                                   "fifo-queue"])
def test_queue_cases(name, model):
    port = None if model == "none" else models.model(model)
    ref = None if model == "none" else ref_models.model(model)
    same(ck.queue(port), ref_ck.queue(ref), QUEUE_CASES[name])


@pytest.mark.parametrize("seed", range(4))
def test_queue_random(seed):
    rng = random.Random(seed)
    ops, queue = [], []
    for i in range(300):
        if rng.random() < 0.55 or not queue:
            v = rng.randrange(50)
            ops += [I(i % 5, "enqueue", v), O(i % 5, "enqueue", v)]
            queue.append(v)
        else:
            v = queue.pop(0) if rng.random() < 0.9 else rng.randrange(60)
            ops += [I(i % 5, "dequeue", None), O(i % 5, "dequeue", v)]
    for model in ("unordered-queue", "fifo-queue"):
        same(ck.queue(models.model(model)),
             ref_ck.queue(ref_models.model(model)), ops)


# ---------------------------------------------------------------------------
# total-queue (checker_test.clj:33-86)
# ---------------------------------------------------------------------------

TOTAL_QUEUE_CASES = {
    "empty": [],
    "sane": [I(1, "enqueue", 1), I(2, "enqueue", 2), O(2, "enqueue", 2),
             I(3, "dequeue", 1), O(3, "dequeue", 1), I(3, "dequeue", 2),
             O(3, "dequeue", 2)],
    "pathological": [I(1, "enqueue", "hung"), I(2, "enqueue", "enqueued"),
                     O(2, "enqueue", "enqueued"), I(3, "enqueue", "dup"),
                     O(3, "enqueue", "dup"), I(4, "dequeue", None),
                     I(5, "dequeue", None), O(5, "dequeue", "wtf"),
                     I(6, "dequeue", None), O(6, "dequeue", "dup"),
                     I(7, "dequeue", None), O(7, "dequeue", "dup")],
    "drain": [I(1, "enqueue", 1), O(1, "enqueue", 1), I(2, "drain", None),
              O(2, "drain", [1])],
    "failed-drain": [I(1, "enqueue", 1), O(1, "enqueue", 1),
                     I(2, "drain", None), F(2, "drain", None)],
}


@pytest.mark.parametrize("name", sorted(TOTAL_QUEUE_CASES))
def test_total_queue_cases(name):
    same(ck.total_queue(), ref_ck.total_queue(), TOTAL_QUEUE_CASES[name])


def test_total_queue_golden():
    got = same(ck.total_queue(), ref_ck.total_queue(),
               TOTAL_QUEUE_CASES["pathological"])
    assert got["valid?"] is False and got["duplicated"] == {"dup": 1}


def test_crashed_drain_raises_in_both():
    ops = indexed([I(2, "drain", None), N(2, "drain", None)])
    with pytest.raises(ValueError):
        ck.total_queue().check(None, convert.history_from_dicts(ops))
    with pytest.raises(ValueError):
        ref_ck.total_queue().check(None, RefHistory(ops))


@pytest.mark.parametrize("seed", range(3))
def test_total_queue_random(seed):
    rng = random.Random(seed)
    ops = []
    for i in range(6000):
        p = i % 8
        v = rng.randrange(3000)
        r = rng.random()
        if r < 0.5:
            ops += [I(p, "enqueue", v),
                    (rng.choice(["ok", "ok", "fail", "info"]), p,
                     "enqueue", v)]
        elif r < 0.95:
            ops += [I(p, "dequeue", None), O(p, "dequeue", v)]
        else:
            ops += [I(p, "drain", None),
                    O(p, "drain", [rng.randrange(3000) for _ in range(3)])]
    same(ck.total_queue(), ref_ck.total_queue(), ops)


# ---------------------------------------------------------------------------
# counter (checker_test.clj:88-163)
# ---------------------------------------------------------------------------

COUNTER_CASES = {
    "empty": [],
    "initial-read": [I(0, "read", None), O(0, "read", 0)],
    "ignore-failed": [I(0, "add", 1), F(0, "add", 1), I(0, "read", None),
                      O(0, "read", 0)],
    "initial-invalid-read": [I(0, "read", None), O(0, "read", 1)],
    "interleaved": [I(0, "read", None), I(1, "add", 1), I(2, "read", None),
                    I(3, "add", 2), I(4, "read", None), I(5, "add", 4),
                    I(6, "read", None), I(7, "add", 8), I(8, "read", None),
                    O(0, "read", 6), O(1, "add", 1), O(2, "read", 0),
                    O(3, "add", 2), O(4, "read", 3), O(5, "add", 4),
                    O(6, "read", 100), O(7, "add", 8), O(8, "read", 15)],
    "rolling": [I(0, "read", None), I(1, "add", 1), O(0, "read", 0),
                I(0, "read", None), O(1, "add", 1), I(1, "add", 2),
                O(0, "read", 3), I(0, "read", None), O(1, "add", 2),
                O(0, "read", 5)],
}


@pytest.mark.parametrize("name", sorted(COUNTER_CASES))
def test_counter_cases(name):
    same(ck.counter(), ref_ck.counter(), COUNTER_CASES[name])


@pytest.mark.parametrize("seed", range(4))
def test_counter_random(seed):
    rng = random.Random(seed)
    ops, value, open_ = [], 0, {}
    for i in range(2000):
        p = rng.randrange(6)
        if p in open_:
            f, v = open_.pop(p)
            typ = rng.choice(["ok", "ok", "ok", "fail", "info"])
            if f == "read":
                ops.append((typ, p, f, value + rng.choice([0, 0, 0, 1, -1])))
            else:
                value += v if typ == "ok" else 0
                ops.append((typ, p, f, v))
        else:
            f = rng.choice(["read", "add"])
            v = None if f == "read" else rng.randrange(-5, 9)
            open_[p] = (f, v)
            ops.append(I(p, f, v))
    same(ck.counter(), ref_ck.counter(), ops)


# ---------------------------------------------------------------------------
# set (checker.clj:182-233)
# ---------------------------------------------------------------------------

SET_CASES = {
    "never-read": [I(0, "add", 0)],
    "ok": [I(0, "add", 0), O(0, "add", 0), I(0, "add", 1), O(0, "add", 1),
           I(1, "read", None), O(1, "read", [0, 1])],
    "lost-and-unexpected": [I(0, "add", 0), O(0, "add", 0), I(0, "add", 1),
                            O(0, "add", 1), I(1, "read", None),
                            O(1, "read", [1, 5])],
    "recovered": [I(0, "add", 3), I(1, "read", None), O(1, "read", [3])],
    "strings": [I(0, "add", "a"), O(0, "add", "a"), I(1, "read", None),
                O(1, "read", ["b"])],
}


@pytest.mark.parametrize("name", sorted(SET_CASES))
def test_set_cases(name):
    same(ck.set_checker(device="cpu"), ref_ck.set_checker(),
         SET_CASES[name])


def set_ops(n, seed, lim=None, dup_reads=0):
    """n attempted adds (values 0..n-1, or seeded values in [-lim, lim)),
    a third failed or crashed, then a read of a random subset and a few
    unattempted values."""
    rng = np.random.default_rng(seed)
    vals = (np.arange(n) if lim is None
            else rng.integers(-lim, lim, n)).tolist()
    ops = []
    for i, v in enumerate(vals):
        ops.append(I(i % 7, "add", v))
        ops.append((["ok", "ok", "fail", "info"][rng.integers(4)], i % 7,
                    "add", v))
    read = [v for v in vals if rng.random() < 0.9]
    read += ((np.arange(20) + (lim or n)).tolist()
             + read[:dup_reads])
    ops += [I(9, "read", None), O(9, "read", read)]
    return ops


def test_set_device_path_matches_host():
    # tests/test_checker.py::test_device_path_matches_host
    n = ck.Set.DEVICE_THRESHOLD
    ops = []
    for i in range(n):
        ops.append(I(0, "add", i))
        if i % 3 != 0:
            ops.append(O(0, "add", i))
    final = [i for i in range(n) if i % 5 != 0] + [n + 17]
    ops += [I(1, "read", None), O(1, "read", final)]
    got = same(ck.set_checker(device="cpu"), ref_ck.set_checker(), ops)
    assert got["unexpected"] == "#{%d}" % (n + 17)


@pytest.mark.parametrize("n,lim,wide", [
    (4095, None, False), (4096, None, False), (6000, 3000, False),
    (5000, 2 ** 40, True), (4500, 2 ** 62, True)])
def test_set_random(n, lim, wide):
    same(ck.Set(device="cpu"), ref_ck.Set(), set_ops(n, n, lim, 50),
         wide=wide)


def test_set_below_threshold_needs_no_device():
    # routing, not a fallback: host sets below the threshold, even with
    # the card as the device
    r = ck.Set().check(None, convert.history_from_dicts(
        indexed(SET_CASES["ok"])))
    assert r["valid?"] is True


def test_set_above_threshold_needs_the_device():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(BackendUnavailable):
        ck.Set().check(None, convert.history_from_dicts(
            indexed(set_ops(4100, 1))))


def test_integer_interval_set_str():
    for xs in ([1, 2, 3, 5], [], [7], [-3, -2, 0, 1, 2], ["b", "a"]):
        assert ck.integer_interval_set_str(xs) == \
            ref_ck.integer_interval_set_str(xs)


# ---------------------------------------------------------------------------
# unique-ids (checker.clj:630-676)
# ---------------------------------------------------------------------------

UNIQUE_CASES = {
    "empty": [],
    "unique": [I(0, "generate", None), O(0, "generate", 1),
               I(0, "generate", None), O(0, "generate", 2)],
    "dups": [I(0, "generate", None), O(0, "generate", 1),
             I(0, "generate", None), O(0, "generate", 1)],
}


@pytest.mark.parametrize("name", sorted(UNIQUE_CASES))
def test_unique_ids_cases(name):
    same(ck.unique_ids(device="cpu"), ref_ck.unique_ids(),
         UNIQUE_CASES[name])


def ids_ops(n, seed, lim, dups):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(-lim, lim, max(1, 2 * lim // (4 * n))),
                     n, replace=False) if lim < 2 ** 40 else \
        rng.integers(-lim, lim, n)
    ids[rng.integers(0, n, dups)] = ids[rng.integers(0, n, dups)]
    ops = []
    for i, v in enumerate(ids.tolist()):
        ops += [I(i % 5, "generate", None), O(i % 5, "generate", v)]
    return ops


@pytest.mark.parametrize("n,lim,dups,wide", [
    (4095, 10 ** 6, 30, False), (4096, 10 ** 6, 0, False),
    (4096, 10 ** 6, 1, False), (8000, 10 ** 6, 200, False),
    (6000, 2 ** 62, 100, True)])
def test_unique_ids_random(n, lim, dups, wide):
    same(ck.UniqueIds(device="cpu"), ref_ck.UniqueIds(),
         ids_ops(n, n + dups, lim, dups), wide=wide)


def test_unique_ids_device_path():
    # tests/test_checker.py::TestUniqueIds::test_device_path
    n = ck.UniqueIds.DEVICE_THRESHOLD
    ops = []
    for i in range(n):
        ops += [I(0, "generate", None), O(0, "generate", i if i != 7 else 6)]
    got = same(ck.unique_ids(device="cpu"), ref_ck.unique_ids(), ops)
    assert got["duplicated"] == {6: 2}


# ---------------------------------------------------------------------------
# set-full (checker_test.clj:249-420)
# ---------------------------------------------------------------------------

def _sf_variants(a, a_ok, r, r_done, hs):
    m = {"a": a, "a_ok": a_ok, "r": r, "r_done": r_done}
    return [[m[k] for k in h] for h in hs]


SET_FULL_CASES = {
    "never-read": [I(0, "add", 0), O(0, "add", 0)],
    "never-confirmed-never-read": [I(0, "add", 0), I(1, "read", None),
                                   O(1, "read", [])],
    "absent-read-after": [I(0, "add", 0), O(0, "add", 0),
                          I(1, "read", None), O(1, "read", [])],
    "write-present-missing": [I(0, "add", 0), I(1, "add", 1),
                              I(2, "read", None), O(2, "read", [1]),
                              O(0, "add", 0), O(1, "add", 1),
                              I(2, "read", None), O(2, "read", [0, 1]),
                              I(2, "read", None), O(2, "read", [0]),
                              I(2, "read", None), O(2, "read", [])],
    "flutter-stable-lost": [I(0, "add", 0), O(0, "add", 0), I(1, "add", 1),
                            I(2, "read", None), O(2, "read", [1]),
                            O(1, "add", 1), I(2, "read", None),
                            I(3, "read", None), O(3, "read", [1]),
                            O(2, "read", [0])],
    "duplicates": [I(0, "add", 0), O(0, "add", 0), I(1, "read", None),
                   O(1, "read", [0, 0])],
    "failed-read-and-nemesis": [I(0, "add", 0), O(0, "add", 0),
                                I(1, "read", None), F(1, "read", None),
                                ("info", "nemesis", "start", None),
                                I(1, "read", None), N(1, "read", None),
                                I(2, "read", None), O(2, "read", [0])],
}
for i, h in enumerate(_sf_variants(
        I(0, "add", 0), O(0, "add", 0), I(1, "read", None),
        O(1, "read", [0]),
        [["r", "a", "r_done", "a_ok"], ["r", "a", "a_ok", "r_done"],
         ["a", "r", "r_done", "a_ok"], ["a", "r", "a_ok", "r_done"],
         ["a", "a_ok", "r", "r_done"]])):
    SET_FULL_CASES[f"present-{i}"] = h
for i, h in enumerate(_sf_variants(
        I(0, "add", 0), O(0, "add", 0), I(1, "read", None),
        O(1, "read", []),
        [["r", "a", "r_done", "a_ok"], ["r", "a", "a_ok", "r_done"],
         ["a", "r", "r_done", "a_ok"], ["a", "r", "a_ok", "r_done"]])):
    SET_FULL_CASES[f"absent-concurrent-{i}"] = h


@pytest.mark.parametrize("name", sorted(SET_FULL_CASES))
@pytest.mark.parametrize("linearizable", [False, True])
def test_set_full_cases(name, linearizable):
    opts = {"linearizable?": linearizable}
    same(ck.set_full(opts), ref_ck.set_full(opts), SET_FULL_CASES[name])


def test_set_full_golden_worst_stale():
    got = same(ck.set_full(), ref_ck.set_full(),
               SET_FULL_CASES["flutter-stable-lost"])
    [ws] = got["worst-stale"]
    assert ws["element"] == 1 and ws["known"][1]["index"] == 4
    assert ws["last-absent"][1]["index"] == 6


@pytest.mark.parametrize("seed", range(3))
def test_set_full_random(seed):
    rng = random.Random(seed)
    ops, present, open_ = [], set(), {}
    for i in range(700):
        p = rng.randrange(6)
        if p in open_:
            f, v = open_.pop(p)
            if f == "add":
                typ = rng.choice(["ok", "ok", "info", "fail"])
                if typ != "fail":
                    present.add(v)
                ops.append((typ, p, f, v))
            else:
                seen = [x for x in present if rng.random() < 0.95]
                seen += [x for x in seen[:1] if rng.random() < 0.1]
                ops.append((rng.choice(["ok", "ok", "ok", "fail"]), p, f,
                            seen))
        else:
            f = rng.choice(["add", "read"])
            v = rng.randrange(80) if f == "add" else None
            open_[p] = (f, v)
            ops.append(I(p, f, v))
    same(ck.set_full(), ref_ck.set_full(), ops)


def test_frequency_distribution():
    for xs in ([], [3], [5, 1, 4, 1, 5, 9, 2, 6]):
        assert ck.frequency_distribution((0, 0.5, 1), xs) == \
            ref_ck.frequency_distribution((0, 0.5, 1), xs)


# ---------------------------------------------------------------------------
# models without a device spec under Linearizable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["noop", "unordered-queue", "fifo-queue",
                                  "multi-register"])
def test_linearizable_refuses_host_models_naming_p6(name):
    h = convert.history_from_dicts(indexed(QUEUE_CASES["concurrent"]))
    for algo in ("auto", "device"):
        with pytest.raises(Unsupported, match="P6"):
            ck.linearizable({"model": models.model(name), "algorithm": algo,
                             "device": "cpu"}).check(None, h)
