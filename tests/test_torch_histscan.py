"""The port's native history scan (`jepsen_tpu_torch/native/histscan.c`)
against the port's pure-Python `_fast_scan` and the JAX package's C
scanners, on seeded histories:

- the three C entry points (`_native_scan` over Op objects,
  `_native_scan_cols` over the columns, `_native_scan_streams` with its
  segment wire) give `_fast_scan`'s n_calls, max_open, cuts, positions,
  return and open-set arrays, delta stream, `seen` and `rows`, and the
  reference's `_native_scan`, `_native_scan_cols` and
  `_native_scan_streams` the same;
- a refused history raises `_fast_scan`'s exception class with its
  message, and leaves `seen` and `rows` as they were; the reference's
  scanners refuse the same histories;
- the stream pass's wire equals `regs_kernel.pack_stream(fk, seg_ends,
  1)` at several segment lengths, and its rows the reference stream's;
- `_pack_regs_single` equals `_pack_regs`;
- the port's `pack_history` and `ColumnJournal` equal the reference's
  column by column, and the scan's cached column casts are rebuilt after
  an in-place edit with `invalidate_packed` or an `append`;
- the routes (`wgl_seg.check`, `check_pipeline`, the crash tiers and
  `wgl_deep.check_pipeline`) give the same results with columns attached
  and without, and the reference's verdicts, and run no Python scan on a
  crash-free history;
- a build from a broken copy of the source raises."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_crash import TIER_CASES, TIER_KEYS
from test_torch_wgl_deep import pipeline_batch as deep_batch
from test_torch_wgl_seg import CHECK_CASES
from test_torch_wgl_seg import pipeline_batch as seg_batch

from jepsen_tpu import models as ref_models
from jepsen_tpu.history import ColumnJournal as RefJournal
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import info_op, invoke_op, ok_op, fail_op
from jepsen_tpu.history import pack_history as ref_pack
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_deep as ref_deep
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, history, models, native
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.ops import planner, regs_kernel, wgl_deep, wgl_seg

SPEC = models.CASRegister().device_spec()
REF_SPEC = ref_models.CASRegister().device_spec()


def gen_history(seed, n_calls, conc, *, vmax=9, max_open=0, burst=0,
                nemesis=0.0):
    """A register workload (read/read/write/cas) run against a sequential
    register with random interleaving, at most `max_open` calls open;
    reads before the first write return None; a cas whose old value
    misses fails.  `nemesis` is the share of steps that log a nemesis
    op; `burst` writes open together at the end."""
    rng = np.random.default_rng(seed)
    ops, value, open_ = [], None, {}
    i = 0
    while i < n_calls:
        if nemesis and rng.random() < nemesis:
            ops.append(info_op("nemesis", ("start", "stop")[i % 2], None))
            continue
        p = int(rng.integers(conc))
        if p in open_:
            ops.append(open_.pop(p))
            continue
        if max_open and len(open_) >= max_open:
            q = list(open_)[int(rng.integers(len(open_)))]
            ops.append(open_.pop(q))
            continue
        i += 1
        f = ("read", "read", "write", "cas")[int(rng.integers(4))]
        if f == "read":
            ops.append(invoke_op(p, "read", None))
            open_[p] = ok_op(p, "read", value)
        elif f == "write":
            v = int(rng.integers(vmax + 1))
            ops.append(invoke_op(p, "write", v))
            value = v
            open_[p] = ok_op(p, "write", v)
        else:
            old, new = (int(x) for x in rng.integers(vmax + 1, size=2))
            ops.append(invoke_op(p, "cas", [old, new]))
            if value == old:
                value = new
                open_[p] = ok_op(p, "cas", [old, new])
            else:
                open_[p] = fail_op(p, "cas", [old, new])
    ops.extend(open_.values())
    ops += [invoke_op(conc + p, "write", p % (vmax + 1))
            for p in range(burst)]
    ops += [ok_op(conc + p, "write", p % (vmax + 1)) for p in range(burst)]
    return RefHistory(ops).index()


def odd_processes():
    """Clients with processes past int32 and past int64, beside ops of
    bool and negative processes, which are not clients."""
    big, huge = 2 ** 40, 2 ** 70
    return RefHistory([
        invoke_op(big, "write", 3), invoke_op(True, "write", 9),
        invoke_op(0, "read", None), ok_op(True, "write", 9),
        ok_op(big, "write", 3), invoke_op(-3, "read", None),
        ok_op(0, "read", 3), invoke_op(huge, "cas", [3, 4]),
        ok_op(-3, "read", 1), invoke_op(1, "read", None),
        ok_op(huge, "cas", [3, 4]), ok_op(1, "read", 4)]).index()


def odd_values():
    """Values the scan encodes as not-ok (a string, a three-list, a pair
    holding a bool) or as pairs (a tuple), and bools."""
    return RefHistory([
        invoke_op(0, "write", True), ok_op(0, "write", True),
        invoke_op(1, "write", "x"), ok_op(1, "write", "x"),
        invoke_op(0, "cas", (1, 2)), invoke_op(2, "write", [1, 2, 3]),
        ok_op(2, "write", [1, 2, 3]), fail_op(0, "cas", (1, 2)),
        invoke_op(1, "cas", [1, False]), ok_op(1, "cas", [1, False]),
        invoke_op(2, "read", None), ok_op(2, "read", None)]).index()


HISTORIES = {
    "north-star-2000": lambda: gen_history(1, 2000, 5),
    "nemesis": lambda: gen_history(2, 600, 5, nemesis=0.05),
    "odd-processes": odd_processes,
    "odd-values": odd_values,
    "empty": lambda: RefHistory([]).index(),
    "nemesis-only": lambda: RefHistory(
        [info_op("nemesis", "start", None)]).index(),
    **{f"deep-r{R}": (lambda R=R: gen_history(10 + R, 300, R + 2,
                                              max_open=R, burst=R))
       for R in range(7, 17)},
}
#: The reference's object scan reads processes as C longs.
NO_REF_OBJECT_SCAN = {"odd-processes"}


def port(h):
    return convert.history_from_dicts(h.to_dicts())


def with_columns(ph):
    return ph.attach_packed(history.pack_history(ph))


def arrays_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))
        for x, y in zip(a, b))


def assert_same_scan(fk, want):
    assert (fk.n_calls, fk.max_open, fk.n_rets) == \
        (want.n_calls, want.max_open, want.n_rets)
    assert np.asarray(fk.cuts, np.int32).tobytes() == \
        np.asarray(want.cuts, np.int32).tobytes()
    assert np.asarray(fk.positions, np.int32).tobytes() == \
        np.asarray(want.positions, np.int32).tobytes()
    assert arrays_equal(planner._fk_arrays(fk), planner._fk_arrays(want))
    assert arrays_equal(planner._deltas(fk), planner._deltas(want))


def python_scan(ph, mob, seen=None, rows=None):
    seen, rows = ({} if seen is None else seen), ([] if rows is None
                                                  else rows)
    return planner._fast_scan(ph.ops, SPEC, seen, rows, mob), seen, rows


def c_scans(ph, mob, target=7):
    """Each C scanner's (result, seen, rows) on its own interning."""
    pk = history.pack_history(ph)
    out = {}
    for name, run in (
            ("objects", lambda s, r: planner._native_scan(
                ph.ops, SPEC, s, r, mob)),
            ("columns", lambda s, r: planner._native_scan_cols(
                pk, ph.ops, SPEC, s, r, mob)),
            ("streams", lambda s, r: planner._native_scan_streams(
                pk, ph.ops, SPEC, s, r, mob, target)),
            ("history", lambda s, r: planner._scan_history(
                pk, ph.ops, SPEC, s, r, mob))):
        seen, rows = {}, []
        out[name] = (run(seen, rows), seen, rows)
    return out


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_c_scanners_equal_python_scan_and_reference(name):
    h = HISTORIES[name]()
    ph = port(h)
    fk, seen, rows = python_scan(ph, 16)
    outs = c_scans(ph, 16)
    for kind in ("objects", "history") + (
            () if name == "odd-processes" else ("columns",)):
        got, s, r = outs[kind]
        assert_same_scan(got, fk)
        assert s == seen and r == rows, kind
    # the columns cannot name a process past int32: the object scan
    # takes such a history
    if name == "odd-processes":
        assert outs["columns"][0] is None and outs["streams"][0] is None
    else:
        sk = outs["streams"][0]
        seg_ends = planner._segment_ends(fk.cuts, 7)
        assert list(sk.seg_ends) == list(seg_ends)
        assert np.array_equal(sk.positions, fk.positions)
        assert (sk.n_calls, sk.max_open, sk.n_rets) == \
            (fk.n_calls, fk.max_open, fk.n_rets)
    # the reference's C scanners
    ref_pk = ref_pack(h)
    if name not in NO_REF_OBJECT_SCAN:
        s, r = {}, []
        ref = ref_planner._native_scan(h.ops, REF_SPEC, s, r, 16)
        assert ref is not False and ref is not None
        assert arrays_equal(planner._fk_arrays(fk), ref.arrays)
        assert np.array_equal(ref.cuts, fk.cuts)
        assert np.array_equal(ref.positions, fk.positions)
        assert (ref.n_calls, ref.max_open) == (fk.n_calls, fk.max_open)
        assert s == seen and r == rows
    s, r = {}, []
    ref = ref_planner._native_scan_cols(ref_pk, REF_SPEC, s, r, 16)
    if name == "odd-processes":
        assert ref is None
        return
    assert ref is not False and ref is not None
    assert arrays_equal(planner._fk_arrays(fk), ref.arrays)
    assert arrays_equal(planner._deltas(fk)[1:], ref.deltas)
    assert np.array_equal(ref.positions, fk.positions)
    assert s == seen and r == rows


def wire_rows(wire):
    """A stream wire's rows, segment by segment: (ret, islot, iuop)."""
    cbuf, offs, nrows = wire
    ret, isl, iu = [], [], []
    for o, L in zip(offs.tolist(), nrows.tolist()):
        ret.append(cbuf[o:o + L].astype(np.int32) - 1)
        isl.append(cbuf[o + L:o + 3 * L:2].astype(np.int32) - 1)
        iu.append(cbuf[o + 3 * L:o + 7 * L].view("<u2")[::2]
                  .astype(np.int32))
        # the second invoke column stays empty
        assert not cbuf[o + L + 1:o + 3 * L:2].any()
        assert not cbuf[o + 3 * L:o + 7 * L].view("<u2")[1::2].any()
    cat = (lambda xs: np.concatenate(xs) if xs
           else np.zeros(0, np.int32))
    return cat(ret), cat(isl), cat(iu)


@pytest.mark.parametrize("target", [1, 5, 24, 256])
@pytest.mark.parametrize("name", ["north-star-2000", "nemesis",
                                  "deep-r9", "deep-r16", "empty"])
def test_stream_wire_equals_pack_stream(name, target):
    h = HISTORIES[name]()
    ph = port(h)
    fk, _, _ = python_scan(ph, 16)
    sk = planner._native_scan_streams(history.pack_history(ph), ph.ops,
                                      SPEC, {}, [], 16, target)
    seg_ends = planner._segment_ends(fk.cuts, target)
    assert list(sk.seg_ends) == list(seg_ends)
    want = regs_kernel.pack_stream(fk, seg_ends, 1)
    for got, w in zip(sk.wire, want):
        assert got.dtype == w.dtype and got.tobytes() == w.tobytes()
    # its rows are the reference stream's: each return's new invokes in
    # invocation order
    ref = ref_planner._native_scan_streams(ref_pack(h), REF_SPEC, {}, [],
                                           16, target)
    assert list(ref.seg_ends) == list(seg_ends)
    ret, isl, iu = wire_rows(sk.wire)
    assert np.array_equal(ret, ref.ret32)
    assert np.array_equal(isl, ref.islot32)
    assert np.array_equal(iu, ref.iuop32)


@pytest.mark.parametrize("name", ["north-star-2000", "deep-r7", "deep-r12",
                                  "deep-r16", "odd-values", "nemesis"])
def test_pack_regs_single_equals_pack_regs(name):
    ph = port(HISTORIES[name]())
    fk, _, rows = python_scan(ph, 16)
    ck = planner._native_scan_cols(history.pack_history(ph), ph.ops, SPEC,
                                   {}, [], 16, want_snaps=False)
    R = max(1, int(fk.max_open))
    want = planner._pack_regs([(0, fk)], 1, R, len(rows), 2)
    got = planner._pack_regs_single(ck, R, len(rows), 2)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def refused(ops):
    return RefHistory(ops).index()


REFUSALS = {
    "crashed-info": (lambda: refused(
        [invoke_op(0, "write", 1), info_op(0, "write", 1),
         invoke_op(1, "read", None), ok_op(1, "read", 1)]), 10),
    "unpaired": (lambda: refused(
        [invoke_op(0, "write", 1), invoke_op(1, "read", None),
         ok_op(1, "read", None)]), 10),
    "double-invoke": (lambda: refused(
        [invoke_op(0, "write", 1), ok_op(0, "write", 1),
         invoke_op(3, "write", 2), invoke_op(3, "write", 3),
         ok_op(3, "write", 3)]), 10),
    "int32-write": (lambda: refused(
        [invoke_op(0, "write", 2 ** 31), ok_op(0, "write", 2 ** 31)]), 10),
    "int32-negative": (lambda: refused(
        [invoke_op(0, "write", -2 ** 31 - 1),
         ok_op(0, "write", -2 ** 31 - 1)]), 10),
    "int32-cas": (lambda: refused(
        [invoke_op(0, "cas", [1, 2 ** 31]),
         ok_op(0, "cas", [1, 2 ** 31])]), 10),
    "int32-read-completion": (lambda: refused(
        [invoke_op(0, "write", 1), ok_op(0, "write", 1),
         invoke_op(1, "read", None), ok_op(1, "read", 2 ** 40)]), 10),
    "int64-overflow": (lambda: refused(
        [invoke_op(0, "write", 2 ** 70), ok_op(0, "write", 2 ** 70)]), 10),
    "missing-f-code": (lambda: refused(
        [invoke_op(0, "write", 1), ok_op(0, "write", 1),
         invoke_op(0, "append", 5), ok_op(0, "append", 5)]), 10),
    "f-code-before-value": (lambda: refused(
        [invoke_op(0, "append", 2 ** 40), ok_op(0, "append", 2 ** 40)]),
        10),
    "depth": (lambda: gen_history(5, 40, 4, burst=12), 10),
    "depth-before-crash": (lambda: refused(
        [invoke_op(p, "write", 1) for p in range(3)]
        + [ok_op(p, "write", 1) for p in range(3)]
        + [invoke_op(3, "write", 1), info_op(3, "write", 1)]), 2),
    "crash-before-depth": (lambda: refused(
        [invoke_op(0, "write", 1), info_op(0, "write", 1)]
        + [invoke_op(p, "write", 1) for p in range(1, 4)]
        + [ok_op(p, "write", 1) for p in range(1, 4)]), 2),
    "double-invoke-big-process": (lambda: refused(
        [invoke_op(2 ** 40, "write", 1), invoke_op(5, "read", None),
         invoke_op(2 ** 40, "write", 2)]), 10),
}


def raised(fn):
    try:
        fn()
    except (ValueError, Unsupported) as e:
        return type(e), str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_keep_their_class_and_message(name):
    make, mob = REFUSALS[name]
    h = make()
    ph = port(h)
    pk = history.pack_history(ph)
    seed = ((0, 7, 0, True), (1, 7, 0, True))

    def run(scan):
        seen, rows = {k: i for i, k in enumerate(seed)}, list(seed)
        out = raised(lambda: scan(seen, rows))
        assert seen == {k: i for i, k in enumerate(seed)}
        assert rows == list(seed)
        return out

    want = run(lambda s, r: planner._fast_scan(ph.ops, SPEC, s, r, mob))
    assert run(lambda s, r: planner._native_scan(ph.ops, SPEC, s, r,
                                                 mob)) == want
    assert run(lambda s, r: planner._scan_history(pk, ph.ops, SPEC, s, r,
                                                  mob)) == want
    if (pk.process == history.P_OUT_OF_RANGE).any():
        assert planner._native_scan_cols(pk, ph.ops, SPEC, {}, [],
                                         mob) is None
    else:
        assert run(lambda s, r: planner._native_scan_cols(
            pk, ph.ops, SPEC, s, r, mob)) == want
        assert run(lambda s, r: planner._native_scan_streams(
            pk, ph.ops, SPEC, s, r, mob, 4)) == want
    # the reference's scanners refuse the same histories
    assert ref_planner._fast_scan(h, REF_SPEC, {}, [], mob) is None
    assert ref_planner._native_scan_cols(ref_pack(h), REF_SPEC, {}, [],
                                         mob) is None
    # and the classes the routes read
    if name in ("crashed-info", "unpaired", "crash-before-depth"):
        assert want[0] is planner.CrashedCalls
    elif name.startswith("double-invoke"):
        assert want[0] is ValueError
    else:
        assert want[0] is Unsupported and "P5" in want[1]


# ---------------------------------------------------------------------------
# A property test on small random histories
# ---------------------------------------------------------------------------

VALUES = st.one_of(st.none(), st.integers(-3, 9), st.booleans(),
                   st.sampled_from([2 ** 31, -2 ** 31 - 1, "x"]),
                   st.lists(st.integers(-2, 9), min_size=2, max_size=2),
                   st.tuples(st.integers(0, 3), st.integers(0, 3)))


@st.composite
def small_histories(draw):
    n_proc = draw(st.integers(1, 4))
    ops, open_ = [], {}
    for _ in range(draw(st.integers(0, 30))):
        step = draw(st.sampled_from(["call"] * 8 + ["nemesis", "double"]))
        if step == "nemesis":
            ops.append(info_op("nemesis", "start", None))
            continue
        p = draw(st.integers(0, n_proc - 1))
        f = draw(st.sampled_from(["read", "write", "cas"] * 6 + ["append"]))
        if p in open_ and step == "call":
            t = draw(st.sampled_from(["ok"] * 6 + ["fail", "info"]))
            ops.append({"ok": ok_op, "fail": fail_op, "info": info_op}[t](
                p, open_.pop(p), draw(VALUES)))
        else:
            open_[p] = f
            ops.append(invoke_op(p, f, None if f == "read"
                                 else draw(VALUES)))
    if draw(st.booleans()):
        ops += [ok_op(p, f, draw(VALUES)) for p, f in open_.items()]
    return RefHistory(ops).index()


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=small_histories(), mob=st.integers(1, 5), target=st.integers(1, 6))
def test_c_scanners_equal_python_scan_on_random_histories(h, mob, target):
    ph = port(h)
    pk = history.pack_history(ph)
    seen0 = {(1, 3, 0, True): 0}
    try:
        want = python_scan(ph, mob, dict(seen0), list(seen0))
    except (ValueError, Unsupported) as e:
        want = (type(e), str(e))
    # the reference's Python scan refuses exactly these
    assert (ref_planner._fast_scan(h, REF_SPEC, {}, [], mob) is None) \
        == isinstance(want[0], type)
    scans = {
        "objects": lambda s, r: planner._native_scan(ph.ops, SPEC, s, r,
                                                     mob),
        "columns": lambda s, r: planner._native_scan_cols(
            pk, ph.ops, SPEC, s, r, mob),
        "streams": lambda s, r: planner._native_scan_streams(
            pk, ph.ops, SPEC, s, r, mob, target)}
    for kind, scan in scans.items():
        seen, rows = dict(seen0), list(seen0)
        try:
            got = scan(seen, rows)
        except (ValueError, Unsupported) as e:
            assert (type(e), str(e)) == want, kind
            assert seen == seen0 and rows == list(seen0)
            continue
        assert not isinstance(want[0], type), (kind, want)
        fk, s_want, r_want = want
        assert seen == s_want and rows == r_want
        if kind != "streams":
            assert_same_scan(got, fk)
            continue
        seg_ends = planner._segment_ends(fk.cuts, target)
        assert list(got.seg_ends) == list(seg_ends)
        assert np.array_equal(got.positions, fk.positions)
        for g, w in zip(got.wire, regs_kernel.pack_stream(fk, seg_ends, 1)):
            assert g.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------

def column_zoo():
    """Ops whose columns exercise every branch of the packers: values
    past int64, pairs holding bools, tuples, strings; nemesis, bool,
    negative and big processes; indexes and times missing or past
    int32."""
    ops = [invoke_op(0, "write", 2 ** 70), ok_op(0, "write", 2 ** 70),
           invoke_op(True, "cas", [True, 1]), invoke_op(-4, "read", None),
           ok_op(-4, "read", "s"), invoke_op(2 ** 40, "cas", (1, 2)),
           ok_op(2 ** 40, "cas", (1, 2)), info_op("nemesis", None, None),
           invoke_op(1, "write", 2 ** 33), fail_op(1, "write", 2 ** 33),
           invoke_op(2, "cas", [2 ** 65, 1]), ok_op(2, "cas", [2 ** 65, 1]),
           invoke_op(3, "write", False), ok_op(3, "write", False)]
    h = RefHistory(ops).index()
    h.ops[3].index = 2 ** 40
    h.ops[4].index = None
    h.ops[5].time = 12345
    return h


PACKED = ("index", "process", "type", "f", "value", "value_ok", "time",
          "vkind")


def assert_columns_equal(got, want):
    for k in PACKED:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    assert got.f_codes == want.f_codes


@pytest.mark.parametrize("name", ["zoo", "north-star-2000", "odd-values"])
def test_pack_history_and_journal_equal_reference(name):
    h = column_zoo() if name == "zoo" else HISTORIES[name]()
    ph = port(h)
    assert_columns_equal(history.pack_history(ph), ref_pack(h))
    assert_columns_equal(history.History(ph.ops, journal=True)
                         .packed_columns(),
                         RefHistory(h.ops, journal=True).packed_columns())
    jr, jp = RefJournal(cap=2), history.ColumnJournal(cap=2)
    grown = history.History([], journal=True)
    for o, po in zip(h.ops, ph.ops):
        jr.append(o)
        jp.append(po)
        grown.append(po)
    assert_columns_equal(jp.packed(), jr.packed())
    assert_columns_equal(grown.packed_columns(), jr.packed())
    # carried across as plain numpy columns
    ref = ref_pack(h)
    carried = convert.packed_from_columns(
        {k: getattr(ref, k) for k in convert.PACKED_COLUMNS}, ref.f_codes)
    assert_columns_equal(carried, ref)


def test_cached_scan_columns_are_rebuilt_after_edits():
    ph = port(gen_history(7, 200, 4))
    pk = history.pack_history(ph)
    ph.attach_packed(pk)
    assert ph.packed_columns() is pk
    first = planner._scan_history(pk, ph.ops, SPEC, {}, [], 10)
    cached = pk._scan_cols
    assert planner._cols_args(pk, SPEC)[3] is cached[1][2]   # reused
    # an in-place edit: the op and its column, then invalidate_packed
    i = next(i for i, o in enumerate(ph.ops)
             if o.type == "ok" and o.f == "write")
    j = max(k for k in range(i) if ph.ops[k].process == ph.ops[i].process)
    for k in (i, j):
        ph.ops[k].value = 42
        pk.value[k, 0] = 42
    ph.invalidate_packed()
    assert pk.version == 1 and ph.packed_columns() is None
    cols = planner._cols_args(pk, SPEC)
    assert cols[3] is not cached[1][2] and cols[3][j] == 42
    rows = []
    edited = planner._scan_history(pk, ph.ops, SPEC, {}, rows, 10)
    assert (1, 42, 0, True) in rows
    assert_same_scan(edited, python_scan(ph, 10)[0])
    assert planner._fk_arrays(first)[3].tobytes() != \
        planner._fk_arrays(edited)[3].tobytes()
    # an append: the journal's columns grow, and the scan sees the op
    jh = history.History(ph.ops[:-2], journal=True)
    before = jh.packed_columns()
    planner._scan_history(before, jh.ops, SPEC, {}, [], 10)
    for o in ph.ops[-2:]:
        jh.append(o)
    after = jh.packed_columns()
    assert len(after) == len(before) + 2
    assert len(planner._cols_args(after, SPEC)[0]) == len(after)
    assert_same_scan(planner._scan_history(after, jh.ops, SPEC, {}, [], 10),
                     python_scan(jh, 10)[0])
    # a length change on one instance rebuilds the cache too
    grown = history.pack_history(jh)
    planner._cols_args(grown, SPEC)
    short = grown.take(np.arange(len(grown) - 2))
    short._scan_cols = grown._scan_cols
    assert len(planner._cols_args(short, SPEC)[0]) == len(short)


def test_a_broken_source_raises(tmp_path, monkeypatch):
    real = native.lib_path()
    broken = tmp_path / "histscan.c"
    broken.write_text(native.SOURCE.read_text().replace(
        "static PyObject *fast_scan(", "static PyObject *fast_scan(]", 1))
    monkeypatch.setattr(native, "SOURCE", broken)
    assert native.lib_path() != real
    with pytest.raises(RuntimeError, match="histscan.c") as e:
        native.build()
    assert "error" in str(e.value)
    assert not native.lib_path().exists()


def test_the_scanner_survives_the_reference_scanners_reload(monkeypatch):
    """The JAX package's `_histscan` loaded again leaves the port's module
    its own functions: a single-phase extension's second load from a
    file rebuilds the module sys.modules holds under its name, and the
    port's is loaded under a qualified one (`native.MODULE`)."""
    from jepsen_tpu import native as ref_native
    assert ref_native.histscan() is not None
    monkeypatch.setattr(native, "_mod", None)        # loaded after it
    mod = native.histscan()
    own = mod.fast_scan
    assert mod.__name__ == native.MODULE
    monkeypatch.setattr(ref_native, "_cache", {})    # and it reloaded
    again = ref_native.histscan()
    assert again is not mod and again.fast_scan is not own
    assert native.histscan() is mod and mod.fast_scan is own
    seen, rows = {}, []
    ops = [invoke_op(0, "write", 1), ok_op(0, "write", 1)]
    h = convert.history_from_dicts(RefHistory(ops).index().to_dicts())
    fk = planner._native_scan(h.ops, models.CASRegister().device_spec(),
                              seen, rows, 10)
    assert fk.n_calls == 1 and len(rows) == 1


# ---------------------------------------------------------------------------
# Routes: columns attached or not, and the reference
# ---------------------------------------------------------------------------

def strip_times(r):
    return {k: v for k, v in r.items() if not k.startswith("time_")}


def both_ways(run, hs):
    """run(port histories) without columns and with them."""
    plain = run([port(h) for h in hs])
    cols = run([with_columns(port(h)) for h in hs])
    return plain, cols


@pytest.fixture
def no_python_scan(monkeypatch):
    """Fails any call of the Python scan without crashed calls."""
    real = planner._fast_scan

    def guarded(*a, max_crashed=0, **kw):
        assert max_crashed, "a crash-free scan ran in Python"
        return real(*a, max_crashed=max_crashed, **kw)
    monkeypatch.setattr(planner, "_fast_scan", guarded)


@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_check_same_with_columns(name, monkeypatch, no_python_scan):
    h = CHECK_CASES[name]()
    target = 256 if "one-segment" in name else 24
    monkeypatch.setattr(wgl_seg, "TARGET_RETURNS", target)
    plain, cols = both_ways(lambda hs: [wgl_seg.check(
        models.CASRegister(), x, device="cpu") for x in hs], [h])
    assert strip_times(plain[0]) == strip_times(cols[0])
    ref = ref_seg.check(ref_models.CASRegister(), h,
                        target_returns_per_segment=target)
    for key in ("valid?", "segments", "dead_segment", "op_index"):
        assert cols[0].get(key) == ref.get(key), key


def test_seg_pipeline_same_with_columns(monkeypatch):
    hs = seg_batch()
    monkeypatch.setattr(wgl_seg, "TARGET_RETURNS", 32)
    stats = [{}, {}]
    runs = iter(stats)
    plain, cols = both_ways(lambda phs: wgl_seg.check_pipeline(
        models.CASRegister(), phs, device="cpu", stats=next(runs)), hs)
    assert [strip_times(r) for r in plain] == [strip_times(r) for r in cols]
    # the stream pass counts under scan: no separate segment stage
    assert "segment" in stats[0] and "segment" not in stats[1]
    ref = ref_seg.check_pipeline(ref_models.CASRegister(), hs,
                                 target_returns_per_segment=32)
    for i, r in enumerate(cols):
        for key in ("valid?", "op_index", "pipelined", "speculation",
                    "dead_segment", "crashed"):
            assert r.get(key) == ref[i].get(key), (i, key)


def test_seg_pipeline_runs_no_python_scan(monkeypatch, no_python_scan):
    hs = [gen_history(s, 150, 4) for s in (31, 32, 33)]
    monkeypatch.setattr(wgl_seg, "TARGET_RETURNS", 16)
    for phs in ([port(h) for h in hs], [with_columns(port(h)) for h in hs]):
        got = wgl_seg.check_pipeline(models.CASRegister(), phs,
                                     device="cpu")
        assert all(r["valid?"] is True and r["pipelined"] for r in got)


@pytest.mark.parametrize("name", sorted(TIER_CASES))
def test_crash_tiers_same_with_columns(name):
    make, tier = TIER_CASES[name]
    h = make()
    localize = tier != "relaxed"

    def run(phs):
        try:
            return [wgl_seg.check(models.CASRegister(), phs[0],
                                  device="cpu", localize=localize)]
        except Unsupported as e:
            return [("Unsupported", str(e))]
    plain, cols = both_ways(run, [h])
    if tier == "residual":
        assert plain == cols and "P5" in cols[0][1]
        return
    assert strip_times(plain[0]) == strip_times(cols[0])
    h.attach_packed(ref_pack(h))
    ref = ref_seg.check(ref_models.CASRegister(), h, localize=localize)
    for key in TIER_KEYS:
        assert cols[0].get(key) == ref.get(key), key


def test_stripped_scan_reads_the_kept_columns(monkeypatch):
    # tier 3 and 4 scan the stripped history over the sliced columns
    h = TIER_CASES["crash-relaxed"][0]()
    ph = with_columns(port(h))
    seen_cols = []
    real = planner._native_scan_cols

    def spy(packed, ops, *a, **kw):
        seen_cols.append((len(packed), len(ops)))
        return real(packed, ops, *a, **kw)
    monkeypatch.setattr(planner, "_native_scan_cols", spy)
    c = wgl_seg._split(models.CASRegister(), SPEC, ph.ops, max_states=64,
                       max_open_bits=10, packed=ph.packed_columns())
    assert seen_cols == [(len(c.stripped), len(c.stripped))]
    assert len(c.stripped) < len(ph.ops)
    want, _, _ = python_scan(history.History(c.stripped), 10)
    assert_same_scan(c.fk, want)


def test_deep_pipeline_same_with_columns(no_python_scan):
    hs = deep_batch()
    plain, cols = both_ways(lambda phs: wgl_deep.check_pipeline(
        models.CASRegister(), phs, device="cpu"), hs)
    assert [strip_times(r) for r in plain] == [strip_times(r) for r in cols]
    ref = ref_deep.check_pipeline(ref_models.CASRegister(), hs)
    for i in (0, 2, 3, 5, 6):
        assert cols[i]["valid?"] is ref[i]["valid?"]
        assert cols[i].get("op_index") == ref[i].get("op_index")
