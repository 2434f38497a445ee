"""The register-delta segment route of jepsen_tpu_torch against
jepsen_tpu's wgl_seg (its XLA register kernel, run by JAX on the CPU),
on histories made from a seed:

- the plain version of the segment kernel (`regs_kernel.scan_plain`,
  which the wrapper runs for CPU tensors) against the reference's
  `_build_kernel_regs` on identical tables: the [K, J, Sn] transfer
  matrices are equal exactly, at R = 1..6, at rounds = R and at the
  pipeline's speculative 2, with invoke bursts that spill into virtual
  rows, a uop table past 255 ids, and Sn in each state-row bucket; and
  the composition's six verdict words equal the reference's
  compose=True kernel;
- `wgl_seg.check` against the reference's `check`: valid?, engine,
  segments, dead_segment and op_index are equal;
- `wgl_seg.check_pipeline` against the reference's on a mixed batch:
  pipelined R <= 6 histories, a speculative death re-run exactly, an
  R = 8 group that goes to the deep kernel, and a crashed history (the
  crash tiers, through `check()`).

The one test that needs the card skips without one."""

import random

import numpy as np
import pytest
import torch
from test_wgl_seg import rand_history

from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import info_op, invoke_op, ok_op, pack_history
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_cpu as ref_cpu
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.errors import BackendUnavailable
from jepsen_tpu_torch.ops import planner, regs_kernel, wgl_seg


def with_burst(h, R, vmax, seed):
    """h followed by R writes that open together: the overlap depth is
    at least R, and the burst spills into virtual rows past I."""
    rng = random.Random(seed)
    base = 1 + max(o.process for o in h.ops)
    vals = [rng.randint(0, vmax) for _ in range(R)]
    ops = list(h.ops)
    ops += [invoke_op(base + p, "write", v) for p, v in enumerate(vals)]
    ops += [ok_op(base + p, "write", v) for p, v in enumerate(vals)]
    return RefHistory(ops).index()


def cas_chain(n, vmax, seed, R):
    """A sequential chain of successful compare-and-sets over values
    0..vmax, then a burst of depth R: hundreds of distinct uops."""
    rng = random.Random(seed)
    ops = [invoke_op(0, "write", 0), ok_op(0, "write", 0)]
    cur = 0
    for _ in range(n):
        new = rng.randint(0, vmax)
        ops += [invoke_op(0, "cas", [cur, new]), ok_op(0, "cas", [cur, new])]
        cur = new
    return with_burst(RefHistory(ops).index(), R, vmax, seed)


def shallow(R, seed, vmax=9, n_ops=160, buggy=False):
    h = rand_history(seed, n_ops=n_ops, conc=R + 1, vmax=vmax,
                     max_open=R, buggy=buggy)
    return with_burst(h, R, vmax, seed)


# name -> (history maker, R, rounds, I)
SCAN_CASES = {
    "r1": (lambda: shallow(1, 11), 1, 1, 1),
    "r2-bad": (lambda: shallow(2, 12, buggy=True), 2, 2, 2),
    "r3": (lambda: shallow(3, 13), 3, 3, 2),
    "r3-spec": (lambda: shallow(3, 13), 3, 2, 2),
    "r4-bad": (lambda: shallow(4, 14, buggy=True), 4, 4, 2),
    "r4-spec-i1": (lambda: shallow(4, 14, buggy=True), 4, 2, 1),
    "r5": (lambda: shallow(5, 15), 5, 5, 2),
    "r5-spec": (lambda: shallow(5, 15), 5, 2, 2),
    "r5-sn8-bad": (lambda: shallow(5, 25, vmax=4, buggy=True), 5, 5, 2),
    "r6": (lambda: shallow(6, 16), 6, 6, 2),
    "r6-spec-i1": (lambda: shallow(6, 16), 6, 2, 1),
    "r6-sn8-bad": (lambda: shallow(6, 26, vmax=4, buggy=True), 6, 6, 2),
    "r5-sn32-wide-uops": (lambda: cas_chain(700, 20, 3, 5), 5, 5, 2),
    "r6-sn32-spec": (lambda: shallow(6, 36, vmax=24), 6, 2, 2),
}


def ref_seg_tables(h, R, I, target=32):
    """The reference's host path: its native columnar scan (whose
    invoke-delta stream is in invocation order), segments, and the
    [Lp, K] tables of `_pack_regs_single` (None without the native
    scanner); the uop tables and the segment ends."""
    model = ref_models.CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    h.attach_packed(pack_history(h))
    fk = ref_planner._native_scan_cols(h.packed_columns(), spec, seen,
                                       rows, 10)
    native = fk is not None and fk is not False
    if not native:
        seen, rows = {}, []
        fk = ref_planner._fast_scan(h, spec, seen, rows, 10)
    assert fk.max_open == R
    uops = np.asarray(rows, np.int32).reshape(-1, 4)
    states, legal, nxt = ref_planner._enumerate_states(
        spec, np.asarray(spec.encode(model), np.int32), uops, 64)
    dec = ref_planner._decompose(legal, nxt)
    seg_ends = ref_planner._segment_ends(fk.cuts, target)
    tabs = ref_planner._pack_regs_single(
        fk, np.asarray(seg_ends), R, len(rows), I)[:3] if native else None
    uop_tabs = ref_planner._pack_uop_tables(legal, nxt, *dec)
    return tabs, uop_tabs, states.shape[0], seg_ends


def wire_tables(cbuf, offs, nrows, I, U):
    """[Lp, K] register-delta tables decoded from a segment wire, in the
    dtypes of the reference's `_pack_regs_single`: what its kernel takes.
    The wire's invoke columns past I are empty."""
    K = len(offs)
    Lp = planner._pad_len(int(nrows.max()))
    ret_t = np.full((Lp, K), -1, np.int8)
    islot_t = np.full((Lp, K, I), -1, np.int8)
    iuop_t = np.full((Lp, K, I), -1, np.int8 if U <= 127 else np.int16)
    for k in range(K):
        o, L = int(offs[k]), int(nrows[k])
        seg = cbuf[o:o + regs_kernel.ROW_BYTES * L].astype(np.int32)
        ret_t[:L, k] = seg[:L] - 1
        sl = seg[L:3 * L].reshape(L, 2) - 1
        u = (seg[3 * L::2] | (seg[3 * L + 1::2] << 8)).reshape(L, 2)
        assert (sl[:, I:] < 0).all()
        islot_t[:L, k] = sl[:, :I]
        iuop_t[:L, k] = np.where(sl[:, :I] >= 0, u[:, :I], -1)
    return ret_t, islot_t, iuop_t


def port_seg_wire(h, I, target=32):
    model = models.CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    ph = convert.history_from_dicts(h.to_dicts())
    fk = planner._fast_scan(ph.ops, spec, seen, rows, 10)
    states, legal, nxt, dec = wgl_seg._model_tables(spec, model, rows, 64)
    seg_ends = planner._segment_ends(fk.cuts, target)
    wire = regs_kernel.pack_stream(fk, seg_ends, I)
    aux, UP = wgl_seg._aux(planner._pack_uop_tables(legal, nxt, *dec))
    return (wire, wire_tables(*wire, I, len(rows)), aux, UP,
            states.shape[0], seg_ends)


@pytest.fixture(scope="module")
def scans():
    out = {}
    for name, (make, R, rounds, I) in SCAN_CASES.items():
        h = make()
        tabs, uop_tabs, Sn, seg_ends = ref_seg_tables(h, R, I)
        wire, ptabs, aux, UP, pSn, pseg_ends = port_seg_wire(h, I)
        # the same rows into both kernels: the port's wire, and the
        # reference's tables decoded from it
        K, Lp = ptabs[0].shape[1], ptabs[0].shape[0]
        args = tuple(ptabs) + tuple(uop_tabs)
        ref_T = np.asarray(ref_seg._build_kernel_regs(
            K, Lp, I, max(1, (1 << R) // 32), Sn, R, True, rounds, 1,
            J=Sn)(*args))
        ref_vd = np.asarray(ref_seg._build_kernel_regs(
            K, Lp, I, max(1, (1 << R) // 32), Sn, R, True, rounds, 1,
            J=Sn, compose=True)(*args))
        cbuf, offs, nrows = wire
        work = torch.zeros(K, dtype=torch.int64)
        T, bad = regs_kernel.regs_scan(
            torch.from_numpy(cbuf), torch.from_numpy(offs),
            torch.from_numpy(nrows), torch.from_numpy(aux), R=R, Sn=Sn,
            UP=UP, J=Sn, rounds=rounds, work=work)
        out[name] = dict(ref_T=ref_T, ref_vd=ref_vd, T=T.numpy(),
                         vd=regs_kernel.compose(T, [K])[0].numpy(),
                         tabs=tabs, ptabs=ptabs, wire=wire,
                         seg_ends=seg_ends,
                         pseg_ends=pseg_ends, Sn=Sn, pSn=pSn, aux=aux,
                         UP=UP, U_real=len(uop_tabs[0]), bad=int(bad[0]),
                         work=work.numpy(), rows=nrows)
    return out


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_scan_plain_matches_reference_kernel(scans, name):
    c = scans[name]
    assert c["pseg_ends"] == c["seg_ends"] and c["pSn"] == c["Sn"]
    assert c["T"].shape == c["ref_T"].shape
    assert np.array_equal(c["T"], c["ref_T"].astype(np.uint8))
    assert np.array_equal(c["vd"], c["ref_vd"])
    assert c["bad"] == 0 and (c["work"] > 0).all()


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_stream_tables_match_native_scanner(scans, name):
    c = scans[name]
    if c["tabs"] is None:
        pytest.skip("the reference's native scanner is not built here")
    for mine, theirs in zip(c["ptabs"], c["tabs"]):
        assert mine.dtype == theirs.dtype
        assert np.array_equal(mine, theirs)


def test_scan_cases_cover_the_edges(scans):
    R_I = {(SCAN_CASES[n][1], SCAN_CASES[n][3]) for n in SCAN_CASES}
    assert {R for R, _ in R_I} == set(range(1, 7))
    assert {regs_kernel.snp(c["Sn"]) for c in scans.values()} == {8, 16, 32}
    assert scans["r5-sn32-wide-uops"]["U_real"] > 255
    # invoke bursts past I spill into virtual rows (more rows than
    # returns), and some speculative pass loses a config the exact keeps
    assert any(c["rows"].sum() > c["seg_ends"][-1] for c in scans.values())
    assert any(not np.array_equal(scans[f"{r}-spec"]["T"], scans[r]["T"])
               for r in ("r3", "r5"))
    bad = [n for n, c in scans.items() if c["vd"][0] == 0]
    assert {"r2-bad", "r4-bad", "r5-sn8-bad", "r6-sn8-bad"} <= set(bad)


def test_segment_wire_is_the_deep_wire_unpadded(scans):
    from jepsen_tpu_torch.ops import wgl_deep
    ret_t, islot_t, iuop_t = scans["r4-bad"]["ptabs"]
    cbuf, offs, nrows = scans["r4-bad"]["wire"]
    for k in range(ret_t.shape[1]):
        L = int(nrows[k])
        assert ret_t[L - 1, k] >= 0 and (ret_t[L:, k] < 0).all()
        deep, G = wgl_deep.pack_events_compact(
            ret_t[:L, k:k + 1], islot_t[:L, k:k + 1], iuop_t[:L, k:k + 1])
        L2 = G * wgl_deep.EB
        seg = cbuf[offs[k]:offs[k] + regs_kernel.ROW_BYTES * L]
        assert np.array_equal(seg[:L], deep[:L])
        assert np.array_equal(seg[L:3 * L], deep[L2:L2 + 2 * L])
        assert np.array_equal(seg[3 * L:], deep[3 * L2:3 * L2 + 4 * L])


def test_compose_matches_host_composition():
    rng = np.random.default_rng(5)
    counts = [1, 3, 7, 12]
    T = (rng.random((sum(counts), 5, 5)) < 0.35).astype(np.uint8)
    T[:, 0, 0] = 1
    T[4] = 0                            # history 2 dies at segment 0
    T[11 + 4] = 0                       # history 3 at segment 4
    vd = regs_kernel.compose(torch.from_numpy(T), counts).numpy()
    lo = 0
    for b, k in enumerate(counts):
        Tb = T[lo:lo + k] > 0
        dead = planner._compose_transfer(Tb, 5)
        assert dead == ref_planner._compose_transfer(Tb, 5)
        assert vd[b, 1] == dead and bool(vd[b, 0]) is (dead < 0)
        if dead > 0:
            v = np.zeros(5, bool)
            v[0] = True
            for t in Tb[:dead]:
                v = v @ t
            assert vd[b, 2] == int((v * (1 << np.arange(5))).sum())
        elif dead == 0:
            assert vd[b, 2] == 1
        lo += k
    assert vd[:, 1].tolist() == [-1, -1, 0, 4]


@pytest.mark.parametrize("seed", [0, 1])
def test_speculation_needs_invocation_order(seed):
    """The pipeline's 2 speculative rounds keep a valid 1,500-call
    history (concurrency 5, vmax 9) alive when each return's new invokes
    are registered in invocation order (`regs_kernel.pack_stream`, the
    reference's native delta stream), and kill it when they are ordered
    by slot (`_pack_regs`, its Python-scan path): the order is part of
    the speculative pass's function.  Both orders go through the
    reference's kernel, and the port's wire through the port's."""
    h = convert.history_from_dicts(
        rand_history(seed, n_ops=1500, conc=5, vmax=9).to_dicts())
    model = models.CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fk = planner._fast_scan(h.ops, spec, seen, rows, 10)
    states, legal, nxt, dec = wgl_seg._model_tables(spec, model, rows, 64)
    R, Sn = fk.max_open, states.shape[0]
    seg_ends = planner._segment_ends(fk.cuts, 256)
    uop_tabs = planner._pack_uop_tables(legal, nxt, *dec)
    aux, UP = wgl_seg._aux(uop_tabs)
    segs, lo = [], 0
    for hi in seg_ends:
        segs.append((len(segs), planner._FastKey(
            fk.rets[lo:hi], R, hi - lo, cuts=fk.cuts[lo:hi],
            positions=fk.positions[lo:hi])))
        lo = hi
    K = len(seg_ends)
    stream = regs_kernel.pack_stream(fk, seg_ends, 1)
    verdicts = []
    for tabs in (wire_tables(*stream, 1, len(rows)),
                 planner._pack_regs(segs, K, R, len(rows), 1)[:3]):
        vd = ref_seg._build_kernel_regs(
            K, tabs[0].shape[0], 1, 1, Sn, R, True, 2, 1, J=Sn,
            compose=True)(*tabs, *uop_tabs)
        verdicts.append(int(np.asarray(vd)[0]))
    T, _ = regs_kernel.regs_scan(
        *(torch.from_numpy(x) for x in stream), torch.from_numpy(aux), R=R,
        Sn=Sn, UP=UP, J=Sn, rounds=2)
    assert R == 5 and K > 1
    assert verdicts == [1, 0]
    assert int(regs_kernel.compose(T, [K])[0, 0]) == 1


def test_kernel_depth_is_the_gate_constant():
    import inspect
    import re

    from jepsen_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "wgl_regs.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("MAXR") == planner.REGS_R_MAX
    assert const("MAXJ") == regs_kernel.J_MAX
    for name in ("CLOSE_OPS", "CLOSE5_OPS", "PRUNE_OPS"):
        assert const(name) == getattr(regs_kernel, name), name
    assert wgl_seg.TARGET_RETURNS == inspect.signature(
        ref_seg.check).parameters["target_returns_per_segment"].default
    py = open(regs_kernel.__file__).read()
    assert "environ" not in py and "except" not in py


def test_regs_gate_matches_reference_eligibility():
    for R, Sn, U, dec in [(6, 32, 32767, True), (7, 11, 40, True),
                          (3, 33, 40, True), (3, 11, 32768, True),
                          (3, 6, 40, False), (1, 1, 1, True)]:
        mine = planner.regs_gate(R, Sn, U, dec) is None
        assert mine is (ref_planner._regs_eligible(R, U, Sn, dec, env={})
                        and dec)
    assert "P5" in planner.regs_gate(3, 6, 40, False)


def test_regs_scan_checks_inputs():
    cbuf = torch.zeros(7, dtype=torch.uint8)
    cbuf[0] = 1                         # one row: a return of slot 0
    offs = torch.zeros(1, dtype=torch.int64)
    rows = torch.ones(1, dtype=torch.int32)
    aux = torch.zeros(3 * 8, dtype=torch.int32)
    kw = dict(R=1, Sn=2, UP=8, J=2, rounds=1)
    T, bad = regs_kernel.regs_scan(cbuf, offs, rows, aux, **kw)
    assert T.tolist() == [[[0, 0], [0, 0]]] and bad.tolist() == [0]
    with pytest.raises(ValueError, match="uint8"):
        regs_kernel.regs_scan(cbuf.to(torch.int32), offs, rows, aux, **kw)
    with pytest.raises(ValueError, match="sizes"):
        regs_kernel.regs_scan(cbuf, offs, rows, aux[:-1], **kw)
    with pytest.raises(ValueError, match="shape"):
        regs_kernel.regs_scan(cbuf, offs, rows, aux, **dict(kw, R=7))
    with pytest.raises(ValueError, match="shape"):
        regs_kernel.regs_scan(cbuf, offs, rows, aux, **dict(kw, rounds=2))
    with pytest.raises(ValueError, match="outside cbuf"):
        regs_kernel.regs_scan(cbuf[:-1], offs, rows, aux, **kw)
    with pytest.raises(ValueError, match="past R"):
        bad_ret = cbuf.clone()
        bad_ret[0] = 3
        regs_kernel.regs_scan(bad_ret, offs, rows, aux, **kw)
    with pytest.raises(ValueError, match="device"):
        regs_kernel.regs_scan(cbuf.to("meta"), offs.to("meta"),
                              rows.to("meta"), aux.to("meta"), **kw)


@pytest.mark.parametrize("R, slot, Sn", [(1, 0, 2), (5, 4, 11), (6, 4, 3),
                                         (6, 5, 3)])
def test_work_counts_operations_over_live_state_rows(R, slot, Sn):
    """One row that invokes and returns `slot`, one closure round: the
    count is one pass and one prune over the Sn state rows that hold
    configs (not the SnP rows of the plane), per lane."""
    cbuf = torch.tensor([slot + 1, slot + 1, 0, 0, 0, 0, 0],
                        dtype=torch.uint8)
    work = torch.zeros(1, dtype=torch.int64)
    regs_kernel.regs_scan(cbuf, torch.zeros(1, dtype=torch.int64),
                          torch.ones(1, dtype=torch.int32),
                          torch.zeros(3 * 8, dtype=torch.int32), R=R, Sn=Sn,
                          UP=8, J=Sn, rounds=1, work=work)
    words = Sn * regs_kernel.plane_width(R)
    if slot < 5:
        per_lane = (regs_kernel.CLOSE_OPS + regs_kernel.PRUNE_OPS) * words
    else:
        per_lane = (regs_kernel.CLOSE5_OPS + regs_kernel.PRUNE_OPS) * Sn
    assert work.tolist() == [per_lane * Sn]


# ---------------------------------------------------------------------------
# Every round count, the fixpoint stop and the work= count
# ---------------------------------------------------------------------------

def every_value_first(h, vmax):
    """h after a sequential write of every value 0..vmax: the model has
    vmax + 2 states whatever h writes."""
    ops = []
    for v in range(vmax + 1):
        ops += [invoke_op(0, "write", v), ok_op(0, "write", v)]
    return RefHistory(ops + list(h.ops)).index()


# name -> (R, vmax, seed, buggy): Sn = vmax + 2 is 8, 11 or 32
ROUND_CASES = {
    "r1-sn11": (1, 9, 61, False),
    "r2-sn8-bad": (2, 6, 62, True),
    "r3-sn32": (3, 30, 63, False),
    "r4-sn11-bad": (4, 9, 64, True),
    "r5-sn8": (5, 6, 65, False),
    "r6-sn32-bad": (6, 30, 66, True),
}


def lane_walk_jacobi(tabs, k, L, legal, nxt, *, R, Sn, rounds, j,
                     stop=True):
    """Lane (segment k, entry state j) walked in plain Python with
    Jacobi rounds, its plane a list of Sn ints over the 2^R masks:
    (integer operations, the plane after every row).  With `stop` a
    row's rounds end at the first that changes nothing; each round run
    is charged."""
    ret_t, islot_t, iuop_t = tabs
    WD = regs_kernel.plane_width(R)
    half = max(1, WD // 2)
    lack = [sum(1 << m for m in range(1 << R) if not m >> b & 1)
            for b in range(R)]
    plane = [int(s == j) for s in range(Sn)]
    uop = {}
    ops = 0
    after = []
    for r in range(L):
        for b, u in zip(islot_t[r, k], iuop_t[r, k]):
            if b >= 0:
                uop[int(b)] = int(u)
        if uop:
            per = sum(regs_kernel.CLOSE_OPS * Sn * WD if b < 5
                      else regs_kernel.CLOSE5_OPS * Sn * half for b in uop)
            for _ in range(rounds):
                add = [0] * Sn
                for b, u in uop.items():
                    for s in range(Sn):
                        if legal[u, s]:
                            add[nxt[u, s]] |= (plane[s] & lack[b]) << (1 << b)
                new = [p | a for p, a in zip(plane, add)]
                ops += per
                if stop and new == plane:
                    break
                plane = new
        b = int(ret_t[r, k])
        if b >= 0:
            plane = [(p & ~lack[b]) >> (1 << b) for p in plane]
            del uop[b]
            ops += regs_kernel.PRUNE_OPS * Sn * (half if b >= 5 else WD)
        after.append(list(plane))
    return ops, after


@pytest.fixture(scope="module")
def round_scans():
    out = {}
    model = models.CASRegister()
    spec = model.device_spec()
    for name, (R, vmax, seed, buggy) in ROUND_CASES.items():
        h = every_value_first(shallow(R, seed, vmax=vmax, n_ops=80,
                                      buggy=buggy), vmax)
        h = convert.history_from_dicts(h.to_dicts())
        seen, rows = {}, []
        fk = planner._fast_scan(h.ops, spec, seen, rows, 10)
        assert fk.max_open == R, name
        states, legal, nxt, dec = wgl_seg._model_tables(spec, model, rows,
                                                        64)
        wire = regs_kernel.pack_stream(
            fk, planner._segment_ends(fk.cuts, 24), 2)
        aux, UP = wgl_seg._aux(planner._pack_uop_tables(legal, nxt, *dec))
        out[name] = dict(R=R, Sn=states.shape[0], wire=wire, aux=aux,
                         UP=UP, legal=legal, nxt=nxt,
                         uop_tabs=planner._pack_uop_tables(legal, nxt,
                                                           *dec),
                         tabs=wire_tables(*wire, 2, len(rows)))
    return out


def plain_scan(c, rounds, work=None):
    T, bad = regs_kernel.regs_scan(
        *(torch.from_numpy(x) for x in c["wire"] + (c["aux"],)),
        R=c["R"], Sn=c["Sn"], UP=c["UP"], J=c["Sn"], rounds=rounds,
        work=work)
    assert int(bad[0]) == 0
    return T.numpy()


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_scan_plain_matches_reference_at_every_round_count(round_scans,
                                                           name):
    c = round_scans[name]
    R, Sn, tabs = c["R"], c["Sn"], c["tabs"]
    K, Lp = tabs[0].shape[1], tabs[0].shape[0]
    assert K > 1
    for rounds in range(1, R + 1):       # the speculative 2 among them
        ref_T = np.asarray(ref_seg._build_kernel_regs(
            K, Lp, 2, max(1, (1 << R) // 32), Sn, R, True, rounds, 1,
            J=Sn)(*tabs, *c["uop_tabs"]))
        assert np.array_equal(plain_scan(c, rounds),
                              ref_T.astype(np.uint8)), rounds


def test_round_cases_cover_the_edges(round_scans):
    assert sorted(c["R"] for c in round_scans.values()) == list(range(1, 7))
    assert {c["Sn"] for c in round_scans.values()} == {8, 11, 32}


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_fixpoint_stop_equals_every_round_row_for_row(round_scans, name):
    c = round_scans[name]
    R, Sn = c["R"], c["Sn"]
    ret_t = c["tabs"][0]
    nrows = c["wire"][2]
    for rounds in sorted({R, min(R, 2)}):
        T = plain_scan(c, rounds)
        for k in range(ret_t.shape[1]):
            for j in range(Sn):
                kw = dict(R=R, Sn=Sn, rounds=rounds, j=j)
                _, stopped = lane_walk_jacobi(c["tabs"], k, int(nrows[k]),
                                              c["legal"], c["nxt"], **kw)
                _, full = lane_walk_jacobi(c["tabs"], k, int(nrows[k]),
                                           c["legal"], c["nxt"], stop=False,
                                           **kw)
                assert stopped == full, (rounds, k, j)
                assert [p & 1 for p in full[-1]] == T[k, j].tolist()


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_work_counts_each_lanes_rounds_to_its_fixpoint(round_scans, name):
    c = round_scans[name]
    R, Sn = c["R"], c["Sn"]
    nrows = c["wire"][2]
    K = len(nrows)
    short = False
    for rounds in sorted({R, min(R, 2)}):
        work = torch.zeros(K, dtype=torch.int64)
        plain_scan(c, rounds, work)
        for k in range(K):
            lanes = [lane_walk_jacobi(c["tabs"], k, int(nrows[k]),
                                      c["legal"], c["nxt"], R=R, Sn=Sn,
                                      rounds=rounds, j=j)[0]
                     for j in range(Sn)]
            assert sum(lanes) == int(work[k]), (rounds, k)
        full = sum(
            lane_walk_jacobi(c["tabs"], k, int(nrows[k]), c["legal"],
                             c["nxt"], R=R, Sn=Sn, rounds=rounds, j=j,
                             stop=False)[0]
            for k in range(K) for j in range(Sn))
        short |= int(work.sum()) < full
    assert short or R == 1              # rows that stop short of rounds


CHECK_CASES = {
    "r1-bad": lambda: shallow(1, 41, buggy=True, n_ops=120),
    "r2": lambda: shallow(2, 42, n_ops=120),
    "r3-bad": lambda: shallow(3, 43, buggy=True, n_ops=120),
    "r4": lambda: shallow(4, 44, n_ops=120),
    "r4-bad": lambda: shallow(4, 45, buggy=True, n_ops=120),
    "r6-bad": lambda: shallow(6, 46, buggy=True, n_ops=120),
    "r3-one-segment-bad": lambda: rand_history(47, n_ops=60, conc=3,
                                               buggy=True),
}


@pytest.fixture(scope="module")
def checks():
    out = {}
    for name, make in CHECK_CASES.items():
        h = make()
        target = 256 if "one-segment" in name else 24
        ref = ref_seg.check(ref_models.CASRegister(), h,
                            target_returns_per_segment=target)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(wgl_seg, "TARGET_RETURNS", target)
            got = wgl_seg.check(models.CASRegister(),
                                convert.history_from_dicts(h.to_dicts()),
                                device="cpu")
        out[name] = (ref, got, ref_cpu.check(ref_models.CASRegister(), h))
    return out


@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_check_matches_reference(checks, name):
    ref, got, oracle = checks[name]
    for key in ("valid?", "engine", "segments", "dead_segment", "op_index",
                "anomaly", "states", "sharded"):
        assert got.get(key) == ref.get(key), key
    assert got["engine"] == "wgl_seg" and got["dispatch"]["R"] <= 6
    assert got["dispatch"]["engine"] == "wgl_seg"
    assert got["valid?"] is oracle["valid?"] is (not name.endswith("bad"))
    if got["valid?"] is False:
        assert got["op_index"] == oracle["op_index"]
        assert got["op"]["f"] == ref["op"]["f"]
        assert got["final-paths"]
    if "one-segment" not in name:
        assert got["segments"] > 1


def test_check_routes_deep_histories_to_the_deep_kernel():
    h = shallow(4, 48, n_ops=40)
    deep = with_burst(h, 8, 9, 48)
    got = wgl_seg.check(models.CASRegister(),
                        convert.history_from_dicts(deep.to_dicts()),
                        device="cpu")
    assert got["engine"] == got["dispatch"]["engine"] == "wgl_deep"
    assert got["dispatch"]["R"] == 8 and got["valid?"] is True
    empty = wgl_seg.check(models.CASRegister(),
                          convert.history_from_dicts([]), device="cpu")
    assert empty["engine"] == "wgl_seg" and empty["valid?"] is True


def pipeline_batch():
    crashed = RefHistory([invoke_op(0, "write", 1), info_op(0, "write", 1),
                          invoke_op(1, "read", None),
                          ok_op(1, "read", 1)]).index()
    hs = [shallow(3, 51, n_ops=100),
          shallow(4, 52, buggy=True, n_ops=100),   # speculative death
          crashed,
          shallow(2, 53, n_ops=100),
          shallow(5, 54, n_ops=100),
          with_burst(shallow(3, 55, n_ops=40), 8, 9, 55),   # R = 8
          shallow(1, 56, n_ops=60),
          shallow(3, 57, n_ops=100),
          shallow(2, 58, buggy=True, n_ops=100),
          RefHistory([]).index()]
    for h in hs:
        h.attach_packed(pack_history(h))
    return hs


@pytest.fixture(scope="module")
def pipelines():
    hs = pipeline_batch()
    ref = ref_seg.check_pipeline(ref_models.CASRegister(), hs,
                                 target_returns_per_segment=32)
    st = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wgl_seg, "TARGET_RETURNS", 32)
        got = wgl_seg.check_pipeline(
            models.CASRegister(),
            [convert.history_from_dicts(h.to_dicts()) for h in hs],
            device="cpu", stats=st)
    return ref, got, st


@pytest.mark.parametrize("i", range(10))
def test_pipeline_matches_reference(pipelines, i):
    ref, got, _ = pipelines
    for key in ("valid?", "op_index", "pipelined", "speculation",
                "dead_segment", "crashed"):
        assert got[i].get(key) == ref[i].get(key), key
    if i == 2:                           # crashed: through check()
        assert got[i]["crashed"] == 1 and got[i]["valid?"] is True
    if i == 5:
        # R = 8: the deep kernel here; the reference's CPU backend routes
        # it to its candidate-table engine, which the port leaves to P5
        assert got[i]["engine"] == "wgl_deep"
    else:
        assert got[i]["engine"] == ref[i]["engine"] == "wgl_seg"
        assert got[i].get("segments") == ref[i].get("segments")


def test_pipeline_routes(pipelines):
    _, got, st = pipelines
    # groups of four scanned histories: (0, 1, 3, 4), the crashed one
    # apart, then (5, 6, 7, 8)
    assert [bool(r.get("pipelined")) for r in got] == \
        [True, True, False, True, True, False, False, False, False, False]
    assert got[1]["speculation"] == "exact-rerun"
    assert got[1]["valid?"] is False and got[8]["valid?"] is False
    # the group holding the R = 8 history goes through check(): its
    # deep history to the deep kernel, the others to the segment kernel
    assert got[5]["engine"] == "wgl_deep"
    assert [got[i]["engine"] for i in (6, 7, 8)] == ["wgl_seg"] * 3
    assert got[0]["dispatch"]["stragglers"] == 5
    assert got[9] == {"valid?": True, "op_count": 0, "backend": "cpu",
                      "engine": "wgl_seg", "dispatch": got[9]["dispatch"]}
    assert {"scan", "segment", "tables", "pack", "copy", "launch", "sync",
            "assemble"} <= set(st)


def test_pipeline_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launches = regs_kernel.LAUNCHES
    with pytest.raises(BackendUnavailable):
        wgl_seg.check_pipeline(models.CASRegister(), [])
    assert regs_kernel.LAUNCHES == launches


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(scans):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    launches = regs_kernel.LAUNCHES
    for name, c in sorted(scans.items()):
        _, R, rounds, _ = SCAN_CASES[name]
        wire = c["wire"] + (c["aux"],)
        outs = []
        for dev in ("cuda", "cpu"):
            work = torch.zeros(len(wire[1]), dtype=torch.int64, device=dev)
            T, bad = regs_kernel.regs_scan(
                *(torch.from_numpy(x).to(dev) for x in wire), R=R,
                Sn=c["Sn"], UP=c["UP"], J=c["Sn"], rounds=rounds, work=work)
            outs.append((T.cpu(), work.cpu(), int(bad.cpu()[0])))
        assert torch.equal(outs[0][0], outs[1][0]), name
        assert torch.equal(outs[0][1], outs[1][1]), name
        assert outs[0][2] == 0
    assert regs_kernel.LAUNCHES == launches + len(scans)
