"""The crash tiers of jepsen_tpu_torch against jepsen_tpu's wgl_seg (its
XLA register kernel run by JAX on the CPU, and its host code), on
histories with crashed (:info or unreturned) calls made from a seed:

- `planner._split_crashed` and `_fast_scan(max_crashed=4)` give the
  reference's crashed calls, rets, cuts, nc and rn, and the scan's
  positions name each return;
- the crash segment wire (`regs_kernel.pack_stream` of a crash-carrying
  scan) decodes to the reference's `_pack_regs(_segments_from_fk(...))`
  tables;
- the plain version of the crash kernel equals the reference's
  `_build_kernel_regs(J=Sn<<nc, nc=nc, rn=rn)` bit for bit at nc = 1..4
  and R + nc up to 8; the relaxed variant's transfer rows, its composed
  verdict words (`_build_kernel_regs_relaxed`) and its death row equal
  the reference's `crash_closure` and `death_row` kernels; their
  `work=` counts equal a plain-Python walk of each lane that charges its
  rounds up to its own fixpoint;
- the same at the kernel's layout edges: segments past 1024 threads
  (J = 88 at Sn = 11, J = 128 at Sn = 32), every normal slot b >= 5
  returning, and a death at a segment's first and last row;
- the plain version's `need=` count: the `work=` count with only the
  closures that can change a lane's plane (at a row whose masks let a
  state jump, in a round whose passes changed the lane), against the
  same plain-Python walk; with no closure it is the `work=` count;
- `wgl_seg.check` and `Linearizable` agree with the reference's
  `wgl_seg.check` on the verdict, the witness and the tier fields in
  every tier, and `check_pipeline` on a mixed batch.

The one test that needs the card (every kernel against its plain
version: transfer rows, death rows and `work=` counts, at the cases
above and the layout edges) skips without one."""

import random

import numpy as np
import pytest
import torch
from test_wgl_seg import crash_history, rand_history

from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import Linearizable as RefLinearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import info_op, invoke_op, ok_op, pack_history
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_cpu as ref_cpu
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.ops import crash_kernel, planner, regs_kernel, wgl_seg

TARGET = 24                     # returns per segment in the kernel cases


def port(h):
    return convert.history_from_dicts(h.to_dicts())


def with_crashes(h, nc, seed, vmax, burst=0):
    """h with nc crashed writes of fresh processes invoked at random
    points (the last one never completes, the others end with :info),
    then `burst` writes that open together, so the normal overlap depth
    is at least `burst`."""
    rng = random.Random(seed)
    ops = list(h.ops)
    base = 100
    at = sorted(rng.randrange(len(ops) + 1) for _ in range(nc))
    for j, pos in enumerate(reversed(at)):
        ops.insert(pos, invoke_op(base + j, "write", rng.randint(0, vmax)))
    ops += [invoke_op(200 + p, "write", p % (vmax + 1)) for p in range(burst)]
    ops += [ok_op(200 + p, "write", p % (vmax + 1)) for p in range(burst)]
    for j in range(nc - 1):
        o = next(o for o in ops if o.process == base + j)
        ops.append(info_op(base + j, "write", o.value))
    return RefHistory(ops).index()


def crash_case(rn, nc, seed, vmax, buggy=False, n_ops=60):
    h = rand_history(seed, n_ops=n_ops, conc=rn + 1, vmax=vmax,
                     max_open=rn, buggy=buggy)
    return with_crashes(h, nc, seed, vmax, burst=rn)


def ref_scan(h, max_crashed=4):
    spec = ref_models.CASRegister().device_spec()
    seen, rows = {}, []
    fk = ref_planner._fast_scan(h, spec, seen, rows, 10,
                                max_crashed=max_crashed)
    return fk, rows


def port_scan(h, max_crashed=4):
    spec = models.CASRegister().device_spec()
    seen, rows = {}, []
    fk = planner._fast_scan(port(h).ops, spec, seen, rows, 10,
                            max_crashed=max_crashed)
    return fk, rows


def decode(cbuf, offs, nrows, U, crow=False):
    """[Lp, K] register-delta tables (and crow [Lp, K]) decoded from a
    segment wire, in the reference's dtypes."""
    K = len(offs)
    Lp = planner._pad_len(int(nrows.max()))
    ret_t = np.full((Lp, K), -1, np.int8)
    islot_t = np.full((Lp, K, 2), -1, np.int8)
    iuop_t = np.full((Lp, K, 2), -1, np.int8 if U <= 127 else np.int16)
    crow_t = np.zeros((Lp, K), np.int16)
    rb = regs_kernel.CROW_ROW_BYTES if crow else regs_kernel.ROW_BYTES
    for k in range(K):
        o, L = int(offs[k]), int(nrows[k])
        seg = cbuf[o:o + rb * L].astype(np.int32)
        ret_t[:L, k] = seg[:L] - 1
        sl = seg[L:3 * L].reshape(L, 2) - 1
        u = (seg[3 * L:7 * L:2] | (seg[3 * L + 1:7 * L:2] << 8)).reshape(L, 2)
        islot_t[:L, k] = sl
        iuop_t[:L, k] = np.where(sl >= 0, u, -1)
        if crow:
            crow_t[:L, k] = (seg[7 * L::2] | (seg[7 * L + 1::2] << 8))
    return ret_t, islot_t, iuop_t, crow_t


def uop_tables(rows):
    model = models.CASRegister()
    spec = model.device_spec()
    states, legal, nxt, dec = wgl_seg._model_tables(spec, model, rows, 64)
    aux, UP = wgl_seg._aux(planner._pack_uop_tables(legal, nxt, *dec))
    return states, legal, nxt, planner._pack_uop_tables(legal, nxt, *dec), \
        aux, UP


# ---------------------------------------------------------------------------
# Scan and wire
# ---------------------------------------------------------------------------

SCAN_HISTORIES = {
    "one-info": lambda: rand_history(8, n_ops=50, crash_at=12),
    "rn3-nc2": lambda: crash_case(3, 2, 31, 4),
    "rn5-nc4": lambda: crash_case(5, 4, 32, 3),
    "mixed-seed3": lambda: crash_history(3, n_calls=50, crash_rate=0.05),
    "many": lambda: crash_history(4, n_calls=60, crash_rate=0.4),
}


@pytest.mark.parametrize("name", sorted(SCAN_HISTORIES))
def test_split_and_scan_match_reference(name):
    h = SCAN_HISTORIES[name]()
    ref_drop, ref_crashed = ref_planner._split_crashed(h.ops)
    drop, crashed = planner._split_crashed(port(h).ops)
    assert np.array_equal(drop, ref_drop)
    assert [(ip, cp) for ip, cp, _ in crashed] == \
        [(ip, cp) for ip, cp, _ in ref_crashed]
    fk_ref, rows_ref = ref_scan(h)
    if fk_ref is None:                  # more than four crashed calls
        assert len(crashed) > 4
        with pytest.raises(planner.CrashedCalls):
            port_scan(h)
        return
    fk, rows = port_scan(h)
    assert rows == rows_ref
    assert (fk.nc, fk.rn, fk.max_open, fk.n_calls) == \
        (fk_ref.nc, fk_ref.rn, fk_ref.max_open, fk_ref.n_calls)
    assert fk.rets == fk_ref.rets
    assert np.array_equal(fk.cuts, fk_ref.cuts)
    ops = port(h).ops
    assert all(ops[p].type == "ok" for p in fk.positions)
    assert len(fk.positions) == fk.n_rets
    with pytest.raises(planner.CrashedCalls, match="crashed|never return"):
        port_scan(h, max_crashed=0)


@pytest.mark.parametrize("name", ["one-info", "rn3-nc2", "rn5-nc4",
                                  "mixed-seed3"])
def test_crash_wire_decodes_to_reference_tables(name):
    h = SCAN_HISTORIES[name]()
    fk_ref, rows = ref_scan(h)
    fk, _ = port_scan(h)
    R = fk.rn + fk.nc
    seg_ends = planner._segment_ends(fk.cuts, TARGET)
    assert seg_ends == ref_planner._segment_ends(fk_ref.cuts, TARGET)
    seg_fk = ref_planner._segments_from_fk(fk_ref, R, seg_ends)
    ref = ref_planner._pack_regs(list(enumerate(seg_fk)), len(seg_ends), R,
                                 len(rows), 2)
    mine = decode(*regs_kernel.pack_stream(fk, seg_ends, 2), len(rows))
    assert len(seg_ends) > 1
    for a, b in zip(mine[:3], ref[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # every crashed call open at a segment is registered in it, never
    # returned
    crash_slots = set(range(fk.rn, R))
    assert not crash_slots & set(mine[0][mine[0] >= 0].tolist())


@pytest.mark.parametrize("R,nc,Sn,U,dec", [
    (4, 4, 8, 40, True), (4, 4, 9, 40, True), (5, 3, 16, 40, True),
    (6, 3, 11, 40, True), (7, 1, 32, 40, True), (6, 2, 32, 40, True),
    (2, 5, 3, 40, True), (3, 1, 33, 40, True), (3, 1, 6, 32768, True),
    (3, 1, 6, 40, False)])
def test_crash_gate_matches_reference_candidates(R, nc, Sn, U, dec):
    shape = ref_planner.Shape(kind="linear", R=R, crashes=nc, Sn=Sn, U=U,
                              decomposed=dec)
    cands, _, _ = ref_planner._linear_candidates(shape, {}, "cpu")
    mine = planner.crash_gate(R, nc, Sn, U, dec) is None
    assert mine is ("wgl_seg_regs" in cands and dec)


# ---------------------------------------------------------------------------
# The crash kernel's plain version against the reference's kernel
# ---------------------------------------------------------------------------

# name -> (rn, nc, vmax, buggy): J = Sn * 2^nc with Sn = vmax + 2
KERNEL_CASES = {
    "rn1-nc1": (1, 1, 6, False),
    "rn4-nc1-bad": (4, 1, 3, True),
    "rn7-nc1": (7, 1, 2, False),
    "rn3-nc2-bad": (3, 2, 4, True),
    "rn6-nc2": (6, 2, 2, False),
    "rn2-nc3": (2, 3, 14, False),
    "rn5-nc3-bad": (5, 3, 3, True),
    "rn1-nc4": (1, 4, 2, False),
    "rn4-nc4": (4, 4, 6, False),
}


def every_value(h, vmax):
    """h after one process writes 0..vmax in turn, so every value is a
    model state: vmax + 2 states with the initial None."""
    ops = [o for v in range(vmax + 1)
           for o in (invoke_op(90, "write", v), ok_op(90, "write", v))]
    return RefHistory(ops + list(h)).index()


def crash_scan_case(h, rn, nc, name):
    """The crash wire of h, the reference kernel's transfer rows and the
    plain version's rows, work= counts and composed verdict."""
    fk, rows = port_scan(h)
    assert (fk.rn, fk.nc) == (rn, nc), name
    R = rn + nc
    seg_ends = planner._segment_ends(fk.cuts, TARGET)
    wire = regs_kernel.pack_stream(fk, seg_ends, 2)
    states, _, _, uop_tabs, aux, UP = uop_tables(rows)
    Sn = states.shape[0]
    tabs = decode(*wire, len(rows))[:3]
    K, Lp = tabs[0].shape[1], tabs[0].shape[0]
    kern = ref_seg._build_kernel_regs(
        K, Lp, 2, max(1, (1 << R) // 32), Sn, R, True, R, 1,
        J=Sn << nc, nc=nc, rn=rn)
    ref_T = np.asarray(kern(*tabs, *uop_tabs))
    work = torch.zeros(K, dtype=torch.int64)
    T, bad = crash_kernel.crash_scan(
        *(torch.from_numpy(x) for x in wire), torch.from_numpy(aux),
        R=R, Sn=Sn, UP=UP, nc=nc, rn=rn, work=work)
    return dict(ref_T=ref_T, T=T.numpy(), bad=int(bad[0]),
                work=work.numpy(), Sn=Sn, K=K, wire=wire, aux=aux,
                UP=UP, R=R, nc=nc, rn=rn, rows=rows,
                vd=regs_kernel.compose(T, [K])[0].numpy(),
                oracle=ref_cpu.check(ref_models.CASRegister(),
                                     h)["valid?"])


@pytest.fixture(scope="module")
def crash_scans():
    return {name: crash_scan_case(
        crash_case(rn, nc, 40 + rn * 7 + nc, vmax, buggy=buggy), rn, nc,
        name) for name, (rn, nc, vmax, buggy) in KERNEL_CASES.items()}


def assert_matches_reference(c):
    J = c["Sn"] << c["nc"]
    assert c["T"].shape == c["ref_T"].shape == (c["K"], J, J)
    assert np.array_equal(c["T"], c["ref_T"].astype(np.uint8))
    assert c["bad"] == 0 and (c["work"] > 0).all()
    # exact rounds: the composed verdict is the oracle's
    assert bool(c["vd"][0]) is c["oracle"]


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_crash_plain_matches_reference_kernel(crash_scans, name):
    assert_matches_reference(crash_scans[name])


def test_crash_cases_cover_the_edges(crash_scans):
    assert {c["nc"] for c in crash_scans.values()} == {1, 2, 3, 4}
    assert max(c["R"] for c in crash_scans.values()) == 8
    assert {regs_kernel.snp(c["Sn"]) for c in crash_scans.values()} == \
        {8, 16}
    assert max(c["Sn"] << c["nc"] for c in crash_scans.values()) == 128
    assert any(not c["oracle"] for c in crash_scans.values())


# ---------------------------------------------------------------------------
# The kernel's layout edges (one thread per lane and state row)
# ---------------------------------------------------------------------------

# name -> (rn, nc, vmax, buggy), with every value 0..vmax a state (Sn =
# vmax + 2): segments past 1024 threads (J * SnP, 88 x 16 at nc = 3 and
# Sn = 11, 128 x 32 at nc = 2 and Sn = 32), which the kernel splits over
# CTAs, and every normal slot b >= 5 returning (rn = 7)
EDGE_CASES = {
    "rn2-nc3-Sn11": (2, 3, 9, False),
    "rn3-nc3-Sn11-bad": (3, 3, 9, True),
    "rn1-nc2-Sn32": (1, 2, 30, False),
    "rn7-nc1-Sn11-bad": (7, 1, 9, True),
}


@pytest.fixture(scope="module")
def crash_edges():
    return {name: crash_scan_case(every_value(
        crash_case(rn, nc, 70 + rn * 7 + nc, vmax, buggy=buggy), vmax), rn,
        nc, name) for name, (rn, nc, vmax, buggy) in EDGE_CASES.items()}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_crash_edges_plain_matches_reference_kernel(crash_edges, name):
    assert crash_edges[name]["Sn"] == EDGE_CASES[name][2] + 2
    assert_matches_reference(crash_edges[name])


def test_crash_edges_cover_the_layout(crash_edges):
    width = {name: (c["Sn"] << c["nc"]) * regs_kernel.snp(c["Sn"])
             for name, c in crash_edges.items()}
    assert width == {"rn2-nc3-Sn11": 1408, "rn3-nc3-Sn11-bad": 1408,
                     "rn1-nc2-Sn32": 4096, "rn7-nc1-Sn11-bad": 352}
    c = crash_edges["rn7-nc1-Sn11-bad"]
    ret_t = decode(*c["wire"], len(c["rows"]))[0]
    # every normal slot returns, 5 and 6 among them; the crashed slot 7
    # never does
    assert set(ret_t[ret_t >= 0].tolist()) == set(range(c["rn"]))
    assert any(not c["oracle"] for c in crash_edges.values())


# ---------------------------------------------------------------------------
# The relaxed variant and the death row against the reference's kernels
# ---------------------------------------------------------------------------

def relaxed_inputs(h):
    """The port's relaxed-tier wire of h (`wgl_seg._relaxed_wire`) and
    the reference kernels' tables decoded from it."""
    model = models.CASRegister()
    ops = port(h).ops
    c = wgl_seg._split(model, model.device_spec(), ops, max_states=64,
                       max_open_bits=10)
    rw = wgl_seg._relaxed_wire(c)
    tabs = decode(*rw.wire, len(c.rows), crow=True)
    return dict(wire=rw.wire, tabs=tabs, ctab=rw.ctab, aux=rw.aux,
                UP=rw.UP, Sn=rw.Sn, R=rw.R, nC=len(rw.ctab) // rw.Sn,
                U=len(c.rows), I=min(2, rw.R), legal=c.legal,
                next_state=c.next_state,
                uop_tabs=planner._pack_uop_tables(
                    c.legal, c.next_state,
                    *planner._decompose(c.legal, c.next_state)))


def relaxed_planted(seed):
    h0 = crash_history(seed, n_calls=80, conc=3, crash_rate=0.15,
                       effect_rate=0.6)
    ops = list(h0)
    idx = [i for i, o in enumerate(ops) if o.type == "ok" and o.f == "read"]
    i = idx[len(idx) * 3 // 4]
    ops[i] = ops[i].assoc(value=99)
    return RefHistory(ops).index()


@pytest.mark.parametrize("seed", [41, 44, 47])
def test_relaxed_plain_matches_reference_kernels(seed):
    c = relaxed_inputs(relaxed_planted(seed))
    R, Sn, I = c["R"], c["Sn"], c["I"]
    ret_t, islot_t, iuop_t, crow_t = c["tabs"]
    Lp, K = ret_t.shape
    Wd = max(1, (1 << R) // 32)
    ctab_u = c["ctab"].view(np.uint32).reshape(-1, Sn)
    ref_T = np.asarray(ref_seg._build_kernel_regs(
        K, Lp, I, Wd, Sn, R, True, R, 1, J=Sn, crash_closure=True)(
        ret_t, islot_t[..., :I], iuop_t[..., :I], *c["uop_tabs"], crow_t,
        ctab_u[..., None]))
    nC_pad = planner._pad_len(c["nC"])
    ctab_pad = np.tile(((1 << np.arange(Sn)).astype(np.uint32))[None],
                       (nC_pad, 1))
    ctab_pad[:c["nC"]] = ctab_u
    a1t, a2t, t0t = c["uop_tabs"]
    buf8 = np.concatenate([ret_t.view(np.uint8).ravel(),
                           islot_t[..., :I].view(np.uint8).ravel(),
                           iuop_t[..., :I].view(np.uint8).ravel(),
                           crow_t.view(np.uint8).ravel()])
    buf32 = np.concatenate([a1t, a2t, t0t.view(np.uint32),
                            ctab_pad.ravel()])
    ref_vd = np.asarray(ref_seg._build_kernel_regs_relaxed(
        K, Lp, I, Wd, Sn, R, True, R, 1, c["U"], iuop_t.dtype == np.int16,
        nC_pad)(buf8, buf32))
    args = [torch.from_numpy(x) for x in c["wire"] + (c["aux"], c["ctab"])]
    work = torch.zeros(K, dtype=torch.int64)
    T, bad = crash_kernel.relaxed_scan(*args, R=R, Sn=Sn, UP=c["UP"],
                                       work=work)
    assert int(bad[0]) == 0 and (work > 0).all()
    assert np.array_equal(T.numpy(), ref_T.astype(np.uint8))
    vd = regs_kernel.compose(T, [K])[0].numpy()
    assert np.array_equal(vd, ref_vd)
    assert vd[0] == 0                    # the planted read refutes it
    dead = int(vd[1])
    seed_mask = int(vd[2]) & 0xFFFFFFFF
    ref_row = int(np.asarray(ref_seg._build_kernel_regs(
        1, Lp, I, Wd, Sn, R, True, rounds=R, unroll=1, J=1,
        crash_closure=True, death_row=True)(
        ret_t[:, dead:dead + 1], islot_t[:, dead:dead + 1, :I],
        iuop_t[:, dead:dead + 1, :I], *c["uop_tabs"],
        crow_t[:, dead:dead + 1], ctab_u[..., None],
        np.asarray([seed_mask], np.uint32))))
    rows, bad = crash_kernel.death_row(
        args[0], args[1][dead:dead + 1], args[2][dead:dead + 1], args[3],
        args[4], seed_mask, R=R, Sn=Sn, UP=c["UP"])
    assert int(bad[0]) == 0
    assert int(rows[0]) == ref_row >= 0


def death_edge(where):
    """A relaxed-tier history whose one segment dies at its first row
    ("first": it opens with a read of a value never written) or at its
    last ("last": it ends with one), its relaxed inputs, and the death
    row's seed (the composed entry states of the dead segment)."""
    ops = list(crash_history(43, n_calls=40, conc=3, crash_rate=0.15,
                             effect_rate=0.6))
    stale = [invoke_op(9, "read", None), ok_op(9, "read", 99)]
    c = relaxed_inputs(RefHistory(stale + ops if where == "first"
                                  else ops + stale).index())
    args = [torch.from_numpy(x) for x in c["wire"] + (c["aux"], c["ctab"])]
    T, _ = crash_kernel.relaxed_scan(*args, R=c["R"], Sn=c["Sn"],
                                     UP=c["UP"])
    vd = regs_kernel.compose(T, [len(c["wire"][1])])[0]
    return c, int(vd[1]), int(vd[2]) & 0xFFFFFFFF


def ref_death_row(c, dead, seed_mask):
    """The reference's death_row kernel on segment `dead` of c."""
    R, Sn, I = c["R"], c["Sn"], c["I"]
    ret_t, islot_t, iuop_t, crow_t = c["tabs"]
    Lp = ret_t.shape[0]
    ctab_u = c["ctab"].view(np.uint32).reshape(-1, Sn)
    return int(np.asarray(ref_seg._build_kernel_regs(
        1, Lp, I, max(1, (1 << R) // 32), Sn, R, True, rounds=R, unroll=1,
        J=1, crash_closure=True, death_row=True)(
        ret_t[:, dead:dead + 1], islot_t[:, dead:dead + 1, :I],
        iuop_t[:, dead:dead + 1, :I], *c["uop_tabs"],
        crow_t[:, dead:dead + 1], ctab_u[..., None],
        np.asarray([seed_mask], np.uint32))))


@pytest.mark.parametrize("where", ["first", "last"])
def test_death_row_at_segment_edges(where):
    c, dead, seed_mask = death_edge(where)
    args = [torch.from_numpy(x) for x in c["wire"] + (c["aux"], c["ctab"])]
    work = torch.zeros(1, dtype=torch.int64)
    rows, bad = crash_kernel.death_row(
        args[0], args[1][dead:dead + 1], args[2][dead:dead + 1], args[3],
        args[4], seed_mask, R=c["R"], Sn=c["Sn"], UP=c["UP"], work=work)
    L = int(c["wire"][2][dead])
    assert int(bad[0]) == 0 and int(work[0]) > 0
    assert int(rows[0]) == ref_death_row(c, dead, seed_mask) \
        == (0 if where == "first" else L - 1)


# ---------------------------------------------------------------------------
# The work= count: each lane's rounds up to its own fixpoint
# ---------------------------------------------------------------------------

def lane_walk(tabs, k, L, legal, nxt, *, R, Sn, start, ctab=None,
              stop_empty=False):
    """One lane of segment k (L rows) walked in plain Python, its plane
    a list of Sn ints over the 2^R masks: (integer operations, final
    plane, the row at which it emptied or -1, rounds left unrun, the
    operations it needs).  A row's rounds go on while they change the
    plane, at most R; each round run is charged.  The needed count
    charges a closure only where the row's masks let a state jump to
    another, and in a round only when its passes changed the plane."""
    ret_t, islot_t, iuop_t, crow_t = tabs
    WD = regs_kernel.plane_width(R)
    half = max(1, WD // 2)
    lack = [sum(1 << m for m in range(1 << R) if not m >> b & 1)
            for b in range(R)]
    closure_ops = crash_kernel.CLOSURE_OPS * Sn * Sn * WD
    plane = list(start)
    uop = {}
    ops = saved = need = 0

    def close(plane, masks):
        return [plane[t] | _or(plane[s] for s in range(Sn)
                               if masks[s] >> t & 1) for t in range(Sn)]

    for r in range(L):
        for b, u in zip(islot_t[r, k], iuop_t[r, k]):
            if b >= 0:
                uop[int(b)] = int(u)
        masks = None if ctab is None else ctab[int(crow_t[r, k])]
        jumps = masks is not None and any(
            masks[s] >> t & 1 for s in range(Sn) for t in range(Sn)
            if s != t)
        if masks is not None:
            plane = close(plane, masks)
            ops += closure_ops
            need += closure_ops if jumps else 0
        if uop:
            passes = sum(regs_kernel.CLOSE_OPS * Sn * WD if b < 5
                         else regs_kernel.CLOSE5_OPS * Sn * half
                         for b in uop)
            per = passes + (closure_ops if masks is not None else 0)
            for rd in range(R):
                old = list(plane)
                for b in sorted(uop):
                    src = [p & lack[b] for p in plane]
                    for s in range(Sn):
                        if legal[uop[b], s]:
                            plane[nxt[uop[b], s]] |= src[s] << (1 << b)
                grew = plane != old
                if masks is not None:
                    plane = close(plane, masks)
                ops += per
                need += passes + (closure_ops if jumps and grew else 0)
                if plane == old:
                    saved += R - rd - 1
                    break
        b = int(ret_t[r, k])
        if b >= 0:
            plane = [(p & ~lack[b]) >> (1 << b) for p in plane]
            del uop[b]
            ops += regs_kernel.PRUNE_OPS * Sn * (half if b >= 5 else WD)
            need += regs_kernel.PRUNE_OPS * Sn * (half if b >= 5 else WD)
        if stop_empty and not any(plane):
            return ops, plane, r, saved, need
    return ops, plane, -1, saved, need


def _or(xs):
    out = 0
    for x in xs:
        out |= x
    return out


@pytest.mark.parametrize("name", ["rn1-nc1", "rn7-nc1", "rn3-nc2-bad",
                                  "rn2-nc3", "rn4-nc4"])
def test_crash_work_counts_each_lanes_rounds(crash_scans, name):
    c = crash_scans[name]
    R, Sn, nc, rn = c["R"], c["Sn"], c["nc"], c["rn"]
    _, legal, nxt, *_ = uop_tables(c["rows"])
    tabs = decode(*c["wire"], len(c["rows"]))[:3] + (None,)
    unrun = 0
    for k in range(c["K"]):
        total = 0
        for j in range(Sn << nc):
            start = [0] * Sn
            start[j % Sn] = 1 << ((j // Sn) << rn)
            ops, plane, _, saved, _ = lane_walk(
                tabs, k, int(c["wire"][2][k]), legal, nxt, R=R, Sn=Sn,
                start=start)
            total += ops
            unrun += saved
            row = [(plane[s] >> (cm << rn)) & 1 for cm in range(1 << nc)
                   for s in range(Sn)]
            assert row == c["T"][k, j].tolist(), (k, j)
        assert total == c["work"][k], k
    assert unrun > 0                    # rows that stop short of R rounds


@pytest.mark.parametrize("seed", [41, 47])
def test_relaxed_work_counts_each_lanes_rounds(seed):
    c = relaxed_inputs(relaxed_planted(seed))
    R, Sn, UP = c["R"], c["Sn"], c["UP"]
    legal, nxt = c["legal"], c["next_state"]
    nrows = c["wire"][2]
    ctab = c["ctab"].view(np.uint32).reshape(-1, Sn).astype(np.int64)
    args = [torch.from_numpy(x) for x in c["wire"] + (c["aux"], c["ctab"])]
    K = len(c["wire"][1])
    work = torch.zeros(K, dtype=torch.int64)
    T, _ = crash_kernel.relaxed_scan(*args, R=R, Sn=Sn, UP=UP, work=work)
    for k in range(K):
        lanes = [lane_walk(c["tabs"], k, int(nrows[k]), legal, nxt, R=R,
                           Sn=Sn,
                           start=[int(s == j) for s in range(Sn)],
                           ctab=ctab) for j in range(Sn)]
        assert sum(x[0] for x in lanes) == int(work[k]), k
        assert [[p & 1 for p in x[1]] for x in lanes] == T[k].tolist()
    vd = regs_kernel.compose(T, [K])[0]
    dead, seed_mask = int(vd[1]), int(vd[2]) & 0xFFFFFFFF
    dwork = torch.zeros(1, dtype=torch.int64)
    rows, _ = crash_kernel.death_row(
        args[0], args[1][dead:dead + 1], args[2][dead:dead + 1], args[3],
        args[4], seed_mask, R=R, Sn=Sn, UP=UP, work=dwork)
    ops, _, row, _, _ = lane_walk(
        c["tabs"], dead, int(nrows[dead]), legal, nxt, R=R, Sn=Sn,
        start=[seed_mask >> s & 1 for s in range(Sn)], ctab=ctab,
        stop_empty=True)
    assert (ops, row) == (int(dwork[0]), int(rows[0]))


@pytest.mark.parametrize("seed", [41, 47])
def test_relaxed_need_counts_only_closures_that_can_change(seed):
    c = relaxed_inputs(relaxed_planted(seed))
    R, Sn, UP = c["R"], c["Sn"], c["UP"]
    legal, nxt = c["legal"], c["next_state"]
    nrows = c["wire"][2]
    ctab = c["ctab"].view(np.uint32).reshape(-1, Sn).astype(np.int64)
    args = [torch.from_numpy(x) for x in c["wire"] + (c["aux"], c["ctab"])]
    K = len(c["wire"][1])
    work = torch.zeros(K, dtype=torch.int64)
    need = torch.zeros(K, dtype=torch.int64)
    T = crash_kernel.walk_plain(*args, R=R, Sn=Sn, UP=UP, work=work,
                                need=need)
    for k in range(K):
        lanes = [lane_walk(c["tabs"], k, int(nrows[k]), legal, nxt, R=R,
                           Sn=Sn,
                           start=[int(s == j) for s in range(Sn)],
                           ctab=ctab) for j in range(Sn)]
        assert sum(x[4] for x in lanes) == int(need[k]), k
    assert bool((need <= work).all()) and int(need.sum()) < int(work.sum())
    vd = regs_kernel.compose(T, [K])[0]
    dead, seed_mask = int(vd[1]), int(vd[2]) & 0xFFFFFFFF
    dneed = torch.zeros(1, dtype=torch.int64)
    crash_kernel.walk_plain(
        args[0], args[1][dead:dead + 1], args[2][dead:dead + 1], args[3],
        args[4], R=R, Sn=Sn, UP=UP, seed=seed_mask, need=dneed)
    lane = lane_walk(
        c["tabs"], dead, int(nrows[dead]), legal, nxt, R=R, Sn=Sn,
        start=[seed_mask >> s & 1 for s in range(Sn)], ctab=ctab,
        stop_empty=True)
    assert lane[4] == int(dneed[0])


@pytest.mark.parametrize("name", ["rn2-nc3", "rn4-nc4"])
def test_crash_need_is_work_without_closure(crash_scans, name):
    c = crash_scans[name]
    need = torch.zeros(c["K"], dtype=torch.int64)
    T = crash_kernel.walk_plain(
        *(torch.from_numpy(x) for x in c["wire"] + (c["aux"],)), R=c["R"],
        Sn=c["Sn"], UP=c["UP"], nc=c["nc"], rn=c["rn"], need=need)
    assert np.array_equal(T.numpy(), c["T"])
    assert need.tolist() == c["work"].tolist()


# ---------------------------------------------------------------------------
# The tiers end to end
# ---------------------------------------------------------------------------

def residual():
    """The reference's residual case: many effect-bearing crashed writes
    whose effects are observed."""
    ops = [invoke_op(9, "write", 0), ok_op(9, "write", 0)]
    for i in range(6):
        ops += [invoke_op(i, "write", i % 3 + 1)]
    for i in range(6):
        ops += [invoke_op(9, "read", None), ok_op(9, "read", i % 3 + 1)]
        ops += [invoke_op(8, "write", 0), ok_op(8, "write", 0)]
    for i in range(6):
        ops += [info_op(i, "write", i % 3 + 1)]
    return RefHistory(ops).index()


# name -> (history, the tier it must take)
TIER_CASES = {
    "inert-only": (lambda: crash_history(3, n_calls=60, crash_rate=0.45,
                                         crash_f=("read",)), "dropped"),
    "bounded-valid": (lambda: RefHistory(
        [invoke_op(0, "write", 1), ok_op(0, "write", 1),
         invoke_op(1, "write", 2), invoke_op(0, "read", None),
         ok_op(0, "read", 2), invoke_op(0, "read", None),
         ok_op(0, "read", 2), info_op(1, "write", 2)]).index(), "bounded"),
    "bounded-invalid": (lambda: crash_history(1, n_calls=40, corrupt=True),
                        "bounded"),
    "stripped-valid": (lambda: crash_history(
        11, n_calls=80, crash_rate=0.2, crash_f=("write", "cas"),
        effect_rate=0.0), "stripped"),
    "crash-relaxed": (lambda: relaxed_planted(40), "relaxed"),
    "residual": (residual, "residual"),
}
TIER_KEYS = ("valid?", "op_index", "crashed", "crashed_dropped",
             "crashed_ignored", "refutation", "witness",
             "witness_bound_index", "dead_segment", "engine")


@pytest.mark.parametrize("name", sorted(TIER_CASES))
def test_check_matches_reference_in_every_tier(name):
    make, tier = TIER_CASES[name]
    h = make()
    h.attach_packed(pack_history(h))
    localize = tier != "relaxed"
    if tier == "residual":
        # wgl_seg.check leaves it open in both; both checkers then run
        # their serial frontier engines
        with pytest.raises(ref_seg.Unsupported):
            ref_seg.check(ref_models.CASRegister(), h)
        with pytest.raises(Unsupported, match="P5"):
            wgl_seg.check(models.CASRegister(), port(h), device="cpu")
        ref = RefLinearizable(ref_models.CASRegister()).check(None, h)
        got = Linearizable(models.CASRegister(), device="cpu").check(
            None, port(h))
        assert got["engine"] == "wgl"
        for key in ("valid?", "op_index", "frontier_size",
                    "final_frontier"):
            assert got.get(key) == ref.get(key), key
        return
    ref = ref_seg.check(ref_models.CASRegister(), h, localize=localize)
    st = {}
    got = wgl_seg.check(models.CASRegister(), port(h), device="cpu",
                        localize=localize, stats=st)
    assert {"scan", "split"} <= set(st)
    lin = Linearizable(models.CASRegister(), device="cpu",
                       localize=localize).check(None, port(h))
    for key in TIER_KEYS:
        assert got.get(key) == ref.get(key), key
        assert lin.get(key) == ref.get(key), key
    field = {"dropped": "crashed_dropped", "bounded": "crashed",
             "stripped": "crashed_ignored", "relaxed": "refutation"}[tier]
    assert got.get(field) is not None
    assert f"crash tier" in got["dispatch"]["why"]
    if ref["valid?"] is False and localize:
        assert got["op_index"] == ref_cpu.check(
            ref_models.CASRegister(), h)["op_index"]


@pytest.mark.parametrize("planted", [False, True])
def test_deep_route_with_crashed_slots(planted):
    # normal depth 7 and two crashed writes: R + nc = 9 is past the
    # segment kernel's 8, so the deep kernel carries them
    h = crash_case(7, 2, 77, 3, n_ops=70)
    if planted:
        ops = list(h)
        i = [i for i, o in enumerate(ops) if o.type == "ok"
             and o.f == "read"][-3]
        ops[i] = ops[i].assoc(value=99)
        h = RefHistory(ops).index()
    got = wgl_seg.check(models.CASRegister(), port(h), device="cpu")
    o = ref_cpu.check(ref_models.CASRegister(), h)
    assert got["engine"] == "wgl_deep" and got["crashed"] == 2
    assert got["dispatch"]["R"] == 9
    assert got["valid?"] is o["valid?"] is (not planted)
    assert got.get("op_index") == o.get("op_index")


def test_pipeline_matches_reference_on_a_mixed_batch():
    hs = [rand_history(61, n_ops=60, conc=3),
          TIER_CASES["bounded-valid"][0](),
          TIER_CASES["inert-only"][0](),
          rand_history(62, n_ops=60, conc=4, buggy=True),
          TIER_CASES["bounded-invalid"][0](),
          rand_history(63, n_ops=60, conc=2)]
    for h in hs:
        h.attach_packed(pack_history(h))
    ref = ref_seg.check_pipeline(ref_models.CASRegister(), hs)
    got = wgl_seg.check_pipeline(models.CASRegister(),
                                 [port(h) for h in hs], device="cpu")
    singles = [wgl_seg.check(models.CASRegister(), port(hs[i]),
                             device="cpu") for i in (1, 2, 4)]
    for i, r in enumerate(got):
        for key in TIER_KEYS:
            assert r.get(key) == ref[i].get(key), (i, key)
    for i, single in zip((1, 2, 4), singles):
        assert not got[i].get("pipelined")
        for key in TIER_KEYS:
            assert got[i].get(key) == single.get(key), (i, key)
    assert all(got[i].get("pipelined") for i in (0, 3, 5))


@pytest.mark.cuda
def test_crash_kernels_match_plain_on_card(crash_scans, crash_edges):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    launches = dict(crash_kernel.LAUNCHES)
    scans = {**crash_scans, **crash_edges}
    for name, c in sorted(scans.items()):
        args = [torch.from_numpy(x).cuda() for x in c["wire"] + (c["aux"],)]
        work = torch.zeros(c["K"], dtype=torch.int64, device="cuda")
        T, bad = crash_kernel.crash_scan(*args, R=c["R"], Sn=c["Sn"],
                                         UP=c["UP"], nc=c["nc"], rn=c["rn"],
                                         work=work)
        assert np.array_equal(T.cpu().numpy(), c["T"]), name
        assert np.array_equal(work.cpu().numpy(), c["work"]), name
        assert int(bad.cpu()[0]) == 0
    for seed in (41, 44, 47):
        c = relaxed_inputs(relaxed_planted(seed))
        K = len(c["wire"][1])
        outs = []
        for dev in ("cuda", "cpu"):
            args = [torch.from_numpy(x).to(dev)
                    for x in c["wire"] + (c["aux"], c["ctab"])]
            work = torch.zeros(K, dtype=torch.int64, device=dev)
            dwork = torch.zeros(K, dtype=torch.int64, device=dev)
            T, _ = crash_kernel.relaxed_scan(*args, R=c["R"], Sn=c["Sn"],
                                             UP=c["UP"], work=work)
            rows, _ = crash_kernel.death_row(*args, 1, R=c["R"], Sn=c["Sn"],
                                             UP=c["UP"], work=dwork)
            outs.append([x.cpu() for x in (T, work, rows, dwork)])
        for got, want in zip(*outs):
            assert torch.equal(got, want), seed
    for where in ("first", "last"):
        c, dead, seed_mask = death_edge(where)
        outs = []
        for dev in ("cuda", "cpu"):
            args = [torch.from_numpy(x).to(dev)
                    for x in c["wire"] + (c["aux"], c["ctab"])]
            work = torch.zeros(1, dtype=torch.int64, device=dev)
            rows, _ = crash_kernel.death_row(
                args[0], args[1][dead:dead + 1], args[2][dead:dead + 1],
                args[3], args[4], seed_mask, R=c["R"], Sn=c["Sn"],
                UP=c["UP"], work=work)
            outs.append((rows.cpu(), work.cpu()))
        assert torch.equal(outs[0][0], outs[1][0]), where
        assert torch.equal(outs[0][1], outs[1][1]), where
    assert crash_kernel.LAUNCHES["wgl_regs_crash"] == \
        launches["wgl_regs_crash"] + len(scans)
    assert crash_kernel.LAUNCHES["wgl_regs_relaxed"] == \
        launches["wgl_regs_relaxed"] + 8
