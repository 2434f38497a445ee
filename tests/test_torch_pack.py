"""jepsen_tpu_torch's host scan and packers against jepsen_tpu's Python
twins on the same seeded histories: the scan (rets, max_open, cuts,
interning), the register-delta tables of _pack_regs and the compact
wire are byte-equal; the scan's return positions name the returns."""

import numpy as np
import pytest
from test_wgl_deep import burst_history, deep_history

from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import invoke_op, ok_op, info_op
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_deep as ref_deep
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.ops import planner, wgl_deep


def spill_burst():
    # an invoke burst far beyond I = 2 per return row: virtual spill rows
    ops = [invoke_op(p, "write", p % 3) for p in range(9)]
    ops += [ok_op(p, "write", p % 3) for p in range(9)]
    ops += [invoke_op(0, "read", None), ok_op(0, "read", 2),
            invoke_op(1, "write", 1), ok_op(1, "write", 1),
            invoke_op(2, "read", None), ok_op(2, "read", 1)]
    return RefHistory(ops).index()


HISTORIES = {
    "r4": lambda: deep_history(120, 6, seed=3, max_open=4),
    "r7": lambda: deep_history(140, 14, seed=57, max_open=7),
    "r9-vmax5": lambda: deep_history(150, 14, seed=59, vmax=5,
                                     max_open=9),
    "r10": lambda: deep_history(150, 16, seed=60, max_open=10),
    "r15-burst": lambda: burst_history(15, seed=1),
    "spill-burst": spill_burst,
}


def scan_both(h, max_open_bits=16):
    ref_spec = ref_models.CASRegister().device_spec()
    seen_r, rows_r = {}, []
    fk_r = ref_planner._fast_scan(h, ref_spec, seen_r, rows_r,
                                  max_open_bits)
    ph = convert.history_from_dicts(h.to_dicts())
    seen, rows = {}, []
    fk = planner._fast_scan(ph, models.CASRegister().device_spec(), seen,
                            rows, max_open_bits)
    return (fk_r, seen_r, rows_r), (fk, seen, rows), ph


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_scan_and_tables_byte_equal(name):
    h = HISTORIES[name]()
    (fk_r, seen_r, rows_r), (fk, seen, rows), ph = scan_both(h)
    assert fk.rets == fk_r.rets
    assert fk.max_open == fk_r.max_open and fk.n_calls == fk_r.n_calls
    assert fk.cuts.tobytes() == fk_r.cuts.tobytes()
    assert seen == seen_r and rows == rows_r
    # positions: the op position of every return, in order
    assert len(fk.positions) == fk.n_rets
    for pos, (slot, _) in zip(fk.positions, fk.rets):
        assert ph.ops[pos].type == "ok"
    R, U = int(fk.max_open), len(rows)
    I = min(2, R)
    got = planner._pack_regs([(0, fk)], 1, R, U, I)
    want = ref_planner._pack_regs([(0, fk_r)], 1, R, U, I)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    cbuf, G = wgl_deep.pack_events_compact(*got[:3])
    ref_cbuf, ref_G = ref_deep.pack_events_compact(*want[:3])
    assert G == ref_G and cbuf.tobytes() == ref_cbuf.tobytes()


def test_spill_rows_are_emitted():
    h = spill_burst()
    _, (fk, _, rows), _ = scan_both(h)
    ret_t, islot_t, _, _ = planner._pack_regs([(0, fk)], 1,
                                              int(fk.max_open), len(rows),
                                              2)
    # 9 invokes before the first return: 4 spill rows (ret -1) carry 8
    assert (ret_t[:4, 0] == -1).all() and ret_t[4, 0] >= 0
    assert (islot_t[:5, 0, :] >= 0).sum() == 9


def test_aux_byte_equal():
    a1 = np.array([1, 6, 0xFFFFFFFF], np.uint32)
    a2 = np.array([0, 1, 2], np.uint32)
    t0 = np.array([0, 3, 1], np.int32)
    for UP in (8, 64):
        # the reference's first 3*UP words; its 16 trailing pattern
        # words live in the kernel's constant memory
        assert wgl_deep.pack_aux(a1, a2, t0, UP).tobytes() == \
            ref_deep.pack_aux(a1, a2, t0, UP)[0, :3 * UP].tobytes()
    assert [wgl_deep._pad_u(u) for u in (1, 9, 121, 4000)] == \
        [ref_deep._pad_u(u) for u in (1, 9, 121, 4000)]
    assert [wgl_deep._pad_g(g) for g in (1, 3, 17, 40)] == \
        [ref_deep._pad_g(g) for g in (1, 3, 17, 40)]


def test_scan_refuses_out_of_slice_shapes():
    spec = models.CASRegister().device_spec()
    crashed = convert.history_from_dicts(RefHistory(
        [invoke_op(0, "write", 1), info_op(0, "write", 1),
         invoke_op(1, "read", None), ok_op(1, "read", 1)]).index()
        .to_dicts())
    with pytest.raises(planner.CrashedCalls, match="crashed"):
        planner._fast_scan(crashed, spec, {}, [], 10)
    deep = convert.history_from_dicts(burst_history(12).to_dicts())
    with pytest.raises(planner.Unsupported, match="max_open_bits=10"):
        planner._fast_scan(deep, spec, {}, [], 10)
    twice = convert.history_from_dicts(RefHistory(
        [invoke_op(0, "write", 1), invoke_op(0, "write", 2)]).index()
        .to_dicts())
    with pytest.raises(ValueError, match="double-invoked"):
        planner._fast_scan(twice, spec, {}, [], 10)
