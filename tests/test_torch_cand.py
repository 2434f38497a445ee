"""The candidate-table route of jepsen_tpu_torch against jepsen_tpu's
(`planner.plan`, and the XLA scans `_build_kernel_bits` and
`_build_kernel` run by JAX on the CPU), on histories made with numpy
from a seed:

- `planner.plan` and `_pack_cand_tables` equal the reference's, array
  for array and dtype for dtype: wide CAS registers (33..40 values, so
  35..42 states, past the segment kernel's 32), the undecomposed counter
  mod 3 and mod 10, and CAS histories at overlap depth 7..10;
- the plain versions of `wgl_cand_bits` and `wgl_cand_dense` (what the
  wrappers run for CPU tensors) give the reference's transfer rows T
  bit for bit at J = Sn and J = 1, each form on the shapes the reference
  sends it, and the dense form also on the bits form's shapes;
- `wgl_seg.check`, `check_many`, `Linearizable` and a
  `check_pipeline` straggler agree with the reference's `check` and
  `check_many` on valid?, dead_segment, op_index and the engine, on
  wide-state and undecomposed histories and on PreparedHistory inputs
  at R 7..10.

`tests/test_torch_cand_card.py` holds the kernels against the plain
versions on a card."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import counter_dicts, key_dicts, mod_counter, wide_dicts
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import Linearizable as RefLinearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu.ops.prep import prepare as ref_prepare
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.ops import cand_kernel, planner, wgl_deep, wgl_seg
from jepsen_tpu_torch.ops.prep import prepare

TARGET = 24                      # returns per segment in the kernel cases


def ref_counter(n):
    """The reference's counter mod n (tests/test_wgl_seg.py's Mod3 at
    n = 3), with a jax step."""
    def step(state, f, a, b, a_ok):
        s = state[0]
        is_inc = f == 0
        ns = jnp.where(is_inc, (s + 1) % n, s)
        legal = is_inc | ((f == 1) & (a.astype(jnp.int32) == s))
        return jnp.where(legal, ns, s)[None], legal

    @dataclasses.dataclass(frozen=True)
    class RefModCounter(ref_models.Model):
        value: int = 0

        def step(self, o):
            if o.f == "inc":
                return RefModCounter((self.value + 1) % n)
            if o.f == "read":
                if o.value == self.value:
                    return self
                return ref_models.inconsistent(f"read {o.value!r}")
            return ref_models.inconsistent(f"unknown f {o.f!r}")

        def device_spec(self):
            return ref_models.DeviceSpec(
                1, {"inc": 0, "read": 1},
                lambda m: np.array([m.value], np.int32), step)

    return RefModCounter()


def models_of(kind):
    """(port model, reference model) of a case kind."""
    if kind == "cas":
        return models.CASRegister(), ref_models.CASRegister()
    n = int(kind[3:])
    return mod_counter(n), ref_counter(n)


#: name -> (kind, op dicts maker): wide-state CAS registers, undecomposed
#: counters, and CAS histories deeper than the segment kernel
CASES = {
    "wide33": ("cas", lambda: wide_dicts(700, 33, n_calls=40, conc=3)),
    "wide36-r4-bad": ("cas", lambda: wide_dicts(701, 36, n_calls=50, conc=5,
                                                max_open=4, buggy=0.1)),
    "wide40-r2": ("cas", lambda: wide_dicts(702, 40, n_calls=40, conc=2)),
    "mod3": ("mod3", lambda: counter_dicts(710, 3, n_calls=40, conc=3)),
    "mod3-bad": ("mod3", lambda: counter_dicts(711, 3, n_calls=40, conc=3,
                                               buggy=0.2)),
    "mod10-r4": ("mod10", lambda: counter_dicts(712, 10, n_calls=40, conc=4,
                                                max_open=4)),
    "mod10-bad": ("mod10", lambda: counter_dicts(713, 10, n_calls=40,
                                                 conc=3, buggy=0.15)),
    "cas-r4-bad": ("cas", lambda: key_dicts(722, n_calls=30, conc=4, vmax=6,
                                            max_open=4, burst=4,
                                            buggy=0.15)),
    "cas-r8": ("cas", lambda: key_dicts(720, n_calls=24, conc=8, vmax=6,
                                        max_open=8, burst=8)),
    "cas-r10-bad": ("cas", lambda: key_dicts(721, n_calls=24, conc=10,
                                             vmax=6, max_open=10, burst=10,
                                             buggy=0.2)),
}


def plans(name):
    kind, make = CASES[name]
    dicts = make()
    m, rm = models_of(kind)
    pl = planner.plan(prepare(convert.history_from_dicts(dicts)),
                      m.device_spec(), m, target_returns_per_segment=TARGET)
    rpl = ref_planner.plan(ref_prepare(RefHistory(dicts)), rm.device_spec(),
                           rm, target_returns_per_segment=TARGET)
    return pl, rpl


@pytest.fixture(scope="module")
def all_plans():
    return {name: plans(name) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_reference(all_plans, name):
    pl, rpl = all_plans[name]
    for f in ("ret_slot", "cand_slot", "cand_uop", "legal", "next_state",
              "states", "seg_end_call", "diag_w", "const_w", "const_t0"):
        a, b = getattr(pl, f), getattr(rpl, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pl.n_calls, pl.max_open) == (rpl.n_calls, rpl.max_open)
    assert (pl.seg_fk is None) == (rpl.seg_fk is None)
    for f, rf in zip(pl.seg_fk or (), rpl.seg_fk or ()):
        for x, y in zip(f.arrays, rf.arrays):
            assert np.array_equal(x, y)
    cuop_t = np.ascontiguousarray(pl.cand_uop.transpose(1, 0, 2))
    if pl.diag_w is not None or pl.states.shape[0] <= 8:
        ours = planner._pack_cand_tables(cuop_t, pl.legal, pl.next_state,
                                         pl.diag_w, pl.const_w, pl.const_t0)
        theirs = ref_planner._pack_cand_tables(
            cuop_t, rpl.legal, rpl.next_state, rpl.diag_w, rpl.const_w,
            rpl.const_t0)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cases_cover_the_forms(all_plans):
    forms = {planner.cand_gate(pl.max_open, pl.states.shape[0],
                               pl.diag_w is not None): pl
             for pl, _ in all_plans.values()}
    assert set(forms) == {"bits", "dense"}
    shapes = {(pl.states.shape[0] > 32, pl.diag_w is not None,
               pl.max_open > 6) for pl, _ in all_plans.values()}
    assert {(True, True, False), (False, False, False),
            (False, True, True)} <= shapes
    assert any(pl.diag_w is None and pl.states.shape[0] > 8
               for pl, _ in all_plans.values())


def tables(pl, J, K_pad=0):
    """The [L, K(, C)] tables of a plan, with K_pad all-padding lanes."""
    ret, cs, cu = pl.ret_slot, pl.cand_slot, pl.cand_uop
    if K_pad:
        K, L, C = cs.shape
        ret = np.concatenate([ret, np.full((K_pad, L), -1, np.int32)])
        cs = np.concatenate([cs, np.zeros((K_pad, L, C), np.int32)])
        cu = np.concatenate([cu, np.full((K_pad, L, C), -1, np.int32)])
    return (np.ascontiguousarray(ret.T), np.ascontiguousarray(
        cs.transpose(1, 0, 2)), np.ascontiguousarray(cu.transpose(1, 0, 2)))


def ref_T(pl, J, form, K_pad=0):
    """The reference kernel of `form` on the plan's tables."""
    ret_t, cslot_t, cuop_t = tables(pl, J, K_pad)
    L, K, C = cslot_t.shape
    R, Sn = pl.max_open, pl.states.shape[0]
    dec = pl.diag_w is not None
    if form == "bits":
        a1, a2, t0 = ref_planner._pack_cand_tables(
            cuop_t, pl.legal, pl.next_state, pl.diag_w, pl.const_w,
            pl.const_t0)
        kern = ref_seg._build_kernel_bits(
            K, L, C, max(1, (1 << R) // 32), Sn, R, dec, J,
            rounds=R if R <= 6 else 0, unroll=1)
        T = kern(ret_t.astype(np.int8), cslot_t.astype(np.int8), a1, a2, t0)
        return np.asarray(T).astype(np.uint8)
    U = pl.legal.shape[0]
    kern = ref_seg._build_kernel(K, L, C, 1 << R, Sn, R, dec, J=J)
    T = kern(ret_t, cslot_t, cuop_t, pl.legal, pl.next_state,
             pl.diag_w if dec else np.zeros((U, Sn), np.float32),
             pl.const_w if dec else np.zeros((U, Sn), np.float32),
             pl.const_t0 if dec else np.zeros(U, np.int32))
    return (np.asarray(T, np.float32) > 0.5).astype(np.uint8)


def port_T(pl, J, form, K_pad=0):
    ret_t, cslot_t, cuop_t = (torch.from_numpy(x)
                              for x in tables(pl, J, K_pad))
    R, Sn = pl.max_open, pl.states.shape[0]
    dec = (pl.diag_w, pl.const_w, pl.const_t0)
    if form == "bits":
        a1, a2, t0 = (torch.from_numpy(x) for x in cand_kernel.bits_tables(
            cuop_t.numpy(), pl.legal, pl.next_state, *dec))
        T, bad = cand_kernel.cand_bits(ret_t, cslot_t, a1, a2, t0, R=R,
                                       Sn=Sn, J=J,
                                       decomposed=dec[0] is not None)
    else:
        tab, nxt = (torch.from_numpy(x) for x in cand_kernel.dense_tables(
            pl.legal, pl.next_state, *dec))
        T, bad = cand_kernel.cand_dense(ret_t, cslot_t, cuop_t, tab, nxt,
                                        R=R, Sn=Sn, J=J)
    assert int(bad[0]) == 0
    return T.numpy()


#: the kernel cases: every case at its own form, J = Sn and 1 (R <= 4, a
#: few segments: the reference compiles each shape on the CPU)
KERNEL_CASES = [(n, J) for n in ("wide33", "wide36-r4-bad", "mod3",
                                 "mod3-bad", "mod10-r4", "mod10-bad",
                                 "cas-r4-bad")
                for J in ("Sn", 1)]


@pytest.mark.parametrize("name,J", KERNEL_CASES)
def test_plain_matches_reference_kernel(all_plans, name, J):
    pl, _ = all_plans[name]
    Sn = pl.states.shape[0]
    J = Sn if J == "Sn" else 1
    form = planner.cand_gate(pl.max_open, Sn, pl.diag_w is not None)
    want = ref_T(pl, J, form, K_pad=2)
    got = port_T(pl, J, form, K_pad=2)
    assert got.shape == want.shape == (pl.ret_slot.shape[0] + 2, J, Sn)
    assert np.array_equal(got, want)
    if J == Sn:
        # a padding lane transfers each state to itself
        assert np.array_equal(got[-1], np.eye(Sn, dtype=np.uint8))


@pytest.mark.parametrize("name", ["mod3-bad", "wide33", "cas-r4-bad"])
def test_dense_form_on_every_shape(all_plans, name):
    """The dense form takes the bits form's shapes too, and both agree
    with the reference's dense scan."""
    pl, _ = all_plans[name]
    Sn = pl.states.shape[0]
    want = ref_T(pl, Sn, "dense")
    assert np.array_equal(port_T(pl, Sn, "dense"), want)
    if Sn <= 8 or pl.diag_w is not None and Sn <= 32:
        assert np.array_equal(port_T(pl, Sn, "bits"), want)


def test_plain_counts_operations(all_plans):
    pl, _ = all_plans["wide36-r4-bad"]
    ret_t, cslot_t, cuop_t = (torch.from_numpy(x)
                              for x in tables(pl, 1, 0))
    tab, nxt = (torch.from_numpy(x) for x in cand_kernel.dense_tables(
        pl.legal, pl.next_state, pl.diag_w, pl.const_w, pl.const_t0))
    need = torch.zeros(ret_t.shape[1], dtype=torch.int64)
    params = cand_kernel._dense_params(cuop_t, tab, nxt,
                                       pl.states.shape[0])
    cand_kernel.walk_plain(ret_t, cslot_t, params, R=pl.max_open,
                           Sn=pl.states.shape[0], J=1, need=need)
    assert (need > 0).all()


def test_operation_count_follows_the_model():
    """One segment, R = 1, one decomposed candidate (state 0 -> 1) at
    slot 0 and its return: one closure round (R caps the rounds),
    SKIP_OPS at mask 0 (no slot) and CAND_OPS at mask 1 (its partner set
    {0} not empty), then a prune of both masks."""
    ret = torch.tensor([[0]], dtype=torch.int32)
    cslot = torch.zeros((1, 1, 1), dtype=torch.int32)
    one = torch.ones((1, 1, 1), dtype=torch.int64)
    params = ("dec", 0 * one, one, one)      # diag {}, rank-1 {0} -> 1
    need = torch.zeros(1, dtype=torch.int64)
    T = cand_kernel.walk_plain(ret, cslot, params, R=1, Sn=2, J=1,
                               need=need)
    assert T.tolist() == [[[0, 1]]]
    ck = cand_kernel
    assert int(need[0]) == ck.SKIP_OPS + ck.CAND_OPS + ck.PRUNE_OPS * 2
    # a lane empty after its first row (the candidate, 1 -> 1, moves
    # nothing from {0}) costs nothing in the rows that follow
    need2 = torch.zeros(1, dtype=torch.int64)
    ret2 = torch.tensor([[0], [-1]], dtype=torch.int32)
    cslot2 = torch.zeros((2, 1, 1), dtype=torch.int32)
    p2 = ("dec", torch.zeros((2, 1, 1), dtype=torch.int64),
          torch.tensor([[[2]], [[1]]]), torch.ones((2, 1, 1),
                                                   dtype=torch.int64))
    T2 = cand_kernel.walk_plain(ret2, cslot2, p2, R=1, Sn=2, J=1,
                                need=need2)
    assert T2.tolist() == [[[0, 0]]]
    assert int(need2[0]) == ck.SKIP_OPS + ck.CAND_OPS + ck.PRUNE_OPS * 2


def test_wrappers_refuse_bad_input(all_plans):
    pl, _ = all_plans["wide33"]
    ret_t, cslot_t, cuop_t = (torch.from_numpy(x)
                              for x in tables(pl, 1, 0))
    tab, nxt = (torch.from_numpy(x) for x in cand_kernel.dense_tables(
        pl.legal, pl.next_state, pl.diag_w, pl.const_w, pl.const_t0))
    Sn, R = pl.states.shape[0], pl.max_open
    with pytest.raises(ValueError, match="outside the table"):
        cand_kernel.cand_dense(ret_t, cslot_t, cuop_t + 10_000, tab, nxt,
                               R=R, Sn=Sn, J=1)
    with pytest.raises(ValueError, match="past R"):
        cand_kernel.cand_dense(ret_t, cslot_t + R, cuop_t, tab, nxt, R=R,
                               Sn=Sn, J=1)
    with pytest.raises(ValueError, match="bits form"):
        cand_kernel.cand_bits(ret_t, cslot_t, cuop_t, cuop_t, cuop_t, R=R,
                              Sn=Sn, J=1, decomposed=True)
    with pytest.raises(ValueError, match="unsupported"):
        cand_kernel.cand_dense(ret_t, cslot_t, cuop_t, tab, nxt, R=11,
                               Sn=Sn, J=1)


@pytest.mark.parametrize("R,Sn,dec,want", [
    (6, 32, True, "bits"), (6, 33, True, "dense"), (10, 8, False, "bits"),
    (3, 9, False, "dense"), (7, 64, True, "dense"), (11, 40, True, None),
    (4, 65, True, None), (0, 4, True, None)])
def test_cand_gate_is_the_reference_split(R, Sn, dec, want):
    got = planner.cand_gate(R, Sn, dec)
    if want is None:
        assert got not in planner.CAND_FORMS and "ROADMAP P5" in got
    else:
        assert got == want


# ---------------------------------------------------------------------------
# The entry points against the reference's
# ---------------------------------------------------------------------------

ENTRY_KEYS = ("valid?", "dead_segment", "op_index", "engine", "segments",
              "states")

#: name -> (kind, op dicts maker) for the entry points
ENTRY_CASES = {
    "wide-valid": ("cas", lambda: wide_dicts(730, 38, n_calls=300, conc=5,
                                             max_open=4)),
    "wide-planted": ("cas", lambda: wide_dicts(731, 38, n_calls=300,
                                               conc=5, max_open=4,
                                               buggy=0.02)),
    "mod3-planted": ("mod3", lambda: counter_dicts(732, 3, n_calls=200,
                                                   conc=4, buggy=0.03)),
    "mod10-valid": ("mod10", lambda: counter_dicts(733, 10, n_calls=200,
                                                   conc=4, max_open=3)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_CASES))
def test_check_matches_reference(name):
    kind, make = ENTRY_CASES[name]
    dicts = make()
    m, rm = models_of(kind)
    ref = ref_seg.check(rm, RefHistory(dicts))
    got = wgl_seg.check(m, convert.history_from_dicts(dicts), device="cpu")
    for key in ENTRY_KEYS:
        assert got.get(key) == ref.get(key), key
    d = got["dispatch"]
    assert d["engine"] == "wgl_seg" and d["kernel"].startswith("wgl_cand_")
    assert d["form"] == planner.cand_gate(got["max_open"], got["states"],
                                          kind == "cas")
    if name.endswith("planted"):
        assert got["valid?"] is False and got["op_index"] is not None
    with pytest.raises(BackendUnavailable):
        wgl_seg.check(m, convert.history_from_dicts(dicts))


@pytest.mark.parametrize("name", ["cas-r8", "cas-r10-bad", "mod3-bad",
                                  "wide36-r4-bad"])
def test_prepared_history_matches_reference(name):
    kind, make = CASES[name]
    dicts = make()
    m, rm = models_of(kind)
    ref = ref_seg.check(rm, ref_prepare(RefHistory(dicts)),
                        target_returns_per_segment=256)
    got = wgl_seg.check(m, prepare(convert.history_from_dicts(dicts)),
                        device="cpu")
    for key in ("valid?", "dead_segment", "engine", "segments", "states",
                "op_count"):
        assert got.get(key) == ref.get(key), key
    assert "op_index" not in got and "op_index" not in ref


def test_linearizable_decides_wide_histories():
    _, make = ENTRY_CASES["wide-planted"]
    dicts = make()
    ref = RefLinearizable(ref_models.CASRegister()).check(
        None, RefHistory(dicts))
    got = Linearizable(models.CASRegister(), device="cpu").check(
        None, convert.history_from_dicts(dicts))
    assert got["engine"] == got["dispatch"]["engine"] == "wgl_seg"
    assert got["dispatch"]["kernel"] == "wgl_cand_dense"
    for key in ("valid?", "op_index", "dead_segment"):
        assert got.get(key) == ref.get(key), key


@pytest.mark.parametrize("pipeline", ["wgl_seg", "wgl_deep"])
def test_pipeline_straggler_takes_the_plan_route(pipeline):
    """A wide history in either pipeline's batch is a straggler that
    check() sends down the plan route: at R 4 in wgl_seg's, at R 8 (past
    the deep kernel's 32 states) in wgl_deep's."""
    R = 4 if pipeline == "wgl_seg" else 8
    hs = [key_dicts(740 + s, n_calls=60, conc=R, max_open=R, burst=R)
          for s in range(3)]
    hs.insert(1, wide_dicts(731, 38, n_calls=150, conc=R, max_open=R,
                            burst=R, buggy=0.02))
    m = models.CASRegister()
    run = (wgl_seg if pipeline == "wgl_seg" else wgl_deep).check_pipeline
    out = run(m, [convert.history_from_dicts(d) for d in hs], device="cpu")
    ref = ref_seg.check(ref_models.CASRegister(), RefHistory(hs[1]))
    got = out[1]
    assert got["dispatch"]["kernel"] == "wgl_cand_dense"
    assert "pipelined" not in got
    for key in ENTRY_KEYS:
        assert got.get(key) == ref.get(key), key
    assert all(r["valid?"] is True for i, r in enumerate(out) if i != 1)


def many_keys(kind):
    if kind == "cas":
        return ([wide_dicts(750 + s, 36, n_calls=30, conc=4)
                 for s in range(5)]
                + [wide_dicts(760 + s, 36, n_calls=30, conc=4, buggy=0.2)
                   for s in range(3)])
    n = int(kind[3:])
    return [counter_dicts(770 + s, n, n_calls=30, conc=3,
                          buggy=0.2 if s % 3 == 2 else 0.0)
            for s in range(8)]


@pytest.mark.parametrize("kind", ["cas", "mod3", "mod10"])
def test_check_many_candidate_lanes(kind):
    keys = many_keys(kind)
    m, rm = models_of(kind)
    ref = ref_seg.check_many(rm, [RefHistory(d) for d in keys])
    st: dict = {}
    got = wgl_seg.check_many(m, [convert.history_from_dicts(d)
                                 for d in keys], device="cpu", stats=st)
    assert st["launches"] == 1
    # the reference runs its register kernel's nibble form at Sn <= 8
    # (B2n, not ported): the port's candidate lanes stand in for it
    ref_engine = "wgl_seg_batch_regs" if kind == "mod3" else "wgl_seg_batch"
    for r, g in zip(ref, got):
        assert g["valid?"] == r["valid?"]
        assert g["engine"] == "wgl_seg_batch" and r["engine"] == ref_engine
        assert g["dispatch"]["kernel"].startswith("wgl_cand_")
        assert g.get("op_index") == r.get("op_index")
    assert any(g["valid?"] is False for g in got)
    assert any(g["valid?"] is True for g in got)


def test_refusals_still_name_p5():
    dicts = key_dicts(780, n_calls=30, conc=12, vmax=40, max_open=11,
                      burst=11)
    deep = [dict(d, index=j) for j, d in enumerate(wide_dicts(781, 40)
                                                   + dicts)]
    with pytest.raises(Unsupported, match="ROADMAP P5"):
        wgl_seg.check(models.CASRegister(),
                      convert.history_from_dicts(deep), device="cpu",
                      max_open_bits=12)
    with pytest.raises(Unsupported, match="max_states"):
        wgl_seg.check(models.CASRegister(),
                      convert.history_from_dicts(wide_dicts(782, 40)),
                      device="cpu", max_states=32)
