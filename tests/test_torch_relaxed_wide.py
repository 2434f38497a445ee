"""The relaxed crash tier's two-word lift (B2w: 33..64 model states) of
jepsen_tpu_torch against jepsen_tpu's, on wide CAS register histories
with crashed calls made with numpy from a seed:

- the plain version of the relaxed walk (`crash_kernel.walk_plain`,
  what `relaxed_scan` and `death_row` run for CPU tensors) gives the
  transfer rows, the composed verdict words and the death row of the
  reference's `_build_kernel_regs(sn_words=2)` (`crash_closure`,
  `death_row`) and `_build_kernel_regs_relaxed(sn_words=2)`, bit for
  bit, on the port's wire decoded into the reference's tables; the
  two-word closures and uop tables equal the reference's;
- `wgl_seg.check` refutes a wide crash history with a planted stale
  read as the reference's does: the same verdict, refutation, witness,
  op_index and dead segment, at W = 2.

`tests/test_torch_cand_card.py` holds the kernel's two-word instances
against the plain version on a card."""

import numpy as np
import pytest
import torch
from test_torch_crash import decode

from chip_smoke import key_dicts, op, plant_stale_read
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.ops import crash_kernel, planner, regs_kernel, wgl_seg

VMAX = 36                        # 38 states: None, 0..36


def wide_crash(seed, n_calls=120, conc=4, crash_rate=0.06, plant=True):
    """A CAS register key that writes every value 0..VMAX, then runs
    key_dicts' workload with crashed calls; with `plant`, a read at 80%
    depth is rewritten to a value no call or crashed call can explain.
    Returns the port's History."""
    head = []
    for v in range(VMAX + 1):
        head += [op(0, "invoke", "write", v), op(0, "ok", "write", v)]
    body = key_dicts(seed, n_calls=n_calls, conc=conc, vmax=VMAX,
                     max_open=conc, crash_rate=crash_rate)
    dicts = [dict(d, index=j) for j, d in enumerate(head + body)]
    h = convert.history_from_dicts(dicts)
    if plant:
        crashed = {v for d in body if d["type"] == "info"
                   for v in ([d["value"]] if d["f"] == "write" else
                             d["value"] if d["f"] == "cas" else [])}
        assert plant_stale_read(h, 0.8, VMAX, forbidden=crashed) is not None
    return h


def relaxed_inputs(h):
    model = models.CASRegister()
    c = wgl_seg._split(model, model.device_spec(), h.ops, max_states=64,
                       max_open_bits=10)
    rw = wgl_seg._relaxed_wire(c)
    assert rw is not None and rw.Sn > 32
    return c, rw


@pytest.mark.parametrize("seed", [800, 803])
def test_wide_tables_match_reference(seed):
    c, rw = relaxed_inputs(wide_crash(seed))
    dec = planner._decompose(c.legal, c.next_state)
    ours = planner._pack_uop_tables(c.legal, c.next_state, *dec, sn_words=2)
    theirs = ref_planner._pack_uop_tables(c.legal, c.next_state, *dec,
                                          sn_words=2)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    eff = [(ip, u) for (ip, _, _), ine, u in zip(c.crashed, c.inert,
                                                 c.crash_uop) if not ine]
    ctab = wgl_seg._prefix_closures(eff, c.legal, c.next_state)
    Sn = rw.Sn
    want = ref_closures(eff, c.legal, c.next_state)
    assert np.array_equal(ctab.view(np.uint32).reshape(-1, Sn, 2), want)


def ref_closures(eff, legal, next_state):
    """The reference's two-word prefix closures (`_relaxed_refute`'s
    `_rows_to_words` of each crash prefix's closure), unpadded."""
    Sn = legal.shape[1]
    C = np.eye(Sn, dtype=bool)
    rows = [C]
    for _, u in eff:
        rel = np.zeros((Sn, Sn), bool)
        lg = legal[u].astype(bool)
        rel[np.arange(Sn)[lg], next_state[u][lg]] = True
        C = C | rel
        while True:
            C2 = C | (C @ C)
            if (C2 == C).all():
                break
            C = C2
        rows.append(C)
    out = np.zeros((len(rows), Sn, 2), np.uint32)
    for c, M in enumerate(rows):
        for sw in range(2):
            lo, hi = sw * 32, min((sw + 1) * 32, Sn)
            pw = (1 << np.arange(hi - lo, dtype=np.uint64)).astype(np.uint64)
            out[c, :, sw] = (M[:, lo:hi].astype(np.uint64) * pw).sum(1)
    return out


@pytest.mark.parametrize("seed", [800, 801, 803])
def test_wide_relaxed_plain_matches_reference_kernels(seed):
    c, rw = relaxed_inputs(wide_crash(seed))
    R, Sn, UP = rw.R, rw.Sn, rw.UP
    I = min(2, R)
    U = len(c.rows)
    ret_t, islot_t, iuop_t, crow_t = decode(*rw.wire, U, crow=True)
    Lp, K = ret_t.shape
    Wd = max(1, (1 << R) // 32)
    dec = planner._decompose(c.legal, c.next_state)
    a1t, a2t, t0t = ref_planner._pack_uop_tables(c.legal, c.next_state,
                                                 *dec, sn_words=2)
    ctab = rw.ctab.view(np.uint32).reshape(-1, Sn, 2)
    nC = ctab.shape[0]
    ref_T = np.asarray(ref_seg._build_kernel_regs(
        K, Lp, I, Wd, Sn, R, True, R, 1, J=Sn, crash_closure=True,
        sn_words=2)(ret_t, islot_t[..., :I], iuop_t[..., :I], a1t, a2t, t0t,
                    crow_t, ctab))
    nC_pad = planner._pad_len(nC)
    ctab_pad = np.zeros((nC_pad, Sn, 2), np.uint32)
    eye = np.eye(Sn, dtype=np.uint64)
    for sw in range(2):
        pw = np.zeros(Sn, np.uint64)
        pw[32 * sw:32 * (sw + 1)] = 1 << np.arange(
            min(32, Sn - 32 * sw), dtype=np.uint64)
        ctab_pad[:, :, sw] = (eye * pw).sum(1)
    ctab_pad[:nC] = ctab
    buf8 = np.concatenate([ret_t.view(np.uint8).ravel(),
                           islot_t[..., :I].view(np.uint8).ravel(),
                           iuop_t[..., :I].view(np.uint8).ravel(),
                           crow_t.view(np.uint8).ravel()])
    buf32 = np.concatenate([a1t.ravel(), a2t.ravel(), t0t.view(np.uint32),
                            ctab_pad.ravel()])
    ref_vd = np.asarray(ref_seg._build_kernel_regs_relaxed(
        K, Lp, I, Wd, Sn, R, True, R, 1, U, iuop_t.dtype == np.int16,
        nC_pad, sn_words=2)(buf8, buf32))
    args = [torch.from_numpy(x) for x in rw.wire + (rw.aux, rw.ctab)]
    work = torch.zeros(K, dtype=torch.int64)
    T, bad = crash_kernel.relaxed_scan(*args, R=R, Sn=Sn, UP=UP, work=work)
    assert int(bad[0]) == 0 and (work > 0).all()
    assert np.array_equal(T.numpy(), ref_T.astype(np.uint8))
    vd = regs_kernel.compose(T, [K])[0].numpy()
    assert np.array_equal(vd, ref_vd)
    assert vd[0] == 0                    # the planted read refutes it
    dead = int(vd[1])
    seed_words = (vd[2:4].astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    ref_row = int(np.asarray(ref_seg._build_kernel_regs(
        1, Lp, I, Wd, Sn, R, True, rounds=R, unroll=1, J=1,
        crash_closure=True, death_row=True, sn_words=2)(
        ret_t[:, dead:dead + 1], islot_t[:, dead:dead + 1, :I],
        iuop_t[:, dead:dead + 1, :I], a1t, a2t, t0t,
        crow_t[:, dead:dead + 1], ctab, seed_words)))
    seed_mask = int(seed_words[0]) | int(seed_words[1]) << 32
    rows, bad = crash_kernel.death_row(
        args[0], args[1][dead:dead + 1], args[2][dead:dead + 1], args[3],
        args[4], seed_mask, R=R, Sn=Sn, UP=UP)
    assert int(bad[0]) == 0
    assert int(rows[0]) == ref_row >= 0


@pytest.mark.parametrize("seed", [800, 801])
def test_wide_crash_refuted_as_the_reference(seed):
    h = wide_crash(seed)
    dicts = h.to_dicts()
    ref = ref_seg.check(ref_models.CASRegister(), RefHistory(dicts),
                        localize=False)
    got = wgl_seg.check(models.CASRegister(),
                        convert.history_from_dicts(dicts), device="cpu",
                        localize=False)
    for key in ("valid?", "refutation", "witness", "op_index",
                "witness_bound_index", "dead_segment", "engine",
                "crashed"):
        assert got.get(key) == ref.get(key), key
    assert got["refutation"] == "crash-relaxed" and got["states"] > 32
    assert got["witness"] == "relaxed-exact"


def test_wide_crash_valid_on_the_stripped_twin():
    h = wide_crash(802, plant=False)
    dicts = h.to_dicts()
    ref = ref_seg.check(ref_models.CASRegister(), RefHistory(dicts))
    got = wgl_seg.check(models.CASRegister(),
                        convert.history_from_dicts(dicts), device="cpu")
    for key in ("valid?", "crashed_ignored", "engine", "states"):
        assert got.get(key) == ref.get(key), key
    assert got["valid?"] is True
    assert got["dispatch"]["kernel"] == "wgl_cand_dense"
