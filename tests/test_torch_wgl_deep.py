"""The deep kernel of jepsen_tpu_torch against jepsen_tpu's Pallas
kernel (run by the Pallas interpreter, as the suite runs it on the CPU)
on identical numpy tables: `valid?` and `failed_row` are equal exactly.
Covers R 7-10, a stream of more than one 512-row block, the word-split
depth R = 15, the batched pipeline, and the wrapper's checks.  On the
CPU the port runs the kernel's plain PyTorch version; the one test that
needs the card skips without one."""

import numpy as np
import pytest
import torch
from test_wgl_deep import burst_history, corrupt, deep_history

from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import info_op, invoke_op, ok_op, pack_history
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_cpu as ref_cpu
from jepsen_tpu.ops import wgl_deep as ref_deep
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.ops import deep_kernel, wgl_deep

CASES = {
    "r7-valid": lambda: deep_history(140, 14, seed=57, max_open=7),
    "r7-bad": lambda: corrupt(deep_history(140, 14, seed=77,
                                           max_open=7), 0.6),
    "r8-bad": lambda: corrupt(deep_history(140, 14, seed=78,
                                           max_open=8), 0.8),
    "r9-valid": lambda: deep_history(150, 14, seed=59, max_open=9),
    "r10-bad": lambda: corrupt(deep_history(150, 14, seed=80,
                                            max_open=10), 0.9),
    "multi-block": lambda: deep_history(620, 14, seed=11, max_open=7),
    "multi-block-bad": lambda: corrupt(
        deep_history(620, 14, seed=11, max_open=7), 0.95),
    "r15-word-split": lambda: burst_history(15, seed=1),
    "r15-word-split-bad": lambda: corrupt(burst_history(15, seed=1), 0.6),
}


def ref_tables(h, max_open_bits=16):
    model = ref_models.CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fk = ref_planner._fast_scan(h, spec, seen, rows, max_open_bits)
    uops = np.asarray(rows, np.int32).reshape(-1, 4)
    states, legal, nxt = ref_planner._enumerate_states(
        spec, np.asarray(spec.encode(model), np.int32), uops, 64)
    dec = ref_planner._decompose(legal, nxt)
    R = int(fk.max_open)
    ret_t, islot_t, iuop_t, _ = ref_planner._pack_regs(
        [(0, fk)], 1, R, len(rows), min(2, R))
    tables = (ret_t, islot_t, iuop_t) + ref_planner._pack_uop_tables(
        legal, nxt, *dec)
    return tables, R, states.shape[0]


@pytest.fixture(scope="module")
def verdicts():
    out = {}
    for name, make in CASES.items():
        tables, R, Sn = ref_tables(make())
        ref = ref_deep.check_tables(*tables, R, Sn)
        got = wgl_deep.check_tables(*convert.tables_to_device(*tables),
                                    R, Sn, device="cpu")
        out[name] = (ref, got, R, tables)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_tables_matches_pallas(verdicts, name):
    ref, got, R, tables = verdicts[name]
    assert got["valid?"] is ref["valid?"]
    assert got["failed_row"] == ref["failed_row"]
    assert got["valid?"] is (not name.endswith("bad"))
    assert got.get("deep_variant") == ref.get("deep_variant")
    if name.startswith("multi"):
        assert tables[0].shape[0] > deep_kernel.EB
    if name.startswith("r15"):
        assert R == 15 and got["shards"] == 2


def test_plain_counts_work(verdicts):
    _, _, R, tables = verdicts["r8-bad"]
    cbuf, G = wgl_deep.pack_events_compact(*tables[:3])
    aux = wgl_deep.pack_aux(*tables[3:], wgl_deep._pad_u(len(tables[3])))
    work = {}
    alive, row = deep_kernel.walk_plain(
        torch.from_numpy(cbuf), torch.from_numpy(aux.view(np.int32)),
        L2=G * deep_kernel.EB, R=R, SnP=8,
        UP=wgl_deep._pad_u(len(tables[3])), work=work)
    assert (alive, row) == (0, verdicts["r8-bad"][0]["failed_row"])
    assert work["words"] > 0 and work["rounds"] > 0


def pipeline_batch():
    ops18 = [invoke_op(p, "write", p % 3) for p in range(18)]
    ops18 += [ok_op(p, "write", p % 3) for p in range(18)]
    h18 = RefHistory(ops18).index()
    crashed = RefHistory([invoke_op(0, "write", 1), info_op(0, "write", 1),
                          invoke_op(1, "read", None),
                          ok_op(1, "read", 1)]).index()
    hs = [deep_history(100, 14, seed=210, max_open=8), h18,
          corrupt(deep_history(100, 14, seed=212, max_open=8), 0.7),
          burst_history(15, seed=3), crashed,
          deep_history(90, 6, seed=5, max_open=4),
          RefHistory([invoke_op(0, "write", 1), ok_op(0, "write", 1),
                      invoke_op(0, "read", None),
                      ok_op(0, "read", 2)]).index()]
    for h in hs:
        h.attach_packed(pack_history(h))
    return hs


def test_pipeline_matches_reference_and_isolates_out_of_scope():
    hs = pipeline_batch()
    model = ref_models.CASRegister()
    ref = ref_deep.check_pipeline(model, hs)
    st = {}
    got = wgl_deep.check_pipeline(
        models.CASRegister(),
        [convert.history_from_dicts(h.to_dicts()) for h in hs],
        device="cpu", stats=st)
    for i in (0, 2, 3, 5, 6):          # R = 8, 8, 15, 4, 1: one grid
        assert got[i]["engine"] == "wgl_deep" and got[i]["pipelined"]
        assert got[i]["valid?"] is ref[i]["valid?"]
        assert got[i].get("op_index") == ref[i].get("op_index")
    assert got[2]["valid?"] is False
    assert got[2]["op_index"] == ref_cpu.check(model, hs[2])["op_index"]
    assert got[3]["deep_variant"] == "word-split"
    assert got[6]["valid?"] is False and got[6]["max_open"] == 1
    # R = 18: a straggler beyond every batched gate, decided by the
    # serial frontier engine as the reference's is; the crashed history:
    # the crash tiers' verdict, as the reference's stragglers get it
    assert got[1]["valid?"] is ref[1]["valid?"] is True
    for key in ("frontier_size", "final_frontier", "op_count"):
        assert got[1][key] == ref[1][key], key
    assert got[1]["engine"] == got[1]["dispatch"]["engine"] == "wgl"
    assert "P5" in got[1]["dispatch"]["why"]
    assert got[4]["valid?"] is ref[4]["valid?"] is True
    assert got[4]["crashed"] == ref[4]["crashed"] == 1
    assert {"scan", "pack", "sync"} <= set(st)


def test_pipeline_state_space_failure_makes_stragglers():
    # history 1's 85 states outgrow max_states 64: as in the reference,
    # it and every later history become stragglers, each checked on its
    # own alphabet after the grid.  Histories 0 and 2 get the
    # reference's verdicts; history 1's comes from the serial engine in
    # both
    wide = []
    for p in range(3):
        for v in range(p * 30, p * 30 + 28):
            wide += [invoke_op(p, "write", v), ok_op(p, "write", v)]
    hs = [deep_history(60, 12, seed=230, max_open=7),
          RefHistory(wide).index(),
          deep_history(60, 12, seed=231, max_open=7)]
    for h in hs:
        h.attach_packed(pack_history(h))
    ref = ref_deep.check_pipeline(ref_models.CASRegister(), hs,
                                  max_states=64)
    got = wgl_deep.check_pipeline(
        models.CASRegister(),
        [convert.history_from_dicts(h.to_dicts()) for h in hs],
        max_states=64, device="cpu")
    for i in (0, 2):
        assert got[i]["valid?"] is ref[i]["valid?"] is True
        assert got[i].get("op_index") == ref[i].get("op_index")
    assert got[1]["valid?"] is ref[1]["valid?"] is True
    assert got[1]["engine"] == "wgl"
    assert "max_states" in got[1]["dispatch"]["why"]
    assert got[1]["final_frontier"] == ref[1]["final_frontier"]
    assert got[2]["valid?"] is True


def test_wrapper_checks_inputs():
    cbuf = torch.zeros(512 * (1 + 3 * deep_kernel.I), dtype=torch.uint8)
    offs = torch.zeros(1, dtype=torch.int64)
    rows = torch.full((1,), 512, dtype=torch.int32)
    aux = torch.zeros(3 * 8, dtype=torch.int32)
    depth = torch.ones(1, dtype=torch.int32)
    out = deep_kernel.deep_walk(cbuf, offs, rows, depth, aux, R=1, SnP=8,
                                UP=8)
    assert out.tolist() == [[1, -1]]
    with pytest.raises(ValueError, match="uint8"):
        deep_kernel.deep_walk(cbuf.to(torch.int32), offs, rows, depth, aux,
                              R=1, SnP=8, UP=8)
    with pytest.raises(ValueError, match="sizes"):
        deep_kernel.deep_walk(cbuf, offs, rows, depth, aux[:-1], R=1,
                              SnP=8, UP=8)
    with pytest.raises(ValueError, match="shape"):
        deep_kernel.deep_walk(cbuf, offs, rows, depth, aux, R=17, SnP=8,
                              UP=8)
    with pytest.raises(ValueError, match="depth 2"):
        deep_kernel.deep_walk(cbuf, offs, rows, depth + 1, aux, R=1,
                              SnP=8, UP=8)
    with pytest.raises(ValueError, match="out of range"):
        deep_kernel.deep_walk(cbuf[:-1], offs, rows, depth, aux, R=1,
                              SnP=8, UP=8)


def test_check_tables_widens_single_invoke_tables():
    # at R = 1 the reference packs I = min(2, R) = 1 invoke column; the
    # port's one wire layout has two, the second left empty
    for last in (1, 2):
        h = RefHistory([invoke_op(0, "write", 1), ok_op(0, "write", 1),
                        invoke_op(0, "read", None),
                        ok_op(0, "read", last)]).index()
        tables, R, Sn = ref_tables(h)
        assert R == 1 and tables[1].shape[2] == 1
        ref = ref_deep.check_tables(*tables, R, Sn)
        got = wgl_deep.check_tables(*convert.tables_to_device(*tables),
                                    R, Sn, device="cpu")
        assert got["valid?"] is ref["valid?"] is (last == 1)
        assert got["failed_row"] == ref["failed_row"]


def test_plane_placement():
    assert deep_kernel.plane_in_shared(14, 32)
    assert deep_kernel.plane_in_shared(16, 16)
    assert deep_kernel.plane_in_shared(15, 32)
    assert not deep_kernel.plane_in_shared(16, 32)
    assert [deep_kernel.threads_for(r) for r in (3, 8, 10, 12, 14, 16)] \
        == [32, 32, 32, 128, 512, 1024]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(verdicts):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, (_, got, R, tables) in sorted(verdicts.items()):
        card = wgl_deep.check_tables(*tables, R, 5, device="cuda")
        assert card["valid?"] is got["valid?"], name
        assert card["failed_row"] == got["failed_row"], name
    # both arms in one grid: depth 7 (warp arm), 11 and 14 (block arm)
    hs = [convert.history_from_dicts(h.to_dicts()) for h in (
        deep_history(90, 12, seed=31, max_open=8),
        burst_history(11, seed=3),
        corrupt(burst_history(14, seed=4), 0.5))]
    _, grid, _ = wgl_deep.pack_pipeline(models.CASRegister(), hs,
                                        device="cpu")
    before = dict(deep_kernel.ARM_LAUNCHES)
    walks = []
    for dev in ("cuda", "cpu"):
        wire = grid.to_device(torch.device(dev))
        work = torch.zeros(len(hs), dtype=torch.int64, device=dev)
        out = deep_kernel.deep_walk(*wire, work=work, **grid.shape())
        walks.append((out.cpu().tolist(), work.cpu().tolist()))
    assert walks[0] == walks[1]
    assert [row[0] for row in walks[0][0]] == [1, 1, 0]
    assert all(deep_kernel.ARM_LAUNCHES[a] == before[a] + 1 for a in before)
