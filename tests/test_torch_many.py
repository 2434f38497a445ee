"""Batched keys in jepsen_tpu_torch (`wgl_seg.check_many`, each key one
lane of the key kernel, `regs_kernel.keys_scan`) against jepsen_tpu's
`check_many` (its
XLA kernels, run by JAX on the CPU), on keys made from a seed with numpy
as op dicts and fed to both packages through
`convert.history_from_dicts`:

- a batch at R <= 6 (the reference's register lanes): valid keys at
  concurrency 5, planted invalid keys, crash keys whose stripped twin is
  valid, crash keys that go through `check()`, an all-crashed key, an
  empty key, keys with and without columns, and a key the scan refuses;
  per key valid?, op_count, anomaly, op, op_index and crashed_ignored
  equal the reference's, the refused key excepted (unsupported, naming
  ROADMAP P5);
- a batch mixing R <= 6 keys with keys at R 7..10, which the port sends
  to the deep kernel's grid (the reference to its candidate-table
  lanes);
- the key launch's function: the reference's `_build_kernel_regs_many_c`
  ([K, 1, Sn] > 0.5) against `regs_kernel.keys_scan` on the CPU (its
  plain version, `scan_plain` at J = 1) on the same keys' wires, at
  R = 1..6 and every state bucket;
- the rules: refused parameters and kernel shapes, a double invoke,
  max_states, key order (the launch's longest-first order and its
  inverse), one exact launch on check_many's own inputs, a wide-valued
  deep key that leaves the lanes' alphabet alone, and a hypothesis
  property against the CPU oracle.

The key launch on the card is held against its plain version by
`tests/test_torch_many_card.py`, which imports no JAX."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_keys import (indexed, key_dicts, key_launch_inputs, lane_keys, op,
                        port_histories, warp_keys)

from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import pack_history as ref_pack
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.ops import regs_kernel, wgl_cpu, wgl_seg
from jepsen_tpu_torch.ops.prep import prepare

FIELDS = ("valid?", "op_count", "anomaly", "op", "op_index",
          "crashed_ignored")


# a crashed write explains the read: the stripped twin dies, check()'s
# crash tiers prove the key valid
TWIN_DIES = indexed([op(0, "invoke", "write", 1), op(0, "ok", "write", 1),
                     op(1, "invoke", "write", 3), op(1, "info", "write", 3),
                     op(0, "invoke", "read", None), op(0, "ok", "read", 3)])
# no write explains the read, crashed or not: invalid through check()
CRASH_INVALID = indexed([op(0, "invoke", "write", 1),
                         op(0, "ok", "write", 1),
                         op(1, "invoke", "write", 2),
                         op(1, "info", "write", 2),
                         op(0, "invoke", "read", None),
                         op(0, "ok", "read", 4)])
ALL_CRASHED = indexed([op(0, "invoke", "write", 1), op(0, "info", "write", 1),
                       op(1, "invoke", "read", None)])
# valid only by linearizing the write, then the first cas, then the
# second, all before the second cas returns: invoked in the reverse
# order, so one closure round a row is not enough
REVERSE_CHAIN = indexed([op(0, "invoke", "cas", [4, 5]),
                         op(1, "invoke", "cas", [3, 4]),
                         op(2, "invoke", "write", 3),
                         op(0, "ok", "cas", [4, 5]),
                         op(1, "ok", "cas", [3, 4]),
                         op(2, "ok", "write", 3)])
PAST_INT32 = indexed([op(0, "invoke", "write", 2 ** 40),
                      op(0, "ok", "write", 2 ** 40),
                      op(1, "invoke", "read", None),
                      op(1, "ok", "read", 2 ** 40)])


def batch_a():
    """(name, op dicts, columns?) of the R <= 6 batch."""
    keys = [(f"valid-{k}", key_dicts(100 + k, n_calls=30 + k, conc=5),
             k % 2 == 0) for k in range(24)]
    keys += [(f"planted-{k}", key_dicts(200 + k, n_calls=60, conc=5,
                                        buggy=0.2), k == 0)
             for k in range(3)]
    keys += [(f"crash-twin-{k}", key_dicts(300 + k, n_calls=50, conc=5,
                                           crash_rate=0.1), k == 1)
             for k in range(3)]
    keys += [("twin-dies", TWIN_DIES, False),
             ("crash-invalid", CRASH_INVALID, True),
             ("all-crashed", ALL_CRASHED, False),
             ("reverse-chain", REVERSE_CHAIN, False),
             ("empty", [], False),
             ("past-int32", PAST_INT32, False),
             ("deep-cols", key_dicts(400, n_calls=40, conc=6, max_open=6,
                                     burst=6), True)]
    return keys


def batch_b():
    """The mixed batch: keys at R 7..10 (one planted, one a crash key
    whose twin is at R 8) among keys at R <= 6."""
    keys = [(f"r{R}", key_dicts(500 + R, n_calls=30, conc=R + 2,
                                max_open=R, burst=R), R % 2 == 0)
            for R in (7, 8, 9, 10)]
    keys += [(f"shallow-{R}", key_dicts(520 + R, n_calls=40, conc=R + 1,
                                        max_open=R, burst=R), R == 3)
             for R in (2, 3, 5)]
    keys += [("r8-planted", key_dicts(540, n_calls=40, conc=10, max_open=8,
                                      burst=8, buggy=0.1), True),
             ("r8-crash-twin", key_dicts(541, n_calls=40, conc=10,
                                         max_open=8, burst=8,
                                         crash_rate=0.1), False)]
    return keys


def both(keys):
    """The reference's and the port's histories of `keys`, columns
    attached where asked."""
    ref = []
    for _, dicts, cols in keys:
        r = RefHistory(dicts)
        if cols:
            r.attach_packed(ref_pack(r))
        ref.append(r)
    return ref, port_histories(keys)


def run_both(keys, **kw):
    ref_h, port_h = both(keys)
    ref = ref_seg.check_many(ref_models.CASRegister(), ref_h, **kw)
    stats = {}
    got = wgl_seg.check_many(models.CASRegister(), port_h, device="cpu",
                             stats=stats, **kw)
    return ref, got, stats


def pick(r):
    return {k: r.get(k) for k in FIELDS}


@pytest.fixture(scope="module")
def many_a():
    keys = batch_a()
    ref, got, stats = run_both(keys)
    return {name: (i, ref[i], got[i]) for i, (name, _, _) in
            enumerate(keys)}, stats


@pytest.fixture(scope="module")
def many_b():
    keys = batch_b()
    ref, got, stats = run_both(keys)
    return {name: (i, ref[i], got[i]) for i, (name, _, _) in
            enumerate(keys)}, stats


@pytest.mark.parametrize("name", [n for n, _, _ in batch_a()])
def test_many_matches_reference(many_a, name):
    _, ref, got = many_a[0][name]
    assert pick(got) == pick(ref)


def test_batch_a_covers_its_cases(many_a):
    by = {n: got for n, (_, _, got) in many_a[0].items()}
    refs = {n: ref for n, (_, ref, _) in many_a[0].items()}
    assert all(by[f"planted-{k}"]["valid?"] is False for k in range(3))
    assert all(by[f"crash-twin-{k}"].get("crashed_ignored")
               for k in range(3))
    assert by["twin-dies"]["valid?"] is True and \
        by["twin-dies"]["crashed"] == 1
    assert by["crash-invalid"]["valid?"] is False
    assert by["all-crashed"] == dict(by["all-crashed"], **{
        "valid?": True, "op_count": 0, "crashed_ignored": 2})
    assert by["empty"]["valid?"] is True and by["empty"]["op_count"] == 0
    assert by["reverse-chain"]["valid?"] is True
    assert by["deep-cols"]["dispatch"]["R"] == 6
    # both run their fallback there: the serial engine raises on the
    # value past int32, the CPU oracle decides it
    assert refs["past-int32"]["valid?"] is by["past-int32"]["valid?"] \
        is True


def test_many_routes(many_a):
    by = {n: got for n, (_, _, got) in many_a[0].items()}
    stats = many_a[1]
    lanes = [n for n in by if n.startswith(("valid-", "planted-",
                                            "crash-twin-", "deep-cols",
                                            "reverse-chain"))]
    for n in lanes:
        assert by[n]["engine"] == "wgl_seg_batch_regs", n
        assert by[n]["dispatch"]["R"] == 6
        assert by[n]["dispatch"]["why"] == wgl_seg.WHY_KEYS
    for n in ("twin-dies", "crash-invalid"):
        assert by[n]["engine"] == "wgl_seg"        # through check()
    for n in ("all-crashed", "empty"):
        assert by[n]["engine"] == "wgl_seg_batch"
    bad = by["past-int32"]
    assert bad["valid?"] is True and bad["engine"] == "fallback"
    assert bad["dispatch"]["why"] == wgl_seg.WHY_FALLBACK
    for n, r in by.items():
        assert "time_total_s" in r
        assert {"engine", "time_kernel_s", "dispatch"} <= set(r)
        if n == "past-int32":        # the CPU oracle's map
            continue
        assert {"op_count", "backend"} <= set(r)
        assert r["backend"] == "cpu"
        assert set(r["dispatch"]) >= {"engine", "why", "batch", "device",
                                      "R"}
        assert r["dispatch"]["engine"] == r["engine"]
    assert by["planted-0"]["dispatch"]["batch"] == len(by)
    assert {"scan", "tables", "pack", "launch", "sync", "assemble",
            "crash", "fallback", "localize"} <= set(stats)
    assert stats["launches"] == 1


@pytest.mark.parametrize("name", [n for n, _, _ in batch_b()])
def test_mixed_depths_match_reference(many_b, name):
    _, ref, got = many_b[0][name]
    assert pick(got) == pick(ref)


def test_mixed_depths_route_to_the_deep_grid(many_b):
    by = {n: got for n, (_, _, got) in many_b[0].items()}
    for R in (7, 8, 9, 10):
        assert by[f"r{R}"]["engine"] == "wgl_deep"
        assert by[f"r{R}"]["max_open"] == R
        assert by[f"r{R}"]["dispatch"]["R"] == 10
        assert by[f"r{R}"]["dispatch"]["why"] == wgl_seg.WHY_KEYS_DEEP
    for R in (2, 3, 5):
        assert by[f"shallow-{R}"]["engine"] == "wgl_seg_batch_regs"
        assert by[f"shallow-{R}"]["dispatch"]["R"] == 5
    assert by["r8-planted"]["valid?"] is False
    assert by["r8-crash-twin"]["engine"] == "wgl_deep"
    assert by["r8-crash-twin"]["crashed_ignored"] > 0
    assert "deep" in many_b[1]


def test_max_states_too_small_makes_every_lane_key_unsupported():
    # the lanes' state space outgrows max_states: every lane key (the
    # crash key's twin with them) goes to the fallback, the serial
    # frontier engine, as in the reference
    keys = batch_a()[:5] + [("crash", key_dicts(301, n_calls=50, conc=5,
                                                crash_rate=0.1), False),
                            ("empty", [], False)]
    ref_h, port_h = both(keys)
    ref = ref_seg.check_many(ref_models.CASRegister(), ref_h, max_states=3)
    got = wgl_seg.check_many(models.CASRegister(), port_h, max_states=3,
                             device="cpu")
    for i, r in enumerate(got[:-1]):
        assert r["engine"] == ref[i]["engine"] == "fallback", i
        assert pick(r) == pick(ref[i]), i
        assert r["final_frontier"] == ref[i]["final_frontier"], i
        assert r["dispatch"]["why"] == wgl_seg.WHY_FALLBACK
    assert got[-1]["valid?"] is True


def test_double_invoke_raises_value_error():
    dicts = indexed([op(0, "invoke", "write", 1), op(0, "invoke", "write", 2),
                     op(0, "ok", "write", 2)])
    ref_h, port_h = both([("double", dicts, False)])
    with pytest.raises(ValueError):
        ref_seg.check_many(ref_models.CASRegister(), ref_h)
    with pytest.raises(ValueError) as e:
        wgl_seg.check_many(models.CASRegister(), port_h, device="cpu")
    assert type(e.value) is ValueError
    assert "double-invoked" in str(e.value)


def test_refused_parameters_and_models():
    h = [convert.history_from_dicts(key_dicts(1))]
    for kw, item in ((dict(mesh=object()), "ROADMAP P8"),
                     (dict(mesh_axis="keys"), "ROADMAP P8")):
        with pytest.raises(Unsupported, match=item):
            wgl_seg.check_many(models.CASRegister(), h, device="cpu", **kw)
    with pytest.raises(Unsupported, match="no device spec"):
        wgl_seg.check_many(models.Model(), h, device="cpu")


def test_prepared_history_is_unsupported():
    # a PreparedHistory key is beyond the key lanes: the fallback (the
    # serial frontier engine) decides it, as in the reference
    h = convert.history_from_dicts(key_dicts(2))
    got = wgl_seg.check_many(models.CASRegister(), [h, prepare(h)],
                             device="cpu")
    assert got[0]["valid?"] is True
    assert got[1]["valid?"] is True and got[1]["engine"] == "fallback"
    assert got[1]["op_count"] == got[0]["op_count"]


def test_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for the default device")

    monkeypatch.setattr(regs_kernel, "scan_plain", no_plain)
    h = [convert.history_from_dicts(key_dicts(3))]
    with pytest.raises(BackendUnavailable):
        wgl_seg.check_many(models.CASRegister(), h)


def test_shuffled_keys_stay_paired():
    keys = batch_a()
    _, port_h = both(keys)
    base = wgl_seg.check_many(models.CASRegister(), port_h, device="cpu")
    order = np.random.default_rng(7).permutation(len(keys))
    _, port_h = both([keys[j] for j in order])
    got = wgl_seg.check_many(models.CASRegister(), port_h, device="cpu")
    for k, j in enumerate(order):
        assert pick(got[k]) == pick(base[j]), keys[j][0]
        assert got[k].get("engine") == base[j].get("engine")


def test_key_launch_is_one_and_exact(monkeypatch):
    """Every lane key in one key launch, at rounds = R (the deepest lane
    key's), on the inputs `wgl_seg.key_launch_inputs` builds; the
    segment kernel's wrapper is not called."""
    keys = batch_a()[:10]
    _, port_h = both(keys)
    calls = []
    scan = regs_kernel.keys_scan

    def spy(*a, **kw):
        calls.append((a, kw))
        return scan(*a, **kw)

    def no_regs_scan(*a, **kw):
        raise AssertionError("the key launch called regs_scan")

    monkeypatch.setattr(regs_kernel, "keys_scan", spy)
    monkeypatch.setattr(regs_kernel, "regs_scan", no_regs_scan)
    st = {}
    got = wgl_seg.check_many(models.CASRegister(), port_h, device="cpu",
                             stats=st)
    assert st["launches"] == 1 and len(calls) == 1
    (args, kw), = calls
    R = max(r["dispatch"]["R"] for r in got)
    assert kw["R"] == R
    wire, want, _ = key_launch_inputs(both(keys)[1])
    assert all(np.array_equal(t.numpy(), w) for t, w in zip(args, wire))
    assert kw == want


def order_keys(seed):
    """Keys of 1 to about 2,000 rows in shuffled order, a third of them
    with wrong reads."""
    rng = np.random.default_rng(seed)
    calls = [1, 1, 2, 5, 20, 60, 150, 400, 1800]
    rng.shuffle(calls)
    return [(f"n{n}-{k}", key_dicts(700 + 10 * seed + k, n_calls=n, conc=4,
                                    buggy=0.2 if k % 3 == 0 else 0.0),
             k % 2 == 0) for k, n in enumerate(calls)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_launch_orders_longest_first(seed):
    """The launch holds the keys longest first (ties in key order), and
    its order maps every launch position back to its key: the wire at
    each position is that key's, and check_many's verdicts come back
    paired with their keys (each the CPU oracle's on the key alone)."""
    keys = order_keys(seed)
    _, port_h = both(keys)
    got = wgl_seg.check_many(models.CASRegister(), port_h, device="cpu",
                             localize=False)
    # the lane keys (a key of one failed cas is decided on the host)
    lanes = [i for i, r in enumerate(got)
             if r["engine"] == "wgl_seg_batch_regs"]
    assert len(lanes) >= len(keys) - 2
    launch = wgl_seg.key_launch_inputs(models.CASRegister(), port_h)
    n = len(lanes)
    assert sorted(launch.order.tolist()) == list(range(n))
    assert (np.diff(launch.nrows) <= 0).all()
    assert launch.nrows.min() <= 5 and launch.nrows.max() >= 1900
    for p in range(n - 1):
        if launch.nrows[p] == launch.nrows[p + 1]:
            assert launch.order[p] < launch.order[p + 1]
    for p, j in enumerate(launch.order):
        k = lanes[j]
        alone = wgl_seg.key_launch_inputs(models.CASRegister(), [port_h[k]])
        o, L = int(launch.offs[p]), int(launch.nrows[p])
        assert L == int(alone.nrows[0])
        # the returns and slots (the uop ids are each alphabet's own)
        assert np.array_equal(launch.cbuf[o:o + 3 * L], alone.cbuf[:3 * L]), \
            keys[k][0]
    for (name, _, _), h, r in zip(keys, port_h, got):
        assert r["valid?"] == wgl_cpu.check(models.CASRegister(),
                                            h)["valid?"], name


@pytest.mark.parametrize("vmax,n_calls,max_states",
                         [(40, 200, 64), (20, 100, 16)])
def test_a_wide_deep_key_leaves_the_lanes_alone(vmax, n_calls, max_states):
    """A deep key's values do not grow the lanes' alphabet: with them
    the lanes' states would pass the segment kernel's 32 (38 states at
    vmax 40) or max_states (20 states at vmax 20), yet the R <= 6 keys stay on the key launch
    with the verdicts they have without the deep key."""
    lanes = [n for n in batch_b() if n[0].startswith("shallow-")]
    wide = ("wide", key_dicts(560, n_calls=n_calls, conc=10, vmax=vmax,
                              max_open=8, burst=8), False)
    _, port_h = both(lanes + [wide])
    got = wgl_seg.check_many(models.CASRegister(), port_h,
                             max_states=max_states, device="cpu")
    ref, alone, _ = run_both(lanes, max_states=max_states)
    for k, (name, _, _) in enumerate(lanes):
        assert got[k]["engine"] == "wgl_seg_batch_regs", name
        assert pick(got[k]) == pick(alone[k]) == pick(ref[k]), name
    deep = got[-1]
    # on the deep grid, or a straggler of it: past the deep kernel's 32
    # states the candidate-table route of check() decides it, past
    # max_states the serial frontier engine
    assert deep["engine"] in ("wgl_deep", "wgl_seg", "wgl")
    if deep["engine"] == "wgl_seg":
        assert deep["dispatch"]["kernel"] == "wgl_cand_dense"
    if deep["engine"] == "wgl":
        assert "ROADMAP P5" in deep["dispatch"]["why"]
    oracle = wgl_cpu.check(models.CASRegister(), port_h[-1])
    assert deep["valid?"] == oracle["valid?"]


# ---------------------------------------------------------------------------
# The key launch's function against the reference's kernel
# ---------------------------------------------------------------------------

def lane_inputs(keys):
    """Both packages' key launch inputs over the same keys: the
    reference's compact I = 1 wire and tables, and the port's wire as
    check_many builds it."""
    ref_h, port_h = both(keys)
    model = ref_models.CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fks = [ref_planner._fast_scan(h, spec, seen, rows, 10) for h in ref_h]
    R = max(fk.max_open for fk in fks)
    uops = np.asarray(rows, np.int32).reshape(-1, 4)
    states, legal, nxt = ref_planner._enumerate_states(
        spec, np.asarray(spec.encode(model), np.int32), uops, 64)
    dec = ref_planner._decompose(legal, nxt)
    a1t, a2t, t0t = ref_planner._pack_uop_tables(legal, nxt, *dec)
    Kp = 128
    # the lane keys (a key of failed calls alone is decided on the host)
    batch = [(i, fk) for i, fk in enumerate(fks) if fk.n_calls]
    ret_t, islot_t, iuop_t, Lp = ref_planner._pack_regs(batch, Kp, R,
                                                       len(rows), 1)
    buf8, Rp = ref_planner._compact_many_block(ret_t, islot_t, iuop_t, Kp,
                                               len(rows))
    buf32 = np.concatenate([a1t, a2t, t0t.view(np.uint32)])
    Sn = states.shape[0]
    kern = ref_seg._build_kernel_regs_many_c(
        Kp, Lp, max(1, (1 << R) // 32), Sn, R, True, R, 1, len(rows), Rp)
    ref_T = np.asarray(kern(buf8, buf32))[:len(batch)] > 0.5

    wire, kw, order = key_launch_inputs(port_h)
    assert (kw["R"], kw["Sn"]) == (R, Sn)
    return ref_T[order], wire, kw


def test_key_launch_plain_matches_reference_kernel():
    ref_T, wire, kw = lane_inputs(lane_keys())
    T, bad = regs_kernel.keys_scan(*(torch.from_numpy(x) for x in wire),
                                   **kw)
    assert int(bad[0]) == 0 and kw["R"] == 6
    assert T.shape == (len(ref_T), 1, kw["Sn"])
    assert np.array_equal(T.numpy()[:, 0, :] > 0, ref_T[:, 0, :])
    alive = T[:, 0, :].any(-1).numpy()
    assert not alive.all() and alive.any()


@pytest.mark.parametrize("snp", [8, 16, 32])
@pytest.mark.parametrize("R", range(1, 7))
def test_keys_scan_matches_reference_kernel(R, snp):
    """keys_scan on the CPU equals the reference's key kernel at every
    depth and state bucket, on check_many's own inputs."""
    ref_T, wire, kw = lane_inputs(warp_keys(R, snp, seed=800 + 40 * R + snp,
                                            calls=(60, 2, 25, 3, 40, 12)))
    assert kw["R"] == R and regs_kernel.snp(kw["Sn"]) == snp
    work = torch.zeros(len(wire[1]), dtype=torch.int64)
    T, bad = regs_kernel.keys_scan(*(torch.from_numpy(x) for x in wire),
                                   work=work, **kw)
    assert int(bad[0]) == 0
    assert np.array_equal(T.numpy()[:, 0, :] > 0, ref_T[:, 0, :])
    assert (work > 0).all()


@pytest.mark.parametrize("R", range(1, 7))
def test_need_counts_no_round_past_the_open_slots(R):
    """scan_plain's `need` is its work= count without the rounds past a
    row's open-slot count: never more, the same at R = 1 (one round at
    most), less where a key's rows ran that extra round, and the same
    transfer rows whether it is asked for or not."""
    wire, kw, _ = key_launch_inputs(port_histories(warp_keys(R, 8)))
    args = [torch.from_numpy(x) for x in wire]
    work, need = (torch.zeros(len(wire[1]), dtype=torch.int64)
                  for _ in range(2))
    T = regs_kernel.scan_plain(*args, J=1, rounds=kw["R"], work=work,
                               need=need, **kw)
    T0, _ = regs_kernel.keys_scan(*args, **kw)
    assert torch.equal(T, T0)
    assert (need > 0).all() and (need <= work).all()
    if R == 1:
        assert torch.equal(need, work)
    else:
        assert (need < work).any()


@pytest.mark.parametrize("shape", [dict(R=0), dict(R=7), dict(Sn=0),
                                   dict(Sn=33), dict(UP=0)])
def test_keys_scan_refuses_shapes(shape):
    """keys_scan takes R 1..6, Sn 1..32 and UP >= 1, and raises before
    it launches or runs anything else."""
    wire, kw, _ = key_launch_inputs(port_histories(lane_keys()[:3]))
    args = [torch.from_numpy(x) for x in wire]
    kw = dict(kw, **shape)
    if "UP" in shape:
        args[3] = args[3][:0]
    with pytest.raises(ValueError):
        regs_kernel.keys_scan(*args, **kw)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2 ** 20), st.integers(0, 40),
                          st.integers(1, 6), st.sampled_from([0.0, 0.3]),
                          st.sampled_from([0.0, 0.15]), st.booleans()),
                min_size=1, max_size=6))
def test_many_matches_cpu_oracle(specs):
    """Small random batches: every key's verdict and witness equal the
    CPU oracle's on that key alone."""
    keys = [(str(j), key_dicts(seed, n_calls=n, conc=conc, buggy=buggy,
                               crash_rate=crash), cols)
            for j, (seed, n, conc, buggy, crash, cols) in enumerate(specs)]
    _, port_h = both(keys)
    got = wgl_seg.check_many(models.CASRegister(), port_h, device="cpu")
    for h, r in zip(port_h, got):
        want = wgl_cpu.check(models.CASRegister(), h)
        assert r["valid?"] == want["valid?"]
        if want["valid?"] is False and "crashed" not in r:
            assert r["op_index"] == want["op_index"]
