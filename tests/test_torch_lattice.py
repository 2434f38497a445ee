"""The port's full lattice (jepsen_tpu_torch.lattice: planes, engine,
checker, adapters; ops.lattice_kernel's plain versions; the workloads'
checkers; planner.plan_lattice) against the reference on the CPU,
exactly: the same op dicts and numpy stacks go to both packages, and
classes, defining edges, weakest-violated, not, witnesses, rounds,
oracle-agrees and every verdict field but the dispatch record must be
equal.  Cases are those of tests/test_lattice.py (the twelve planted
classes on every tier, G1-predicate's direct flag, the clean and the
nil-first histories, the three-tier differential over random stacks,
witnesses for every flag, the adapter parity batteries), the packed
round and masks against the reference's packed pieces, and
chip_smoke.py's [lattice] histories at 200 txns with every plant."""

import random

import numpy as np
import pytest
import test_lattice as ref_cases
import torch
from chip_smoke import LATTICE_PLANTS, lattice_history

from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.lattice import adapters as ref_adapters
from jepsen_tpu.lattice import checker as ref_checker
from jepsen_tpu.lattice import engine as ref_engine
from jepsen_tpu.lattice import planes as ref_planes
from jepsen_tpu.ops import elle_mesh as ref_mesh
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu.workloads import causal as ref_causal
from jepsen_tpu.workloads import long_fork as ref_long_fork
from jepsen_tpu.workloads import monotonic as ref_monotonic
from jepsen_tpu_torch import convert
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.lattice import LATTICE_CLASSES
from jepsen_tpu_torch.lattice import adapters, checker, engine, planes
from jepsen_tpu_torch.ops import elle_mesh, lattice_kernel
from jepsen_tpu_torch.ops import planner
from jepsen_tpu_torch.workloads import causal, long_fork, monotonic

#: Verdict fields that are the dispatch record (timings, routing).
DISPATCH = ("dispatch", "stages")
ALGORITHMS = ("host", "device", "mesh")
CPU = torch.device("cpu")


@pytest.fixture
def one_device_reference(monkeypatch):
    """The reference's packed tier on one of the test mesh's devices, as
    the port runs it (shards 1)."""
    devices = ref_mesh._devices
    monkeypatch.setattr(ref_mesh, "_devices",
                        lambda devices_=None, max_devices=None:
                        devices(devices_, 1))


def dicts_of(ref_history):
    return [o.to_dict() for o in ref_history]


def both(dicts):
    return RefHistory(dicts), convert.history_from_dicts(dicts)


def strip(v):
    return {k: x for k, x in v.items() if k not in DISPATCH}


def classify_both(dicts, workload, algorithm):
    rh, ph = both(dicts)
    want = ref_checker.classify_history(rh, workload=workload,
                                        algorithm=algorithm)
    got = checker.classify_history(ph, workload=workload,
                                   algorithm=algorithm, device="cpu")
    return got, want


# ---------------------------------------------------------------------------
# Planted histories on every tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("cls,mk,workload,level", ref_cases.PLANTS,
                         ids=[p[0] for p in ref_cases.PLANTS])
def test_planted_class_matches_reference(one_device_reference, algorithm,
                                         cls, mk, workload, level):
    got, want = classify_both(dicts_of(mk()), workload, algorithm)
    assert strip(got) == strip(want)
    assert got["anomaly-types"] == [cls]
    assert got["weakest-violated"] == level
    assert got["engine"] == f"lattice-{algorithm}"
    assert got["dispatch"]["engine"] == want["engine"]
    steps = got["anomalies"][cls][0]["steps"]
    assert steps[0] == steps[-1] and len(steps) >= 2
    if algorithm == "mesh":
        assert got["shards"] == 1 and got["rounds"] == want["rounds"]


def g1_predicate_dicts():
    return [{"process": 0, "type": "invoke", "f": "txn",
             "value": [["w", "x", 5]]},
            {"process": 0, "type": "fail", "f": "txn",
             "value": [["w", "x", 5]]},
            {"process": 1, "type": "invoke", "f": "txn",
             "value": [["rp", ["keys", ["x"]], None]]},
            {"process": 1, "type": "ok", "f": "txn",
             "value": [["rp", ["keys", ["x"]], {"x": 5}]]}]


def txn_dicts(*triples):
    out = []
    for p, mops in triples:
        for typ in ("invoke", "ok"):
            out.append({"process": p, "type": typ, "f": "txn",
                        "value": [list(m) for m in mops]})
    return out


DIRECT_CASES = [
    ("g1-predicate", g1_predicate_dicts(), "rw-register"),
    ("clean", txn_dicts((0, [["append", "x", 1]]), (0, [["r", "x", [1]]]),
                        (1, [["r", "x", [1]], ["append", "x", 2]]),
                        (0, [["r", "x", [1, 2]]])), "list-append"),
    ("nil-first", txn_dicts((0, [["w", "x", 1]]), (1, [["r", "x", 1]]),
                            (2, [["r", "x", None]])), "rw-register"),
    ("empty", [], "list-append"),
]


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name,dicts,workload", DIRECT_CASES,
                         ids=[c[0] for c in DIRECT_CASES])
def test_direct_clean_and_nil_first_match_reference(
        one_device_reference, algorithm, name, dicts, workload):
    got, want = classify_both([dict(d, index=i) for i, d in
                               enumerate(dicts)], workload, algorithm)
    assert strip(got) == strip(want)
    if name == "g1-predicate":
        assert "G1-predicate" in got["anomaly-types"]
        assert got["weakest-violated"] == "read-committed"
    elif name == "nil-first":
        assert got["valid?"] is True and got["lattice"]["nil-first-rw"] >= 1
    else:
        assert got["valid?"] is True and got["anomaly-types"] == []


def test_planes_match_reference():
    for _, mk, workload, _ in ref_cases.PLANTS:
        rh, ph = both(dicts_of(mk()))
        rlp, _ = ref_planes.from_history(rh, workload=workload)
        plp, _ = planes.from_history(ph, workload=workload)
        assert plp.meta == rlp.meta
        assert np.array_equal(plp.stacked(), rlp.stacked())
        assert np.array_equal(plp.packed_stacked(), rlp.packed_stacked())
        assert np.array_equal(plp.packed_stacked(),
                              elle_mesh.pack_planes(plp.stacked()))


# ---------------------------------------------------------------------------
# The three tiers on random stacks
# ---------------------------------------------------------------------------

def random_stack(seed):
    rng = random.Random(seed)
    n = rng.choice([5, 9, 17, 33])
    return n, ref_cases.random_stack(rng, n)


@pytest.mark.parametrize("seed", range(10))
def test_three_tiers_match_reference(one_device_reference, seed):
    n, stack = random_stack(seed)
    want = ref_engine.classify_host(stack, n)
    ref_packed = ref_engine.classify_packed(
        ref_mesh.pack_planes(stack, n_dev=1), n)
    assert ref_packed["anomalies"] == want["anomalies"]
    host = engine.classify_host(stack, n)
    dev = engine.classify_device(stack, n, device="cpu")
    packed = engine.classify_packed(elle_mesh.pack_planes(stack), n,
                                    device="cpu")
    assert host == want
    assert dev == ref_engine.classify_device(stack, n)
    assert packed["anomalies"] == want["anomalies"]
    assert packed["rounds"] == ref_packed["rounds"]
    assert packed["n_pad"] == ref_packed["n_pad"]


@pytest.mark.parametrize("seed", range(6))
def test_witness_for_every_flag_matches_reference(seed):
    rng = random.Random(1000 + seed)
    n = rng.choice([6, 12, 20])
    stack = ref_cases.random_stack(rng, n)
    flags = engine.classify_host(stack, n)["anomalies"]
    for cls, edge in flags.items():
        cyc = engine.find_witness(stack, cls, edge)
        assert cyc is not None and cyc[0] == cyc[-1], (seed, cls)
        assert cyc == ref_engine.find_witness(stack, cls, edge)


@pytest.mark.parametrize("n,algorithm,threshold", [
    (0, "auto", 4096), (100, "auto", 4096), (4095, "auto", 4096),
    (4096, "auto", 4096), (50, "auto", 50), (10_000, "device", 4096),
    (10, "mesh", 4096), (10, "host", 4096)])
def test_plan_lattice_matches_reference(n, algorithm, threshold):
    got = planner.plan_lattice(n, algorithm=algorithm,
                               mesh_threshold=threshold)
    want = ref_planner.plan_lattice(n, algorithm=algorithm,
                                    mesh_threshold=threshold)
    assert got["engine"] == want.engine
    assert got["n_max"] == n and got["batch"] == 1


def test_plan_lattice_rejects_unknown_algorithm():
    with pytest.raises(ValueError):
        planner.plan_lattice(10, algorithm="fast")


def test_auto_picks_the_reference_tier(one_device_reference):
    dicts = dicts_of(ref_cases.h_g_single())
    for threshold in (2, 4096):
        rh, ph = both(dicts)
        want = ref_checker.classify_history(rh, workload="list-append",
                                            mesh_threshold=threshold)
        got = checker.classify_history(ph, workload="list-append",
                                       mesh_threshold=threshold,
                                       device="cpu")
        assert strip(got) == strip(want)
        assert got["engine"] == ("lattice-mesh" if threshold == 2
                                 else "lattice-device")


# ---------------------------------------------------------------------------
# The packed round and the masks against the reference's packed pieces
# ---------------------------------------------------------------------------

def ref_round(pk, n_pad):
    """One Jacobi round of the reference's packed tier
    (lattice/engine.py:314-334) over its product `pmm`, on one device:
    the seven uint32 planes."""
    import jax.numpy as jnp
    _, _, pmm = ref_mesh._device_fns(n_pad, ref_mesh._block_for(n_pad))
    cww, p0a, p1a, p0s, p1s, cpred, cm = (jnp.asarray(p) for p in pk)
    out = (cww | pmm(cww, cww), p0a | pmm(p0a, p0a),
           p1a | pmm(p0a | p1a, p1a) | pmm(p1a, p0a | p1a),
           p0s | pmm(p0s, p0s),
           p1s | pmm(p0s | p1s, p1s) | pmm(p1s, p0s | p1s),
           cpred | pmm(cpred, cpred), cm | pmm(cm, cm))
    return [np.asarray(x, np.uint32) for x in out]


def to_torch(words):
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                            .view(np.int32))


def to_words(t):
    return t.numpy().view(np.uint32)


def ref_tpose(words, n):
    dense = ref_mesh.unpack_bits(words, n)
    return ref_mesh.pack_bits(dense.T)


@pytest.mark.parametrize("seed", range(4))
def test_lattice_round_plain_matches_reference_round(seed):
    rng = np.random.default_rng(seed)
    n_pad = (128, 256)[seed % 2]
    dens = (0.003, 0.02, 0.1, 0.0)[seed]
    pk = [ref_mesh.pack_bits(rng.random((n_pad, n_pad)) < dens)
          for _ in range(7)]
    want = ref_round(pk, n_pad)
    got = lattice_kernel.lattice_round(*[to_torch(p) for p in pk])
    assert all(np.array_equal(to_words(g), w) for g, w in zip(got[:7], want))
    assert bool(got[7]) == any(not np.array_equal(a, b)
                               for a, b in zip(want, pk))
    assert all(np.array_equal(to_words(t), ref_tpose(p, n_pad))
               for t, p in zip(got[8], pk))


def ref_masks_edges(pl, tp, n_pad):
    """The reference's masks and picks (engine.py:352-367) on packed
    uint32 words, numpy: {class index: flat index}."""
    ww, wr, rw, so_ww, so_wr, so_rw, so_rr, prw = pl
    t_p0a, t_p1a, t_p0s, t_p1s, t_cww, t_cpred, t_lf = tp
    t_dep = t_p0a | t_p1a
    so = so_ww | so_wr | so_rw | so_rr
    m_mw = so_ww & t_dep
    m_wfr = so_rw & t_dep & ~m_mw
    m_ryw = so_wr & t_dep & ~m_mw & ~m_wfr
    m_mr = so_rr & t_dep & ~m_mw & ~m_wfr & ~m_ryw
    sess = m_mw | m_wfr | m_ryw | m_mr
    m_pram = so & t_p0s & ~sess
    m_causal = so & t_p1s & ~t_p0s & ~sess & ~m_pram
    m_lf = rw & t_lf & ~t_p0a
    masks = (m_mw, m_wfr, m_ryw, m_mr, m_pram, m_causal, m_lf,
             ww & t_cww, wr & t_p0a, rw & t_p0a,
             rw & t_p1a & ~t_p0a & ~m_lf, prw & t_cpred)
    out = []
    for m in masks:
        dense = ref_mesh.unpack_bits(m, n_pad)
        out.append(int(np.argmax(dense)) if dense.any() else -1)
    return out


@pytest.mark.parametrize("seed", range(5))
def test_masks_plain_matches_reference_masks(seed):
    rng = np.random.default_rng(100 + seed)
    n_pad = 128 * (1 + seed % 2)
    dens = (0.002, 0.01, 0.05, 0.3, 0.9)[seed]
    words = [ref_mesh.pack_bits(rng.random((n_pad, n_pad)) < dens)
             for _ in range(15)]
    got = lattice_kernel.masks([to_torch(w) for w in words[:8]],
                               [to_torch(w) for w in words[8:]])
    assert got.dtype == torch.int64 and got.shape == (12,)
    assert got.tolist() == ref_masks_edges(words[:8], words[8:], n_pad)


def test_masks_take_fifteen_planes():
    z = torch.zeros((128, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        lattice_kernel.masks([z] * 8, [z] * 6)


@pytest.mark.parametrize("seed", range(3))
def test_closures_match_reference_packed_tier(one_device_reference, seed):
    """The port's packed pieces (rounds of lattice_round, then lf, the
    transposes and masks_plain) against the reference's whole packed
    program on the same packed stack: edges and rounds."""
    n, stack = random_stack(50 + seed)
    pk = ref_mesh.pack_planes(stack, n_dev=1)
    want = ref_engine.classify_packed(pk, n)
    tposes, rounds = engine.closures(elle_mesh._to_device(pk, CPU))
    idx = lattice_kernel.masks(list(elle_mesh._to_device(pk, CPU)), tposes)
    n_pad = pk.shape[-2]
    got = {c: (i // n_pad, i % n_pad)
           for c, i in zip(LATTICE_CLASSES, idx.tolist()) if i >= 0}
    assert got == want["anomalies"] and rounds == want["rounds"]


# ---------------------------------------------------------------------------
# The checker's errors and options
# ---------------------------------------------------------------------------

def test_checker_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = convert.history_from_dicts(dicts_of(ref_cases.h_g1c()))
    with pytest.raises(BackendUnavailable):
        checker.LatticeChecker().check(None, h)
    with pytest.raises(BackendUnavailable):
        checker.LatticeChecker(algorithm="mesh").check(None, h)
    assert checker.LatticeChecker(algorithm="host").check(
        None, h)["anomaly-types"] == ["G1c"]


def test_more_than_one_device_is_p8():
    with pytest.raises(Unsupported, match="P8"):
        checker.LatticeChecker(devices=["cpu", "cpu"])
    v = checker.LatticeChecker(devices=["cpu"]).check(
        None, convert.history_from_dicts(dicts_of(ref_cases.h_g1c())))
    assert v["anomaly-types"] == ["G1c"] and v["dispatch"]["device"] == "cpu"


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError):
        checker.LatticeChecker(algorithm="fast")


@pytest.mark.parametrize("anomalies", [None, ["G0"], ["G1c", "PRAM"]])
def test_failing_anomaly_subset_matches_reference(anomalies):
    rh, ph = both(dicts_of(ref_cases.h_g1c()))
    want = ref_checker.LatticeChecker(workload="list-append",
                                      anomalies=anomalies,
                                      algorithm="device").check(None, rh)
    got = checker.LatticeChecker(workload="list-append",
                                 anomalies=anomalies, algorithm="device",
                                 device="cpu").check(None, ph)
    assert strip(got) == strip(want)


def test_dispatch_record_and_stages():
    ph = convert.history_from_dicts(dicts_of(ref_cases.h_pram()))
    v = checker.LatticeChecker(algorithm="mesh", device="cpu").check(None, ph)
    d = v["dispatch"]
    assert d["engine"] == "lattice-mesh" and d["device"] == "cpu"
    assert d["n_pad"] == 128 and d["shards"] == 1
    assert d["rounds"] == v["rounds"] and d["n_max"] == 4
    assert set(v["stages"]) >= {"infer_s", "planes_s", "pack_s",
                                "rounds_s", "masks_s", "witness_s"}


# ---------------------------------------------------------------------------
# The workload adapters against the reference's
# ---------------------------------------------------------------------------

def comparable(v):
    """A verdict without the dispatch record, its objects of one package
    or the other as plain data: the causal register model as its repr,
    an illegal history's op as its dict."""
    out = strip(v)
    if "model" in out:
        out["model"] = repr(out["model"])
    err = out.get("error")
    if isinstance(err, dict) and "op" in err:
        out["error"] = dict(err, op=err["op"].to_dict())
    if isinstance(out.get("oracle"), dict):
        out["oracle"] = comparable(out["oracle"])
    return out


def causal_dicts(seq):
    out = []
    for f, v in seq:
        out.append({"process": 0, "type": "invoke", "f": f,
                    "value": None if f != "write" else v})
        out.append({"process": 0, "type": "ok", "f": f, "value": v})
    return [dict(d, index=i) for i, d in enumerate(out)]


def causal_seq(seed):
    rng = random.Random(seed)
    seq = [("read-init", 0)]
    value = 0
    for nxt in (1, 2):
        seq.append(("write", nxt))
        value = nxt
        for _ in range(rng.randrange(0, 3)):
            corrupt = rng.random() < 0.3
            seq.append(("read", rng.randrange(0, value) if corrupt
                        and value else value))
    return seq


CAUSAL = [("clean", [("read-init", 0), ("write", 1), ("read", 1),
                     ("write", 2), ("read", 2)]),
          ("stale", [("read-init", 0), ("write", 1), ("read", 1),
                     ("write", 2), ("read", 1)])] + \
    [(f"random-{s}", causal_seq(s)) for s in range(8)]


@pytest.mark.parametrize("name,seq", CAUSAL, ids=[c[0] for c in CAUSAL])
def test_causal_adapter_matches_reference(name, seq):
    rh, ph = both(causal_dicts(seq))
    want = ref_causal.check().check({}, rh, {})
    got = causal.check(device="cpu").check({}, ph, {})
    assert comparable(got) == comparable(want)
    assert got["oracle-agrees"] is True
    assert comparable(causal.CausalChecker().check({}, ph)) == \
        comparable(ref_causal.CausalChecker().check({}, rh))


def long_fork_dicts(reads, writes=((0, 0), (1, 1))):
    out = []
    for p, k in writes:
        for typ in ("invoke", "ok"):
            out.append({"process": p, "type": typ, "f": "write",
                        "value": [["w", k, 1]]})
    for p, mops in reads:
        out.append({"process": p, "type": "invoke", "f": "read",
                    "value": [[m[0], m[1], None] for m in mops]})
        out.append({"process": p, "type": "ok", "f": "read",
                    "value": [list(m) for m in mops]})
    return [dict(d, index=i) for i, d in enumerate(out)]


LONG_FORK = [
    ("planted", long_fork_dicts([(2, [["r", 0, 1], ["r", 1, None]]),
                                 (3, [["r", 1, 1], ["r", 0, None]])])),
    ("clean", long_fork_dicts([(2, [["r", 0, 1], ["r", 1, None]]),
                               (3, [["r", 0, 1], ["r", 1, 1]])])),
    ("early", long_fork_dicts([(2, [["r", 0, None], ["r", 1, None]])])),
    ("ragged", long_fork_dicts([(2, [["r", 0, 1]]),
                                (3, [["r", 0, 1], ["r", 1, None]])])),
    ("multi-write", long_fork_dicts([(2, [["r", 0, 1], ["r", 1, None]])],
                                    writes=((0, 0), (1, 0)))),
]


@pytest.mark.parametrize("name,dicts", LONG_FORK,
                         ids=[c[0] for c in LONG_FORK])
def test_long_fork_adapter_matches_reference(name, dicts):
    rh, ph = both(dicts)
    want = ref_long_fork.checker(2).check({}, rh, {})
    got = long_fork.checker(2, device="cpu").check({}, ph, {})
    assert comparable(got) == comparable(want)
    if name == "planted":
        assert got["valid?"] is False and "long-fork" in got["anomaly-types"]
        assert got["weakest-violated"] == "parallel-snapshot-isolation"
        assert got["oracle-agrees"] is True


def test_long_fork_helpers_match_reference():
    rng = random.Random(7)
    for _ in range(20):
        m = rng.randrange(2, 14)
        dicts = [{"process": i, "type": "ok", "f": "read", "index": i,
                  "value": [["r", k, rng.choice([None, 1])]
                            for k in range(3)]} for i in range(m)]
        rh, ph = both(dicts)
        want = [[a.index, b.index]
                for a, b in ref_long_fork.find_forks(list(rh))]
        got = [[a.index, b.index] for a, b in long_fork.find_forks(list(ph))]
        assert got == want
    assert list(long_fork.group_for(3, 7)) == list(
        ref_long_fork.group_for(3, 7))


def mono_dicts(rows):
    return [{"process": 0, "type": "invoke", "f": "read", "value": None,
             "index": 0},
            {"process": 0, "type": "ok", "f": "read", "value": rows,
             "index": 1}]


MONO = [("inversion", mono_dicts([[1, 100, 0], [3, 150, 1], [2, 200, 0]])),
        ("clean", mono_dicts([[1, 100, 0], [2, 200, 1], [3, 300, 0]])),
        ("duplicate", mono_dicts([[1, 100, 0], [1, 200, 1], [3, 300, 0]])),
        ("gaps", mono_dicts([[1, 100, 0], [4, 200, 1], [9, 300, 0]])),
        ("no-read", [{"process": 0, "type": "invoke", "f": "add",
                      "value": None, "index": 0}])]


@pytest.mark.parametrize("name,dicts", MONO, ids=[c[0] for c in MONO])
def test_monotonic_adapter_matches_reference(name, dicts):
    rh, ph = both(dicts)
    want = ref_monotonic.checker().check({}, rh, {})
    got = monotonic.checker(device="cpu").check({}, ph, {})
    assert comparable(got) == comparable(want)


LOWERINGS = ([("monotonic", d) for _, d in MONO]
             + [("causal", causal_dicts(seq)) for _, seq in CAUSAL[:3]]
             + [("long-fork", d) for _, d in LONG_FORK])


@pytest.mark.parametrize("case", range(len(LOWERINGS)))
def test_lowerings_match_reference(case):
    kind, dicts = LOWERINGS[case]
    rh, ph = both(dicts)
    name = f"lower_{kind.replace('-', '_')}"
    assert getattr(adapters, name)(ph) == getattr(ref_adapters, name)(rh)


# ---------------------------------------------------------------------------
# chip_smoke.py's [lattice] histories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("plant", (None,) + LATTICE_PLANTS)
def test_smoke_histories_match_reference(one_device_reference, algorithm,
                                         plant):
    got, want = classify_both(lattice_history(200, plant), "auto", algorithm)
    assert strip(got) == strip(want)
    expect = {None: [], "G1a": ["G1a"]}.get(plant, [plant])
    assert got["anomaly-types"] == expect
