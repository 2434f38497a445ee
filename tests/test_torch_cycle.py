"""The port's cycle analysis (`jepsen_tpu_torch.ops.cycle`: the closure
on `elle_kernel.square`'s plain version, the labels on `cycle_labels`'
plain version) and the txn cycle checker (`checker.cycle`) against the
JAX package's `ops/cycle.py` and `checker/cycle.py` on the CPU, exactly:
every case of tests/test_cycle.py, a host Tarjan oracle, seeded random
graphs past one 128-tile, the bench's 2048-node graph, the empty graph,
and seeded random rw-register histories (chip_smoke.py's simulated
serializable store with its planted blocks, and failed, crashed and
non-txn ops).  The packing and the rounds to the fixpoint are held
against the reference's layout and its fixed step count."""

import math
import random

import numpy as np
import pytest
import torch
from chip_smoke import (CYCLE_EXPECT, CYCLE_PLANTS, CYCLE_RING,
                        bench_graph, rw_register_history)
from test_cycle import labels_to_comps, tarjan_scc

from jepsen_tpu.checker import cycle as ref_txn_cycle
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import invoke_op as ref_invoke
from jepsen_tpu.history import ok_op as ref_ok
from jepsen_tpu.ops import cycle as ref_cyc
from jepsen_tpu_torch import convert
from jepsen_tpu_torch.checker import cycle as txn_cycle
from jepsen_tpu_torch.errors import BackendUnavailable
from jepsen_tpu_torch.ops import cycle, elle_kernel, elle_mesh


def equal_scc(adj):
    got = cycle.scc(adj, device="cpu")
    want = ref_cyc.scc(adj)
    assert got[0].dtype == np.int64 and got[1].dtype == bool
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    return got


def random_graph(n, deg, seed):
    return np.random.default_rng(seed).random((n, n)) < deg / max(n, 1)


# ---------------------------------------------------------------------------
# ops/cycle.py: tests/test_cycle.py::TestKernels, each against the
# reference
# ---------------------------------------------------------------------------

def line_graph():
    adj = np.zeros((4, 4), bool)
    adj[0, 1] = adj[1, 2] = adj[2, 3] = True
    return adj


def triangle():
    adj = np.zeros((3, 3), bool)
    adj[0, 1] = adj[1, 2] = adj[2, 0] = True
    return adj


def dag(seed=5, n=60):
    rng = random.Random(seed)
    adj = np.zeros((n, n), bool)
    for _ in range(300):
        i, j = sorted(rng.sample(range(n), 2))
        adj[i, j] = True
    return adj


def tarjan_graph(seed):
    rng = random.Random(seed)
    adj = np.zeros((50, 50), bool)
    for _ in range(120):
        i, j = rng.randrange(50), rng.randrange(50)
        if i != j:
            adj[i, j] = True
    return adj


def components():
    adj = np.zeros((7, 7), bool)
    adj[0, 1] = adj[1, 0] = True
    adj[2, 3] = adj[3, 4] = adj[4, 2] = True
    adj[5, 6] = True
    return adj


def back_edge():
    adj = np.zeros((4, 4), bool)
    adj[0, 1] = adj[1, 2] = adj[2, 3] = adj[3, 0] = adj[2, 1] = True
    return adj


def self_loop():
    adj = np.zeros((3, 3), bool)
    adj[1, 1] = True
    return adj


GRAPHS = {"line": line_graph(), "triangle": triangle(), "dag": dag(),
          "tarjan-1": tarjan_graph(1), "tarjan-2": tarjan_graph(2),
          "tarjan-3": tarjan_graph(3), "components": components(),
          "back-edge": back_edge(), "self-loop": self_loop(),
          "one": np.ones((1, 1), bool), "lone": np.zeros((1, 1), bool)}
for _n, _deg in ((127, 1.0), (128, 2.0), (129, 1.5), (130, 3.0),
                 (300, 1.0), (300, 2.5), (700, 1.2)):
    GRAPHS[f"random-{_n}-{_deg:g}"] = random_graph(_n, _deg, _n * 10 + 1)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_functions_match_reference(name):
    adj = GRAPHS[name]
    lab, on_cycle, closure = equal_scc(adj)
    assert labels_to_comps(lab) == tarjan_scc(adj)
    assert np.array_equal(cycle.transitive_closure(adj, device="cpu"),
                          ref_cyc.transitive_closure(adj))
    assert cycle.find_cycle(adj, device="cpu") == ref_cyc.find_cycle(adj)
    assert cycle.cycles_by_component(adj, device="cpu") == \
        ref_cyc.cycles_by_component(adj)
    src = np.random.default_rng(len(adj)).random(len(adj)) < 0.1
    assert np.array_equal(cycle.reachability_from(adj, src, device="cpu"),
                          ref_cyc.reachability_from(adj, src))


def test_closure_line():
    r = cycle.transitive_closure(line_graph(), device="cpu")
    assert r[0, 3] and r[0, 1] and r[1, 3]
    assert not r[3, 0] and not np.diagonal(r).any()


def test_cycle_detected():
    _, on_cycle, _ = equal_scc(triangle())
    assert on_cycle.all()
    path = cycle.find_cycle(triangle(), device="cpu")
    assert path[0] == path[-1] and len(path) == 4


def test_dag_no_cycle():
    _, on_cycle, _ = equal_scc(dag())
    assert not on_cycle.any()
    assert cycle.find_cycle(dag(), device="cpu") is None
    assert cycle.cycles_by_component(dag(), device="cpu") == []


def test_cycles_by_component_covers_each_scc():
    found = cycle.cycles_by_component(components(), device="cpu")
    heads = {frozenset(p[:-1]) for p in found}
    assert heads == {frozenset({0, 1}), frozenset({2, 3, 4})}


def test_find_cycle_with_interior_back_edge():
    path = cycle.find_cycle(back_edge(), device="cpu")
    assert path[0] == path[-1] == 0
    assert all(back_edge()[a, b] for a, b in zip(path, path[1:]))


def test_find_cycle_self_loop():
    assert cycle.find_cycle(self_loop(), device="cpu") == [1, 1]


def test_find_cycle_with_a_given_closure():
    adj = components()
    clo = ref_cyc.transitive_closure(adj)
    assert cycle.find_cycle(adj, clo) == ref_cyc.find_cycle(adj, clo)


def test_reachability_from():
    adj = np.zeros((5, 5), bool)
    adj[0, 1] = adj[1, 2] = adj[3, 4] = True
    src = np.zeros(5, bool)
    src[0] = True
    assert list(cycle.reachability_from(adj, src, device="cpu")) == \
        [True, True, True, False, False]


def test_empty_graph():
    adj = np.zeros((0, 0), bool)
    equal_scc(adj)
    assert cycle.transitive_closure(adj, device="cpu").shape == (0, 0)
    assert cycle.find_cycle(adj, device="cpu") is None
    assert cycle.cycles_by_component(adj, device="cpu") == []


def test_bench_graph():
    adj = bench_graph()
    lab, on_cycle, _ = equal_scc(adj)
    assert on_cycle[:CYCLE_RING].all()
    assert len(set(lab[:CYCLE_RING].tolist())) == 1


# ---------------------------------------------------------------------------
# The packed layout and the rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 33, 128, 129, 300])
def test_pack_is_the_port_word_order(n):
    adj = random_graph(n, 3.0, n)
    words = elle_mesh.pack_planes(adj[None])[0]
    assert words.dtype == np.uint32 and words.shape[0] % 128 == 0
    rows, cols = np.nonzero(adj)
    want = np.zeros_like(words)
    np.bitwise_or.at(want, (rows, cols >> 5),
                     np.uint32(1) << (cols & 31).astype(np.uint32))
    assert np.array_equal(words, want)
    assert np.array_equal(elle_mesh.unpack_bits(words[:n], n), adj)
    assert np.array_equal(
        elle_mesh.unpack_bits(words[:n].view(np.int32), n), adj)


@pytest.mark.parametrize("n,steps_extra", [(200, 0), (1000, 0)])
def test_rounds_reach_the_reference_closure_by_the_fixpoint(n, steps_extra):
    # a ring's closure needs ceil(log2(n)) + 1 rounds (the last changes
    # nothing); the reference always runs ceil(log2(n_pad - 1)) squarings
    adj = np.zeros((n, n), bool)
    adj[np.arange(n), (np.arange(n) + 1) % n] = True
    r, t, rounds = cycle.closure_planes(adj, torch.device("cpu"))
    assert rounds == math.ceil(math.log2(n)) + 1
    n_pad = r.shape[0]
    assert rounds - 1 <= max(1, math.ceil(math.log2(n_pad - 1)))
    assert np.array_equal(elle_mesh.unpack_bits(r[:n].numpy(), n),
                          ref_cyc.transitive_closure(adj))
    assert torch.equal(t, elle_kernel.tpose_plain(r))


def test_square_with_one_plane_as_every_operand():
    adj = random_graph(256, 2.0, 7)
    r = torch.from_numpy(elle_mesh.pack_planes(adj[None])[0].view(np.int32))
    out, changed, t = elle_kernel.square(r)
    assert torch.equal(out, elle_kernel.product(r, r, r))
    assert bool(changed) == bool((out != r).any())
    assert torch.equal(t, elle_kernel.tpose_plain(r))


def test_labels_plain_is_the_reference_rule():
    adj = random_graph(300, 2.0, 3)
    r, t, _ = cycle.closure_planes(adj, torch.device("cpu"))
    before = cycle.LAUNCHES["cycle_labels"]
    out = cycle.labels(r, t)
    assert cycle.LAUNCHES["cycle_labels"] == before
    lab, diag, _ = ref_cyc.scc(adj)
    assert out.dtype == torch.int32 and out.shape == (2, r.shape[0])
    assert np.array_equal(out[0, :300].numpy(), lab)
    assert np.array_equal(out[1, :300].numpy().astype(bool), diag)
    assert out[0, 300:].tolist() == list(range(300, r.shape[0]))


def test_no_device_without_asking_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(BackendUnavailable):
        cycle.scc(triangle())
    with pytest.raises(BackendUnavailable):
        txn_cycle.TxnCycleChecker().check(None, convert.history_from_dicts(
            txn_dicts([(0, [["w", "x", 1]])])))


# ---------------------------------------------------------------------------
# checker/cycle.py: tests/test_cycle.py::TestTxnCycleChecker, each against
# the reference
# ---------------------------------------------------------------------------

def txn_dicts(txns):
    """[(process, [mops])] -> op dicts, one ok txn each."""
    ops = []
    for p, t in txns:
        ops += [ref_invoke(p, "txn", t), ref_ok(p, "txn", t)]
    return RefHistory(ops).index().to_dicts()


def both(dicts, **kw):
    got = txn_cycle.checker(device="cpu", **kw).check(
        {}, convert.history_from_dicts(dicts), {})
    want = ref_txn_cycle.checker(**kw).check(
        {}, RefHistory([dict(d) for d in dicts]), {})
    assert got == want
    return got


TXN_CASES = {
    "serial": [(0, [["w", "x", 1]]), (1, [["r", "x", 1], ["w", "y", 1]]),
               (0, [["r", "y", 1], ["w", "x", 2]]), (1, [["r", "x", 2]])],
    "g1c": [(0, [["w", "x", 1], ["r", "y", 1]]),
            (1, [["w", "y", 1], ["r", "x", 1]])],
    "g2": [(0, [["r", "y", None], ["w", "x", 1]]),
           (1, [["r", "x", None], ["w", "y", 1]])],
    "g-single": [(0, [["w", "x", 1], ["w", "y", 1]]),
                 (1, [["r", "x", None], ["r", "y", 1]])],
    "g1a": [(0, [["w", "x", 1]]), (1, [["r", "x", 99]])],
    "g1b": [(0, [["w", "x", 1], ["w", "x", 2]]), (1, [["r", "x", 1]])],
    "ryow": [(0, [["w", "x", 1], ["r", "x", 1], ["w", "x", 2]])],
    "lost-update": [(0, [["r", "x", None], ["w", "x", 1]]),
                    (1, [["r", "x", None], ["w", "x", 2]])],
}


@pytest.mark.parametrize("name", sorted(TXN_CASES))
@pytest.mark.parametrize("anomalies", [None, ["G2"]])
def test_txn_cases(name, anomalies):
    both(txn_dicts(TXN_CASES[name]), anomalies=anomalies)


def test_g0_write_cycle_is_valid():
    ops = [ref_invoke(0, "txn", [["w", "x", 1], ["w", "y", 1]]),
           ref_invoke(1, "txn", [["w", "x", 2], ["w", "y", 2]])]
    ops += [ref_ok(0, "txn", ops[0].value), ref_ok(1, "txn", ops[1].value)]
    assert both(RefHistory(ops).index().to_dicts())["valid?"] is True


def test_realtime_strict_serializability():
    ops = [ref_invoke(0, "txn", [["w", "x", 1]]),
           ref_ok(0, "txn", [["w", "x", 1]]),
           ref_invoke(1, "txn", [["r", "x", None]]),
           ref_ok(1, "txn", [["r", "x", None]])]
    dicts = RefHistory(ops).index().to_dicts()
    assert both(dicts)["valid?"] is True
    r = both(dicts, realtime=True)
    assert r["valid?"] is False and r["cycle-count"] == 1


def test_non_txn_values_skipped():
    ops = [ref_invoke(0, "read", [1, 2, 3]), ref_ok(0, "read", [1, 2, 3]),
           ref_invoke(1, "txn", [["w", "x", 1]]),
           ref_ok(1, "txn", [["w", "x", 1]])]
    r = both(RefHistory(ops).index().to_dicts())
    assert r["valid?"] is True and r["txn-count"] == 1


def test_empty_history():
    assert both([])["txn-count"] == 0


@pytest.mark.parametrize("plant", (None,) + CYCLE_PLANTS)
@pytest.mark.parametrize("n", [150, 400])
def test_simulated_store_histories(plant, n):
    got = both(rw_register_history(n, 77 + n, plant))
    assert got["anomaly-types"] == CYCLE_EXPECT[plant]


def chaos_rw_register(seed, n_txns=150, conc=5, keys=4):
    """A store that commits at completion, with failed and crashed txns,
    reads that see a stale or an unwritten value, intermediate reads, and
    interleaved non-txn ops: every anomaly type can arise."""
    rng = random.Random(seed)
    state, nxt, ops, inflight = {}, {k: 0 for k in range(keys)}, [], {}

    def emit(p, typ, f, v):
        ops.append({"index": len(ops), "process": p, "type": typ, "f": f,
                    "value": v, "time": len(ops)})

    started = 0
    while started < n_txns or inflight:
        p = rng.randrange(conc)
        if p in inflight:
            txn = inflight.pop(p)
            typ = rng.choice(["ok"] * 8 + ["fail", "info"])
            out = []
            for f, k, v in txn:
                if f == "r":
                    seen = state.get(k)
                    r = rng.random()
                    if r < 0.08 and nxt[k]:
                        seen = rng.randrange(1, nxt[k] + 2)
                    out.append(["r", k, seen])
                else:
                    out.append(["w", k, v])
                    if typ == "ok":
                        state[k] = v
            emit(p, typ, "txn", out)
        elif started < n_txns:
            txn = []
            for _ in range(rng.randint(1, 4)):
                k = rng.randrange(keys)
                if rng.random() < 0.5:
                    txn.append(["r", k, None])
                else:
                    nxt[k] += 1
                    txn.append(["w", k, nxt[k]])
            inflight[p] = txn
            emit(p, "invoke", "txn", [list(m) for m in txn])
            started += 1
            if rng.random() < 0.05:
                emit(conc + 1, "invoke", "read", None)
                emit(conc + 1, "ok", "read", [1, 2])
    return ops


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("realtime", [False, True])
def test_chaos_histories(seed, realtime):
    both(chaos_rw_register(seed), realtime=realtime)


def test_chaos_past_one_tile():
    r = both(chaos_rw_register(99, n_txns=400, conc=8, keys=6))
    assert r["txn-count"] > 128
