"""The port's Elle (jepsen_tpu_torch: txn, lattice, elle.infer,
ops.elle_graph, ops.elle_mesh with the elle_pmm kernel's plain version,
ops.planner.plan_elle, checker.elle) against the reference on the CPU,
exactly: the same op dicts go into both packages, and the planes,
edge types, direct anomalies, meta, flags, defining edges, rounds and
every verdict field but the dispatch record must be equal.  Histories
are the planted ones of tests/test_elle.py, seeded random list-append,
rw-register and predicate histories (`chaos_*` below, with failed and
indeterminate txns and corrupted reads), chip_smoke.py's simulated
serializable list-append store with its planted blocks, and the JAX
package's bench plane generator (`chip_smoke.elle_stack`)."""

import itertools
import math
import random
import re
from pathlib import Path

import numpy as np
import pytest
import test_elle as ref_cases
import torch
from chip_smoke import (ELLE_PLANTS, elle_expected, elle_mixed_cases,
                        elle_stack, keyed_list_append, list_append_history)

from jepsen_tpu import independent as ref_independent
from jepsen_tpu import lattice as ref_lattice
from jepsen_tpu import txn as ref_txn
from jepsen_tpu.checker import elle as ref_elle
from jepsen_tpu.elle import infer as ref_infer
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.ops import elle_graph as ref_graph
from jepsen_tpu.ops import elle_mesh as ref_mesh
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu_torch import convert, independent, lattice, txn
from jepsen_tpu_torch.checker import elle
from jepsen_tpu_torch.elle import infer
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.ops import elle_graph, elle_kernel, elle_mesh, planner

#: Verdict fields that are the dispatch record (timings, routing).
DISPATCH = ("dispatch", "stages")


def both(dicts):
    return RefHistory(dicts), convert.history_from_dicts(dicts)


def _ops(seq):
    return [dict(d, index=i, time=i) for i, d in enumerate(seq)]


def chaos_list_append(seed, n_txns=60, conc=4, keys=3):
    """Random list-append history: a store that commits at completion,
    with failed and indeterminate txns, and reads that sometimes see a
    corrupted list (a dropped or swapped element, an aborted append)."""
    rng = random.Random(seed)
    state: dict = {}
    nxt = {k: 0 for k in range(keys)}
    aborted: list = []
    inflight: dict = {}
    out: list = []
    started = 0
    while started < n_txns or inflight:
        p = rng.randrange(conc)
        if p not in inflight:
            if started >= n_txns:
                continue
            txn_ = []
            for _ in range(rng.randint(1, 4)):
                k = rng.randrange(keys)
                if rng.random() < 0.5:
                    txn_.append(["r", k, None])
                else:
                    nxt[k] += 1
                    txn_.append(["append", k, nxt[k]])
            inflight[p] = txn_
            out.append({"process": p, "type": "invoke", "f": "txn",
                        "value": [list(m) for m in txn_]})
            started += 1
            continue
        txn_ = inflight.pop(p)
        fate = rng.random()
        typ = "ok" if fate < 0.8 else ("fail" if fate < 0.9 else "info")
        apply = typ == "ok" or (typ == "info" and rng.random() < 0.5)
        done = []
        for f, k, v in txn_:
            if f == "r":
                seen = list(state.get(k, ()))
                r = rng.random()
                if r < 0.05 and seen:
                    seen.pop(rng.randrange(len(seen)))
                elif r < 0.08 and len(seen) > 1:
                    i = rng.randrange(len(seen) - 1)
                    seen[i], seen[i + 1] = seen[i + 1], seen[i]
                elif r < 0.11 and aborted:
                    ak, av = rng.choice(aborted)
                    if ak == k:
                        seen.append(av)
                done.append(["r", k, seen])
            else:
                if apply:
                    state.setdefault(k, []).append(v)
                elif typ == "fail":
                    aborted.append((k, v))
                done.append(["append", k, v])
        if typ == "ok":
            out.append({"process": p, "type": "ok", "f": "txn",
                        "value": done})
        else:
            out.append({"process": p, "type": typ, "f": "txn",
                        "value": [m if m[0] == "append" else [m[0], m[1],
                                                                None]
                                  for m in done]})
    return _ops(out)


def chaos_rw_register(seed, n_txns=60, conc=4, keys=3, predicate=False):
    """Random rw-register history (unique values per key, several
    writes of a key in one txn, stale and garbage reads, failed and
    indeterminate txns); with `predicate`, predicate reads
    ["rp", ["keys", [...]], observed] that sometimes miss a key."""
    rng = random.Random(seed)
    state: dict = {}
    nxt = {k: 0 for k in range(keys)}
    history: dict = {k: [] for k in range(keys)}
    inflight: dict = {}
    out: list = []
    started = 0
    while started < n_txns or inflight:
        p = rng.randrange(conc)
        if p not in inflight:
            if started >= n_txns:
                continue
            txn_ = []
            for _ in range(rng.randint(1, 4)):
                k = rng.randrange(keys)
                r = rng.random()
                if predicate and r < 0.2:
                    ks = sorted(rng.sample(range(keys), 2))
                    txn_.append(["rp", ["keys", ks], {}])
                elif r < 0.55:
                    txn_.append(["r", k, None])
                else:
                    nxt[k] += 1
                    txn_.append(["w", k, nxt[k]])
            inflight[p] = txn_
            out.append({"process": p, "type": "invoke", "f": "txn",
                        "value": [list(m) for m in txn_]})
            started += 1
            continue
        txn_ = inflight.pop(p)
        fate = rng.random()
        typ = "ok" if fate < 0.8 else ("fail" if fate < 0.9 else "info")
        apply = typ == "ok" or (typ == "info" and rng.random() < 0.5)
        local = dict(state)
        done = []
        for f, k, v in txn_:
            if f == "r":
                seen = local.get(k)
                r = rng.random()
                if r < 0.08 and history[k]:
                    seen = rng.choice(history[k])
                elif r < 0.1:
                    seen = nxt[k] + 100
                done.append(["r", k, seen])
            elif f == "rp":
                obs = {kk: local.get(kk) for kk in k[1]}
                if rng.random() < 0.15:
                    obs.pop(rng.choice(k[1]))
                done.append(["rp", k, obs])
            else:
                local[k] = v
                history[k].append(v)
                done.append(["w", k, v])
        if apply:
            state = local
        out.append({"process": p, "type": typ, "f": "txn",
                    "value": done if typ == "ok" else
                    [m if m[0] == "w" else [m[0], m[1],
                                            {} if m[0] == "rp" else None]
                     for m in done]})
    return _ops(out)


PLANTED = ("h_g0", "h_g1a", "h_g1b", "h_g1c", "h_gsingle", "h_g2",
           "h_clean", "h_rw_gsingle", "h_rw_clean")
SEEDS = range(6)


def history_cases():
    cases = [(name, getattr(ref_cases, name)().to_dicts())
             for name in PLANTED]
    for s in SEEDS:
        cases.append((f"la-{s}", chaos_list_append(100 + s)))
        cases.append((f"rw-{s}", chaos_rw_register(200 + s)))
        cases.append((f"pred-{s}", chaos_rw_register(300 + s,
                                                     predicate=True)))
    for plant in (None,) + ELLE_PLANTS:
        cases.append((f"store-{plant}",
                      list_append_history(120, 400, plant=plant)))
    return cases


CASES = history_cases()
CASE_IDS = [c[0] for c in CASES]


def assert_same_inference(r, p):
    assert p.workload == r.workload
    assert p.n == r.n
    for name in infer.PLANES:
        assert np.array_equal(p.planes[name], r.planes[name]), name
        for a, b in zip(p.edge_lists[name], r.edge_lists[name]):
            assert np.array_equal(a, b), name
    assert p.edge_types == r.edge_types
    assert p.direct == r.direct
    assert p.meta == r.meta
    assert (p.predicate is None) == (r.predicate is None)
    if r.predicate is not None:
        assert p.predicate["reads"] == r.predicate["reads"]
        for a, b in zip(p.predicate["prw"], r.predicate["prw"]):
            assert np.array_equal(a, b)
    assert np.array_equal(p.stacked(), r.stacked())


# ---------------------------------------------------------------------------
# txn, lattice, inference
# ---------------------------------------------------------------------------

MOPS = [["r", "x", None], ["read", 1, [2]], ["w", "y", 3], ["write", 0, 1],
        ["append", 2, 5], ["rp", ["keys", [1, 2]], {}], ["rp", "opaque", {}],
        ["cas", 1, 2], ["r", 1], "r", ("append", "k", 1)]


@pytest.mark.parametrize("m", MOPS, ids=repr)
def test_txn_accessors_match_reference(m):
    for name in ("is_read", "is_write", "is_append", "is_predicate_read",
                 "is_op"):
        assert getattr(txn, name)(m) == getattr(ref_txn, name)(m), name
    if ref_txn.is_op(m):
        assert txn.predicate_keys(m) == ref_txn.predicate_keys(m)
        assert (txn.f(m), txn.key(m), txn.value(m)) == \
            (ref_txn.f(m), ref_txn.key(m), ref_txn.value(m))


ANOMALY_SETS = [()] + [(a,) for a in sorted(ref_lattice.MODEL_OF)] + \
    list(itertools.combinations(["G0", "G1a", "G-single", "G2-item",
                                 "causal", "long-fork", "PRAM",
                                 "read-your-writes", "unknown-class"], 2))


@pytest.mark.parametrize("found", ANOMALY_SETS, ids=repr)
def test_lattice_matches_reference(found):
    assert lattice.violated_models(found) == \
        ref_lattice.violated_models(found)
    assert lattice.weakest_violated(found) == \
        ref_lattice.weakest_violated(found)
    assert elle.violated_levels(found) == ref_elle.violated_levels(found)
    assert elle.weakest_violated(found) == ref_elle.weakest_violated(found)
    assert lattice.MODELS == ref_lattice.MODELS
    assert lattice.MODEL_OF == ref_lattice.MODEL_OF
    assert lattice.LATTICE_CLASSES == ref_lattice.LATTICE_CLASSES


def test_checker_tables_match_reference():
    assert elle.ISOLATION_LEVELS == ref_elle.ISOLATION_LEVELS
    assert elle.ANOMALY_LEVEL == ref_elle.ANOMALY_LEVEL
    assert elle.ALL_ANOMALIES == ref_elle.ALL_ANOMALIES
    assert infer.PLANES == ref_infer.PLANES
    assert elle_graph.ANOMALY_CLASSES == ref_graph.ANOMALY_CLASSES
    assert elle_mesh.ANOMALY_CLASSES == ref_mesh.ANOMALY_CLASSES


@pytest.mark.parametrize("name,dicts", CASES, ids=CASE_IDS)
def test_inference_matches_reference(name, dicts):
    rh, ph = both(dicts)
    assert infer.detect_workload(ph) == ref_infer.detect_workload(rh)
    r, p = ref_infer.infer(rh), infer.infer(ph)
    assert_same_inference(r, p)
    assert [(i.to_dict(), o.to_dict()) for i, o in p.txns] == \
        [(i.to_dict(), o.to_dict()) for i, o in r.txns]
    wrote, read = infer.txn_roles(p.txns)
    rwrote, rread = ref_infer.txn_roles(r.txns)
    assert np.array_equal(wrote, rwrote) and np.array_equal(read, rread)
    sp, sr = infer.session_planes(p.txns), ref_infer.session_planes(r.txns)
    for fam in infer.SESSION_PLANES:
        assert np.array_equal(sp["planes"][fam], sr["planes"][fam])
        for a, b in zip(sp["edge_lists"][fam], sr["edge_lists"][fam]):
            assert np.array_equal(a, b)


def test_chaos_histories_reach_every_direct_class():
    """The seeded generators exercise what inference flags."""
    seen = set()
    for _, dicts in CASES:
        seen |= set(infer.infer(convert.history_from_dicts(dicts)).direct)
    assert {"G1a", "G1b", "incompatible-order", "G1-predicate"} <= seen


@pytest.mark.parametrize("workload", ["list-append", "rw-register"])
def test_inference_with_an_explicit_workload(workload):
    dicts = chaos_list_append(7) + []
    rh, ph = both(dicts)
    assert_same_inference(ref_infer.infer(rh, workload=workload),
                          infer.infer(ph, workload=workload))
    with pytest.raises(ValueError, match="unknown elle workload"):
        infer.infer(ph, workload="set")


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 128, 129, 300])
def test_packing_matches_reference(n):
    rng = np.random.default_rng(n)
    dense = rng.random((5, n, n)) < 0.1
    assert np.array_equal(elle_mesh.pack_bits(dense),
                          ref_mesh.pack_bits(dense))
    assert elle_mesh.pack_bits(dense).dtype == np.uint32
    for n_dev in (1, 2):
        assert elle_mesh.pad_for_mesh(n, n_dev) == \
            ref_mesh.pad_for_mesh(n, n_dev)
        assert elle_mesh.mesh_tile(n_dev) == ref_mesh.mesh_tile(n_dev)
        pk = elle_mesh.pack_planes(dense, n_dev=n_dev)
        assert np.array_equal(pk, ref_mesh.pack_planes(dense, n_dev=n_dev))
        assert np.array_equal(elle_mesh.unpack_bits(pk, n)[:, :n],
                              dense)
    assert elle_mesh.plane_nbytes(n) == ref_mesh.plane_nbytes(n)
    assert elle_mesh.plane_nbytes(n, packed=False) == \
        ref_mesh.plane_nbytes(n, packed=False)
    n_pad = elle_mesh.pad_for_mesh(n)
    src = rng.integers(0, n, 3 * n)
    dst = rng.integers(0, n, 3 * n)
    mine = np.zeros((n_pad, n_pad // 32), np.uint32)
    ref = np.zeros_like(mine)
    elle_mesh.set_bits(mine, src, dst)
    ref_mesh.set_bits(ref, src, dst)
    assert mine.tobytes() == ref.tobytes()
    strided = np.zeros((n_pad, 2 * (n_pad // 32)), np.uint32)[:, ::2]
    elle_mesh.set_bits(strided, src, dst)
    assert np.array_equal(strided, ref)


@pytest.mark.parametrize("name,dicts", CASES[:12], ids=CASE_IDS[:12])
def test_packed_stack_matches_reference(name, dicts):
    rh, ph = both(dicts)
    r, p = ref_infer.infer(rh), infer.infer(ph)
    assert p.packed_stacked().tobytes() == r.packed_stacked().tobytes()
    assert np.array_equal(p.packed_stacked(),
                          elle_mesh.pack_planes(p.stacked()))


def test_torch_packing_matches_numpy():
    rng = np.random.default_rng(3)
    dense = rng.random((256, 256)) < 0.3
    words = elle_kernel.pack(torch.from_numpy(dense))
    assert np.array_equal(words.numpy().view(np.uint32),
                          elle_mesh.pack_bits(dense))
    assert torch.equal(elle_kernel.unpack(words, 256),
                       torch.from_numpy(dense))
    t = elle_mesh.tpose(words)
    assert np.array_equal(t.numpy().view(np.uint32),
                          elle_mesh.pack_bits(dense.T))
    eye = elle_mesh._eye(256, torch.device("cpu"))
    assert np.array_equal(eye.numpy().view(np.uint32),
                          elle_mesh.pack_bits(np.eye(256, dtype=bool)))


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------

def packed(dense):
    return elle_mesh._to_device(elle_mesh.pack_planes(dense[None])[0],
                                torch.device("cpu"))


@pytest.mark.parametrize("n,dens", [(40, 0.1), (128, 1 / 128), (200, 0.02),
                                    (256, 0.3), (300, 0.5)])
def test_product_plain_matches_reference(n, dens):
    rng = np.random.default_rng(int(n * 1000 * dens))
    a = rng.random((n, n)) < dens
    b = rng.random((n, n)) < dens
    want = (a.astype(np.int64) @ b.astype(np.int64)) > 0
    assert np.array_equal(ref_mesh.packed_product(a, b), want)
    assert np.array_equal(elle_mesh.packed_product(a, b, device="cpu"),
                          want)
    x = rng.random((n, n)) < dens
    got = elle_kernel.product(packed(a), packed(b), packed(x))
    assert np.array_equal(
        elle_mesh.unpack_bits(got.numpy().view(np.uint32), n)[:n], want | x)


@pytest.mark.parametrize("n", [60, 200])
def test_closure_round_plain_reaches_the_reference_closure(n):
    stack = elle_stack(n, 11 + n, plant=True)
    ww, wr, rw, po, rt = (packed(stack[i]) for i in range(5))
    od = po | rt
    cww, p0, p1, rounds = elle_mesh.closure(
        ww, wr, rw, od, steps=10 * n)
    rc, r0, r1 = ref_graph.closure_reference(stack)
    n_pad = elle_mesh.pad_for_mesh(n)
    for mine, ref in ((cww, rc), (p0, r0), (p1, r1)):
        got = elle_mesh.unpack_bits(mine.numpy().view(np.uint32), n_pad)
        assert np.array_equal(got[:n, :n], ref)
    _, _, _, changed = elle_kernel.closure_round(cww, p0, p1)
    assert not bool(changed)
    assert 2 <= rounds <= math.ceil(math.log2(n - 1)) + 1


def np_tile_bits(words, tile=128):
    """Set bits of each tile-row band of packed u32 words and the most in
    one of its rows, by numpy: [tiles, 2]."""
    pop = np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=1)
    rows = pop.sum(1).reshape(-1, tile)
    return np.stack([rows.sum(1), rows.max(1)], 1)


@pytest.mark.parametrize("n_pad,dens,two", [(128, 0.01, False),
                                            (384, 0.3, False),
                                            (384, 0.001, True),
                                            (1152, 0.05, True)])
def test_tile_bits_plain_matches_numpy_popcount(n_pad, dens, two):
    rng = np.random.default_rng(n_pad + int(1000 * dens))
    a0 = rng.random((n_pad, n_pad)) < dens
    a1 = rng.random((n_pad, n_pad)) < dens
    t0, t1 = packed(a0), packed(a1)
    operands = [(t0, t1 if two else None), (t1, None)]
    got = elle_kernel.tile_bits_plain(operands)
    want = np.stack([
        np_tile_bits(elle_mesh.pack_bits(a0 | a1) if two
                     else elle_mesh.pack_bits(a0)),
        np_tile_bits(elle_mesh.pack_bits(a1))])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(elle_kernel.prepare(operands)[0], got)


@pytest.mark.parametrize("n_pad", [128, 384])
def test_prepare_counts_and_transposes_on_cpu(n_pad):
    rng = np.random.default_rng(n_pad)
    dense = [rng.random((n_pad, n_pad)) < d for d in (0.02, 0.3)]
    t0, t1 = (packed(d) for d in dense)
    counts, tposes = elle_kernel.prepare([(t0, t1)], [t0, t1])
    assert torch.equal(counts, elle_kernel.tile_bits_plain([(t0, t1)]))
    for got, d in zip(tposes, dense):
        assert np.array_equal(got.numpy().view(np.uint32),
                              elle_mesh.pack_bits(d.T))


@pytest.mark.parametrize("nterms", [1, 2])
def test_forms_plain_follows_the_crossover(nterms):
    n_pad = 1024
    num, den = elle_kernel.GATHER_DENSITY
    cap = nterms * elle_kernel.TILE * n_pad * num // den
    per_term = [[cap, cap + 1, 0, cap * den], [0, 0, 0, 0]][:nterms]
    bits = torch.tensor([[[b, min(b, n_pad)] for b in row]
                         for row in per_term], dtype=torch.int32)
    forms = elle_kernel.forms_plain(bits, [list(range(nterms))], n_pad)
    assert forms.tolist() == [[0, 1, 0, 1]]


def test_gather_density_is_the_sources():
    src = (Path(elle_kernel.__file__).resolve().parent.parent / "csrc"
           / "elle_pmm.cu").read_text()
    num = re.search(r"constexpr long long GATHER_NUM = (\d+);", src)
    den = re.search(r"constexpr long long GATHER_DEN = (\d+);", src)
    assert (int(num.group(1)), int(den.group(1))) == \
        elle_kernel.GATHER_DENSITY


@pytest.mark.parametrize("case", range(5), ids=["split", "edge", "zero",
                                                 "one", "heavy"])
def test_mixed_cases_take_the_forms_they_name(case):
    gen = torch.Generator()
    gen.manual_seed(case)
    name, a, b, x, want = elle_mixed_cases(384, gen,
                                           torch.device("cpu"))[case]
    bits = elle_kernel.tile_bits_plain([(a, None)])
    assert elle_kernel.forms_plain(bits, [[0]], 384)[0].tolist() == want
    assert torch.equal(elle_kernel.product(a, b, x),
                       elle_kernel.product_plain(a, b, x))


def test_kernel_wrappers_refuse_bad_planes():
    a = torch.zeros((128, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        elle_kernel.product(a.to(torch.int64), a)
    with pytest.raises(ValueError, match="multiple of 128"):
        elle_kernel.product(torch.zeros((64, 2), dtype=torch.int32),
                            torch.zeros((64, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        elle_kernel.closure_round(a, a, torch.zeros((128, 5),
                                                    dtype=torch.int32))


# ---------------------------------------------------------------------------
# the dense tier
# ---------------------------------------------------------------------------

def random_stack(n, seed, dens=2.0):
    """Random planes with every class likely: sparse random ww/wr/rw,
    a po chain, a sparse rt sample, no diagonal."""
    rng = np.random.default_rng(seed)
    st = rng.random((5, n, n)) < dens / n
    st[3] = False
    perm = rng.permutation(n)
    st[3, perm[:-1], perm[1:]] = True
    for p in range(5):
        np.fill_diagonal(st[p], False)
    return st


def g2_stack(n, seed):
    """Two ww chains over the two halves of a random order, joined only
    by an rw edge from each chain's end to the other's start: the one
    cycle has two rw edges (G2-item), and neither closes without rw."""
    rng = np.random.default_rng(seed)
    st = np.zeros((5, n, n), bool)
    perm = rng.permutation(n)
    a, b = perm[:n // 2], perm[n // 2:]
    for chain in (a, b):
        st[0, chain[:-1], chain[1:]] = True
    st[2, a[-1], b[0]] = st[2, b[-1], a[0]] = True
    return st


STACK_NS = (100, 128, 129, 200, 256, 257, 300)


def stacks_for(ns, seed0):
    out = []
    for i, n in enumerate(ns):
        out.append(random_stack(n, seed0 + i, dens=1.0 + (i % 3)))
        out.append(elle_stack(n, seed0 + 50 + i, plant=i % 2 == 0))
        out.append(g2_stack(n, seed0 + 90 + i))
    return out


@pytest.mark.parametrize("include_order", [True, False])
def test_dense_tier_matches_reference(include_order):
    stacks = stacks_for(STACK_NS, 500)
    want = ref_graph.classify_batch(stacks, include_order=include_order)
    got = elle_graph.classify_batch(stacks, include_order=include_order,
                                    device="cpu")
    assert got == want
    kinds = set().union(*(r["anomalies"] for r in got))
    assert kinds == set(elle_graph.ANOMALY_CLASSES)
    for s, r in zip(stacks[:4], got[:4]):
        host = elle_graph.classify_host(s, include_order=include_order)
        assert host == ref_graph.classify_host(s,
                                               include_order=include_order)
        assert host["anomalies"] == r["anomalies"]


def test_dense_tier_stops_at_its_fixpoint(monkeypatch):
    """Deviation: each closure stops at its fixpoint where the reference
    always runs ceil(log2(n_pad - 1)) rounds; the rows are the same."""
    stacks = [elle_stack(200, 7, plant=True), random_stack(150, 8)]
    calls = []
    sq = elle_graph._sq

    def counting(a, b):
        calls.append(1)
        return sq(a, b)

    monkeypatch.setattr(elle_graph, "_sq", counting)
    got = elle_graph.classify_batch(stacks, device="cpu")
    assert got == ref_graph.classify_batch(stacks)
    steps = elle_graph._steps(256)
    assert len(calls) < 6 * steps


def test_dense_tier_on_empty_and_tiny_histories():
    stacks = [np.zeros((5, 0, 0), bool), np.zeros((5, 1, 1), bool),
              random_stack(3, 1)]
    assert elle_graph.classify_batch(stacks, device="cpu") == \
        ref_graph.classify_batch(stacks)
    assert elle_graph.classify_batch([], device="cpu") == []
    assert elle_graph.classify_host(stacks[0]) == \
        ref_graph.classify_host(stacks[0])


def test_host_oracle_deadline_row():
    s = random_stack(200, 3)
    row = elle_graph.classify_host(s, deadline_s=0.0)
    assert row["unknown"] and row["degraded"] == "host-deadline"
    assert row["anomalies"] == {} and row["n"] == 200


@pytest.mark.parametrize("cls", list(elle_graph.ANOMALY_CLASSES))
def test_find_witness_matches_reference(cls):
    stacks = stacks_for(STACK_NS[:4], 900)
    rows = ref_graph.classify_batch(stacks)
    hits = [(s, r["anomalies"][cls]) for s, r in zip(stacks, rows)
            if cls in r["anomalies"]]
    assert hits
    for s, edge in hits:
        assert elle_graph.find_witness(s, cls, edge) == \
            ref_graph.find_witness(s, cls, edge)
    with pytest.raises(ValueError, match="unknown anomaly class"):
        elle_graph.find_witness(hits[0][0], "G9", (0, 1))


def test_closure_reference_matches_reference():
    for s in stacks_for((50, 130), 77):
        for mine, ref in zip(elle_graph.closure_reference(s),
                             ref_graph.closure_reference(s)):
            assert np.array_equal(mine, ref)


# ---------------------------------------------------------------------------
# the packed tier
# ---------------------------------------------------------------------------

def chain_stack(n):
    """A po chain over n txns and one rw edge back from its end to its
    start: G-single, and the closure needs ceil(log2(n - 1)) rounds."""
    st = np.zeros((5, n, n), bool)
    st[3, np.arange(n - 1), np.arange(1, n)] = True
    st[2, n - 1, 0] = True
    return st


@pytest.mark.parametrize("include_order", [True, False])
def test_packed_tier_matches_reference(include_order):
    stacks = stacks_for((100, 129, 257), 700) + [chain_stack(40),
                                                 chain_stack(128),
                                                 chain_stack(300)]
    want = ref_mesh.classify_mesh(stacks, include_order=include_order,
                                  max_devices=1)
    got = elle_mesh.classify_mesh(stacks, include_order=include_order,
                                  device="cpu")
    assert got == want
    dense = ref_graph.classify_batch(stacks, include_order=include_order)
    assert [r["anomalies"] for r in got] == [r["anomalies"] for r in dense]
    if include_order:
        # the chain of 300 needs all ceil(log2(383)) = 9 rounds: the cap
        assert got[-1]["rounds"] == 9 == elle_graph._steps(384)
        assert got[-1]["anomalies"] == {"G-single": (299, 0)}
        assert got[-3]["rounds"] == 7      # 40 txns: 6 rounds + the check


def test_packed_tier_from_inferences_matches_reference():
    dicts = [d for _, d in CASES[9:18]]
    infs = [infer.infer(convert.history_from_dicts(d)) for d in dicts]
    rinfs = [ref_infer.infer(RefHistory(d)) for d in dicts]
    got = elle_mesh.classify_mesh([i.stacked() for i in infs],
                                  device="cpu", inferences=infs)
    want = ref_mesh.classify_mesh([i.stacked() for i in rinfs],
                                  max_devices=1, inferences=rinfs)
    assert got == want


def test_packed_tier_refuses_unaligned_planes():
    with pytest.raises(ValueError, match="mesh_tile"):
        elle_mesh.classify_packed([np.zeros((5, 96, 3), np.uint32)], [90],
                                  device="cpu")


# ---------------------------------------------------------------------------
# the planner and the checker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_max,algorithm", [
    (10, "auto"), (8191, "auto"), (8192, "auto"), (50_000, "auto"),
    (10, "mesh"), (10, "device"), (10, "host"), (9000, "device")])
def test_plan_elle_matches_reference_engine(n_max, algorithm):
    plan = planner.plan_elle(n_max, batch=3, algorithm=algorithm)
    ref = ref_planner.plan_elle(n_max, batch=3, algorithm=algorithm)
    assert plan["engine"] == ref.engine
    assert (plan["batch"], plan["n_max"]) == (3, n_max)
    with pytest.raises(ValueError, match="unknown algorithm"):
        planner.plan_elle(n_max, algorithm="fast")


@pytest.fixture
def one_device_reference(monkeypatch):
    """The reference's packed tier on one of the test mesh's devices, as
    the port runs it (shards 1, n_pad a multiple of 128)."""
    devices = ref_mesh._devices
    monkeypatch.setattr(ref_mesh, "_devices",
                        lambda devices_=None, max_devices=None:
                        devices(devices_, 1))


def strip(v):
    return {k: x for k, x in v.items() if k not in DISPATCH}


ALGORITHMS = [("auto", 8192), ("auto", 50), ("mesh", 8192),
              ("device", 8192), ("host", 8192)]


@pytest.mark.parametrize("algorithm,threshold", ALGORITHMS)
@pytest.mark.parametrize("include_order", [True, False])
def test_check_matches_reference(one_device_reference, algorithm, threshold,
                                 include_order):
    kw = dict(algorithm=algorithm, mesh_threshold=threshold,
              include_order=include_order)
    for name, dicts in CASES:
        rh, ph = both(dicts)
        want = ref_elle.Elle(**kw).check({}, rh)
        got = elle.Elle(device="cpu", **kw).check({}, ph)
        assert strip(got) == strip(want), name
        assert got["dispatch"]["engine"] == want["engine"]


@pytest.mark.parametrize("algorithm,threshold", ALGORITHMS)
def test_check_many_matches_reference(one_device_reference, algorithm,
                                      threshold):
    hs = [d for _, d in CASES]
    kw = dict(algorithm=algorithm, mesh_threshold=threshold, max_group=5)
    want = ref_elle.Elle(**kw).check_many(
        None, [RefHistory(d) for d in hs])
    got = elle.Elle(device="cpu", **kw).check_many(
        None, [convert.history_from_dicts(d) for d in hs])
    assert [strip(g) for g in got] == [strip(w) for w in want]
    for k in range(0, len(got), 5):
        group = got[k:k + 5]
        n_max = max(g["txn-count"] for g in group)
        engine = ref_planner.plan_elle(n_max, algorithm=algorithm,
                                       mesh_threshold=threshold).engine
        assert {g["dispatch"]["engine"] for g in group} == {engine}
        assert {g["dispatch"]["n_max"] for g in group} == {n_max}
    rec = got[0]["dispatch"]
    assert set(rec) == {"engine", "why", "batch", "device", "n_max",
                        "n_pad", "rounds", "shards"}
    assert rec["batch"] == 5 and rec["device"] == "cpu"


@pytest.mark.parametrize("plant", (None,) + ELLE_PLANTS)
def test_store_histories_give_the_planted_verdicts(plant):
    """chip_smoke.py's simulated store: clean, or exactly the planted
    class, on both tiers, equal to the reference."""
    dicts = list_append_history(300, 31, plant=plant)
    rh, ph = both(dicts)
    want = ref_elle.Elle().check({}, rh)
    for alg in ("device", "mesh"):
        got = elle.Elle(device="cpu", algorithm=alg).check({}, ph)
        exp = elle_expected(plant)
        assert (got["valid?"], got["anomaly-types"],
                got["weakest-violated"], got["not"]) == exp
        assert {k: v for k, v in strip(got).items()
                if k not in ("engine", "rounds", "shards")} == \
            {k: v for k, v in strip(want).items() if k != "engine"}


def test_empty_history_verdict_matches_reference():
    rh, ph = both([])
    assert strip(elle.Elle(device="cpu").check({}, ph)) == \
        strip(ref_elle.Elle().check({}, rh))


def test_anomalies_option_and_unknown_verdicts():
    rh, ph = both(ref_cases.h_gsingle().to_dicts())
    kw = dict(anomalies=["G2-item"], include_order=False)
    assert strip(elle.Elle(device="cpu", **kw).check({}, ph)) == \
        strip(ref_elle.Elle(**kw).check({}, rh))
    with pytest.raises(ValueError, match="unknown anomaly"):
        elle.Elle(anomalies=["G7"])
    with pytest.raises(ValueError, match="unknown algorithm"):
        elle.Elle(algorithm="tpu")
    rh, ph = both(chaos_list_append(1, n_txns=80))
    kw = dict(algorithm="host", host_deadline_s=0.0)
    got = elle.Elle(**kw).check({}, ph)
    want = ref_elle.Elle(**kw).check({}, rh)
    for key in ("elapsed_s", "dispatch", "stages"):
        got.pop(key), want.pop(key)
    assert got == want and got["valid?"] == "unknown"
    assert elle.checker("list-append").workload == "list-append"


def test_batch_checker_matches_reference(one_device_reference):
    rh, ph = both(keyed_list_append(12, 25, (3, 7), 600))
    want = ref_independent.batch_checker(ref_elle.Elle()).check({}, rh)
    got = independent.batch_checker(elle.Elle(device="cpu")).check({}, ph)
    assert got["valid?"] == want["valid?"] is False
    assert got["failures"] == want["failures"] == [3, 7]
    assert list(got["results"]) == list(want["results"])
    for k in got["results"]:
        assert strip(got["results"][k]) == strip(want["results"][k])
    assert isinstance(independent.batch_checker(elle.Elle()),
                      elle.BatchedElleChecker)
    again = elle.batch_checker(device="cpu").check({}, ph)
    assert again["failures"] == got["failures"]
    assert {k: strip(r) for k, r in again["results"].items()} == \
        {k: strip(r) for k, r in got["results"].items()}
    with pytest.raises(ValueError, match="device"):
        independent.batch_checker(elle.Elle(), device="cpu")
    assert independent.batch_checker(elle.Elle()).check(
        {}, convert.history_from_dicts([])) == \
        {"valid?": True, "results": {}, "failures": []}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_runner_options_name_p4r():
    with pytest.raises(Unsupported, match="ROADMAP P4R"):
        elle.Elle(max_retries=3)
    with pytest.raises(Unsupported, match="ROADMAP P4R"):
        elle.batch_checker(max_retries=0)


def test_no_card_raises_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ph = both(ref_cases.h_g2().to_dicts())
    stack = infer.infer(ph).stacked()
    for alg in ("auto", "mesh", "device"):
        with pytest.raises(BackendUnavailable):
            elle.Elle(algorithm=alg).check({}, ph)
        with pytest.raises(BackendUnavailable):
            elle.Elle(algorithm=alg).check_many({}, [ph])
    with pytest.raises(BackendUnavailable):
        elle_graph.classify_batch([stack])
    with pytest.raises(BackendUnavailable):
        elle_mesh.classify_mesh([stack])
    with pytest.raises(BackendUnavailable):
        elle_mesh.packed_product(stack[0], stack[1])
    with pytest.raises(BackendUnavailable):
        independent.batch_checker(elle.Elle()).check(
            {}, convert.history_from_dicts(keyed_list_append(2, 25, (), 600)))
    # the numpy oracle runs because the caller asks for it
    v = elle.Elle(algorithm="host").check({}, ph)
    assert v["anomaly-types"] == ["G2-item"] and v["engine"] == "elle-host"
