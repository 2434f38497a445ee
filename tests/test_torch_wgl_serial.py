"""The serial frontier engine of jepsen_tpu_torch (`ops.wgl.check`, its
walk `ops.frontier_kernel.walk`, on the CPU its plain version) against
jepsen_tpu's `ops.wgl` (its XLA kernel `_build_kernel`, run by JAX on
the CPU), on the same seeded histories carried across as op dicts:

- the port's twin of every case of the reference's
  `tests/test_wgl_tpu.py`: empty, sequential, witness, concurrent
  writes, real-time order, crashed writes, a crashed op surfacing late,
  failed ops, CAS and mutex, random valid and mutated histories, the
  chunked walk equal to one launch, escalation through frontier sizes,
  and overflow reported unknown: valid?, op, op_index, frontier_size,
  final_frontier and cause equal, and valid? equal to the CPU oracle's;
- every launch of the walk against the reference kernel's call at the
  same point of the same check (each side's calls recorded): the plan
  arrays, the crash arguments (cw, gws, luts and the group sizes) and
  the frontier entering the launch equal byte for byte, and after each
  chunk the frontier words (masks, states, valid) and ok,
  failed_event, overflow, frontier and r, at small frontier sizes, with
  crash groups at one and two mask words, mutexes and escalation;
- `plan` array for array against the reference's;
- the row-frontier ops (`ops.frontier`) against the reference's
  `make_bit_ops` and `make_dedupe_compact` on random pools;
- the `work=` count: chunked equal to one launch, and what each part
  counts;
- the wrapper's checks, and no card: BackendUnavailable, no plain run.

The CUDA kernel against its plain version on the card is
`tests/test_torch_wgl_serial_card.py`, which imports no JAX."""

import dataclasses
import random

import numpy as np
import pytest
import torch
from chip_smoke import mutex_dicts, serial_inputs, serial_kernel_cases
from test_wgl_cpu import H, simulate_register_history
from torch_keys import key_dicts

from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import fail_op, info_op, invoke_op, ok_op
from jepsen_tpu.ops import frontier as ref_frontier
from jepsen_tpu.ops import prep as ref_prep
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops import wgl_cpu as ref_cpu
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.ops import frontier, frontier_kernel, wgl
from jepsen_tpu_torch.ops.prep import prepare

FIELDS = ("valid?", "op_index", "frontier_size", "final_frontier", "cause",
          "op_count", "anomaly")
MODELS = {"cas": (ref_models.CASRegister, models.CASRegister),
          "reg": (ref_models.Register, models.Register),
          "mutex": (ref_models.Mutex, models.Mutex)}


def port(h):
    return convert.history_from_dicts(h.to_dicts())


def from_dicts(dicts):
    return RefHistory(dicts)


def mutex_history(seed, n=40, conc=4, bad=0.0):
    """A mutex workload (chip_smoke's): acquires and releases against
    a real lock, with failed and crashed (one in five) acquires; `bad`
    of the refused acquires complete ok anyway (invalid)."""
    return from_dicts(mutex_dicts(seed, n, conc, bad=bad, crash=0.2))


def _random_valid():
    rng = random.Random(1234)
    return [simulate_register_history(rng, n_procs=4, n_ops=50)
            for _ in range(5)]


def _random_mutated():
    rng = random.Random(99)
    out = []
    for _ in range(15):
        h = simulate_register_history(rng, n_procs=3, n_ops=40,
                                      crash_p=0.02)
        ok_reads = [j for j, o in enumerate(h) if o.f == "read" and o.is_ok]
        if ok_reads and rng.random() < 0.7:
            h[rng.choice(ok_reads)].value = rng.randrange(10)
        out.append(h)
    return out


def _chunked():
    rng = random.Random(77)
    return [simulate_register_history(rng, n_procs=3, n_ops=40,
                                      crash_p=0.05 if i % 2 else 0.0)
            for i in range(4)]


def twin_cases():
    """name -> (model key, initial value, reference history, check kw):
    the cases of the reference's tests/test_wgl_tpu.py."""
    cases = {
        "empty": ("cas", None, H(), {}),
        "sequential-valid": ("cas", None, H(
            invoke_op(0, "write", 3), ok_op(0, "write", 3),
            invoke_op(0, "read", None), ok_op(0, "read", 3)), {}),
        "sequential-invalid-witness": ("cas", None, H(
            invoke_op(0, "write", 3), ok_op(0, "write", 3),
            invoke_op(0, "read", None), ok_op(0, "read", 4)), {}),
        "real-time-order": ("cas", None, H(
            invoke_op(0, "write", 1), ok_op(0, "write", 1),
            invoke_op(0, "write", 2), ok_op(0, "write", 2),
            invoke_op(0, "read", None), ok_op(0, "read", 1)), {}),
        "crashed-op-surfaces-late": ("cas", 0, H(
            invoke_op(9, "write", 7), info_op(9, "write", 7),
            invoke_op(0, "write", 1), ok_op(0, "write", 1),
            invoke_op(0, "read", None), ok_op(0, "read", 1),
            invoke_op(0, "read", None), ok_op(0, "read", 7)), {}),
        "failed-ops-never-happened": ("cas", None, H(
            invoke_op(0, "write", 3), ok_op(0, "write", 3),
            invoke_op(1, "write", 9), fail_op(1, "write", 9),
            invoke_op(0, "read", None), ok_op(0, "read", 9)), {}),
        "cas": ("cas", 0, H(
            invoke_op(0, "cas", [0, 1]), ok_op(0, "cas", [0, 1]),
            invoke_op(1, "cas", [1, 2]), ok_op(1, "cas", [1, 2]),
            invoke_op(0, "read", None), ok_op(0, "read", 2)), {}),
        "mutex-double-acquire": ("mutex", None, H(
            invoke_op(0, "acquire", None), ok_op(0, "acquire", None),
            invoke_op(1, "acquire", None), ok_op(1, "acquire", None)), {}),
        "register-model": ("reg", None, H(
            invoke_op(0, "write", 1), invoke_op(1, "write", 2),
            ok_op(0, "write", 1), invoke_op(2, "read", None),
            ok_op(2, "read", 2), ok_op(1, "write", 2)), {}),
    }
    for seen in (1, 2):
        cases[f"concurrent-writes-read-{seen}"] = ("cas", None, H(
            invoke_op(0, "write", 1), invoke_op(1, "write", 2),
            ok_op(0, "write", 1), ok_op(1, "write", 2),
            invoke_op(0, "read", None), ok_op(0, "read", seen)), {})
    for seen in (9, 0, 5):
        cases[f"crashed-write-read-{seen}"] = ("cas", 0, H(
            invoke_op(1, "write", 9), info_op(1, "write", 9),
            invoke_op(0, "read", None), ok_op(0, "read", seen)), {})
    for i, h in enumerate(_random_valid()):
        cases[f"random-valid-{i}"] = ("cas", 0, h, {})
    for i, h in enumerate(_random_mutated()):
        cases[f"random-mutated-{i}"] = ("cas", 0, h, {})
    for i, h in enumerate(_chunked()):
        cases[f"chunked-{i}"] = ("cas", 0, h, {"events_per_call": 3})
    rng = random.Random(5)
    cases["escalation"] = ("cas", 0, simulate_register_history(
        rng, n_procs=6, n_ops=40, crash_p=0.15),
        {"frontier_sizes": (4, 64, 1024)})
    rng = random.Random(11)
    cases["overflow-unknown"] = ("cas", 0, simulate_register_history(
        rng, n_procs=8, n_ops=60, crash_p=0.3), {"frontier_sizes": (2,)})
    for k in range(2):
        cases[f"mutex-random-{k}"] = ("mutex", None,
                                      mutex_history(40 + k, bad=0.3 * k), {})
    return cases


TWINS = twin_cases()


def make_models(key, init):
    ref_cls, port_cls = MODELS[key]
    if key == "mutex":
        return ref_cls(), port_cls()
    return ref_cls(init), port_cls(init)


def pick(r):
    out = {k: r.get(k) for k in FIELDS}
    if "op" in r:
        out["op"] = (r["op"]["f"], r["op"]["value"], r["op"]["index"])
    return out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_check_matches_reference(name):
    key, init, h, kw = TWINS[name]
    ref_model, port_model = make_models(key, init)
    ref = ref_wgl.check(ref_model, h, **kw)
    got = wgl.check(port_model, port(h), device="cpu", **kw)
    assert pick(got) == pick(ref)
    assert got["backend"] == "cpu"
    oracle = ref_cpu.check(ref_model, h)
    if got["valid?"] != "unknown":
        assert got["valid?"] == oracle["valid?"]
    if name == "sequential-invalid-witness":
        assert got["op"]["value"] == 4 and got["op_index"] == 2
    if name == "overflow-unknown":
        assert got["valid?"] == "unknown"
        assert got["cause"] == "frontier-overflow"
    if name == "escalation":
        assert got["frontier_size"] > 4
    if name.startswith("chunked-"):
        whole = wgl.check(port_model, port(h), device="cpu")
        assert got["valid?"] == whole["valid?"]


# ---------------------------------------------------------------------------
# Every launch against the reference kernel's call, byte for byte
# ---------------------------------------------------------------------------

def record_reference(monkeypatch, model, h, **kw):
    """The reference's check with every kernel call recorded: [(static
    args, args, outputs)] as numpy."""
    calls = []
    build = ref_wgl._build_kernel

    def spy(*static):
        kern = build(*static)

        def run(*args):
            out = kern(*args)
            calls.append((static, [np.asarray(a) for a in args],
                          {k: np.asarray(v) for k, v in out.items()}))
            return out
        return run

    monkeypatch.setattr(ref_wgl, "_build_kernel", spy)
    res = ref_wgl.check(model, h, **kw)
    monkeypatch.setattr(ref_wgl, "_build_kernel", build)
    return res, calls


def record_port(monkeypatch, model, h, **kw):
    calls = []
    walk = frontier_kernel.walk

    def spy(t, masks, states, valid, **k):
        out = walk(t, masks, states, valid, **k)
        calls.append((t, masks.clone(), states.clone(), valid.clone(), k,
                      out))
        return out

    monkeypatch.setattr(frontier_kernel, "walk", spy)
    res = wgl.check(model, port(h), device="cpu", **kw)
    monkeypatch.setattr(frontier_kernel, "walk", walk)
    return res, calls


def u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def crash_dicts(seed, n, conc, rate, buggy=0.3):
    return from_dicts(key_dicts(seed, n_calls=n, conc=conc, crash_rate=rate,
                                buggy=buggy))


LAUNCH_CASES = {
    "valid-chunks": ("cas", 0, lambda: _chunked()[0],
                     dict(frontier_sizes=(64,), events_per_call=5)),
    "crash-chunks": ("cas", 0, lambda: _chunked()[1],
                     dict(frontier_sizes=(4, 64), events_per_call=4)),
    "escalation": ("cas", 0, lambda: TWINS["escalation"][2],
                   dict(frontier_sizes=(4, 600), events_per_call=7)),
    "crash-groups": ("cas", None, lambda: crash_dicts(741828, 38, 5, 0.15),
                     dict(frontier_sizes=(64,), events_per_call=6)),
    "crash-groups-2-words": ("cas", None,
                             lambda: crash_dicts(52, 100, 5, 0.35, 0.0),
                             dict(frontier_sizes=(64,), events_per_call=40)),
    "overflow": ("cas", 0, lambda: TWINS["overflow-unknown"][2],
                 dict(frontier_sizes=(3, 5), events_per_call=9)),
    "mutex": ("mutex", None, lambda: mutex_history(43, bad=0.2),
              dict(frontier_sizes=(8,), events_per_call=6)),
    # crash groups in the tier F = 8192: the closure passes 512 configs,
    # so the tiers 64 and 512 overflow and the last runs without
    # dominance (above its cap of 4096), then overflows and truncates
    "crash-tier-8192": ("cas", None, lambda: from_dicts(key_dicts(
        81, n_calls=40, conc=4, burst=10, crash_rate=0.25)),
        dict(frontier_sizes=(8192,), events_per_call=20)),
}


@pytest.mark.parametrize("name", sorted(LAUNCH_CASES))
def test_every_launch_matches_reference_kernel(monkeypatch, name):
    key, init, make, kw = LAUNCH_CASES[name]
    h = make()
    ref_model, port_model = make_models(key, init)
    ref, rcalls = record_reference(monkeypatch, ref_model, h, **kw)
    got, pcalls = record_port(monkeypatch, port_model, h, **kw)
    assert pick(got) == pick(ref)
    assert len(pcalls) == len(rcalls) >= 1
    if "chunks" in name or name == "crash-groups-2-words":
        assert len(pcalls) > 1
    for (static, args, out), (t, masks, states, valid, k, pout) in zip(
            rcalls, pcalls):
        _, _, F, C, W, S, sizes = static
        assert masks.shape == (F, max((W + 31) // 32, 1))
        assert t.cand_call.shape[1] == C and states.shape[1] == S
        # the plan arrays, the call's scalars and the entering frontier
        for x, y in zip(args[:8], t):
            assert np.array_equal(np.asarray(x), y.numpy())
        r0, m0, s0, v0, n_events, stop_r = args[8:14]
        assert (int(r0), int(n_events), int(stop_r)) == \
            (k["r0"], k["n_events"], k["stop_r"])
        assert np.array_equal(u32(m0), u32(masks.numpy()))
        assert np.array_equal(s0, states.numpy())
        assert np.array_equal(v0, valid.numpy())
        # the crash arguments
        crash = k["crash"]
        if sizes is None:
            assert crash is None
        else:
            assert crash.sizes == sizes
            for x, y in zip(args[14:], crash[1:]):
                assert np.array_equal(u32(x), u32(y.numpy()))
        # the frontier and the flags after the chunk
        o = pout["out"].tolist()
        assert o == [int(out["ok"]), int(out["failed_event"]),
                     int(out["overflow"]), int(out["frontier"]),
                     int(out["r"])]
        assert np.array_equal(u32(out["final_masks"]),
                              u32(pout["final_masks"].numpy()))
        assert np.array_equal(out["final_states"],
                              pout["final_states"].numpy())
        assert np.array_equal(out["final_valid"],
                              pout["final_valid"].numpy())
    if name == "crash-groups-2-words":
        assert pcalls[0][1].shape[1] == 2
    if name == "escalation":
        assert {c[1].shape[0] for c in pcalls} == {4, 600}
    if name == "crash-tier-8192":
        assert pcalls[0][4]["crash"] is not None
        assert max(int(c[5]["out"][3]) for c in pcalls) > 512
        assert 8192 > frontier_kernel.DOM_TIER_CAP
        assert any(int(c[5]["out"][2]) for c in pcalls)     # overflowed


@pytest.mark.parametrize("seed,n,conc,rate", [(304019, 34, 6, 0.15),
                                              (52, 100, 5, 0.35),
                                              (7, 60, 8, 0.0)])
def test_plan_matches_reference(seed, n, conc, rate):
    h = crash_dicts(seed, n, conc, rate)
    for pad in (False, True):
        kw = {}
        if pad:
            p = ref_prep.prepare(h)
            kw = dict(pad_events_to=ref_wgl._bucket(len(p.calls)),
                      pad_cands_to=ref_wgl._bucket(p.max_open, 4))
        rm = ref_models.CASRegister()
        ref = ref_wgl.plan(ref_prep.prepare(h), rm.device_spec(), rm, **kw)
        pm = models.CASRegister()
        got = wgl.plan(prepare(port(h)), pm.device_spec(), pm, **kw)
        for field in ("ret_call", "ret_slot", "cand_call", "cand_slot", "f",
                      "a", "b", "a_ok", "init_state"):
            x, y = getattr(ref, field), getattr(got, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        for field in ("n_calls", "n_events", "max_open", "crash_groups"):
            assert getattr(ref, field) == getattr(got, field), field
    if rate:
        assert got.crash_groups


# ---------------------------------------------------------------------------
# The row-frontier ops
# ---------------------------------------------------------------------------

def test_bit_ops_match_reference():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    for Wd in (1, 2, 3):
        masks = rng.integers(0, 2 ** 32, (50, Wd), dtype=np.uint64)
        masks = masks.astype(np.uint32)
        slots = rng.integers(0, 32 * Wd, 50).astype(np.int32)
        r_has, r_set, r_clear = ref_frontier.make_bit_ops(Wd)
        has, set_, clear = frontier.make_bit_ops(Wd)
        m = torch.from_numpy(masks.astype(np.int64))
        s = torch.from_numpy(slots.astype(np.int64))
        jm, js = jnp.asarray(masks), jnp.asarray(slots)
        assert np.array_equal(np.asarray(r_has(jm, js)), has(m, s).numpy())
        assert np.array_equal(u32(r_set(jm, js)), set_(m, s).numpy())
        assert np.array_equal(u32(r_clear(jm, js)), clear(m, s).numpy())


@pytest.mark.parametrize("Wd,out_rows", [(1, 8), (1, 40), (2, 16), (3, 5)])
def test_dedupe_compact_matches_reference(Wd, out_rows):
    # out_rows <= P, as in every closure round (a pool of Fb * (C + 1)
    # rows deduped to Fb): the reference parks the rows it drops at
    # position P + 1, inside the output only when out_rows > P + 1
    import jax.numpy as jnp
    rng = np.random.default_rng(Wd * 100 + out_rows)
    P = 40
    # few distinct words, so the pool holds duplicates; signed states
    # on both sides of 0 check the XOR of the sign bit
    masks = rng.choice(np.array([0, 1, 5, 2 ** 31, 2 ** 32 - 1],
                                np.uint32), (P, Wd))
    states = rng.choice(np.array([-(2 ** 31), -3, 0, 2, 2 ** 31 - 1],
                                 np.int32), (P, 1))
    valid = rng.random(P) < 0.7
    ref = ref_frontier.make_dedupe_compact(Wd, 1)(
        jnp.asarray(masks), jnp.asarray(states), jnp.asarray(valid),
        out_rows)
    got = frontier.make_dedupe_compact(Wd, 1)(
        torch.from_numpy(masks.astype(np.int64)), torch.from_numpy(states),
        torch.from_numpy(valid), out_rows)
    assert np.array_equal(u32(ref[0]), got[0].numpy())
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy())
    assert np.array_equal(np.asarray(ref[2]), got[2].numpy())
    assert bool(ref[3]) == got[3] and int(ref[4]) == got[4]


# ---------------------------------------------------------------------------
# work=, the wrapper, no card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fast-path", "tiers", "overflow", "chunks",
                                  "crash-1-word", "crash-4-words", "mutex",
                                  "burst-2-words", "burst-5-words"])
def test_pool_sizes_sum_to_sorted_row_levels(name):
    # walk_plain's optional count of its dedupes by pool size: each
    # dedupe of P rows lands in bucket b = ceil(log2 P), so the buckets
    # sum, b times their rows, to work='s sorted row-levels; the count
    # changes nothing of the walk
    _, model, h, F, _ = next(c for c in serial_kernel_cases()
                             if c[0] == name)
    spec, pl, t, crash, W = serial_inputs(model, h, "cpu")
    kw = dict(r0=0, n_events=pl.n_events, stop_r=pl.n_events,
              step=spec.step, crash=crash)
    fr = wgl.init_frontier(F, W, 1, pl.init_state)
    pools, work, bare = {}, torch.zeros(3, dtype=torch.int64), \
        torch.zeros(3, dtype=torch.int64)
    got = frontier_kernel.walk_plain(t, *fr, work=work, pools=pools, **kw)
    want = frontier_kernel.walk_plain(t, *fr, work=bare, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(work, bare)
    assert pools and sum(b * rows for b, (_, rows) in pools.items()) \
        == int(work[1])
    for b, (rounds, rows) in pools.items():
        lo = 2 ** (b - 1) if b else 0
        assert rounds >= 1 and rounds * lo < rows <= rounds * 2 ** b


def test_work_counts_chunked_equal_one_launch():
    h = port(crash_dicts(741828, 38, 5, 0.15))
    one, chunked = {}, {}
    a = wgl.check(models.CASRegister(), h, device="cpu", stats=one)
    b = wgl.check(models.CASRegister(), h, device="cpu", stats=chunked,
                  events_per_call=3)
    assert a["valid?"] is b["valid?"] is False
    assert one["launches"] == 1 and chunked["launches"] > 3
    assert one["work"] == chunked["work"]
    expansions, sorted_rows, dominance = one["work"]
    assert expansions > 0 and sorted_rows > 0 and dominance > 0
    # crash-free: no dominance pass
    free = {}
    wgl.check(models.CASRegister(), port(_chunked()[0]), device="cpu",
              stats=free)
    assert free["work"][2] == 0 and free["work"][0] > 0


def test_work_counts_one_event_by_hand():
    # one write and one read open, the read returns first: its op is
    # pure but illegal at the initial state, so the slow path expands
    # the one config by both open calls (2 expansions), and dedupes a
    # pool of 3 rows (3 * ceil(log2 3) = 6 row-levels) in the first
    # round; the second round expands the one config still lacking the
    # read by the read alone
    h = H(invoke_op(0, "write", 1), invoke_op(1, "read", None),
          ok_op(1, "read", 1), ok_op(0, "write", 1))
    st = {}
    r = wgl.check(models.CASRegister(0), port(h), device="cpu", stats=st,
                  pad=False)
    assert r["valid?"] is True
    # the read's return: the fast test steps the 1 config lacking it
    # (illegal: the register holds 0); round 1 expands that config by
    # the 2 open calls (the read is illegal: a pool of 2 rows, 2 * 1
    # row-levels); round 2 expands both configs, which lack the read, by
    # the 2 open calls (the write is already in one: a pool of 2 parents
    # and 2 children, 4 * 2 row-levels); C = 2 rounds end the closure.
    # The write's return: not pure, and no config lacks it
    assert st["work"] == [1 + 2 + 4, 2 + 8, 0]


def test_walk_checks_its_inputs():
    pm = models.CASRegister()
    h = port(_chunked()[0])
    pl, t, _, _ = wgl.walk_inputs(pm, prepare(h), pad=False)
    masks, states, valid = wgl.init_frontier(8, 4, 1, pl.init_state)
    kw = dict(r0=0, n_events=pl.n_events, stop_r=10, spec=pm.device_spec())
    frontier_kernel.walk(t, masks, states, valid, **kw)
    with pytest.raises(ValueError):
        frontier_kernel.walk(t, masks.to(torch.int64), states, valid, **kw)
    with pytest.raises(ValueError):
        frontier_kernel.walk(t, masks, states, valid[:4], **kw)
    with pytest.raises(ValueError):
        frontier_kernel.walk(t._replace(f=t.f.to(torch.int64)), masks,
                             states, valid, **kw)
    with pytest.raises(ValueError, match="pure"):
        frontier_kernel.walk(t._replace(pure=t.pure[:-1]), masks,
                             states, valid, **kw)
    with pytest.raises(ValueError):
        frontier_kernel.walk(t, masks, states, valid,
                             **dict(kw, n_events=10 ** 6))
    with pytest.raises(ValueError, match="no frontier kernel"):
        frontier_kernel.walk(
            frontier_kernel.Tables(*(x.to("meta") for x in t)),
            *(x.to("meta") for x in (masks, states, valid)), **kw)


def test_check_refuses_what_the_reference_refuses():
    h = port(H(invoke_op(0, "write", 2 ** 40), ok_op(0, "write", 2 ** 40)))
    with pytest.raises(ValueError, match="int32"):
        wgl.check(models.CASRegister(), h, device="cpu")
    with pytest.raises(ValueError, match="events_per_call"):
        wgl.check(models.CASRegister(), h, device="cpu", events_per_call=0)

    class HostOnly(models.Model):
        def step(self, op):
            return self

    with pytest.raises(Unsupported, match="no device spec"):
        wgl.check(HostOnly(), h, device="cpu")


def test_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for the default device")

    monkeypatch.setattr(frontier_kernel, "walk_plain", no_plain)
    with pytest.raises(BackendUnavailable):
        wgl.check(models.CASRegister(), port(_chunked()[0]))


def test_the_kernel_refuses_a_model_without_its_transition():
    spec = models.CASRegister().device_spec()
    bare = dataclasses.replace(spec, device_step=None)
    frontier_kernel.require(bare, torch.device("cpu"))   # plain: spec.step
    with pytest.raises(Unsupported, match="no transition for None"):
        frontier_kernel.require(bare, torch.device("cuda"))
    with pytest.raises(Unsupported, match="state size 2"):
        frontier_kernel.require(dataclasses.replace(spec, state_size=2),
                                torch.device("cuda"))
    frontier_kernel.require(spec, torch.device("cuda"))
    frontier_kernel.require(models.Mutex().device_spec(),
                            torch.device("cuda"))


@pytest.mark.parametrize("key", ["cas", "mutex"])
def test_the_pure_table_is_the_models(key):
    # the one table both the kernel and the plain version read
    pm = make_models(key, 0)[1]
    h = port(mutex_history(43) if key == "mutex" else _random_valid()[0])
    pl, t, _, _ = wgl.walk_inputs(pm, prepare(h))
    spec = pm.device_spec()
    want = (torch.zeros_like(t.a_ok) if spec.pure is None
            else spec.pure(t.f, t.a, t.b, t.a_ok))
    assert t.pure.dtype == torch.bool and torch.equal(t.pure, want)
    assert bool(t.pure[:pl.n_calls].any()) is (key == "cas")


def test_the_kernel_steps_are_named():
    assert models.CASRegister().device_spec().device_step == "register"
    assert models.Register().device_spec().device_step == "register"
    assert models.Mutex().device_spec().device_step == "mutex"
    assert set(frontier_kernel.STEPS) == {"register", "mutex"}
