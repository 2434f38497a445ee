"""Every route to the serial frontier engine in jepsen_tpu_torch, on the
CPU device, against jepsen_tpu's routes to its own (`Linearizable`'s
`_device_check`, `check_many`'s fallback, `wgl_deep.check_pipeline`'s
stragglers):

- `Linearizable` on a history `wgl_seg.check` refuses (`engine:
  "wgl"`): the residual crash case (valid?, op_index and the frontier
  fields the reference checker's, valid? the CPU oracle's), write
  bursts at R 11..16 at the default max_open_bits and at R 17 and 18
  (valid by construction), and a stale read before a burst at R 12
  (refuted at the read, final-paths rebuilt);
- `check_many` on the residual crash keys of ROADMAP C3 (seeds 304019,
  741828, 767203: True, False, True), fixed here: `engine:
  "fallback"`, the reference's verdict and witness and the CPU
  oracle's; a PreparedHistory key; a caller's `fallback=`; a value
  past int32, which the serial engine refuses and the CPU oracle
  decides, and nothing else: a model the kernel has no transition for
  (on a faked card) and a failing walk raise from the fallback; and
  `independent.batch_checker` over the C3 keys;
- `wgl_deep.check_pipeline` with an R > 16 straggler among in-scope
  histories: the straggler on the serial engine (`engine: "wgl"`), the
  others on the deep grid, every verdict the reference's."""

import dataclasses
import itertools

import pytest
import torch
from test_wgl_deep import burst_history, deep_history
from torch_keys import key_dicts, op

from jepsen_tpu import independent as ref_ind
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import Linearizable as RefLinearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import info_op, invoke_op, ok_op, pack_history
from jepsen_tpu.ops import wgl_cpu as ref_cpu
from jepsen_tpu.ops import wgl_deep as ref_deep
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, independent, models
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.ops import frontier_kernel, wgl, wgl_cpu, wgl_deep, \
    wgl_seg
from jepsen_tpu_torch.ops.prep import PreparedHistory, prepare

#: ROADMAP C3's keys: (seed, calls, concurrency) of
#: key_dicts(..., buggy=0.3, crash_rate=0.15), and the verdict
C3 = [(304019, 34, 6, True), (741828, 38, 5, False), (767203, 31, 6, True)]
FIELDS = ("valid?", "op_index", "op_count", "anomaly", "frontier_size",
          "final_frontier")


def c3_dicts(seed, n, conc):
    return key_dicts(seed, n_calls=n, conc=conc, buggy=0.3,
                     crash_rate=0.15)


def port(h):
    return convert.history_from_dicts(h.to_dicts())


def pick(r):
    return {k: r.get(k) for k in FIELDS}


def residual():
    ops = [invoke_op(9, "write", 0), ok_op(9, "write", 0)]
    ops += [invoke_op(i, "write", i % 3 + 1) for i in range(6)]
    for i in range(6):
        ops += [invoke_op(9, "read", None), ok_op(9, "read", i % 3 + 1),
                invoke_op(8, "write", 0), ok_op(8, "write", 0)]
    ops += [info_op(i, "write", i % 3 + 1) for i in range(6)]
    return RefHistory(ops).index()


# name -> (reference history, Linearizable options)
LINEAR_CASES = {"residual": (residual, {})}
for _R in range(11, 17):
    LINEAR_CASES[f"R{_R}-default-bits"] = (
        lambda R=_R: burst_history(R, seed=5), {})
LINEAR_CASES["R17-past-the-deep-kernel"] = (
    lambda: burst_history(17, seed=5), {"max_open_bits": 18})
LINEAR_CASES["R18-default-bits"] = (lambda: burst_history(18, seed=5), {})
LINEAR_CASES["R12-planted"] = (
    lambda: RefHistory([invoke_op(0, "write", 1), ok_op(0, "write", 1),
                        invoke_op(0, "read", None), ok_op(0, "read", 7)]
                       + burst_history(12, seed=6).ops).index(), {})


@pytest.mark.parametrize("name", sorted(LINEAR_CASES))
def test_linearizable_falls_to_the_serial_engine(name):
    make, kw = LINEAR_CASES[name]
    h = make()
    with pytest.raises(Unsupported, match="ROADMAP P5"):
        wgl_seg.check(models.CASRegister(), port(h), device="cpu",
                      **{k: v for k, v in kw.items()
                         if k == "max_open_bits"})
    got = Linearizable(models.CASRegister(), device="cpu", **kw).check(
        None, port(h))
    assert got["engine"] == got["dispatch"]["engine"] == "wgl"
    assert got["dispatch"]["why"].startswith(
        "serial frontier engine (ops.wgl")
    if name == "R12-planted":
        assert got["valid?"] is False and got["op_index"] == 2
        assert "final-paths" in got          # the checker's rebuild
    elif name == "residual":
        # the reference's own chain reaches its serial engine too
        ref = RefLinearizable(ref_models.CASRegister()).check(None, h)
        assert pick(got) == pick(ref)
        assert got["valid?"] == ref_cpu.check(ref_models.CASRegister(),
                                              h)["valid?"]
    else:
        # a write burst after a valid tail: valid by construction (the
        # CPU oracle's search of a burst this deep takes minutes)
        assert got["valid?"] is True
        assert got["final_frontier"] >= 1


@pytest.fixture(scope="module")
def c3_batch():
    ref_h = [RefHistory(c3_dicts(s, n, c)) for s, n, c, _ in C3]
    port_h = [convert.history_from_dicts(c3_dicts(s, n, c))
              for s, n, c, _ in C3]
    ref = ref_seg.check_many(ref_models.CASRegister(), ref_h)
    stats = {}
    got = wgl_seg.check_many(models.CASRegister(), port_h, device="cpu",
                             stats=stats)
    return ref, got, port_h, stats


@pytest.mark.parametrize("k", range(len(C3)))
def test_c3_keys_through_check_many(c3_batch, k):
    ref, got, port_h, stats = c3_batch
    seed, _, _, want = C3[k]
    assert got[k]["valid?"] is want, seed
    assert got[k]["engine"] == ref[k]["engine"] == "fallback"
    assert got[k]["dispatch"]["why"] == wgl_seg.WHY_FALLBACK
    assert pick(got[k]) == pick(ref[k])
    oracle = wgl_cpu.check(models.CASRegister(), port_h[k])
    assert got[k]["valid?"] == oracle["valid?"]
    if not want:
        assert got[k]["op_index"] == oracle["op_index"] == \
            ref[k]["op_index"]
        assert got[k]["anomaly"] == "nonlinearizable"
    assert "fallback" in stats


@pytest.mark.parametrize("k", range(len(C3)))
def test_c3_keys_through_linearizable(k):
    seed, n, conc, want = C3[k]
    h = convert.history_from_dicts(c3_dicts(seed, n, conc))
    with pytest.raises(Unsupported, match="relaxed refutation"):
        wgl_seg.check(models.CASRegister(), h, device="cpu")
    got = Linearizable(models.CASRegister(), device="cpu").check(None, h)
    ref = RefLinearizable(ref_models.CASRegister()).check(
        None, RefHistory(c3_dicts(seed, n, conc)))
    assert got["valid?"] is want and got["engine"] == "wgl"
    assert pick(got) == pick(ref)


def test_c3_keys_through_the_batch_checker():
    """The C3 keys as the keys of one independent history, each on its
    own processes, with a valid and a planted key beside them."""
    specs = {j: c3_dicts(s, n, c) for j, (s, n, c, _) in enumerate(C3)}
    specs["v"] = key_dicts(31, n_calls=30, conc=5)
    specs["p"] = key_dicts(32, n_calls=30, conc=5, buggy=0.3)
    streams = [[dict(d, process=10 * j + d["process"],
                     value={"__kv__": [k, d["value"]]}) for d in ds]
               for j, (k, ds) in enumerate(specs.items())]
    dicts = [d for group in itertools.zip_longest(*streams) for d in group
             if d is not None]
    dicts = [dict(d, index=j) for j, d in enumerate(dicts)]
    ref = ref_ind.batch_checker(ref_models.CASRegister()).check(
        None, RefHistory(dicts))
    got = independent.batch_checker(models.CASRegister(),
                                    device="cpu").check(
        None, convert.history_from_dicts(dicts))
    assert got["valid?"] is ref["valid?"] is False
    assert got["failures"] == ref["failures"]
    assert 1 in got["failures"]
    for k, r in got["results"].items():
        assert pick(r) == pick(ref["results"][k]), k
    for j in range(len(C3)):
        assert got["results"][j]["engine"] == "fallback"


def test_prepared_history_key_goes_to_the_fallback():
    dicts = key_dicts(2, n_calls=40, conc=5, buggy=0.3)
    ref_h = RefHistory(dicts)
    from jepsen_tpu.ops.prep import prepare as ref_prepare
    ref = ref_seg.check_many(ref_models.CASRegister(),
                             [ref_h, ref_prepare(ref_h)])
    h = convert.history_from_dicts(dicts)
    got = wgl_seg.check_many(models.CASRegister(), [h, prepare(h)],
                             device="cpu")
    assert got[1]["engine"] == ref[1]["engine"] == "fallback"
    assert pick(got[1]) == pick(ref[1])
    assert got[0]["valid?"] is got[1]["valid?"]


def test_a_callers_fallback_decides_the_refused_keys():
    seen = []

    def mine(model, prep):
        assert isinstance(prep, PreparedHistory)
        seen.append(len(prep.calls))
        return {"valid?": "unknown", "engine": "mine"}

    keys = [convert.history_from_dicts(key_dicts(5, n_calls=30, conc=5))]
    keys += [convert.history_from_dicts(c3_dicts(s, n, c))
             for s, n, c, _ in C3[:2]]
    got = wgl_seg.check_many(models.CASRegister(), keys, device="cpu",
                             fallback=mine)
    assert got[0]["engine"] == "wgl_seg_batch_regs"
    assert [r["engine"] for r in got[1:]] == ["mine", "mine"]
    assert got[1]["dispatch"]["engine"] == "mine"
    assert len(seen) == 2

    def bare(model, prep):
        return {"valid?": True}

    got = wgl_seg.check_many(models.CASRegister(), keys[1:], device="cpu",
                             fallback=bare)
    assert all(r["engine"] == "fallback" for r in got)


def test_a_value_past_int32_reaches_the_cpu_oracle(monkeypatch):
    dicts = [op(0, "invoke", "write", 2 ** 40), op(0, "ok", "write", 2 ** 40),
             op(1, "invoke", "read", None), op(1, "ok", "read", 2 ** 33)]
    dicts = [dict(d, index=j) for j, d in enumerate(dicts)]
    calls = []
    check = wgl_cpu.check

    def spy(model, h, **kw):
        calls.append(h)
        return check(model, h, **kw)

    monkeypatch.setattr(wgl_cpu, "check", spy)
    got = wgl_seg.check_many(models.CASRegister(),
                             [convert.history_from_dicts(dicts)],
                             device="cpu", localize=False)
    ref = ref_seg.check_many(ref_models.CASRegister(), [RefHistory(dicts)],
                             localize=False)
    assert got[0]["valid?"] is ref[0]["valid?"] is False
    assert got[0]["engine"] == "fallback"
    assert len(calls) == 1 and isinstance(calls[0], PreparedHistory)
    assert "frontier_size" not in got[0]         # the oracle's map


class NoKernelStep(models.CASRegister):
    """A CAS register whose device spec names no transition the serial
    kernel compiles in (its plain version still steps it)."""

    def device_spec(self):
        return dataclasses.replace(super().device_spec(), device_step=None)


def no_oracle(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the CPU oracle answered a key the serial "
                             "engine did not refuse for its encoding")

    monkeypatch.setattr(wgl_cpu, "check", refuse)


def test_a_kernel_refusal_raises_from_the_fallback(monkeypatch):
    # the default fallback on a card (faked: nothing reaches a tensor)
    # for a model without a kernel transition: Unsupported before the
    # walk's inputs are built, never an answer of the CPU oracle
    no_oracle(monkeypatch)
    monkeypatch.setattr(wgl, "resolve_device",
                        lambda device=None: torch.device("cuda"))

    def built(*a, **kw):
        raise AssertionError("walk inputs built for a refused model")

    monkeypatch.setattr(wgl, "walk_inputs", built)
    h = prepare(convert.history_from_dicts(c3_dicts(*C3[1][:3])))
    fallback = wgl_seg._serial_fallback(torch.device("cuda"))
    with pytest.raises(Unsupported, match="no transition for None"):
        fallback(NoKernelStep(), h)


def test_a_failing_walk_raises_from_check_many(monkeypatch):
    # a C3 key reaches the fallback; a ValueError of the walk itself
    # (here a refused shape) is not answered by the CPU oracle
    no_oracle(monkeypatch)

    def refused(*a, **kw):
        raise ValueError("unsupported walk shape")

    monkeypatch.setattr(frontier_kernel, "walk", refused)
    h = convert.history_from_dicts(c3_dicts(*C3[0][:3]))
    with pytest.raises(ValueError, match="walk shape"):
        wgl_seg.check_many(models.CASRegister(), [h], device="cpu",
                           localize=False)


def test_pipeline_straggler_past_the_deep_kernel():
    hs = [deep_history(100, 14, seed=240, max_open=8), burst_history(17),
          deep_history(90, 6, seed=241, max_open=4),
          RefHistory([invoke_op(0, "write", 1), ok_op(0, "write", 1),
                      invoke_op(0, "read", None), ok_op(0, "read", 8)]
                     + burst_history(17).ops).index()]
    for h in hs:
        h.attach_packed(pack_history(h))
    ref = ref_deep.check_pipeline(ref_models.CASRegister(), hs)
    st = {}
    got = wgl_deep.check_pipeline(models.CASRegister(),
                                  [port(h) for h in hs], device="cpu",
                                  stats=st)
    for i in (0, 2):
        assert got[i]["engine"] == "wgl_deep" and got[i]["pipelined"]
        assert got[i]["valid?"] is ref[i]["valid?"] is True
    for i in (1, 3):
        assert got[i]["engine"] == got[i]["dispatch"]["engine"] == "wgl"
        assert "beyond every batched gate" in got[i]["dispatch"]["why"]
        assert pick(got[i]) == pick(ref[i])
    assert got[1]["valid?"] is True and got[3]["valid?"] is False
    assert got[3]["op_index"] == 2
    assert "stragglers" in st
