"""The whole slice: jepsen_tpu_torch's Linearizable checker on the CPU
device against jepsen_tpu's wgl_seg.check (the deep Pallas kernel, run
by the interpreter, at R >= 7; the register-delta segment kernel at
R <= 6) and its exact CPU oracle, on histories carried across by
convert.history_from_dicts.  valid?, engine, anomaly, op_index and
op["f"] are equal exactly on valid, corrupted and subtle stale-read
histories."""

import pytest
from test_wgl_deep import burst_history, corrupt, deep_history

from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import invoke_op, ok_op, pack_history
from jepsen_tpu.ops import wgl_cpu as ref_cpu
from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.checker import Linearizable, linearizable
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.ops import wgl_seg


def subtle_stale_read():
    # after a deep prefix quiesces, write 2 then read 1 strictly in
    # sequence: an in-domain value no pending write can explain
    h = deep_history(140, 14, seed=91, vmax=2, max_open=8)
    tail = [invoke_op(0, "write", 2), ok_op(0, "write", 2),
            invoke_op(1, "read", None), ok_op(1, "read", 1)]
    h2 = RefHistory(h.ops + tail).index()
    h2.attach_packed(pack_history(h2))
    return h2


CASES = {
    "r7-valid": lambda: deep_history(120, 14, seed=57, max_open=7),
    "r9-valid": lambda: deep_history(120, 14, seed=59, max_open=9),
    "r7-corrupt": lambda: corrupt(deep_history(140, 14, seed=77,
                                               max_open=7), 0.6),
    "r9-corrupt": lambda: corrupt(deep_history(140, 14, seed=79,
                                               max_open=9), 0.8),
    "r10-corrupt": lambda: corrupt(deep_history(140, 14, seed=80,
                                                max_open=10), 0.9),
    "subtle-stale-read": subtle_stale_read,
    "r4-corrupt": lambda: corrupt(deep_history(120, 6, seed=3,
                                               max_open=4), 0.5),
    "r12-burst-valid": lambda: burst_history(12, seed=4),
}


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, make in CASES.items():
        h = make()
        ref = ref_seg.check(ref_models.CASRegister(), h, max_open_bits=14)
        oracle = ref_cpu.check(ref_models.CASRegister(), h)
        ph = convert.history_from_dicts(h.to_dicts())
        got = Linearizable(models.CASRegister(), device="cpu",
                           max_open_bits=14).check(None, ph)
        out[name] = (ref, oracle, got)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_linearizable_matches_reference(results, name):
    ref, oracle, got = results[name]
    assert got["valid?"] is ref["valid?"] is oracle["valid?"]
    assert got["engine"] == ref["engine"]
    assert got["dispatch"]["engine"] == ref["engine"]
    assert ref["engine"] == ("wgl_seg" if got["max_open"] <= 6
                             else "wgl_deep")
    assert got.get("anomaly") == ref.get("anomaly")
    assert got.get("op_index") == ref.get("op_index") \
        == oracle.get("op_index")
    if got["valid?"] is False:
        assert got["op"]["f"] == ref["op"]["f"] == oracle["op"]["f"]
        assert got["final-paths"] and got["configs"]
    assert got["valid?"] is ("valid" in name)


def test_shallow_history_reports_its_route(results):
    ref, _, got = results["r4-corrupt"]
    assert ref["engine"] == got["engine"] == "wgl_seg"
    assert got["max_open"] <= 6
    assert "segment kernel" in got["dispatch"]["why"]
    assert got["segments"] == ref["segments"]
    assert got["dead_segment"] == ref["dead_segment"]


def test_cpu_algorithm_is_the_oracle(results):
    h = CASES["r9-corrupt"]()
    ph = convert.history_from_dicts(h.to_dicts())
    got = linearizable({"model": models.CASRegister(),
                        "algorithm": "cpu"}).check(None, ph)
    assert got["op_index"] == results["r9-corrupt"][1]["op_index"]
    assert "engine" not in got


def test_default_max_open_bits_refuses_deeper_histories():
    # the batched engines refuse R = 12 at the default max_open_bits;
    # the checker then runs the serial frontier engine, as the
    # reference's _device_check does
    h = burst_history(12, seed=4)
    ph = convert.history_from_dicts(h.to_dicts())
    with pytest.raises(Unsupported, match="max_open_bits=10"):
        wgl_seg.check(models.CASRegister(), ph, device="cpu")
    got = Linearizable(models.CASRegister(), device="cpu").check(None, ph)
    assert got["engine"] == got["dispatch"]["engine"] == "wgl"
    assert "max_open_bits=10" in got["dispatch"]["why"]
    assert got["valid?"] is ref_cpu.check(ref_models.CASRegister(),
                                          h)["valid?"] is True


def test_checker_options_are_validated():
    # frontier_sizes and pad are the serial engine's (the reference's
    # serial keys); its other keywords are not checker options there
    Linearizable(models.CASRegister(), frontier_sizes=(64,), pad=False)
    with pytest.raises(TypeError):
        Linearizable(models.CASRegister(), events_per_call=4)
    with pytest.raises(ValueError):
        Linearizable(None)
    with pytest.raises(Unsupported, match="P6"):
        Linearizable(models.CASRegister(), algorithm="competition")
