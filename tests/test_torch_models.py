"""jepsen_tpu_torch models against jepsen_tpu's: the enumerated state
space (states, legal, next_state), the decomposition and the packed uop
tables are byte-equal for every model with a device spec."""

import numpy as np
import pytest

from jepsen_tpu import models as ref_models
from jepsen_tpu.ops import planner as ref_planner
from jepsen_tpu_torch import models
from jepsen_tpu_torch.ops import planner

NONE = -(2 ** 31)


def register_uops(vmax, with_cas):
    rows = [(0, 0, 0, 0)]                       # read of an unknown value
    for v in range(vmax + 1):
        rows += [(0, v, 0, 1), (1, v, 0, 1)]
        if with_cas:
            rows += [(2, v, (v * 7 + 3) % (vmax + 1), 1),
                     (2, v, v, 1)]
    return np.asarray(rows, np.int32)


CASES = {
    "cas-register-v3": (models.CASRegister(), ref_models.CASRegister(),
                        register_uops(3, True)),
    "cas-register-v9": (models.CASRegister(), ref_models.CASRegister(),
                        register_uops(9, True)),
    "cas-register-init": (models.CASRegister(2),
                          ref_models.CASRegister(2),
                          register_uops(4, True)),
    "register-v5": (models.Register(), ref_models.Register(),
                    register_uops(5, False)),
    "mutex": (models.Mutex(), ref_models.Mutex(),
              np.asarray([(0, 0, 0, 0), (1, 0, 0, 0)], np.int32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_tables_byte_equal(name):
    model, ref_model, uops = CASES[name]
    spec, ref_spec = model.device_spec(), ref_model.device_spec()
    init = np.asarray(spec.encode(model), np.int32)
    assert init.tobytes() == np.asarray(ref_spec.encode(ref_model),
                                        np.int32).tobytes()
    got = planner._enumerate_states(spec, init, uops, 64)
    want = ref_planner._enumerate_states(ref_spec, init, uops, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    dec = planner._decompose(got[1], got[2])
    ref_dec = ref_planner._decompose(want[1], want[2])
    assert dec[0] is not None
    for g, w in zip(dec, ref_dec):
        assert g.tobytes() == w.tobytes()
    tabs = planner._pack_uop_tables(got[1], got[2], *dec)
    ref_tabs = ref_planner._pack_uop_tables(want[1], want[2], *ref_dec)
    for g, w in zip(tabs, ref_tabs):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_undecomposable_tables_byte_equal():
    # a synthetic relation whose op sends two states to two targets:
    # the nibble form of the uop tables
    legal = np.array([[True, True, False], [True, False, True]])
    nxt = np.array([[1, 2, 0], [0, 0, 0]], np.int32)
    dec = planner._decompose(legal, nxt)
    assert dec == (None, None, None)
    for g, w in zip(planner._pack_uop_tables(legal, nxt, *dec),
                    ref_planner._pack_uop_tables(
                        legal, nxt, *ref_planner._decompose(legal, nxt))):
        assert g.tobytes() == w.tobytes()


def test_state_space_cap_raises_unsupported():
    model = models.CASRegister()
    spec = model.device_spec()
    init = np.asarray(spec.encode(model), np.int32)
    with pytest.raises(planner.Unsupported, match="max_states"):
        planner._enumerate_states(spec, init, register_uops(40, False), 16)


@pytest.mark.parametrize("cls", ["CASRegister", "Register", "Mutex"])
def test_host_step_matches_reference(cls):
    # the host-side step (the CPU oracle's) is the same state machine
    from jepsen_tpu.history import Op as RefOp
    from jepsen_tpu_torch.history import Op
    m, rm = getattr(models, cls)(), getattr(ref_models, cls)()
    fs = (["acquire", "release", "acquire", "acquire"] if cls == "Mutex"
          else ["write", "read", "read", "write", "read"])
    vals = [1, 1, 2, 3, None]
    for f, v in zip(fs, vals):
        m, rm = (m.step(Op(f=f, value=v)), rm.step(RefOp(f=f, value=v)))
        assert models.is_inconsistent(m) == ref_models.is_inconsistent(rm)
        if models.is_inconsistent(m):
            assert m.msg == rm.msg
            break
        assert repr(m).split("(", 1)[1] == repr(rm).split("(", 1)[1]


HOST_MODEL_STEPS = {
    "noop": [("write", 1), ("anything", None), ("read", 7)],
    "unordered-queue": [("enqueue", 3), ("enqueue", "a"), ("enqueue", 3),
                        ("dequeue", 3), ("dequeue", "a"), ("dequeue", 3),
                        ("dequeue", 3)],
    "unordered-queue-bad-f": [("enqueue", 1), ("peek", None)],
    "fifo-queue": [("enqueue", 1), ("enqueue", 2), ("dequeue", 1),
                   ("dequeue", 2), ("dequeue", 2)],
    "fifo-queue-wrong-head": [("enqueue", 1), ("enqueue", 2),
                              ("dequeue", 2)],
    "multi-register": [("txn", [["w", "x", 1], ["w", "y", 2]]),
                       ("txn", [["r", "x", 1], ["r", "y", None]]),
                       ("txn", [["write", "x", 3], ["read", "x", 3]]),
                       ("txn", None), ("txn", [["r", "y", 5]])],
    "multi-register-bad-mop": [("txn", [["append", "x", 1]])],
}


@pytest.mark.parametrize("case", sorted(HOST_MODEL_STEPS))
def test_host_models_step_as_the_reference(case):
    # the four models without a device spec: each step's model (by its
    # dataclass fields) or its inconsistency message equals the reference's
    import dataclasses

    from jepsen_tpu.history import Op as RefOp
    from jepsen_tpu_torch.history import Op
    name = next(n for n in models.MODELS if case.startswith(n))
    m, rm = models.model(name), ref_models.model(name)
    assert m.device_spec() is None and rm.device_spec() is None
    assert type(m).__name__ == type(rm).__name__
    for f, v in HOST_MODEL_STEPS[case]:
        m, rm = m.step(Op(f=f, value=v)), rm.step(RefOp(f=f, value=v))
        assert models.is_inconsistent(m) == ref_models.is_inconsistent(rm)
        if models.is_inconsistent(m):
            assert m.msg == rm.msg
            break
        assert dataclasses.astuple(m) == dataclasses.astuple(rm)


def test_model_registry_and_factories_match_reference():
    assert sorted(models.MODELS) == sorted(ref_models.MODELS)
    for name in models.MODELS:
        assert type(models.model(name)).__name__ == \
            ref_models.MODELS[name].__name__
    for f in ("cas_register", "register", "mutex", "noop",
              "unordered_queue", "fifo_queue"):
        assert type(getattr(models, f)()).__name__ == \
            type(getattr(ref_models, f)()).__name__
    assert models.cas_register(3) == models.CASRegister(3)
