"""jepsen_tpu_torch.independent against jepsen_tpu.independent: the key
split (`history_keys`, `subhistory`) and `batch_checker(model).check`
on one keyed history fed to both packages as op dicts (values tagged
{"__kv__": [k, v]}, as the JAX package's `Op.to_dict()` writes them);
the verdict, the failures and every key's result are the reference's.
The reference's options that need what the port lacks raise
Unsupported naming the ROADMAP item; a Checker with its own
`check_many` (Elle) batches through it, as in the reference."""

import itertools

import pytest
import torch
from test_torch_many import FIELDS
from torch_keys import key_dicts, op

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import convert, independent, models
from jepsen_tpu_torch.checker import Checker, merge_valid
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.history import History


def keyed_dicts(specs, nemesis=True):
    """One history over keys `specs` ({key: key_dicts kwargs}): each key
    on its own five processes, the keys' ops merged round-robin, values
    tagged as independent tuples; a nemesis op at the start and end."""
    streams = []
    for j, (k, kw) in enumerate(specs.items()):
        streams.append([dict(d, process=5 * j + d["process"],
                             value={"__kv__": [k, d["value"]]})
                        for d in key_dicts(**kw)])
    ops = [d for group in itertools.zip_longest(*streams) for d in group
           if d is not None]
    if nemesis:
        ops = ([op("nemesis", "info", "start", None)] + ops
               + [op("nemesis", "info", "stop", None)])
    return [dict(d, index=j) for j, d in enumerate(ops)]


SPECS = {k: dict(seed=700 + k, n_calls=30, conc=5,
                 buggy=0.2 if k in (3, 8) else 0.0) for k in range(10)}
SPECS["x"] = dict(seed=720, n_calls=30, conc=5, crash_rate=0.1)


def both(dicts):
    return RefHistory(dicts), convert.history_from_dicts(dicts)


def test_convert_carries_independent_tuples():
    _, h = both(keyed_dicts(SPECS))
    vals = [o.value for o in h.ops if o.process != "nemesis"]
    assert vals and all(independent.is_tuple(v) for v in vals)
    v = vals[0]
    assert isinstance(v, independent.KV) and v.key == 0
    assert repr(independent.tuple_(1, [2, 3])) == \
        repr(ref_ind.tuple_(1, [2, 3])) == "[1 [2, 3]]"
    assert not independent.is_tuple((1, 2))


def test_tagged_dicts_round_trip_as_the_reference_writes_them():
    """Op dicts tag an independent key's tuple, so a stored keyed
    history keeps its keys (without the tag every key would vanish and
    the check pass trivially)."""
    dicts = keyed_dicts(SPECS)
    ref, h = both(dicts)
    assert h.to_dicts() == ref.to_dicts() == dicts
    again = History(h.to_dicts())
    assert independent.history_keys(again) == set(SPECS)
    assert again.to_dicts() == dicts
    out = independent.batch_checker(models.CASRegister(),
                                    device="cpu").check(None, dicts)
    assert out["failures"] == [3, 8]


def test_history_keys_and_subhistory_match_reference():
    ref, h = both(keyed_dicts(SPECS))
    keys = independent.history_keys(h)
    assert keys == ref_ind.history_keys(ref) == set(SPECS)
    for k in sorted(keys, key=repr):
        got = independent.subhistory(k, h)
        want = ref_ind.subhistory(k, ref)
        assert got.to_dicts() == want.to_dicts()
        assert got.ops[0].f == "start" and got.ops[-1].f == "stop"


@pytest.fixture(scope="module")
def checked():
    ref_h, h = both(keyed_dicts(SPECS))
    ref = ref_ind.batch_checker(ref_models.CASRegister()).check(None, ref_h)
    got = independent.batch_checker(models.CASRegister(),
                                    device="cpu").check(None, h)
    return ref, got


def test_batch_checker_matches_reference(checked):
    ref, got = checked
    assert got["valid?"] is ref["valid?"] is False
    assert got["failures"] == ref["failures"] == [3, 8]
    assert list(got["results"]) == list(ref["results"])
    for k, r in got["results"].items():
        assert {f: r.get(f) for f in FIELDS} == \
            {f: ref["results"][k].get(f) for f in FIELDS}, k
    assert got["results"]["x"]["crashed_ignored"] > 0


def test_batch_checker_is_one_check_many(monkeypatch):
    from jepsen_tpu_torch.ops import wgl_seg
    calls = []
    many = wgl_seg.check_many

    def spy(model, hs, **kw):
        calls.append((len(hs), kw))
        return many(model, hs, **kw)

    monkeypatch.setattr(wgl_seg, "check_many", spy)
    _, h = both(keyed_dicts({k: SPECS[k] for k in (0, 1, 2)}))
    out = independent.batch_checker(models.CASRegister(),
                                    device="cpu").check(None, h)
    assert out == dict(out, **{"valid?": True, "failures": []})
    assert calls == [(3, {"device": "cpu"})]
    assert all(r["engine"] == "wgl_seg_batch_regs"
               for r in out["results"].values())


def test_batch_checker_on_no_keys():
    _, h = both(keyed_dicts({}))
    assert independent.batch_checker(models.CASRegister(),
                                     device="cpu").check(None, h) == \
        {"valid?": True, "results": {}, "failures": []}


def test_refused_options_name_their_roadmap_items():
    m = models.CASRegister()
    with pytest.raises(Unsupported, match="ROADMAP P8"):
        independent.batch_checker(m, mesh=object())
    with pytest.raises(Unsupported, match="ROADMAP P4R"):
        independent.BatchedLinearizableChecker(m, deadline_s=5.0)
    with pytest.raises(Unsupported, match="ROADMAP P4R"):
        independent.BatchedLinearizableChecker(m, max_retries=3)
    _, h = both(keyed_dicts({0: SPECS[0]}))
    with pytest.raises(Unsupported, match="ROADMAP P4R"):
        independent.batch_checker(m, device="cpu").check(
            None, h, {"checkpoint_dir": "ckpt"})


def test_batch_checker_routes_a_batching_checker_as_the_reference(
        monkeypatch):
    """A Checker with its own check_many (Elle) is no longer refused: the
    key split batches through it, as the reference's batch_checker does;
    each key's verdict is the reference's (the dispatch record aside)."""
    from chip_smoke import keyed_list_append

    from jepsen_tpu.checker import elle as ref_elle
    from jepsen_tpu.ops import elle_mesh as ref_mesh
    from jepsen_tpu_torch.checker import elle

    class Batching(Checker):
        def check_many(self, test, histories, opts=None):
            return [{"valid?": len(h) % 2 == 0} for h in histories]

    dicts = keyed_list_append(6, 20, (1, 4), 300)
    rh, h = both(dicts)
    out = independent.batch_checker(Batching()).check(None, h)
    assert out["results"] == {k: {"valid?": len(independent.subhistory(
        k, h)) % 2 == 0} for k in range(6)}
    devices = ref_mesh._devices
    monkeypatch.setattr(ref_mesh, "_devices",
                        lambda d=None, max_devices=None: devices(d, 1))
    for alg in ("auto", "mesh"):
        want = ref_ind.batch_checker(ref_elle.Elle(algorithm=alg)).check(
            None, rh)
        got = independent.batch_checker(
            elle.Elle(algorithm=alg, device="cpu")).check(None, h)
        assert got["failures"] == want["failures"] == [1, 4]
        assert got["valid?"] is want["valid?"] is False
        for k, r in got["results"].items():
            assert {f: v for f, v in r.items()
                    if f not in ("dispatch", "stages")} == \
                {f: v for f, v in want["results"][k].items()
                 if f not in ("dispatch", "stages")}


def test_batch_checker_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, h = both(keyed_dicts({0: SPECS[0]}))
    with pytest.raises(BackendUnavailable):
        independent.batch_checker(models.CASRegister()).check(None, h)


@pytest.mark.parametrize("valids", list(itertools.product(
    [True, False, "unknown"], repeat=3)) + [()])
def test_merge_valid_matches_reference(valids):
    assert merge_valid(valids) == ref_checker.merge_valid(valids)
