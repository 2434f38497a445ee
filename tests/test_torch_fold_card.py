"""The commutative checkers' kernel `fold_member` (`ops/fold.py`,
`csrc/fold.cu`) on the card against its plain version on the same
tensors, bit for bit: the set checker's four masks, the duplicate
counts and the multiset difference's keep-mask, at the JAX package's
bench size (10^6 elements, every 97th lost) and at their edges (int32
and int64 values past int32 and negative, an empty ys, an empty xs);
and `set_masks`, `duplicate_counts`, `multiset_minus_mask`,
`counter_bounds`, `Set` and `UniqueIds` on the card equal to the CPU
device.  Imports no JAX; skips without a card."""

import numpy as np
import pytest
import torch

from chip_smoke import (FOLD_LOST_EVERY, fold_bench, fold_calls,
                        fold_kernel_cases, ids_history, outputs_err,
                        set_history)
from jepsen_tpu_torch.checker import Set, UniqueIds
from jepsen_tpu_torch.ops import fold

CASES = fold_kernel_cases(77)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_card(case):
    dev = card()
    _, kind, arrays = CASES[case]
    kern, plain, args, _ = fold_calls(kind, arrays, dev)
    launches = fold.LAUNCHES["fold_member"]
    got = kern()
    torch.cuda.synchronize()
    assert outputs_err(got, plain()) == 0
    empty = len(args[0]) + (len(args[1]) if kind == "set" else 0) == 0
    assert fold.LAUNCHES["fold_member"] == launches + (0 if empty else 1)


@pytest.mark.cuda
def test_bench_set_fold_counts_every_lost_element():
    card()
    adds, final = fold_bench()
    masks = fold.set_masks(adds, adds, final)
    assert int(masks[2].sum()) == (len(adds) - 1) // FOLD_LOST_EVERY + 1
    for g, w in zip(masks, fold.set_masks(adds, adds, final, device="cpu")):
        assert np.array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_public_functions_equal_the_cpu(wide):
    card()
    rng = np.random.default_rng(5)
    lim = 2 ** 62 if wide else 5000
    xs = rng.integers(-lim, lim, 30_000)
    ys = np.concatenate([xs[::3], rng.integers(-lim, lim, 5000)])
    for f, args in ((fold.duplicate_counts, (xs,)),
                    (fold.multiset_minus_mask, (xs, ys)),
                    (fold.set_masks, (xs, xs[:20_000], ys))):
        got, want = f(*args), f(*args, device="cpu")
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert np.array_equal(g, w)
    inv, ok = rng.random(1000) < 0.5, rng.random(1000) < 0.5
    v = rng.integers(-9, 9, 1000)
    for g, w in zip(fold.counter_bounds(inv, ok, v),
                    fold.counter_bounds(inv, ok, v, device="cpu")):
        assert np.array_equal(g, w)


@pytest.mark.cuda
def test_checkers_on_card_equal_the_cpu():
    card()
    h, _ = set_history(20_000)
    assert Set().check(None, h) == Set(device="cpu").check(None, h)
    ids, _ = ids_history(20_000)
    assert UniqueIds().check(None, ids) == \
        UniqueIds(device="cpu").check(None, ids)
