"""The port's commutative-checker algebra (`jepsen_tpu_torch.ops.fold`,
the kernel `fold_member`'s plain version on the CPU) against the JAX
package's `ops/fold.py` on the same seeded inputs, exactly: the set
checker's four masks, duplicate counts, the multiset difference's
keep-mask, the counter bounds and `all_ints`; int32 values, negative
ones, int64 values past int32 (the reference under `jax.enable_x64`,
since its 32-bit mode wraps them), duplicates and the empty cases.
The wrappers' own rules: the plain version only for CPU tensors, no
launch counted there, dtype and device checks, and no device without
`device="cpu"`."""

import jax
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import fold as ref_fold
from jepsen_tpu_torch.errors import BackendUnavailable
from jepsen_tpu_torch.ops import fold

WIDE = 2 ** 62


def values(seed, n, lim):
    return np.random.default_rng(seed).integers(-lim, lim, n)


def reference(f, *args, wide=False):
    """The reference's f, with JAX's 64-bit mode for values past int32."""
    if wide:
        with jax.enable_x64(True):
            return f(*args)
    return f(*args)


def equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


SIZES = [0, 1, 7, 300, 5000]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("wide", [False, True])
def test_set_masks_match_reference(n, wide):
    lim = WIDE if wide else 40
    att = values(n + 1, n, lim)
    adds = att[: n // 2]
    final = np.concatenate([att[n // 3:], values(n + 2, n // 4, lim)])
    equal(fold.set_masks(att, adds, final, device="cpu"),
          reference(ref_fold.set_masks, att, adds, final, wide=wide))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("wide", [False, True])
def test_duplicate_counts_match_reference(n, wide):
    xs = values(n + 3, n, WIDE if wide else 25)
    if wide and n:
        xs = np.concatenate([xs, xs[::5]])
    got = fold.duplicate_counts(xs, device="cpu")
    equal(got, reference(ref_fold.duplicate_counts, xs, wide=wide))
    assert got[0].dtype == np.int64 and got[1].dtype == bool


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("wide", [False, True])
def test_multiset_minus_mask_matches_reference(n, wide):
    lim = WIDE if wide else 9
    xs = values(n + 4, n, lim)
    if wide and n:
        xs = np.concatenate([xs, xs[::3], xs[::7]])
    ys = np.concatenate([xs[::2], values(n + 5, n // 3, lim)])
    equal(fold.multiset_minus_mask(xs, ys, device="cpu"),
          reference(ref_fold.multiset_minus_mask, xs, ys, wide=wide))


@pytest.mark.parametrize("xs,ys", [([], []), ([], [1, 2]), ([3, 1, 3], []),
                                   ([5, 5, 5], [5]), ([2, -7], [-7, -7])])
def test_multiset_minus_mask_edges(xs, ys):
    equal(fold.multiset_minus_mask(xs, ys, device="cpu"),
          ref_fold.multiset_minus_mask(xs, ys))


def test_the_wide_values_the_reference_wraps():
    # 2^40 and 2^40 + 2^32 agree in their low 32 bits: the reference's
    # 32-bit mode counts them as one value, the port as two
    xs = [1, 1, 2, 2 ** 40, 2 ** 40 + 2 ** 32]
    counts, mask = fold.duplicate_counts(xs, device="cpu")
    assert counts.tolist() == [2, 2, 1, 1, 1]
    assert mask.tolist() == [True, True, False, False, False]
    assert ref_fold.duplicate_counts(xs)[0].tolist() == [2, 2, 1, 2, 2]
    equal((counts, mask), reference(ref_fold.duplicate_counts, xs,
                                    wide=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_bounds_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    inv, ok = rng.random(n) < 0.5, rng.random(n) < 0.4
    v = rng.integers(-50, 50, n)
    equal(fold.counter_bounds(inv, ok, v, device="cpu"),
          ref_fold.counter_bounds(inv, ok, v))


def test_counter_bounds_empty():
    equal(fold.counter_bounds([], [], [], device="cpu"),
          ref_fold.counter_bounds([], [], []))


@pytest.mark.parametrize("xs", [[], [1, 2], [True, 1], [1.0], [1, None],
                                [2 ** 70], ["a"]])
def test_all_ints_matches_reference(xs):
    assert fold.all_ints(xs) == ref_fold.all_ints(xs)


def test_narrowing_matches_reference():
    for arrs in ([np.array([1, -2 ** 31])], [np.array([2 ** 31]),
                                              np.array([0])],
                 [np.array([], np.int64)]):
        got, want = fold._narrow(*arrs), ref_fold._narrow(*arrs)
        assert [a.dtype for a in got] == [a.dtype for a in want]


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    x = torch.tensor([3, 1, 3, 9], dtype=torch.int32)
    s = torch.sort(x).values
    before = fold.LAUNCHES["fold_member"]
    masks = fold.set_member(x, x[:2], s, s, torch.sort(x[:2]).values)
    assert [m.dtype for m in masks] == [torch.uint8] * 4
    counts, mask = fold.dup_member(x, s)
    assert counts.tolist() == [2, 1, 2, 1] and mask.tolist() == [1, 0, 1, 0]
    ss, order = torch.sort(x, stable=True)
    keep = fold.minus_member(ss, torch.tensor([3], dtype=torch.int32), order)
    assert keep.tolist() == [0, 1, 1, 1]
    assert fold.LAUNCHES["fold_member"] == before


def test_wrappers_check_their_inputs():
    x32 = torch.tensor([1, 2], dtype=torch.int32)
    x64 = x32.to(torch.int64)
    with pytest.raises(ValueError):
        fold.dup_member(x32, x64)
    with pytest.raises(ValueError):
        fold.dup_member(x32.float(), x32.float())
    with pytest.raises(ValueError):
        fold.minus_member(x32, x32, x32)


def test_no_device_without_asking_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: fold.set_masks([1], [1], [1]),
                 lambda: fold.duplicate_counts([1]),
                 lambda: fold.multiset_minus_mask([1], [1]),
                 lambda: fold.counter_bounds([True], [False], [1])):
        with pytest.raises(BackendUnavailable):
            call()
