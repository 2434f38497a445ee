"""The commutative checkers' set algebra on the card (the JAX package's
`ops/fold.py`).

The reference's commutative checkers (`set`, `unique-ids`, and the
`counter` bounds; `jepsen/src/jepsen/checker.clj:182-233,630-755`) are
O(n) folds over histories.  Here they are sort-based set algebra over
int64 columns: membership, multiplicity, duplicates and the multiset
difference each reduce to `torch.sort` plus binary searches and
compares.  The searches, compares and masks are the hand-written CUDA
kernel `fold_member` (`jepsen_tpu_torch/csrc/fold.cu`), one launch a
call; `counter_bounds` is torch ops (no checker calls it).

Every function takes `device`, the card by default; `device="cpu"` runs
the kernel's plain version (`torch.searchsorted` and compares) on CPU
tensors.  Values narrow to int32 when every value of a call fits, as the
reference's `_narrow` does; otherwise they stay int64, which the
reference's 32-bit JAX mode wraps (ROADMAP Deviations).  `LAUNCHES`
counts kernel launches."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.ops import cuda_build

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"fold_member": 0}

_SET, _DUPS, _MINUS = 0, 1, 2
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _declare(lib):
    lib.fold_member_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    lib.fold_member_launch.restype = ctypes.c_int


def _check(tensors, dev):
    dtype = tensors[0].dtype
    for t in tensors:
        if (t.dtype != dtype or dtype not in (torch.int32, torch.int64)
                or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError(f"values must be contiguous 1-D int32 or int64 "
                             f"tensors of one dtype, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"a tensor is on {t.device}, expected {dev}")


def _launch(mode, xs, ys, order=None, masks=(), counts=None):
    """One launch of fold_member on the card; xs (x0, x1), ys (y0, y1,
    y2) may hold None.  Launches nothing for no x."""
    x0, x1 = xs
    n = len(x0) + (0 if x1 is None else len(x1))
    if n == 0:
        return
    dev = x0.device
    if dev.type != "cuda":
        raise ValueError(f"no fold_member kernel for device {dev}")
    lib = cuda_build.load("fold", _declare)
    ptrs = (ctypes.c_void_p * 11)(*[
        None if t is None else t.data_ptr()
        for t in (x0, x1, *ys, order, *masks, counts)])
    lens = (ctypes.c_int64 * 5)(*[0 if t is None else len(t)
                                  for t in (x0, x1, *ys)])
    err = lib.fold_member_launch(
        mode, int(x0.dtype == torch.int64), ptrs, lens,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fold_member launch failed: cudaError {err} "
                           f"(mode {mode}, {n} values)")
    LAUNCHES["fold_member"] += 1


# ---------------------------------------------------------------------------
# The kernel's wrappers: the plain version for CPU tensors, the kernel for
# CUDA tensors (or raise)
# ---------------------------------------------------------------------------

def set_member(final_read, adds, attempts_s, final_s, adds_s):
    """The set checker's four masks (ok, unexpected, lost, recovered) as
    uint8 tensors: final_read and adds in any order, the other three
    ascending."""
    dev = final_read.device
    _check([final_read, adds, attempts_s, final_s, adds_s], dev)
    if dev.type == "cpu":
        return set_member_plain(final_read, adds, attempts_s, final_s,
                                adds_s)
    nr, na = len(final_read), len(adds)
    out = torch.empty(3 * nr + na, dtype=torch.uint8, device=dev)
    ok, unexpected, lost, recovered = out.split([nr, nr, na, nr])
    _launch(_SET, (final_read, adds), (attempts_s, final_s, adds_s),
            masks=(ok, unexpected, lost, recovered))
    return ok, unexpected, lost, recovered


def dup_member(xs, xs_s):
    """(counts int64, count > 1 as uint8) of each x in xs; xs_s is xs
    ascending."""
    dev = xs.device
    _check([xs, xs_s], dev)
    if dev.type == "cpu":
        return dup_member_plain(xs, xs_s)
    counts = torch.empty(len(xs), dtype=torch.int64, device=dev)
    mask = torch.empty(len(xs), dtype=torch.uint8, device=dev)
    _launch(_DUPS, (xs, None), (xs_s, None, None), masks=(mask, None, None,
                                                         None),
            counts=counts)
    return counts, mask


def minus_member(s, ys_s, order):
    """The multiset difference's keep-mask (uint8) over xs in their own
    order, from s = xs sorted stably, order its permutation (s =
    xs[order]) and ys ascending."""
    dev = s.device
    _check([s, ys_s], dev)
    if order.dtype != torch.int64 or order.shape != s.shape \
            or order.device != dev or not order.is_contiguous():
        raise ValueError("order must be a contiguous int64 tensor shaped "
                         "as s on its device")
    if dev.type == "cpu":
        return minus_member_plain(s, ys_s, order)
    keep = torch.empty(len(s), dtype=torch.uint8, device=dev)
    _launch(_MINUS, (s, None), (ys_s, None, None), order=order,
            masks=(keep, None, None, None))
    return keep


def member_plain(xs, ys_s):
    """x in ys, for each x (bool), ys ascending; all false for empty ys."""
    if len(ys_s) == 0:
        return torch.zeros(xs.shape, dtype=torch.bool, device=xs.device)
    lo = torch.searchsorted(ys_s, xs, side="left")
    return (ys_s[lo.clamp(max=len(ys_s) - 1)] == xs) & (lo < len(ys_s))


def count_plain(xs, ys_s):
    """The multiplicity of each x in ys (int64), ys ascending."""
    return (torch.searchsorted(ys_s, xs, side="right")
            - torch.searchsorted(ys_s, xs, side="left"))


def set_member_plain(final_read, adds, attempts_s, final_s, adds_s):
    ok = member_plain(final_read, attempts_s)
    lost = ~member_plain(adds, final_s)
    recovered = ok & ~member_plain(final_read, adds_s)
    return tuple(m.to(torch.uint8) for m in (ok, ~ok, lost, recovered))


def dup_member_plain(xs, xs_s):
    counts = count_plain(xs, xs_s)
    return counts, (counts > 1).to(torch.uint8)


def minus_member_plain(s, ys_s, order):
    idx = torch.arange(len(s), device=s.device)
    occurrence = idx - torch.searchsorted(s, s, side="left")
    keep = torch.empty(len(s), dtype=torch.uint8, device=s.device)
    keep[order] = (occurrence >= count_plain(s, ys_s)).to(torch.uint8)
    return keep


# ---------------------------------------------------------------------------
# The public functions (the reference's API, plus `device`)
# ---------------------------------------------------------------------------

def _i64(xs) -> np.ndarray:
    if isinstance(xs, np.ndarray):
        return xs.astype(np.int64, copy=False).reshape(-1)
    return np.asarray(list(xs), np.int64).reshape(-1)


def _narrow(*arrs: np.ndarray):
    """A group of int64 arrays as int32 when every value fits: half the
    bytes to the card and through the sorts.  The group narrows together
    so that the searches compare one dtype."""
    for a in arrs:
        if len(a) and (a.min() < _I32_MIN or a.max() > _I32_MAX):
            return arrs
    return tuple(a.astype(np.int32) for a in arrs)


def _to(arrs, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


def all_ints(xs) -> bool:
    return all(isinstance(x, int) and not isinstance(x, bool) for x in xs)


def set_masks(attempts, adds, final_read, device=None):
    """The set checker's masks (ok, unexpected and recovered over
    final_read, lost over adds) as numpy bool arrays; see
    `set_member`."""
    dev = resolve_device(device)
    att, add, read = _to(_narrow(_i64(attempts), _i64(adds),
                                 _i64(final_read)), dev)
    masks = set_member(read, add, torch.sort(att).values,
                       torch.sort(read).values, torch.sort(add).values)
    flat = torch.cat(masks).cpu().numpy().astype(bool)
    nr = len(read)
    return tuple(np.split(flat, [nr, 2 * nr, 2 * nr + len(add)]))


def duplicate_counts(xs, device=None):
    """(multiplicity of each x in xs, int64; multiplicity > 1)."""
    dev = resolve_device(device)
    (x,) = _to(_narrow(_i64(xs)), dev)
    counts, mask = dup_member(x, torch.sort(x).values)
    return counts.cpu().numpy(), mask.cpu().numpy().astype(bool)


def multiset_minus_mask(xs, ys, device=None):
    """Multiset difference xs - ys as a keep-mask over xs: the k-th
    occurrence of a value v in xs (in xs's order) survives iff k >=
    count(v in ys)."""
    dev = resolve_device(device)
    x, y = _to(_narrow(_i64(xs), _i64(ys)), dev)
    s, order = torch.sort(x, stable=True)
    return minus_member(s, torch.sort(y).values,
                        order).cpu().numpy().astype(bool)


def counter_bounds(is_inv_add, is_ok_add, values, device=None):
    """Prefix lower / upper counter bounds after each event
    (checker.clj:678-755): an attempted decrement or an ok'd increment
    moves `lower`; an attempted increment or an ok'd decrement moves
    `upper`.  Torch ops (the reference's is an XLA program no checker
    calls)."""
    dev = resolve_device(device)
    inv, ok = _to([np.asarray(is_inv_add, bool),
                   np.asarray(is_ok_add, bool)], dev)
    (v,) = _to([_i64(values)], dev)
    zero = torch.zeros_like(v)
    dl = torch.where(inv & (v < 0), v, zero) + \
        torch.where(ok & (v > 0), v, zero)
    du = torch.where(inv & (v > 0), v, zero) + \
        torch.where(ok & (v < 0), v, zero)
    lo, hi = torch.stack([dl.cumsum(0), du.cumsum(0)]).cpu().numpy()
    return lo, hi
