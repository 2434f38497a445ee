"""The serial frontier walk: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces `jepsen_tpu/ops/wgl.py::_build_kernel` (:212, an XLA program,
not Pallas: `kernel` :408-503, `closure_tier` :328, `canonicalize`
:271, `dominate` :285, `compact` :305, over `frontier.make_bit_ops` :31
and `make_dedupe_compact` :67).  The walk is just-in-time linearization
over a row frontier: a configuration is one row (mask words over the
open-call slots, one model state), at most F rows.  For each return
event r0 <= r < min(n_events, stop_r):

- the pure fast path: the returning op is pure and legal on every
  config lacking its slot, so nothing changes;
- otherwise the closure in the smallest pool tier (64, 512, F) that
  holds the frontier: rounds that expand every config lacking the
  returning slot by every open candidate it has not linearized, then
  dedupe the pool (parents and children) exactly, in the reference's
  order (valid first, then the mask words, then the state XOR
  0x80000000), truncated to the tier.  A round stops the loop when no
  config lacks the slot, after C rounds, when the distinct count stops
  growing, or at an overflow; an overflow reruns the next tier from the
  event-start frontier, and at the last tier keeps the truncated set
  and raises the overflow flag.  With crash groups (crashed calls on
  permanent slots grouped by identical op), every pool row is first
  canonicalized to its groups' invoke-order prefixes, and after each
  dedupe the configs whose crashed set strictly contains another's
  (same state, same other bits) are dropped (tiers up to 4096); these
  rounds stop at a content fixpoint;
- then the configs lacking the slot are pruned, the rest compacted in
  order, and the slot's bit cleared on every row.

`walk` runs the kernel (`jepsen_tpu_torch/csrc/wgl_frontier.cu`: one
CTA walks one history, its rounds' pools radix-sorted in shared memory,
and where a pool can outgrow that the launch is a cooperative grid of
one CTA an SM that takes the larger rounds; see its note) for CUDA
tensors and the plain version `walk_plain` (the reference kernel's body
step by step on `ops.frontier`'s ops) for CPU tensors; there is no
other route.  Both
take the frontier (masks int32[F, Wd] holding 32-bit words, states
int32[F, S], valid bool[F]) and return new tensors with the outputs
(`out` int32[5]: ok, failed_event, overflow, frontier rows, r).
Which returning op takes the fast path is one host-made table,
`Tables.pure` (the model's `DeviceSpec.pure` over every call), read by
both the kernel and the plain version.  `work`, an optional int64[3],
receives what the walk needed: the
(config, candidate) expansions stepped (fast-path legality tests
included), the sorted row-levels (each dedupe of P valid pool rows
counts P * ceil(log2 P), the comparisons a comparison sort cannot go
below) and the dominance pairs (m^2 for each dominance pass over m
rows).  `LAUNCHES` counts kernel launches; with `RECORD` set,
`LAST_LAUNCH` holds the last launch's CTAs and the rounds each form
took."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.ops import cuda_build, frontier

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"wgl_frontier": 0}
#: When set, each launch also counts its closure rounds by form into
#: LAST_LAUNCH; off, it allocates nothing for them.
RECORD = False
#: The last launch on the card while RECORD was set: "ctas" (1, or the
#: grid's CTAs) and "forms" int64[3], the rounds built and sorted in
#: shared memory, built on the grid and sorted in shared memory, and
#: built and sorted on the grid.
LAST_LAUNCH: dict = {}

#: The closure's pool tiers below F (the reference's TIERS).
TIERS = (64, 512)
#: Dominance runs in tiers of at most this many rows (quadratic).
DOM_TIER_CAP = 4096
#: The transitions the kernel compiles in, by `DeviceSpec.device_step`.
STEPS = {"register": 0, "mutex": 1}
#: Integer operations the bound charges: an expansion (the slot test,
#: the step's compare and select, the bit set), a comparison per key
#: word of a sort, a dominance test per key word.
EXPAND_OPS = 4
CMP_OPS = 2
DOM_OPS = 3
_FULL = 0xFFFFFFFF

class Tables(NamedTuple):
    """The plan on a device: ret_call / ret_slot int32[Rp], cand_call /
    cand_slot int32[Rp, C], and the per-call op encoding f / a / b
    int32[N], a_ok bool[N] (the reference's WGLPlan arrays); pure
    bool[N], the model's `DeviceSpec.pure` of each call (all False
    without one): the calls whose return may take the fast path."""
    ret_call: torch.Tensor
    ret_slot: torch.Tensor
    cand_call: torch.Tensor
    cand_slot: torch.Tensor
    f: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    a_ok: torch.Tensor
    pure: torch.Tensor


def pure_table(spec, f, a, b, a_ok) -> torch.Tensor:
    """bool[N]: `spec.pure` over the calls' encodings (torch tensors),
    all False for a model without a pure test."""
    if spec.pure is None:
        return torch.zeros(f.shape, dtype=torch.bool, device=f.device)
    return torch.as_tensor(spec.pure(f, a, b, a_ok), dtype=torch.bool,
                           device=f.device).expand(f.shape).contiguous()


def require(spec, dev) -> None:
    """Raise Unsupported where the kernel cannot walk `spec`'s model on
    `dev`: a CUDA device and no transition compiled in for it, or a
    state of other than one word.  Nothing to check for the plain
    version, which steps the model's own torch transition."""
    if dev.type == "cuda" and (spec.device_step not in STEPS
                               or spec.state_size != 1):
        raise Unsupported(
            f"the frontier kernel has no transition for "
            f"{spec.device_step!r} at state size {spec.state_size} "
            f"(it compiles in {sorted(STEPS)} at state size 1)")


class Crash(NamedTuple):
    """The crash arguments (the reference's `crash_sizes` and crash
    args): sizes, the bucketed multi-slot group sizes; cw int32[Wd],
    every crashed slot; gws int32[G, Wd], each group's slots; luts
    int32[sum(size + 1), Wd], each group's invoke-order prefixes."""
    sizes: tuple
    cw: torch.Tensor
    gws: torch.Tensor
    luts: torch.Tensor


def tiers(F: int) -> list:
    return [t for t in TIERS if t < F] + [F]


def _ceil_log2(p: int) -> int:
    return (p - 1).bit_length() if p > 1 else 0


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wgl_frontier_launch.argtypes = (
        [ptr] * 9 + [i32] * 4 + [ptr] * 3 + [i32] * 2
        + [ptr] * 4 + [i32] * 2 + [ptr, ctypes.c_longlong]
        + [ptr] * 4 + [ptr])
    lib.wgl_frontier_launch.restype = i32
    lib.wgl_frontier_layout.argtypes = [i32, i32, i32, ptr]
    lib.wgl_frontier_layout.restype = i32


@functools.lru_cache(maxsize=None)
def layout(F: int, C: int, Wd: int) -> dict:
    """The kernel's layout of a walk at (F, C, Wd), from the built
    library: capacity (pool rows a round sorts in shared memory), grid
    (1 for the grid form: a pool can outgrow that), scratch_words,
    smem_bytes, buffer_words, ctas (the launch's, on the current
    device)."""
    lib = cuda_build.load("wgl_frontier", _declare)
    out = (ctypes.c_longlong * 6)()
    err = lib.wgl_frontier_layout(F, C, Wd, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"no wgl_frontier layout at F={F} C={C} Wd={Wd}: "
                         f"cudaError {err}")
    return dict(zip(("capacity", "grid", "scratch_words", "smem_bytes",
                     "buffer_words", "ctas"), (int(x) for x in out)))


def _check(t, name, dtype, dev, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def walk(t: Tables, masks, states, valid, *, r0: int, n_events: int,
         stop_r: int, spec, crash: Optional[Crash] = None,
         work=None) -> dict:
    """Walk events r0..min(n_events, stop_r) of one history from the
    frontier (masks, states, valid), stopping at a death: the plain
    version for CPU tensors, the kernel for CUDA tensors (or raise:
    Unsupported where `require` refuses the model, ValueError for
    tensors of the wrong layout or device).  Returns {"out": int32[5]
    (ok, failed_event, overflow, frontier, r), "final_masks",
    "final_states", "final_valid"} on the device."""
    dev = masks.device
    F, Wd = masks.shape
    S = states.shape[1] if states.dim() == 2 else 0
    Rp, C = t.cand_call.shape
    N = t.f.numel()
    _check(masks, "masks", torch.int32, dev, (F, Wd))
    _check(states, "states", torch.int32, dev, (F, S))
    _check(valid, "valid", torch.bool, dev, (F,))
    for name, x, shape in (("ret_call", t.ret_call, (Rp,)),
                           ("ret_slot", t.ret_slot, (Rp,)),
                           ("cand_call", t.cand_call, (Rp, C)),
                           ("cand_slot", t.cand_slot, (Rp, C)),
                           ("f", t.f, (N,)), ("a", t.a, (N,)),
                           ("b", t.b, (N,))):
        _check(x, name, torch.int32, dev, shape)
    _check(t.a_ok, "a_ok", torch.bool, dev, (N,))
    _check(t.pure, "pure", torch.bool, dev, (N,))
    if crash is not None:
        G = len(crash.sizes)
        _check(crash.cw, "cw", torch.int32, dev, (Wd,))
        _check(crash.gws, "gws", torch.int32, dev, (G, Wd))
        _check(crash.luts, "luts", torch.int32, dev,
               (max(sum(z + 1 for z in crash.sizes), 1), Wd))
    if work is not None:
        _check(work, "work", torch.int64, dev, (3,))
    if not (F >= 1 and Wd >= 1 and S >= 1 and C >= 1 and N >= 1
            and 0 <= r0 and n_events <= Rp):
        raise ValueError(f"unsupported walk shape F={F} Wd={Wd} S={S} "
                         f"C={C} N={N} r0={r0} n_events={n_events} "
                         f"Rp={Rp}")
    if dev.type == "cpu":
        return walk_plain(t, masks, states, valid, r0=r0,
                          n_events=n_events, stop_r=stop_r, step=spec.step,
                          crash=crash, work=work)
    if dev.type != "cuda":
        raise ValueError(f"no frontier kernel for device {dev}")
    require(spec, dev)
    if S != 1:
        raise ValueError(f"states must hold one word a row, got {S}")
    fm, fs, fv = masks.clone(), states.clone(), valid.clone()
    out = torch.empty(5, dtype=torch.int32, device=dev)
    lay = layout(F, C, Wd)
    scratch = torch.empty(lay["scratch_words"], dtype=torch.int32,
                          device=dev)
    sizes = None
    if crash is not None:
        sizes = torch.tensor(list(crash.sizes), dtype=torch.int32,
                             device=dev)
    if work is not None:
        work.zero_()
    forms = torch.zeros(3, dtype=torch.int64, device=dev) if RECORD \
        else None
    ctas = ctypes.c_int(0)
    lib = cuda_build.load("wgl_frontier", _declare)
    err = lib.wgl_frontier_launch(
        t.ret_call.data_ptr(), t.ret_slot.data_ptr(),
        t.cand_call.data_ptr(), t.cand_slot.data_ptr(), t.f.data_ptr(),
        t.a.data_ptr(), t.b.data_ptr(), t.a_ok.data_ptr(),
        t.pure.data_ptr(), C, int(r0), int(n_events), int(stop_r),
        fm.data_ptr(), fs.data_ptr(), fv.data_ptr(), F, Wd,
        None if crash is None else crash.cw.data_ptr(),
        None if crash is None else crash.gws.data_ptr(),
        None if crash is None else crash.luts.data_ptr(),
        None if crash is None else sizes.data_ptr(),
        0 if crash is None else len(crash.sizes),
        STEPS[spec.device_step],
        scratch.data_ptr(), scratch.numel(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        None if forms is None else forms.data_ptr(),
        ctypes.addressof(ctas),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgl_frontier launch failed: cudaError {err} "
                           f"(F={F} Wd={Wd} C={C})")
    LAUNCHES["wgl_frontier"] += 1
    if RECORD:
        LAST_LAUNCH.update(ctas=ctas.value, forms=forms)
    return {"out": out, "final_masks": fm, "final_states": fs,
            "final_valid": fv}


# ---------------------------------------------------------------------------
# The plain version: the reference kernel's body on torch tensors
# ---------------------------------------------------------------------------

def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 element holding a 32-bit word."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _FULL) >> 24


def _as_words(masks: torch.Tensor) -> torch.Tensor:
    return masks.to(torch.int64) & _FULL


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def walk_plain(t: Tables, masks, states, valid, *, r0: int, n_events: int,
               stop_r: int, step, crash: Optional[Crash] = None,
               work=None, pools: Optional[dict] = None) -> dict:
    """The walk in plain PyTorch on masks' device, as the reference's
    kernel computes it (`step` is the DeviceSpec's torch transition).
    Returns what `walk` returns.  `pools`, when given a dict, receives
    the dedupes' pool sizes by power of two: ceil(log2 P) -> [rounds,
    rows] (so the sum of b * rows over it is `work`'s sorted
    row-levels); the entry points never pass it."""
    dev = masks.device
    F, Wd = masks.shape
    S = states.shape[1]
    C = t.cand_call.shape[1]
    has_bit, set_bit, clear_bit = frontier.make_bit_ops(Wd)
    dedupe_compact = frontier.make_dedupe_compact(Wd, S)
    crash_mode = crash is not None
    if crash_mode:
        cw = _as_words(crash.cw)
        gws = _as_words(crash.gws)
        luts = _as_words(crash.luts)
    counts = [0, 0, 0]

    def ops_of(j):
        return t.f[j], t.a[j], t.b[j], t.a_ok[j]

    def step_rows(st, f, a, b, ok):
        """step over rows: st int32[N, S], f/a/b/ok [N]."""
        n = st.shape[0]
        return step(st, f.expand(n) if f.dim() == 0 else f,
                    a.expand(n) if a.dim() == 0 else a,
                    b.expand(n) if b.dim() == 0 else b,
                    ok.expand(n) if ok.dim() == 0 else ok)

    def canonicalize(m):
        off = 0
        for gi, size in enumerate(crash.sizes):
            gw = gws[gi]
            lut = luts[off:off + size + 1]
            cnt = _popcount(m & gw).sum(-1)
            m = (m & (gw ^ _FULL)) | lut[cnt]
            off += size + 1
        return m

    def dominate(m, s, v):
        crash_w = m & cw
        normal = m & (cw ^ _FULL)
        P = m.shape[0]
        eq = v[:, None] & v[None, :]
        for w in range(Wd):
            eq &= normal[:, None, w] == normal[None, :, w]
        for si in range(S):
            eq &= s[:, None, si] == s[None, :, si]
        subset = torch.ones((P, P), dtype=torch.bool, device=dev)
        proper = torch.zeros((P, P), dtype=torch.bool, device=dev)
        for w in range(Wd):
            subset &= (crash_w[:, None, w]
                       & (crash_w[None, :, w] ^ _FULL)) == 0
            proper |= crash_w[:, None, w] != crash_w[None, :, w]
        return v & ~(eq & subset & proper).any(0)

    def repack(m, s, keep, rows):
        pos = torch.cumsum(keep.to(torch.int64), 0) - 1
        om = torch.zeros((rows, Wd), dtype=torch.int64, device=dev)
        os_ = torch.zeros((rows, S), dtype=torch.int32, device=dev)
        om[pos[keep]] = m[keep]
        os_[pos[keep]] = s[keep]
        return om, os_, torch.arange(rows, device=dev) < int(keep.sum())

    def closure_tier(Fb, m, s, v, tslot, cc, cs, cf, ca, cb, cok):
        bm, bs, bv = m[:Fb], s[:Fb], v[:Fb]
        open_c = cc >= 0
        ovf, rounds, progressed, prev = False, 0, True, -1
        while True:
            lacks = bv & ~has_bit(bm, tslot)
            if not (bool(lacks.any()) and rounds < C and progressed
                    and not ovf):
                break
            pm = bm[:, None, :].expand(Fb, C, Wd)
            pslot = cs[None, :].expand(Fb, C)
            st2, legal = step_rows(
                bs[:, None, :].expand(Fb, C, S).reshape(Fb * C, S),
                *(x[None, :].expand(Fb, C).reshape(-1)
                  for x in (cf, ca, cb, cok)))
            not_lin = ~has_bit(pm, pslot)
            expand = lacks[:, None] & open_c[None, :]
            okc = expand & not_lin & legal.reshape(Fb, C)
            pool_m = torch.cat([bm, set_bit(pm, pslot).reshape(Fb * C, Wd)])
            pool_s = torch.cat([bs, st2.to(torch.int32)])
            pool_v = torch.cat([bv, okc.reshape(Fb * C)])
            P = int(pool_v.sum())
            counts[0] += int(expand.sum())
            counts[1] += P * _ceil_log2(P)
            if pools is not None:
                b = pools.setdefault(_ceil_log2(P), [0, 0])
                b[0] += 1
                b[1] += P
            if crash_mode and crash.sizes:
                pool_m = torch.where(pool_v[:, None], canonicalize(pool_m),
                                     pool_m)
            nm, ns, nv, o2, count = dedupe_compact(pool_m, pool_s, pool_v,
                                                   Fb)
            if crash_mode:
                if Fb <= DOM_TIER_CAP:
                    counts[2] += int(nv.sum()) ** 2
                    nv2 = dominate(nm, ns, nv)
                else:
                    nv2 = nv
                nm, ns, nv = repack(nm, ns, nv2, Fb)
                progressed = bool((nm != bm).any() | (ns != bs).any()
                                  | (nv != bv).any())
            else:
                progressed = count > prev
            bm, bs, bv = nm, ns, nv
            ovf = ovf or o2
            rounds += 1
            prev = count
        if Fb == F:
            return bm, bs, bv, ovf
        pm_ = torch.zeros((F, Wd), dtype=torch.int64, device=dev)
        ps_ = torch.zeros((F, S), dtype=torch.int32, device=dev)
        pv_ = torch.zeros(F, dtype=torch.bool, device=dev)
        pm_[:Fb], ps_[:Fb], pv_[:Fb] = bm, bs, bv
        return pm_, ps_, pv_, ovf

    m = _as_words(masks)
    s = states.clone()
    v = valid.clone()
    r = int(r0)
    dead = False
    overflow = False
    while r < n_events and r < stop_r and not dead:
        tslot = int(t.ret_slot[r])
        tcall = int(t.ret_call[r])
        cc = t.cand_call[r]
        cs = t.cand_slot[r].to(torch.int64)
        jc = torch.clamp(cc, min=0).to(torch.int64)
        cf, ca, cb, cok = ops_of(jc)
        lacking = v & ~has_bit(m, tslot)
        fast_ok = False
        jt = max(tcall, 0)
        if bool(t.pure[jt]):
            counts[0] += int(lacking.sum())
            _, legal = step_rows(s, *ops_of(jt))
            fast_ok = bool((~lacking | legal).all())
        ovf = False
        if not fast_ok:
            count = int(v.sum())
            out = None
            ts = tiers(F)
            for i, Fb in enumerate(ts):
                last = i == len(ts) - 1
                if out is not None or not (count <= Fb or last):
                    continue
                res = closure_tier(Fb, m, s, v, tslot, cc, cs, cf, ca, cb,
                                   cok)
                if not res[3] or last:
                    out = res
            m, s, v, ovf = out
            v = v & has_bit(m, tslot)
            m, s, v = repack(m, s, v, F)
        m = clear_bit(m, tslot)
        dead = not bool(v.any())
        overflow = overflow or ovf
        r += 1
    if work is not None:
        work.copy_(torch.tensor(counts, dtype=torch.int64, device=dev))
    out = torch.tensor([int(not dead), r - 1 if dead else -1, int(overflow),
                        int(v.sum()), r], dtype=torch.int32, device=dev)
    return {"out": out, "final_masks": _as_int32(m), "final_states": s,
            "final_valid": v}
