"""The candidate-table kernels: the CUDA kernels' wrappers, the host
packers of their tables, and their plain PyTorch version.

Replaces `jepsen_tpu/ops/wgl_seg.py::_build_kernel_bits` (:105, B3b)
and `_build_kernel` (:787, B3d), the two XLA scans `_dispatch_kernel`
(:943) picks between.  Both walk the candidate tables of
`planner.plan` (or of `check_many`'s lane keys): per lane (segment k,
entry j) the frontier is the set of configurations (linearized-call
mask m < 2^R, model state s) reachable from (0, j); at each return
event every open call (a candidate: its slot and its op) may be
linearized into the configs lacking its slot, to the fixpoint, and then
the configs lacking the returning slot are pruned and its bit cleared.
T[k, j, s] is whether (0, s) survives the segment's last return.  J = Sn
gives one history's transfer matrices, J = 1 the keys of `check_many`
as lanes entering state 0 (the initial state is interned first).

The kernels (`jepsen_tpu_torch/csrc/wgl_cand.cu`) hold a lane's
frontier as one 64-bit state set per mask, one thread per mask, in
shared memory.  The two entry points differ in how a candidate's
transition arrives:

- `cand_bits` (kernel `wgl_cand_bits`): per-candidate tables of
  `planner._pack_cand_tables` ([L, K, C], gathered on the host): a
  decomposed model's diagonal and rank-1 state masks and rank-1 target
  (Sn <= 32), or an undecomposed one's legal mask and next states in
  nibbles (Sn <= 8).
- `cand_dense` (kernel `wgl_cand_dense`): per-candidate uop ids and the
  per-uop tables of `dense_tables`: the diagonal and rank-1 masks and
  target, or the legal mask and a next-state row [Sn], up to 64 states.

Closures run to their fixpoint (at most R rounds); the reference's
dense scan stops by Lowe's rule, which gives the same transfer rows.
The wrappers take the plain version (`walk_plain`) only for tensors on
the CPU; for CUDA tensors they launch the kernel on the current stream
or raise.  `LAUNCHES` counts each kernel's launches."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jepsen_tpu_torch.ops import cuda_build, planner

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"wgl_cand_bits": 0, "wgl_cand_dense": 0}

#: Candidates of one return row the kernels take (the open calls, at most
#: R <= 10, padded to a power of two by `plan`).
C_MAX = 16
#: Integer operations of the bound model, per (live candidate, mask) of a
#: closure round where the mask holds the candidate's slot and the partner
#: set is not empty, per 32-bit word of the state set: the slot test, the
#: partner index, the load, the diagonal and rank-1 selects, the test, the
#: target bit and the OR.  An undecomposed transition adds NEXT_OPS per
#: legal state the partner set holds (the next-state load, the shift, the
#: OR).  Every other (live candidate, mask) of a round costs SKIP_OPS (the
#: slot test).
CAND_OPS = 8
NEXT_OPS = 3
SKIP_OPS = 1
#: Per mask and word of a prune: the slot test, the partner load, the
#: select.
PRUNE_OPS = 3


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wgl_cand_launch.argtypes = ([i32] + [ptr] * 7 + [i32] * 7
                                    + [ptr] * 3)
    lib.wgl_cand_launch.restype = i32


def dense_tables(legal: np.ndarray, next_state: np.ndarray, diag_w, const_w,
                 const_t0):
    """The dense kernel's per-uop tables: tab int64[U, 3] (decomposed:
    the diagonal mask, the rank-1 mask and target; undecomposed: the
    legal mask, 0, 0; bit s = state s, up to 64 states) and nxt
    uint8[U, Sn] (the next state of each legal state; empty for a
    decomposed model)."""
    U, Sn = legal.shape
    pw = np.left_shift(np.uint64(1), np.arange(Sn, dtype=np.uint64))

    def bits(x):
        return ((np.asarray(x) > 0).astype(np.uint64) * pw).sum(
            1, dtype=np.uint64).view(np.int64)

    tab = np.zeros((U, 3), np.int64)
    if diag_w is not None:
        tab[:, 0], tab[:, 1] = bits(diag_w), bits(const_w)
        tab[:, 2] = const_t0
        nxt = np.zeros((U, 0), np.uint8)
    else:
        tab[:, 0] = bits(legal)
        nxt = np.where(legal, next_state, 0).astype(np.uint8)
    return tab, np.ascontiguousarray(nxt)


def bits_tables(cand_uop_t: np.ndarray, legal, next_state, diag_w, const_w,
                const_t0):
    """`planner._pack_cand_tables` of [L, K, C] candidates as the bits
    kernel's int32 tables (aux1, aux2 bit patterns, t0)."""
    a1, a2, t0 = planner._pack_cand_tables(cand_uop_t, legal, next_state,
                                           diag_w, const_w, const_t0)
    return (a1.astype(np.uint32).view(np.int32),
            a2.astype(np.uint32).view(np.int32), t0.astype(np.int32))


def _check2(t, name, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != dev):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _shape(ret, cslot, *, R, Sn, J):
    dev = ret.device
    if ret.dim() != 2 or cslot.dim() != 3:
        raise ValueError("ret must be [L, K] and cslot [L, K, C]")
    L, K = ret.shape
    C = cslot.shape[2]
    _check2(ret, "ret", torch.int32, (L, K), dev)
    _check2(cslot, "cslot", torch.int32, (L, K, C), dev)
    if not (1 <= R <= planner.CAND_R_MAX and 1 <= Sn <= planner.CAND_SN_MAX
            and J in (1, Sn) and 1 <= C <= C_MAX and K >= 1 and L >= 1):
        raise ValueError(f"unsupported candidate-table shape R={R} Sn={Sn} "
                         f"J={J} C={C} K={K} L={L}")
    return dev, L, K, C


def cand_bits(ret, cslot, aux1, aux2, t0, *, R: int, Sn: int, J: int,
              decomposed: bool):
    """Transfer rows u8[K, J, Sn] of the bits form: ret int32[L, K]
    (returning slot, -1 for none), cslot int32[L, K, C] and the
    per-candidate int32 tables of `bits_tables` (decomposed with Sn <=
    32, or the nibble form with Sn <= 8).  Returns (T, bad int32[1]): bad
    counts CTAs the kernel refused (a slot at or past R), whose rows it
    did not write; on the CPU such input raises instead."""
    dev, L, K, C = _shape(ret, cslot, R=R, Sn=Sn, J=J)
    for name, x in (("aux1", aux1), ("aux2", aux2), ("t0", t0)):
        _check2(x, name, torch.int32, (L, K, C), dev)
    if Sn > (32 if decomposed else 8):
        raise ValueError(f"the bits form takes Sn <= 32 decomposed or <= 8 "
                         f"undecomposed, got Sn={Sn}")
    form = 0 if decomposed else 1
    if dev.type == "cpu":
        return (walk_plain(ret, cslot, _bits_params(aux1, aux2, t0,
                                                    decomposed, Sn),
                           R=R, Sn=Sn, J=J),
                torch.zeros(1, dtype=torch.int32))
    return _launch("wgl_cand_bits", form, ret, cslot, aux1, aux2, t0, None,
                   None, 0, R=R, Sn=Sn, J=J)


def cand_dense(ret, cslot, cuop, tab, nxt, *, R: int, Sn: int, J: int):
    """Transfer rows u8[K, J, Sn] of the dense form: ret int32[L, K],
    cslot and cuop int32[L, K, C] (uop id, -1 for none), and the per-uop
    tables of `dense_tables` (tab int64[U, 3]; nxt uint8[U, Sn] for an
    undecomposed model, [U, 0] for a decomposed one), up to 64 states.
    Returns (T, bad int32[1]): bad counts CTAs the kernel refused (a slot
    at or past R, a uop outside the table); on the CPU such input raises
    instead."""
    dev, L, K, C = _shape(ret, cslot, R=R, Sn=Sn, J=J)
    _check2(cuop, "cuop", torch.int32, (L, K, C), dev)
    U = tab.shape[0]
    _check2(tab, "tab", torch.int64, (U, 3), dev)
    decomposed = nxt.shape[1] == 0
    _check2(nxt, "nxt", torch.uint8, (U, 0 if decomposed else Sn), dev)
    form = 2 if decomposed else 3
    if dev.type == "cpu":
        return (walk_plain(ret, cslot, _dense_params(cuop, tab, nxt, Sn),
                           R=R, Sn=Sn, J=J),
                torch.zeros(1, dtype=torch.int32))
    return _launch("wgl_cand_dense", form, ret, cslot, cuop, None, None, tab,
                   nxt, U, R=R, Sn=Sn, J=J)


def _launch(name, form, ret, cslot, c1, c2, c3, tab, nxt, U, *, R, Sn, J):
    dev = ret.device
    if dev.type != "cuda":
        raise ValueError(f"no candidate-table kernel for device {dev}")
    L, K = ret.shape
    C = cslot.shape[2]
    out = torch.empty((K, J, Sn), dtype=torch.uint8, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = cuda_build.load("wgl_cand", _declare)

    def p(x):
        return None if x is None else x.data_ptr()

    err = lib.wgl_cand_launch(
        form, p(ret), p(cslot), p(c1), p(c2), p(c3), p(tab), p(nxt), U, L,
        K, C, R, Sn, J, out.data_ptr(), bad.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} (L={L} "
                           f"K={K} C={C} R={R} Sn={Sn} J={J})")
    LAUNCHES[name] += 1
    return out, bad


# ---------------------------------------------------------------------------
# The plain version: the same walk in PyTorch, every lane at once
# ---------------------------------------------------------------------------

def _bits_params(aux1, aux2, t0, decomposed: bool, Sn: int):
    """Each candidate's transition (int64 [L, K, C] tensors) from the bits
    form's tables: ("dec", diag, const, t0) or ("tab", legal, next
    [L, K, C, Sn])."""
    m32 = 0xFFFFFFFF
    a1 = aux1.to(torch.int64) & m32
    a2 = aux2.to(torch.int64) & m32
    if decomposed:
        return ("dec", a1, a2, t0.to(torch.int64))
    s = torch.arange(Sn, device=aux1.device)
    nx = (a2[..., None] >> (4 * s)) & 15
    return ("tab", a1, nx)


def _dense_params(cuop, tab, nxt, Sn: int):
    """Each candidate's transition from the dense form's uop tables; a
    candidate -1 gets zero masks.  Raises ValueError on a uop outside the
    table."""
    U = tab.shape[0]
    if bool((cuop >= U).any()):
        raise ValueError("a candidate names a uop outside the table")
    live = cuop >= 0
    u = cuop.clamp(0, max(U - 1, 0)).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=cuop.device)
    g = tab[u]                                         # [L, K, C, 3]
    a = torch.where(live, g[..., 0], zero)
    if nxt.shape[1] == 0:
        b = torch.where(live, g[..., 1], zero)
        return ("dec", a, b, g[..., 2])
    return ("tab", a, nxt[u].to(torch.int64))


def _trans(src, p, r: int, k, c: int):
    """The states a candidate's op reaches from the state sets src
    (int64 [N, M], lane n in segment k[n]): its transition's image of
    each set, and for an undecomposed transition the number of legal
    states each set holds (None for a decomposed one)."""
    zero = torch.zeros((), dtype=torch.int64, device=src.device)
    if p[0] == "dec":
        d, cm, t0 = (x[r, k, c, None] for x in p[1:])
        return (src & d) | torch.where((src & cm) != 0,
                                       torch.bitwise_left_shift(
                                           torch.ones_like(t0), t0),
                                       zero), None
    x = src & p[1][r, k, c, None]
    nx = p[2][r, k, c]                                 # [N, Sn]
    out = torch.zeros_like(src)
    cnt = torch.zeros_like(src)
    for s in range(nx.shape[1]):
        on = (x >> s) & 1
        bit = torch.bitwise_left_shift(torch.ones_like(nx[:, s]), nx[:, s])
        out = out | torch.where(on != 0, bit[:, None], zero)
        cnt += on
    return out, cnt


def walk_plain(ret, cslot, params, *, R: int, Sn: int, J: int,
               need: torch.Tensor | None = None):
    """The kernels' function in plain PyTorch on ret's device: every lane
    (k, j) walks its rows in step, its frontier int64[M] state sets (bit
    s = state s, M = 2^R masks); each row's rounds are Jacobi rounds of
    every candidate, to the fixpoint (at most R), then the prune and
    retirement of the returning slot.  A lane whose sets are all empty
    stays so, and is left out of the rows that follow; lanes of one
    segment whose sets are equal are walked once a row.  `need`, an
    optional int64[K], receives each segment's integer operations summed
    over its J lanes, for the lanes not yet empty: in each round up to
    the first that leaves the lane unchanged, per live candidate and
    mask, CAND_OPS per word where the mask holds the candidate's slot and
    the partner set is not empty (NEXT_OPS more per legal state that set
    holds, for an undecomposed transition), else SKIP_OPS; PRUNE_OPS per
    mask and word of a prune.  Raises ValueError on a live candidate's
    slot at or past R."""
    dev = ret.device
    L, K = ret.shape
    C = cslot.shape[2]
    M = 1 << R
    m_idx = torch.arange(M, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    live = _live(params)                               # [L, K, C]
    if bool(((cslot < 0) | (cslot >= R))[live].any()) \
            or bool((ret >= R).any()):
        raise ValueError("a candidate or return names a slot past R")
    N = K * J
    lane_k = torch.arange(K, device=dev).repeat_interleave(J)
    S = torch.zeros((N, M), dtype=torch.int64, device=dev)
    S[:, 0] = 1 if J == 1 else torch.bitwise_left_shift(
        torch.ones(N, dtype=torch.int64, device=dev),
        torch.arange(N, device=dev) % J)
    words = 1 if Sn <= 32 else 2
    ops = torch.zeros(N, dtype=torch.int64, device=dev)
    sl = cslot.to(torch.int64).clamp(0, R - 1)
    for r in range(L):
        act = (S != 0).any(1).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        # lanes of one segment whose sets are equal stay equal: walk each
        # such group once
        uq, inv = torch.unique(torch.cat([lane_k[act, None], S[act]], 1),
                               dim=0, return_inverse=True)
        k, sub = uq[:, 0], uq[:, 1:]
        cost = torch.zeros(k.numel(), dtype=torch.int64, device=dev)
        lv = live[r, k]                                # [n, C]
        run = lv.any(1)
        for _ in range(R if bool(run.any()) else 0):
            add = torch.zeros_like(sub)
            for c in range(C):
                lc = lv[:, c]
                if not bool(lc.any()):
                    continue
                b = sl[r, k, c]                        # [n]
                has = ((m_idx[None] >> b[:, None]) & 1) != 0   # [n, M]
                idx = m_idx[None] ^ torch.bitwise_left_shift(
                    torch.ones_like(b), b)[:, None]
                src = sub.gather(1, idx)
                new, cnt = _trans(src, params, r, k, c)
                ok = has & lc[:, None]
                add = add | torch.where(ok, new, zero)
                if need is not None:
                    full = CAND_OPS * words + (0 if cnt is None
                                               else NEXT_OPS * cnt)
                    per = torch.where(ok & (src != 0), full, SKIP_OPS)
                    cost += torch.where(lc & run, per.sum(1), 0)
            grew = ((add & ~sub) != 0).any(1)
            sub = sub | add
            run = run & grew
            if not bool(run.any()):
                break
        rs = ret[r, k].to(torch.int64)
        on = rs >= 0
        if bool(on.any()):
            b = rs.clamp(0, R - 1)
            has = ((m_idx[None] >> b[:, None]) & 1) != 0
            idx = m_idx[None] | torch.bitwise_left_shift(
                torch.ones_like(b), b)[:, None]
            cleared = torch.where(has, zero, sub.gather(1, idx))
            sub = torch.where(on[:, None], cleared, sub)
            cost += torch.where(on, PRUNE_OPS * words * M, 0)
        S[act] = sub[inv]
        ops.index_add_(0, act, cost[inv])
    if need is not None:
        need.copy_(ops.view(K, J).sum(1))
    s_idx = torch.arange(Sn, device=dev)
    return ((S.view(K, J, M)[:, :, 0, None] >> s_idx) & 1).to(torch.uint8)


def _live(params) -> torch.Tensor:
    """Where a candidate can move a config: a nonzero mask."""
    if params[0] == "dec":
        return (params[1] != 0) | (params[2] != 0)
    return params[1] != 0
