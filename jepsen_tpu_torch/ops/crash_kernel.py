"""The segment kernel's crash variants: the CUDA kernel's wrappers and
their plain PyTorch version.

Replaces the `nc > 0`, `crash_closure` and `death_row` variants of
`jepsen_tpu/ops/wgl_seg.py::_build_kernel_regs` (:258; :290-316,
:324-462, :474-484) with the composed relaxed wrapper
`_build_kernel_regs_relaxed` (:564).  Three functions of one walk over
a segment's event rows (`jepsen_tpu_torch/csrc/wgl_crash.cu`):

- `crash_scan` (kernel `wgl_regs_crash`): nc crashed calls ride as
  permanent slots rn..rn+nc-1, registered like invokes and never
  retired.  Lane j = cm * Sn + s enters in state s with the crashed
  calls of cm linearized (mask cm << rn), and its transfer row reads
  the 2^nc crashed-mask planes at zero normal bits: T[K, J, J] with
  J = Sn * 2^nc.
- `relaxed_scan` (kernel `wgl_regs_relaxed`): nc = 0, J = Sn; each row
  carries an index into a table of per-state masks (`ctab[nC, Sn, W]`,
  reflexive and transitive closures built on the host), and the row's
  mask closes the plane's states before the first round and after
  every round.  Past 32 states (up to 64) every state mask (the aux
  table's, the closures', the death row's seed) takes W = 2 words, state
  s in word s // 32 (the reference's `sn_words=2` lift, B2w); the
  kernel then runs two state rows a thread.
- `death_row` (the same kernel): one lane seeded with a set of states
  at mask 0 walks one segment with the closure and reports the first
  row at which its plane empties (-1 if it never does).

All three run to the fixpoint that R rounds (R counting the crashed
slots) reach, so a closure pass may update the plane in place: a round
then holds at least what the reference's Jacobi round holds and no more
than the fixpoint, so the transfer rows are equal bit for bit, and a
row's rounds end early once a round changes no lane of a warp.  The
`work=` count is the integer operations each lane needs (the constants
below, over the Sn state rows that hold configs): its rounds up to the
first that leaves its plane unchanged, at most R.

The `work=` count charges a closure at every row and in every round,
and the kernel is held to it; `walk_plain`'s `need` count charges only
the closures that can change the plane (at a row whose masks let a
state jump, in a round whose passes changed the lane), and the bound is
taken from it.

The kernel runs one thread per (lane, state row), a lane's SnP threads
in one warp, a segment's lanes over CTAs of at most 128 threads.  The
wrappers take the plain version (`walk_plain`) only for tensors on the
CPU; for CUDA tensors they launch the kernel on the current stream or
raise.  `LAUNCHES` counts each kernel's launches."""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch.ops import cuda_build, planner
from jepsen_tpu_torch.ops import regs_kernel as rk
from jepsen_tpu_torch.ops.deep_kernel import _FULL, _check
from jepsen_tpu_torch.ops.wgl_deep import _snp as snp

#: Kernel launches since import (or since a caller reset them to 0);
#: "wgl_regs_relaxed_w2" counts the relaxed launches (walks and death
#: rows) of two-word state masks again on their own.
LAUNCHES = {"wgl_regs_crash": 0, "wgl_regs_relaxed": 0,
            "wgl_regs_relaxed_w2": 0}

#: Integer operations of a closure over the crash-prefix masks, per
#: (source state, target state) pair and plane word: the select and
#: the OR.  A slot b >= 5 pass costs CLOSE5_OPS per state row of each
#: word that receives (half the words), and its prune PRUNE_OPS.
CLOSURE_OPS = 2


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wgl_crash_launch.argtypes = (
        [ptr, ctypes.c_longlong] + [ptr] * 3 + [i32] + [ptr, i32]
        + [i32] * 7 + [ctypes.c_ulonglong] + [ptr] * 4)
    lib.wgl_crash_launch.restype = i32


def sn_words(Sn: int) -> int:
    """32-bit words of a state mask: 1 up to 32 states, 2 up to 64."""
    return 1 if Sn <= 32 else 2


def _snp_w(Sn: int) -> int:
    """The kernel's state-row bucket: 8, 16, 32, or 64 (two rows a
    thread) past 32 states."""
    return 64 if Sn > 32 else snp(Sn)


def _launch(name, cbuf, offs, nrows, aux, ctab, *, R, Sn, UP, nc, rn,
            seed, work):
    """Check the arguments, then run the plain version (CPU tensors) or
    launch the kernel (CUDA tensors).  Returns (out, bad): out is
    u8[K, J, J] transfer rows, or int32[K] death rows when `seed` is
    given; bad (int32[1]) counts segments the kernel refused (rows
    outside cbuf, a uop id outside the table, a slot at or past R, a
    crash-prefix index outside ctab) and whose output it did not write;
    on the CPU such input raises instead."""
    dev = cbuf.device
    _check(cbuf, "cbuf", torch.uint8, dev)
    _check(offs, "offs", torch.int64, dev)
    _check(nrows, "nrows", torch.int32, dev)
    _check(aux, "aux", torch.int32, dev)
    K = offs.numel()
    W = sn_words(Sn)
    if nrows.numel() != K or aux.numel() != (2 * W + 1) * UP:
        raise ValueError("offs/nrows/aux sizes disagree")
    nC = 0
    if ctab is not None:
        _check(ctab, "ctab", torch.int32, dev)
        nC = ctab.numel() // max(Sn * W, 1)
        if nC < 1 or ctab.numel() != nC * Sn * W:
            raise ValueError("ctab must hold [nC, Sn, W] masks")
    if work is not None:
        _check(work, "work", torch.int64, dev)
        if work.numel() != K:
            raise ValueError("work must hold one count per segment")
    J = 1 if seed is not None else Sn << nc
    sn_max = planner.REGS_SN_MAX * (2 if ctab is not None else 1)
    if not (1 <= R <= planner.CRASH_R_MAX and 1 <= Sn <= sn_max
            and 0 <= nc <= planner.MAX_CRASHED and 0 <= rn
            and rn + nc <= R and J <= planner.CRASH_J_MAX and UP >= 1
            and (ctab is None or (nc == 0 and R <= planner.REGS_R_MAX))
            and (seed is None or ctab is not None)):
        raise ValueError(f"unsupported kernel shape R={R} Sn={Sn} nc={nc} "
                         f"rn={rn} J={J} UP={UP} closure={ctab is not None}")
    if dev.type == "cpu":
        out = walk_plain(cbuf, offs, nrows, aux, ctab, R=R, Sn=Sn, UP=UP,
                         nc=nc, rn=rn, seed=seed, work=work)
        return out, torch.zeros(1, dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no crash kernel for device {dev}")
    if seed is None:
        out = torch.empty((K, J, J), dtype=torch.uint8, device=dev)
    else:
        out = torch.empty(K, dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    if K == 0:
        return out, bad
    lib = cuda_build.load("wgl_crash", _declare)
    if work is not None:
        work.zero_()                    # each lane adds its count
    err = lib.wgl_crash_launch(
        cbuf.data_ptr(), cbuf.numel(), offs.data_ptr(), nrows.data_ptr(),
        aux.data_ptr(), UP, None if ctab is None else ctab.data_ptr(), nC,
        K, R, _snp_w(Sn), Sn, nc, rn, int(seed is not None),
        0 if seed is None else int(seed) & (1 << 64) - 1, out.data_ptr(),
        None if work is None else work.data_ptr(), bad.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} (K={K} "
                           f"R={R} Sn={Sn} nc={nc} J={J})")
    LAUNCHES[name] += 1
    if W > 1:
        LAUNCHES["wgl_regs_relaxed_w2"] += 1
    return out, bad


def crash_scan(cbuf, offs, nrows, aux, *, R: int, Sn: int, UP: int,
               nc: int, rn: int, work=None):
    """Transfer rows of K segments with nc >= 1 crashed calls on the
    permanent slots rn..rn+nc-1 (the wire from `regs_kernel.pack_stream`
    of a crash-carrying scan), each row's rounds run to the fixpoint (at
    most R = rn + nc <= 8): u8[K, J, J] with J = Sn * 2^nc <= 128, and
    bad int32[1].  `work`, an optional int64[K], receives each
    segment's integer operations, summed over its J lanes."""
    if nc < 1 or R != rn + nc:
        raise ValueError(f"crash_scan needs nc >= 1 and R = rn + nc, got "
                         f"R={R} rn={rn} nc={nc}")
    return _launch("wgl_regs_crash", cbuf, offs, nrows, aux, None, R=R,
                   Sn=Sn, UP=UP, nc=nc, rn=rn, seed=None, work=work)


def relaxed_scan(cbuf, offs, nrows, aux, ctab, *, R: int, Sn: int,
                 UP: int, work=None):
    """Transfer rows u8[K, Sn, Sn] under the relaxed crash semantics:
    each row of the wire (CROW_ROW_BYTES a row) names a row of ctab
    (int32[nC * Sn * W]: bit t % 32 of word t // 32 of ctab[c, s] allows
    the jump s -> t, W = sn_words(Sn)), whose masks close the plane
    before the first round and after every round; rounds to the
    fixpoint, at most R <= 6.  aux is a1[UP, W] ++ a2[UP, W] ++ t0[UP].
    Returns (T, bad)."""
    return _launch("wgl_regs_relaxed", cbuf, offs, nrows, aux, ctab, R=R,
                   Sn=Sn, UP=UP, nc=0, rn=0, seed=None, work=work)


def death_row(cbuf, offs, nrows, aux, ctab, seed: int, *, R: int, Sn: int,
              UP: int, work=None):
    """The first row (counting virtual rows) at which the relaxed walk
    of each segment empties, from the states of `seed` (bit s = state
    s, up to 64 states) at mask 0, or -1: int32[K], and bad int32[1]."""
    return _launch("wgl_regs_relaxed", cbuf, offs, nrows, aux, ctab, R=R,
                   Sn=Sn, UP=UP, nc=0, rn=0, seed=seed, work=work)


# ---------------------------------------------------------------------------
# The plain version: the same walk in PyTorch, every segment at once
# ---------------------------------------------------------------------------

def _words64(x: torch.Tensor, W: int) -> torch.Tensor:
    """int64 masks from W consecutive 32-bit words of x (low word
    first); bit 63 lands in the sign, which the walk's shifts and ANDs
    read as bit 63."""
    v = x.to(torch.int64) & _FULL
    if W == 1:
        return v
    v = v.reshape(-1, W)
    return v[:, 0] | (v[:, 1] << 32)


def uop_table(aux, UP: int, W: int = 1):
    """(a1, a2, t0) int64[UP] each from the aux table a1[UP, W] ++
    a2[UP, W] ++ t0[UP]: the diagonal and rank-1 masks (up to 64
    states) and the rank-1 target of every uop."""
    if W == 1:
        return rk.uop_table(aux, UP)
    return (_words64(aux[:UP * W], W), _words64(aux[UP * W:2 * UP * W], W),
            aux[2 * UP * W:2 * UP * W + UP].to(torch.int64) & _FULL)


def walk_plain(cbuf, offs, nrows, aux, ctab=None, *, R: int, Sn: int,
               UP: int, nc: int = 0, rn: int = 0, seed=None, work=None,
               need=None):
    """The kernel's function in plain PyTorch on cbuf's device: all K
    segments walk their rows in step, a segment past its own row count
    (or, with `seed`, past its death) standing still.  The planes are
    int64[K, J, SnP, WD] holding 32-bit words; closure passes update
    them in place, slot by slot, as the kernel does, and a row's rounds
    end when no lane changes.  Each lane's count charges the rounds up
    to the first that leaves its plane unchanged (into `work`, as the
    kernel counts), and `need` (int64[K], optional) receives the same
    count with only the closures that can change the plane: at a row
    whose masks let a live state jump to another, before the rounds and
    in each round whose passes changed the lane.  Raises ValueError
    where the kernel would count a bad segment."""
    dev = cbuf.device
    K = offs.numel()
    SnP, WD = _snp_w(Sn), rk.plane_width(R)
    W = sn_words(Sn)
    J = 1 if seed is not None else Sn << nc
    wire = rk.decode_wire(cbuf, offs, nrows, R=R, UP=UP,
                          crow=ctab is not None)
    tab = uop_table(aux, UP, W)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if ctab is not None:
        nC = ctab.numel() // (Sn * W)
        if bool(((wire.crow < 0) | (wire.crow >= nC)).any()):
            raise ValueError("a row names a crash prefix outside ctab")
        s_idx = torch.arange(SnP, device=dev)
        cm = _words64(ctab, W).reshape(nC, Sn)
        # csel[c, s, t]: the jump s -> t is allowed under prefix c
        csel = torch.zeros((nC, SnP, SnP), dtype=torch.bool, device=dev)
        csel[:, :Sn, :] = ((cm[:, :, None] >> s_idx) & 1).bool()
        csel[:, :, Sn:] = False
        # jump[c]: prefix c lets a live state jump to another
        jump = (csel[:, :Sn, :Sn]
                & ~torch.eye(Sn, dtype=torch.bool, device=dev)).flatten(1)
        jump = jump.any(1)

    fr = torch.zeros((K, J, SnP, WD), dtype=torch.int64, device=dev)
    if seed is not None:
        for s in range(Sn):
            fr[:, 0, s, 0] = (int(seed) >> s) & 1
    else:
        for j in range(J):
            m0 = (j // Sn) << rn
            fr[:, j, j % Sn, m0 >> 5] = 1 << (m0 & 31)
    slots = rk.new_slots(K, R, dev)
    ops = torch.zeros((K, J), dtype=torch.int64, device=dev)
    needed = torch.zeros((K, J), dtype=torch.int64, device=dev)
    close_ops = CLOSURE_OPS * Sn * Sn * WD if ctab is not None else 0
    died = torch.full((K,), -1, dtype=torch.int64, device=dev)

    def close(fr, row):
        sel = csel[wire.crow[:, row]]                     # [K, s, t]
        out = fr
        for s in range(Sn):
            out = out | torch.where(sel[:, None, s, :, None],
                                    fr[:, :, s:s + 1, :], zero)
        return out

    for row in range(wire.Lmax):
        act = wire.live[:, row] & (died < 0)
        act4 = act[:, None, None, None]
        slots = rk.register(wire, row, tab, UP, slots)
        a1r, a2r, t0r, openr = slots
        opened = openr & act[:, None]
        jumps = torch.zeros_like(act)
        if ctab is not None:
            fr = torch.where(act4, close(fr, row), fr)
            ops += torch.where(act, close_ops, 0)[:, None]
            jumps = act & jump[wire.crow[:, row]]
            needed += torch.where(jumps, close_ops, 0)[:, None]
        if bool(opened.any()):
            pass_ops = rk.round_ops(opened, Sn, WD)[:, None]
            per_round = pass_ops + torch.where(opened.any(1), close_ops,
                                               0)[:, None]
            run = opened.any(1)[:, None].expand(K, J)
            for _ in range(R):
                before = fr
                for b in range(R):
                    ob = opened[:, b, None, None, None]
                    if bool(ob.any()):
                        lin = rk.slot_pass(fr, b, a1r[:, b], a2r[:, b],
                                           t0r[:, b])
                        fr = torch.where(ob, fr | lin, fr)
                # the plane was closed when the round began: only the
                # passes can leave the closure something to add
                grew = (fr != before).flatten(2).any(2)
                if ctab is not None:
                    fr = torch.where(act4, close(fr, row), fr)
                ops += torch.where(run, per_round, 0)
                needed += torch.where(run, pass_ops, 0)
                needed += torch.where(run & grew & jumps[:, None],
                                      close_ops, 0)
                run = run & (fr != before).flatten(2).any(2)
                if not bool(run.any()):
                    break               # every lane at its fixpoint
        rs = torch.where(act, wire.ret[:, row], -1)
        for b in range(R):
            mb = rs == b
            if bool(mb.any()):
                fr = torch.where(mb[:, None, None, None], rk.retire(fr, b),
                                 fr)
                openr[:, b] &= ~mb
        ops += rk.prune_ops(rs, Sn, WD)[:, None]
        needed += rk.prune_ops(rs, Sn, WD)[:, None]
        if seed is not None:
            empty = ~(fr != 0).flatten(1).any(1)
            died = torch.where(act & empty, row, died)
    if work is not None:
        work.copy_(ops.sum(1))
    if need is not None:
        need.copy_(needed.sum(1))
    if seed is not None:
        return died.to(torch.int32)
    # the 2^nc crashed-mask planes at zero normal bits: j' = cm * Sn + s
    planes = []
    for cm_ in range(1 << nc):
        m = cm_ << rn
        planes.append((fr[:, :, :Sn, m >> 5] >> (m & 31)) & 1)
    return torch.cat(planes, 2).to(torch.uint8)
