"""The deep-overlap event walk: the CUDA kernel's wrappers and its plain
PyTorch version.

Replaces `jepsen_tpu/ops/wgl_deep.py::_build` (the Pallas kernel,
`pallas_call` at :358) and its compact-wire prologue `_build_c`.  The
kernel (`jepsen_tpu_torch/csrc/wgl_deep.cu`) walks the histories of a
batch over the u8 compact wire and returns (alive, first dead row) per
history, in two arms chosen per history by `arm_of`:

- the warp arm (depth <= WARP_MAX_R): one warp per history with the
  plane in registers; bound by the latency of a row's chain of passes,
  which shuffles and warp reductions keep free of barriers;
- the block arm (deeper): one CTA per history, each thread owning whole
  word columns of the plane, held in registers where the register file
  allows (`block_plane`), else in shared memory (global at R = 16 with
  32 states); bound by the plane's bytes through one SM, with one
  barrier per cross-warp slot and one per block sum.

`deep_walk` splits a grid by arm into at most two launches on the
current stream, each CTA writing its history's row of the output, so
results stay in the batch's order; the source note says more.  The
wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernels or raises; the build at first use
raises when `nvcc` fails.  `LAUNCHES` counts kernel launches, and
`ARM_LAUNCHES` counts them per arm."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from jepsen_tpu_torch.ops import cuda_build

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0
#: The same launches by arm.
ARM_LAUNCHES = {"warp": 0, "block": 0}

#: Deepest history the warp arm walks (csrc/wgl_deep.cu WARP_MAX_R): at
#: R = 10 a lane holds at most 32 plane words; PERF.md records the
#: phase-3 times on the card that keep the boundary here.
WARP_MAX_R = 10

EB = 512                        # event rows staged per block step
WEB = 256                       # event rows staged per warp step
I = 2                           # invoke columns per event row of the wire
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use
_STATIC_SMEM = 1024             # the block kernel's static shared arrays
_INTRA = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)
_FULL = 0xFFFFFFFF


def plane_words(R: int, SnP: int) -> int:
    """Words of one history's plane: SnP rows of max(1, 2^R / 32)."""
    return SnP * max(1, (1 << R) >> 5)


def stage_bytes(rows: int = EB) -> int:
    """Shared memory of `rows` staged event rows: ret, islot and the
    gathered (a1, a2, t0) of each new invoke, as 32-bit words."""
    return rows * (1 + 4 * I) * 4


def plane_in_shared(R: int, SnP: int) -> bool:
    return (plane_words(R, SnP) * 4 + stage_bytes() + _STATIC_SMEM
            <= SMEM_PER_BLOCK)


def threads_for(R: int) -> int:
    """Block arm: one thread per plane word column, 32 to 1024."""
    return min(1024, max(32, (1 << R) >> 5))


def arm_of(depth: int) -> str:
    """The arm that walks a history of this overlap depth."""
    return "warp" if depth <= WARP_MAX_R else "block"


def block_plane(R: int, SnP: int) -> str:
    """Where the block arm keeps the plane of a grid whose deepest
    history has depth R: in registers (one column of SnP words per
    thread) while the threads' share of the register file allows it
    (64 a thread at 1024 threads, 128 at 512), else in shared memory,
    and in global memory where shared memory is too small."""
    if R <= 14 or (R == 15 and SnP <= 16):
        return "registers"
    return "shared" if plane_in_shared(R, SnP) else "global"


def launch_plan(arm: str, R: int, SnP: int) -> dict:
    """How one arm launches a grid whose deepest history has depth R:
    threads per CTA, dynamic and static shared bytes, where the plane
    lives and the plane words each thread holds in registers (None for
    a plane in memory)."""
    if arm == "warp":
        return dict(arm=arm, threads=32, smem=0, static_smem=stage_bytes(WEB),
                    plane="registers",
                    lane_words=max(1, plane_words(R, SnP) // 32))
    threads = threads_for(R)
    plane = block_plane(R, SnP)
    smem = stage_bytes() + {"registers": SnP * threads * 4,
                            "shared": plane_words(R, SnP) * 4,
                            "global": 0}[plane]
    return dict(arm=arm, threads=threads, smem=smem,
                static_smem=_STATIC_SMEM, plane=plane,
                lane_words=SnP if plane == "registers" else None)


def split_by_arm(depths) -> list[tuple[str, list[int]]]:
    """The sub-grids of a grid: (arm, history indices in batch order)
    for each arm that has a history, warp arm first."""
    parts: dict = {"warp": [], "block": []}
    for h, d in enumerate(depths):
        parts[arm_of(d)].append(h)
    return [(arm, idx) for arm, idx in parts.items() if idx]


def build() -> Path:
    """Compile csrc/wgl_deep.cu (cached under _build/, keyed by a hash
    of the source; `cuda_build`) and return the library's path.  Raises
    RuntimeError with nvcc's output on failure."""
    return cuda_build.build("wgl_deep")["wgl_deep"]


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wgl_deep_warp_launch.argtypes = [ptr] * 6 + [i32] * 3 + [ptr] * 3
    lib.wgl_deep_block_launch.argtypes = (
        [ptr] * 6 + [i32] * 5 + [ptr] * 3 + [i32] * 2 + [ptr])
    lib.wgl_deep_warp_launch.restype = i32
    lib.wgl_deep_block_launch.restype = i32


def _load():
    return cuda_build.load("wgl_deep", _declare)


def _check(t: torch.Tensor, name: str, dtype, dev: torch.device):
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def deep_walk(cbuf: torch.Tensor, offs: torch.Tensor,
              nrows: torch.Tensor, depth: torch.Tensor, aux: torch.Tensor,
              *, R: int, SnP: int, UP: int,
              work: torch.Tensor | None = None) -> torch.Tensor:
    """(alive, first dead row | -1) as i32[n, 2] for the n histories
    whose compact wires (I = 2 invoke columns) lie in `cbuf` at byte
    offsets `offs` (int64), each `nrows` (int32) rows long and of
    overlap depth `depth` (int32, 1 <= depth <= R; R sizes the plane),
    under one aux table (int32 view of diag[UP] ++ const[UP] ++ t0[UP]).
    `work`, an optional int64[n], receives the plane words each
    history's passes touch (the bound model of PERF.md).  CUDA tensors
    launch one grid per arm present (`split_by_arm`) on the current
    stream without synchronising between them (reading the depths to
    the host syncs once before); CPU tensors run the plain version."""
    global LAUNCHES
    dev = cbuf.device
    _check(cbuf, "cbuf", torch.uint8, dev)
    _check(offs, "offs", torch.int64, dev)
    _check(nrows, "nrows", torch.int32, dev)
    _check(depth, "depth", torch.int32, dev)
    _check(aux, "aux", torch.int32, dev)
    n = offs.numel()
    if work is not None:
        _check(work, "work", torch.int64, dev)
        if work.numel() != n:
            raise ValueError("work must hold one count per history")
    if nrows.numel() != n or depth.numel() != n \
            or aux.numel() != 3 * UP:
        raise ValueError("offs/nrows/depth/aux sizes disagree")
    if not (1 <= R <= 16 and SnP in (8, 16, 32)):
        raise ValueError(f"unsupported kernel shape R={R} SnP={SnP}")
    depths = depth.tolist()
    for h, Rh in enumerate(depths):
        if not 1 <= Rh <= R:
            raise ValueError(f"history {h}: depth {Rh} outside 1..{R}")
    if dev.type == "cpu":
        out = torch.empty((n, 2), dtype=torch.int32)
        offs_l, rows_l = offs.tolist(), nrows.tolist()
        for h in (h for _, idx in split_by_arm(depths) for h in idx):
            o, L2, Rh = offs_l[h], rows_l[h], depths[h]
            size = L2 * (1 + 3 * I)
            if o + size > cbuf.numel():
                raise ValueError(f"history {h}: wire [{o}, {o + size}) out "
                                 f"of range")
            count: dict = {}
            out[h] = torch.tensor(walk_plain(cbuf[o:o + size], aux, L2=L2,
                                             R=Rh, SnP=SnP, UP=UP,
                                             work=count))
            if work is not None:
                work[h] = count.get("words", 0)
        return out
    if dev.type != "cuda":
        raise ValueError(f"no deep kernel for device {dev}")
    out = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    work_ptr = None if work is None else work.data_ptr()
    for arm, idx in split_by_arm(depths):
        Rb = max(depths[h] for h in idx)
        plan = launch_plan(arm, Rb, SnP)
        hidx = None if len(idx) == n else \
            torch.tensor(idx, dtype=torch.int32, device=dev)
        ptrs = (cbuf.data_ptr(), offs.data_ptr(), nrows.data_ptr(),
                depth.data_ptr(), None if hidx is None else hidx.data_ptr(),
                aux.data_ptr())
        if arm == "warp":
            err = lib.wgl_deep_warp_launch(*ptrs, UP, len(idx), SnP,
                                           out.data_ptr(), work_ptr, stream)
        else:
            gplane = None if plan["plane"] != "global" else torch.empty(
                len(idx) * plane_words(Rb, SnP), dtype=torch.int32,
                device=dev)
            err = lib.wgl_deep_block_launch(
                *ptrs, UP, len(idx), Rb, SnP,
                int(plan["plane"] == "registers"),
                None if gplane is None else gplane.data_ptr(),
                out.data_ptr(), work_ptr, plan["threads"], plan["smem"],
                stream)
        if err != 0:
            raise RuntimeError(f"wgl_deep {arm} launch failed: cudaError "
                               f"{err} (R={R} SnP={SnP} n={len(idx)} "
                               f"plan={plan})")
        LAUNCHES += 1
        ARM_LAUNCHES[arm] += 1
    return out


# ---------------------------------------------------------------------------
# The plain version: the same walk in PyTorch, one event at a time
# ---------------------------------------------------------------------------

def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 element holding a 32-bit word."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _FULL) >> 24


def _shift_words(x: torch.Tensor, d: int) -> torch.Tensor:
    """Move every row's words d places up (d > 0) or down (d < 0),
    filling with zeros."""
    z = torch.zeros_like(x[:, :abs(d)])
    if d > 0:
        return torch.cat([z, x[:, :-d]], dim=1)
    return torch.cat([x[:, -d:], z], dim=1)


def walk_plain(cbuf: torch.Tensor, aux: torch.Tensor, *, L2: int, R: int,
               SnP: int, UP: int, work: dict | None = None):
    """One history's walk over its compact wire, on cbuf's device, as
    (alive, first dead row | -1).  The plane is int64[SnP, NW] holding
    32-bit words, word w of row s holding masks w*32 .. w*32+31 of
    state s.  `work`, when given, accumulates the plane words each pass
    must touch (`words`) and the closure rounds run (`rounds`)."""
    dev = cbuf.device
    NW = max(1, (1 << R) >> 5)
    PW = SnP * NW
    wire = cbuf.to(torch.int64)
    ret = (wire[:L2] - 1).tolist()
    isl = (wire[L2:L2 * (1 + I)] - 1).reshape(L2, I).tolist()
    pairs = wire[L2 * (1 + I):].reshape(L2 * I, 2)
    iuop = (pairs[:, 0] | (pairs[:, 1] << 8)).reshape(L2, I).tolist()
    tab = (aux.to(torch.int64) & _FULL).tolist()

    w_idx = torch.arange(NW, device=dev)
    s_idx = torch.arange(SnP, device=dev)
    lack = torch.stack([
        torch.full((NW,), _INTRA[b], dtype=torch.int64, device=dev)
        if b < 5 else torch.where(((w_idx >> (b - 5)) & 1) == 0,
                                  _FULL, 0)
        for b in range(R)])                   # [R, NW] lacks-bit-b words

    def rowsel(bits: int) -> torch.Tensor:
        return ((bits >> s_idx) & 1).bool()[:, None]

    def count(key: str, n: int):
        if work is not None:
            work[key] = work.get(key, 0) + n

    fr = torch.zeros((SnP, NW), dtype=torch.int64, device=dev)
    fr[0, 0] = 1
    a1r, a2r, t0r = [0] * R, [0] * R, [0] * R
    openr = [False] * R
    for r in range(L2):
        for i in range(I):
            sl = isl[r][i]
            if sl < 0:
                continue
            u = iuop[r][i]
            a1r[sl], a2r[sl], t0r[sl] = tab[u], tab[UP + u], tab[2 * UP + u]
            openr[sl] = True
            # lazy-retirement merge of the (vacant) slot bit onto 0
            lp = lack[sl]
            high = fr & (lp ^ _FULL)
            if sl < 5:
                fr = (fr & lp) | (high >> (1 << sl))
            else:
                fr = (fr & lp) | _shift_words(high, -(1 << (sl - 5)))
            count("words", 2 * PW)
        rs = ret[r]
        if rs < 0:
            continue
        ltpv = lack[rs]
        lt = fr & ltpv
        n_lt = int(_popcount(lt).sum())
        n_ill = int(_popcount(torch.where(rowsel(a1r[rs]), 0, lt)).sum())
        count("words", PW)
        if not (a2r[rs] == 0 and n_ill == 0):
            prev, cnt, lacking = -1, -1, n_lt
            prog = True
            while prog and lacking > 0:
                for b in range(R):
                    if not openr[b]:
                        continue
                    src = fr & ltpv & lack[b]
                    moved = torch.where(rowsel(a1r[b]), src, 0)
                    red = torch.where(rowsel(a2r[b]), src, 0)
                    sh = 1
                    while sh < SnP:          # OR over the state rows
                        red = red | torch.roll(red, sh, 0)
                        sh *= 2
                    moved[t0r[b]] |= red[0]
                    if b < 5:
                        fr = fr | ((moved << (1 << b)) & _FULL)
                    else:
                        fr = fr | _shift_words(moved, 1 << (b - 5))
                    count("words", 2 * PW if b < 5 else PW)
                c = int(_popcount(fr).sum())
                lacking = int(_popcount(fr & ltpv).sum())
                count("words", PW)
                count("rounds", 1)
                prog = c > prev
                prev = cnt = c
            fr = fr & (ltpv ^ _FULL)          # prune configs lacking rs
            count("words", 2 * PW)
            if cnt >= 0 and cnt == lacking:
                return 0, r
        openr[rs] = False
    return 1, -1
