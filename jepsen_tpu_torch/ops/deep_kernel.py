"""The deep-overlap event walk: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces `jepsen_tpu/ops/wgl_deep.py::_build` (the Pallas kernel,
`pallas_call` at :358) and its compact-wire prologue `_build_c`.  The
kernel (`jepsen_tpu_torch/csrc/wgl_deep.cu`) runs one CTA per history
of a batch over the u8 compact wire and returns (alive, first dead row)
per history.  On this card it is bound by one SM's shared-memory
bandwidth: each closure round streams the 2^R-mask plane once per open
slot, while the event stream is a few bytes per row.  The design keeps
the plane in shared memory wherever it fits (all but R = 16 at 32
states), stages event rows with their transition words gathered, and
reduces every decision block-wide through warp shuffles; the source
note says more.

The wrapper takes the plain version only for tensors on the CPU.  For
a CUDA tensor it launches the kernel or raises; the build at first use
raises when `nvcc` fails.  `LAUNCHES` counts kernel launches."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

#: Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

EB = 512                        # event rows staged per block step
I = 2                           # invoke columns per event row of the wire
SMEM_PER_BLOCK = 232_448        # bytes of shared memory one block may use
_STATIC_SMEM = 1024             # the kernel's static shared arrays
_INTRA = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)
_FULL = 0xFFFFFFFF

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_lib = None
_lib_lock = threading.Lock()


def plane_words(R: int, SnP: int) -> int:
    """Words of one history's plane: SnP rows of max(1, 2^R / 32)."""
    return SnP * max(1, (1 << R) >> 5)


def stage_bytes() -> int:
    """Shared memory of one staged event block: ret, islot and the
    gathered (a1, a2, t0) of each new invoke, as 32-bit words."""
    return EB * (1 + 4 * I) * 4


def plane_in_shared(R: int, SnP: int) -> bool:
    return (plane_words(R, SnP) * 4 + stage_bytes() + _STATIC_SMEM
            <= SMEM_PER_BLOCK)


def threads_for(R: int) -> int:
    """One thread per plane word column, 32 to 1024."""
    return min(1024, max(32, (1 << R) >> 5))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin); the "
                       "deep kernel is built from csrc/ at first use")


def build() -> Path:
    """Compile csrc/*.cu into a shared library with a plain C interface
    (cached under _build/, keyed by a hash of the sources) and return
    its path.  Raises RuntimeError with nvcc's output on failure."""
    srcs = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    lib = _BUILD / f"libwgl_deep_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(tmp)] + [str(s) for s in srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    (_BUILD / (lib.stem + ".ptxas.txt")).write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.wgl_deep_launch
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


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
    under one aux table (int32 view of diag[UP] ++ const[UP] ++ t0[UP]).  The caller
    checks the depths on the host: a depth past R traps the kernel,
    which the next synchronisation raises.  `work`, an optional
    int64[n], receives the plane words each history's passes touch (the
    bound model of PERF.md).  CUDA tensors launch the kernel on the
    current stream without synchronising; CPU tensors run the plain
    version."""
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
    if dev.type == "cpu":
        out = torch.empty((n, 2), dtype=torch.int32)
        for h, (o, L2, Rh) in enumerate(zip(offs.tolist(), nrows.tolist(),
                                            depth.tolist())):
            size = L2 * (1 + 3 * I)
            if not (1 <= Rh <= R and o + size <= cbuf.numel()):
                raise ValueError(f"history {h}: depth {Rh} or wire "
                                 f"[{o}, {o + size}) out of range")
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
    if plane_in_shared(R, SnP):
        gplane = None
        smem = plane_words(R, SnP) * 4 + stage_bytes()
    else:
        gplane = torch.empty(n * plane_words(R, SnP), dtype=torch.int32,
                             device=dev)
        smem = stage_bytes()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wgl_deep_launch(
        cbuf.data_ptr(), offs.data_ptr(), nrows.data_ptr(),
        depth.data_ptr(), aux.data_ptr(), UP, n, R, SnP,
        None if gplane is None else gplane.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), threads_for(R), smem,
        stream)
    if err != 0:
        raise RuntimeError(f"wgl_deep kernel launch failed: cudaError {err}"
                           f" (R={R} SnP={SnP} n={n} smem={smem})")
    LAUNCHES += 1
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
