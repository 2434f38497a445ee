"""Elle's packed boolean product: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces `jepsen_tpu/ops/elle_mesh.py::_device_fns.pmm` (:261, an XLA
program, not Pallas), which the packed tier's closure rounds run four
times a round.  Planes are [n_pad, n_pad / 32] int32 tensors holding the
reference's u32 words (bit b of word w is column 32 w + b), n_pad a
multiple of 128.

`product(a, b, x)` is x | a.b, the exact boolean product on packed
words.  `closure_round(cww, p0, p1)` is one Jacobi round of the pair
closure (`elle_mesh.py:362-364`):

    cww' = cww | cww.cww,  p0' = p0 | p0.p0,  p1' = p1 | q.p1 | p1.q,

with q = p0 | p1, and a flag that says whether any plane changed.  On
CUDA tensors both launch the kernel `elle_pmm`
(`jepsen_tpu_torch/csrc/elle_pmm.cu`; a round is one launch of three
jobs); on CPU tensors they run the plain version (`product_plain`,
`closure_round_plain`: unpack, float32 product, threshold, pack); there
is no other route.  `LAUNCHES` counts kernel launches."""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch.ops import cuda_build

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"elle_pmm": 0}

#: Row granularity of a plane (the kernel's tiles and the reference's
#: 128-tile padding).
TILE = 128
_JOB_PTRS = 10
_FULL = 0xFFFFFFFF


def _declare(lib):
    ptr = ctypes.c_void_p
    lib.elle_pmm_launch.argtypes = [ctypes.POINTER(ptr),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int, ctypes.c_int, ptr, ptr]
    lib.elle_pmm_launch.restype = ctypes.c_int


def _check(planes, dev) -> int:
    n_pad = planes[0].shape[0]
    for p in planes:
        if (p.dtype != torch.int32 or p.dim() != 2
                or tuple(p.shape) != (n_pad, n_pad // 32)
                or not p.is_contiguous()):
            raise ValueError(f"planes must be contiguous int32 tensors of "
                             f"shape (n_pad, n_pad / 32), got {p.dtype} "
                             f"{tuple(p.shape)}")
        if p.device != dev:
            raise ValueError(f"a plane is on {p.device}, expected {dev}")
    if n_pad < TILE or n_pad % TILE:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of "
                         f"{TILE}")
    return n_pad


def _launch(jobs, dev, changed=None) -> None:
    """jobs: [(x or None, out, [(a0, a1 or None, b0, b1 or None), ...])]."""
    n_pad = jobs[0][1].shape[0]
    ptrs = (ctypes.c_void_p * (_JOB_PTRS * len(jobs)))()
    nterms = (ctypes.c_int * len(jobs))()
    for j, (x, out, terms) in enumerate(jobs):
        base = _JOB_PTRS * j
        ptrs[base] = None if x is None else x.data_ptr()
        ptrs[base + 1] = out.data_ptr()
        for t, term in enumerate(terms):
            for s, p in enumerate(term):
                ptrs[base + 2 + 4 * t + s] = None if p is None \
                    else p.data_ptr()
        nterms[j] = len(terms)
    lib = cuda_build.load("elle_pmm", _declare)
    err = lib.elle_pmm_launch(
        ptrs, nterms, len(jobs), n_pad,
        None if changed is None else changed.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"elle_pmm launch failed: cudaError {err} "
                           f"(n_pad={n_pad}, jobs={len(jobs)})")
    LAUNCHES["elle_pmm"] += 1


def product(a, b, x=None):
    """x | a.b on packed planes (x None: a.b): the plain version for CPU
    tensors, the kernel for CUDA tensors (or raise)."""
    dev = a.device
    _check([a, b] + ([] if x is None else [x]), dev)
    if dev.type == "cpu":
        return product_plain(a, b, x)
    if dev.type != "cuda":
        raise ValueError(f"no elle_pmm kernel for device {dev}")
    out = torch.empty_like(a)
    _launch([(x, out, [(a, None, b, None)])], dev)
    return out


def closure_round(cww, p0, p1):
    """One Jacobi round of the pair closure: (cww', p0', p1', changed),
    changed a bool scalar tensor on the planes' device.  The plain
    version for CPU tensors, one launch of the kernel for CUDA tensors
    (or raise)."""
    dev = cww.device
    _check([cww, p0, p1], dev)
    if dev.type == "cpu":
        return closure_round_plain(cww, p0, p1)
    if dev.type != "cuda":
        raise ValueError(f"no elle_pmm kernel for device {dev}")
    outs = [torch.empty_like(cww) for _ in range(3)]
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch([(cww, outs[0], [(cww, None, cww, None)]),
             (p0, outs[1], [(p0, None, p0, None)]),
             (p1, outs[2], [(p0, p1, p1, None), (p1, None, p0, p1)])],
            dev, changed)
    return outs[0], outs[1], outs[2], changed[0] != 0


# ---------------------------------------------------------------------------
# The plain version, and the packing it shares with ops.elle_mesh
# ---------------------------------------------------------------------------

def unpack(words, n=None):
    """int32 [..., W] words -> bool [..., n] (n defaults to 32 W)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[..., None] >> shifts) & 1).bool()
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return bits if n is None else bits[..., :n]


def pack(bits):
    """bool [..., c] (c a multiple of 32) -> int32 [..., c / 32] words."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    c = bits.shape[-1]
    w = (bits.reshape(bits.shape[:-1] + (c // 32, 32)).to(torch.int64)
         << shifts).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def product_plain(a, b, x=None):
    """x | a.b in plain PyTorch on a's device: unpack both operands to
    float32 0/1 matrices, multiply (exact: a count is at most n_pad <
    2^24), threshold, pack."""
    prod = pack(unpack(a).float() @ unpack(b).float() > 0.5)
    return prod if x is None else x | prod


def closure_round_plain(cww, p0, p1):
    """`closure_round` in plain PyTorch on the planes' device."""
    q = p0 | p1
    cww2 = product_plain(cww, cww, cww)
    p0n = product_plain(p0, p0, p0)
    p1n = product_plain(p1, q, product_plain(q, p1, p1))
    changed = ((cww2 != cww).any() | (p0n != p0).any()
               | (p1n != p1).any())
    return cww2, p0n, p1n, changed
