"""The full lattice's packed tier on the card: a closure round on the
kernels of `elle_pmm.cu` and the class masks on the kernel
`lattice_masks`, with their plain PyTorch versions.

Planes are [n_pad, n_pad / 32] int32 tensors holding the reference's
u32 words (bit b of word w is column 32 w + b), n_pad a multiple of 128.

`lattice_round(cww, p0a, p1a, p0s, p1s, cpred, cm)` is one Jacobi round
of the seven closures (`jepsen_tpu/lattice/engine.py:314-334`):

    cww' = cww | cww.cww,       cpred' = cpred | cpred.cpred,
    p0a' = p0a | p0a.p0a,       p1a'   = p1a | qa.p1a | p1a.qa,
    p0s' = p0s | p0s.p0s,       p1s'   = p1s | qs.p1s | p1s.qs,
    cm'  = cm | cm.cm,

with qa = p0a | p1a and qs = p0s | p1s.  It returns the seven new
planes, one flag that says whether any plane changed, and the packed
transposes of the seven input planes (the round's right operands).  On
CUDA tensors the round is two pairs of launches sharing the flag,
because `elle_pmm` takes at most four jobs and eight left operands a
launch: {cww, p0a, p1a, cpred} and {p0s, p1s, cm}, each an
`elle_tile_bits` launch (counts and transposes) and an `elle_pmm` launch
(`elle_kernel._launch`; counted in `elle_kernel.LAUNCHES`).

`masks(planes8, tposes7)` is the twelve priority-subtracted class masks
and their lowest defining edges (`engine.py:352-367`), one launch of
`lattice_masks` (`jepsen_tpu_torch/csrc/lattice_masks.cu`) on CUDA
tensors: int64 [12], each class's least flat index a * n_pad + b in
`LATTICE_CLASSES` order, or NONE.

On CPU tensors both run their plain versions (`lattice_round_plain` over
`elle_kernel.product_plain`, `masks_plain` in torch bitwise ops and
`elle_mesh.pick`); there is no other route.  `LAUNCHES` counts
`lattice_masks`' launches."""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch.ops import cuda_build, elle_kernel, elle_mesh

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"lattice_masks": 0}

#: A class whose mask is empty (the kernel's all-ones u64).
NONE = -1

#: The input planes `masks` reads, in its order.
MASK_PLANES = ("ww", "wr", "rw", "so_ww", "so_wr", "so_rw", "so_rr", "prw")
#: The transposes `masks` reads, in its order.
MASK_TPOSES = ("p0a", "p1a", "p0s", "p1s", "cww", "cpred", "lf")


def _declare(lib):
    ptr = ctypes.c_void_p
    lib.lattice_masks_launch.argtypes = [ctypes.POINTER(ptr),
                                         ctypes.POINTER(ptr), ctypes.c_int,
                                         ptr, ptr]
    lib.lattice_masks_launch.restype = ctypes.c_int


def lattice_round(cww, p0a, p1a, p0s, p1s, cpred, cm):
    """One Jacobi round of the seven closures: (cww', p0a', p1a', p0s',
    p1s', cpred', cm', changed, tposes), changed a bool scalar tensor on
    the planes' device and tposes the packed transposes of (cww, p0a,
    p1a, p0s, p1s, cpred, cm).  When changed is false the new planes
    equal the old, and the transposes are the closures'.  The plain
    version for CPU tensors, two count and two product launches for
    CUDA tensors (or raise)."""
    planes = [cww, p0a, p1a, p0s, p1s, cpred, cm]
    dev = cww.device
    elle_kernel._check(planes, dev)
    if dev.type == "cpu":
        return lattice_round_plain(*planes)
    if dev.type != "cuda":
        raise ValueError(f"no elle_pmm kernel for device {dev}")
    outs = [torch.zeros_like(cww) for _ in range(7)]
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    t_cww, t_p0a, t_p1a, t_cpred = elle_kernel._launch(
        [(cww, outs[0], [(cww, None, cww, None)]),
         (p0a, outs[1], [(p0a, None, p0a, None)]),
         (p1a, outs[2], [(p0a, p1a, p1a, None), (p1a, None, p0a, p1a)]),
         (cpred, outs[5], [(cpred, None, cpred, None)])], dev, changed)
    t_p0s, t_p1s, t_cm = elle_kernel._launch(
        [(p0s, outs[3], [(p0s, None, p0s, None)]),
         (p1s, outs[4], [(p0s, p1s, p1s, None), (p1s, None, p0s, p1s)]),
         (cm, outs[6], [(cm, None, cm, None)])], dev, changed)
    return (*outs, changed[0] != 0,
            (t_cww, t_p0a, t_p1a, t_p0s, t_p1s, t_cpred, t_cm))


def masks(planes8, tposes7):
    """int64 [12] on the planes' device: each lattice class's least flat
    defining index a * n_pad + b, or NONE.  planes8 are (ww, wr, rw,
    so_ww, so_wr, so_rw, so_rr, prw), tposes7 the packed transposes of
    (p0a, p1a, p0s, p1s, cww, cpred, lf).  The plain version for CPU
    tensors, one launch of `lattice_masks` for CUDA tensors (or
    raise)."""
    planes8, tposes7 = list(planes8), list(tposes7)
    if len(planes8) != len(MASK_PLANES) or len(tposes7) != len(MASK_TPOSES):
        raise ValueError(f"masks takes {len(MASK_PLANES)} planes and "
                         f"{len(MASK_TPOSES)} transposes, got "
                         f"{len(planes8)} and {len(tposes7)}")
    dev = planes8[0].device
    n_pad = elle_kernel._check(planes8 + tposes7, dev)
    if dev.type == "cpu":
        return masks_plain(planes8, tposes7)
    if dev.type != "cuda":
        raise ValueError(f"no lattice_masks kernel for device {dev}")
    out = torch.empty(12, dtype=torch.int64, device=dev)
    pp = (ctypes.c_void_p * len(planes8))(*[p.data_ptr() for p in planes8])
    tp = (ctypes.c_void_p * len(tposes7))(*[t.data_ptr() for t in tposes7])
    lib = cuda_build.load("lattice_masks", _declare)
    err = lib.lattice_masks_launch(pp, tp, n_pad, out.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lattice_masks launch failed: cudaError {err} "
                           f"(n_pad={n_pad})")
    LAUNCHES["lattice_masks"] += 1
    return out


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def lattice_round_plain(cww, p0a, p1a, p0s, p1s, cpred, cm):
    """`lattice_round` in plain PyTorch on the planes' device."""
    prod = elle_kernel.product_plain

    def pair(p0, p1):
        q = p0 | p1
        return prod(p0, p0, p0), prod(p1, q, prod(q, p1, p1))

    old = (cww, p0a, p1a, p0s, p1s, cpred, cm)
    p0a2, p1a2 = pair(p0a, p1a)
    p0s2, p1s2 = pair(p0s, p1s)
    new = (prod(cww, cww, cww), p0a2, p1a2, p0s2, p1s2,
           prod(cpred, cpred, cpred), prod(cm, cm, cm))
    changed = torch.stack([(a != b).any() for a, b in zip(new, old)]).any()
    return (*new, changed, tuple(elle_kernel.tpose_plain(p) for p in old))


def class_masks(ww, wr, rw, so_ww, so_wr, so_rw, so_rr, prw,
                t_p0a, t_p1a, t_p0s, t_p1s, t_cww, t_cpred, t_lf) -> list:
    """The twelve priority-subtracted masks in `LATTICE_CLASSES` order,
    as bitwise ops on packed words (or on bool planes)."""
    t_dep = t_p0a | t_p1a
    so = so_ww | so_wr | so_rw | so_rr
    m_mw = so_ww & t_dep
    m_wfr = so_rw & t_dep & ~m_mw
    m_ryw = so_wr & t_dep & ~m_mw & ~m_wfr
    m_mr = so_rr & t_dep & ~m_mw & ~m_wfr & ~m_ryw
    sess = m_mw | m_wfr | m_ryw | m_mr
    m_pram = so & t_p0s & ~sess
    m_causal = so & t_p1s & ~t_p0s & ~sess & ~m_pram
    m_lf = rw & t_lf & ~t_p0a
    return [m_mw, m_wfr, m_ryw, m_mr, m_pram, m_causal, m_lf,
            ww & t_cww, wr & t_p0a, rw & t_p0a,
            rw & t_p1a & ~t_p0a & ~m_lf, prw & t_cpred]


def masks_plain(planes8, tposes7):
    """`masks` in plain PyTorch on the planes' device."""
    planes8, tposes7 = list(planes8), list(tposes7)
    n_pad = planes8[0].shape[0]
    picks = elle_mesh.pick(torch.stack(class_masks(*planes8, *tposes7)))
    return torch.tensor([a * n_pad + b if f else NONE for f, a, b in picks],
                        dtype=torch.int64, device=planes8[0].device)
