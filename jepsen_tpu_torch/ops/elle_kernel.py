"""Elle's packed boolean product: the CUDA kernels' wrappers and their
plain PyTorch versions.

Replaces `jepsen_tpu/ops/elle_mesh.py::_device_fns.pmm` (:261, an XLA
program, not Pallas), which the packed tier's closure rounds run four
times a round.  Planes are [n_pad, n_pad / 32] int32 tensors holding the
reference's u32 words (bit b of word w is column 32 w + b), n_pad a
multiple of 128.

`product(a, b, x)` is x | a.b, the exact boolean product on packed
words.  `closure_round(cww, p0, p1)` is one Jacobi round of the pair
closure (`elle_mesh.py:362-364`):

    cww' = cww | cww.cww,  p0' = p0 | p0.p0,  p1' = p1 | q.p1 | p1.q,

with q = p0 | p1, and a flag that says whether any plane changed.
`square(r)` is one round of a single plane's transitive closure, r |
r.r, with its flag and r's packed transpose (`ops.cycle`). On
CUDA tensors each is two launches (`jepsen_tpu_torch/csrc/elle_pmm.cu`):
`elle_tile_bits` counts the set bits of each 128-row tile of each left
operand and of its densest row, and writes the packed transposes of the
right operands (`prepare`); then `elle_pmm` computes every job (a round
is three) into zeroed outputs, each (job, row tile) in the dense form on
the int8 tensor cores (B unpacked from its transpose) or, at most
`GATHER_DENSITY` of its bits set, in the row-gather form (a dense row
split among warps). On CPU tensors they run the plain versions
(`product_plain`, `closure_round_plain`: unpack, float32 product,
threshold, pack; `tile_bits_plain`, `tpose_plain`); there is no other
route. `LAUNCHES` counts kernel launches; with `RECORD` set,
`LAST_LAUNCH` holds the last product launch's tile counts and forms on
the card."""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch.ops import cuda_build

#: Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"elle_pmm": 0, "elle_tile_bits": 0}

#: When true, each product launch on the card also writes the form each
#: (job, row tile) took into LAST_LAUNCH; off, it allocates nothing for
#: them.  Checks against the plain rule set it; the checker does not.
RECORD = False
#: The last product launch on the card while RECORD was set: "tile_bits"
#: int32 [operands, tiles, 2] (`prepare`'s counts) and "forms" int32
#: [jobs, tiles], 1 where the (job, row tile) took the dense form, 0 the
#: gather form.
LAST_LAUNCH: dict = {}

#: Row granularity of a plane (the counted tiles and the reference's
#: 128-tile padding).
TILE = 128
#: The forms' crossover, a density (elle_pmm.cu's GATHER_NUM /
#: GATHER_DEN): a (job, row tile) whose left operands hold at most this
#: share of its TILE x n_pad bits, a term, takes the gather form.
GATHER_DENSITY = (2, 25)
_JOB_PTRS = 14
_FULL = 0xFFFFFFFF


def _declare(lib):
    ptr = ctypes.c_void_p
    ints = ctypes.POINTER(ctypes.c_int)
    lib.elle_tile_bits_launch.argtypes = [ctypes.POINTER(ptr), ctypes.c_int,
                                          ctypes.POINTER(ptr), ctypes.c_int,
                                          ctypes.c_int, ptr, ptr]
    lib.elle_tile_bits_launch.restype = ctypes.c_int
    lib.elle_pmm_launch.argtypes = [ctypes.POINTER(ptr), ints, ints,
                                    ctypes.c_int, ctypes.c_int, ptr, ptr,
                                    ptr, ptr]
    lib.elle_pmm_launch.restype = ctypes.c_int
    lib.elle_pmm_smem.argtypes = [ctypes.c_int]
    lib.elle_pmm_smem.restype = ctypes.c_int


def _lib():
    return cuda_build.load("elle_pmm", _declare)


def dynamic_smem(n_pad: int) -> int:
    """The product kernel's dynamic shared memory at n_pad, in bytes
    (builds the source at first use)."""
    return _lib().elle_pmm_smem(n_pad)


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
        if dev.type == "cuda" and p.data_ptr() % 16:
            raise ValueError("a plane on the card must start on a 16-byte "
                             "boundary")
    if n_pad < TILE or n_pad % TILE:
        raise ValueError(f"n_pad={n_pad} is not a positive multiple of "
                         f"{TILE}")
    return n_pad


def _operands(jobs):
    """The distinct left operands (a0, a1) of jobs' terms, each term's
    index among them, and the distinct right planes (b0 and b1)."""
    ops, index, term_ops, rights = [], {}, [], {}
    for _, _, terms in jobs:
        for a0, a1, b0, b1 in terms:
            key = (a0.data_ptr(), None if a1 is None else a1.data_ptr())
            if key not in index:
                index[key] = len(ops)
                ops.append((a0, a1))
            term_ops.append(index[key])
            for b in (b0, b1):
                if b is not None:
                    rights.setdefault(b.data_ptr(), b)
    return ops, term_ops, list(rights.values())


def prepare(operands, planes=()):
    """(counts, transposes): int32 [len(operands), n_pad / TILE, 2], the
    set bits of each TILE-row tile of each operand (a0, a1 or None; a0 |
    a1 counted as one) and the most set bits in one row of the tile; and
    the packed transpose of each plane in planes.  One launch of the
    kernel `elle_tile_bits` for CUDA tensors (or raise), the plain
    versions for CPU tensors."""
    flat = [p for a0, a1 in operands for p in (a0, a1) if p is not None]
    dev = flat[0].device
    n_pad = _check(flat + list(planes), dev)
    if dev.type == "cpu":
        return tile_bits_plain(operands), [tpose_plain(p) for p in planes]
    if dev.type != "cuda":
        raise ValueError(f"no elle_tile_bits kernel for device {dev}")
    counts = torch.empty((len(operands), n_pad // TILE, 2),
                         dtype=torch.int32, device=dev)
    tposes = [torch.empty_like(p) for p in planes]
    ptrs = (ctypes.c_void_p * (2 * len(operands)))()
    for i, (a0, a1) in enumerate(operands):
        ptrs[2 * i] = a0.data_ptr()
        ptrs[2 * i + 1] = None if a1 is None else a1.data_ptr()
    pl = (ctypes.c_void_p * max(1, 2 * len(planes)))()
    for i, (p, t) in enumerate(zip(planes, tposes)):
        pl[2 * i], pl[2 * i + 1] = p.data_ptr(), t.data_ptr()
    err = _lib().elle_tile_bits_launch(
        ptrs, len(operands), pl, len(planes), n_pad, counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"elle_tile_bits launch failed: cudaError {err} "
                           f"(n_pad={n_pad}, operands={len(operands)}, "
                           f"planes={len(planes)})")
    LAUNCHES["elle_tile_bits"] += 1
    return counts, tposes


def _launch(jobs, dev, changed=None) -> list:
    """jobs: [(x or None, out, [(a0, a1 or None, b0, b1 or None), ...])].
    Returns the packed transposes of the distinct right planes, in the
    order of their first use."""
    n_pad = jobs[0][1].shape[0]
    ops, term_ops, rights = _operands(jobs)
    counts, tposes = prepare(ops, rights)
    tpose = {p.data_ptr(): t for p, t in zip(rights, tposes)}
    forms = torch.empty((len(jobs), n_pad // TILE), dtype=torch.int32,
                        device=dev) if RECORD else None
    ptrs = (ctypes.c_void_p * (_JOB_PTRS * len(jobs)))()
    nterms = (ctypes.c_int * len(jobs))()
    tops = (ctypes.c_int * (2 * len(jobs)))()
    u = 0
    for j, (x, out, terms) in enumerate(jobs):
        base = _JOB_PTRS * j
        ptrs[base] = None if x is None else x.data_ptr()
        ptrs[base + 1] = out.data_ptr()
        for t, (a0, a1, b0, b1) in enumerate(terms):
            for s, p in enumerate((a0, a1, b0, b1)
                                  + tuple(None if b is None
                                          else tpose[b.data_ptr()]
                                          for b in (b0, b1))):
                ptrs[base + 2 + 6 * t + s] = None if p is None \
                    else p.data_ptr()
            tops[2 * j + t] = term_ops[u]
            u += 1
        nterms[j] = len(terms)
    err = _lib().elle_pmm_launch(
        ptrs, nterms, tops, len(jobs), n_pad, counts.data_ptr(),
        None if forms is None else forms.data_ptr(),
        None if changed is None else changed.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"elle_pmm launch failed: cudaError {err} "
                           f"(n_pad={n_pad}, jobs={len(jobs)})")
    LAUNCHES["elle_pmm"] += 1
    if RECORD:
        LAST_LAUNCH.update(tile_bits=counts, forms=forms)
    return tposes


def product(a, b, x=None):
    """x | a.b on packed planes (x None: a.b): the plain version for CPU
    tensors, the kernels for CUDA tensors (or raise)."""
    dev = a.device
    _check([a, b] + ([] if x is None else [x]), dev)
    if dev.type == "cpu":
        return product_plain(a, b, x)
    if dev.type != "cuda":
        raise ValueError(f"no elle_pmm kernel for device {dev}")
    out = torch.zeros_like(a)
    _launch([(x, out, [(a, None, b, None)])], dev)
    return out


def square(r):
    """One round of a plane's transitive closure, r | r.r (the product
    x | a.b with a, b and x all r): (r', changed, r's packed transpose),
    changed a bool scalar tensor on r's device.  When changed is false
    r' equals r, and the transpose is the closure's.  The plain version
    for CPU tensors, one count and one product launch for CUDA tensors
    (or raise)."""
    dev = r.device
    _check([r], dev)
    if dev.type == "cpu":
        return square_plain(r)
    if dev.type != "cuda":
        raise ValueError(f"no elle_pmm kernel for device {dev}")
    out = torch.zeros_like(r)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    (t,) = _launch([(r, out, [(r, None, r, None)])], dev, changed)
    return out, changed[0] != 0, t


def closure_round(cww, p0, p1):
    """One Jacobi round of the pair closure: (cww', p0', p1', changed),
    changed a bool scalar tensor on the planes' device.  The plain
    version for CPU tensors, one count and one product launch for CUDA
    tensors (or raise)."""
    dev = cww.device
    _check([cww, p0, p1], dev)
    if dev.type == "cpu":
        return closure_round_plain(cww, p0, p1)
    if dev.type != "cuda":
        raise ValueError(f"no elle_pmm kernel for device {dev}")
    outs = [torch.zeros_like(cww) for _ in range(3)]
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


def square_plain(r):
    """`square` in plain PyTorch on r's device."""
    out = product_plain(r, r, r)
    return out, (out != r).any(), tpose_plain(r)


def closure_round_plain(cww, p0, p1):
    """`closure_round` in plain PyTorch on the planes' device."""
    q = p0 | p1
    cww2 = product_plain(cww, cww, cww)
    p0n = product_plain(p0, p0, p0)
    p1n = product_plain(p1, q, product_plain(q, p1, p1))
    changed = ((cww2 != cww).any() | (p0n != p0).any()
               | (p1n != p1).any())
    return cww2, p0n, p1n, changed


def tpose_plain(plane):
    """The packed transpose of a plane in plain PyTorch (bit a of row b is
    bit b of the plane's row a), as the packed tier's `tpose`."""
    from jepsen_tpu_torch.ops import elle_mesh
    return elle_mesh.tpose(plane)


def tile_bits_plain(operands):
    """`prepare`'s counts in plain PyTorch on the operands' device."""
    out = []
    for a0, a1 in operands:
        a = a0 if a1 is None else a0 | a1
        rows = unpack(a).sum(1, dtype=torch.int64).reshape(-1, TILE)
        out.append(torch.stack([rows.sum(1), rows.max(1).values], 1))
    return torch.stack(out).to(torch.int32)


def forms_plain(bits, term_ops, n_pad):
    """int32 [jobs, tiles]: the form each (job, row tile) takes, 1 dense
    and 0 gather, from `prepare`'s counts and each job's term operand
    indices (a list a job), by the kernel's rule (the set bits, summed
    over the terms, at most GATHER_DENSITY of the terms' tiles)."""
    num, den = GATHER_DENSITY
    out = []
    for ops in term_ops:
        total = sum(bits[o, :, 0].to(torch.int64) for o in ops)
        out.append(total * den > len(ops) * TILE * n_pad * num)
    return torch.stack(out).to(torch.int32)
