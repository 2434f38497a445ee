"""The segment route's composition (`regs_kernel.compose`; on the CPU its
plain version, `compose_plain`) against jepsen_tpu's composed kernels,
run by JAX on the CPU, on the same wire:

- `_build_kernel_regs_group_c`, the grouped pipeline kernel, on the
  compact I = 1 wire of a group of histories: one of a single segment,
  one valid, and three that die at their first, a middle and their last
  segment, at the speculative 2 rounds and at exact rounds;
- `_build_kernel_regs(..., nc, rn, compose=True)` on a crash-shaped
  walk with J = 88 entry configs (Sn = 11, nc = 3), valid and invalid.

The six verdict words are equal exactly (0/1 data, no tolerance).  Also
the plain version against a numpy chain on random matrices up to J =
128, and the wrapper's checks.  The one test that needs the card skips
without one."""

import numpy as np
import pytest
import torch
from test_torch_crash import crash_case, decode, port_scan, uop_tables
from test_wgl_seg import rand_history

from jepsen_tpu.ops import wgl_seg as ref_seg
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.ops import crash_kernel, planner, regs_kernel, wgl_seg

TARGET = 16                     # returns per segment in the group cases


def plant_impossible_read(h, seg_ends, fk, k):
    """h with one ok read inside segment k (by return ordinal) turned to
    a value nothing writes: the walk dies at that return."""
    lo = seg_ends[k - 1] if k else 0
    for r in range(lo, seg_ends[k]):
        op = h.ops[int(fk.positions[r])]
        if op.type == "ok" and op.f == "read":
            op.value = 99
            return h
    raise AssertionError(f"segment {k} holds no ok read")


def group_histories():
    """(name, history, expected dead segment or None) of one group."""
    def make(seed, n_ops=90):
        return convert.history_from_dicts(
            rand_history(seed, n_ops=n_ops, conc=4, vmax=9,
                         max_open=3).to_dicts())
    spec = models.CASRegister().device_spec()
    out = [("one-segment", make(71, n_ops=6), None),
           ("valid", make(72), None)]
    for name, seed, at in (("dead-first", 73, lambda n: 0),
                           ("dead-middle", 74, lambda n: n // 2),
                           ("dead-last", 75, lambda n: n - 1)):
        h = make(seed)
        fk = planner._fast_scan(h.ops, spec, {}, [], 10)
        seg_ends = planner._segment_ends(fk.cuts, TARGET)
        k = at(len(seg_ends))
        out.append((name, plant_impossible_read(h, seg_ends, fk, k), k))
    return out


def compact_block(cbuf, offs, nrows, U, Rp, Kp):
    """One history's segments (the port's I = 1 wire) as the reference's
    compact group block (`planner._regs_fill_compact`): rows u8[Rp]
    (ret+1 | (islot+1) << 4) ++ iuop u8 or u16[Rp] ++ cum i32[Kp + 1]."""
    rows_s, iu = [], []
    for o, L in zip(offs, nrows):
        seg = cbuf[int(o):int(o) + regs_kernel.ROW_BYTES * int(L)]
        L = int(L)
        ret = seg[:L].astype(np.int32)
        isl = seg[L:3 * L].reshape(L, 2).astype(np.int32)
        u = (seg[3 * L::2].astype(np.int32)
             | (seg[3 * L + 1::2].astype(np.int32) << 8)).reshape(L, 2)
        assert (isl[:, 1] == 0).all()         # I = 1: column 1 empty
        rows_s.append(ret | (isl[:, 0] << 4))
        iu.append(u[:, 0])
    cum = np.zeros(Kp + 1, np.int32)
    cum[1:len(nrows) + 1] = np.cumsum(nrows)
    cum[len(nrows) + 1:] = cum[len(nrows)]
    rs = np.zeros(Rp, np.uint8)
    n = int(cum[-1])
    rs[:n] = np.concatenate(rows_s)
    iw = np.zeros(Rp, np.uint8 if U <= 255 else np.uint16)
    iw[:n] = np.concatenate(iu)
    return np.concatenate([rs, iw.view(np.uint8), cum.view(np.uint8)])


@pytest.fixture(scope="module")
def group():
    cases = group_histories()
    model = models.CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fks = [planner._fast_scan(h.ops, spec, seen, rows, 10)
           for _, h, _ in cases]
    states, legal, nxt, dec = wgl_seg._model_tables(spec, model, rows, 64)
    Sn, U = states.shape[0], len(rows)
    R = max(fk.max_open for fk in fks)
    uop_tabs = planner._pack_uop_tables(legal, nxt, *dec)
    aux, UP = wgl_seg._aux(uop_tabs)
    grid = wgl_seg._SegGrid()
    wires = []
    for fk in fks:
        seg_ends = planner._segment_ends(fk.cuts, TARGET)
        grid.add(fk, seg_ends, 1)
        wires.append(regs_kernel.pack_stream(fk, seg_ends, 1))
    Kp = max(grid.seg_counts)
    Rp = max(int(w[2].sum()) for w in wires)
    Lp = planner._pad_len(max(int(w[2].max()) for w in wires))
    payload = np.concatenate([compact_block(*w, U, Rp, Kp) for w in wires])
    buf32 = np.concatenate([np.asarray(t).astype(np.uint32)
                            for t in uop_tabs])
    out = {}
    for rounds in sorted({2, R}):
        ref = np.asarray(ref_seg._build_kernel_regs_group_c(
            len(cases), Kp, Lp, max(1, (1 << R) // 32), Sn, R, True,
            rounds, 1, U, Rp)(payload, buf32))
        T, bad = regs_kernel.regs_scan(
            *(torch.from_numpy(x) for x in grid.wire() + (aux,)), R=R,
            Sn=Sn, UP=UP, J=Sn, rounds=rounds)
        assert int(bad[0]) == 0
        out[rounds] = (ref, regs_kernel.compose(T, grid.seg_counts).numpy(),
                       T)
    return cases, grid.seg_counts, R, out


def test_group_matches_reference_group_kernel(group):
    cases, counts, R, out = group
    assert R >= 3 and counts[0] == 1 and min(counts[1:]) > 2
    assert out[R][2].shape[1:] == (11, 11)         # J = Sn = 11
    for rounds, (ref, got, _) in out.items():
        assert np.array_equal(got, ref), rounds
    ref = out[R][0]
    for b, (name, _, dead) in enumerate(cases):
        assert ref[b, 1] == (-1 if dead is None else dead), name
        assert ref[b, 0] == (dead is None), name
    assert ref[2, 2:].tolist() == [1, 0, 0, 0]     # entry config 0


@pytest.fixture(scope="module")
def crash88():
    out = {}
    for buggy, seed in ((False, 62), (True, 61)):      # Sn = 11
        h = crash_case(2, 3, seed, 9, buggy=buggy, n_ops=80)
        fk, rows = port_scan(h)
        R, nc, rn = fk.rn + fk.nc, fk.nc, fk.rn
        seg_ends = planner._segment_ends(fk.cuts, 24)
        wire = regs_kernel.pack_stream(fk, seg_ends, 2)
        states, _, _, uop_tabs, aux, UP = uop_tables(rows)
        Sn = states.shape[0]
        tabs = decode(*wire, len(rows))[:3]
        K, Lp = tabs[0].shape[1], tabs[0].shape[0]
        ref = np.asarray(ref_seg._build_kernel_regs(
            K, Lp, 2, max(1, (1 << R) // 32), Sn, R, True, R, 1,
            J=Sn << nc, nc=nc, rn=rn, compose=True)(*tabs, *uop_tabs))
        T, _ = crash_kernel.crash_scan(
            *(torch.from_numpy(x) for x in wire), torch.from_numpy(aux),
            R=R, Sn=Sn, UP=UP, nc=nc, rn=rn)
        out[buggy] = (ref, regs_kernel.compose(T, [K])[0].numpy(), T, nc)
    return out


@pytest.mark.parametrize("buggy", [False, True])
def test_crash_shaped_j88_matches_reference(crash88, buggy):
    ref, got, T, nc = crash88[buggy]
    assert T.shape[1] == 88 and nc == 3
    assert np.array_equal(got, ref)
    assert bool(ref[0]) is not buggy
    if buggy:
        assert ref[1] > 0 and any(ref[2:])


def numpy_chain(T, counts):
    """The six words by a numpy walk of each history's vector."""
    out, lo = [], 0
    for k_b in counts:
        v = np.zeros(T.shape[1], bool)
        v[0] = True
        dead, entry = -1, np.zeros_like(v)
        for k in range(k_b):
            nv = (v[:, None] & (T[lo + k] > 0)).any(0)
            if not nv.any():
                dead, entry = k, v
                break
            v = nv
        words = [int(sum(int(entry[j]) << (j - 32 * w)
                         for j in range(32 * w, min(32 * w + 32, len(v)))))
                 for w in range(4)]
        out.append([int(dead < 0), dead]
                   + [x - (1 << 32) if x >= 1 << 31 else x for x in words])
        lo += k_b
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("J", [1, 11, 32, 33, 88, 128])
def test_plain_matches_a_numpy_chain(J):
    rng = np.random.default_rng(J)
    counts = [1, 3, 7, 12, 5]
    T = (rng.random((sum(counts), J, J)) < 0.3).astype(np.uint8)
    T[:, :, 0] |= (rng.random((sum(counts), J)) < 0.6).astype(np.uint8)
    T[:, 0, 0] = 1
    T[1] = 0                            # history 1 dies at segment 0
    T[4 + 3] = 0                        # history 2 in the middle
    T[11 + 11] = 0                      # history 3 at its last
    T[23 + 2, :, J - 1] = 1             # history 4 reaches the top bit
    got = regs_kernel.compose(torch.from_numpy(T), counts).numpy()
    assert np.array_equal(got, numpy_chain(T, counts))
    assert got[:, 1].tolist()[:4] == [-1, 0, 3, 11]


def test_compose_checks_inputs():
    T = torch.ones((3, 4, 4), dtype=torch.uint8)
    assert regs_kernel.compose(T, [1, 2]).tolist() == [[1, -1, 0, 0, 0, 0]] * 2
    with pytest.raises(ValueError, match="u8"):
        regs_kernel.compose(T.to(torch.float32), [3])
    with pytest.raises(ValueError, match="u8"):
        regs_kernel.compose(T[:, :, :3].contiguous(), [3])
    with pytest.raises(ValueError, match="unsupported"):
        regs_kernel.compose(T, [1, 1])
    with pytest.raises(ValueError, match="unsupported"):
        regs_kernel.compose(T, [3, 0])
    with pytest.raises(ValueError, match="unsupported"):
        regs_kernel.compose(torch.ones((1, 129, 129), dtype=torch.uint8),
                            [1])
    with pytest.raises(ValueError, match="device"):
        regs_kernel.compose(T.to("meta"), [3])


def test_cpu_route_launches_nothing():
    """On the CPU the plain versions answer: neither counter moves."""
    h = convert.history_from_dicts(
        rand_history(76, n_ops=60, conc=3, vmax=9).to_dicts())
    launches = (regs_kernel.LAUNCHES, regs_kernel.COMPOSE_LAUNCHES)
    got = wgl_seg.check(models.CASRegister(), h, device="cpu")
    assert got["valid?"] is True and got["engine"] == "wgl_seg"
    assert (regs_kernel.LAUNCHES, regs_kernel.COMPOSE_LAUNCHES) == launches


@pytest.mark.cuda
def test_compose_kernel_matches_plain_on_card(group, crash88):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, counts, _, out = group
    launches = regs_kernel.COMPOSE_LAUNCHES
    n = 0
    for T, c in [(t, counts) for _, _, t in out.values()] + \
            [(t, [t.shape[0]]) for _, _, t, _ in crash88.values()]:
        got = regs_kernel.compose(T.to("cuda"), c).cpu()
        assert torch.equal(got, regs_kernel.compose_plain(T, c))
        n += 1
    assert regs_kernel.COMPOSE_LAUNCHES == launches + n


def test_compose_limits_are_the_kernel_constants():
    import re

    from jepsen_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "wgl_regs.cu").read_text()
    maxjc = int(re.search(r"constexpr int MAXJC = (\d+);", src).group(1))
    words = int(re.search(r"constexpr int COMPOSE_WORDS = (\d+);",
                          src).group(1))
    assert maxjc == regs_kernel.J_COMPOSE_MAX == planner.CRASH_J_MAX
    # a chunk holds at least one matrix's row masks at the widest J
    assert words >= maxjc * ((maxjc + 31) // 32)
