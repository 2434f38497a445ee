"""The key launch of `wgl_seg.check_many` (`regs_kernel.keys_scan`,
kernel `wgl_regs_keys`: several keys a warp) on the card against its
plain version on CPU copies of the same inputs: transfer rows and
operation counts equal byte for byte, on check_many's own inputs and on
keys that split a warp at every (plane width, state bucket) and on
random uop tables (`chip_smoke.random_key_launch`); a key that names a
uop past the table is refused alone.  Imports no JAX; skips without a
card."""

import numpy as np
import pytest
import torch
from torch_keys import key_launch_inputs, lane_keys, port_histories, warp_keys

from chip_smoke import random_key_launch, refuse_key
from jepsen_tpu_torch.ops import regs_kernel


def card_and_plain(wire, kw):
    """keys_scan on the card and on the CPU over the same host wire:
    [(T, work, bad)] for each, on the host."""
    outs = []
    for dev in ("cuda", "cpu"):
        work = torch.zeros(len(wire[1]), dtype=torch.int64, device=dev)
        T, bad = regs_kernel.keys_scan(
            *(torch.from_numpy(x).to(dev) for x in wire), work=work, **kw)
        outs.append((T.cpu(), work.cpu(), int(bad.cpu()[0])))
    return outs


@pytest.mark.cuda
def test_key_launch_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wire, kw, _ = key_launch_inputs(port_histories(lane_keys()))
    launches = regs_kernel.KEYS_LAUNCHES
    (T, work, bad), (pT, pwork, _) = card_and_plain(wire, kw)
    assert torch.equal(T, pT) and torch.equal(work, pwork) and bad == 0
    assert regs_kernel.KEYS_LAUNCHES == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("snp", [8, 16, 32])
@pytest.mark.parametrize("R", [4, 6])
def test_keys_that_split_a_warp_match_plain_on_card(R, snp):
    """Every instantiation (plane width 1 at R = 4, 2 at R = 6; SnP 8,
    16, 32): keys of differing slots, kinds and lengths in one warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wire, kw, _ = key_launch_inputs(port_histories(warp_keys(R, snp)))
    assert kw["R"] == R and regs_kernel.snp(kw["Sn"]) == snp
    assert wire[2].min() == 1 and wire[2].max() > 128
    (T, work, bad), (pT, pwork, _) = card_and_plain(wire, kw)
    assert torch.equal(T, pT) and torch.equal(work, pwork) and bad == 0


@pytest.mark.cuda
@pytest.mark.parametrize("R,Sn,seed", [(5, 6, 45), (6, 14, 56),
                                       (4, 27, 64), (3, 32, 43),
                                       (2, 1, 62)])
def test_random_tables_match_plain_on_card(R, Sn, seed):
    """Random keys under random uop tables, whose rank-1 masks take every
    shape (none, one row, every row, subsets); the seeds leave some keys
    alive and some dead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inp = random_key_launch(seed, 13, R, Sn)
    wire = tuple(inp[x] for x in ("cbuf", "offs", "nrows", "aux"))
    kw = dict(R=R, Sn=Sn, UP=inp["UP"])
    (T, work, bad), (pT, pwork, _) = card_and_plain(wire, kw)
    assert torch.equal(T, pT) and torch.equal(work, pwork) and bad == 0
    assert 0 < int(pT.amax(-1).sum()) < len(wire[1])


@pytest.mark.cuda
@pytest.mark.parametrize("snp", [8, 32])
def test_a_refused_key_is_counted_alone_on_card(snp):
    """A key with a uop id past UP adds one to bad and writes nothing;
    its warp-mates' rows and counts equal the plain version's on the
    wire without the fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wire, kw, _ = key_launch_inputs(port_histories(warp_keys(4, snp)))
    p = 5
    (_, _, _), (pT, pwork, _) = card_and_plain(wire, kw)
    dev = "cuda"
    work = torch.full((len(wire[1]),), -1, dtype=torch.int64, device=dev)
    T, bad = regs_kernel.keys_scan(
        *(torch.from_numpy(x).to(dev)
          for x in refuse_key(wire, p, kw["UP"])), work=work, **kw)
    keep = np.arange(len(wire[1])) != p
    assert int(bad.cpu()[0]) == 1
    assert torch.equal(T.cpu()[keep], pT[keep])
    assert torch.equal(work.cpu()[keep], pwork[keep])
    assert int(work.cpu()[p]) == -1
