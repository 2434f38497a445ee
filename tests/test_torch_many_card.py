"""The key launch of `wgl_seg.check_many` (the segment kernel at J = 1,
one segment a key) on the card against its plain version on CPU copies
of the same inputs: transfer rows and operation counts equal exactly.
Imports no JAX; skips without a card."""

import pytest
import torch
from torch_keys import key_launch_inputs, lane_keys, port_histories

from jepsen_tpu_torch.ops import regs_kernel


@pytest.mark.cuda
def test_key_launch_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wire, kw = key_launch_inputs(port_histories(lane_keys()))
    outs = []
    launches = regs_kernel.LAUNCHES
    for dev in ("cuda", "cpu"):
        work = torch.zeros(len(wire[1]), dtype=torch.int64, device=dev)
        T, bad = regs_kernel.regs_scan(
            *(torch.from_numpy(x).to(dev) for x in wire), work=work, **kw)
        outs.append((T.cpu(), work.cpu(), int(bad.cpu()[0])))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == 0
    assert regs_kernel.LAUNCHES == launches + 1
