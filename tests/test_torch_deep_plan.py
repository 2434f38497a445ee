"""The deep kernel's dispatch between its two arms, on the CPU: every
shape has a launch plan the card accepts, a grid of mixed depths splits
into per-arm sub-grids that cover each history once, and the verdicts
of such a grid come back in the batch's order, equal to jepsen_tpu's
(Pallas interpreter) on the same histories."""

import re

import numpy as np
import pytest
import torch
from test_wgl_deep import burst_history, corrupt, deep_history

from jepsen_tpu import models as ref_models
from jepsen_tpu.ops import wgl_deep as ref_deep
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.ops import cuda_build, deep_kernel, wgl_deep

REGS_PER_SM = 65_536


@pytest.mark.parametrize("SnP", (8, 16, 32))
@pytest.mark.parametrize("R", range(1, 17))
def test_launch_plan_fits_the_card(R, SnP):
    arm = deep_kernel.arm_of(R)
    plan = deep_kernel.launch_plan(arm, R, SnP)
    assert plan["arm"] == arm in ("warp", "block")
    assert 32 <= plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    assert plan["smem"] + plan["static_smem"] <= deep_kernel.SMEM_PER_BLOCK
    if arm == "warp":
        assert plan["threads"] == 32 and plan["plane"] == "registers"
        assert plan["lane_words"] <= 32
        assert plan["lane_words"] * 32 >= deep_kernel.plane_words(R, SnP)
    else:
        # one thread per word column, and a register plane leaves the
        # thread at least half of its share of the register file
        assert plan["threads"] == deep_kernel.threads_for(R)
        if plan["plane"] == "registers":
            assert plan["lane_words"] == SnP
            assert 2 * SnP * plan["threads"] <= REGS_PER_SM
        else:
            assert plan["lane_words"] is None
            assert (plan["plane"] == "shared") is \
                deep_kernel.plane_in_shared(R, SnP)


def test_boundary_is_one_constant():
    assert deep_kernel.arm_of(deep_kernel.WARP_MAX_R) == "warp"
    assert deep_kernel.arm_of(deep_kernel.WARP_MAX_R + 1) == "block"
    src = (cuda_build.CSRC / "wgl_deep.cu").read_text()
    m = re.search(r"constexpr int WARP_MAX_R = (\d+);", src)
    assert m and int(m.group(1)) == deep_kernel.WARP_MAX_R
    py = open(deep_kernel.__file__).read()
    assert "environ" not in py and "except" not in py


def test_split_covers_every_history_once():
    depths = [3, 14, 8, 11, 10, 16, 1, 12, 8]
    parts = deep_kernel.split_by_arm(depths)
    assert [arm for arm, _ in parts] == ["warp", "block"]
    seen = sorted(h for _, idx in parts for h in idx)
    assert seen == list(range(len(depths)))
    for arm, idx in parts:
        assert idx == sorted(idx)
        assert all(deep_kernel.arm_of(depths[h]) == arm for h in idx)
    assert deep_kernel.split_by_arm([9, 4]) == [("warp", [0, 1])]
    assert deep_kernel.split_by_arm([13]) == [("block", [0])]
    assert deep_kernel.split_by_arm([]) == []


def mixed_batch():
    hs = [deep_history(60, 8, seed=30, max_open=3),
          corrupt(deep_history(90, 12, seed=31, max_open=8), 0.7),
          burst_history(10, seed=2),
          corrupt(burst_history(11, seed=3), 0.5),
          burst_history(14, seed=4),
          deep_history(80, 12, seed=32, max_open=8)]
    return hs


def test_mixed_grid_matches_reference_in_batch_order():
    hs = mixed_batch()
    ref = ref_deep.check_pipeline(ref_models.CASRegister(), hs)
    got = wgl_deep.check_pipeline(
        models.CASRegister(),
        [convert.history_from_dicts(h.to_dicts()) for h in hs],
        device="cpu")
    depths = [r["max_open"] for r in got]
    assert {deep_kernel.arm_of(d) for d in depths} == {"warp", "block"}
    assert depths[0] <= 3 and depths[2] == 10 and depths[3] == 11
    assert depths[4] == 14
    for r, g in zip(ref, got):
        assert g["valid?"] is r["valid?"]
        assert g.get("op_index") == r.get("op_index")
    assert [g["valid?"] for g in got] == [True, False, True, False, True,
                                          True]


def test_deep_walk_puts_each_history_in_its_row():
    # the same grid walked whole and history by history, in reverse
    hs = [convert.history_from_dicts(h.to_dicts()) for h in mixed_batch()]
    _, grid, pend = wgl_deep.pack_pipeline(models.CASRegister(), hs,
                                           device="cpu")
    wire = grid.to_device(torch.device("cpu"))
    work = torch.zeros(len(pend), dtype=torch.int64)
    whole = deep_kernel.deep_walk(*wire, work=work, **grid.shape())
    cbuf, offs, rows, depth, aux = wire
    for k in reversed(range(len(pend))):
        one = torch.zeros(1, dtype=torch.int64)
        out = deep_kernel.deep_walk(cbuf, offs[k:k + 1], rows[k:k + 1],
                                    depth[k:k + 1], aux, work=one,
                                    **grid.shape())
        assert out[0].tolist() == whole[k].tolist()
        assert int(one) == int(work[k]) > 0
    assert np.array_equal(whole[:, 0].numpy() == 1,
                          np.array([p[0] in (0, 2, 4, 5) for p in pend]))
