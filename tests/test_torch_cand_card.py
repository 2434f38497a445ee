"""The candidate-table kernels (`cand_kernel.cand_bits`, kernel
`wgl_cand_bits`; `cand_kernel.cand_dense`, kernel `wgl_cand_dense`) and
the relaxed crash kernel's two-word instances (`crash_kernel.relaxed_scan`
and `death_row` past 32 states) on the card against their plain versions
on CPU copies of the same inputs: transfer rows, death rows and `work=`
counts equal byte for byte, on `chip_smoke.cand_kernel_cases()` (both
forms, decomposed and undecomposed, J = Sn and J = 1, R 1..10, 3 to 64
states) and on wide crash histories.  Imports no JAX; skips without a
card."""

import numpy as np
import pytest
import torch

from chip_smoke import (cand_call, cand_kernel_cases, cand_plain_job,
                        cand_tables, crash_run, plain_crash_job,
                        relaxed_inputs, wide_dicts)
from jepsen_tpu_torch import convert
from jepsen_tpu_torch.ops import cand_kernel, crash_kernel, regs_kernel

CASES = cand_kernel_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_cand_kernel_matches_plain_on_card(i):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, model, h, J = CASES[i]
    t = cand_tables(model, h, J, 64)
    name = f"wgl_cand_{t['form']}"
    launches = cand_kernel.LAUNCHES[name]
    T, bad = cand_call(t, "cuda")()
    pT, _, _ = cand_plain_job(t)
    assert int(bad.cpu()[0]) == 0
    assert np.array_equal(T.cpu().numpy(), pT)
    assert cand_kernel.LAUNCHES[name] == launches + 1


@pytest.mark.cuda
def test_cand_kernel_refuses_a_slot_past_R_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, model, h, J = CASES[0]
    t = cand_tables(model, h, J, 64)
    t = dict(t, cslot=t["cslot"] + t["R"])
    T, bad = cand_call(t, "cuda")()
    assert int(bad.cpu()[0]) > 0
    with pytest.raises(ValueError):
        cand_call(t, "cpu")()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [800, 801, 803])
def test_two_word_relaxed_matches_plain_on_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h = convert.history_from_dicts(wide_dicts(
        seed, 36, n_calls=200, conc=4, max_open=4, crash_rate=0.06,
        buggy=0.05))
    ri = relaxed_inputs(h)
    assert ri["Sn"] > 32
    launches = crash_kernel.LAUNCHES["wgl_regs_relaxed_w2"]
    T, work, bad, _ = crash_run(ri, "cuda", "relaxed")
    pT, pwork, _, _ = plain_crash_job(ri, "relaxed")
    assert bad == 0 and np.array_equal(T, pT)
    assert np.array_equal(work, pwork)
    vd = regs_kernel.compose(torch.from_numpy(T), [ri["K"]])[0].tolist()
    for k in ([vd[1]] if vd[1] >= 0 else []) + [0]:
        seed_mask = ((1 << ri["Sn"]) - 1) if k != vd[1] else \
            (vd[2] & 0xFFFFFFFF) | (vd[3] & 0xFFFFFFFF) << 32
        dr, dw, bad, _ = crash_run(ri, "cuda", "death", [k], seed_mask)
        pdr, pdw, _, _ = plain_crash_job(ri, "death", [k], seed_mask)
        assert bad == 0 and int(dr[0]) == int(pdr[0])
        assert np.array_equal(dw, pdw)
    assert crash_kernel.LAUNCHES["wgl_regs_relaxed_w2"] > launches
