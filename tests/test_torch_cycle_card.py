"""The cycle checker's kernels on the card against their plain versions
on the same tensors, bit for bit: each closure round of
`ops/cycle.py` (`elle_kernel.square`: `elle_tile_bits` and `elle_pmm`
with x, a and b one plane; the product, its change flag and the
transpose) and `cycle_labels` (`csrc/cycle.cu`), on the JAX package's
bench graph (2048 nodes, a 100-cycle) and on random graphs, a DAG, a
long ring, the empty and the complete graph and self-loops, and on the
dependency graphs of `chip_smoke.py`'s 10,000-txn checks (n_pad 10,112,
the size the checker gives them there); then `scc`
and `TxnCycleChecker` on the card equal to the CPU device.  Imports no
JAX; skips without a card."""

import numpy as np
import pytest
import torch

from chip_smoke import (CYCLE_CHECK_SIZES, CYCLE_EXPECT, CYCLE_RING,
                        bench_graph, cycle_case_err, cycle_kernel_cases,
                        dsg_adj, rw_register_history)
from jepsen_tpu_torch.checker.cycle import TxnCycleChecker
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.ops import cycle, elle_kernel

CASES = cycle_kernel_cases(91)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_closure_and_labels_match_plain_on_card(case):
    dev = card()
    launches = cycle.LAUNCHES["cycle_labels"]
    assert cycle_case_err(CASES[case][1], dev) == 0
    assert cycle.LAUNCHES["cycle_labels"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("plant", [None, "G0", "G1c", "G-single", "G2",
                                   "G1a"])
def test_dsg_closure_and_labels_match_plain_at_the_checks_size(plant):
    dev = card()
    n = max(CYCLE_CHECK_SIZES)
    adj = dsg_adj(History(rw_register_history(n, 9500 + n, plant)))
    assert 128 * -(-len(adj) // 128) == 10_112
    launches = cycle.LAUNCHES["cycle_labels"]
    assert cycle_case_err(adj, dev) == 0
    assert cycle.LAUNCHES["cycle_labels"] == launches + 1


@pytest.mark.cuda
def test_bench_graph_scc_equals_the_cpu():
    card()
    adj = bench_graph()
    before = dict(elle_kernel.LAUNCHES)
    lab, diag, clo = cycle.scc(adj)
    assert diag[:CYCLE_RING].all() and len(set(lab[:CYCLE_RING])) == 1
    for g, w in zip((lab, diag, clo), cycle.scc(adj, device="cpu")):
        assert np.array_equal(g, w)
    assert all(elle_kernel.LAUNCHES[k] > before[k] for k in before)


@pytest.mark.cuda
@pytest.mark.parametrize("plant", [None, "G0", "G1c", "G-single", "G2",
                                   "G1a"])
def test_txn_cycle_checker_on_card_equals_the_cpu(plant):
    card()
    h = History(rw_register_history(600, 31, plant))
    got = TxnCycleChecker().check(None, h)
    assert got["anomaly-types"] == CYCLE_EXPECT[plant]
    assert got == TxnCycleChecker(device="cpu").check(None, h)
