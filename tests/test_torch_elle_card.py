"""The packed boolean product (`elle_kernel.product`, `closure_round`:
kernels `elle_tile_bits` and `elle_pmm`) on the card against its plain
version on the same tensors, bit for bit with the change flag: random
packed planes at n_pad 128, 256 and 1152 and at the ragged n_pad 384
and 10,112 over densities 1/n to 0.5; the first launch's tile counts
and right-plane transposes at n_pad 128 to 10,112; planes whose row
tiles are split between the dense and the gather form in one launch, a
tile at the crossover and one bit above it, the all-zero and all-one
planes, a gathered tile with full rows, and the two-term job with its
terms in different forms, each launch's tile counts and forms checked
against the plain count and the rule; a closed plane (no change), and
every round of a bench stack's closure; and the two Elle tiers on the
card equal to the CPU device.  Imports no JAX; skips without a card."""

import numpy as np
import pytest
import torch

from chip_smoke import (elle_case_err, elle_mixed_cases, elle_stack,
                        elle_triple, launch_forms_ok, random_packed,
                        round_err, round_terms, tile_plane)
from jepsen_tpu_torch.ops import elle_graph, elle_kernel, elle_mesh


@pytest.fixture(autouse=True)
def record_forms(monkeypatch):
    monkeypatch.setattr(elle_kernel, "RECORD", True)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad,n", [(128, 128), (256, 200), (1152, 1100)])
@pytest.mark.parametrize("dens", [None, 0.05, 0.5])
def test_kernel_matches_plain_on_card(n_pad, n, dens):
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_pad)
    dens = 1.0 / n if dens is None else dens
    a, b, x = (random_packed(n_pad, n, dens, gen, dev) for _ in range(3))
    launches = elle_kernel.LAUNCHES["elle_pmm"]
    assert torch.equal(elle_kernel.product(a, b),
                       elle_kernel.product_plain(a, b))
    assert torch.equal(elle_kernel.product(a, b, x),
                       elle_kernel.product_plain(a, b, x))
    assert round_err(elle_kernel.closure_round(a, b, x),
                     elle_kernel.closure_round_plain(a, b, x)) == 0
    torch.cuda.synchronize()
    assert elle_kernel.LAUNCHES["elle_pmm"] == launches + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", [384, 10_112])
@pytest.mark.parametrize("dens", [None, 0.002, 0.05, 0.5])
def test_kernel_matches_plain_at_ragged_n_pad(n_pad, dens):
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_pad + 7)
    n = n_pad - 100
    dens = 1.0 / n if dens is None else dens
    a, b, x = (random_packed(n_pad, n, dens, gen, dev) for _ in range(3))
    assert elle_case_err(a, b, x) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", [384, 10_112])
@pytest.mark.parametrize("case", range(5), ids=["split", "edge", "zero",
                                                 "one", "heavy"])
def test_mixed_planes_match_plain_in_one_launch(n_pad, case):
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_pad + case)
    name, a, b, x, want = elle_mixed_cases(n_pad, gen, dev)[case]
    elle_kernel.product(a, b)
    assert elle_kernel.LAST_LAUNCH["forms"][0].tolist() == want
    if name in ("split", "edge"):
        assert 0 < sum(want) < len(want)       # both forms in one launch
    assert elle_case_err(a, b, x) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", [128, 384, 1152, 10_112])
def test_prepare_matches_plain_on_card(n_pad):
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_pad + 3)
    a, b, c = (random_packed(n_pad, n_pad - 1, d, gen, dev)
               for d in (0.001, 0.05, 0.5))
    operands = [(a, None), (b, c), (c, None)]
    counts, tposes = elle_kernel.prepare(operands, [a, b, c])
    assert torch.equal(counts, elle_kernel.tile_bits_plain(operands))
    for t, p in zip(tposes, (a, b, c)):
        assert torch.equal(t, elle_kernel.tpose_plain(p))


@pytest.mark.cuda
def test_two_term_job_in_both_forms_matches_plain():
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    n_pad = 1024
    cww = random_packed(n_pad, n_pad, 0.01, gen, dev)
    p0 = tile_plane(n_pad, (0.3, 1e-4), gen, dev)
    p1 = tile_plane(n_pad, (1e-4, 1e-4, 0.3, 1e-4), gen, dev)
    got = elle_kernel.closure_round(cww, p0, p1)
    forms = elle_kernel.LAST_LAUNCH["forms"][2].tolist()
    assert 0 < sum(forms) < len(forms)
    assert launch_forms_ok(round_terms(cww, p0, p1), n_pad)
    assert round_err(got, elle_kernel.closure_round_plain(cww, p0, p1)) == 0


@pytest.mark.cuda
def test_closed_plane_reports_no_change():
    dev = card()
    p = elle_kernel.pack(torch.ones((256, 256), dtype=torch.bool,
                                    device=dev).triu())
    z = torch.zeros_like(p)
    cww, p0, p1, changed = elle_kernel.closure_round(p, p, z)
    assert not bool(changed)
    assert torch.equal(cww, p) and torch.equal(p0, p) and torch.equal(p1, z)


@pytest.mark.cuda
def test_bench_closure_rounds_match_plain_on_card():
    dev = card()
    _, _, _, cww, p0, p1 = elle_triple(elle_stack(900, 3, plant=True), dev)
    for _ in range(12):
        got = elle_kernel.closure_round(cww, p0, p1)
        assert round_err(got, elle_kernel.closure_round_plain(cww, p0,
                                                              p1)) == 0
        assert launch_forms_ok(round_terms(cww, p0, p1), cww.shape[0])
        cww, p0, p1 = got[:3]
        if not bool(got[3]):
            break
    else:
        pytest.fail("the closure did not settle")


@pytest.mark.cuda
@pytest.mark.parametrize("include_order", [True, False])
def test_tiers_on_card_equal_cpu(include_order):
    card()
    stacks = [elle_stack(n, 40 + n, plant=n % 2 == 0)
              for n in (100, 128, 300, 301)]
    for fn in (elle_graph.classify_batch, elle_mesh.classify_mesh):
        got = fn(stacks, include_order=include_order)
        assert got == fn(stacks, include_order=include_order, device="cpu")
    a = np.random.default_rng(1).random((200, 200)) < 0.02
    assert np.array_equal(elle_mesh.packed_product(a, a),
                          (a.astype(np.int64) @ a) > 0)
