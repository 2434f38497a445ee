"""The lattice's kernels on the card against their plain versions on the
same tensors, bit for bit: a lattice closure round
(`lattice_kernel.lattice_round`: two `elle_tile_bits` + `elle_pmm`
pairs sharing one change flag; the seven planes, the flag and the seven
transposes) and `lattice_masks` (`lattice_kernel.masks`), on random
packed planes at n_pad 128, 384 and 1024, and on the planes of
`chip_smoke.py`'s list-append histories; then `LatticeChecker` on the
card equal to the CPU device on every tier.  Imports no JAX; skips
without a card."""

import pytest
import torch

from chip_smoke import (LATTICE_PLANTS, lattice_history, lattice_mask_cases,
                        random_packed)
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.lattice import engine
from jepsen_tpu_torch.lattice.checker import LatticeChecker
from jepsen_tpu_torch.lattice.planes import from_history
from jepsen_tpu_torch.ops import elle_kernel, elle_mesh, lattice_kernel

NPADS = (128, 384, 1024)
DENSITIES = (0.0, 0.002, 0.02, 0.3)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def same_round(got, want):
    return (all(torch.equal(g, w) for g, w in zip(got[:7], want[:7]))
            and bool(got[7]) == bool(want[7])
            and all(torch.equal(g, w) for g, w in zip(got[8], want[8])))


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", NPADS)
@pytest.mark.parametrize("dens", DENSITIES)
def test_lattice_round_matches_plain(n_pad, dens):
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_pad + int(1000 * dens))
    state = [random_packed(n_pad, n_pad - 5, dens, gen, dev)
             for _ in range(7)]
    before = dict(elle_kernel.LAUNCHES)
    got = lattice_kernel.lattice_round(*state)
    assert all(elle_kernel.LAUNCHES[k] == before[k] + 2 for k in before)
    assert same_round(got, lattice_kernel.lattice_round_plain(*state))


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", NPADS)
def test_lattice_masks_match_plain(n_pad):
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(77 + n_pad)
    for name, planes, tposes in lattice_mask_cases(n_pad, gen, dev):
        launches = lattice_kernel.LAUNCHES["lattice_masks"]
        got = lattice_kernel.masks(planes, tposes)
        assert lattice_kernel.LAUNCHES["lattice_masks"] == launches + 1
        assert torch.equal(got, lattice_kernel.masks_plain(planes, tposes)), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("plant", (None,) + LATTICE_PLANTS)
def test_closures_and_masks_on_history_planes(plant):
    dev = card()
    lp, _ = from_history(History(lattice_history(300, plant)))
    planes = elle_mesh._to_device(lp.packed_stacked(), dev)
    tposes, _ = engine.closures(planes)
    cpu = planes.cpu()
    want, _ = engine.closures(cpu)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(tposes, want))
    assert torch.equal(lattice_kernel.masks(list(planes), tposes).cpu(),
                       lattice_kernel.masks_plain(list(cpu), want))


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["auto", "mesh", "device"])
@pytest.mark.parametrize("plant", (None,) + LATTICE_PLANTS)
def test_lattice_checker_on_card_equals_the_cpu(algorithm, plant):
    card()
    h = History(lattice_history(200, plant))
    got = LatticeChecker(algorithm=algorithm).check(None, h)
    want = LatticeChecker(algorithm=algorithm, device="cpu").check(None, h)
    for v in (got, want):
        v.pop("stages")
        v["dispatch"].pop("device")
    assert got == want
