"""The serial frontier walk (`frontier_kernel.walk`, kernel
`wgl_frontier`) on the card against its plain version on CPU copies of
the same inputs (in PyTorch on the card for the R = 18 walks at F = 8192
and 65536), launch by launch from the same entering frontier: outputs,
frontier words and `work=` counts equal on chip_smoke.py's
`[serial-kernel]` cases (the fast path, every pool tier with
escalation, overflow at the last size, chunk boundaries, crash groups
at 1, 2 and 4 mask words and in the tier F = 8192, a mutex, write
bursts at 2, 3 and 5 key words whose pools have varying bits in every
word and many equal digits and whose truncations fall inside runs of
equal high digits, the grid's sort at F = 8192, and the R = 18
history's deciding walk); the rounds that the grid takes; and
`wgl.check` on the card equal to the CPU device on ROADMAP C3's keys.
Imports no JAX; skips without a card."""

import pytest
import torch

from chip_smoke import (SERIAL_KERNEL_NAMES, SERIAL_PLAIN_ON_CARD, key_dicts,
                        serial_compare, serial_kernel_cases)
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.ops import frontier_kernel, wgl


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERIAL_KERNEL_NAMES)
def test_walk_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, model, h, F, chunk = next(c for c in serial_kernel_cases()
                                 if c[0] == name)
    launches = frontier_kernel.LAUNCHES["wgl_frontier"]
    plain_on = "cuda" if name in SERIAL_PLAIN_ON_CARD else "cpu"
    err, n, _, _, _, forms, ctas = serial_compare(model, h, F, chunk,
                                                  plain_on)
    assert err == 0
    assert frontier_kernel.LAUNCHES["wgl_frontier"] == launches + n
    # one CTA where the largest pool fits its shared memory, else the
    # grid, whose large pools are built (and past two key buffers
    # sorted) by every CTA
    if name in ("fast-path", "chunks", "mutex"):
        assert ctas == 1 and forms[1] == forms[2] == 0
    if name.startswith("burst-"):
        assert ctas > 1 and forms[1] + forms[2] > 0
    if name in ("grid-8192", "deciding-65536"):
        assert ctas > 1 and forms[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,conc", [(304019, 34, 6), (741828, 38, 5),
                                         (767203, 31, 6)])
def test_check_on_card_equals_cpu(seed, n, conc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h = convert.history_from_dicts(key_dicts(seed, n_calls=n, conc=conc,
                                             buggy=0.3, crash_rate=0.15))
    card = wgl.check(models.CASRegister(), h, events_per_call=7)
    cpu = wgl.check(models.CASRegister(), h, device="cpu",
                    events_per_call=7)
    for key in ("valid?", "op_index", "frontier_size", "final_frontier"):
        assert card.get(key) == cpu.get(key), key
    assert card["backend"] == "cuda"
