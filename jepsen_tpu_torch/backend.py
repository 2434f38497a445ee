"""Device resolution shared by every entry point.

`device=None` means the card.  Without one the call raises
`BackendUnavailable`; it never carries on quietly on the CPU.  The CPU
runs only when the caller names it, and there every kernel runs its
plain PyTorch version."""

from __future__ import annotations

import torch

from jepsen_tpu_torch.errors import BackendUnavailable


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise BackendUnavailable(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch version", backend="cuda")
        return dev
    if dev.type == "cpu":
        return dev
    raise BackendUnavailable(f"no kernel for device type {dev.type!r}",
                             backend=dev.type)
