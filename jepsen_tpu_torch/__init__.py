"""jepsen_tpu_torch: the history-analysis device layer of jepsen_tpu on
PyTorch and CUDA (NVIDIA H100).

This slice checks linearizability of crash-free register-family
histories with overlap depth up to 16 through two hand-written CUDA
kernels: the register-delta segment kernel at depth <= 6
(`ops/regs_kernel.py`, `csrc/wgl_regs.cu`) and the deep-overlap kernel
at 7..16 (`ops/deep_kernel.py`, `csrc/wgl_deep.cu`).  Entry points run on
the card unless the caller passes `device="cpu"`, which runs the
kernel's plain PyTorch version."""

from jepsen_tpu_torch.errors import (BackendUnavailable, CheckError,
                                     Unsupported)

__all__ = ["BackendUnavailable", "CheckError", "Unsupported"]
