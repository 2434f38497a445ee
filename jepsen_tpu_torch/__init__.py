"""jepsen_tpu_torch: the history-analysis device layer of jepsen_tpu on
PyTorch and CUDA (NVIDIA H100).

It checks linearizability of register-family histories with overlap
depth up to 16 through hand-written CUDA kernels: the register-delta
segment kernel at depth <= 6 (`ops/regs_kernel.py`, `csrc/wgl_regs.cu`),
its crash variants for histories with crashed (:info) calls
(`ops/crash_kernel.py`, `csrc/wgl_crash.cu`) and the deep-overlap kernel
at 7..16 (`ops/deep_kernel.py`, `csrc/wgl_deep.cu`); what those refuse
goes, as in jepsen_tpu, to the serial frontier engine (`ops/wgl.py`,
`ops/frontier_kernel.py`, `csrc/wgl_frontier.cu`).  Elle
(`checker/elle.py`) checks the transactional isolation of list-append
and rw-register histories: inference on the host (`elle/infer.py`), the
closure on the card, dense (`ops/elle_graph.py`) or bit-packed on the
kernel `elle_pmm` (`ops/elle_mesh.py`, `ops/elle_kernel.py`,
`csrc/elle_pmm.cu`).  The txn cycle checker (`checker/cycle.py`) finds
dependency cycles by SCC (`ops/cycle.py`): the closure on `elle_pmm`,
the labels on the kernel `cycle_labels` (`csrc/cycle.cu`).  The checker
library (`checker/__init__.py`: set, set-full, queue, total-queue,
unique-ids, counter, compose) runs `Set` and `UniqueIds`' set algebra on
the kernel `fold_member` (`ops/fold.py`, `csrc/fold.cu`) for large
integer histories.  The host scan of a history is C
(`native/histscan.c`, built by the host compiler at first use).  Entry points run on the card unless the caller passes
`device="cpu"`, which runs the kernel's plain PyTorch version."""

from jepsen_tpu_torch.errors import (BackendUnavailable, CheckError,
                                     Unsupported)

__all__ = ["BackendUnavailable", "CheckError", "Unsupported"]
