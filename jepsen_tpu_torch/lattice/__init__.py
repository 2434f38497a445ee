"""The full weak-consistency lattice (the JAX package's `lattice/`).

Widens Elle's engine from the four Adya serializability classes
(G0/G1c/G-single/G2-item) to the combined Adya + session/causal +
predicate lattice:

  * `lattice`  - the consistency-model partial order and the one
    `weakest_violated` that `checker.elle` and the lattice checker
    report;
  * `planes`   - session-order and predicate plane families lowered
    from an `elle.infer.Inference` (so_ww/so_wr/so_rw/so_rr + prw),
    dense or packed uint32 (`ops.elle_mesh`'s word layout);
  * `engine`   - the masked-closure classifier in three tiers with
    equal verdicts (the numpy oracle, the dense tier on the card, the
    packed tier on the kernels `elle_pmm` and `lattice_masks`) plus
    per-class witness recovery;
  * `checker`  - the post-hoc `LatticeChecker` and `classify_history`;
  * `adapters` - `workloads.causal`, `long_fork` and `monotonic`
    lowered onto the plane engine, their host checkers run alongside
    as the oracle.
"""

from jepsen_tpu_torch.lattice.lattice import (  # noqa: F401
    LATTICE_CLASSES, MODEL_OF, MODELS, model_of, violated_models,
    weakest_violated)
