"""The consistency-model lattice (the JAX package's `lattice/`): the
model order and `weakest_violated`, which `checker.elle` reports.  The
lattice engine, its planes, checker and adapters are ROADMAP P7."""

from jepsen_tpu_torch.lattice.lattice import (  # noqa: F401
    LATTICE_CLASSES, MODEL_OF, MODELS, model_of, violated_models,
    weakest_violated)
