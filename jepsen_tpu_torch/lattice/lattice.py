"""The consistency-model partial order (the JAX package's
`lattice/lattice.py`).

Adya's chain (read-uncommitted < read-committed < snapshot-isolation
< serializable) joins the session/causal family in one lattice:

                     serializable
                          |
                  snapshot-isolation
                   /              \\
         read-committed    parallel-snapshot-isolation
                 |                 |
         read-uncommitted       causal
                               /      \\
                           PRAM    writes-follow-reads
                          /  |  \\
          read-your-writes   |   monotonic-writes
                     monotonic-reads

An anomaly class maps to the WEAKEST model that proscribes it
(`MODEL_OF`); finding one rules out that model and everything above
it.  `weakest_violated(found)` names the minimal violated model, the
single string `checker.elle` reports.  For pure-Adya anomaly sets it
returns the Adya chain's answer."""

from __future__ import annotations

from typing import Optional

# models, weakest first — the canonical topological order used for
# "not" lists and deterministic tie-breaks among incomparable minima
MODELS = (
    "read-your-writes", "monotonic-reads", "monotonic-writes",
    "writes-follow-reads", "PRAM", "causal", "read-uncommitted",
    "read-committed", "parallel-snapshot-isolation",
    "snapshot-isolation", "serializable",
)

# model -> models DIRECTLY above it (stronger: violating the key also
# violates each value, transitively)
STRONGER = {
    "read-uncommitted": ("read-committed",),
    "read-committed": ("snapshot-isolation",),
    "snapshot-isolation": ("serializable",),
    "read-your-writes": ("PRAM",),
    "monotonic-reads": ("PRAM",),
    "monotonic-writes": ("PRAM",),
    "PRAM": ("causal",),
    "writes-follow-reads": ("causal",),
    "causal": ("parallel-snapshot-isolation",),
    "parallel-snapshot-isolation": ("snapshot-isolation",),
    "serializable": (),
}

# the cycle classes the lattice engine detects, in mask-priority
# order: each class's mask subtracts every earlier class's edges, so
# one defining edge belongs to exactly one class
LATTICE_CLASSES = (
    "monotonic-writes", "writes-follow-reads", "read-your-writes",
    "monotonic-reads", "PRAM", "causal", "long-fork",
    "G0", "G1c", "G-single", "G2-item", "G2-predicate",
)

# anomaly class -> weakest model it violates.  Includes the direct
# (non-cycle) classes `elle/infer.py` finds.
MODEL_OF = {
    # session guarantees violate themselves
    "read-your-writes": "read-your-writes",
    "monotonic-reads": "monotonic-reads",
    "monotonic-writes": "monotonic-writes",
    "writes-follow-reads": "writes-follow-reads",
    "PRAM": "PRAM",
    "causal": "causal",
    # a long fork is legal under causal; PSI is the weakest model
    # that forbids it (Sovran et al.)
    "long-fork": "parallel-snapshot-isolation",
    # Adya's item classes (identical to checker.elle.ANOMALY_LEVEL)
    "G0": "read-uncommitted",
    "duplicate-elements": "read-uncommitted",
    "G1a": "read-committed",
    "G1b": "read-committed",
    "G1c": "read-committed",
    "incompatible-order": "read-committed",
    "cyclic-version-order": "read-committed",
    "G-single": "snapshot-isolation",
    "G2-item": "serializable",
    # predicate (phantom) classes
    "G1-predicate": "read-committed",
    "G2-predicate": "serializable",
}


def model_of(anomaly: str) -> Optional[str]:
    """Weakest model the anomaly class violates, or None if unknown."""
    return MODEL_OF.get(anomaly)


def _up_closure(models) -> set:
    out: set = set()
    stack = list(models)
    while stack:
        m = stack.pop()
        if m in out:
            continue
        out.add(m)
        stack.extend(STRONGER.get(m, ()))
    return out


def violated_models(found) -> list:
    """Every model ruled out by the found anomaly classes, in the
    canonical weakest-first order (the lattice `not` list)."""
    base = {MODEL_OF[a] for a in found if a in MODEL_OF}
    if not base:
        return []
    up = _up_closure(base)
    return [m for m in MODELS if m in up]


def weakest_violated(found) -> Optional[str]:
    """The weakest violated model: the minimal element of the
    violated up-set (first in MODELS order when minima are
    incomparable), or None for a clean set.  Agrees with the
    pre-lattice Adya chain answer on pure-Adya inputs."""
    vio = violated_models(found)
    if not vio:
        return None
    up = set(vio)
    for m in vio:
        # minimal = no violated model sits strictly below it
        below = {b for b, ups in STRONGER.items()
                 if m in _up_closure(ups)}
        if not (up & below):
            return m
    return vio[0]
