"""Causal-consistency register checker (the JAX package's
`workloads/causal.py`, after jepsen's `tests/causal.clj`): a causal
order of (read-init, w1, read, w2, read) per key must execute in issue
order; ops carry position/link metadata tying each to the last-seen
position.  Only the checker is ported."""

from __future__ import annotations

from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import inconsistent, is_inconsistent


class CausalRegister:
    """causal.clj CausalRegister :32-87: value, op counter, last
    position."""

    def __init__(self, value=0, counter=0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op):
        c = self.counter + 1
        v = op.value
        pos = op.extra.get("position")
        link = op.extra.get("link")
        if link != "init" and link != self.last_pos:
            return inconsistent(
                f"Cannot link {link!r} to last-seen position "
                f"{self.last_pos!r}")
        if op.f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return inconsistent(
                f"expected value {c} attempting to write {v} instead")
        if op.f == "read-init":
            if self.counter == 0 and v not in (0, None):
                return inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        if op.f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        return inconsistent(f"unknown f {op.f!r}")

    def __repr__(self):
        return f"CausalRegister({self.value})"


def causal_register():
    return CausalRegister()


class CausalChecker(Checker):
    """Fold ok ops through the causal register (causal.clj check
    :89-116)."""

    def __init__(self, model=None):
        self.model = model or causal_register()

    def check(self, test, history, opts=None):
        s = self.model
        for op in History(history):
            if not op.is_ok:
                continue
            s2 = s.step(op)
            if is_inconsistent(s2):
                return {"valid?": False, "error": s2.msg}
            s = s2
        return {"valid?": True, "model": s}


def check(model=None, **kw):
    """Lattice-backed causal checker: the register history lowers to
    list-append planes and classifies over the full consistency
    lattice; `CausalChecker` above runs alongside as the oracle.  kw
    goes to the LatticeChecker (device=, algorithm=)."""
    from jepsen_tpu_torch.lattice import adapters
    return adapters.CausalLatticeChecker(model, **kw)
