"""Consistency models: pure state machines that judge single operations.

A Model has one operation, `step(op) -> Model' | Inconsistent`.  Every
model here is immutable and hashable (the CPU oracle memoizes
(mask, model) configurations).  Models that the device engines can
check also provide a `DeviceSpec`: an integer state-vector encoding and
a transition `step` written on torch tensors, batched over a leading
axis."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch


class Inconsistent:
    """Returned by step() when the op cannot legally apply."""

    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(x) -> bool:
    return isinstance(x, Inconsistent)


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Integer encoding of a model for the device engines.

    state_size : words in the int32 state vector
    f_codes    : f tag -> small int used by step
    encode     : model -> np.int32[state_size] initial state
    step       : torch fn (state i32[N, S], f i32[N], a i32[N], b i32[N],
                 a_ok bool[N]) -> (state' i32[N, S], legal bool[N])
    pure       : optional torch fn (f, a, b, a_ok) -> bool[N]: True where
                 the op never modifies state, for any state (reads)
    decode     : optional np.int32[state_size] -> Model, the inverse of
                 `encode`; the segment kernel's witness localization
                 seeds the CPU oracle with decoded entry states
    device_step: the transition the serial frontier kernel compiles in
                 (`csrc/wgl_frontier.cu`): "register" (the reference's
                 `_register_step`) or "mutex" (`_mutex_step`); None for
                 a model that kernel cannot run
    """

    state_size: int
    f_codes: dict
    encode: Callable[[Any], np.ndarray]
    step: Callable
    pure: Optional[Callable] = None
    decode: Optional[Callable] = None
    device_step: Optional[str] = None


class Model:
    def step(self, op) -> "Model | Inconsistent":
        raise NotImplementedError

    def device_spec(self) -> Optional[DeviceSpec]:
        return None


# ---------------------------------------------------------------------------
# Register / CAS register
# ---------------------------------------------------------------------------

_REG_F = {"read": 0, "write": 1, "cas": 2}
_NONE_CODE = -(2 ** 31)     # encodes value=None; no workload writes it


def _register_pure(f, a, b, a_ok):
    return f == 0           # reads never modify the register


def _register_step(state, f, a, b, a_ok):
    """Shared transition of register and cas-register.  read -> legal
    iff unknown value or state == a; write -> state' = a; cas -> legal
    iff state == a, state' = b."""
    cur = state[:, 0]
    is_read = f == 0
    is_write = f == 1
    is_cas = f == 2
    legal = torch.where(is_read, (~a_ok) | (cur == a),
                        torch.where(is_cas, cur == a,
                                    torch.ones_like(is_read)))
    new = torch.where(is_write, a, torch.where(is_cas, b, cur))
    return torch.where(legal, new, cur)[:, None].to(torch.int32), legal


def _register_encode(m):
    return np.array([_NONE_CODE if m.value is None else m.value],
                    np.int32)


def _register_value(state):
    v = int(state[0])
    return None if v == _NONE_CODE else v


@dataclasses.dataclass(frozen=True)
class CASRegister(Model):
    """A register supporting read/write/cas (knossos cas-register)."""

    value: Optional[int] = None

    def step(self, op):
        f, v = op.f, op.value
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(
                f"read {v!r} but register holds {self.value!r}")
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            old, new = v
            if self.value != old:
                return inconsistent(f"cas {old!r}->{new!r} but register "
                                    f"holds {self.value!r}")
            return CASRegister(new)
        return inconsistent(f"unknown f {f!r}")

    def device_spec(self):
        return DeviceSpec(1, dict(_REG_F), _register_encode,
                          _register_step, pure=_register_pure,
                          decode=lambda s: CASRegister(_register_value(s)),
                          device_step="register")


@dataclasses.dataclass(frozen=True)
class Register(Model):
    """read/write register (knossos register)."""

    value: Optional[int] = None

    def step(self, op):
        f, v = op.f, op.value
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(
                f"read {v!r} but register holds {self.value!r}")
        if f == "write":
            return Register(v)
        return inconsistent(f"unknown f {f!r}")

    def device_spec(self):
        return DeviceSpec(1, dict(_REG_F), _register_encode,
                          _register_step, pure=_register_pure,
                          decode=lambda s: Register(_register_value(s)),
                          device_step="register")


# ---------------------------------------------------------------------------
# Mutex
# ---------------------------------------------------------------------------

_MUTEX_F = {"acquire": 0, "release": 1}


def _mutex_step(state, f, a, b, a_ok):
    locked = state[:, 0] != 0
    want = f == 0           # acquire
    legal = torch.where(want, ~locked, locked)
    new = torch.where(legal, want.to(torch.int32), state[:, 0])
    return new[:, None].to(torch.int32), legal


@dataclasses.dataclass(frozen=True)
class Mutex(Model):
    """knossos mutex: acquire/release."""

    locked: bool = False

    def step(self, op):
        if op.f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a held mutex")
            return Mutex(True)
        if op.f == "release":
            if not self.locked:
                return inconsistent("cannot release a free mutex")
            return Mutex(False)
        return inconsistent(f"unknown f {op.f!r}")

    def device_spec(self):
        return DeviceSpec(1, dict(_MUTEX_F),
                          lambda m: np.array([int(m.locked)], np.int32),
                          _mutex_step,
                          decode=lambda s: Mutex(bool(int(s[0]))),
                          device_step="mutex")


# ---------------------------------------------------------------------------
# Host models without a device spec: `Linearizable` refuses them under
# 'auto' and 'device' (ROADMAP P6); the queue checkers step them
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NoOp(Model):
    """knossos noop: accepts everything."""

    def step(self, op):
        return self


@dataclasses.dataclass(frozen=True)
class UnorderedQueue(Model):
    """knossos unordered-queue: a multiset; dequeue of an absent element
    is inconsistent (the queue checker's model)."""

    items: tuple = ()       # the multiset, sorted by repr

    def step(self, op):
        if op.f == "enqueue":
            return UnorderedQueue(tuple(sorted(self.items + (op.value,),
                                               key=repr)))
        if op.f == "dequeue":
            if op.value in self.items:
                items = list(self.items)
                items.remove(op.value)
                return UnorderedQueue(tuple(items))
            return inconsistent(f"can't dequeue {op.value!r}: not present")
        return inconsistent(f"unknown f {op.f!r}")


@dataclasses.dataclass(frozen=True)
class FIFOQueue(Model):
    """knossos fifo-queue."""

    items: tuple = ()

    def step(self, op):
        if op.f == "enqueue":
            return FIFOQueue(self.items + (op.value,))
        if op.f == "dequeue":
            if not self.items:
                return inconsistent("can't dequeue an empty queue")
            if self.items[0] != op.value:
                return inconsistent(
                    f"dequeued {op.value!r} but head was {self.items[0]!r}")
            return FIFOQueue(self.items[1:])
        return inconsistent(f"unknown f {op.f!r}")


@dataclasses.dataclass(frozen=True)
class MultiRegister(Model):
    """knossos multi-register: txn reads and writes over a few keys; an
    op's value is a list of [f, k, v] micro-ops."""

    registers: tuple = ()   # (key, value) pairs, sorted by repr

    def as_dict(self):
        return dict(self.registers)

    def step(self, op):
        regs = self.as_dict()
        for mf, k, v in op.value or []:
            if mf in ("r", "read"):
                if v is not None and regs.get(k) != v:
                    return inconsistent(
                        f"read {v!r} from {k!r} which holds {regs.get(k)!r}")
            elif mf in ("w", "write"):
                regs[k] = v
            else:
                return inconsistent(f"unknown micro-op {mf!r}")
        return MultiRegister(tuple(sorted(regs.items(), key=repr)))


# ---------------------------------------------------------------------------
# Registry: names usable from test maps
# ---------------------------------------------------------------------------

MODELS = {
    "cas-register": CASRegister,
    "register": Register,
    "mutex": Mutex,
    "noop": NoOp,
    "unordered-queue": UnorderedQueue,
    "fifo-queue": FIFOQueue,
    "multi-register": MultiRegister,
}


def model(name: str, *args, **kw) -> Model:
    return MODELS[name](*args, **kw)


def cas_register(value=None):
    return CASRegister(value)


def register(value=None):
    return Register(value)


def mutex():
    return Mutex()


def noop():
    return NoOp()


def unordered_queue():
    return UnorderedQueue()


def fifo_queue():
    return FIFOQueue()
