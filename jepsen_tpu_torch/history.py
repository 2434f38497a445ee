"""Operation histories: an ordered list of operations.

Each op is a small record with the fields

  index    monotone position in the history
  process  logical single-threaded actor id (int >= 0); other ids
           (the nemesis) are not client calls
  type     one of invoke | ok | fail | info
  f        operation function tag (e.g. 'read', 'write', 'cas')
  value    op payload; for reads the invoke carries None and the
           completion carries the observed value
  time     relative nanoseconds since test start
  error    optional error payload on non-ok completions

Only what the linearizability path reads is kept here: the op record,
its constructors and an indexed list.  Persistence and columnar packing
belong to later slices."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, Optional

INVOKE, OK, FAIL, INFO = "invoke", "ok", "fail", "info"

_FIELDS = ("process", "type", "f", "value", "time", "index", "error")


@dataclasses.dataclass
class Op:
    """One operation record."""

    process: Any = None
    type: str = INVOKE
    f: Any = None
    value: Any = None
    time: Optional[int] = None
    index: Optional[int] = None
    error: Any = None
    extra: dict = dataclasses.field(default_factory=dict)

    def assoc(self, **kw) -> "Op":
        """A copy with fields replaced (unknown keys land in extra)."""
        fields = {k: v for k, v in kw.items() if k in _FIELDS}
        extra = dict(self.extra)
        extra.update((k, v) for k, v in kw.items() if k not in _FIELDS)
        return dataclasses.replace(self, extra=extra, **fields)

    @property
    def is_invoke(self):
        return self.type == INVOKE

    def to_dict(self) -> dict:
        d = {"index": self.index, "process": self.process,
             "type": self.type, "f": self.f, "value": self.value,
             "time": self.time}
        if self.error is not None:
            d["error"] = self.error
        d.update(self.extra)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Op":
        d = dict(d)
        kw = {k: d.pop(k) for k in _FIELDS if k in d}
        return cls(extra=d, **kw)


def invoke_op(process, f, value, **kw):
    return Op(process=process, type=INVOKE, f=f, value=value, **kw)


def ok_op(process, f, value, **kw):
    return Op(process=process, type=OK, f=f, value=value, **kw)


def fail_op(process, f, value, **kw):
    return Op(process=process, type=FAIL, f=f, value=value, **kw)


def info_op(process, f, value, **kw):
    return Op(process=process, type=INFO, f=f, value=value, **kw)


def op(like: Any) -> Op:
    """Coerce a dict or Op to an Op."""
    if isinstance(like, Op):
        return like
    return Op.from_dict(like)


class History:
    """An indexed list of Ops."""

    def __init__(self, ops: Iterable[Any] = ()):
        self.ops: list[Op] = [op(o) for o in ops]

    def __len__(self):
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def index(self) -> "History":
        """Assign sequential :index to every op."""
        for i, o in enumerate(self.ops):
            o.index = i
        return self

    def to_dicts(self) -> list[dict]:
        return [o.to_dict() for o in self.ops]
