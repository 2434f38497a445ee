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

Only what the linearizability path and Elle's inference read is kept
here: the op record, its constructors, an indexed list, and the
history's columnar form (`PackedHistory`, built by `pack_history` or
journaled op by op by `ColumnJournal`), which the native scanners read
without touching the Op objects.  Persistence (the write-ahead log and its readers) is not
part of the checker and is left out."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, Optional

import numpy as np

#: Process id of the nemesis in the process column: anything that is
#: not a client process.
NEMESIS = -1

INVOKE, OK, FAIL, INFO = "invoke", "ok", "fail", "info"
TYPES = (INVOKE, OK, FAIL, INFO)
TYPE_CODE = {t: i for i, t in enumerate(TYPES)}

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

    @property
    def is_ok(self):
        return self.type == OK

    @property
    def is_fail(self):
        return self.type == FAIL

    @property
    def is_info(self):
        return self.type == INFO

    def to_dict(self) -> dict:
        v = self.value
        if type(v).__name__ == "KV" and isinstance(v, tuple):
            # an independent key's tuple, tagged so that it survives a
            # JSON round trip (the JAX package writes the same tag)
            v = {"__kv__": [v[0], v[1]]}
        d = {"index": self.index, "process": self.process,
             "type": self.type, "f": self.f, "value": v,
             "time": self.time}
        if self.error is not None:
            d["error"] = self.error
        d.update(self.extra)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Op":
        d = dict(d)
        kw = {k: d.pop(k) for k in _FIELDS if k in d}
        v = kw.get("value")
        if isinstance(v, dict) and set(v) == {"__kv__"}:
            from jepsen_tpu_torch.independent import KV   # imports this
            kw["value"] = KV(*v["__kv__"])
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
    """An indexed list of Ops.  With `journal=True` every op, those given
    and those appended, also lands in a ColumnJournal, so the columnar
    form exists as soon as the ops do."""

    def __init__(self, ops: Iterable[Any] = (), journal: bool = False):
        self.ops: list[Op] = [op(o) for o in ops]
        self._packed: Optional[PackedHistory] = None
        self._journal: Optional[ColumnJournal] = None
        if journal:
            self._journal = ColumnJournal()
            for o in self.ops:
                self._journal.append(o)

    def __len__(self):
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def append(self, o: Any) -> Op:
        """Append one op; an attached columnar form is dropped (it is
        positional), a journal takes the op."""
        o = op(o)
        self.ops.append(o)
        self._packed = None
        if self._journal is not None:
            self._journal.append(o)
        return o

    def invalidate_packed(self) -> None:
        """Drop the attached columnar form.  Call it after editing an op
        in place: append() drops it by itself, but an in-place edit would
        otherwise leave the native scanners reading columns that the ops
        no longer match.  It also bumps the dropped form's `version`, so
        any holder of that instance rebuilds the casts it cached."""
        if self._packed is not None:
            self._packed.version += 1
        self._packed = None

    def packed_columns(self) -> Optional["PackedHistory"]:
        """The columnar form if one exists (attached, or built by the
        journal), without walking the ops; None otherwise."""
        if self._packed is not None:
            return self._packed
        if self._journal is not None:
            return self._journal.packed()
        return None

    def attach_packed(self, packed: "PackedHistory") -> "History":
        """Attach a columnar form built for these ops (`pack_history`,
        or a ColumnJournal kept while the ops were recorded)."""
        if len(packed) != len(self.ops):
            raise ValueError(f"{len(packed)} packed rows for "
                             f"{len(self.ops)} ops")
        self._packed = packed
        return self

    def index(self) -> "History":
        """Assign sequential :index to every op."""
        for i, o in enumerate(self.ops):
            o.index = i
        return self

    def to_dicts(self) -> list[dict]:
        return [o.to_dict() for o in self.ops]


@dataclasses.dataclass
class PackedHistory:
    """The columnar form of a history.  Two int64 value slots cover the
    register workloads (a cas carries [old, new]); value_ok marks the
    slots that held an integer.  `vkind` says what each op's value was,
    for the native column scan: 0 None, 1 an int32 int (or a bool), 2 an
    int32 [a, b] pair, 3 anything else, 4 an int or pair outside int32.

    The scan wrappers cache contiguous casts of these columns on the
    instance (`_scan_cols`, see `ops.planner._cols_args`), keyed by
    (version, len).  Code that edits a column in place bumps `version`
    (History.invalidate_packed() does), or the cache goes stale."""

    index: np.ndarray       # int32 [n]
    process: np.ndarray     # int32 [n]  (NEMESIS, P_OUT_OF_RANGE)
    type: np.ndarray        # uint8 [n]  TYPE_CODE
    f: np.ndarray           # int32 [n]  codes of f_codes
    value: np.ndarray       # int64 [n, 2]
    value_ok: np.ndarray    # bool  [n, 2]
    time: np.ndarray        # int64 [n]
    f_codes: dict           # f tag -> code
    vkind: Optional[np.ndarray] = None  # uint8 [n]
    version: int = 0

    def __len__(self):
        return len(self.index)

    def take(self, keep: np.ndarray) -> "PackedHistory":
        """The columns of the ops at positions `keep`, in that order."""
        return PackedHistory(
            self.index[keep], self.process[keep], self.type[keep],
            self.f[keep], self.value[keep], self.value_ok[keep],
            self.time[keep], dict(self.f_codes),
            vkind=None if self.vkind is None else self.vkind[keep])


_I32 = 2 ** 31
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

#: Process-column value of a client process outside int32: the column
#: scans refuse such a history, and the object scan, which sees the real
#: id, takes it.
P_OUT_OF_RANGE = -2


def _i32_process(p) -> int:
    """Process column value: an exact int in 0..2^31-1 as itself, an
    exact int past that P_OUT_OF_RANGE, anything else (a nemesis tag, a
    bool, a negative int) NEMESIS.  Never raises."""
    if type(p) is int:
        return p if 0 <= p < _I32 else \
            (P_OUT_OF_RANGE if p >= _I32 else NEMESIS)
    return NEMESIS


def _i32_index(idx, fallback: int) -> int:
    """Index column value: the op's own index when it is an int32 int,
    else its position."""
    return idx if isinstance(idx, int) and not isinstance(idx, bool) \
        and -_I32 <= idx < _I32 else fallback


def _fits_i64(x: int) -> bool:
    return _I64_MIN <= x <= _I64_MAX


def default_value_encoder(o: Op) -> tuple[list[int], list[bool]]:
    """An op value in two int64 slots: an int (or bool) in slot 0, an
    [a, b] pair in both, None or anything else (an int past int64 too)
    marked not-ok.  Never raises."""
    v = o.value
    if isinstance(v, bool):
        return [int(v), 0], [True, False]
    if isinstance(v, int):
        if not _fits_i64(v):
            return [0, 0], [False, False]
        return [v, 0], [True, False]
    if (isinstance(v, (list, tuple)) and len(v) == 2
            and all(isinstance(x, int) and not isinstance(x, bool)
                    for x in v)):
        if not (_fits_i64(v[0]) and _fits_i64(v[1])):
            return [0, 0], [False, False]
        return [v[0], v[1]], [True, True]
    return [0, 0], [False, False]


def _value_kind(v) -> int:
    """The vkind of a value (see PackedHistory)."""
    if v is None:
        return 0
    if isinstance(v, bool):
        return 1
    if isinstance(v, int):
        return 1 if -_I32 <= v < _I32 else 4
    if (isinstance(v, (list, tuple)) and len(v) == 2
            and all(isinstance(x, int) and not isinstance(x, bool)
                    for x in v)):
        return 2 if all(-_I32 <= x < _I32 for x in v) else 4
    return 3


def pack_history(h: History, f_codes: Optional[dict] = None,
                 value_encoder=None) -> PackedHistory:
    """The columnar form of `h`: f tags coded in order of first use
    unless `f_codes` is given; a custom `value_encoder` leaves vkind
    None, which the column scans refuse."""
    custom_encoder = value_encoder is not None
    value_encoder = value_encoder or default_value_encoder
    if f_codes is None:
        f_codes = {}
        for o in h:
            if o.f not in f_codes:
                f_codes[o.f] = len(f_codes)
    n = len(h)
    index = np.zeros(n, np.int32)
    process = np.zeros(n, np.int32)
    typ = np.zeros(n, np.uint8)
    f = np.zeros(n, np.int32)
    value = np.zeros((n, 2), np.int64)
    value_ok = np.zeros((n, 2), bool)
    time = np.zeros(n, np.int64)
    vkind = None if custom_encoder else np.zeros(n, np.uint8)
    for i, o in enumerate(h):
        index[i] = _i32_index(o.index, i)
        process[i] = _i32_process(o.process)
        typ[i] = TYPE_CODE[o.type]
        f[i] = f_codes.get(o.f, -1)
        (value[i, 0], value[i, 1]), (value_ok[i, 0], value_ok[i, 1]) = \
            value_encoder(o)
        time[i] = o.time if o.time is not None else 0
        if vkind is not None:
            vkind[i] = _value_kind(o.value)
    return PackedHistory(index, process, typ, f, value, value_ok, time,
                         dict(f_codes), vkind=vkind)


class ColumnJournal:
    """The columnar form built op by op, as a run records its ops, so
    that it exists when the run ends; `packed()` views it as a
    PackedHistory."""

    _COLS = ("index", "process", "type", "f", "value", "value_ok", "time",
             "vkind")

    def __init__(self, cap: int = 1024):
        self._n = 0
        self._cap = cap
        self.f_codes: dict = {}
        self._alloc(cap)

    def _alloc(self, cap):
        self.index = np.zeros(cap, np.int32)
        self.process = np.zeros(cap, np.int32)
        self.type = np.zeros(cap, np.uint8)
        self.f = np.zeros(cap, np.int32)
        self.value = np.zeros((cap, 2), np.int64)
        self.value_ok = np.zeros((cap, 2), bool)
        self.time = np.zeros(cap, np.int64)
        self.vkind = np.zeros(cap, np.uint8)

    def _grow(self):
        old = [getattr(self, name) for name in self._COLS]
        self._cap *= 2
        self._alloc(self._cap)
        for o, name in zip(old, self._COLS):
            getattr(self, name)[:len(o)] = o

    def append(self, o: Op) -> None:
        i = self._n
        if i == self._cap:
            self._grow()
        self.index[i] = _i32_index(o.index, i)
        self.process[i] = _i32_process(o.process)
        self.type[i] = TYPE_CODE[o.type]
        fc = self.f_codes.get(o.f)
        if fc is None:
            fc = self.f_codes[o.f] = len(self.f_codes)
        self.f[i] = fc
        (self.value[i, 0], self.value[i, 1]), \
            (self.value_ok[i, 0], self.value_ok[i, 1]) = \
            default_value_encoder(o)
        self.time[i] = o.time if o.time is not None else 0
        self.vkind[i] = _value_kind(o.value)
        self._n = i + 1

    def packed(self) -> PackedHistory:
        n = self._n
        return PackedHistory(self.index[:n], self.process[:n],
                             self.type[:n], self.f[:n], self.value[:n],
                             self.value_ok[:n], self.time[:n],
                             dict(self.f_codes), vkind=self.vkind[:n])
