"""Carrying state across from the JAX package, as plain data only.

`history_from_dicts` builds this package's History from a list of op
dicts (the JAX package's `Op.to_dict()` output, or any JSON history);
`packed_from_columns` builds a PackedHistory from plain numpy columns
(for example another package's columnar history, field by field);
`tables_to_device` turns packed numpy register-delta tables into
tensors on a device.  Nothing here imports the JAX package: callers
hand over dicts and arrays."""

from __future__ import annotations

import copy
from typing import Iterable

import numpy as np
import torch

from jepsen_tpu_torch.history import History, Op, PackedHistory

#: The array columns of a PackedHistory, in its field order.
PACKED_COLUMNS = ("index", "process", "type", "f", "value", "value_ok",
                  "time", "vkind")


def history_from_dicts(dicts: Iterable[dict]) -> History:
    """A History of Ops built from op dicts with the keys index,
    process, type, f, value, time (and optional error / extra keys).
    A value {"__kv__": [k, v]} (an independent key's tuple, as the JAX
    package's `Op.to_dict()` tags it) becomes `independent.KV(k, v)`.
    Values are copied so the two histories share no mutable payload."""
    ops = []
    for d in dicts:
        d = dict(d)
        if "value" in d:
            d["value"] = copy.deepcopy(d["value"])
        ops.append(Op.from_dict(d))
    return History(ops)


def packed_from_columns(columns: dict, f_codes: dict) -> PackedHistory:
    """A PackedHistory from numpy arrays under the names of
    PACKED_COLUMNS (vkind may be None) and the f tag -> code table;
    every array is copied."""
    cols = {k: (None if columns.get(k) is None
                else np.array(columns[k], copy=True))
            for k in PACKED_COLUMNS}
    return PackedHistory(**cols, f_codes=dict(f_codes))


def tables_to_device(ret_t, islot_t, iuop_t, a1t, a2t, t0t,
                     device="cpu") -> tuple:
    """Packed register-delta tables (ret_t [L, 1], islot_t and iuop_t
    [L, 1, I], a1t/a2t u32[U], t0t i32[U]) as tensors on `device`,
    ready for `ops.wgl_deep.check_tables`.  The u32 masks travel as
    int64 so no bit is lost in a signed dtype."""
    conv = [np.asarray(ret_t, np.int32), np.asarray(islot_t, np.int32),
            np.asarray(iuop_t, np.int32), np.asarray(a1t, np.int64),
            np.asarray(a2t, np.int64), np.asarray(t0t, np.int32)]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in conv)
