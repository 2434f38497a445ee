"""Seeded independent keys for the jepsen_tpu_torch tests of batched
keys, as op dicts made with numpy, and the port's key launch inputs
over them.  Imports no JAX, so the card's test file can use it."""

import numpy as np

from chip_smoke import WARP_KEY_CALLS
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.history import pack_history
from jepsen_tpu_torch.ops import wgl_seg


def op(p, t, f, v):
    return {"process": p, "type": t, "f": f, "value": v, "time": None}


def key_dicts(seed, n_calls=40, conc=5, vmax=4, max_open=0, burst=0,
              crash_rate=0.0, buggy=0.0):
    """One key's ops as dicts, made with numpy from `seed`: a register
    workload (read/read/write/cas) run against a sequential register,
    with at most `max_open` normal calls open at once; `burst` writes
    open together at the end (overlap depth at least `burst`);
    `crash_rate` of the calls crash at once (:info, no effect on the
    register); `buggy` of the reads see a random value."""
    rng = np.random.default_rng(seed)
    ops, value, open_ops = [], None, {}
    i = 0
    while i < n_calls:
        p = int(rng.integers(conc))
        if p in open_ops:
            ops.append(open_ops.pop(p))
            continue
        if max_open and len(open_ops) >= max_open:
            ops.append(open_ops.pop(
                sorted(open_ops)[int(rng.integers(len(open_ops)))]))
            continue
        i += 1
        f = ("read", "read", "write", "cas")[int(rng.integers(4))]
        a, b = int(rng.integers(vmax + 1)), int(rng.integers(vmax + 1))
        if crash_rate and rng.random() < crash_rate:
            v = None if f == "read" else a if f == "write" else [a, b]
            ops += [op(p, "invoke", f, v), op(p, "info", f, v)]
            continue
        if f == "read":
            ops.append(op(p, "invoke", "read", None))
            seen = a if buggy and rng.random() < buggy else value
            open_ops[p] = op(p, "ok", "read", seen)
        elif f == "write":
            ops.append(op(p, "invoke", "write", a))
            value = a
            open_ops[p] = op(p, "ok", "write", a)
        else:
            ops.append(op(p, "invoke", "cas", [a, b]))
            if value == a:
                value = b
                open_ops[p] = op(p, "ok", "cas", [a, b])
            else:
                open_ops[p] = op(p, "fail", "cas", [a, b])
    ops.extend(open_ops.values())
    ops += [op(conc + q, "invoke", "write", q % (vmax + 1))
            for q in range(burst)]
    ops += [op(conc + q, "ok", "write", q % (vmax + 1)) for q in range(burst)]
    return [dict(d, index=j) for j, d in enumerate(ops)]


def indexed(ops):
    return [dict(d, index=j) for j, d in enumerate(ops)]


def lane_keys():
    """(name, op dicts, columns?) of keys at R <= 6, some invalid, one
    at R = 6."""
    return ([(f"v{k}", key_dicts(600 + k, n_calls=40, conc=5), k % 2)
             for k in range(8)]
            + [(f"b{k}", key_dicts(610 + k, n_calls=40, conc=5, buggy=0.2),
                k % 2) for k in range(4)]
            + [("r6", key_dicts(620, n_calls=30, conc=7, max_open=6,
                                burst=6), True)])


def port_histories(keys):
    """The port's histories of (name, op dicts, columns?) keys."""
    out = []
    for _, dicts, cols in keys:
        h = convert.history_from_dicts(dicts)
        if cols:
            h.attach_packed(pack_history(h))
        out.append(h)
    return out


def key_launch_inputs(histories):
    """The key launch over `histories` as check_many builds it
    (`wgl_seg.key_launch_inputs`): the host wire (cbuf, offs, nrows,
    aux, in launch order), keys_scan's shape arguments, and the launch
    order (launch position p holds key order[p])."""
    k = wgl_seg.key_launch_inputs(models.CASRegister(), histories)
    return tuple(k[:4]), dict(R=k.R, Sn=k.Sn, UP=k.UP), k.order


#: vmax of a state bucket: 6, 14 and 30 states at SnP 8, 16 and 32
BUCKET_VMAX = {8: 4, 16: 12, 32: 28}
ONE_ROW = indexed([op(0, "invoke", "write", 1), op(0, "ok", "write", 1)])


def warp_keys(R, snp, seed=None, calls=WARP_KEY_CALLS):
    """(name, op dicts, columns?) of keys that split a warp of the key
    kernel, at overlap depth R (one key pinned there by a burst) with
    states in the bucket SnP: random r/w/cas keys of `calls` calls, made
    from `seed` on (their open slots, rank-1 kinds and returning slots
    differ row by row), a third with wrong reads, and a one-row key
    fourth.  The default calls give a one-row key beside keys longer
    than a staged chunk (32 to 128 rows), 11 keys (no multiple of 4 or 2
    keys a warp)."""
    vmax = BUCKET_VMAX[snp]
    seed = 900 + 50 * R + snp if seed is None else seed
    keys = [(f"R{R}-{snp}-{k}",
             key_dicts(seed + k, n_calls=n, conc=R + 1, vmax=vmax,
                       max_open=R, burst=R if k == 0 else 0,
                       buggy=0.2 if k % 3 == 1 else 0.0), k % 2 == 0)
            for k, n in enumerate(calls)]
    return keys[:3] + [("one-row", ONE_ROW, False)] + keys[3:]
