"""Seeded independent keys for the jepsen_tpu_torch tests of batched
keys, as op dicts made with numpy (`key_dicts`, shared with
chip_smoke.py, whose serial phases check such keys), and the port's key
launch inputs over them.  Imports no JAX, so the card's test file can
use it."""

from chip_smoke import WARP_KEY_CALLS, key_dicts, op
from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.history import pack_history
from jepsen_tpu_torch.ops import wgl_seg


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
