"""Row-frontier primitives of the serial WGL engine, on torch tensors.

The port's copy of the row-frontier half of `jepsen_tpu/ops/frontier.py`
(`make_bit_ops` :31, `make_dedupe_compact` :67), used by the plain
version of the frontier walk (`ops.frontier_kernel.walk_plain`).  A
configuration is one row: its mask words and its model state.  Dedupe
is a full-content lexicographic sort, never a hash, so distinct
configurations are never merged.

Mask words are 32-bit values held in int64 tensors (so every word
compares unsigned); the callers convert at the frontier's edges.  The
plane-frontier ops of the reference are not needed here: the port's
segment kernels have their own (`ops.regs_kernel`)."""

from __future__ import annotations

import torch

_SENTINEL = 0xFFFFFFFF
_SIGN = 0x80000000


def make_bit_ops(Wd: int):
    """(has_bit, set_bit, clear_bit) over mask rows int64[..., Wd].
    `slot` broadcasts to masks.shape[:-1]."""
    words = torch.arange(Wd)

    def word_bit(slot, dev):
        slot = torch.as_tensor(slot, dtype=torch.int64, device=dev)
        return slot // 32, torch.ones_like(slot) << (slot % 32)

    def has_bit(masks, slot):
        w, bit = word_bit(slot, masks.device)
        w = torch.broadcast_to(w, masks.shape[:-1])
        word = torch.gather(masks, -1, w[..., None])[..., 0]
        return (word & torch.broadcast_to(bit, word.shape)) != 0

    def set_bit(masks, slot):
        w, bit = word_bit(slot, masks.device)
        at = words.to(masks.device) == w[..., None]
        return torch.where(at, masks | bit[..., None], masks)

    def clear_bit(masks, slot):
        w, bit = word_bit(slot, masks.device)
        at = words.to(masks.device) == w[..., None]
        return torch.where(at, masks & ~bit[..., None], masks)

    return has_bit, set_bit, clear_bit


def lexsort(keys) -> torch.Tensor:
    """The permutation that sorts rows by keys[0], then keys[1], ...
    (keys[0] primary), each an int64[P] compared as a number."""
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def state_key(states: torch.Tensor) -> torch.Tensor:
    """int32 states as the unsigned sort key of the reference (the bit
    pattern XOR 0x80000000), in int64."""
    return (states.to(torch.int64) & _SENTINEL) ^ _SIGN


def make_dedupe_compact(Wd: int, S: int):
    """Exact dedupe and compaction of a pool of configs down to
    out_rows: masks int64[P, Wd], states int32[P, S], valid bool[P].
    The survivors are the distinct valid rows in the order of the sort
    (valid first, then the mask words, then the state words XOR
    0x80000000), truncated to out_rows.  Returns (masks, states, valid,
    overflowed, distinct_count).

    The reference sorts the whole pool with the invalid rows as
    sentinels after every valid one; only the valid rows reach the
    output, so this sorts those alone, two 32-bit key words to an int64
    key (the high word's top bit flipped, so the signed order is the
    unsigned one)."""

    def dedupe_compact(masks, states, valid, out_rows: int):
        dev = masks.device
        rows = torch.nonzero(valid).flatten()
        words = [masks[rows, wi] for wi in range(Wd)]
        words += [state_key(states[rows, si]) for si in range(S)]
        if len(words) % 2:
            words.append(torch.zeros_like(words[0]))
        keys = [((words[k] ^ _SIGN) << 32) | words[k + 1]
                for k in range(0, len(words), 2)]
        perm = lexsort(keys) if rows.numel() else rows
        skeys = torch.stack([k[perm] for k in keys]) if keys else None
        first = torch.ones(perm.numel(), dtype=torch.bool, device=dev)
        if perm.numel() > 1:
            first[1:] = (skeys[:, 1:] != skeys[:, :-1]).any(0)
        kept = rows[perm[first]]
        count = kept.numel()
        n = min(count, out_rows)
        out_masks = torch.zeros((out_rows, Wd), dtype=torch.int64,
                                device=dev)
        out_states = torch.zeros((out_rows, S), dtype=torch.int32,
                                 device=dev)
        out_masks[:n] = masks[kept[:n]]
        out_states[:n] = states[kept[:n]]
        out_valid = torch.arange(out_rows, device=dev) < n
        return out_masks, out_states, out_valid, count > out_rows, count

    return dedupe_compact
