"""Smoke run of jepsen_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing what it measured on lines tagged with its name;
any failure exits non-zero:

  device     - the card, and nvidia-smi's name and power limit;
  build      - one nvcc per source (csrc/wgl_deep.cu, csrc/wgl_regs.cu,
               csrc/wgl_crash.cu, csrc/wgl_frontier.cu, csrc/elle_pmm.cu,
               csrc/fold.cu, csrc/cycle.cu, csrc/lattice_masks.cu,
               csrc/wgl_cand.cu), started together, for sm_90a
               (timed); ptxas registers and
               spill bytes of each kernel instantiation; a spill in the
               deep kernel's warp arm, the candidate-table kernels or the
               crash kernel's two-word instances fails; then the native history
               scanner (native/histscan.c) with the host C compiler
               (timed, the compiler named);
  columns    - printed by each phase that builds full-size histories:
               the seconds pack_history and attach_packed take to give
               them their columns, as a run that journals its ops has
               them (a cost moved off the check, not saved);
  kernel     - each deep arm against the plain PyTorch version (on CPU
               copies of the same inputs) on 600-call histories at its
               edges and plane sizes: warp arm R = 3, 5, 8, 10 (twice),
               block arm R = 11 (twice), 12, 14, 15, 16 (twice), with
               SnP 8, 16 and 32 on each arm and the global-memory plane
               at R = 16, SnP = 32; one valid and one planted-invalid
               history each: verdict, first dead row and plane words;
               kernel time (launch to end) and bound per case; the R = 3
               verdicts also against the exact CPU oracle;
  seg-kernel - the segment kernel against its plain version on CPU
               copies of the same inputs: 400-call histories at
               R = 1..6 x SnP 8/16/32, valid and planted-invalid, at
               rounds R and 2, and one with more than 255 uop ids:
               transfer matrices, operation counts (each lane's rounds
               to its fixpoint), the exact verdict;
  scan       - the C scanners (the stream pass, the column scan, the
               object walk) against the plain Python scan with
               pack_stream on the same histories in one call: the whole
               north-star batch and the envelope at max_open 12; every
               field (n_calls, max_open, cuts, positions, the return and
               open-set arrays, the delta stream), seen, rows, the
               segment wire's bytes and the envelope's deep tables must
               be equal; seconds of each scanner;
  main       - the deep-overlap envelope at full size: 16 etcd-shaped
               register histories of 20,000 calls (concurrency 16, vmax
               9, read/read/write/cas) per depth max_open 8/10/12/14,
               through wgl_deep.check_pipeline and Linearizable, plus
               planted stale reads at 90% depth whose exact witness must
               come back; the deep kernel's launches per arm are counted;
  grid       - the envelope's grids rebuilt as check_pipeline built them
               and launched again: every CTA's verdict must equal the
               main path's, the mixed grid must launch both arms, and
               chosen CTAs must equal the plain version, in worker
               processes;
  timing     - per deep arm, the kernel, its plain version and the bound
               on one envelope history (depth 8 warp, depth 12 block);
  seg-main   - the north-star batch: 24 register histories of 100,000
               calls (concurrency 5, vmax 9) through wgl_seg.check_pipeline
               (all valid, engine wgl_seg), one through Linearizable, and
               a planted stale read through both whose exact witness must
               come back; the segment kernel's and wgl_compose's launches
               are counted (one composition per scan) and torch.bmm's
               calls (none);
  seg-grid / seg-timing
             - the batch's first group rebuilt as the pipeline built it:
               chosen segment lanes against the plain version; then the
               group launch and check()'s launch on one history, each
               against its plain version and its bound, and wgl_compose
               on the group's matrices beside the torch.bmm levels that
               composed them before, its plain version and its bound,
               for the JSON kernel line;
  crash-kernel
             - the segment kernel's crash variants against their plain
               version on CPU copies of the same inputs: the crash
               variant at nc = 1..4 crashed calls and R + nc = 2..8
               with (nc, Sn) at (1, 32), (2, 32), (3, 16), (4, 8); the
               relaxed variant and the death row at R = 1..6 x SnP
               8/16/32 with 1, 40 and 300 crash prefixes; valid and
               planted-invalid: transfer rows, verdict words, death rows
               and operation counts;
  crash-main - the crash tiers at full size through Linearizable: (a)
               the hard regime (50,000 calls, 16 processes, 1% crashed)
               proven valid on its stripped twin, (b) the same shape
               with a stale read planted at 90% depth refuted under
               relaxed crash semantics at the planted read, (c) a
               north-star history with four completions turned :info
               on the nc = 3 segment kernel, valid and planted, (d) an
               envelope history with two crashed writes on the deep
               warp arm at R = 10, valid and planted; stage seconds of
               each; the crash kernels' launches are counted from here;
  crash-pipeline
             - a north-star batch with four histories shaped as (c)
               through check_pipeline: those through check(), with the
               single calls' verdicts, the rest pipelined;
  crash-timing
             - the tier-2 launch of (c), the relaxed launch of (b) and
               its death-row launch against their plain versions and
               bounds, for the JSON kernel line (the relaxed bound from
               the operations the walk needs, beside the work= count's);
  compose    - wgl_compose against its plain version on CPU copies: the
               north-star group's matrices, one history's, (c)'s J = 88
               and (b)'s, deaths made at the first, a middle and the last
               segment, and seeded matrices at J = 1, 33, 88 and 128 on
               unaligned starts; then (c)'s and (b)'s compositions timed
               against the torch.bmm levels in turns;
  many-main  - the JAX package's multi-key workload: 3400 keys of 300
               calls (r/w/cas, vmax 4, concurrency 5) through
               wgl_seg.check_many, once to warm up and once timed: every
               key valid on the key launch (engine wgl_seg_batch_regs,
               one launch of wgl_regs_keys and none of the segment
               kernel); wall, ops/s, stage seconds, launches, kernel ms
               and host share; then a stale read planted in 3 keys:
               those and only those invalid, at the planted read;
  many-crash - 850 keys, 1% of calls crashed on every third key: every
               key valid and batched (crash-stripped twins, one key
               launch), the crashed calls ignored counted;
  many-kernel
             - the key launch (wgl_regs_keys) rebuilt as check_many
               builds it, against the plain version byte for byte on
               CPU copies of the same inputs (rows and operation
               counts): its first 256 keys, launches that split a warp
               (R = 4 and 6 at SnP 8 / 16 / 32, a one-row key beside
               long ones, 11 keys, a key refused alone) and the full
               launch; cycles a row of it and of the J = 1 launch of
               the segment kernel it replaced, in turns, at one key an
               SM and at the full batch; timed both ways beside its
               bound (from the operations the walk needs, beside the
               work= count's), with the CTAs, the registers and the
               CTAs an SM;
  many-independent
             - one keyed history of 64 keys through
               independent.batch_checker: its results equal check_many's
               on the subhistories, and failures names the planted key;
  serial-kernel
             - the serial frontier walk (wgl_frontier) against its plain
               version on CPU copies (on the card for the R = 18 walks at
               F = 8192 and 65536), launch by launch from the same
               entering frontier: the fast path, every pool tier with
               escalation, overflow at the last size, chunk boundaries,
               crash groups with dominance at 1, 2 and 4 mask words, a
               mutex, write bursts at 2, 3 and 5 key words (varying bits
               in every word, two values, truncations inside runs of
               equal high digits), pools past one SM on the grid, and the
               R = 18 history's deciding walk; outputs, frontier words and
               work= counts equal; each case's rounds by form (shared
               memory, grid-built, grid-sorted) and CTAs; two cases
               timed;
  serial-main
             - the JAX package's mixed-depth envelope batch, not cut: three
               histories of 20,000 calls at concurrency 16 and max_open
               14, an R = 15 one and an R = 18 one of 1,200 calls plus a
               write burst, through wgl_deep.check_pipeline: all valid,
               R = 15 word-split on the deep grid, R = 18 a straggler on
               the serial engine (wgl_frontier's launches counted); then
               the R = 18 history and a planted twin through
               Linearizable (refuted at the planted read); the R = 18
               walk at F = 1024 and the walk that decides it timed beside
               their plain versions and their bounds, for the JSON kernel
               line, with the deciding walk's dedupes by pool size (the
               plain version's count);
  serial-crash
             - ROADMAP C3's three keys and eight residual keys of the
               [many-crash] shape (fixed seeds, printed), each one that
               wgl_seg.check leaves open, through check_many (engine
               fallback) and Linearizable (engine wgl): the CPU oracle's
               verdict and witness; one walk timed;
  elle-kernel
             - elle_pmm (the packed boolean product) and its tile count
               elle_tile_bits against their plain versions on the card,
               bit for bit with the change flag: random packed planes at
               n_pad 128, 384, 1024 and 10,112 and densities 1/n, 4/n,
               0.05 and 0.5; mixed planes at n_pad 384 and 10,112 (row
               tiles split between sparse and dense, so that one launch
               takes both forms; a tile at the crossover and one bit
               above it; all zero; all one), a product and a closure
               round each, the forms each launch took checked against
               the rule; every round of the bench's 10,000-txn closure,
               each timed both ways beside its densities, its row tiles
               per form, the plain version, the library's product (4
               torch.matmul of bf16 operands, thresholded) and its bound,
               and the closure's total; the crossover measured again
               (a dense round's time a term-tile over gathered rounds'
               time a set bit); the tile count timed beside its plain
               version and bound; registers, spills and shared memory of
               every instantiation from [build];
  elle-main  - the JAX package's Elle bench planes (bench.py:2139-2188):
               8 histories of 1,000 txns and 1 of 10,000, a planted
               G-single in the even ones, through elle_graph.classify_batch
               (dense) and elle_mesh.classify_mesh (packed): anomalies
               exactly {G-single} or {}, equal defining edges, the
               1,000-txn rows equal to the numpy oracle; seconds a
               history, rounds and peak device memory of each tier;
  elle-check - Elle().check on simulated list-append histories (a
               serializable store, concurrency 10, the JAX package's
               list-append defaults) of 1,000 txns (the dense tier) and
               10,000 (the packed tier), clean and with a planted G1c,
               G-single, G2-item and G1a block: verdict, anomaly-types,
               not, weakest-violated, every witness a cycle of the
               planes, infer_s and classify_s; then
               independent.batch_checker(Elle()) over 64 keys with three
               planted keys; the Elle kernels' launches over the checks
               are the kernel line's;
  fold       - the JAX package's config 5 at its bench's size
               (bench.py:1406-1416): set_masks on 1,000,000 adds with
               every 97th lost (10,310 lost), Set().check on a set
               history of 1,000,000 adds (lost, unexpected and recovered
               elements planted) and UniqueIds().check on 1,000,000 acks
               (repeated ones planted), each equal to device="cpu"'s and
               to the planted counts, with the seconds of the device call
               against the host loop; fold_member's launches over them
               counted; then fold_member against its plain version bit
               for bit (the three modes, int32 and int64, empty ys and
               xs) and timed on the bench's fold beside its plain
               version, torch.searchsorted and its bound;
  cycle      - config 4: scc of the bench's 2048-node graph with a
               100-cycle (bench.py:1387-1399; the ring one component on
               a cycle, everything equal to device="cpu"'s), then
               TxnCycleChecker().check on simulated rw-register
               histories of 1,000 and 10,000 txns, clean and with a
               planted G0 (valid: commit-order versions admit no ww
               cycle), G1c, G-single, G2 and G1a block: anomaly-types
               exactly the planted ones, the 1,000-txn results equal to
               device="cpu"'s, the wall split into scc, the cycle walks
               and the host loops; elle_tile_bits', elle_pmm's and
               cycle_labels' launches over them counted; then every
               closure round (product, change flag, transpose) and
               cycle_labels against their plain versions on 14 graphs
               and on the six 10,000-txn checks' DSGs (n_pad 10,112),
               and cycle_labels timed on the bench graph's closure and
               the clean 10,000-txn DSG's;
  lattice    - the full-lattice checker on [elle-check]'s simulated
               list-append store at 1,000 txns (LatticeChecker().check,
               the dense tier) and 10,000 (check_planes on planes
               inferred once, the packed tier), clean and with a planted
               G1c, G-single, G2-item, G1a and read-your-writes block:
               at 1,000 txns the reference's verdict fields and witness
               steps (LATTICE_EXPECT, read off the JAX package on the
               CPU), at 10,000 the same classes and the dense tier's
               (algorithm="device") anomalies equal to the packed
               tier's; stage seconds (inference and planes, pack,
               rounds, transposes, masks, witness) and rounds; then the
               causal, long-fork and monotonic adapters once each on a
               planted history (oracle-agrees); elle_tile_bits',
               elle_pmm's and lattice_masks' launches over the checks
               counted;
  lattice-kernel
             - lattice_masks against masks_plain bit for bit on the six
               10,000-txn stacks' planes and transposes and on random
               planes at n_pad 128 and 10,112 (all zero, all one, three
               densities), timed both ways on the clean stack beside its
               plain version and its byte bound; the clean stack's
               closure round by round on the card beside each round's
               bound, its first and last rounds against
               lattice_round_plain bit for bit and timed beside it and
               the library's 9 bf16 products;
  cand-kernel
             - both candidate-table kernels (wgl_cand_bits, wgl_cand_dense)
               against their plain version on CPU copies of the same
               plan tables, transfer rows bit for bit, and each case's
               launch timed both ways: the dense form on
               decomposed wide registers at R = 1..6 (33..64 states) and
               a counter mod 12 (undecomposed, 12 states), the bits form
               on registers at R = 7, 8, 10 and a counter mod 3 (the
               nibble form), each at J = Sn and J = 1;
  wide-main  - the candidate-table route on the main path: the crash-free
               twin of the JAX package's wide-state history (bench.py:
               1717-1725: a 40-value CAS register, 20,000 calls, 16
               processes, max_open 6; 42 states) through Linearizable,
               valid on wgl_cand_dense, its planted stale read invalid at
               the CPU oracle's op; 512 wide keys through check_many in
               one J = 1 launch, verdicts equal to the CPU oracle's on a
               sample; a counter mod 3 through Linearizable (the bits
               form's nibbles), valid and planted; an envelope history at
               max_open 8 as a PreparedHistory (the bits form at R = 8);
               the kernels' launches over these calls counted; then the
               keys' launch, rebuilt by check_many's host half, against
               its plain version bit for bit; the wide history's and the
               envelope's launches timed beside their plain versions and
               bounds; the envelope's tables timed in both forms;
  wide-crash - the JAX package's wide-state crash regime (bench.py:
               1717-1740: 1% crashed with values 0..30, a stale read
               planted at 90% with 0..30 forbidden) through
               wgl_seg.check: refuted by the relaxed tier at two-word
               state masks (W = 2) with the planted read as its exact
               witness; the W = 2 launches counted; the relaxed launch
               and the death row against their plain version (PyTorch on
               the card) and timed.

Kernel times come two ways, each a field of the JSON kernel line: "ms",
from an idle card's launch to its end (CUDA events around one call,
the host's enqueue included; `launch_ms`), and "device_ms", launches
enqueued back to back behind a device sleep (`device_ms`).

A "[time]" line gives each phase's wall seconds.  The last line is
{"ok": true, "device": {...}}.  Exits non-zero with
no result line when torch.cuda.is_available() is false or the package
is missing."""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import multiprocessing
import os
import random
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

SMEM_BYTES_PER_CLOCK = 128          # one SM's shared-memory bandwidth
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Workload: an etcd-shaped register history generator and a subtle-
# violation planter (the shapes the JAX package's bench prices)
# ---------------------------------------------------------------------------

def make_history(n_ops, concurrency, seed, vmax=9, max_open=0, burst=0,
                 cas_hits=False, crash_rate=0.0, crash_vmax=0):
    """A register workload (read/read/write/cas) executed against a
    sequential in-memory register with process interleaving, bounded to
    `max_open` simultaneously-open normal calls; `n_ops` counts calls.
    With `burst`, that many writes open together at the end, so the
    overlap depth is at least `burst`.  With `cas_hits`, every cas names
    the register's value as its old value and succeeds, so the distinct
    (old, new) pairs run into the hundreds of uop ids.  With
    `crash_rate`, that share of calls time out: an invoke and at once an
    :info completion, no effect on the register; `crash_vmax` > 0 draws
    their values from 0..crash_vmax (the nemesis-run shape of the JAX
    package's bench, `make_history`)."""
    from jepsen_tpu_torch.history import (History, fail_op, info_op,
                                          invoke_op, ok_op)
    rng = random.Random(seed)
    ops, value = [], None
    open_ops: dict = {}
    procs = list(range(concurrency))
    i = 0
    while i < n_ops:
        p = rng.choice(procs)
        if p in open_ops:
            ops.append(open_ops.pop(p))
            continue
        if max_open and len(open_ops) >= max_open:
            ops.append(open_ops.pop(rng.choice(list(open_ops))))
            continue
        i += 1
        f = rng.choice(("read", "read", "write", "cas"))
        if crash_rate and rng.random() < crash_rate:
            cm = crash_vmax or vmax
            v = (None if f == "read" else rng.randint(0, cm)
                 if f == "write" else
                 [rng.randint(0, cm), rng.randint(0, cm)])
            ops.append(invoke_op(p, f, v))
            ops.append(info_op(p, f, v))
            continue
        if f == "read":
            ops.append(invoke_op(p, "read", None))
            open_ops[p] = ok_op(p, "read", value)
        elif f == "write":
            v = rng.randint(0, vmax)
            ops.append(invoke_op(p, "write", v))
            value = v
            open_ops[p] = ok_op(p, "write", v)
        else:
            old, new = rng.randint(0, vmax), rng.randint(0, vmax)
            if cas_hits and value is not None:
                old = value
            ops.append(invoke_op(p, "cas", [old, new]))
            if value == old:
                value = new
                open_ops[p] = ok_op(p, "cas", [old, new])
            else:
                open_ops[p] = fail_op(p, "cas", [old, new])
    ops.extend(open_ops.values())
    ops += [invoke_op(concurrency + p, "write", p % (vmax + 1))
            for p in range(burst)]
    ops += [ok_op(concurrency + p, "write", p % (vmax + 1))
            for p in range(burst)]
    return History(ops).index()


def op(p, t, f, v):
    """One op as a dict, the form both packages read."""
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


def counter_step(n):
    """The torch transition of a counter mod n: inc moves state s to
    (s + 1) mod n, a different target from each state, so the model has
    no diagonal + rank-1 decomposition; read v is legal iff v == s (the
    Mod3 counter of the JAX package's tests/test_wgl_seg.py:421-487 at
    n = 3)."""
    def step(state, f, a, b, a_ok):
        s = state[:, 0]
        is_inc = f == 0
        legal = is_inc | ((f == 1) & (a == s))
        nxt = torch.where(is_inc, (s + 1) % n, s)
        return torch.where(legal, nxt, s)[:, None].to(torch.int32), legal
    return step


def mod_counter(n):
    """A port model of the counter mod n (`counter_step`)."""
    from jepsen_tpu_torch import models

    @dataclasses.dataclass(frozen=True)
    class ModCounter(models.Model):
        value: int = 0

        def step(self, o):
            if o.f == "inc":
                return ModCounter((self.value + 1) % n)
            if o.f == "read":
                if o.value == self.value:
                    return self
                return models.inconsistent(f"read {o.value!r}")
            return models.inconsistent(f"unknown f {o.f!r}")

        def device_spec(self):
            return models.DeviceSpec(
                1, {"inc": 0, "read": 1},
                lambda m: np.array([m.value], np.int32), counter_step(n),
                decode=lambda s: ModCounter(int(s[0])))

    return ModCounter()


def counter_dicts(seed, n, n_calls=40, conc=3, max_open=0, buggy=0.0):
    """One counter-mod-n history as op dicts, made with numpy from
    `seed`: processes increment and read a sequential counter, each read
    seeing the value at its invoke (every call takes effect at its
    invoke), with at most `max_open` calls open; `buggy` of the reads
    see a random value instead."""
    rng = np.random.default_rng(seed)
    ops, value, open_ops = [], 0, {}
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
        if rng.random() < 0.5:
            ops.append(op(p, "invoke", "inc", None))
            value = (value + 1) % n
            open_ops[p] = op(p, "ok", "inc", None)
        else:
            seen = int(rng.integers(n)) if buggy and rng.random() < buggy \
                else value
            ops.append(op(p, "invoke", "read", None))
            open_ops[p] = op(p, "ok", "read", seen)
    ops.extend(open_ops.values())
    return [dict(d, index=j) for j, d in enumerate(ops)]


def plant_stale_read(h, frac, vmax, forbidden=()):
    """Rewrite one ok-read at `frac` depth to a legal value w that no
    linearization can produce: w is neither the register value at the
    read's invoke nor written by any call that can linearize inside the
    read's window, nor in `forbidden` (for example every crashed call's
    value, which crashed calls could otherwise explain).  Returns the op
    index of the read's INVOKE (the exact witness), or None."""
    ops = h.ops
    n = len(ops)
    value_at = np.zeros(n + 1, np.int64)      # sequential value before i
    cur = -1
    for i, o in enumerate(ops):
        value_at[i] = cur
        if o.type == "ok" and o.f == "write":
            cur = o.value
        elif o.type == "ok" and o.f == "cas":
            cur = o.value[1]
    pend: dict = {}
    inv_of: dict = {}
    inv_pos, comp_pos, wval = [], [], []
    for i, o in enumerate(ops):
        if o.type == "invoke":
            pend[o.process] = len(inv_pos)
            inv_pos.append(i)
            comp_pos.append(n)
            v = o.value if o.f == "write" else \
                o.value[1] if o.f == "cas" else None
            wval.append(-1 if v is None else int(v))
        elif o.process in pend:
            c = pend.pop(o.process)
            comp_pos[c] = i
            inv_of[i] = inv_pos[c]
    inv_pos, comp_pos, wval = (np.asarray(x, np.int64)
                               for x in (inv_pos, comp_pos, wval))
    reads = [i for i, o in enumerate(ops)
             if o.type == "ok" and o.f == "read" and o.value is not None
             and i in inv_of]
    start = int(len(reads) * frac)
    for i in reads[start:] + reads[:start]:
        lo = inv_of[i]
        # a write can be the read's last write in some linearization iff
        # it invokes before the read completes and no write is forced
        # between them
        before = (comp_pos < lo) & (wval >= 0)
        M = int(inv_pos[before].max()) if before.any() else 0
        touch = (inv_pos <= i) & (comp_pos >= M) & (wval >= 0)
        V = set(int(x) for x in np.unique(wval[touch]))
        V.add(int(value_at[lo]))
        w = next((x for x in range(vmax + 1)
                  if x not in V and x not in forbidden), None)
        if w is None:
            continue
        ops[i].value = w
        h.invalidate_packed()        # the columns no longer match
        return ops[lo].index
    return None


def attach_columns(tag, hs):
    """Give each history its columns (pack_history, attach_packed), as a
    run that journals its ops has them; print the seconds on a
    [columns] line: a cost moved off the check, not saved."""
    from jepsen_tpu_torch.history import pack_history
    t = time.perf_counter()
    for h in hs:
        h.attach_packed(pack_history(h))
    dt = time.perf_counter() - t
    log(f"[columns] {tag}: {len(hs)} histories, "
        f"{sum(len(h) for h in hs)} ops packed and attached in {dt:.3f} s")
    return dt


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        sys.exit(2)
    try:
        import jepsen_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the jepsen_tpu_torch package is missing: {e}",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    smi = smi.splitlines()[0]
    log(f"[device] {smi}; {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; max SM clock {clk} MHz")
    return smi, float(clk) * 1e6


def phase_build():
    """Both kernels' nvcc at once, timed; ptxas registers and spills of
    every instantiation; a warp-arm spill of the deep kernel fails."""
    from jepsen_tpu_torch.ops import (cand_kernel, crash_kernel, cuda_build,
                                      cycle, deep_kernel, elle_kernel, fold,
                                      frontier_kernel, lattice_kernel,
                                      regs_kernel)
    t = time.perf_counter()
    libs = cuda_build.build("wgl_deep", "wgl_regs", "wgl_crash",
                            "wgl_frontier", "elle_pmm", "fold", "cycle",
                            "lattice_masks", "wgl_cand")
    deep_kernel._load()
    cuda_build.load("wgl_cand", cand_kernel._declare)
    cuda_build.load("wgl_regs", regs_kernel._declare)
    cuda_build.load("wgl_crash", crash_kernel._declare)
    cuda_build.load("wgl_frontier", frontier_kernel._declare)
    cuda_build.load("elle_pmm", elle_kernel._declare)
    cuda_build.load("fold", fold._declare)
    cuda_build.load("cycle", cycle._declare)
    cuda_build.load("lattice_masks", lattice_kernel._declare)
    dt = time.perf_counter() - t
    kernels, entries = {}, []
    for lib in libs.values():
        report = cuda_build.ptxas_report(lib)
        text = report.read_text() if report.exists() else ""
        kernels.update(ptxas_kernels(text))
        entries += [ln for ln in text.splitlines() if "entry function" in ln]
    if not all(any(k.startswith(n) for k in kernels)
               for n in ("wgl_regs_kernel", "wgl_regs_keys", "wgl_warp",
                         "wgl_crash", "wgl_frontier", "elle_pmm",
                         "elle_tile_bits", "fold_member", "cycle_labels",
                         "lattice_masks", "wgl_cand_kernel")):
        raise SystemExit("[build] ptxas reported no kernel of a source: "
                         + " | ".join(entries))
    log(f"[build] {', '.join(p.name for p in libs.values())} in {dt:.2f} s "
        f"(one nvcc per source, in parallel); ptxas: " + " | ".join(
            f"{k}: {v['regs']} registers, spill {v['spill']} bytes"
            for k, v in kernels.items()))
    # the deep kernel's warp arm, the candidate-table kernels and the
    # crash kernel's two-word instances keep their planes in registers
    spilled = [k for k, v in kernels.items() if v["spill"] and (
        k.startswith(("wgl_warp", "wgl_cand_kernel"))
        or (k.startswith("wgl_crash_kernel") and k.endswith(",2>")))]
    if spilled:
        raise SystemExit(f"[build] the register plane spills: {spilled}")
    if not any(k.startswith("wgl_crash_kernel") and k.endswith(",2>")
               for k in kernels):
        raise SystemExit("[build] ptxas reported no two-word crash kernel")
    fk = frontier_kernel
    shapes = ((64, 4, 1), (1024, 8, 1), (4096, 16, 1), (1024, 32, 1),
              (8192, 32, 1), (65536, 32, 1), (1024, 64, 2), (512, 128, 4),
              (64, 16, 4), (1024, 16, 8))
    lays = {sh: fk.layout(*sh) for sh in shapes}
    grid = max(v["ctas"] for v in lays.values())
    log("[build] wgl_frontier: " + " | ".join(
        f"{k}: {v['regs']} registers, spill {v['spill']} bytes, "
        f"{v['smem']} bytes static shared memory, "
        f"{lays[shapes[0]]['smem_bytes']} bytes dynamic"
        for k, v in kernels.items() if k.startswith("wgl_frontier"))
        + "; a round's pool sorted in shared memory up to "
        + " / ".join(str(fk.layout(1, 1, wd)["capacity"]) for wd in (1, 2, 4))
        + " rows at 2 / 3 / 5 key words; a launch is 1 CTA where F (C + 1) "
        f"rows fit, else a cooperative grid of {grid} CTAs (one an SM): "
        + ", ".join(f"F={F} C={C} Wd={Wd} "
                    f"{'grid' if lays[(F, C, Wd)]['grid'] else '1 CTA'}"
                    for F, C, Wd in shapes))
    from jepsen_tpu_torch import native
    cc = native.compiler()
    version = subprocess.run([cc, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1]
    t = time.perf_counter()
    lib = native.build()
    native.histscan()
    log(f"[build] {lib.name} in {time.perf_counter() - t:.2f} s by {cc} "
        f"({' '.join(version)}; {' '.join(native.FLAGS)})")
    return kernels


def ptxas_kernels(text):
    """{kernel<template args>: {"regs": n, "spill": store + load bytes,
    "smem": static shared bytes}} from `nvcc -Xptxas -v` output."""
    out, name = {}, None
    types = {"i": "int", "l": "long", "j": "unsigned", "b": "bool"}
    for ln in text.splitlines():
        m = re.search(r"entry function '_Z(\d+)(\w+)'", ln)
        if m:
            k = int(m.group(1))
            name, rest = m.group(2)[:k], m.group(2)[k:]
            if rest.startswith("I"):     # template arguments, up to E
                args = []
                for a in re.finditer(r"L[ib](\d+)E|([ijlb])|(E)", rest[1:]):
                    if a.group(3):
                        break
                    args.append(a.group(1) or types[a.group(2)])
                name = f"{name}<{','.join(args)}>"
            out[name] = {"regs": None, "spill": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["regs"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            out[name]["smem"] = int(m.group(1))
    return out


def tables_for(h, max_open_bits=16):
    """The port's host path for one history: scan, states, tables, wire.
    Returns (cbuf u8, G, aux i32, R, Sn, UP, fk, ret_t)."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import deep_kernel, planner, wgl_deep
    model = CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fk = planner._scan_history(planner.columns_of(h), h.ops, spec, seen,
                               rows, max_open_bits)
    uops = np.asarray(rows, np.int32).reshape(-1, 4)
    states, legal, nxt = planner._enumerate_states(
        spec, np.asarray(spec.encode(model), np.int32), uops, 64)
    dec = planner._decompose(legal, nxt)
    R = int(fk.max_open)
    ret_t, islot_t, iuop_t, _ = planner._pack_regs(
        [(0, fk)], 1, R, len(rows), deep_kernel.I)
    cbuf, G = wgl_deep.pack_events_compact(ret_t, islot_t, iuop_t)
    UP = wgl_deep._pad_u(len(rows))
    aux = wgl_deep.pack_aux(*planner._pack_uop_tables(legal, nxt, *dec),
                            UP).view(np.int32)
    return cbuf, G, aux, R, states.shape[0], UP, fk, ret_t


def walk_inputs(t, device):
    """deep_walk's tensors (on `device`) and shape arguments for one
    history from tables_for."""
    from jepsen_tpu_torch.ops import deep_kernel, wgl_deep
    cbuf, G, aux, R, Sn, UP = t[:6]
    dev = torch.device(device)
    args = (torch.from_numpy(cbuf).to(dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.full((1,), G * deep_kernel.EB, dtype=torch.int32,
                       device=dev),
            torch.full((1,), R, dtype=torch.int32, device=dev),
            torch.from_numpy(aux).to(dev))
    return args, dict(R=R, SnP=wgl_deep._snp(Sn), UP=UP)


def run_walk(t, device, work=None):
    from jepsen_tpu_torch.ops import deep_kernel
    args, kw = walk_inputs(t, device)
    out = deep_kernel.deep_walk(*args, work=work, **kw)
    return tuple(int(x) for x in out[0].cpu())


def timed_walk(t):
    """One kernel launch on inputs already on the card: ((alive, first
    dead row), plane words touched, kernel ms from launch to end)."""
    from jepsen_tpu_torch.ops import deep_kernel
    args, kw = walk_inputs(t, "cuda")
    work = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = []
    ms = launch_ms(lambda: out.append(deep_kernel.deep_walk(
        *args, work=work, **kw)), 1)
    return tuple(int(x) for x in out[0][0].cpu()), int(work.item()), ms


def abs_err(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


# (R, vmax) of phase 3: each arm at its edges and at SnP 8, 16 and 32
# (vmax 6 / 9 / 30 give 8 / 11 / 32 model states)
KERNEL_CASES = [(3, 6), (5, 30), (8, 9), (10, 30), (10, 6),
                (11, 30), (11, 6), (12, 9), (14, 6), (15, 30), (16, 9),
                (16, 30)]


def phase_kernel(clock_hz):
    """Each case on the card and in the plain version (worker processes,
    running while the card's launches run); returns the largest
    disagreement per arm."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import deep_kernel, wgl_cpu, wgl_deep
    seen = set()
    err = {"warp": 0, "block": 0}
    cases = []
    for R, vmax in KERNEL_CASES:
        for bad in (False, True):
            h = make_history(600, R + 4, seed=1000 + 10 * R + vmax,
                             vmax=vmax, max_open=R, burst=R)
            wit = plant_stale_read(h, 0.6, vmax) if bad else None
            if bad and wit is None:
                raise SystemExit(f"[kernel] no plantable read at R={R}")
            t = tables_for(h)
            if t[3] != R:
                raise SystemExit(f"[kernel] built R={t[3]}, wanted {R}")
            cases.append((R, bad, h, t))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(4, mp_context=ctx) as pool:
        # the longest plain walks (the deepest cases) first
        futs = {}
        for _, _, _, t in sorted(cases, key=lambda c: -c[0]):
            L2 = t[1] * deep_kernel.EB
            futs[id(t)] = pool.submit(
                plain_job, t[0][:L2 * (1 + 3 * deep_kernel.I)], t[2], L2,
                t[3], walk_inputs(t, "cpu")[1]["SnP"], t[5])
        for R, bad, h, t in cases:
            snp = wgl_deep._snp(t[4])
            arm = deep_kernel.arm_of(R)
            plane = deep_kernel.launch_plan(arm, R, snp)["plane"]
            seen.add((arm, snp))
            seen.add(plane)
            card, words, ms = timed_walk(t)
            plain, plain_words, plain_s = futs[id(t)].result()
            err[arm] = max(err[arm], abs_err(card, plain))
            ok = (card == plain and words == plain_words
                  and card[0] == (0 if bad else 1))
            oracle = ""
            if R == 3:
                o = wgl_cpu.check(CASRegister(), h)
                ok &= o["valid?"] is (not bad)
                oracle = f" oracle={o['valid?']}"
            b = bound_ms(words, t[0].nbytes + t[2].nbytes, clock_hz)
            log(f"[kernel] {arm} R={R} Sn={t[4]} SnP={snp} rows="
                f"{len(t[7])} {'invalid' if bad else 'valid'} plane="
                f"{plane} kernel={card} plain={plain}{oracle} "
                f"words={words} kernel_ms={ms:.3f} bound_ms={b:.4f} "
                f"plain_s={plain_s:.3f} {'OK' if ok else 'MISMATCH'}")
            if not ok:
                pool.shutdown(wait=False, cancel_futures=True)
                raise SystemExit("[kernel] kernel and plain version "
                                 "disagree")
    want = {(a, s) for a in ("warp", "block") for s in (8, 16, 32)}
    want |= {"registers", "shared", "global"}
    if not want <= seen:
        raise SystemExit(f"[kernel] not run: {sorted(map(str, want - seen))}")
    return err


def phase_main():
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import deep_kernel, wgl_deep
    depths = (8, 10, 12, 14)
    batches = {mo: [make_history(20_000, 16, seed=41 + mo + 101 * s,
                                 vmax=9, max_open=mo)
                    for s in range(16)] for mo in depths}
    planted = {}
    for mo in (8, 14):
        h = make_history(20_000, 16, seed=7 + mo, vmax=9, max_open=mo)
        planted[mo] = (h, plant_stale_read(h, 0.9, 9))
        if planted[mo][1] is None:
            raise SystemExit(f"[main] no plantable read at depth {mo}")
    attach_columns("the envelope", [h for mo in depths for h in batches[mo]]
                   + [h for h, _ in planted.values()])
    model = CASRegister()
    checker = Linearizable(model, max_open_bits=16)
    verdicts = {}
    deep_kernel.LAUNCHES = 0
    for arm in deep_kernel.ARM_LAUNCHES:
        deep_kernel.ARM_LAUNCHES[arm] = 0
    for mo in depths:
        hs = batches[mo]
        st = {}
        t = time.perf_counter()
        res = wgl_deep.check_pipeline(model, hs, stats=st)
        wall = time.perf_counter() - t
        verdicts[mo] = res
        bad = [i for i, r in enumerate(res) if r["valid?"] is not True]
        if bad or any(r["engine"] != "wgl_deep" for r in res):
            raise SystemExit(f"[main] depth {mo}: histories {bad} not "
                             f"judged valid by wgl_deep")
        n_ops = sum(len(h) for h in hs)
        host = wall - st["kernel_ms"] / 1e3
        Rs = sorted({r["max_open"] for r in res})
        t = time.perf_counter()
        single = checker.check(None, hs[0])
        single_s = time.perf_counter() - t
        if single["valid?"] is not True:
            raise SystemExit(f"[main] depth {mo}: Linearizable judged "
                             f"a valid history {single['valid?']}")
        log(f"[main] max_open={mo} R={Rs} states={res[0]['states']} "
            f"batch=16x{len(hs[0])} ops: {n_ops / wall:.0f} ops/s, wall "
            f"{wall:.3f} s, kernel {st['kernel_ms']:.3f} ms per batch, "
            f"host share {host / wall:.3f} (scan {st['scan']:.3f} s, "
            f"pack {st['pack']:.3f} s, tables {st['tables']:.3f} s, "
            f"copy {st['copy']:.3f} s, sync {st['sync']:.3f} s); "
            f"Linearizable one history {single_s:.3f} s")
    # planted stale reads: one history through Linearizable (with the
    # oracle's final-paths), and both in one mixed-depth grid with valid
    # histories of depths 8 and 14
    t = time.perf_counter()
    r8 = checker.check(None, planted[8][0])
    dt = time.perf_counter() - t
    mixed = [batches[8][1], planted[8][0], batches[14][1], planted[14][0]]
    t = time.perf_counter()
    rm = wgl_deep.check_pipeline(model, mixed)
    dt_mixed = time.perf_counter() - t
    batches["mixed"] = mixed
    verdicts["mixed"] = rm
    checks = [("Linearizable", 8, r8, planted[8][1], dt),
              ("check_pipeline mixed", 8, rm[1], planted[8][1], dt_mixed),
              ("check_pipeline mixed", 14, rm[3], planted[14][1],
               dt_mixed)]
    for how, mo, r, wit, dt in checks:
        ok = r["valid?"] is False and r.get("op_index") == wit
        log(f"[main] planted stale read depth {mo} via {how}: valid?="
            f"{r['valid?']} op_index={r.get('op_index')} planted={wit} "
            f"final-paths={len(r.get('final-paths') or [])} in {dt:.3f} s "
            f"{'OK' if ok else 'WRONG'}")
        if not ok:
            raise SystemExit("[main] planted witness not reported")
    if not (rm[0]["valid?"] is True and rm[2]["valid?"] is True):
        raise SystemExit("[main] mixed-depth grid judged a valid history")
    launches = dict(deep_kernel.ARM_LAUNCHES)
    log(f"[main] kernel launches on the main path: "
        f"{deep_kernel.LAUNCHES} ({launches})")
    if min(launches.values()) <= 0:
        raise SystemExit("[main] the main path left an arm unlaunched")
    return batches, verdicts, launches


def plain_job(cbuf, aux, L2, R, SnP, UP):
    """The plain version on one CTA's wire, in a worker process:
    ((alive, first dead row), plane words touched, seconds)."""
    from jepsen_tpu_torch.ops import deep_kernel
    torch.set_num_threads(1)
    work: dict = {}
    t = time.perf_counter()
    out = deep_kernel.walk_plain(torch.from_numpy(cbuf),
                                 torch.from_numpy(aux), L2=L2, R=R, SnP=SnP,
                                 UP=UP, work=work)
    return tuple(out), work.get("words", 0), time.perf_counter() - t


def phase_grid(batches, verdicts):
    """The main path's grids, rebuilt by the same host half
    (wgl_deep.pack_pipeline), launched once more with the plane-word
    count on: every CTA's verdict must equal the main path's, and the
    chosen CTAs must equal the plain version on CPU copies of the very
    tensors the grid read."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import deep_kernel, wgl_deep
    model = CASRegister()
    jobs = []
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    t_all = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        for name, hs in batches.items():
            _, grid, pend = wgl_deep.pack_pipeline(model, hs)
            wire = grid.to_device(torch.device("cuda"))
            n = len(pend)
            work = torch.zeros(n, dtype=torch.int64, device="cuda")
            before = dict(deep_kernel.ARM_LAUNCHES)
            out = deep_kernel.deep_walk(*wire, work=work,
                                        **grid.shape()).cpu()
            words = work.cpu().tolist()
            arms = {a: deep_kernel.ARM_LAUNCHES[a] - before[a]
                    for a in before}
            log(f"[grid] {name}: {n} CTAs, depths {sorted(set(grid.depth))}"
                f", launches per arm {arms}")
            want = {deep_kernel.arm_of(d) for d in grid.depth}
            if {a for a, c in arms.items() if c} != want:
                raise SystemExit(f"[grid] {name}: launched {arms}, wanted "
                                 f"the arms {sorted(want)}")
            if name == "mixed" and want != {"warp", "block"}:
                raise SystemExit("[grid] the mixed grid does not hold "
                                 "both arms")
            for k, (i, *_rest) in enumerate(pend):
                if bool(out[k, 0]) is not verdicts[name][i]["valid?"]:
                    raise SystemExit(f"[grid] {name}: CTA {k} disagrees "
                                     f"with the main path's verdict")
            depth = grid.depth
            if name == 14:
                picks = [depth.index(r) for r in sorted(set(depth))]
            elif name == "mixed":
                picks = [1, 3]            # the planted histories
            else:
                picks = [0]
            cbuf, offs, rows, _, aux = (x.cpu().numpy() for x in wire)
            shape = grid.shape()
            for k in picks:
                o, L2 = int(offs[k]), int(rows[k])
                size = L2 * (1 + 3 * deep_kernel.I)
                fut = pool.submit(plain_job, cbuf[o:o + size].copy(), aux,
                                  L2, depth[k], shape["SnP"], shape["UP"])
                jobs.append((name, k, depth[k], shape["R"],
                             tuple(int(x) for x in out[k]), words[k], fut))
        err = {"warp": 0, "block": 0}
        for name, k, Rh, R, card, words, fut in jobs:
            plain, pwords, secs = fut.result()
            arm = deep_kernel.arm_of(Rh)
            err[arm] = max(err[arm], abs_err(card, plain))
            ok = card == plain and words == pwords
            log(f"[grid] {name}: CTA {k} depth {Rh} ({arm} arm) in a grid "
                f"of stride "
                f"R={R}: kernel={card} plain={plain} words {words}/"
                f"{pwords} plain_s={secs:.1f} {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit("[grid] a main-path CTA disagrees with "
                                 "the plain version")
    log(f"[grid] {len(jobs)} CTAs held against the plain version in "
        f"{time.perf_counter() - t_all:.1f} s ({workers} workers)")
    return err


def bound_ms(words, in_bytes, clock_hz):
    """The larger of the plane traffic over one SM's shared-memory
    bandwidth (one CTA per history) and the wire over device memory."""
    smem = 4.0 * words / (SMEM_BYTES_PER_CLOCK * clock_hz)
    hbm = in_bytes / HBM_BYTES_PER_S
    return 1e3 * max(smem, hbm)


def phase_timing(batches, clock_hz):
    """Kernel time and bound per depth batch, then per arm the kernel,
    its plain version and the bound on one main-path history (depth 8
    on the warp arm, depth 12 on the block arm)."""
    from jepsen_tpu_torch.ops import deep_kernel
    for mo in (8, 10, 12, 14):
        ts = [tables_for(h) for h in batches[mo]]
        # each history alone, one launch after another, with its own
        # tables: the per-history kernel time and plane traffic
        ins = [walk_inputs(t, "cuda") for t in ts]
        work = [torch.zeros(1, dtype=torch.int64, device="cuda")
                for _ in ts]
        serial_ms = launch_ms(lambda: [
            deep_kernel.deep_walk(*args, work=w, **kw)
            for (args, kw), w in zip(ins, work)], 1)
        words = [int(w.item()) for w in work]
        b = max(bound_ms(wd, t[0].nbytes + t[2].nbytes, clock_hz)
                for wd, t in zip(words, ts))
        log(f"[timing] max_open={mo}: 16 histories one grid each, "
            f"{serial_ms:.3f} ms in sequence ({serial_ms / 16:.3f} ms "
            f"each); plane words touched max {max(words)} -> bound "
            f"{b:.3f} ms per history")
    # one main-path history per arm: kernel vs plain vs bound, same
    # inputs; the plain walks run in worker processes meanwhile
    picks = {"warp": batches[8][0], "block": batches[12][0]}
    res = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(picks), mp_context=ctx) as pool:
        ts, futs = {}, {}
        for arm, h in picks.items():
            t = ts[arm] = tables_for(h)
            if deep_kernel.arm_of(t[3]) != arm:
                raise SystemExit(f"[timing] depth {t[3]} is not {arm}")
            futs[arm] = pool.submit(plain_job, t[0], t[2],
                                    t[1] * deep_kernel.EB, t[3],
                                    walk_inputs(t, "cpu")[1]["SnP"], t[5])
        for arm, t in ts.items():
            work_card = torch.zeros(1, dtype=torch.int64, device="cuda")
            card = run_walk(t, "cuda", work=work_card)
            words = int(work_card.item())
            args, kw = walk_inputs(t, "cuda")
            reps = 5
            ms = launch_ms(lambda: deep_kernel.deep_walk(*args, **kw), reps)
            dms = device_ms(lambda: deep_kernel.deep_walk(*args, **kw), 3)
            b = bound_ms(words, t[0].nbytes + t[2].nbytes, clock_hz)
            res[arm] = dict(card=card, words=words, ms=ms, device_ms=dms,
                            bound_ms=b)
        for arm, t in ts.items():
            plain, pwords, secs = futs[arm].result()
            r = res[arm]
            if r["card"] != plain or r["words"] != pwords:
                raise SystemExit(f"[timing] {arm}: kernel {r['card']} / "
                                 f"{r['words']} words vs plain {plain} / "
                                 f"{pwords} words")
            r.update(plain_ms=1e3 * secs, err=abs_err(r["card"], plain))
            log(f"[timing] {arm} arm, one depth-{t[3]} history "
                f"({len(picks[arm])} ops, {len(t[7])} rows): kernel "
                f"{r['ms']:.3f} ms launch to end (mean of {reps}), "
                f"{r['device_ms']:.3f} ms on the device, plain (CPU, "
                f"one thread) {r['plain_ms']:.1f} ms, bound "
                f"{r['bound_ms']:.4f} ms from {r['words']} plane words")
    return res


# ---------------------------------------------------------------------------
# The register-delta segment kernel (overlap depth <= 6)
# ---------------------------------------------------------------------------

INT32_LANES_PER_SM = 64             # H100: 64 INT32 lanes per SM a clock
N_SM = 132
SEG_N_OPS = 100_000                 # calls per north-star history
SEG_BATCH = 24                      # histories of the pipelined batch
DEV = "cuda"                        # the card the segment phases run on


def seg_bound_ms(ops, wire_bytes, clock_hz):
    """The larger of the walk's integer operations (the kernel's `work=`
    count) over every INT32 lane of the card and the wire over device
    memory."""
    return 1e3 * max(ops / (N_SM * INT32_LANES_PER_SM * clock_hz),
                     wire_bytes / HBM_BYTES_PER_S)


def seg_inputs(hs, target=None, I=None):
    """The segment wire of histories scanned as check_pipeline scans a
    group: one alphabet, depth R = the deepest, segments of `target`
    returns (default wgl_seg.TARGET_RETURNS, the entry points'), I invoke
    columns per row (default min(2, R), check()'s; the pipeline packs
    1).  Returns a dict
    of host arrays and shape arguments, with each history's segment
    count."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import planner, wgl_seg
    model = CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fks = [planner._scan_history(planner.columns_of(h), h.ops, spec, seen,
                                 rows, 10) for h in hs]
    states, legal, nxt, dec = wgl_seg._model_tables(spec, model, rows, 64)
    R = max(fk.max_open for fk in fks)
    grid = wgl_seg._SegGrid()
    for fk in fks:
        seg_ends = planner._segment_ends(
            fk.cuts, wgl_seg.TARGET_RETURNS if target is None else target)
        grid.add(fk, seg_ends, min(2, R) if I is None else I)
    aux, UP = wgl_seg._aux(planner._pack_uop_tables(legal, nxt, *dec))
    cbuf, offs, nrows = grid.wire()
    return dict(cbuf=cbuf, offs=offs, nrows=nrows, aux=aux, UP=UP, R=R,
                Sn=states.shape[0], U=len(rows), seg_counts=grid.seg_counts)


def seg_scan(inp, device, rounds, ks=None):
    """regs_scan on `device` over the wire of `inp` (only segments `ks`,
    when given): (T u8 numpy, work int64 numpy (integer operations per
    segment), bad, ms from launch to end, NaN on the CPU)."""
    from jepsen_tpu_torch.ops import regs_kernel
    dev = torch.device(device)
    offs, nrows = inp["offs"], inp["nrows"]
    if ks is not None:
        offs, nrows = offs[ks], nrows[ks]
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (inp["cbuf"], offs, nrows, inp["aux"])]
    work = torch.zeros(len(offs), dtype=torch.int64, device=dev)
    kw = dict(R=inp["R"], Sn=inp["Sn"], UP=inp["UP"],
              J=inp["Sn"], rounds=rounds, work=work)
    out = []
    ms = float("nan")
    if dev.type == "cuda":
        ms = launch_ms(lambda: out.append(regs_kernel.regs_scan(*args, **kw)),
                       1)
    else:
        out.append(regs_kernel.regs_scan(*args, **kw))
    T, bad = out[0]
    return T.cpu().numpy(), work.cpu().numpy(), int(bad.cpu()[0]), ms


def plain_seg_job(inp, rounds, ks=None):
    """The plain version on CPU copies, in a worker process: (T, work,
    seconds)."""
    torch.set_num_threads(1)
    t = time.perf_counter()
    T, work, _, _ = seg_scan(inp, "cpu", rounds, ks)
    return T, work, time.perf_counter() - t


def wire_bytes(inp, K, Sn):
    return (inp["cbuf"].nbytes + 12 * K + inp["aux"].nbytes
            + K * Sn * Sn)


# (R, vmax) of the segment kernel phase: R = 1..6, each at SnP 8, 16
# and 32 (vmax 6 / 9 / 30 give 8 / 11 / 32 model states)
SEG_KERNEL_CASES = [(R, v) for R in range(1, 7) for v in (6, 9, 30)]


def phase_seg_kernel(clock_hz):
    """The segment kernel against its plain version on CPU copies of the
    same inputs, R = 1..6 x SnP 8/16/32 x (valid, planted-invalid) x
    (rounds R, rounds 2), plus a uop table past 255 ids: transfer
    matrices, operation counts and the composed verdict.  Returns the
    largest disagreement."""
    from jepsen_tpu_torch.ops import regs_kernel
    cases = []
    for R, vmax in SEG_KERNEL_CASES:
        for bad in (False, True):
            h = make_history(400, R + 2, seed=2000 + 10 * R + vmax,
                             vmax=vmax, max_open=R, burst=R)
            if bad and plant_stale_read(h, 0.6, vmax) is None:
                raise SystemExit(f"[seg-kernel] no plantable read at R={R}")
            cases.append((R, vmax, bad, seg_inputs([h], target=64)))
    wide = make_history(2500, 4, seed=77, vmax=30, max_open=5, burst=5,
                        cas_hits=True)
    cases.append((5, 30, False, seg_inputs([wide], target=64)))
    if cases[-1][3]["U"] <= 255:
        raise SystemExit("[seg-kernel] the wide case has no uop past 255")
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    err = 0
    seen = set()
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        jobs = []
        for R, vmax, bad, inp in cases:
            if inp["R"] != R:
                raise SystemExit(f"[seg-kernel] built R={inp['R']}, "
                                 f"wanted {R}")
            for rounds in sorted({R, min(R, 2)}):
                jobs.append((R, vmax, bad, inp, rounds,
                             pool.submit(plain_seg_job, inp, rounds)))
        for R, vmax, bad, inp, rounds, fut in jobs:
            T, work, nbad, ms = seg_scan(inp, DEV, rounds)
            pT, pwork, secs = fut.result()
            K, Sn = T.shape[0], inp["Sn"]
            vd = regs_kernel.compose(torch.from_numpy(T).to(DEV),
                                     [K]).cpu()[0].tolist()
            err = max(err, int(np.abs(T.astype(np.int64)
                                      - pT.astype(np.int64)).max()))
            ok = (np.array_equal(T, pT) and np.array_equal(work, pwork)
                  and nbad == 0)
            if rounds == R:             # exact: the verdict is the truth
                ok &= vd[0] == (0 if bad else 1)
            seen.add((R, regs_kernel.snp(Sn), rounds == R))
            b = seg_bound_ms(int(work.sum()), wire_bytes(inp, K, Sn),
                             clock_hz)
            log(f"[seg-kernel] R={R} Sn={Sn} SnP={regs_kernel.snp(Sn)} "
                f"U={inp['U']} K={K} rows={int(inp['nrows'].sum())} "
                f"rounds={rounds} {'invalid' if bad else 'valid'} "
                f"verdict={vd[:2]} ops={int(work.sum())} "
                f"kernel_ms={ms:.3f} bound_ms={b:.4f} plain_s={secs:.3f} "
                f"{'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit("[seg-kernel] kernel and plain version "
                                 "disagree")
    want = {(R, snp, ex) for R in range(1, 7) for snp in (8, 16, 32)
            for ex in (True, R <= 2)}
    if not want <= seen:
        raise SystemExit(f"[seg-kernel] not run: {sorted(want - seen)}")
    return err


def phase_seg_main():
    """The north-star shape through the segment route: SEG_BATCH register
    histories of SEG_N_OPS calls, concurrency 5, vmax 9, through
    check_pipeline (all valid, engine wgl_seg) and one of them through
    Linearizable; then a planted stale read through both, whose exact
    witness must come back.  The segment kernel's launch count is read
    over this whole path."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import regs_kernel, wgl_seg
    t = time.perf_counter()
    hs = [make_history(SEG_N_OPS, 5, seed=7000 + s, vmax=9)
          for s in range(SEG_BATCH)]
    planted = make_history(SEG_N_OPS, 5, seed=6999, vmax=9)
    wit = plant_stale_read(planted, 0.9, 9)
    if wit is None:
        raise SystemExit("[seg-main] no plantable read")
    log(f"[seg-main] made {SEG_BATCH + 1} histories of {SEG_N_OPS} calls "
        f"in {time.perf_counter() - t:.1f} s")
    attach_columns("the north-star batch", hs + [planted])
    model = CASRegister()
    checker = Linearizable(model)
    bmm_calls = [0]
    bmm = torch.bmm

    def counted_bmm(*a, **kw):
        bmm_calls[0] += 1
        return bmm(*a, **kw)
    torch.bmm = counted_bmm
    regs_kernel.LAUNCHES = 0
    regs_kernel.COMPOSE_LAUNCHES = 0
    st = {}
    t = time.perf_counter()
    res = wgl_seg.check_pipeline(model, hs, stats=st)
    wall = time.perf_counter() - t
    bad = [i for i, r in enumerate(res) if r["valid?"] is not True
           or r["engine"] != "wgl_seg" or not r.get("pipelined")]
    if bad:
        raise SystemExit(f"[seg-main] histories {bad} not judged valid by "
                         f"the pipelined segment kernel")
    n_ops = sum(len(h) for h in hs)
    dev_ms = st.get("kernel_ms", 0.0) + st.get("compose_ms", 0.0)
    stages = ", ".join(f"{k} {st.get(k, 0.0):.3f} s" for k in (
        "scan", "segment", "tables", "pack", "copy", "launch", "sync",
        "assemble"))
    log(f"[seg-main] check_pipeline {SEG_BATCH}x{len(hs[0])} ops "
        f"(R={res[0]['dispatch']['R']}, states {res[0]['states']}, "
        f"segments per history {min(r['segments'] for r in res)}.."
        f"{max(r['segments'] for r in res)}): {n_ops / wall:.0f} ops/s, "
        f"wall {wall:.3f} s, kernel {st.get('kernel_ms', 0.0):.3f} ms, "
        f"compose (wgl_compose) {st.get('compose_ms', 0.0):.3f} ms = "
        f"{st.get('compose_ms', 0.0) / max(dev_ms, 1e-9):.3f} "
        f"of the device time, host share {(wall - dev_ms / 1e3) / wall:.4f}"
        f"; stages: {stages}")
    t = time.perf_counter()
    single = checker.check(None, hs[0])
    single_s = time.perf_counter() - t
    if single["valid?"] is not True or single["engine"] != "wgl_seg":
        raise SystemExit(f"[seg-main] Linearizable: {single['valid?']} by "
                         f"{single['engine']}")
    log(f"[seg-main] Linearizable one history ({len(hs[0])} ops, "
        f"{single['segments']} segments): {single_s:.3f} s, time_kernel_s "
        f"{single['time_kernel_s']:.4f}")
    t = time.perf_counter()
    r1 = checker.check(None, planted)
    dt1 = time.perf_counter() - t
    t = time.perf_counter()
    rp = wgl_seg.check_pipeline(model, [hs[1], planted])
    dt2 = time.perf_counter() - t
    for how, r, dt in (("Linearizable", r1, dt1),
                       ("check_pipeline", rp[1], dt2)):
        ok = (r["valid?"] is False and r.get("op_index") == wit
              and r["engine"] == "wgl_seg")
        log(f"[seg-main] planted stale read via {how}: valid?={r['valid?']} "
            f"op_index={r.get('op_index')} planted={wit} dead_segment="
            f"{r.get('dead_segment')} speculation={r.get('speculation')} "
            f"final-paths={len(r.get('final-paths') or [])} in {dt:.3f} s "
            f"{'OK' if ok else 'WRONG'}")
        if not ok:
            raise SystemExit("[seg-main] planted witness not reported")
    if rp[0]["valid?"] is not True:
        raise SystemExit("[seg-main] the planted batch judged a valid "
                         "history invalid")
    torch.bmm = bmm
    launches = regs_kernel.LAUNCHES
    compose_launches = regs_kernel.COMPOSE_LAUNCHES
    log(f"[seg-main] launches on the main path: segment kernel {launches}, "
        f"wgl_compose {compose_launches}; torch.bmm calls {bmm_calls[0]}")
    if launches <= 0 or compose_launches != launches or bmm_calls[0]:
        raise SystemExit("[seg-main] the main path must launch the segment "
                         "kernel and one composition per launch, and no "
                         "torch.bmm")
    return hs, {"wgl_regs": launches, "wgl_compose": compose_launches}


def same_scan(fk, want):
    """The fields of two scans of one history equal: n_calls, max_open,
    cuts, positions, the return and open-set arrays and the delta
    stream."""
    from jepsen_tpu_torch.ops import planner
    return ((fk.n_calls, fk.max_open, fk.n_rets)
            == (want.n_calls, want.max_open, want.n_rets)
            and np.array_equal(fk.cuts, want.cuts)
            and np.array_equal(fk.positions, want.positions)
            and all(np.array_equal(a, b) for a, b in zip(
                planner._fk_arrays(fk), planner._fk_arrays(want)))
            and all(np.array_equal(a, b) for a, b in zip(
                planner._deltas(fk), planner._deltas(want))))


def phase_scan(seg_hs, env_hs):
    """The C scanners against the plain Python scan, on the same
    histories in one call (host times move between calls): the stream
    pass (scan, cuts and segment wire), the column scan and the object
    walk beside `_fast_scan` with `_segment_ends` and `pack_stream` on
    the north-star batch, and the same with the deep tables
    (`_pack_regs_single` beside `_pack_regs`) on the envelope at
    max_open 12.  Each scanner interns into its own seen/rows, shared
    across the batch as the pipelines share them.  Any difference
    fails."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import deep_kernel, planner, regs_kernel, wgl_seg
    spec = CASRegister().device_spec()
    out = {}
    for tag, hs, mob, deep in (("north-star", seg_hs, 10, False),
                               ("envelope max_open=12", env_hs, 16, True)):
        names = ("streams", "columns", "objects", "python")
        secs = dict.fromkeys(names + ("python wire", "tables",
                                      "python tables"), 0.0)
        intern = {k: ({}, []) for k in names}
        bad = []
        for i, h in enumerate(hs):
            pk = h.packed_columns()
            if pk is None:
                raise SystemExit(f"[scan] {tag}: history {i} has no columns")
            scans = {
                "streams": lambda s, r: planner._native_scan_streams(
                    pk, h.ops, spec, s, r, mob, wgl_seg.TARGET_RETURNS),
                "columns": lambda s, r: planner._native_scan_cols(
                    pk, h.ops, spec, s, r, mob),
                "objects": lambda s, r: planner._native_scan(
                    h.ops, spec, s, r, mob),
                "python": lambda s, r: planner._fast_scan(
                    h.ops, spec, s, r, mob)}
            got = {}
            for k, scan in scans.items():
                t = time.perf_counter()
                got[k] = scan(*intern[k])
                secs[k] += time.perf_counter() - t
            fk = got["python"]
            t = time.perf_counter()
            seg_ends = planner._segment_ends(fk.cuts, wgl_seg.TARGET_RETURNS)
            wire = regs_kernel.pack_stream(fk, seg_ends, 1)
            secs["python wire"] += time.perf_counter() - t
            sk = got["streams"]
            if not (list(sk.seg_ends) == list(seg_ends)
                    and (sk.n_calls, sk.max_open, sk.n_rets)
                    == (fk.n_calls, fk.max_open, fk.n_rets)
                    and np.array_equal(sk.positions, fk.positions)
                    and all(a.tobytes() == b.tobytes()
                            for a, b in zip(sk.wire, wire))):
                bad.append((i, "streams"))
            bad += [(i, k) for k in ("columns", "objects")
                    if not same_scan(got[k], fk)]
            if deep:
                R, U = int(fk.max_open), len(intern["python"][1])
                t = time.perf_counter()
                tabs = planner._pack_regs_single(got["columns"], R, U,
                                                 deep_kernel.I)
                secs["tables"] += time.perf_counter() - t
                t = time.perf_counter()
                want = planner._pack_regs([(0, fk)], 1, R, U, deep_kernel.I)
                secs["python tables"] += time.perf_counter() - t
                if tabs[3] != want[3] or any(
                        a.tobytes() != b.tobytes()
                        for a, b in zip(tabs[:3], want[:3])):
                    bad.append((i, "deep tables"))
        s0, r0 = intern["python"]
        bad += [k for k in names[:3] if intern[k] != (s0, r0)]
        n_ops = sum(len(h) for h in hs)
        py = secs["python"] + secs["python wire"]
        line = ", ".join(f"{k} {secs[k]:.3f} s" for k in secs
                         if deep or "tables" not in k)
        log(f"[scan] {tag}: {len(hs)} histories, {n_ops} ops: {line}; "
            f"the stream pass {n_ops / secs['streams']:.0f} ops/s, the "
            f"Python scan with its wire {n_ops / py:.0f} ops/s "
            f"({py / secs['streams']:.1f}x); fields, seen, rows and "
            f"{'deep tables' if deep else 'wire bytes'} "
            f"{'equal OK' if not bad else 'DIFFER ' + str(bad[:8])}")
        if bad:
            raise SystemExit(f"[scan] {tag}: the C scanners disagree")
        out[tag] = dict(secs, n_ops=n_ops)
    return out


def phase_seg_grid(hs, clock_hz):
    """The main path's first group rebuilt as check_pipeline built it
    (one alphabet, I = 1, speculative rounds) and launched once more:
    every history's composed verdict must be valid, and chosen segment
    lanes (first, middle and last of each history) must equal the plain
    version on CPU copies of the same inputs.  Then the timing of the
    main-path shapes: the group launch (rounds 2) and check()'s launch
    on one history (rounds R), each against its plain version."""
    from jepsen_tpu_torch.ops import regs_kernel, wgl_seg
    grp = seg_inputs(hs[:wgl_seg.PIPE_GROUP], I=1)
    rounds = min(grp["R"], wgl_seg.SPEC_ROUNDS)
    one = seg_inputs(hs[:1])
    K, Sn = len(grp["offs"]), grp["Sn"]
    picks, lo = [], 0
    for k in grp["seg_counts"]:
        picks += [lo, lo + k // 2, lo + k - 1]
        lo += k
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(3, mp_context=ctx) as pool:
        f_picks = pool.submit(plain_seg_job, grp, rounds, picks)
        f_grp = pool.submit(plain_seg_job, grp, rounds)
        f_one = pool.submit(plain_seg_job, one, one["R"])
        T, work, nbad, _ = seg_scan(grp, DEV, rounds)
        vd = regs_kernel.compose(torch.from_numpy(T).to(DEV),
                                 grp["seg_counts"]).cpu()
        if nbad or not bool(vd[:, 0].all()):
            raise SystemExit(f"[seg-grid] the rebuilt group: bad {nbad}, "
                             f"verdicts {vd[:, :2].tolist()}")
        timed = {}
        for name, inp, rd in (("group", grp, rounds),
                              ("single", one, one["R"])):
            Tn, wn, _, _ = seg_scan(inp, DEV, rd)
            args = [torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
                    for x in (inp["cbuf"], inp["offs"], inp["nrows"],
                              inp["aux"])]
            kw = dict(R=inp["R"], Sn=inp["Sn"], UP=inp["UP"], J=inp["Sn"],
                      rounds=rd)

            def scan():
                return regs_kernel.regs_scan(*args, **kw)
            scan()                                    # warm
            timed[name] = (launch_ms(scan, 5), device_ms(scan, 10), Tn, wn)
        # the composition alone, on the group's transfer matrices:
        # wgl_compose and PR 4's torch.bmm levels in turns
        counts = grp["seg_counts"]
        turns = compose_turns(torch.from_numpy(T).to(DEV), counts)
        t = time.perf_counter()
        regs_kernel.compose_plain(torch.from_numpy(T), counts)
        compose_plain_ms = 1e3 * (time.perf_counter() - t)
        pT, pwork, psecs = f_picks.result()
        ok = np.array_equal(T[picks], pT) and np.array_equal(work[picks],
                                                             pwork)
        log(f"[seg-grid] group of {len(grp['seg_counts'])} histories, K={K} "
            f"segments, R={grp['R']}, Sn={Sn}, rounds={rounds}: all "
            f"verdicts valid; lanes of segments {picks} equal the plain "
            f"version ({psecs:.1f} s): {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit("[seg-grid] a main-path lane disagrees with "
                             "the plain version")
        err = 0
        res = {}
        for name, fut in (("group", f_grp), ("single", f_one)):
            inp = grp if name == "group" else one
            ms, dms, Tn, wn = timed[name]
            pT, pwork, psecs = fut.result()
            if not (np.array_equal(Tn, pT) and np.array_equal(wn, pwork)):
                raise SystemExit(f"[seg-grid] {name}: kernel and plain "
                                 f"version disagree")
            err = max(err, int(np.abs(Tn.astype(np.int64)
                                      - pT.astype(np.int64)).max()))
            Kn = len(inp["offs"])
            b = seg_bound_ms(int(wn.sum()), wire_bytes(inp, Kn, Sn),
                             clock_hz)
            res[name] = dict(ms=ms, device_ms=dms, plain_ms=1e3 * psecs,
                             bound_ms=b, ops=int(wn.sum()))
            log(f"[seg-timing] {name} launch: K={Kn} segments, "
                f"rows={int(inp['nrows'].sum())}, R={inp['R']}, rounds="
                f"{rounds if name == 'group' else inp['R']}: kernel "
                f"{ms:.4f} ms launch to end (mean of 5), {dms:.4f} ms on "
                f"the device (10 back to back), plain (CPU, one thread) "
                f"{1e3 * psecs:.1f} ms, bound {b:.4f} ms from "
                f"{int(wn.sum())} integer operations ({b / ms:.4f} of "
                f"launch to end, {b / dms:.4f} of the device time)")
        cb = compose_bound_ms(T.nbytes, len(counts))
        cdev = turns["kernel"]["device"]
        res["compose"] = dict(ms=turns["kernel"]["launch"], device_ms=cdev,
                              plain_ms=compose_plain_ms, bound_ms=cb,
                              library_ms=turns["bmm"]["launch"])
        log(f"[seg-timing] composition of the group's {K} transfer "
            f"matrices (J={Sn}, {len(counts)} histories): "
            f"{turns_line(turns)}; plain (CPU) {compose_plain_ms:.1f} ms, "
            f"bound {cb:.5f} ms from {T.nbytes} bytes "
            f"({cb / cdev:.4f} of the device time); wgl_compose is "
            f"{cdev / (cdev + res['group']['device_ms']):.3f} of kernel + "
            f"composition on the device")
    res["err"] = err
    res["T_group"], res["counts_group"] = T, grp["seg_counts"]
    res["T_single"] = timed["single"][2]
    return res


def device_ms(fn, reps):
    """Mean device time of `reps` back-to-back calls of fn: the card
    sleeps while the host enqueues them, so the events hold the device's
    work and not the host's launch overhead."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t               # host and device, once
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(int(2e9 * (2 * reps * one + 1e-3)))
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def launch_ms(fn, reps):
    """Mean of `reps` calls of fn, each timed from an idle card's launch
    to its end (CUDA events around the one call): the host's enqueue
    included."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
    return total / reps


def compose_turns(T, counts):
    """wgl_compose and the torch.bmm levels on the same matrices, in the
    order bmm, kernel, kernel, bmm, each turn warmed first: per route the
    mean and the readings of the device time (10 back to back) and of
    one call from launch to end.  Fails if the two disagree."""
    from jepsen_tpu_torch.ops import regs_kernel
    fns = {"bmm": bmm_levels, "kernel": regs_kernel.compose}
    got = {n: {"device_all": [], "launch_all": []} for n in fns}
    for name in ("bmm", "kernel", "kernel", "bmm"):
        fn = fns[name]
        fn(T, counts)
        got[name]["device_all"].append(device_ms(lambda: fn(T, counts), 10))
        got[name]["launch_all"].append(launch_ms(lambda: fn(T, counts), 1))
    if not torch.equal(bmm_levels(T, counts), regs_kernel.compose(T, counts)):
        raise SystemExit("wgl_compose and the torch.bmm levels disagree")
    for d in got.values():
        for k in ("device", "launch"):
            d[k] = sum(d[k + "_all"]) / len(d[k + "_all"])
    return got


def turns_line(turns):
    """compose_turns' readings as one log phrase."""
    def one(n):
        d = turns[n]
        return (f"{d['device']:.4f} ms on the device ("
                f"{', '.join(f'{x:.4f}' for x in d['device_all'])}), "
                f"{d['launch']:.4f} ms launch to end ("
                f"{', '.join(f'{x:.4f}' for x in d['launch_all'])})")
    return (f"in turns, wgl_compose {one('kernel')}; the torch.bmm levels "
            f"{one('bmm')}")


def compose_bound_ms(t_bytes, B):
    """The composition's least time: each transfer matrix read once and
    six words a history written (and two of its indices read), over
    device memory."""
    return 1e3 * (t_bytes + B * (6 * 4 + 12)) / HBM_BYTES_PER_S


def bmm_levels(T, seg_counts):
    """The composition as the port computed it before wgl_compose, for
    the timing only (the port no longer calls it): prefix products by
    doubling, log2(K) levels of torch.bmm on 0/1 float32 matrices,
    thresholded after each; row 0 gives the six verdict words."""
    from jepsen_tpu_torch.ops.regs_kernel import to_device
    dev = T.device
    B = len(seg_counts)
    J = T.shape[1]
    Kmax = max(seg_counts)
    counts = np.asarray(seg_counts, np.int64)
    hb = np.repeat(np.arange(B), counts)
    hk = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                             counts)
    P = torch.eye(J, dtype=torch.float32, device=dev).repeat(B, Kmax, 1, 1)
    P[to_device(hb, dev), to_device(hk, dev)] = T.to(torch.float32)
    d = 1
    while d < Kmax:
        prod = torch.bmm(P[:, :Kmax - d].reshape(-1, J, J),
                         P[:, d:].reshape(-1, J, J))
        P = torch.cat([P[:, :d], (prod > 0).to(torch.float32)
                       .reshape(B, Kmax - d, J, J)], dim=1)
        d *= 2
    alive = (P[:, :, 0, :] > 0).any(-1)                   # [B, Kmax]
    valid = alive[:, -1]
    dead = torch.where(valid, -1, alive.sum(1))
    idx = (dead - 1).clamp(0, Kmax - 1)
    reach = P[torch.arange(B, device=dev), idx, 0, :] > 0  # [B, J]
    entry0 = torch.zeros((B, J), dtype=torch.bool, device=dev)
    entry0[:, 0] = True
    entry = torch.where(valid[:, None], False,
                        torch.where((dead > 0)[:, None], reach, entry0))
    jj = torch.arange(min(J, 128), device=dev)
    bit = entry[:, :len(jj)].to(torch.int64) << (jj % 32)
    words = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    words.index_add_(1, jj // 32, bit)
    words = (words + 2 ** 31) % 2 ** 32 - 2 ** 31        # as int32 bits
    return torch.cat([valid.to(torch.int64)[:, None], dead[:, None],
                      words], 1).to(torch.int32)


def compose_random_cases():
    """Seeded 0/1 matrices at J = 1, 33, 88 and 128 (one to four mask
    words), three histories each, long enough for several staged chunks,
    one of them dying at a chosen segment; each T a view three bytes into
    a larger buffer, so no history starts on a 16-byte boundary."""
    rng = np.random.default_rng(31)
    cases = []
    for J in (1, 33, 88, 128):
        counts = [int(c) for c in rng.integers(40, 120, 3)]
        K = sum(counts)
        T = rng.random((K, J, J)) < 2.0 / J
        T[:, :, 0] |= rng.random((K, J)) < 0.999
        T[counts[0] + counts[1] // 2] = False
        buf = torch.zeros(T.size + 3, dtype=torch.uint8)
        buf[3:] = torch.from_numpy(T.astype(np.uint8).ravel())
        cases.append((J, counts, buf))
    return cases


def phase_compose(seg, crash):
    """wgl_compose against its plain version (on CPU copies of the same
    matrices): the north-star group, one history alone, the crash tier's
    J = 88 matrices of (c) and the relaxed tier's of (b), deaths made at
    the first, a middle and the last segment (the group's and (c)'s
    matrices with one segment emptied), and seeded matrices at one to
    four mask words on unaligned starts.  Then (c)'s and (b)'s
    compositions timed against the torch.bmm levels in turns.  Returns
    the largest disagreement."""
    from jepsen_tpu_torch.ops import regs_kernel
    Tg, cg = seg["T_group"], seg["counts_group"]
    Tc, Tr = crash["T_crash"], crash["T_relaxed"]
    starts = np.concatenate([[0], np.cumsum(cg)[:-1]])
    killed = Tg.copy()
    for b, k in ((0, 0), (1, cg[1] // 2), (2, cg[2] - 1)):
        killed[starts[b] + k] = 0
    mid = Tc.copy()
    mid[len(Tc) // 2] = 0
    cases = [("north-star group", Tg, cg),
             ("one history", seg["T_single"], [len(seg["T_single"])]),
             ("crash (c), J = 88", Tc, [len(Tc)]),
             ("relaxed (b)", Tr, [len(Tr)]),
             ("group, deaths at segment 0 / middle / last", killed, cg),
             ("crash (c), death in the middle", mid, [len(mid)])]
    for J, counts, buf in compose_random_cases():
        dev = buf.to(DEV)
        K = sum(counts)
        cases.append((f"seeded, unaligned, J = {J}",
                      dev[3:].view(K, J, J), counts))
    err = 0
    for name, T, counts in cases:
        if not torch.is_tensor(T):
            T = torch.from_numpy(T).to(DEV)
        got = regs_kernel.compose(T, counts).cpu()
        want = regs_kernel.compose_plain(T.cpu(), counts)
        err = max(err, int((got.to(torch.int64)
                            - want.to(torch.int64)).abs().max()))
        ok = torch.equal(got, want)
        log(f"[compose] {name}: B={len(counts)} K={len(T)} J={T.shape[1]} "
            f"(valid, dead) {[tuple(r[:2]) for r in got.tolist()]} "
            f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit("[compose] wgl_compose and the plain version "
                             "disagree")
    want_dead = [0, cg[1] // 2, cg[2] - 1] + [-1] * (len(cg) - 3)
    got_dead = regs_kernel.compose(torch.from_numpy(killed).to(DEV),
                                   cg).cpu()[:, 1].tolist()
    if got_dead != want_dead:
        raise SystemExit(f"[compose] made deaths {want_dead}, found "
                         f"{got_dead}")
    for name, T in (("crash (c), J = 88", Tc), ("relaxed (b)", Tr)):
        turns = compose_turns(torch.from_numpy(T).to(DEV), [len(T)])
        log(f"[compose] timing, {name}: K={len(T)} J={T.shape[1]}, "
            f"{T.nbytes} bytes of T, bound "
            f"{compose_bound_ms(T.nbytes, 1):.5f} ms: {turns_line(turns)}")
    return err


# ---------------------------------------------------------------------------
# The crash tiers: the segment kernel's crash variants on the main path
# ---------------------------------------------------------------------------

HARD_N_OPS = 50_000                 # calls of the hard crash regime
ENV_N_OPS = 20_000                  # calls of an envelope history


def copy_history(h):
    """A history of copies of h's ops (the planter edits ops in place)."""
    import copy
    from jepsen_tpu_torch.history import History
    return History([copy.copy(o) for o in h.ops])


def crash_ops(h, picks):
    """A copy of h with the ok completions picked by `picks` (a list of
    (depth fraction, f) pairs: the first ok completion of f at or past
    that share of the ops) turned into :info.  Returns (history, the
    values the crashed calls could write)."""
    h = copy_history(h)
    ops = h.ops
    values = set()
    for frac, f in picks:
        i = next(i for i in range(int(len(ops) * frac), len(ops))
                 if ops[i].type == "ok" and ops[i].f == f)
        ops[i] = ops[i].assoc(type="info")
        v = ops[i].value
        values |= set(v) if isinstance(v, list) else {v}
    values.discard(None)
    return h, values


def add_crashes(h, nc, seed, vmax, keep_last_open=True):
    """h with nc crashed writes of fresh processes, of values 0..vmax,
    invoked at random points: each ends with an :info at the end of the
    history, the last one (with `keep_last_open`) never completes.
    Returns (history, their values)."""
    from jepsen_tpu_torch.history import History, info_op, invoke_op
    rng = random.Random(seed)
    ops = list(h.ops)
    vals = [rng.randint(0, vmax) for _ in range(nc)]
    at = sorted(rng.randrange(len(ops) + 1) for _ in range(nc))
    for j, pos in reversed(list(enumerate(at))):
        ops.insert(pos, invoke_op(1000 + j, "write", vals[j]))
    ops += [info_op(1000 + j, "write", vals[j])
            for j in range(nc - (1 if keep_last_open else 0))]
    return History(ops).index(), set(vals)


def with_every_value(h, vmax):
    """h after one process writes 0..vmax in turn, so every value is a
    model state: vmax + 2 states with the initial None."""
    from jepsen_tpu_torch.history import History, invoke_op, ok_op
    ops = [o for v in range(vmax + 1)
           for o in (invoke_op(999, "write", v), ok_op(999, "write", v))]
    return History(ops + list(h.ops)).index()


def crash_inputs(h):
    """The tier-2 wire of h as check() builds it: the scan carrying up
    to four crashed calls on permanent slots, segments, wire and uop
    table.  Returns a dict of host arrays and shape arguments."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import planner, regs_kernel, wgl_seg
    model = CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fk = planner._fast_scan(h.ops, spec, seen, rows, 10,
                            max_crashed=planner.MAX_CRASHED)
    states, legal, nxt, dec = wgl_seg._model_tables(spec, model, rows, 64)
    seg_ends = planner._segment_ends(fk.cuts, wgl_seg.TARGET_RETURNS)
    cbuf, offs, nrows = regs_kernel.pack_stream(fk, seg_ends, 2)
    aux, UP = wgl_seg._aux(planner._pack_uop_tables(legal, nxt, *dec))
    return dict(cbuf=cbuf, offs=offs, nrows=nrows, aux=aux, UP=UP,
                R=fk.rn + fk.nc, rn=fk.rn, nc=fk.nc, Sn=states.shape[0],
                K=len(seg_ends))


def relaxed_inputs(h):
    """The relaxed tier's wire of h as check() builds it (crash-prefix
    closures and each row's index; the stripped history's segments)."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_seg
    model = CASRegister()
    spec = model.device_spec()
    c = wgl_seg._split(model, spec, h.ops, max_states=64, max_open_bits=12)
    rw = wgl_seg._relaxed_wire(c)
    cbuf, offs, nrows = rw.wire
    return dict(cbuf=cbuf, offs=offs, nrows=nrows, aux=rw.aux, UP=rw.UP,
                ctab=rw.ctab, R=rw.R, Sn=rw.Sn, K=len(offs),
                nC=len(rw.ctab) // (rw.Sn * (1 if rw.Sn <= 32 else 2)))


def crash_run(inp, device, kind, ks=None, seed=None, reps=0):
    """One variant's wrapper on `device` over the wire of `inp` (only
    segments `ks`, when given): kind "crash" (crash_scan), "relaxed"
    (relaxed_scan) or "death" (death_row from the states of `seed`).
    Returns (output numpy, work numpy, bad, (launch ms, device ms)):
    after the counted launch, `reps` launches timed from launch to end
    and 2 reps back to back on the device; NaN on the CPU or with reps
    = 0."""
    from jepsen_tpu_torch.ops import crash_kernel
    dev = torch.device(device)
    args = crash_args(inp, kind, ks, dev)
    work = torch.zeros(args[1].numel(), dtype=torch.int64, device=dev)

    def launch(w):
        kw = dict(R=inp["R"], Sn=inp["Sn"], UP=inp["UP"], work=w)
        if kind == "crash":
            return crash_kernel.crash_scan(*args, nc=inp["nc"],
                                           rn=inp["rn"], **kw)
        if kind == "relaxed":
            return crash_kernel.relaxed_scan(*args, **kw)
        return crash_kernel.death_row(*args, seed, **kw)
    out, bad = launch(work)
    ms = (float("nan"), float("nan"))
    if dev.type == "cuda" and reps:
        ms = (launch_ms(lambda: launch(None), reps),
              device_ms(lambda: launch(None), 2 * reps))
    return out.cpu().numpy(), work.cpu().numpy(), int(bad.cpu()[0]), ms


def crash_args(inp, kind, ks, dev):
    """The wire of `inp` (only segments `ks`, when given) as tensors on
    dev: cbuf, offs, nrows, aux (and ctab but for kind "crash")."""
    offs, nrows = inp["offs"], inp["nrows"]
    if ks is not None:
        offs, nrows = offs[ks], nrows[ks]
    names = ("cbuf", "offs", "nrows", "aux") + (
        ("ctab",) if kind != "crash" else ())
    arrs = dict(inp, offs=offs, nrows=nrows)
    return [torch.from_numpy(np.ascontiguousarray(arrs[n])).to(dev)
            for n in names]


def plain_crash_job(inp, kind, ks=None, seed=None, dev="cpu"):
    """The plain version (`crash_kernel.walk_plain`) on copies of the
    inputs on `dev`: on CPU copies in a worker process (one thread), or
    in PyTorch on the card.  Returns (output, work, the operations the
    walk needs, seconds)."""
    from jepsen_tpu_torch.ops import crash_kernel
    d = torch.device(dev)
    if d.type == "cpu":
        torch.set_num_threads(1)
    t = time.perf_counter()
    args = crash_args(inp, kind, ks, d)
    work, need = (torch.zeros(args[1].numel(), dtype=torch.int64, device=d)
                  for _ in range(2))
    out = crash_kernel.walk_plain(
        *args, R=inp["R"], Sn=inp["Sn"], UP=inp["UP"], nc=inp.get("nc", 0),
        rn=inp.get("rn", 0), seed=seed if kind == "death" else None,
        work=work, need=need)
    out, work, need = (x.cpu().numpy() for x in (out, work, need))
    return out, work, need, time.perf_counter() - t


def crash_wire_bytes(inp, out_bytes):
    return (inp["cbuf"].nbytes + 12 * len(inp["offs"]) + inp["aux"].nbytes
            + inp.get("ctab", np.zeros(0, np.int32)).nbytes + out_bytes)


# (rn, nc, vmax): nc = 1..4 at R + nc = 2..8, with (nc, Sn) at (1, 32),
# (2, 32), (3, 16) and (4, 8) (vmax 30 / 14 / 6 give 32 / 16 / 8 states)
CRASH_KERNEL_CASES = [(1, 1, 30), (4, 1, 30), (6, 1, 30), (7, 1, 30),
                      (1, 2, 30), (4, 2, 30), (6, 2, 30),
                      (1, 3, 14), (3, 3, 14), (5, 3, 14),
                      (1, 4, 6), (2, 4, 6), (3, 4, 6), (4, 4, 6)]
# (R, vmax, crash prefixes) of the relaxed variant and the death row:
# R = 1..6 at SnP 8 / 16 / 32, each prefix count at each SnP
RELAXED_KERNEL_CASES = [(R, v, (1, 40, 300)[(R + i) % 3])
                        for R in range(1, 7)
                        for i, v in enumerate((6, 9, 30))]


def crash_kernel_cases():
    """The [crash-kernel] cases: (kind, planted, inputs) for each crash
    and relaxed shape, valid and planted-invalid, 300-call histories."""
    cases = []
    for rn, nc, vmax in CRASH_KERNEL_CASES:
        for bad in (False, True):
            seed = 3000 + 10 * rn + nc + (5 if bad else 0)
            h = with_every_value(make_history(
                300, rn + 2, seed=seed, vmax=vmax, max_open=rn, burst=rn),
                vmax)
            h, vals = add_crashes(h, nc, seed, vmax)
            if bad and plant_stale_read(h, 0.6, vmax, vals) is None:
                raise SystemExit(f"[crash-kernel] no plantable read at "
                                 f"rn={rn} nc={nc}")
            inp = crash_inputs(h)
            if (inp["rn"], inp["nc"], inp["Sn"]) != (rn, nc, vmax + 2):
                raise SystemExit(f"[crash-kernel] built rn={inp['rn']} "
                                 f"nc={inp['nc']} Sn={inp['Sn']}, wanted "
                                 f"{rn}, {nc}, {vmax + 2}")
            cases.append(("crash", bad, inp))
    for R, vmax, nC in RELAXED_KERNEL_CASES:
        for bad in (False, True):
            seed = 4000 + 10 * R + vmax + (5 if bad else 0)
            h = make_history(300, R + 2, seed=seed, vmax=vmax, max_open=R,
                             burst=R)
            # crashed values leave vmax - 1 and vmax to the planted read
            h, vals = add_crashes(h, nC - 1, seed, vmax - 2,
                                  keep_last_open=False)
            if bad and plant_stale_read(h, 0.6, vmax, vals) is None:
                raise SystemExit(f"[crash-kernel] no plantable read at R={R}")
            inp = relaxed_inputs(h)
            if (inp["R"], inp["nC"]) != (R, nC):
                raise SystemExit(f"[crash-kernel] built R={inp['R']} "
                                 f"nC={inp['nC']}, wanted {R}, {nC}")
            cases.append(("relaxed", bad, inp))
    return cases


def phase_crash_kernel(clock_hz):
    """Each crash variant against its plain version on CPU copies of the
    same inputs: the crash variant at nc = 1..4 and R + nc = 2..8 (J up
    to 64 and 128), the relaxed variant (composed verdict) and the death
    row at R = 1..6 x SnP 8/16/32 with 1, 40 and 300 crash prefixes,
    each valid and planted-invalid: transfer rows, verdict words, death
    rows and operation counts; and ptxas's registers and spills of each
    instantiation.  Returns the largest disagreement per kernel."""
    from jepsen_tpu_torch.ops import cuda_build, regs_kernel, wgl_seg
    report = cuda_build.ptxas_report(cuda_build.lib_path("wgl_crash"))
    regs = {k: v for k, v in ptxas_kernels(
        report.read_text() if report.exists() else "").items()
        if k.startswith("wgl_crash")}
    log("[crash-kernel] ptxas (WD, SnP, closure): " + " | ".join(
        f"{k}: {v['regs']} registers, spill {v['spill']} bytes"
        for k, v in sorted(regs.items())))
    # segments of 64 returns, so each small history spans several
    target = wgl_seg.TARGET_RETURNS
    wgl_seg.TARGET_RETURNS = 64
    try:
        cases = crash_kernel_cases()
    finally:
        wgl_seg.TARGET_RETURNS = target
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    err = {"crash": 0, "relaxed": 0}
    seen = set()
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        jobs = [(kind, bad, inp, pool.submit(plain_crash_job, inp, kind))
                for kind, bad, inp in cases]
        for kind, bad, inp, fut in jobs:
            T, work, nbad, _ = crash_run(inp, DEV, kind)
            pT, pwork, _, secs = fut.result()
            K, Sn = inp["K"], inp["Sn"]
            vd = regs_kernel.compose(torch.from_numpy(T).to(DEV),
                                     [K]).cpu()[0].tolist()
            pvd = regs_kernel.compose(torch.from_numpy(pT),
                                      [K])[0].tolist()
            e = int(np.abs(T.astype(np.int64) - pT.astype(np.int64)).max())
            ok = (np.array_equal(T, pT) and np.array_equal(work, pwork)
                  and nbad == 0 and vd == pvd)
            if kind == "crash":     # exact: the verdict is the truth
                ok &= vd[0] == (0 if bad else 1)
            death = ""
            if kind == "relaxed":
                # the death row of the dead segment, from its reachable
                # entry states (segment 0 from state 0 when valid)
                dead = max(vd[1], 0)
                seed = (vd[2] & 0xFFFFFFFF) if vd[1] >= 0 else 1
                drow, dwork, dbad, _ = crash_run(inp, DEV, "death", [dead],
                                                 seed)
                pdrow, pdwork, _, _ = plain_crash_job(inp, "death", [dead],
                                                      seed)
                e = max(e, abs(int(drow[0]) - int(pdrow[0])))
                ok &= (int(drow[0]) == int(pdrow[0]) and dbad == 0
                       and np.array_equal(dwork, pdwork))
                if bad and vd[0] == 0:
                    ok &= int(drow[0]) >= 0
                death = (f" death_row={int(drow[0])}/{int(pdrow[0])} "
                         f"ops={int(dwork[0])}")
                seen.add(("relaxed", inp["R"], regs_kernel.snp(Sn),
                          inp["nC"]))
            else:
                seen.add(("crash", inp["nc"], inp["R"], regs_kernel.snp(Sn)))
            err[kind] = max(err[kind], e)
            b = seg_bound_ms(int(work.sum()), crash_wire_bytes(inp, T.nbytes),
                             clock_hz)
            log(f"[crash-kernel] {kind} R={inp['R']}"
                + (f" rn={inp['rn']} nc={inp['nc']} J={Sn << inp['nc']}"
                   if kind == "crash" else f" prefixes={inp['nC']}")
                + f" Sn={Sn} K={K} rows={int(inp['nrows'].sum())} "
                f"{'invalid' if bad else 'valid'} verdict={vd[:2]} "
                f"ops={int(work.sum())}{death} bound_ms={b:.4f} "
                f"plain_s={secs:.3f} {'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit("[crash-kernel] kernel and plain version "
                                 "disagree")
    want = {("crash", nc, rn + nc, snp)
            for rn, nc, v in CRASH_KERNEL_CASES
            for snp in (8 if v == 6 else 16 if v == 14 else 32,)}
    want |= {("relaxed", R, 8 if v == 6 else 16 if v == 9 else 32, nC)
             for R, v, nC in RELAXED_KERNEL_CASES}
    if not want <= seen:
        raise SystemExit(f"[crash-kernel] not run: {sorted(want - seen)}")
    return err


def stage_line(st):
    return ", ".join(f"{k} {st[k]:.3f} s" for k in (
        "scan", "split", "tier2", "stripped", "relaxed", "oracle")
        if k in st)


def segment_of(fk_positions, ops, seg_ends, index):
    """The segment holding the return of the call whose completion has
    op index `index`."""
    r = next(r for r, p in enumerate(fk_positions)
             if ops[p].index == index)
    return next(k for k, e in enumerate(seg_ends) if e > r)


def phase_crash_main(seg_hs):
    """The crash tiers at full size through Linearizable: (a) the hard
    regime (50,000 calls, 16 processes, 1% crashed, max_open 6, vmax 4)
    proven valid on its stripped twin; (b) the same shape at vmax 9 with
    crashed values 0..7 and a stale read planted at 90% depth, refuted
    under relaxed crash semantics at the planted read; (c) a north-star
    history with four ok completions turned :info (a read, two writes,
    a cas) on the nc = 3 segment kernel, valid and then planted-invalid
    at its dead segment; (d) an envelope history at max_open 8 with two
    write completions turned :info on the deep warp arm at R = 10, valid
    and then planted-invalid at its exact witness.  The crash kernels'
    launch counts start at 0 here."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import crash_kernel, deep_kernel, planner
    model = CASRegister()
    out = {}
    for k in crash_kernel.LAUNCHES:
        crash_kernel.LAUNCHES[k] = 0

    def run(tag, h, want, **kw):
        st = {}
        t = time.perf_counter()
        r = Linearizable(model, stats=st, **kw).check(None, h)
        dt = time.perf_counter() - t
        n_crash = sum(1 for o in h.ops if o.type == "info")
        keys = ("valid?", "engine", "crashed", "crashed_dropped",
                "crashed_ignored", "refutation", "witness", "op_index",
                "dead_segment", "max_open", "states")
        bad = {k: (r.get(k), v) for k, v in want.items() if r.get(k) != v}
        log(f"[crash-main] {tag}: {len(h.ops)} ops, {n_crash} crashed: "
            + " ".join(f"{k}={r.get(k)}" for k in keys if k in r)
            + f" R={r['dispatch'].get('R')} in {dt:.3f} s; stages: "
            f"{stage_line(st)}; why: {r['dispatch']['why']} "
            f"{'OK' if not bad else 'WRONG ' + str(bad)}")
        if bad:
            raise SystemExit(f"[crash-main] {tag}: {bad}")
        out[tag] = dict(r=r, s=dt, st=st)
        return r

    t = time.perf_counter()
    ha = make_history(HARD_N_OPS, 16, seed=23, crash_rate=0.01, max_open=6,
                      vmax=4)
    hb, wit_b = crash_b_history()
    hc, vals_c = crash_c_history(seg_hs[0])
    hc_bad = copy_history(hc)
    wit_c = plant_stale_read(hc_bad, 0.9, 9, forbidden=vals_c)
    hd0 = make_history(ENV_N_OPS, 16, seed=5100, vmax=9, max_open=8)
    hd, vals_d = crash_ops(hd0, [(0.3, "write"), (0.7, "write")])
    hd_bad = copy_history(hd)
    wit_d = plant_stale_read(hd_bad, 0.9, 9, forbidden=vals_d)
    if None in (wit_b, wit_c, wit_d):
        raise SystemExit("[crash-main] no plantable read")
    log(f"[crash-main] made the histories in {time.perf_counter() - t:.1f} s")
    attach_columns("the crash workloads", [ha, hb, hc, hc_bad, hd, hd_bad])
    n_a = sum(1 for o in ha.ops if o.type == "info")
    run("(a) hard regime", ha, {"valid?": True, "crashed_ignored": n_a},
        max_open_bits=12)
    run("(b) crash-regime refutation", hb,
        {"valid?": False, "refutation": "crash-relaxed",
         "witness": "relaxed-exact", "op_index": wit_b},
        max_open_bits=12, localize=False)
    run("(c) tier 2 on the segment kernel", hc,
        {"valid?": True, "engine": "wgl_seg", "crashed": 3,
         "crashed_dropped": 1, "max_open": 8, "states": 11})
    # the planted read's dead segment, from the tier-2 scan's segments
    from jepsen_tpu_torch.ops import wgl_seg
    spec = model.device_spec()
    span = inert_read_span(hc_bad)
    red = [o for o in hc_bad.ops if o.index not in span]
    fk = planner._fast_scan(red, spec, {}, [], 10, max_crashed=4)
    seg_ends = planner._segment_ends(fk.cuts, wgl_seg.TARGET_RETURNS)
    comp = completion_index(hc_bad, wit_c)
    dead_c = segment_of(fk.positions, red, seg_ends, comp)
    run("(c) planted", hc_bad,
        {"valid?": False, "engine": "wgl_seg", "crashed": 3,
         "crashed_dropped": 1, "dead_segment": dead_c}, localize=False)
    warp0 = deep_kernel.ARM_LAUNCHES["warp"]
    run("(d) deep route with crashes", hd,
        {"valid?": True, "engine": "wgl_deep", "crashed": 2})
    run("(d) planted", hd_bad,
        {"valid?": False, "engine": "wgl_deep", "crashed": 2,
         "op_index": wit_d}, localize=False)
    if out["(d) deep route with crashes"]["r"]["dispatch"]["R"] != 10 or \
            deep_kernel.ARM_LAUNCHES["warp"] - warp0 != 2:
        raise SystemExit("[crash-main] (d) did not run the deep warp arm "
                         "at R = 10")
    out["hists"] = dict(a=ha, b=hb, c=hc, d=hd)
    return out


def crash_b_history():
    """(b): the hard regime's shape at vmax 9, crashed values 0..7, and a
    stale read planted at 90% depth: (history, the read's index)."""
    hb = make_history(HARD_N_OPS, 16, seed=23, crash_rate=0.01, max_open=6,
                      vmax=9, crash_vmax=7)
    return hb, plant_stale_read(hb, 0.9, 9, forbidden=set(range(8)))


def crash_c_history(h0):
    """(c): north-star history h0 with four ok completions turned :info
    (a read, two writes, a cas): (history, the crashed values)."""
    return crash_ops(h0, [(0.2, "read"), (0.4, "write"), (0.6, "write"),
                          (0.8, "cas")])


def crash_timing_inputs(hc, hb):
    """The wires [crash-timing] launches: (c)'s tier-2 wire (its inert
    crashed read dropped, as tier 1 drops it) and (b)'s relaxed wire."""
    span = inert_read_span(hc)
    red = copy_history(hc)
    red.ops = [o for o in red.ops if o.index not in span]
    return crash_inputs(red), relaxed_inputs(hb)


def inert_read_span(h):
    """Op indices of the crashed read's invoke and :info in h."""
    info = next(o for o in h.ops if o.type == "info" and o.f == "read")
    inv = max(o.index for o in h.ops if o.process == info.process
              and o.type == "invoke" and o.index < info.index)
    return {inv, info.index}


def completion_index(h, invoke_index):
    inv = h.ops[invoke_index]
    return next(o.index for o in h.ops[invoke_index + 1:]
                if o.process == inv.process)


def phase_crash_pipeline(seg_hs, main):
    """A batch of SEG_BATCH north-star histories, four of them shaped as
    (c), through check_pipeline: the crash-bearing ones come back
    through check() with the verdicts of single calls, the rest stay
    pipelined.  Returns the crash kernels' launches over the crash main
    path (this phase and [crash-main])."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import crash_kernel, wgl_seg
    model = CASRegister()
    shaped = [main["hists"]["c"]] + [crash_c_history(h)[0]
                                     for h in seg_hs[1:4]]
    attach_columns("the crash-bearing pipeline histories", shaped[1:])
    batch = shaped + list(seg_hs[4:SEG_BATCH])
    st = {}
    t = time.perf_counter()
    res = wgl_seg.check_pipeline(model, batch, stats=st)
    wall = time.perf_counter() - t
    # the main path ends here: the single checks below only compare
    launches = dict(crash_kernel.LAUNCHES)
    singles = [main["(c) tier 2 on the segment kernel"]["r"]] + [
        wgl_seg.check(model, h) for h in shaped[1:]]
    keys = ("valid?", "engine", "crashed", "crashed_dropped", "dead_segment")
    bad = [i for i in range(4)
           if res[i].get("pipelined")
           or any(res[i].get(k) != singles[i].get(k) for k in keys)]
    bad += [i for i in range(4, len(batch))
            if res[i]["valid?"] is not True or not res[i].get("pipelined")]
    n_ops = sum(len(h.ops) for h in batch)
    log(f"[crash-pipeline] {len(batch)} histories ({len(shaped)} with "
        f"crashed calls): {n_ops / wall:.0f} ops/s, wall {wall:.3f} s, "
        f"stragglers {st.get('stragglers', 0.0):.3f} s, scan "
        f"{st.get('scan', 0.0):.3f} s; crash-bearing: "
        + "; ".join(f"valid?={r['valid?']} crashed={r.get('crashed')} "
                    f"dropped={r.get('crashed_dropped')}"
                    for r in res[:4])
        + f" {'OK' if not bad else 'WRONG ' + str(bad)}")
    if bad:
        raise SystemExit(f"[crash-pipeline] histories {bad} disagree")
    log(f"[crash-pipeline] crash kernel launches on the crash main path: "
        f"{launches}")
    # the two-word relaxed instances run on [wide-crash]'s path
    if min(v for k, v in launches.items()
           if k != "wgl_regs_relaxed_w2") <= 0:
        raise SystemExit("[crash-pipeline] the main path left a crash "
                         "kernel unlaunched")
    return launches


def phase_crash_timing(main, clock_hz):
    """The main path's crash launches timed (launch to end, mean of 5
    after the counted launch; and on the device) beside their plain
    versions and bounds:
    the tier-2 launch of (c) (all segments, then the first 16 against
    the plain version), the relaxed launch of (b) and its death-row
    launch; and the stage seconds of (a)-(d)."""
    from jepsen_tpu_torch.ops import regs_kernel
    ci, ri = crash_timing_inputs(main["hists"]["c"], main["hists"]["b"])
    ks = list(range(min(16, ci["K"])))
    ctx = multiprocessing.get_context("spawn")
    res = {}
    with ProcessPoolExecutor(3, mp_context=ctx) as pool:
        f_slice = pool.submit(plain_crash_job, ci, "crash", ks)
        f_rel = pool.submit(plain_crash_job, ri, "relaxed")
        T, work, nbad, (ms, dms) = crash_run(ci, DEV, "crash", reps=5)
        vd = regs_kernel.compose(torch.from_numpy(T).to(DEV),
                                 [ci["K"]]).cpu()[0].tolist()
        b_full = seg_bound_ms(int(work.sum()),
                              crash_wire_bytes(ci, T.nbytes), clock_hz)
        log(f"[crash-timing] tier-2 launch of (c): K={ci['K']} segments, "
            f"rows={int(ci['nrows'].sum())}, R={ci['R']} (rn={ci['rn']}, "
            f"nc={ci['nc']}), J={ci['Sn'] << ci['nc']}: verdict {vd[:2]}, "
            f"kernel {ms:.3f} ms launch to end (mean of 5), {dms:.3f} ms "
            f"on the device, bound {b_full:.4f} ms from {int(work.sum())} "
            f"integer operations ({b_full / ms:.4f} of it)")
        Ts, ws, _, (ms_s, dms_s) = crash_run(ci, DEV, "crash", ks, reps=5)
        pT, pwork, pneed, psecs = f_slice.result()
        if not (np.array_equal(Ts, pT) and np.array_equal(ws, pwork)
                and np.array_equal(ws, pneed) and np.array_equal(Ts, T[ks])):
            raise SystemExit("[crash-timing] tier-2 slice: kernel and plain "
                             "version disagree")
        b = seg_bound_ms(int(ws.sum()), crash_wire_bytes(
            dict(ci, offs=ci["offs"][ks]), Ts.nbytes), clock_hz)
        res["crash"] = dict(ms=ms_s, device_ms=dms_s,
                            plain_ms=1e3 * psecs, bound_ms=b,
                            err=int(np.abs(Ts.astype(np.int64)
                                           - pT.astype(np.int64)).max()))
        log(f"[crash-timing] tier-2 launch of (c), segments 0..{ks[-1]}: kernel "
            f"{ms_s:.3f} ms launch to end (mean of 5), {dms_s:.3f} ms on "
            f"the device, plain (CPU, one thread) "
            f"{1e3 * psecs:.1f} ms, bound {b:.4f} ms from {int(ws.sum())} "
            f"integer operations ({b / ms_s:.4f} of it); equal")
        Tr, wr, _, (ms_r, dms_r) = crash_run(ri, DEV, "relaxed", reps=5)
        vdr = regs_kernel.compose(torch.from_numpy(Tr).to(DEV),
                                  [ri["K"]]).cpu()[0].tolist()
        dead = vdr[1]
        seed = vdr[2] & 0xFFFFFFFF
        dr, dw, _, (ms_d, dms_d) = crash_run(ri, DEV, "death", [dead],
                                             seed, reps=5)
        t = time.perf_counter()
        pdr, pdw, pdn, _ = plain_crash_job(ri, "death", [dead], seed)
        pd_ms = 1e3 * (time.perf_counter() - t)
        pTr, pwr, pnr, rsecs = f_rel.result()
        if not (np.array_equal(Tr, pTr) and np.array_equal(wr, pwr)
                and int(dr[0]) == int(pdr[0])
                and np.array_equal(dw, pdw)):
            raise SystemExit("[crash-timing] relaxed: kernel and plain "
                             "version disagree")
        # the bound from the operations the walk needs; the work= count's
        # beside it charges every closure, needed or not
        rbytes = crash_wire_bytes(ri, Tr.nbytes)
        dbytes = crash_wire_bytes(dict(ri, offs=ri["offs"][[dead]]), 4)
        br = seg_bound_ms(int(pnr.sum()), rbytes, clock_hz)
        br_w = seg_bound_ms(int(wr.sum()), rbytes, clock_hz)
        bd = seg_bound_ms(int(pdn.sum()), dbytes, clock_hz)
        bd_w = seg_bound_ms(int(dw.sum()), dbytes, clock_hz)
        res["relaxed"] = dict(ms=ms_r, device_ms=dms_r,
                              plain_ms=1e3 * rsecs, bound_ms=br,
                              err=int(np.abs(Tr.astype(np.int64)
                                             - pTr.astype(np.int64)).max()))
        log(f"[crash-timing] relaxed launch of (b): K={ri['K']} segments, "
            f"rows={int(ri['nrows'].sum())}, R={ri['R']}, Sn={ri['Sn']}, "
            f"{ri['nC']} crash prefixes: dead segment {dead}, kernel "
            f"{ms_r:.3f} ms launch to end (mean of 5), {dms_r:.3f} ms on "
            f"the device, plain {1e3 * rsecs:.1f} ms, bound "
            f"{br:.4f} ms from the {int(pnr.sum())} integer operations it "
            f"needs ({br / ms_r:.4f} of it, {br / dms_r:.4f} on the "
            f"device), {br_w:.4f} ms from work={int(wr.sum())} "
            f"({br_w / ms_r:.4f}, {br_w / dms_r:.4f}); equal")
        log(f"[crash-timing] death-row launch of (b)'s dead segment: row "
            f"{int(dr[0])}, kernel {ms_d:.3f} ms launch to end (mean of "
            f"5), {dms_d:.3f} ms on the device, plain "
            f"{pd_ms:.1f} ms, bound {bd:.5f} ms from the {int(pdn.sum())} "
            f"integer operations it needs, {bd_w:.5f} ms from "
            f"work={int(dw.sum())}; equal")
    for tag, m in main.items():
        if tag != "hists":
            log(f"[crash-timing] {tag}: {m['s']:.3f} s; stages: "
                f"{stage_line(m['st'])}")
    res["T_crash"], res["T_relaxed"] = T, Tr
    return res


# ---------------------------------------------------------------------------
# Many independent keys (wgl_seg.check_many, independent.batch_checker)
# ---------------------------------------------------------------------------

MANY_KEYS = 3400                    # keys of the multi-key batch
MANY_CALLS = 300                    # calls a key
MANY_CRASH_KEYS = MANY_KEYS // 4    # keys of the crashed-keys batch
MANY_KERNEL_KEYS = 256              # keys held byte for byte
SM_CTAS = 32                        # resident CTAs an SM (sm_90)
SM_REGS = 65536                     # 32-bit registers an SM
SM_SMEM = 228 * 1024                # shared memory an SM, bytes
CTA_SMEM_RESERVED = 1024            # shared memory the runtime keeps a CTA


def many_keys(n, seed0, crash_every=0):
    """n keys of MANY_CALLS calls, concurrency 5, vmax 4, seeds seed0 +
    k (the JAX package's multi-key workload); with `crash_every`, 1% of
    the calls of every crash_every-th key crash."""
    return [make_history(MANY_CALLS, 5, seed=seed0 + k, vmax=4,
                         crash_rate=0.01 if crash_every
                         and k % crash_every == 0 else 0.0)
            for k in range(n)]


def many_line(tag, keys, res, st, wall, launches):
    """One log line of a check_many run: ops/s, wall, stages, launches,
    kernel ms and host share."""
    n_ops = sum(len(h) for h in keys)
    dev_ms = st.get("kernel_ms", 0.0)
    stages = ", ".join(f"{k} {st.get(k, 0.0):.3f} s" for k in (
        "scan", "tables", "pack", "launch", "sync", "assemble", "deep",
        "crash", "localize"))
    R = max((r["dispatch"]["R"] or 0) for r in res if "dispatch" in r)
    log(f"[{tag}] check_many {len(keys)} keys x {MANY_CALLS} calls "
        f"({n_ops} ops, R={R}): {n_ops / wall:.0f} ops/s, wall "
        f"{wall:.3f} s, key launches {launches}, kernel {dev_ms:.3f} ms, "
        f"host share {(wall - dev_ms / 1e3) / wall:.4f}; stages: {stages}")


def check_key_launches(tag, launches, st):
    """The key batch went through wgl_regs_keys: one key launch (as
    check_many counted it) and no launch of the segment kernel."""
    from jepsen_tpu_torch.ops import regs_kernel
    if launches != 1 or st["launches"] != 1 or regs_kernel.LAUNCHES:
        raise SystemExit(f"[{tag}] {launches} wgl_regs_keys launches and "
                         f"{regs_kernel.LAUNCHES} segment kernel launches "
                         f"on the main path, {st['launches']} key "
                         f"launches counted by check_many")


def phase_many_main():
    """MANY_KEYS keys through check_many (warm, then timed): every key
    valid on the key launch; then a stale read planted in three keys,
    which alone come back invalid, each at its planted read.  The
    segment kernel's launch count is read over the timed run."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import regs_kernel, wgl_seg
    t = time.perf_counter()
    keys = many_keys(MANY_KEYS, 1000)
    log(f"[many-main] made {MANY_KEYS} keys of {MANY_CALLS} calls in "
        f"{time.perf_counter() - t:.1f} s")
    attach_columns("the multi-key batch", keys)
    model = CASRegister()
    wgl_seg.check_many(model, keys)                  # warm
    regs_kernel.LAUNCHES = regs_kernel.KEYS_LAUNCHES = 0
    st = {}
    t = time.perf_counter()
    res = wgl_seg.check_many(model, keys, stats=st)
    wall = time.perf_counter() - t
    launches = regs_kernel.KEYS_LAUNCHES
    bad = [i for i, r in enumerate(res) if r["valid?"] is not True
           or r["engine"] != "wgl_seg_batch_regs"]
    if bad:
        raise SystemExit(f"[many-main] keys {bad[:8]} not judged valid by "
                         f"the key launch")
    many_line("many-main", keys, res, st, wall, launches)
    check_key_launches("many-main", launches, st)
    picks = (7, MANY_KEYS // 2, MANY_KEYS - 1)
    planted = list(keys)
    wits = {}
    for k in picks:
        planted[k] = copy_history(keys[k])
        wits[k] = plant_stale_read(planted[k], 0.5, 4)
        if wits[k] is None:
            raise SystemExit(f"[many-main] no plantable read in key {k}")
    attach_columns("the planted keys", [planted[k] for k in picks])
    t = time.perf_counter()
    rp = wgl_seg.check_many(model, planted)
    dt = time.perf_counter() - t
    got = {i: r.get("op_index") for i, r in enumerate(rp)
           if r["valid?"] is not True}
    ok = got == wits and all(rp[k]["engine"] == "wgl_seg_batch_regs"
                             for k in picks)
    log(f"[many-main] stale reads planted in keys {list(picks)} at "
        f"{[wits[k] for k in picks]}: invalid keys {sorted(got)} at "
        f"{[got.get(k) for k in picks]} in {dt:.3f} s "
        f"{'OK' if ok else 'WRONG'}")
    if not ok:
        raise SystemExit("[many-main] the planted keys were not the "
                         "invalid ones, at their planted reads")
    return keys, launches


def phase_many_crash():
    """MANY_CRASH_KEYS keys, 1% of calls crashed on every third key,
    through check_many: every key valid and batched (its engine a
    wgl_seg one); the crashed calls ignored are counted."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import regs_kernel, wgl_seg
    keys = many_keys(MANY_CRASH_KEYS, 5000, crash_every=3)
    attach_columns("the crashed-keys batch", keys)
    model = CASRegister()
    wgl_seg.check_many(model, keys)                  # warm
    regs_kernel.LAUNCHES = regs_kernel.KEYS_LAUNCHES = 0
    st = {}
    t = time.perf_counter()
    res = wgl_seg.check_many(model, keys, stats=st)
    wall = time.perf_counter() - t
    launches = regs_kernel.KEYS_LAUNCHES
    bad = [i for i, r in enumerate(res) if r["valid?"] is not True
           or not r["engine"].startswith("wgl_seg")]
    if bad:
        raise SystemExit(f"[many-crash] keys {bad[:8]} not judged valid "
                         f"by a batched engine")
    crashed = sum(o.type == "info" for h in keys for o in h.ops)
    ignored = sum(r.get("crashed_ignored", 0) for r in res)
    twins = sum("crashed_ignored" in r for r in res)
    many_line("many-crash", keys, res, st, wall, launches)
    check_key_launches("many-crash", launches, st)
    log(f"[many-crash] {crashed} crashed calls in {twins} keys, "
        f"{ignored} ignored on their keys' crash-stripped twins")
    if ignored != crashed:
        raise SystemExit("[many-crash] a crashed key left the batch")


def many_inputs(keys):
    """The key launch's inputs from `wgl_seg.key_launch_inputs`, the
    construction check_many launches: one alphabet, each key one
    segment, the longest first, rounds R (the deepest key's)."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_seg
    return wgl_seg.key_launch_inputs(CASRegister(), keys)._asdict()


def keys_run(inp, device):
    """keys_scan on `device` over the key launch `inp`: (T u8 numpy,
    work int64 numpy, bad)."""
    from jepsen_tpu_torch.ops import regs_kernel
    dev = torch.device(device)
    args = [torch.from_numpy(np.ascontiguousarray(inp[x])).to(dev)
            for x in ("cbuf", "offs", "nrows", "aux")]
    work = torch.full((len(inp["offs"]),), -1, dtype=torch.int64,
                      device=dev)
    T, bad = regs_kernel.keys_scan(*args, R=inp["R"], Sn=inp["Sn"],
                                   UP=inp["UP"], work=work)
    return T.cpu().numpy(), work.cpu().numpy(), int(bad.cpu()[0])


def plain_keys_job(inp):
    """The plain version on CPU copies, in a worker process: (T, work,
    need: the operations the walk needs, seconds)."""
    from jepsen_tpu_torch.ops import regs_kernel
    torch.set_num_threads(1)
    t = time.perf_counter()
    args = [torch.from_numpy(np.ascontiguousarray(inp[x]))
            for x in ("cbuf", "offs", "nrows", "aux")]
    work, need = (torch.zeros(len(inp["offs"]), dtype=torch.int64)
                  for _ in range(2))
    T = regs_kernel.scan_plain(*args, R=inp["R"], Sn=inp["Sn"],
                               UP=inp["UP"], J=1, rounds=inp["R"],
                               work=work, need=need)
    return T.numpy(), work.numpy(), need.numpy(), time.perf_counter() - t


def many_kernel_cases():
    """(name, key launch inputs, refused launch position or None) of
    launches that split a warp of the key kernel, at R = 4 and 6 (plane
    width 1 and 2) and vmax 4 / 12 / 28 (SnP 8 / 16 / 32): 11 keys (no
    multiple of 4 or 2 a warp) of 1 to about 330 rows, a one-row key
    beside keys longer than a staged chunk, stale reads planted in
    three, every key's open slots, rank-1 kinds and returning slots its
    own; random keys under random uop tables (random_key_launch: every
    rank-1 shape, at SnP 8, 16, 32 and Sn 1); and the first launch again
    with a uop id past the table in the key at launch position 5, which
    the kernel refuses alone."""
    from jepsen_tpu_torch.history import History, invoke_op, ok_op
    from jepsen_tpu_torch.ops import regs_kernel
    cases = []
    for R in (4, 6):
        for vmax in (4, 12, 28):
            hs = [make_history(n, R + 1, seed=9000 + 100 * R + vmax + k,
                               vmax=vmax, max_open=R,
                               burst=R if k == 0 else 0)
                  for k, n in enumerate(WARP_KEY_CALLS)]
            for k in (1, 4, 7):
                plant_stale_read(hs[k], 0.5, vmax)
            hs.insert(3, History([invoke_op(0, "write", 1),
                                  ok_op(0, "write", 1)]).index())
            inp = many_inputs(hs)
            name = f"R={inp['R']} SnP={regs_kernel.snp(inp['Sn'])}"
            cases.append((name, inp, None))
    for seed, (R, Sn) in enumerate(((5, 6), (6, 14), (4, 27), (2, 1))):
        inp = random_key_launch(9100 + seed, 11, R, Sn)
        cases.append((f"random table R={R} Sn={Sn}", inp, None))
    inp, p = cases[0][1], 5
    wire = refuse_key(tuple(inp[x] for x in ("cbuf", "offs", "nrows",
                                             "aux")), p, inp["UP"])
    cases.append((cases[0][0] + ", a uop id past the table",
                  dict(inp, cbuf=wire[0]), p))
    return cases


#: calls of the keys that split a warp (many_kernel_cases and the card
#: tests' keys): a key longer than a staged chunk beside short ones
WARP_KEY_CALLS = (300, 40, 150, 3, 90, 20, 200, 60, 8, 130)


def refuse_key(wire, p, UP):
    """A copy of the key launch's wire (cbuf, offs, nrows, aux) whose key
    at launch position p names a uop id past the table (UP) at its first
    invoke: the key kernel refuses that key alone."""
    cbuf, offs, nrows, aux = wire
    cbuf = cbuf.copy()
    o, L = int(offs[p]), int(nrows[p])
    cell = int(np.nonzero(cbuf[o + L:o + 3 * L])[0][0])
    cbuf[o + 3 * L + 2 * cell] = UP & 0xFF
    cbuf[o + 3 * L + 2 * cell + 1] = UP >> 8
    return cbuf, offs, nrows, aux


def random_key_launch(seed, K, R, Sn, UP=16, max_rows=90):
    """A key launch over K random keys (1 .. max_rows rows each, in
    launch order) under a random uop table of UP uops whose rank-1
    masks take every shape: none, one source row, every row but the
    target state (which the diagonal keeps), and random subsets.  Each
    key's rows invoke only free slots (< R) and return only open ones.
    Made with numpy from `seed`; a dict as many_inputs returns."""
    rng = np.random.default_rng(seed)
    bits = np.uint64(1) << np.arange(Sn, dtype=np.uint64)
    a1 = ((rng.random((UP, Sn)) < 0.8) @ bits).astype(np.uint32)
    t0 = rng.integers(0, Sn, UP).astype(np.uint32)
    cover = (1 << Sn) - 1
    a2 = np.zeros(UP, np.uint32)
    for u in range(UP):
        kind, t = u % 4, int(t0[u])
        if kind == 1:
            a2[u] = 1 << int(rng.integers(Sn))
        elif kind == 2:
            a2[u] = cover & ~(1 << t)
            a1[u] |= np.uint32(1 << t)
        elif kind == 3:
            a2[u] = int(rng.integers(0, 1 << Sn)) & cover
    bufs, offs, nrows, o = [], [], [], 0
    for _ in range(K):
        L = int(rng.integers(1, max_rows))
        ret = np.full(L, -1)
        isl = np.full((L, 2), -1)
        opened = set()
        for r in range(L):
            for i in range(2):
                free = [b for b in range(R) if b not in opened]
                if free and rng.random() < 0.6:
                    isl[r, i] = int(rng.choice(free))
                    opened.add(int(isl[r, i]))
            if opened and rng.random() < 0.8:
                ret[r] = int(rng.choice(sorted(opened)))
                opened.discard(int(ret[r]))
        iu = rng.integers(0, UP, (L, 2)).astype("<u2")
        bufs.append(np.concatenate([(ret + 1).astype(np.uint8),
                                    (isl + 1).astype(np.uint8).ravel(),
                                    iu.ravel().view(np.uint8)]))
        offs.append(o)
        nrows.append(L)
        o += len(bufs[-1])
    nrows = np.asarray(nrows, np.int32)
    order = np.argsort(-nrows, kind="stable")
    return dict(cbuf=np.concatenate(bufs),
                offs=np.asarray(offs, np.int64)[order], nrows=nrows[order],
                aux=np.concatenate([a1, a2, t0]).view(np.int32), R=R, Sn=Sn,
                UP=UP, order=order)


def key_routes(inp, dev):
    """The key launch's routes over the inputs `inp` on `dev`, as
    (name, fn) pairs: wgl_regs_keys, and the segment kernel at J = 1
    (the launch it replaced)."""
    from jepsen_tpu_torch.ops import regs_kernel
    args = [torch.from_numpy(np.ascontiguousarray(inp[x])).to(dev)
            for x in ("cbuf", "offs", "nrows", "aux")]
    kw = dict(R=inp["R"], Sn=inp["Sn"], UP=inp["UP"])
    return [("wgl_regs_keys", lambda: regs_kernel.keys_scan(*args, **kw)),
            ("wgl_regs_kernel J=1",
             lambda: regs_kernel.regs_scan(*args, J=1, rounds=kw["R"],
                                           **kw))]


def key_cycles(keys, clock_hz):
    """Each key route's time over the first N_SM keys (one key an SM for
    the J = 1 launch: one chain alone) and over all of them, in turns
    (J = 1, keys, keys, J = 1), on the device and launch to end; cycles
    a row: the device time at the max SM clock over the mean rows a
    key.  Returns {(route, K): {device_ms, ms, cycles}}."""
    out = {}
    for K in (N_SM, len(keys)):
        inp = many_inputs(keys[:K])
        rows = inp["nrows"]
        routes = dict(key_routes(inp, DEV))
        times = {name: [] for name in routes}
        for name in ("wgl_regs_kernel J=1", "wgl_regs_keys",
                     "wgl_regs_keys", "wgl_regs_kernel J=1"):
            fn = routes[name]
            fn()                                      # warm
            times[name].append((device_ms(fn, 10), launch_ms(fn, 5)))
        for name, ts in times.items():
            dms = sum(t[0] for t in ts) / len(ts)
            ms = sum(t[1] for t in ts) / len(ts)
            cyc = dms * 1e-3 * clock_hz / rows.mean()
            out[name, K] = dict(device_ms=dms, ms=ms, cycles=cyc)
            log(f"[many-kernel] K={K} keys ({int(rows.sum())} rows, "
                f"{rows.mean():.1f} a key, longest {int(rows.max())}): "
                f"{name} {dms:.4f} ms on the device (10 back to back; "
                f"turns {', '.join(f'{t[0]:.4f}' for t in ts)}), "
                f"{ms:.4f} ms launch to end (mean of 5; turns "
                f"{', '.join(f'{t[1]:.4f}' for t in ts)}), {cyc:.0f} "
                f"cycles a row")
    return out


def ctas_per_sm(k, dyn_smem=0):
    """Resident CTAs an SM of one-warp CTAs of the kernel instantiation
    whose ptxas counts are `k`, with `dyn_smem` bytes of dynamic shared
    memory a CTA: the least of the CTA limit, the register file
    (registers rounded up to 8 a thread) and shared memory."""
    regs = -(-k["regs"] // 8) * 8
    return min(SM_CTAS, SM_REGS // (32 * regs),
               SM_SMEM // (k["smem"] + dyn_smem + CTA_SMEM_RESERVED))


def phase_many_kernel(keys, kernels, clock_hz):
    """The key launch rebuilt as check_many builds it: wgl_regs_keys
    against the plain version byte for byte (on CPU copies of the same
    inputs) on the first MANY_KERNEL_KEYS keys, on the cases that split a
    warp and on the full launch; then cycles a row at one key an SM and
    at the full batch, the J = 1 launch of the segment kernel it
    replaced timed beside it in turns, and the bound: from the
    operations the walk needs (the plain version's `need`: no round past
    a row's open-slot count), beside the work= count's, which charges
    the plain version's one more round and so compares with the J = 1
    launch's."""
    from jepsen_tpu_torch.ops import regs_kernel
    small = many_inputs(keys[:MANY_KERNEL_KEYS])
    full = many_inputs(keys)
    cases = many_kernel_cases()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(2, mp_context=ctx) as pool:
        f_full = pool.submit(plain_keys_job, full)
        f_small = pool.submit(plain_keys_job, small)
        # the refused case's plain rows are its source case's (the first)
        f_cases = [pool.submit(plain_keys_job, inp)
                   for _, inp, p in cases if p is None]
        T, work, nbad = keys_run(small, DEV)
        pT, pwork, _, _ = f_small.result()
        ok = (T.tobytes() == pT.tobytes() and np.array_equal(work, pwork)
              and nbad == 0)
        log(f"[many-kernel] wgl_regs_keys, first {MANY_KERNEL_KEYS} keys "
            f"(R={small['R']}, Sn={small['Sn']}, rows="
            f"{int(small['nrows'].sum())}): transfer rows and operation "
            f"counts against the plain version "
            f"{'byte for byte OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit("[many-kernel] the key launch and its plain "
                             "version disagree")
        for i, (name, inp, p) in enumerate(cases):
            T, work, nbad = keys_run(inp, DEV)
            pT, pwork, _, _ = f_cases[0 if p is not None else i].result()
            keep = np.arange(len(inp["offs"])) != (-1 if p is None else p)
            ok = (T[keep].tobytes() == pT[keep].tobytes()
                  and np.array_equal(work[keep], pwork[keep])
                  and nbad == (p is not None)
                  and (p is None or work[p] == -1))
            log(f"[many-kernel] case {name}: K={len(inp['offs'])} keys of "
                f"{int(inp['nrows'].min())}..{int(inp['nrows'].max())} "
                f"rows, Sn={inp['Sn']}, {int((pT.max(-1) == 0).sum())} "
                f"dead, refused {nbad}: rows and counts "
                f"{'byte for byte OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"[many-kernel] case {name}: the key "
                                 f"kernel and its plain version disagree")
        Tn, wn, nbad = keys_run(full, DEV)
        cyc = key_cycles(keys, clock_hz)
        pT, pwork, pneed, psecs = f_full.result()
    K, Sn = len(full["offs"]), full["Sn"]
    if not (Tn.tobytes() == pT.tobytes() and np.array_equal(wn, pwork)
            and nbad == 0):
        raise SystemExit("[many-kernel] the full key launch and its plain "
                         "version disagree")
    new, old = cyc["wgl_regs_keys", K], cyc["wgl_regs_kernel J=1", K]
    n_bytes = full["cbuf"].nbytes + 12 * K + full["aux"].nbytes + K * Sn
    b = seg_bound_ms(int(pneed.sum()), n_bytes, clock_hz)
    b_w = seg_bound_ms(int(wn.sum()), n_bytes, clock_hz)
    wd, sp = regs_kernel.plane_width(full["R"]), regs_kernel.snp(Sn)
    name = f"wgl_regs_keys<{wd},{sp}>"
    k = kernels.get(name)
    dyn = 20 * 2 * 128          # the warp's two chunks of 128 staged cells
    occ = ctas_per_sm(k, dyn) if k else "not reported"
    log(f"[many-kernel] full launch: K={K} keys, rows="
        f"{int(full['nrows'].sum())}, R={full['R']}, Sn={Sn}, rounds "
        f"{full['R']}: {-(-K // (32 // sp))} CTAs of one warp "
        f"({32 // sp} keys a warp), {name} {k['regs'] if k else '?'} "
        f"registers, {k['smem'] if k else '?'} + {dyn} bytes of shared "
        f"memory, {occ} CTAs an SM; kernel {new['ms']:.4f} ms launch to end, "
        f"{new['device_ms']:.4f} ms on the device; the J = 1 launch "
        f"{old['ms']:.4f} / {old['device_ms']:.4f} ms (in turns, the same "
        f"call); plain (CPU, one thread) {1e3 * psecs:.1f} ms, equal byte "
        f"for byte; bound {b:.4f} ms from the {int(pneed.sum())} integer "
        f"operations the walk needs and {n_bytes} bytes "
        f"({b / new['ms']:.4f} of launch to end, "
        f"{b / new['device_ms']:.4f} of the device time; the J = 1 launch "
        f"{b / old['device_ms']:.4f}), {b_w:.4f} ms from "
        f"work={int(wn.sum())} ({b_w / new['ms']:.4f}, "
        f"{b_w / new['device_ms']:.4f}; the J = 1 launch "
        f"{b_w / old['device_ms']:.4f})")
    return dict(ms=new["ms"], device_ms=new["device_ms"],
                plain_ms=1e3 * psecs, bound_ms=b,
                err=int(np.abs(Tn.astype(np.int64)
                               - pT.astype(np.int64)).max()))


def phase_many_independent(keys):
    """One keyed history of 64 keys, a stale read planted in one, through
    independent.batch_checker: its results equal check_many's on the
    subhistories and failures names the planted key."""
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.independent import (KV, batch_checker,
                                              subhistory)
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_seg
    n, bad_key = 64, 41
    parts = [copy_history(h) for h in keys[:n]]
    if plant_stale_read(parts[bad_key], 0.5, 4) is None:
        raise SystemExit("[many-independent] no plantable read")
    # round-robin merge, each key on its own five processes
    streams = [[o.assoc(process=5 * k + o.process, value=KV(k, o.value))
                for o in h.ops] for k, h in enumerate(parts)]
    ops = [s[j] for j in range(max(map(len, streams))) for s in streams
           if j < len(s)]
    h = History(ops).index()
    t = time.perf_counter()
    out = batch_checker(CASRegister()).check(None, h)
    dt = time.perf_counter() - t
    ks = sorted(out["results"], key=repr)
    direct = wgl_seg.check_many(CASRegister(),
                                [subhistory(k, h) for k in ks])
    fields = ("valid?", "op_count", "op_index", "engine")
    same = all({f: out["results"][k].get(f) for f in fields}
               == {f: r.get(f) for f in fields}
               for k, r in zip(ks, direct))
    ok = (same and out["failures"] == [bad_key] and out["valid?"] is False
          and len(ks) == n)
    log(f"[many-independent] {n} keys, {len(h)} ops through "
        f"batch_checker in {dt:.3f} s: valid?={out['valid?']} failures="
        f"{out['failures']} (planted {bad_key}); results equal check_many "
        f"on the subhistories: {'OK' if ok else 'WRONG'}")
    if not ok:
        raise SystemExit("[many-independent] batch_checker disagrees")


# ---------------------------------------------------------------------------
# The serial frontier engine (ops.wgl, kernel wgl_frontier)
# ---------------------------------------------------------------------------

SERIAL_MAIN_CALLS = 20_000          # calls of the mixed batch's R <= 14 ones
#: ROADMAP C3's keys: (seed, calls, concurrency) of key_dicts(...,
#: buggy=0.3, crash_rate=0.15), each a residual crash key
C3_KEYS = ((304019, 34, 6), (741828, 38, 5), (767203, 31, 6))
#: (seed, crash rate) of make_history(MANY_CALLS, 5, seed, vmax=4,
#: crash_rate=rate) with a stale read planted at half depth (the
#: [many-crash] key shape), that every crash tier leaves open: the
#: residual case.  Found by a scan of seeds 30000-33500 on the CPU
#: device (about one key in ten there is residual; these are eight
#: whose CPU oracle ends within a second); a crashed write explains
#: each planted read, so each is valid.
SERIAL_CRASH_KEYS = ((30052, 0.02), (30155, 0.02), (30309, 0.02),
                     (33106, 0.02), (31031, 0.025), (31054, 0.025),
                     (32033, 0.03), (32068, 0.03))


def serial_inputs(model, h, device, pad=True):
    """The walk's inputs for history h as wgl.check builds them: (spec,
    plan, Tables, Crash or None, W) on `device`."""
    from jepsen_tpu_torch.ops import wgl
    from jepsen_tpu_torch.ops.prep import prepare
    pl, t, crash, W = wgl.walk_inputs(model, prepare(h), pad=pad,
                                      device=device)
    return model.device_spec(), pl, t, crash, W


def serial_walk(inp, F, r0, stop_r, frontier=None, work=None, plain=False,
                pools=None):
    """One launch of the walk (the kernel on CUDA inputs, the plain
    version on CPU ones, or with `plain` the plain version on the
    inputs' device, its dedupes by pool size into `pools`) from
    `frontier` (default: the initial one)."""
    from jepsen_tpu_torch.ops import frontier_kernel, wgl
    spec, pl, t, crash, W = inp
    dev = t.f.device
    if frontier is None:
        frontier = wgl.init_frontier(F, W, pl.init_state.shape[0],
                                     pl.init_state, dev)
    kw = dict(r0=r0, n_events=pl.n_events, stop_r=stop_r, crash=crash,
              work=work)
    if plain:
        return frontier_kernel.walk_plain(
            t, *(x.to(dev) for x in frontier), step=spec.step, pools=pools,
            **kw)
    return frontier_kernel.walk(t, *(x.to(dev) for x in frontier),
                                spec=spec, **kw)


def serial_compare(model, h, F, chunk, plain_on="cpu"):
    """The whole walk of h at frontier size F in launches of `chunk`
    events, each launch on the card against the plain version (on the
    host's CPU, or in PyTorch on `plain_on`) from the same entering
    frontier (the plain version's).  Returns (max abs difference over
    the outputs, the frontier words and the work= counts, launches,
    card seconds, plain seconds, last outputs, the rounds by form summed
    over the launches (frontier_kernel.LAST_LAUNCH), the last launch's
    CTAs)."""
    from jepsen_tpu_torch.ops import frontier_kernel
    card = serial_inputs(model, h, DEV)
    cpu = serial_inputs(model, h, plain_on)
    n_events = cpu[1].n_events
    frontier, r, err, launches = None, 0, 0, 0
    t_card = t_plain = 0.0
    forms, ctas = [0, 0, 0], 0
    while True:
        wc = torch.zeros(3, dtype=torch.int64, device=DEV)
        wp = torch.zeros(3, dtype=torch.int64, device=plain_on)
        frontier_kernel.RECORD = True
        try:
            t = time.perf_counter()
            a = serial_walk(card, F, r, r + chunk, frontier, wc)
            a["out"].cpu()                              # the walk's end
            t_card += time.perf_counter() - t
        finally:
            frontier_kernel.RECORD = False
        last = frontier_kernel.LAST_LAUNCH
        forms = [x + y for x, y in zip(forms, last["forms"].tolist())]
        ctas = last["ctas"]
        t = time.perf_counter()
        b = serial_walk(cpu, F, r, r + chunk, frontier, wp,
                        plain=plain_on != "cpu")
        b["out"].cpu()
        t_plain += time.perf_counter() - t
        launches += 1
        for x, y in ((a["out"], b["out"]), (wc, wp),
                     (a["final_masks"], b["final_masks"]),
                     (a["final_states"], b["final_states"]),
                     (a["final_valid"], b["final_valid"])):
            d = (x.cpu().to(torch.int64) - y.cpu().to(torch.int64)).abs()
            err = max(err, int(d.max()) if d.numel() else 0)
        ok, _, _, _, r = b["out"].tolist()
        if not ok or r >= n_events:
            return (err, launches, t_card, t_plain, b["out"].tolist(),
                    forms, ctas)
        frontier = (b["final_masks"], b["final_states"], b["final_valid"])


def serial_history(seed, calls, conc, burst):
    """The mixed-depth batch's deep histories (bench.py:2001-2012)."""
    return make_history(calls, conc, seed=seed, vmax=9, max_open=14,
                        burst=burst)


def mutex_dicts(seed, n=60, conc=4, bad=0.0, crash=0.3):
    """A mutex workload as op dicts: acquires and releases against a
    real lock.  A refused acquire completes ok anyway with chance `bad`
    (the history is then invalid), else crashes with chance `crash`,
    else fails."""
    rng = random.Random(seed)
    ops, held, pend = [], None, {}
    for _ in range(n):
        p = rng.randrange(conc)
        if p in pend:
            ops.append(pend.pop(p))
            continue
        f = "release" if held == p else "acquire"
        ops.append(op(p, "invoke", f, None))
        if f == "release" or held is None:
            held = None if f == "release" else p
            pend[p] = op(p, "ok", f, None)
        else:
            t = rng.random()
            pend[p] = op(p, "ok" if t < bad else
                         "info" if t < bad + crash else "fail", f, None)
    ops += list(pend.values())
    return [dict(d, index=j) for j, d in enumerate(ops)]


def write_burst(n, values=2, last_first=False):
    """n writes invoked together (process p writes p % values) and
    returned in invoke order (or last first): their slots 0..n-1 fill
    ceil(n / 32) mask words, the closures overflow every tier, and with
    few values most pool rows share their state digit.  Every order of
    writes is valid, but a truncated frontier keeps the rows smallest in
    word 0, so the walk lasts while those hold the returning slot (the
    first returns with last_first and more than 32 writes)."""
    from jepsen_tpu_torch.history import History, invoke_op, ok_op
    ops = [invoke_op(p, "write", p % values) for p in range(n)]
    order = reversed(range(n)) if last_first else range(n)
    ops += [ok_op(p, "write", p % values) for p in order]
    return History(ops).index()


SERIAL_KERNEL_NAMES = ("fast-path", "tiers", "overflow", "chunks",
                       "crash-1-word", "crash-2-words", "crash-4-words",
                       "crash-8192", "mutex", "burst-2-words",
                       "burst-3-words", "burst-5-words", "grid-8192",
                       "deciding-65536")
#: Cases whose plain version runs in PyTorch on the card (on a CPU the
#: walks at F = 8192 and 65536 take minutes).
SERIAL_PLAIN_ON_CARD = ("grid-8192", "deciding-65536")


def serial_kernel_cases():
    """(name, model, history, F, events a launch) of [serial-kernel]
    (SERIAL_KERNEL_NAMES, in order):
    the fast path, every tier with escalation, overflow at the last
    size, chunk boundaries, crash groups with dominance at 1, 2 and 4
    mask words, crash groups in the tier F = 8192 (17 crashed calls and
    a 10-write burst: the closure passes 512 configs, so it runs past
    the dominance cap, and overflows at 8192), a mutex; write bursts of
    24, 40 and 100 writes of two values (2, 3 and 5 key words, varying
    bits in every word, pools past one SM on the grid; each overflow
    keeps the rows of smallest word 0, so the truncation falls inside a
    run of equal high digits); the R = 18 deep history at F = 8192 (an
    overflow at every size, pools up to 270,336 rows: the grid's sort)
    and at F = 65536, the walk that decides it."""
    from jepsen_tpu_torch.convert import history_from_dicts
    from jepsen_tpu_torch.history import History, invoke_op, ok_op
    from jepsen_tpu_torch.models import CASRegister, Mutex
    burst = [invoke_op(p, "write", p % 3) for p in range(11)]
    burst += [ok_op(p, "write", p % 3) for p in range(11)]
    cas = CASRegister()
    return [
        ("fast-path", cas, make_history(600, 4, seed=61, vmax=4), 64,
         4096),
        ("tiers", cas, History(burst).index(), 4096, 4096),
        ("overflow", cas, serial_history(983, 1_200, 22, 18), 1024, 4096),
        ("chunks", cas, make_history(600, 8, seed=62, vmax=4, max_open=6),
         512, 37),
        ("crash-1-word", cas, history_from_dicts(key_dicts(
            741828, n_calls=38, conc=5, buggy=0.3, crash_rate=0.15)),
         1024, 16),
        ("crash-2-words", cas, history_from_dicts(key_dicts(
            52, n_calls=100, conc=5, crash_rate=0.35)), 1024, 4096),
        ("crash-4-words", cas, history_from_dicts(key_dicts(
            70, n_calls=180, conc=4, crash_rate=0.45, buggy=0.05)), 64,
         4096),
        ("crash-8192", cas, history_from_dicts(key_dicts(
            81, n_calls=40, conc=4, burst=10, crash_rate=0.25)), 8192, 20),
        ("mutex", Mutex(), history_from_dicts(mutex_dicts(63)), 64, 9),
        ("burst-2-words", cas, write_burst(24), 1024, 4096),
        ("burst-3-words", cas, write_burst(40), 1024, 16),
        ("burst-5-words", cas, write_burst(100, last_first=True), 512,
         4096),
        ("grid-8192", cas, serial_history(983, 1_200, 22, 18), 8192, 4096),
        ("deciding-65536", cas, serial_history(983, 1_200, 22, 18), 65536,
         4096),
    ]


def phase_serial_kernel(clock_hz):
    """wgl_frontier against its plain version, launch by launch, on
    serial_kernel_cases(): outputs, frontier words and work= counts
    equal; each case's rounds by form; both forms of launch and every
    form of round must appear.  Then the "tiers" and "crash-8192" cases
    timed.  Returns the largest difference (0)."""
    err = 0
    cases = serial_kernel_cases()
    seen = [0, 0, 0]
    one_cta = grid = False
    for name, model, h, F, chunk in cases:
        plain_on = DEV if name in SERIAL_PLAIN_ON_CARD else "cpu"
        e, n, tc, tp, out, forms, ctas = serial_compare(model, h, F, chunk,
                                                        plain_on)
        wd = serial_inputs(model, h, "cpu")[4]
        seen = [x + y for x, y in zip(seen, forms)]
        one_cta |= ctas == 1
        grid |= ctas > 1
        log(f"[serial-kernel] {name}: {len(h)} ops, F={F}, W={wd}, "
            f"{n} launches of <= {chunk} events, out {out}: card "
            f"{1e3 * tc:.3f} ms, plain ({plain_on}) {1e3 * tp:.1f} ms; "
            f"{ctas} CTA(s); rounds {forms[0]} in shared memory, "
            f"{forms[1]} built on the grid and sorted in shared memory, "
            f"{forms[2]} built and sorted on the grid; max abs difference "
            f"{e} {'OK' if e == 0 else 'WRONG'}")
        err = max(err, e)
    if err:
        raise SystemExit("[serial-kernel] wgl_frontier disagrees with its "
                         "plain version")
    if not (one_cta and grid and all(seen)):
        raise SystemExit(f"[serial-kernel] a form did not run: one CTA "
                         f"{one_cta}, grid {grid}, rounds by form {seen}")
    for name, model, h, F, _ in cases:
        if name in ("tiers", "crash-8192"):
            serial_timing(f"serial-kernel] [{name}", model, h, F, clock_hz)
    return err


def serial_bound_ms(work, kw, in_bytes, clock_hz):
    """The walk's least time: the operations its work= count needs
    (frontier_kernel's EXPAND_OPS an expansion, CMP_OPS a key word of
    each sorted row-level, DOM_OPS a key word of each dominance pair)
    over every INT32 lane, or its inputs and its frontier over device
    memory; and which bounds it."""
    from jepsen_tpu_torch.ops import frontier_kernel as fk
    ops = (fk.EXPAND_OPS * work[0] + fk.CMP_OPS * kw * work[1]
           + fk.DOM_OPS * kw * work[2])
    t_ops = 1e3 * ops / (N_SM * INT32_LANES_PER_SM * clock_hz)
    t_bytes = 1e3 * in_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes", ops


def serial_timing(tag, model, h, F, clock_hz, plain_on="cpu", pools=None):
    """One launch of the whole walk of h at F on the card, from launch to
    end and on the device, beside the plain version (on the host's CPU,
    or with plain_on=DEV in PyTorch on the card; its dedupes by pool
    size into `pools`) and the bound; the launch's CTAs and rounds by
    form."""
    from jepsen_tpu_torch.ops import frontier_kernel
    card = serial_inputs(model, h, DEV)
    plain_in = serial_inputs(model, h, plain_on)
    n = card[1].n_events
    work = torch.zeros(3, dtype=torch.int64, device=DEV)
    serial_walk(card, F, 0, n, work=work)                 # warm
    ms = launch_ms(lambda: serial_walk(card, F, 0, n, work=work), 3)
    dev_ms = device_ms(lambda: serial_walk(card, F, 0, n), 3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain = serial_walk(plain_in, F, 0, n, plain=True, pools=pools)
    plain["out"].cpu()                                  # the walk's end
    plain_ms = 1e3 * (time.perf_counter() - t)
    frontier_kernel.RECORD = True
    try:
        got = serial_walk(card, F, 0, n, work=work)
    finally:
        frontier_kernel.RECORD = False
    forms = frontier_kernel.LAST_LAUNCH["forms"].tolist()
    ctas = frontier_kernel.LAST_LAUNCH["ctas"]
    w = work.tolist()
    err = max(int((got[k].cpu().to(torch.int64)
                   - plain[k].cpu().to(torch.int64)).abs().max())
              for k in ("out", "final_masks", "final_states",
                        "final_valid"))
    kw = max((card[4] + 31) // 32, 1) + 1           # key words a row
    in_bytes = sum(x.numel() * x.element_size() for x in card[2]) \
        + 2 * F * (kw * 4 + 1)
    bound, by, ops = serial_bound_ms(w, kw, in_bytes, clock_hz)
    log(f"[{tag}] wgl_frontier over {len(h)} ops ({n} returns) at F={F}: "
        f"{ms:.3f} ms launch to end, {dev_ms:.3f} ms on the device; plain "
        f"({'the host CPU' if plain_on == 'cpu' else 'PyTorch on the card'}"
        f") {plain_ms:.1f} ms; out {got['out'].tolist()}; work= "
        f"{w[0]} expansions, {w[1]} sorted row-levels, {w[2]} dominance "
        f"pairs ({ops} operations, {in_bytes} bytes): bound {bound:.7f} "
        f"ms ({by}), reached {100 * bound / dev_ms:.4f}% on the device; "
        f"{ctas} CTA(s), rounds {forms[0]} in shared memory, {forms[1]} "
        f"built on the grid, {forms[2]} sorted on the grid; max abs "
        f"difference {err}")
    if err:
        raise SystemExit(f"[{tag}] wgl_frontier disagrees with its plain "
                         f"version")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "err": err, "F": F,
            "work": w, "forms": forms, "ctas": ctas}


def phase_serial_main(clock_hz):
    """The JAX package's mixed-depth envelope batch, not cut
    (bench.py:1996-2033): three histories of SERIAL_MAIN_CALLS calls at
    concurrency 16 and max_open 14, one of 1,200 calls plus a 15-write
    burst (R = 15) and one of 1,200 calls at concurrency 22 plus an
    18-write burst (R = 18), vmax 9, through wgl_deep.check_pipeline:
    all valid, R = 15 word-split on the deep grid, R = 18 a straggler on
    the serial engine (wgl_frontier launched).  Then the R = 18 history
    and a stale read planted in its twin through Linearizable: valid,
    and refuted at the planted read.  Then the R = 18 history's walks
    timed: at F = 1024 (an overflow, then a death at return 37) against
    the plain version on the host's CPU, and the walk that decides it,
    at the last of the frontier sizes, against the plain version in
    PyTorch on the card (on the host's CPU it takes minutes).  Returns
    (the kernel's launches on the batch, the deciding walk's timing,
    the F = 1024 walk's timing)."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import frontier_kernel, wgl_deep
    t = time.perf_counter()
    mixed = [serial_history(977 + s, SERIAL_MAIN_CALLS, 16, 0)
             for s in range(3)]
    mixed += [serial_history(981, 1_200, 18, 15),
              serial_history(983, 1_200, 22, 18)]
    log(f"[serial-main] made the mixed batch ({sum(map(len, mixed))} ops) "
        f"in {time.perf_counter() - t:.1f} s")
    attach_columns("the mixed batch", mixed)
    model = CASRegister()
    frontier_kernel.LAUNCHES["wgl_frontier"] = 0
    st = {}
    t = time.perf_counter()
    res = wgl_deep.check_pipeline(model, mixed, stats=st)
    wall = time.perf_counter() - t
    launches = frontier_kernel.LAUNCHES["wgl_frontier"]
    r18 = res[-1]
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in st.items()
                       if k != "kernel_ms")
    log(f"[serial-main] check_pipeline: valid? "
        f"{[r['valid?'] for r in res]}, engines "
        f"{[r.get('engine') for r in res]}, R = 15 "
        f"{res[3].get('deep_variant')}; R = 18 frontier "
        f"{r18.get('frontier_size')} ({r18.get('final_frontier')} configs "
        f"left), walk {r18.get('time_kernel_s', 0.0):.3f} s; wall "
        f"{wall:.3f} s; stages: {stages}; wgl_frontier launches "
        f"{launches}")
    ok = (all(r["valid?"] is True for r in res)
          and res[3].get("deep_variant") == "word-split"
          and all(r["engine"] == "wgl_deep" for r in res[:4])
          and r18["engine"] == r18["dispatch"]["engine"] == "wgl")
    if not ok or not launches:
        raise SystemExit("[serial-main] the mixed batch was judged or "
                         "routed wrong, or wgl_frontier was not launched")
    h18 = mixed[-1]
    twin = copy_history(h18)
    wit = plant_stale_read(twin, 0.5, 9)
    out = {}
    for name, h in (("R = 18", h18), ("its planted twin", twin)):
        t = time.perf_counter()
        out[name] = Linearizable(model).check(None, h)
        r = out[name]
        log(f"[serial-main] Linearizable on {name}: valid? {r['valid?']}, "
            f"engine {r.get('engine')}, op_index {r.get('op_index')} "
            f"(planted {wit}), frontier {r.get('frontier_size')}, walk "
            f"{r.get('time_kernel_s', 0.0):.3f} s, wall "
            f"{time.perf_counter() - t:.3f} s")
    if (out["R = 18"]["valid?"] is not True
            or out["its planted twin"]["valid?"] is not False
            or out["its planted twin"].get("op_index") != wit
            or out["its planted twin"].get("engine") != "wgl"):
        raise SystemExit("[serial-main] Linearizable's serial verdicts "
                         "are wrong")
    first = serial_timing("serial-main", model, h18, 1024, clock_hz)
    F = r18["frontier_size"]
    pools = {}
    deciding = serial_timing(f"serial-main] [deciding F={F}", model, h18,
                             F, clock_hz, plain_on=DEV, pools=pools)
    levels = sum(b * rows for b, (_, rows) in pools.items())
    log(f"[serial-main] [deciding F={F}] dedupes by pool size P, "
        f"2^(b-1) < P <= 2^b (the plain version's count on the card): "
        + "; ".join(f"b={b}: {n} rounds, {rows} rows"
                    for b, (n, rows) in sorted(pools.items()))
        + f"; {sum(n for n, _ in pools.values())} rounds, "
        f"{sum(rows for _, rows in pools.values())} rows, {levels} sorted "
        f"row-levels (work= {deciding['work'][1]})")
    if levels != deciding["work"][1]:
        raise SystemExit("[serial-main] the pool sizes disagree with work=")
    return launches, deciding, first


def serial_crash_keys():
    """(name, History) of [serial-crash]: C3's keys, then the residual
    keys of the [many-crash] shape."""
    from jepsen_tpu_torch.convert import history_from_dicts
    keys = [(f"C3 {s}", history_from_dicts(key_dicts(
        s, n_calls=n, conc=c, buggy=0.3, crash_rate=0.15)))
        for s, n, c in C3_KEYS]
    for seed, rate in SERIAL_CRASH_KEYS:
        h = make_history(MANY_CALLS, 5, seed=seed, vmax=4, crash_rate=rate)
        plant_stale_read(h, 0.5, 4)
        keys.append((f"many-crash {seed}", h))
    return keys


def phase_serial_crash(clock_hz):
    """C3's keys and the residual keys of the [many-crash] shape: each
    one wgl_seg.check leaves open (the relaxed refutation does not
    refute it), through check_many (engine fallback) and Linearizable
    (engine wgl): the CPU oracle's verdict and witness.  Returns the
    kernel's launches over it."""
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.errors import Unsupported
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import frontier_kernel, wgl_cpu, wgl_seg
    model = CASRegister()
    keys = serial_crash_keys()
    log(f"[serial-crash] keys: C3 seeds {[s for s, _, _ in C3_KEYS]}; "
        f"[many-crash] shape (seed, crash rate) {list(SERIAL_CRASH_KEYS)}")
    for name, h in keys:
        try:
            wgl_seg.check(model, h, localize=False)
        except Unsupported as e:
            if "relaxed refutation" in str(e):
                continue
        raise SystemExit(f"[serial-crash] {name} is not a residual key")
    frontier_kernel.LAUNCHES["wgl_frontier"] = 0
    st = {}
    t = time.perf_counter()
    many = wgl_seg.check_many(model, [h for _, h in keys], stats=st)
    wall = time.perf_counter() - t
    launches = frontier_kernel.LAUNCHES["wgl_frontier"]
    bad = []
    for (name, h), r in zip(keys, many):
        oracle = wgl_cpu.check(model, h)
        lin = Linearizable(model).check(None, h)
        want = (oracle["valid?"], oracle.get("op_index"))
        got = [(x["valid?"], x.get("op_index")) for x in (r, lin)]
        log(f"[serial-crash] {name}: {len(h)} ops, "
            f"{sum(o.type == 'info' for o in h.ops)} crashed; check_many "
            f"{got[0]} ({r.get('engine')}, frontier "
            f"{r.get('frontier_size')}), Linearizable {got[1]} "
            f"({lin.get('engine')}), CPU oracle {want}")
        if (got != [want, want] or r.get("engine") != "fallback"
                or lin.get("engine") != "wgl"):
            bad.append(name)
    log(f"[serial-crash] check_many over {len(keys)} keys in {wall:.3f} s "
        f"(fallback stage {st.get('fallback', 0.0):.3f} s); wgl_frontier "
        f"launches {launches}")
    if bad or not launches:
        raise SystemExit(f"[serial-crash] keys {bad} disagree with the CPU "
                         f"oracle, or wgl_frontier was not launched")
    name, h = keys[1]
    serial_timing(f"serial-crash] [{name}", model, h, 1024, clock_hz)
    return launches


# ---------------------------------------------------------------------------
# Elle: the transactional isolation checker (inference, the dense tier and
# the packed tier on the kernel elle_pmm)
# ---------------------------------------------------------------------------

ELLE_CONC = 10                      # client processes of a simulated store
ELLE_KEY_COUNT = 3                  # the JAX package's list-append
ELLE_MIN_LEN, ELLE_MAX_LEN = 1, 4   # defaults (workloads/list_append.py:
ELLE_WRITES_PER_KEY = 32            # 26-28): active keys, micro-ops a txn,
ELLE_READ_RATIO = 0.5               # appends before a key retires, reads
ELLE_PLANT_KEY = 1 << 20            # first key of a planted block
ELLE_PLANTS = ("G1c", "G-single", "G2-item", "G1a")
#: (valid?, anomaly-types, weakest-violated, not) of a clean history and
#: of each planted block
ELLE_EXPECT = {
    None: (True, [], None, []),
    "G1c": (False, ["G1c"], "read-committed",
            ["read-committed", "snapshot-isolation", "serializable"]),
    "G-single": (False, ["G-single"], "snapshot-isolation",
                 ["snapshot-isolation", "serializable"]),
    "G2-item": (False, ["G2-item"], "serializable", ["serializable"]),
    "G1a": (False, ["G1a"], "read-committed",
            ["read-committed", "snapshot-isolation", "serializable"]),
}
ELLE_MAIN = ((1000, 8), (10_000, 1))    # (txns, histories): the bench's rows
ELLE_CHECK_SIZES = (1000, 10_000)       # auto: dense tier, packed tier
ELLE_MESH_AT = 8192                     # Elle()'s mesh_threshold
ELLE_KEYS, ELLE_KEY_TXNS = 64, 100      # the [elle-check] keyed history
ELLE_KEY_PLANTS = (5, 17, 42)           # its keys with a planted G-single
ELLE_KERNEL_NPADS = (128, 384, 1024, 10_112)
ELLE_MIXED_NPADS = (384, 10_112)
ELLE_CROSS_DENSITIES = (0.002, 0.005, 0.01)   # gathered rounds
INT8_OPS_PER_S = 1.979e15           # H100 SXM dense int8 tensor cores
BF16_FLOPS_PER_S = 989e12           # H100 SXM dense bf16 tensor cores


def elle_expected(plant):
    return ELLE_EXPECT[plant]


def elle_plant_block(emit, kind):
    """One planted anomaly on two fresh keys, emitted while every client
    is idle (so the block's txns meet the rest only through po and rt,
    which order them after everything before and before everything
    after): the planted histories of the JAX package's tests/test_elle.py
    (:38-143), and a session's read that misses its own append (the
    lattice's read-your-writes, tests/test_lattice.py:66-73)."""
    a, b = ELLE_PLANT_KEY, ELLE_PLANT_KEY + 1
    if kind == "G1c":           # wr a then ww b against it
        t0 = [["append", a, 1], ["append", b, 2]]
        emit(0, "invoke", t0)
        emit(1, "invoke", [["r", a, None], ["append", b, 1]])
        emit(1, "ok", [["r", a, [1]], ["append", b, 1]])
        emit(0, "ok", t0)
        emit(2, "invoke", [["r", b, None]])
        emit(2, "ok", [["r", b, [1, 2]]])
    elif kind == "G-single":    # read skew: one append seen, one missed
        t1 = [["append", a, 1], ["append", b, 1]]
        emit(0, "invoke", [["r", b, None], ["r", a, None]])
        emit(1, "invoke", t1)
        emit(1, "ok", t1)
        emit(0, "ok", [["r", b, [1]], ["r", a, []]])
    elif kind == "G2-item":     # write skew: each misses the other
        emit(0, "invoke", [["r", a, None], ["append", b, 1]])
        emit(1, "invoke", [["r", b, None], ["append", a, 1]])
        emit(0, "ok", [["r", a, []], ["append", b, 1]])
        emit(1, "ok", [["r", b, []], ["append", a, 1]])
        emit(2, "invoke", [["r", a, None], ["r", b, None]])
        emit(2, "ok", [["r", a, [1]], ["r", b, [1]]])
    elif kind == "G1a":         # a read of a failed append
        t0 = [["append", a, 9]]
        emit(0, "invoke", t0)
        emit(0, "fail", t0)
        emit(1, "invoke", [["r", a, None]])
        emit(1, "ok", [["r", a, [9]]])
    elif kind == "read-your-writes":    # a session reads past its append
        t0 = [["append", a, 1]]
        emit(0, "invoke", t0)
        emit(0, "ok", t0)
        emit(0, "invoke", [["r", a, None]])
        emit(0, "ok", [["r", a, []]])
        emit(1, "invoke", [["r", a, None]])
        emit(1, "ok", [["r", a, [1]]])
    else:
        raise ValueError(f"no planted block {kind!r}")


def list_append_history(n_txns, seed, plant=None, conc=ELLE_CONC):
    """Op dicts of a list-append test against a serializable store: conc
    clients each run one txn at a time (the JAX package's list-append
    generator: ELLE_KEY_COUNT active keys, ELLE_MIN_LEN..ELLE_MAX_LEN
    micro-ops, a read with probability ELLE_READ_RATIO, else an append of
    the key's next value, the key retired after ELLE_WRITES_PER_KEY
    appends); the store applies a txn whole when it completes, so the
    history is strictly serializable.  With `plant`, every open txn is
    completed halfway through and a planted block (`elle_plant_block`)
    is emitted."""
    rng = random.Random(seed)
    state: dict = {}
    active = list(range(ELLE_KEY_COUNT))
    counters = {k: 0 for k in active}
    next_key = ELLE_KEY_COUNT
    ops: list = []
    inflight: dict = {}

    def emit(p, typ, value):
        ops.append({"index": len(ops), "process": p, "type": typ,
                    "f": "txn", "value": value, "time": len(ops)})

    def mop():
        nonlocal next_key
        k = rng.choice(active)
        if rng.random() < ELLE_READ_RATIO:
            return ["r", k, None]
        counters[k] += 1
        v = counters[k]
        if v >= ELLE_WRITES_PER_KEY:
            active[active.index(k)] = next_key
            counters[next_key] = 0
            next_key += 1
        return ["append", k, v]

    def complete(p):
        out = []
        for f, k, v in inflight.pop(p):
            if f == "r":
                out.append(["r", k, list(state.get(k, ()))])
            else:
                state.setdefault(k, []).append(v)
                out.append(["append", k, v])
        emit(p, "ok", out)

    started = 0
    planted = plant is None
    while started < n_txns or inflight:
        if not planted and started >= n_txns // 2:
            for p in sorted(inflight):
                complete(p)
            elle_plant_block(emit, plant)
            planted = True
        p = rng.randrange(conc)
        if p in inflight:
            complete(p)
        elif started < n_txns:
            txn = [mop() for _ in range(rng.randint(ELLE_MIN_LEN,
                                                    ELLE_MAX_LEN))]
            inflight[p] = txn
            emit(p, "invoke", [list(m) for m in txn])
            started += 1
    return ops


def keyed_list_append(n_keys, n_txns, plant_keys, seed0):
    """One history over n_keys independent keys: key j a simulated store
    history (a planted G-single where j is in plant_keys) on its own
    conc processes, values tagged as independent tuples, the keys' ops
    merged round-robin."""
    streams = []
    for j in range(n_keys):
        ops = list_append_history(
            n_txns, seed0 + j, plant="G-single" if j in plant_keys else None)
        streams.append([dict(d, process=ELLE_CONC * j + d["process"],
                             value={"__kv__": [j, d["value"]]})
                        for d in ops])
    merged = [d for group in itertools.zip_longest(*streams) for d in group
              if d is not None]
    return [dict(d, index=i, time=i) for i, d in enumerate(merged)]


def elle_stack(n, seed, plant):
    """The JAX package's Elle bench planes (bench.py:2139-2165): a random
    DAG of ww and wr edges at 4/n density over a random order, a po
    chain along it, an rt sample at 1/n, no rw; with `plant`, one
    backward rw edge, whose only cycles are single-rw: G-single."""
    rng = np.random.RandomState(seed)
    st = np.zeros((5, n, n), bool)
    perm = rng.permutation(n)
    pos = np.empty(n, int)
    pos[perm] = np.arange(n)
    fwd = pos[:, None] < pos[None, :]
    for p in range(2):
        st[p] = fwd & (rng.rand(n, n) < 4.0 / n)
    for a, b in zip(perm, perm[1:]):
        st[3, a, b] = True
    st[4] = fwd & (rng.rand(n, n) < 1.0 / n)
    if plant:
        a, b = int(perm[n // 3]), int(perm[2 * n // 3])
        st[2, b, a] = True
    return st


def elle_bench_stacks():
    """[(n, [stacks])] of ELLE_MAIN, seeded as the bench seeds them
    (bench.py:2175-2188): a planted G-single in the even ones."""
    return [(n, [elle_stack(n, 1000 + n + i, plant=i % 2 == 0)
                 for i in range(b)]) for n, b in ELLE_MAIN]


def elle_triple(stack, dev):
    """(ww, wr, rw, cww, p0, p1): a bench stack's packed planes on dev and
    its closure's starting triple, order planes included."""
    from jepsen_tpu_torch.ops import elle_mesh
    t = elle_mesh._to_device(elle_mesh.pack_planes(stack), dev)
    ww, wr, rw, od = t[0], t[1], t[2], t[3] | t[4]
    eye = elle_mesh._eye(t.shape[1], dev)
    return ww, wr, rw, ww | od, ww | wr | od | eye, rw.clone()


def random_packed(n_pad, n, dens, gen, dev):
    from jepsen_tpu_torch.ops import elle_kernel
    bits = torch.rand((n_pad, n_pad), generator=gen, device=dev) < dens
    bits[n:] = False
    bits[:, n:] = False
    return elle_kernel.pack(bits)


def tile_plane(n_pad, dens, gen, dev):
    """A packed plane whose 128-row tile t has density dens[t % len(dens)]
    (every column)."""
    from jepsen_tpu_torch.ops import elle_kernel
    tile = torch.arange(n_pad, device=dev) // elle_kernel.TILE
    d = torch.tensor(dens, device=dev)[tile % len(dens)]
    bits = torch.rand((n_pad, n_pad), generator=gen, device=dev) < d[:, None]
    return elle_kernel.pack(bits)


def exact_plane(n_pad, counts, gen, dev):
    """A packed plane whose 128-row tile t holds exactly counts[t] set bits
    at random places (tiles past the list none)."""
    from jepsen_tpu_torch.ops import elle_kernel
    tile = elle_kernel.TILE
    bits = torch.zeros((n_pad, n_pad), dtype=torch.bool, device=dev)
    for t, k in enumerate(counts):
        idx = torch.randperm(tile * n_pad, generator=gen, device=dev)[:k]
        bits[tile * t:tile * (t + 1)].view(-1)[idx] = True
    return elle_kernel.pack(bits)


def gather_max_bits(n_pad, nterms=1):
    """The most set bits a (job, row tile) of nterms terms may hold and
    still take the gather form (elle_kernel.GATHER_DENSITY)."""
    from jepsen_tpu_torch.ops import elle_kernel
    num, den = elle_kernel.GATHER_DENSITY
    return nterms * elle_kernel.TILE * n_pad * num // den


def elle_mixed_cases(n_pad, gen, dev):
    """[(name, a, b, x, forms)]: planes whose product(a, b) takes both
    forms in one launch.  "split": a's even row tiles half set, its odd
    ones almost empty (b the other way round, x at 1%), so the three
    jobs of a closure round take both forms too; "edge": a's tile 0 holds
    exactly gather_max_bits (gathered), tile 1 one bit more (dense), the
    rest none; "zero" and "one": the all-zero and all-one planes; "heavy":
    two full rows in an almost empty tile 0, a gathered tile whose rows
    are split among warps.  forms is the form row product(a, b) must take
    (1 dense, 0 gather)."""
    from jepsen_tpu_torch.ops import elle_kernel
    tiles = n_pad // elle_kernel.TILE
    cap = gather_max_bits(n_pad)
    zero = torch.zeros((n_pad, n_pad // 32), dtype=torch.int32, device=dev)
    one = torch.full_like(zero, -1)
    split = [1 - t % 2 for t in range(tiles)]
    full_rows = zero.clone()
    full_rows[[0, 5]] = -1
    edge = [0, 1] + [0] * (tiles - 2)
    return [
        ("split", tile_plane(n_pad, (0.5, 1e-4), gen, dev),
         tile_plane(n_pad, (1e-4, 0.5), gen, dev),
         tile_plane(n_pad, (0.01,), gen, dev), split),
        ("edge", exact_plane(n_pad, (cap, cap + 1), gen, dev),
         random_packed(n_pad, n_pad, 0.05, gen, dev),
         random_packed(n_pad, n_pad, 0.01, gen, dev), edge),
        ("zero", zero, zero, zero, [0] * tiles),
        ("one", one, one, zero, [1] * tiles),
        ("heavy", tile_plane(n_pad, (1e-4,), gen, dev) | full_rows,
         random_packed(n_pad, n_pad, 0.05, gen, dev),
         random_packed(n_pad, n_pad, 0.01, gen, dev), [0] * tiles)]


def nz_rows(a):
    return int((a != 0).any(1).sum())


def bits_set(a):
    from jepsen_tpu_torch.ops import elle_kernel
    return int(elle_kernel.unpack(a).sum())


def pmm_bound(jobs_a, planes, n_pad, clock_hz):
    """(ms, by) of boolean products whose left operands are jobs_a, over
    `planes` packed planes read or written once: the products' work is
    the cheaper of the dense form (2 r n_pad^2 int8 operations a
    product, r its left operand's nonzero rows, over 1,979 TOP/s) and
    the sparse form (one word OR for each set bit of the left operand
    and word of a row, over every INT32 lane), and the bound is the
    larger of that and the packed bytes over 3.35 TB/s."""
    w = n_pad // 32
    dense = sum(2.0 * nz_rows(a) * n_pad * n_pad for a in jobs_a)
    sparse = sum(float(bits_set(a)) * w for a in jobs_a)
    t_dense = dense / INT8_OPS_PER_S
    t_sparse = sparse / (N_SM * 64 * clock_hz)
    t_ops = min(t_dense, t_sparse)
    t_bytes = planes * n_pad * n_pad / 8 / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            {"int8_ms": t_dense * 1e3, "word_or_ms": t_sparse * 1e3,
             "bytes_ms": t_bytes * 1e3})


def library_round(cww, p0, p1):
    """The round through the library's product: the operands unpacked to
    bf16 once (untimed), then a closure that multiplies them with
    torch.matmul and thresholds (timed)."""
    from jepsen_tpu_torch.ops import elle_kernel
    d = [elle_kernel.unpack(x).to(torch.bfloat16) for x in (cww, p0, p1)]
    q = (d[1] + d[2]).clamp(max=1)

    def run():
        return ((torch.matmul(d[0], d[0]) > 0.5),
                (torch.matmul(d[1], d[1]) > 0.5),
                (torch.matmul(q, d[2]) > 0.5) | (torch.matmul(d[2], q) > 0.5))
    return run


def round_err(got, want):
    """Largest disagreement between two rounds' outputs: 1 if any bit or
    the change flag differs, else 0."""
    same = all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
    return 0 if same and bool(got[3]) == bool(want[3]) else 1


def elle_case_err(a, b, x):
    """1 if product(a, b), product(a, b, x), closure_round(a, b, x) or
    the tile counts of their launches differ from the plain versions', or
    if a launch's forms differ from the rule on its counts; else 0."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    n_pad = a.shape[0]
    e = int(not torch.equal(ek.product(a, b), ek.product_plain(a, b)))
    e |= int(not launch_forms_ok([[(a, None)]], n_pad))
    e |= int(not torch.equal(ek.product(a, b, x), ek.product_plain(a, b, x)))
    e |= round_err(ek.closure_round(a, b, x), ek.closure_round_plain(a, b, x))
    e |= int(not launch_forms_ok(round_terms(a, b, x), n_pad))
    return e


def round_terms(cww, p0, p1):
    """A closure round's left operands (a0, a1), a list a job."""
    return [[(cww, None)], [(p0, None)], [(p0, p1), (p1, None)]]


def launch_operands(terms):
    """The distinct left operands of jobs' terms (a list a job) in the
    wrapper's order, and each job's operand indices."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    ops, flat, _ = ek._operands([(None, None, [(a0, a1, None, None)
                                              for a0, a1 in job])
                                 for job in terms])
    it = iter(flat)
    return ops, [[next(it) for _ in job] for job in terms]


def launch_forms_ok(terms, n_pad):
    """The last launch's tile counts equal tile_bits_plain's, and its forms
    the rule's on them."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    operands, term_ops = launch_operands(terms)
    bits = ek.tile_bits_plain(operands)
    last = ek.LAST_LAUNCH
    return (torch.equal(last["tile_bits"], bits)
            and torch.equal(last["forms"],
                            ek.forms_plain(bits, term_ops, n_pad)))


def forms_of_last():
    """[(dense, gather)] row tiles of each job of the last launch."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    f = ek.LAST_LAUNCH["forms"]
    return [(int(r.sum()), int(r.numel() - r.sum())) for r in f]


def phase_elle_kernel(kernels, stacks, clock_hz):
    """elle_pmm and elle_tile_bits against their plain versions on the
    card, bit for bit, the change flag and each launch's forms included:
    random packed operands at ELLE_KERNEL_NPADS and densities 1/n to 0.5,
    the mixed cases at ELLE_MIXED_NPADS (one product and one round each),
    and every round of the bench's 10,000-txn closure; then every round of
    that closure timed beside the plain version, the library's product and
    the bound, the crossover measured again, and the tile count timed.
    Records each launch's forms (elle_kernel.RECORD) while it runs."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    t0 = time.perf_counter()
    ek.RECORD = True
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1717)
    err, cases = 0, 0
    for n_pad in ELLE_KERNEL_NPADS:
        n = n_pad - 100 if n_pad > 128 else n_pad
        for dens in (1.0 / n, 4.0 / n, 0.05, 0.5):
            a, b, x = (random_packed(n_pad, n, dens, gen, dev)
                       for _ in range(3))
            e = elle_case_err(a, b, x)
            torch.cuda.synchronize()
            err, cases = max(err, e), cases + 2
            if e:
                log(f"[elle-kernel] MISMATCH n_pad={n_pad} density={dens}")
    log(f"[elle-kernel] {cases} random cases (n_pad {ELLE_KERNEL_NPADS}, "
        f"densities 1/n, 4/n, 0.05, 0.5; a product and a round each, tile "
        f"counts and forms): {'equal bit for bit' if not err else 'DIFFER'}")
    for n_pad in ELLE_MIXED_NPADS:
        for name, a, b, x, want in elle_mixed_cases(n_pad, gen, dev):
            ek.product(a, b)
            got = ek.LAST_LAUNCH["forms"][0].tolist()
            e = elle_case_err(a, b, x) | int(got != want)
            rnd = forms_of_last()
            torch.cuda.synchronize()
            err = max(err, e)
            log(f"[elle-kernel] mixed {name} n_pad {n_pad}: product's row "
                f"tiles dense {sum(got)} / gather {len(got) - sum(got)}"
                f"{'' if got == want else ' - NOT THE RULE'}; the round's "
                f"(dense, gather) a job {rnd}: "
                f"{'equal bit for bit' if not e else 'DIFFER'}")
    n, group = stacks[-1]
    *_, cww, p0, p1 = elle_triple(group[0], dev)
    n_pad = cww.shape[0]
    steps = max(1, math.ceil(math.log2(max(n_pad - 1, 2))))
    triples, rounds, done = [], 0, False
    while not done and rounds < steps:
        triples.append((cww, p0, p1))
        got = ek.closure_round(cww, p0, p1)
        e = round_err(got, ek.closure_round_plain(cww, p0, p1))
        e |= int(not launch_forms_ok(round_terms(cww, p0, p1), n_pad))
        err = max(err, e)
        if e:
            log(f"[elle-kernel] MISMATCH bench round {rounds + 1}")
        cww, p0, p1 = got[:3]
        done = not bool(got[3])
        rounds += 1
    log(f"[elle-kernel] bench n={n} (n_pad {n_pad}): {rounds} rounds of "
        f"{steps}, each equal to the plain version's, tile counts and "
        f"forms included{'' if not err else ' - DIFFER'}")
    if err:
        raise SystemExit("[elle-kernel] elle_pmm disagrees with its plain "
                         "version")
    out = {"err": err, "rounds": []}
    for r, (c, a, b) in enumerate(triples):
        q = a | b
        bound, by, parts = pmm_bound([c, a, q, b], 6, n_pad, clock_hz)
        ms = launch_ms(lambda: ek.closure_round(c, a, b), 5)
        dms = device_ms(lambda: ek.closure_round(c, a, b), 5)
        forms = forms_of_last()
        plain = device_ms(lambda: ek.closure_round_plain(c, a, b), 2)
        lib = device_ms(library_round(c, a, b), 3)
        density = [round(float(ek.unpack(x).float().mean()), 6)
                   for x in (c, a, b)]
        log(f"[elle-kernel] bench round {r + 1} (n_pad {n_pad}, densities "
            f"cww/p0/p1 {density}; row tiles (dense, gather) a job "
            f"{forms}): {ms:.4f} ms launch to end, {dms:.4f} ms on the "
            f"device; plain {plain:.3f} ms; library (4 torch.matmul of bf16 "
            f"operands, thresholded) {lib:.3f} ms; bound {bound:.4f} ms "
            f"({by}; int8 form {parts['int8_ms']:.4f}, word-OR form "
            f"{parts['word_or_ms']:.4f}, bytes {parts['bytes_ms']:.4f} ms), "
            f"reached {100 * bound / dms:.2f}% on the device")
        out["rounds"].append({"ms": ms, "device_ms": dms, "plain_ms": plain,
                              "library_ms": lib, "bound_ms": bound,
                              "bound_by": by, "forms": forms,
                              "densities": density})
    out["first"], out["last"] = out["rounds"][0], out["rounds"][-1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    c, a, b = triples[0]
    rounds_again, done = 0, False
    while not done and rounds_again < steps:    # as elle_mesh.closure
        c, a, b, changed = ek.closure_round(c, a, b)
        done = not bool(changed)
        rounds_again += 1
    wall = time.perf_counter() - t
    tot = {k: sum(r[k] for r in out["rounds"])
           for k in ("ms", "device_ms", "plain_ms", "library_ms",
                     "bound_ms")}
    out["closure"] = dict(tot, wall_s=wall, rounds=rounds_again)
    log(f"[elle-kernel] the closure's {rounds} rounds: kernels "
        f"{tot['device_ms']:.4f} ms on the device, {tot['ms']:.4f} ms launch "
        f"to end (summed); the rounds as elle_mesh.closure runs them (a "
        f"change flag read each) {wall:.4f} s on the host clock "
        f"({rounds_again} rounds); bounds "
        f"{tot['bound_ms']:.4f} ms; plain {tot['plain_ms']:.1f} ms; library "
        f"{tot['library_ms']:.3f} ms")
    out["crossover"] = elle_crossover(gen, dev)
    out["tile_bits"] = elle_tile_bits_timing(triples[-1], n_pad)
    for name, v in kernels.items():
        if name.startswith(("elle_pmm", "elle_tile_bits")):
            dyn = (ek.dynamic_smem(n_pad) if name.startswith("elle_pmm")
                   else 0)
            log(f"[elle-kernel] {name}: {v['regs']} registers, spill "
                f"{v['spill']} bytes, {v['smem']} bytes of static shared "
                f"memory, {dyn} bytes of dynamic shared memory at n_pad "
                f"{n_pad}")
    ek.RECORD = False
    log(f"[elle-kernel] phase {time.perf_counter() - t0:.1f} s")
    return out


def elle_crossover(gen, dev):
    """The forms' crossover measured on the card at n_pad 10,112: a round
    of half-set random planes (every tile dense) over its term-tiles, and
    rounds of sparse ones (every tile gathered) fitted to a time a set
    bit; the density where a gathered tile costs a dense one."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    n_pad = ELLE_KERNEL_NPADS[-1]
    tiles = n_pad // ek.TILE
    planes = [random_packed(n_pad, n_pad, 0.45, gen, dev) for _ in range(3)]
    dms = device_ms(lambda: ek.closure_round(*planes), 5)
    dense = forms_of_last()
    term_tiles = sum(d * t for (d, _), t in zip(dense, (1, 1, 2)))
    per_tile = dms / term_tiles
    pts = []
    for d in ELLE_CROSS_DENSITIES:
        c, a, b = (random_packed(n_pad, n_pad, d, gen, dev) for _ in range(3))
        bits = int(ek.tile_bits_plain(
            launch_operands(round_terms(c, a, b))[0])[..., 0].sum())
        pts.append((bits, device_ms(lambda: ek.closure_round(c, a, b), 5),
                    forms_of_last()))
    x = np.array([p[0] for p in pts], float)
    y = np.array([p[1] for p in pts], float)
    per_bit = float(np.polyfit(x, y, 1)[0])
    density = per_tile / per_bit / (ek.TILE * n_pad)
    num, den = ek.GATHER_DENSITY
    log(f"[elle-kernel] crossover at n_pad {n_pad}: a dense round "
        f"{dms:.4f} ms over {term_tiles} term-tiles ({dense}) = "
        f"{1e3 * per_tile:.3f} us a term-tile; gathered rounds "
        + ", ".join(f"{b} bits {t:.4f} ms {f}" for b, t, f in pts)
        + f": {1e6 * per_bit:.4f} ns a set bit; crossover density "
        f"{100 * density:.2f}% (the source's {num}/{den} = "
        f"{100 * num / den:.2f}%)")
    return {"us_per_term_tile": 1e3 * per_tile, "ns_per_bit": 1e6 * per_bit,
            "density": density}


def elle_tile_bits_timing(triple, n_pad):
    """elle_tile_bits as a round launches it (the counts of its four left
    operands, q = p0 | p1 read as two planes, and the transposes of its
    three right planes) against its plain version, timed both ways beside
    it and its bound (each distinct plane read once, each transpose and the
    counts written once, over 3.35 TB/s; the kernel's re-reads of p0 and
    p1, as operands and as the planes it transposes, are its own cost)."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    ops = launch_operands(round_terms(*triple))[0]
    planes = list(triple)
    counts, tposes = ek.prepare(ops, planes)
    want = ek.tile_bits_plain(ops)
    err = int(not torch.equal(counts, want)
              or not all(torch.equal(t, ek.tpose_plain(p))
                         for t, p in zip(tposes, planes)))
    ms = launch_ms(lambda: ek.prepare(ops, planes), 5)
    dms = device_ms(lambda: ek.prepare(ops, planes), 5)
    plain = device_ms(lambda: (ek.tile_bits_plain(ops),
                               [ek.tpose_plain(p) for p in planes]), 2)
    read = {t.data_ptr() for a0, a1 in ops for t in (a0, a1)
            if t is not None} | {p.data_ptr() for p in planes}
    nbytes = (len(read) + len(planes)) * n_pad * n_pad / 8 \
        + counts.numel() * 4
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f"[elle-kernel] elle_tile_bits as a round launches it ({len(ops)} "
        f"operands counted, {len(planes)} planes transposed): {ms:.4f} ms "
        f"launch to end, {dms:.4f} ms on the device; plain {plain:.3f} ms; "
        f"bound {bound:.4f} ms (bytes), reached {100 * bound / dms:.2f}% on "
        f"the device{'' if not err else ' - DIFFER'}")
    if err:
        raise SystemExit("[elle-kernel] elle_tile_bits disagrees with its "
                         "plain version")
    return {"err": err, "ms": ms, "device_ms": dms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def phase_elle_main(stacks):
    """The JAX package's Elle bench rows through both tiers on the card:
    8 histories of 1,000 txns and 1 of 10,000, a planted G-single in the
    even ones; the anomalies exactly {G-single} or {}, equal defining
    edges on both tiers, the 1,000-txn rows equal to the numpy oracle.
    Returns the Elle kernels' launches."""
    from jepsen_tpu_torch.ops import elle_graph, elle_kernel, elle_mesh
    t0 = time.perf_counter()
    elle_graph.classify_batch([elle_stack(100, 1, True)])   # cuBLAS warm-up
    for k in elle_kernel.LAUNCHES:
        elle_kernel.LAUNCHES[k] = 0
    bad = []
    sq = elle_graph._sq
    for n, group in stacks:
        walls, peaks, rows = {}, {}, {}
        splits = {}
        products = [0, 0.0]           # the dense tier's bf16 products, ops

        def counted(a, b):
            products[0] += 1
            products[1] += 2.0 * a[..., 0, 0].numel() * a.shape[-2] * \
                a.shape[-1] * b.shape[-1]
            return sq(a, b)
        for tier, fn in (("dense", elle_graph.classify_batch),
                         ("packed", elle_mesh.classify_mesh)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            splits[tier] = {}
            elle_graph._sq = counted if tier == "dense" else sq
            t = time.perf_counter()
            try:
                rows[tier] = fn(group, stats=splits[tier])
                torch.cuda.synchronize()
            finally:
                elle_graph._sq = sq
            walls[tier] = time.perf_counter() - t
            peaks[tier] = torch.cuda.max_memory_allocated() - base
        for i, (d, p) in enumerate(zip(rows["dense"], rows["packed"])):
            want = {"G-single"} if i % 2 == 0 else set()
            if set(d["anomalies"]) != want or d["anomalies"] != \
                    p["anomalies"]:
                bad.append((n, i, d["anomalies"], p["anomalies"]))
        host_s = None
        if n <= 1000:
            t = time.perf_counter()
            for i, s in enumerate(group):
                h = elle_graph.classify_host(s)
                if h["anomalies"] != rows["dense"][i]["anomalies"]:
                    bad.append((n, i, "host", h["anomalies"]))
            host_s = (time.perf_counter() - t) / len(group)
        log(f"[elle-main] n={n} x {len(group)}: dense "
            f"{walls['dense'] / len(group):.4f} s a history (peak "
            f"{peaks['dense'] / 2**20:.1f} MiB), packed "
            f"{walls['packed'] / len(group):.4f} s a history (peak "
            f"{peaks['packed'] / 2**20:.1f} MiB, rounds "
            f"{[r['rounds'] for r in rows['packed']]}); numpy oracle "
            f"{'not run' if host_s is None else f'{host_s:.3f} s a history'}"
            f"; anomalies {[sorted(r['anomalies']) for r in rows['packed']]}"
            f"; stage seconds: dense {elle_stages(splits['dense'])}, packed "
            f"{elle_stages(splits['packed'])}; the dense tier's "
            f"{products[0]} bf16 products ({products[1]:.4g} operations; "
            f"bound {1e3 * products[1] / BF16_FLOPS_PER_S:.4f} ms at 989 "
            f"TFLOP/s, {1e3 * products[1] / BF16_FLOPS_PER_S / len(group):.4f}"
            f" ms a history)")
    launches = dict(elle_kernel.LAUNCHES)
    log(f"[elle-main] launches {launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if bad or not all(launches.values()):
        raise SystemExit(f"[elle-main] misclassified {bad[:4]}, or an Elle "
                         f"kernel was not launched ({launches})")
    return launches


def elle_stages(st):
    return ", ".join(f"{k} {v:.4f}" for k, v in st.items())


def witness_ok(v, inf):
    """Every cycle witness of verdict v is a cycle of inf's planes, each
    hop on the plane its label names."""
    for cls in ("G0", "G1c", "G-single", "G2-item"):
        for w in v["anomalies"].get(cls, ()):
            steps, labels = w.get("steps"), w.get("edges")
            if (not steps or steps[0] != steps[-1] or len(steps) < 3
                    or len(labels) != len(steps) - 1):
                return False
            if not all(inf.planes[e][x, y]
                       for e, x, y in zip(labels, steps, steps[1:])):
                return False
    return True


def phase_elle_check():
    """Elle().check on simulated list-append histories at 1,000 txns (the
    dense tier) and 10,000 (the packed tier): clean and each planted
    block, verdict, anomaly-types, not, weakest-violated and every
    witness a real cycle; then independent.batch_checker(Elle()) over
    ELLE_KEYS keys.  Returns the Elle kernels' launches over the checks."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.elle import Elle
    from jepsen_tpu_torch.elle import infer
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.ops import elle_kernel
    t0 = time.perf_counter()
    for k in elle_kernel.LAUNCHES:
        elle_kernel.LAUNCHES[k] = 0
    bad = []
    for n in ELLE_CHECK_SIZES:
        for plant in (None,) + ELLE_PLANTS:
            h = History(list_append_history(n, 9000 + n, plant=plant))
            t = time.perf_counter()
            v = Elle().check(None, h)
            wall = time.perf_counter() - t
            got = (v["valid?"], v["anomaly-types"], v["weakest-violated"],
                   v["not"])
            engine = "elle-mesh" if n >= ELLE_MESH_AT else "elle-device"
            ok = got == ELLE_EXPECT[plant] and v["engine"] == engine
            if ok and plant in ("G1c", "G-single", "G2-item"):
                ok = witness_ok(v, infer.infer(h))
            log(f"[elle-check] n={n} {plant or 'clean'}: {got[0]} "
                f"{got[1]} weakest {got[2]}, engine {v['engine']}, rounds "
                f"{v.get('rounds')}; wall {wall:.3f} s; stages "
                f"{elle_stages(v['stages'])}{'' if ok else ' - WRONG'}")
            if not ok:
                bad.append((n, plant))
    launches = dict(elle_kernel.LAUNCHES)
    h = History(keyed_list_append(ELLE_KEYS, ELLE_KEY_TXNS, ELLE_KEY_PLANTS,
                                  7000))
    t = time.perf_counter()
    out = independent.batch_checker(Elle()).check(None, h)
    wall = time.perf_counter() - t
    planted = sorted(ELLE_KEY_PLANTS, key=repr)   # the keys in repr order
    if (out["valid?"] is not False or out["failures"] != planted
            or any(out["results"][k]["anomaly-types"] != ["G-single"]
                   for k in planted)
            or len(out["results"]) != ELLE_KEYS):
        bad.append(("batch_checker", out["failures"]))
    log(f"[elle-check] batch_checker(Elle()) over {ELLE_KEYS} keys of "
        f"{ELLE_KEY_TXNS} txns ({len(h)} ops): failures {out['failures']} "
        f"in {wall:.3f} s; launches over the checks {launches}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    if bad or not all(launches.values()):
        raise SystemExit(f"[elle-check] wrong verdicts {bad}, or an Elle "
                         f"kernel was not launched ({launches})")
    return launches


# ---------------------------------------------------------------------------
# The commutative checkers (ops/fold.py, kernel fold_member) and the txn
# cycle checker (ops/cycle.py: elle_pmm's closure, kernel cycle_labels):
# the JAX package's bench configs 5 and 4 (bench.py:1387-1416)
# ---------------------------------------------------------------------------

FOLD_N = 1_000_000                  # bench.py:1406-1416: elements of the
FOLD_LOST_EVERY = 97                # set fold, every 97th lost
FOLD_CRASH_EVERY = 101              # [fold]'s Set history: adds left :info
FOLD_UNEXPECTED = 1000              # read elements no add attempted
FOLD_DUP_EVERY = 1999               # [fold]'s UniqueIds: a repeated ack
CYCLE_N, CYCLE_SEED, CYCLE_RING = 2048, 11, 100     # bench.py:1387-1399
CYCLE_CHECK_SIZES = (1000, 10_000)  # txns of [cycle]'s checked histories
CYCLE_CPU_AT_MOST = 1000            # also checked with device="cpu"
CYCLE_PLANTS = ("G0", "G1c", "G-single", "G2", "G1a")
#: anomaly-types of a clean history and of each planted block. The
#: checker's version order is the commit order of the writes, so no
#: cycle of ww edges alone can exist: a planted G0 block (the JAX
#: package's tests/test_cycle.py::test_g0_write_cycle) is valid.
CYCLE_EXPECT = {None: [], "G0": [], "G1c": ["G1c"],
                "G-single": ["G-single"], "G2": ["G2"], "G1a": ["G1a"]}
CYCLE_KERNEL_NS = (100, 300, 1000, 2048)    # random graphs of [cycle]


def fold_bench():
    """(adds, final read) of the bench's set fold: 0..FOLD_N - 1, every
    FOLD_LOST_EVERY-th missing from the read."""
    adds = np.arange(FOLD_N, dtype=np.int64)
    return adds, adds[adds % FOLD_LOST_EVERY != 0]


def set_history(n):
    """A set workload of n adds (process value % 10): each add invoked,
    then ok'd, or left :info where its value is a multiple of
    FOLD_CRASH_EVERY; then one read of every value that is not a multiple
    of FOLD_LOST_EVERY and of FOLD_UNEXPECTED values no add attempted.
    The History and its expected (lost, unexpected, recovered) counts."""
    from jepsen_tpu_torch.history import History, Op
    v = np.arange(n)
    ok = v % FOLD_CRASH_EVERY != 0
    read = v % FOLD_LOST_EVERY != 0
    ops = []
    for x, done in zip(v.tolist(), ok.tolist()):
        ops.append(Op(process=x % 10, type="invoke", f="add", value=x))
        ops.append(Op(process=x % 10, type="ok" if done else "info",
                      f="add", value=x))
    final = v[read].tolist() + list(range(n, n + FOLD_UNEXPECTED))
    ops += [Op(process=10, type="invoke", f="read", value=None),
            Op(process=10, type="ok", f="read", value=final)]
    want = (int((ok & ~read).sum()), FOLD_UNEXPECTED, int((~ok & read).sum()))
    return History(ops).index(), want


def ids_history(n):
    """n generate calls whose acks are distinct, negative and positive,
    but for every FOLD_DUP_EVERY-th, which repeats the ack before it; the
    History and its expected duplicated-count."""
    from jepsen_tpu_torch.history import History, Op
    ids = np.arange(n, dtype=np.int64) * 7 - 3 * n
    dup = np.arange(FOLD_DUP_EVERY, n, FOLD_DUP_EVERY)
    ids[dup] = ids[dup - 1]
    ops = []
    for i, x in enumerate(ids.tolist()):
        ops.append(Op(process=i % 10, type="invoke", f="generate",
                      value=None))
        ops.append(Op(process=i % 10, type="ok", f="generate", value=x))
    return History(ops).index(), len(dup)


def fold_kernel_cases(seed):
    """[(name, kind, arrays)]: fold_member's three modes at the bench's
    size and at their edges: int32 and int64 values (past int32 and
    negative), duplicates, an empty ys, an empty xs and both empty."""
    rng = np.random.default_rng(seed)
    big = rng.integers(-2 ** 62, 2 ** 62, 50_000)
    small = rng.integers(-3000, 3000, 40_000)
    adds, final = fold_bench()
    return [
        ("bench", "set", (adds, adds, final)),
        ("set-int32", "set", (small[:20_000], small[10_000:25_000],
                              small[5_000:30_000])),
        ("set-int64", "set", (big[:30_000], big[10_000:40_000],
                              np.concatenate([big[20_000:],
                                              big[:100] + 1]))),
        ("set-no-attempts", "set", (big[:0], big[:0], big[:500])),
        ("set-no-read", "set", (small[:800], small[:500], small[:0])),
        ("set-empty", "set", (small[:0], small[:0], small[:0])),
        ("dups-int32", "dups", (small,)),
        ("dups-int64", "dups", (np.concatenate([big, big[::7]]),)),
        ("dups-bench", "dups", (np.concatenate(
            [adds, adds[::FOLD_DUP_EVERY]]),)),
        ("dups-empty", "dups", (small[:0],)),
        ("minus-int32", "minus", (small, small[::3])),
        ("minus-int64", "minus", (np.concatenate([big[:1000]] * 3),
                                  big[:1500])),
        ("minus-no-ys", "minus", (small[:900], small[:0])),
        ("minus-empty", "minus", (small[:0], small[:10])),
    ]


def fold_calls(kind, arrays, dev):
    """(kernel call, plain call, inputs, output bytes) of fold_member's
    wrapper on one case, the inputs prepared as ops.fold prepares them:
    narrowed together, on dev, ys sorted (xs sorted stably for minus)."""
    from jepsen_tpu_torch.ops import fold
    ts = fold._to(fold._narrow(*[fold._i64(a) for a in arrays]), dev)
    if kind == "set":
        att, add, read = ts
        args = (read, add, torch.sort(att).values, torch.sort(read).values,
                torch.sort(add).values)
        fns = fold.set_member, fold.set_member_plain
        out_bytes = 3 * len(read) + len(add)
    elif kind == "dups":
        (x,) = ts
        args = (x, torch.sort(x).values)
        fns = fold.dup_member, fold.dup_member_plain
        out_bytes = 9 * len(x)
    else:
        x, y = ts
        s, order = torch.sort(x, stable=True)
        args = (s, torch.sort(y).values, order)
        fns = fold.minus_member, fold.minus_member_plain
        out_bytes = len(x)
    return (lambda: fns[0](*args)), (lambda: fns[1](*args)), args, out_bytes


def outputs_err(got, want):
    """0 where two tuples of tensors (or two tensors) are equal bit for
    bit, dtypes included, else 1."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return int(len(got) != len(want) or not all(
        g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())
        for g, w in zip(got, want)))


def searches_library(kind, args):
    """torch.searchsorted for each search a case's function needs, on the
    same sorted ys: the library's share of fold_member's work."""
    if kind == "set":
        read, add, att_s, read_s, add_s = args
        return lambda: (torch.searchsorted(att_s, read),
                        torch.searchsorted(read_s, add),
                        torch.searchsorted(add_s, read))
    if kind == "dups":
        x, xs_s = args
        return lambda: (torch.searchsorted(xs_s, x),
                        torch.searchsorted(xs_s, x, side="right"))
    s, ys_s, _ = args
    return lambda: (torch.searchsorted(s, s), torch.searchsorted(ys_s, s),
                    torch.searchsorted(ys_s, s, side="right"))


def fold_timing(kind, arrays, dev):
    """fold_member on one case timed both ways beside its plain version,
    torch.searchsorted's searches and its bound (the inputs read once and
    the outputs written once over HBM_BYTES_PER_S)."""
    kern, plain, args, out_bytes = fold_calls(kind, arrays, dev)
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    return {"ms": launch_ms(kern, 5), "device_ms": device_ms(kern, 20),
            "plain_ms": device_ms(plain, 3),
            "library_ms": device_ms(searches_library(kind, args), 5),
            "bound_ms": 1e3 * (in_bytes + out_bytes) / HBM_BYTES_PER_S,
            "bound_by": "bytes", "bytes": in_bytes + out_bytes,
            "dtype": str(args[0].dtype).replace("torch.", "")}


def timing_line(t):
    return (f"{t['ms']:.4f} ms launch to end, {t['device_ms']:.4f} ms on "
            f"the device; plain {t['plain_ms']:.4f} ms; library "
            + ("none" if t.get("library_ms") is None
               else f"{t['library_ms']:.4f} ms")
            + f"; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), reached "
            f"{100 * t['bound_ms'] / t['device_ms']:.2f}% on the device")


def timing_wrap(mod, name, acc):
    """Wraps mod.name so that each call adds its host seconds to
    acc[name]; returns the function that puts the original back."""
    f = getattr(mod, name)

    def wrapped(*a, **k):
        t = time.perf_counter()
        try:
            return f(*a, **k)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t
    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, f)


def phase_fold():
    """The JAX package's config 5 at the bench's size: set_masks on
    FOLD_N adds with every FOLD_LOST_EVERY-th lost (10,310 lost); then
    Set().check on a FOLD_N-add set history with lost, unexpected and
    recovered elements, and UniqueIds().check on FOLD_N acks with
    repeated ones; each held against the same call with device="cpu" and
    the planted counts, and fold_member's launches over them counted.
    Then fold_member against its plain version bit for bit on
    fold_kernel_cases, and timed on the bench's set fold."""
    from jepsen_tpu_torch.checker import Set, UniqueIds
    from jepsen_tpu_torch.ops import fold
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    adds, final = fold_bench()
    hist, want = set_history(FOLD_N)
    ids, n_dups = ids_history(FOLD_N)
    made_s = time.perf_counter() - t0
    fold.set_masks(adds[:100], adds[:100], final[:100])     # warm-up
    fold.LAUNCHES["fold_member"] = 0
    t = time.perf_counter()
    masks = fold.set_masks(adds, adds, final)
    bench_s = time.perf_counter() - t
    acc: dict = {}
    restore = [timing_wrap(fold, "set_masks", acc),
               timing_wrap(fold, "duplicate_counts", acc)]
    try:
        t = time.perf_counter()
        got_set = Set().check(None, hist)
        set_s = time.perf_counter() - t
        t = time.perf_counter()
        got_ids = UniqueIds().check(None, ids)
        ids_s = time.perf_counter() - t
    finally:
        for r in restore:
            r()
    launches = fold.LAUNCHES["fold_member"]
    bad = []
    n_lost = int(masks[2].sum())
    if n_lost != (FOLD_N - 1) // FOLD_LOST_EVERY + 1:
        bad.append(("bench lost", n_lost))
    cpu = fold.set_masks(adds, adds, final, device="cpu")
    if not all(np.array_equal(a, b) for a, b in zip(masks, cpu)):
        bad.append("set_masks differs from the CPU's")
    counts = (got_set.get("lost-count"), got_set.get("unexpected-count"),
              got_set.get("recovered-count"))
    if ("error" in got_set or got_set["valid?"] is not False
            or counts != want
            or got_set != Set(device="cpu").check(None, hist)):
        bad.append(("Set", counts, want, got_set.get("error")))
    if ("error" in got_ids or got_ids["valid?"] is not False
            or got_ids["duplicated-count"] != n_dups
            or got_ids != UniqueIds(device="cpu").check(None, ids)):
        bad.append(("UniqueIds", got_ids.get("duplicated-count"), n_dups,
                    got_ids.get("error")))
    log(f"[fold] set_masks on the bench's {FOLD_N} adds: {n_lost} lost in "
        f"{bench_s:.4f} s; Set().check ({len(hist)} ops; lost, unexpected, "
        f"recovered {counts}) {set_s:.3f} s, of it set_masks "
        f"{acc.get('set_masks', 0):.4f} s and the host loop "
        f"{set_s - acc.get('set_masks', 0):.3f} s; UniqueIds().check "
        f"({len(ids)} ops, {got_ids['duplicated-count']} duplicated) "
        f"{ids_s:.3f} s, of it duplicate_counts "
        f"{acc.get('duplicate_counts', 0):.4f} s; fold_member launches "
        f"{launches}; histories made in {made_s:.1f} s"
        + ("" if not bad else f" - WRONG {bad}"))
    err = 0
    for name, kind, arrays in fold_kernel_cases(2020):
        kern, plain, args, _ = fold_calls(kind, arrays, dev)
        e = outputs_err(kern(), plain())
        torch.cuda.synchronize()
        err |= e
        if e:
            log(f"[fold] MISMATCH {name}")
    log(f"[fold] fold_member against its plain version on "
        f"{len(fold_kernel_cases(2020))} cases (set, dups, minus; int32 and "
        f"int64, empty ys and xs): "
        f"{'equal bit for bit' if not err else 'DIFFER'}")
    timing = {}
    for name, kind, arrays in (("set", "set", (adds, adds, final)),
                               ("dups", "dups", (np.concatenate(
                                   [adds, adds[::FOLD_DUP_EVERY]]),)),
                               ("minus", "minus", (adds, final))):
        timing[name] = fold_timing(kind, arrays, dev)
        log(f"[fold] fold_member {name} ({timing[name]['dtype']}, "
            f"{timing[name]['bytes']} bytes): {timing_line(timing[name])}")
    log(f"[fold] launches {launches}; phase {time.perf_counter() - t0:.1f} s")
    if bad or err or not launches:
        raise SystemExit(f"[fold] wrong results {bad}, fold_member differs "
                         f"from its plain version ({err}), or it was not "
                         f"launched ({launches})")
    return dict(timing["set"], launches=launches, err=err,
                dups=timing["dups"], minus=timing["minus"])


def bench_graph():
    """The bench's SCC input (bench.py:1387-1395): 6 n random edges over n
    = CYCLE_N nodes (random.Random(CYCLE_SEED)) and a CYCLE_RING-cycle on
    nodes 0..CYCLE_RING - 1."""
    rng = random.Random(CYCLE_SEED)
    adj = np.zeros((CYCLE_N, CYCLE_N), bool)
    for _ in range(6 * CYCLE_N):
        adj[rng.randrange(CYCLE_N), rng.randrange(CYCLE_N)] = True
    ring = np.arange(CYCLE_RING)
    adj[ring, (ring + 1) % CYCLE_RING] = True
    return adj


def cycle_kernel_cases(seed):
    """[(name, adj)]: the bench graph; random digraphs at CYCLE_KERNEL_NS
    nodes and mean degree 1 (many small components) or 3; a DAG; one
    ring through 1500 nodes (its closure takes 12 rounds); the empty and
    the complete graph; self-loops only."""
    rng = np.random.default_rng(seed)
    out = [("bench", bench_graph())]
    for n in CYCLE_KERNEL_NS:
        for deg in (1.0, 3.0):
            out.append((f"random-{n}-{deg:g}", rng.random((n, n)) < deg / n))
    out.append(("dag-500", np.triu(rng.random((500, 500)) < 0.01, 1)))
    ring = np.zeros((1500, 1500), bool)
    perm = rng.permutation(1500)
    ring[perm, np.roll(perm, 1)] = True
    out.append(("ring-1500", ring))
    out.append(("empty-200", np.zeros((200, 200), bool)))
    out.append(("complete-130", np.ones((130, 130), bool)))
    out.append(("self-loops-64", np.eye(64, dtype=bool)))
    return out


def dsg_adj(history):
    """The dependency graph TxnCycleChecker().check hands to the SCC of a
    history: build_graph over its completed txns, no realtime edges."""
    from jepsen_tpu_torch.checker import cycle as txn_cycle
    return txn_cycle.build_graph(txn_cycle.completed_txns(history)).adj


def packed_plane(adj, dev):
    """A bool adjacency packed as ops/cycle.py packs it
    (elle_mesh.pack_planes), int32 words on dev."""
    from jepsen_tpu_torch.ops import elle_mesh
    return elle_mesh._to_device(elle_mesh.pack_planes(adj[None])[0], dev)


def labels_bytes(lab):
    """The bytes cycle_labels' function must move for these labels (int
    [n_pad], this run's): row i reads the words of both planes up to the
    one holding its label's bit where the label is below i, else the
    ceil(i / 32) words of the columns below i (label = min(i, j), so no
    column at or past i is needed); R+'s diagonal word where those words
    miss it; 8 bytes a row written."""
    lab = np.asarray(lab, np.int64)
    i = np.arange(len(lab))
    words = np.where(lab < i, (lab >> 5) + 1, (i + 31) >> 5)
    return int(4 * (2 * words.sum() + ((i >> 5) >= words).sum())
               + 8 * len(lab))


def labels_timing(r, t):
    """cycle_labels on the closure r and its transpose t, timed both ways
    beside its plain version; the bound is labels_bytes of its labels over
    the card's memory rate."""
    from jepsen_tpu_torch.ops import cycle
    nbytes = labels_bytes(cycle.labels(r, t)[0].cpu().numpy())
    return {"ms": launch_ms(lambda: cycle.labels(r, t), 5),
            "device_ms": device_ms(lambda: cycle.labels(r, t), 20),
            "plain_ms": device_ms(lambda: cycle.labels_plain(r, t), 3),
            "library_ms": None, "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}


def cycle_case_err(adj, dev):
    """0 where the closure on dev (every round's product, change flag and
    transpose: elle_kernel.square) and the labels (cycle.labels) equal
    their plain versions on the same tensors, bit for bit; else 1."""
    from jepsen_tpu_torch.ops import cycle, elle_kernel
    r = packed_plane(adj, dev)
    err = 0
    while True:
        got = elle_kernel.square(r)
        err |= outputs_err(got, elle_kernel.square_plain(r))
        if not bool(got[1]):
            break
        r = got[0]
    t = got[2]
    return err | outputs_err(cycle.labels(r, t), cycle.labels_plain(r, t))


def rw_register_history(n_txns, seed, plant=None, conc=ELLE_CONC):
    """Op dicts of an rw-register txn test against a serializable store:
    conc clients each run one txn at a time of ELLE_MIN_LEN..ELLE_MAX_LEN
    micro-ops over ELLE_KEY_COUNT active keys, a read with probability
    ELLE_READ_RATIO, else a write of the key's next value, the key
    retired after ELLE_WRITES_PER_KEY writes (`list_append_history`'s
    shape, with writes); the store applies a txn whole when it completes,
    so the history is serializable in completion order.  With `plant`,
    every open txn is completed halfway through and a planted block
    (`cycle_plant_block`) is emitted."""
    rng = random.Random(seed)
    state: dict = {}
    active = list(range(ELLE_KEY_COUNT))
    counters = {k: 0 for k in active}
    next_key = ELLE_KEY_COUNT
    ops: list = []
    inflight: dict = {}

    def emit(p, typ, value):
        ops.append({"index": len(ops), "process": p, "type": typ,
                    "f": "txn", "value": value, "time": len(ops)})

    def mop():
        nonlocal next_key
        k = rng.choice(active)
        if rng.random() < ELLE_READ_RATIO:
            return ["r", k, None]
        counters[k] += 1
        v = counters[k]
        if v >= ELLE_WRITES_PER_KEY:
            active[active.index(k)] = next_key
            counters[next_key] = 0
            next_key += 1
        return ["w", k, v]

    def complete(p):
        local, out = {}, []
        for f, k, v in inflight.pop(p):
            if f == "r":
                out.append(["r", k, local.get(k, state.get(k))])
            else:
                local[k] = v
                out.append(["w", k, v])
        state.update(local)
        emit(p, "ok", out)

    started = 0
    planted = plant is None
    while started < n_txns or inflight:
        if not planted and started >= n_txns // 2:
            for p in sorted(inflight):
                complete(p)
            cycle_plant_block(emit, plant)
            planted = True
        p = rng.randrange(conc)
        if p in inflight:
            complete(p)
        elif started < n_txns:
            txn = [mop() for _ in range(rng.randint(ELLE_MIN_LEN,
                                                    ELLE_MAX_LEN))]
            inflight[p] = txn
            emit(p, "invoke", [list(m) for m in txn])
            started += 1
    return ops


def cycle_plant_block(emit, kind):
    """One planted anomaly on two fresh keys, emitted while every client
    is idle: the histories of the JAX package's tests/test_cycle.py
    (:190-245)."""
    a, b = ELLE_PLANT_KEY, ELLE_PLANT_KEY + 1
    if kind == "G0":            # both write both: versioned by commit
        t0, t1 = [["w", a, 1], ["w", b, 1]], [["w", a, 2], ["w", b, 2]]
        emit(0, "invoke", t0)
        emit(1, "invoke", t1)
        emit(0, "ok", t0)
        emit(1, "ok", t1)
    elif kind == "G1c":         # each reads the other's write
        emit(0, "invoke", [["w", a, 1], ["r", b, None]])
        emit(1, "invoke", [["w", b, 1], ["r", a, None]])
        emit(0, "ok", [["w", a, 1], ["r", b, 1]])
        emit(1, "ok", [["w", b, 1], ["r", a, 1]])
    elif kind == "G-single":    # read skew: one write seen, one missed
        t0 = [["w", a, 1], ["w", b, 1]]
        emit(0, "invoke", t0)
        emit(0, "ok", t0)
        emit(1, "invoke", [["r", a, None], ["r", b, None]])
        emit(1, "ok", [["r", a, None], ["r", b, 1]])
    elif kind == "G2":          # write skew: each misses the other
        t0, t1 = [["r", b, None], ["w", a, 1]], [["r", a, None], ["w", b, 1]]
        emit(0, "invoke", t0)
        emit(1, "invoke", t1)
        emit(0, "ok", t0)
        emit(1, "ok", t1)
    elif kind == "G1a":         # a read of a value no txn wrote
        emit(0, "invoke", [["w", a, 1]])
        emit(0, "ok", [["w", a, 1]])
        emit(1, "invoke", [["r", a, None]])
        emit(1, "ok", [["r", a, 99]])
    else:
        raise ValueError(f"no planted block {kind!r}")


def closure_timing(adj, dev, clock_hz):
    """Each round of adj's closure (elle_kernel.square: elle_tile_bits and
    elle_pmm) timed both ways beside its plain version, the library's
    product (one torch.matmul of the bf16 plane, thresholded; the unpack
    untimed) and its bound (pmm_bound of one product over 3 planes: the
    plane read, the result and its transpose written), summed over the
    rounds."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    r = packed_plane(adj, dev)
    n_pad = r.shape[0]
    tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms",
                         "bound_ms", "ops_bound_ms"), 0.0)
    rounds = 0
    while True:
        x = r
        d = ek.unpack(x).to(torch.bfloat16)
        bound, by, parts = pmm_bound([x], 3, n_pad, clock_hz)
        tot["ms"] += launch_ms(lambda: ek.square(x), 3)
        tot["device_ms"] += device_ms(lambda: ek.square(x), 5)
        tot["plain_ms"] += device_ms(lambda: ek.square_plain(x), 2)
        tot["library_ms"] += device_ms(lambda: torch.matmul(d, d) > 0.5, 3)
        tot["bound_ms"] += bound
        tot["ops_bound_ms"] += min(parts["int8_ms"], parts["word_or_ms"])
        r, changed, _ = ek.square(x)
        rounds += 1
        if not bool(changed):
            break
    by = ("operations" if tot["ops_bound_ms"] * 2 >= tot["bound_ms"]
          else "bytes")
    return dict(tot, rounds=rounds, n_pad=n_pad, bound_by=by)


def phase_cycle(clock_hz):
    """The JAX package's config 4: scc on the bench's graph (the ring's
    nodes on a cycle and of one label; labels, diagonal and closure equal
    to device="cpu"'s), then TxnCycleChecker().check on simulated
    rw-register histories of CYCLE_CHECK_SIZES txns, clean and with each
    planted block (anomaly-types exactly CYCLE_EXPECT's; at most
    CYCLE_CPU_AT_MOST txns also equal to device="cpu"'s); the launches of
    elle_tile_bits, elle_pmm and cycle_labels over them counted.  Then
    each closure round and cycle_labels against their plain versions on
    cycle_kernel_cases and on the DSG of every check above
    CYCLE_CPU_AT_MOST txns, and cycle_labels timed on the bench graph's
    closure and the largest clean DSG's."""
    from jepsen_tpu_torch.checker import cycle as txn_cycle
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.ops import cycle, elle_kernel
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    adj = bench_graph()
    hists = {(n, plant): History(rw_register_history(n, 9500 + n, plant))
             for n in CYCLE_CHECK_SIZES for plant in (None,) + CYCLE_PLANTS}
    made_s = time.perf_counter() - t0
    cycle.scc(np.eye(3, dtype=bool))                         # warm-up
    for k in elle_kernel.LAUNCHES:
        elle_kernel.LAUNCHES[k] = 0
    cycle.LAUNCHES["cycle_labels"] = 0
    t = time.perf_counter()
    lab, diag, clo = cycle.scc(adj)
    scc_s = time.perf_counter() - t
    results, walls, parts = {}, {}, {}
    for key, h in hists.items():
        acc: dict = {}
        restore = [timing_wrap(cycle, "scc", acc),
                   timing_wrap(cycle, "cycles_by_component", acc)]
        try:
            t = time.perf_counter()
            results[key] = txn_cycle.TxnCycleChecker().check(None, h)
            walls[key] = time.perf_counter() - t
        finally:
            for r in reversed(restore):
                r()
        parts[key] = acc
    launches = dict(elle_kernel.LAUNCHES, **cycle.LAUNCHES)
    bad = []
    ring = slice(0, CYCLE_RING)
    if not diag[ring].all() or len(set(lab[ring].tolist())) != 1:
        bad.append("the ring's nodes are not one component on a cycle")
    want = cycle.scc(adj, device="cpu")
    if not all(np.array_equal(a, b) for a, b in zip((lab, diag, clo), want)):
        bad.append("scc differs from the CPU's")
    r, t_plane, rounds = cycle.closure_planes(adj, dev)
    log(f"[cycle] scc of the bench's {CYCLE_N}-node graph: {scc_s:.4f} s, "
        f"{rounds} closure rounds, {int(diag.sum())} nodes on cycles in "
        f"{len(set(lab[diag].tolist()))} components, the {CYCLE_RING}-ring "
        f"labelled {sorted(set(lab[ring].tolist()))}; histories made in "
        f"{made_s:.1f} s")
    for (n, plant), v in results.items():
        ok = ("error" not in v and v["anomaly-types"] == CYCLE_EXPECT[plant]
              and v["valid?"] is (not CYCLE_EXPECT[plant]))
        if ok and n <= CYCLE_CPU_AT_MOST:
            ok = v == txn_cycle.TxnCycleChecker(device="cpu").check(
                None, hists[(n, plant)])
        p = parts[(n, plant)]
        log(f"[cycle] TxnCycleChecker n={n} {plant or 'clean'}: "
            f"{v['valid?']} {v['anomaly-types']}, txns {v['txn-count']}, "
            f"cycles {v['cycle-count']}; wall {walls[(n, plant)]:.3f} s, "
            f"of it scc {p.get('scc', 0):.3f} s, the cycle walks "
            f"{p.get('cycles_by_component', 0) - p.get('scc', 0):.3f} s, "
            f"the host loops (pairing, G1a, G1b, the graph) "
            f"{walls[(n, plant)] - p.get('cycles_by_component', 0):.3f} s"
            + ("" if ok else " - WRONG"))
        if not ok:
            bad.append((n, plant))
    err = 0
    cases = cycle_kernel_cases(404)
    dsgs = {f"dsg-{n}-{plant or 'clean'}": dsg_adj(hists[(n, plant)])
            for (n, plant) in hists if n > CYCLE_CPU_AT_MOST}
    for name, a in cases + list(dsgs.items()):
        e = cycle_case_err(a, dev)
        torch.cuda.synchronize()
        err |= e
        if e:
            log(f"[cycle] MISMATCH {name}")
    log(f"[cycle] each closure round (elle_tile_bits + elle_pmm: product, "
        f"change flag, transpose) and cycle_labels against their plain "
        f"versions on {len(cases)} graphs and the {len(dsgs)} DSGs of the "
        f"checks above {CYCLE_CPU_AT_MOST} txns (n_pad "
        f"{sorted({128 * -(-len(a) // 128) for a in dsgs.values()})}"
        f"): {'equal bit for bit' if not err else 'DIFFER'}")
    n_pad = r.shape[0]
    timing = labels_timing(r, t_plane)
    big = max(CYCLE_CHECK_SIZES)
    dsg = dsgs[f"dsg-{big}-clean"]
    r_dsg, t_dsg, rounds_dsg = cycle.closure_planes(dsg, dev)
    at_dsg = dict(labels_timing(r_dsg, t_dsg), n_pad=r_dsg.shape[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    cycle.closure_planes(adj, dev)
    closure_s = time.perf_counter() - t
    log(f"[cycle] cycle_labels at n_pad {n_pad} (the bench graph's "
        f"closure, {timing['bytes']} bytes): {timing_line(timing)}; the "
        f"closure's {rounds} rounds {closure_s:.4f} s on the host clock (a "
        f"change flag read each)")
    log(f"[cycle] cycle_labels at n_pad {at_dsg['n_pad']} (the clean "
        f"{big}-txn DSG's closure, {rounds_dsg} rounds, {at_dsg['bytes']} "
        f"bytes): {timing_line(at_dsg)}")
    closures = {"bench": closure_timing(adj, dev, clock_hz),
                f"dsg-{big}": closure_timing(dsg, dev, clock_hz)}
    for name, c in closures.items():
        log(f"[cycle] closure of the {name} graph (n_pad {c['n_pad']}, "
            f"{c['rounds']} rounds of elle_tile_bits + elle_pmm), summed: "
            + timing_line(c))
    log(f"[cycle] launches {launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if bad or err or not all(launches.values()):
        raise SystemExit(f"[cycle] wrong results {bad}, a kernel differs "
                         f"from its plain version ({err}), or one was not "
                         f"launched ({launches})")
    return dict(timing, launches=launches, err=err, rounds=rounds,
                n_pad=n_pad, closures=closures, at_dsg=at_dsg)


# ---------------------------------------------------------------------------
# The full consistency lattice (lattice/: planes, the three tiers, the
# checker and the workload adapters; the packed tier on elle_pmm and the
# kernel lattice_masks)
# ---------------------------------------------------------------------------

LATTICE_SIZES = (1000, 10_000)          # auto: the dense tier, the packed
LATTICE_MESH_AT = 4096                  # LatticeChecker()'s mesh_threshold
LATTICE_PLANTS = ELLE_PLANTS + ("read-your-writes",)
LATTICE_KERNEL_NPADS = (128, 10_112)    # random planes of [lattice-kernel]
SESSION_FAMILIES = ("so_ww", "so_wr", "so_rw", "so_rr")
#: The reference's verdict on list_append_history(1000, 10100, plant) on
#: the CPU (the JAX package's LatticeChecker, its dense tier): (valid?,
#: anomaly-types, weakest-violated, not, each class's witness steps).
LATTICE_EXPECT = {
    None: (True, [], None, [], {}),
    "G1c": (False, ["G1c"], "read-committed",
            ["read-committed", "snapshot-isolation", "serializable"],
            {"G1c": [[501, 500, 501]]}),
    "G-single": (False, ["G-single"], "snapshot-isolation",
                 ["snapshot-isolation", "serializable"],
                 {"G-single": [[501, 500, 501]]}),
    "G2-item": (False, ["G2-item"], "serializable", ["serializable"],
                {"G2-item": [[500, 501, 500]]}),
    "G1a": (False, ["G1a"], "read-committed",
            ["read-committed", "snapshot-isolation", "serializable"],
            {"G1a": [None]}),
    "read-your-writes": (False, ["read-your-writes"], "read-your-writes",
                         ["read-your-writes", "PRAM", "causal",
                          "parallel-snapshot-isolation",
                          "snapshot-isolation", "serializable"],
                         {"read-your-writes": [[500, 501, 500]]}),
}


def lattice_history(n, plant):
    """The [lattice] phase's history: the simulated list-append store of
    [elle-check] at n txns, seeded 9100 + n, with a planted block."""
    return list_append_history(n, 9100 + n, plant)


def lattice_got(v):
    """(valid?, anomaly-types, weakest-violated, not, witness steps) of a
    lattice verdict, LATTICE_EXPECT's shape."""
    return (v["valid?"], v["anomaly-types"], v["weakest-violated"], v["not"],
            {k: [w.get("steps") for w in ws]
             for k, ws in v["anomalies"].items()})


def adapter_cases():
    """(name, checker factory, op dicts) of one planted history a
    workload adapter: a causal register's stale read, a long fork, a
    monotonic ts/value inversion (tests/test_lattice.py:437-474)."""
    def pair(p, f, v, inv=None):
        return [{"process": p, "type": "invoke", "f": f, "value": inv},
                {"process": p, "type": "ok", "f": f, "value": v}]
    causal = [d for f, v in (("read-init", 0), ("write", 1), ("read", 1),
                             ("write", 2), ("read", 1))
              for d in pair(0, f, v, v if f == "write" else None)]
    fork = (pair(0, "write", [["w", 0, 1]], [["w", 0, 1]])
            + pair(1, "write", [["w", 1, 1]], [["w", 1, 1]])
            + pair(2, "read", [["r", 0, 1], ["r", 1, None]],
                   [["r", 0, 1], ["r", 1, None]])
            + pair(3, "read", [["r", 1, 1], ["r", 0, None]],
                   [["r", 1, 1], ["r", 0, None]]))
    mono = pair(0, "read", [[1, 100, 0], [3, 150, 1], [2, 200, 0]])
    from jepsen_tpu_torch.workloads import causal as causal_wl
    from jepsen_tpu_torch.workloads import long_fork, monotonic
    return [("causal", causal_wl.check, causal),
            ("long-fork", lambda: long_fork.checker(2), fork),
            ("monotonic", monotonic.checker, mono)]


def phase_lattice():
    """The full-lattice checker on the card over list-append histories of
    LATTICE_SIZES txns, clean and each of LATTICE_PLANTS: at 1,000 txns
    LatticeChecker().check (the dense tier) gives the reference's verdict
    (LATTICE_EXPECT); at 10,000, on planes inferred once
    (infer, planes.from_inference), LatticeChecker().check_planes (the packed
    tier) gives the same classes, and the dense tier's
    (algorithm="device") anomalies equal the packed tier's; then each
    workload adapter once on a planted history (oracle-agrees).  Returns
    (the kernels' launches over the checks, the 10,000-txn packed
    stacks, their rounds)."""
    from jepsen_tpu_torch.elle import infer
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.lattice import checker as lattice_checker
    from jepsen_tpu_torch.lattice import planes as lattice_planes
    from jepsen_tpu_torch.ops import elle_kernel, lattice_kernel
    t0 = time.perf_counter()
    hists = {(n, plant): History(lattice_history(n, plant))
             for n in LATTICE_SIZES for plant in (None,) + LATTICE_PLANTS}
    made_s = time.perf_counter() - t0
    lattice_checker.LatticeChecker(algorithm="mesh").check(
        None, History(lattice_history(40, "G1c")))               # warm-up
    lattice_checker.LatticeChecker(algorithm="device").check(
        None, History(lattice_history(40, "G1c")))
    for k in elle_kernel.LAUNCHES:
        elle_kernel.LAUNCHES[k] = 0
    lattice_kernel.LAUNCHES["lattice_masks"] = 0
    verdicts, walls, planes_of = {}, {}, {}
    for (n, plant), h in hists.items():
        t = time.perf_counter()
        if n <= 1000:
            verdicts[(n, plant)] = lattice_checker.LatticeChecker().check(
                None, h)
        else:
            inf = infer.infer(h)
            infer_s = time.perf_counter() - t
            lp = lattice_planes.from_inference(inf)
            planes_s = time.perf_counter() - t - infer_s
            v = lattice_checker.LatticeChecker().check_planes(
                lp, inf, infer_s=infer_s)
            v["stages"] = dict(infer_s=v["stages"].pop("infer_s"),
                               planes_s=planes_s, **v["stages"])
            verdicts[(n, plant)] = v
            planes_of[(n, plant)] = (lp, inf)
        walls[(n, plant)] = time.perf_counter() - t
    launches = dict(elle_kernel.LAUNCHES, **lattice_kernel.LAUNCHES)
    bad, packed, rounds = [], {}, {}
    for (n, plant), v in verdicts.items():
        want = LATTICE_EXPECT[plant]
        got = lattice_got(v)
        engine = "lattice-mesh" if n >= LATTICE_MESH_AT else "lattice-device"
        ok = v["engine"] == engine and (
            got == want if n <= 1000 else got[:4] == want[:4])
        extra = ""
        if (n, plant) in planes_of:
            lp, inf = planes_of.pop((n, plant))
            t = time.perf_counter()
            d = lattice_checker.LatticeChecker(
                algorithm="device").check_planes(lp, inf)
            dense_s = time.perf_counter() - t
            same = d["anomalies"] == v["anomalies"]
            ok = ok and same
            packed[plant] = lp.packed_stacked()
            rounds[plant] = v["rounds"]
            extra = (f"; the dense tier's verdict (algorithm='device') "
                     f"{dense_s:.3f} s, anomalies "
                     f"{'equal' if same else 'DIFFER'}, stages "
                     f"{elle_stages(d['stages'])}")
            del lp, inf
        log(f"[lattice] n={n} {plant or 'clean'}: {got[0]} {got[1]} weakest "
            f"{got[2]}, engine {v['engine']}, rounds {v.get('rounds')}, "
            f"n_pad {v.get('n_pad')}; wall {walls[(n, plant)]:.3f} s; stages "
            f"{elle_stages(v['stages'])}; session edges "
            f"{sum(v['lattice']['edge-counts'][p] for p in SESSION_FAMILIES)}"
            f"{extra}{'' if ok else ' - WRONG'}")
        if not ok:
            bad.append((n, plant, got))
    for name, make, dicts in adapter_cases():
        t = time.perf_counter()
        v = make().check({}, History(dicts), {})
        wall = time.perf_counter() - t
        ok = v["oracle-agrees"] is True and v["valid?"] is False
        log(f"[lattice] adapter {name}: valid? {v['valid?']}, "
            f"{v['anomaly-types']}, weakest {v['weakest-violated']}, engine "
            f"{v['engine']}, oracle-agrees {v['oracle-agrees']}; "
            f"{wall:.3f} s{'' if ok else ' - WRONG'}")
        if not ok:
            bad.append(("adapter", name))
    log(f"[lattice] launches over the checks {launches}; histories made in "
        f"{made_s:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    if bad or not all(launches.values()):
        raise SystemExit(f"[lattice] wrong verdicts {bad}, or a kernel was "
                         f"not launched ({launches})")
    return launches, packed, rounds


def lattice_round_timing(state, n_pad, clock_hz, full=True):
    """One lattice round on the card (two elle_tile_bits + elle_pmm pairs)
    timed both ways beside its bound (pmm_bound over its 9 products, its
    7 planes read and 7 written); with `full`, also held against its
    plain version bit for bit (planes, flag, transposes) and timed
    beside it and the library's products (9 bf16 torch.matmul,
    thresholded), both on the card."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    from jepsen_tpu_torch.ops import lattice_kernel as lk
    cww, p0a, p1a, p0s, p1s, cpred, cm = state
    ms = launch_ms(lambda: lk.lattice_round(*state), 3)
    dms = device_ms(lambda: lk.lattice_round(*state), 3)
    bound, by, parts = pmm_bound(
        [cww, p0a, p0a | p1a, p1a, p0s, p0s | p1s, p1s, cpred, cm], 14,
        n_pad, clock_hz)
    out = {"ms": ms, "device_ms": dms, "bound_ms": bound, "bound_by": by,
           "parts": parts}
    if not full:
        return out
    got = lk.lattice_round(*state)
    want = lk.lattice_round_plain(*state)
    err = int(not all(torch.equal(g, w) for g, w in zip(got[:7], want[:7]))
              or bool(got[7]) != bool(want[7])
              or not all(torch.equal(g, w) for g, w in zip(got[8], want[8])))
    del got, want
    plain = launch_ms(lambda: lk.lattice_round_plain(*state), 1)
    d = [ek.unpack(x).to(torch.bfloat16) for x in state]
    qa = (d[1] + d[2]).clamp(max=1)
    qs = (d[3] + d[4]).clamp(max=1)
    terms = [(d[0], d[0]), (d[1], d[1]), (qa, d[2]), (d[2], qa),
             (d[3], d[3]), (qs, d[4]), (d[4], qs), (d[5], d[5]),
             (d[6], d[6])]
    library = launch_ms(lambda: [torch.matmul(a, b) > 0.5 for a, b in terms],
                        2)
    return dict(out, err=err, plain_ms=plain, library_ms=library)


def lattice_closure_timing(planes, clock_hz):
    """Every round of a packed stack's closure (engine.closures' loop)
    timed on the card and bounded, summed; the first and the last round
    also against the plain version and the library (lattice_round_timing
    with full)."""
    from jepsen_tpu_torch.ops import elle_kernel as ek
    from jepsen_tpu_torch.ops import elle_mesh
    from jepsen_tpu_torch.ops import lattice_kernel as lk
    ww, wr, rw = planes[0], planes[1], planes[2]
    n_pad = ww.shape[0]
    eye = elle_mesh._eye(n_pad, ww.device)
    base_a = ww | wr
    base_s = base_a | planes[3] | planes[4] | planes[5] | planes[6]
    state = (ww.clone(), base_a | eye, rw.clone(), base_s | eye,
             rw.clone(), base_a | rw | planes[7], ek.product(wr, rw) | eye)
    rounds = []
    steps = max(1, math.ceil(math.log2(max(n_pad - 1, 2))))
    while len(rounds) < steps:
        rounds.append((state, lattice_round_timing(state, n_pad, clock_hz,
                                                   full=False)))
        *nxt, changed, _ = lk.lattice_round(*state)
        if not bool(changed):
            break
        state = tuple(nxt)
    first = dict(rounds[0][1], **lattice_round_timing(rounds[0][0], n_pad,
                                                      clock_hz))
    last = dict(rounds[-1][1], **lattice_round_timing(rounds[-1][0], n_pad,
                                                      clock_hz))
    tot = {k: sum(r[k] for _, r in rounds)
           for k in ("ms", "device_ms", "bound_ms")}
    return {"first": first, "last": last, "closure": dict(
        tot, rounds=len(rounds),
        bound_by="operations" if all(r["bound_by"] == "operations"
                                     for _, r in rounds) else "mixed")}


def lattice_masks_case(planes, tposes):
    """(err, kernel out): 1 if lattice_masks differs from masks_plain on
    the same tensors, else 0."""
    from jepsen_tpu_torch.ops import lattice_kernel as lk
    got = lk.masks(planes, tposes)
    want = lk.masks_plain(planes, tposes)
    return int(not torch.equal(got, want)), got


def lattice_mask_cases(n_pad, gen, dev):
    """(name, planes8, tposes7) of random packed planes at n_pad: all zero
    (every class empty), all one, and random words at densities 1/n_pad,
    0.01 and 0.5, so that each class is found where its inputs allow."""
    w = n_pad // 32
    out = [("zero", [torch.zeros((n_pad, w), dtype=torch.int32, device=dev)
                     for _ in range(15)]),
           ("one", [torch.full((n_pad, w), -1, dtype=torch.int32, device=dev)
                    for _ in range(15)])]
    for dens in (1.0 / n_pad, 0.01, 0.5):
        out.append((f"dens-{dens:.4g}",
                    [random_packed(n_pad, n_pad, dens, gen, dev)
                     for _ in range(15)]))
    return [(name, pl[:8], pl[8:]) for name, pl in out]


def phase_lattice_kernel(packed, rounds, clock_hz):
    """lattice_masks against masks_plain on the card, bit for bit: the
    10,000-txn checks' planes and transposes (each stack of [lattice]),
    and random planes at LATTICE_KERNEL_NPADS; timed both ways on the
    clean stack beside its plain version and its byte bound (15 planes
    read once, 96 bytes written).  Then the clean stack's closure round
    by round on the card beside each round's bound, its first and last
    rounds against lattice_round_plain bit for bit (planes, flag,
    transposes) and timed beside it and the library's products."""
    from jepsen_tpu_torch.lattice import engine
    from jepsen_tpu_torch.ops import elle_mesh
    from jepsen_tpu_torch.ops import lattice_kernel as lk
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    err, timing, closure = 0, None, None
    for plant, pk in packed.items():
        planes = elle_mesh._to_device(pk, dev)
        tposes, r = engine.closures(planes)
        e, got = lattice_masks_case(list(planes), tposes)
        torch.cuda.synchronize()
        err |= e
        n_pad = planes.shape[1]
        log(f"[lattice-kernel] {plant or 'clean'} (n_pad {n_pad}, {r} rounds"
            f"): lattice_masks {'equal' if not e else 'DIFFERS'} to "
            f"masks_plain, picks {got.tolist()}")
        if plant is None:
            pl, tp = list(planes), list(tposes)
            ms = launch_ms(lambda: lk.masks(pl, tp), 10)
            dms = device_ms(lambda: lk.masks(pl, tp), 20)
            plain = launch_ms(lambda: lk.masks_plain(pl, tp), 2)
            nbytes = 15 * n_pad * n_pad // 8 + 12 * 8
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            timing = {"ms": ms, "device_ms": dms, "plain_ms": plain,
                      "bound_ms": bound, "bound_by": "bytes",
                      "library_ms": None, "bytes": nbytes, "n_pad": n_pad}
            del pl, tp
            closure = lattice_closure_timing(planes, clock_hz)
            err |= closure["first"]["err"] | closure["last"]["err"]
        del planes, tposes
    gen = torch.Generator(device=dev)
    gen.manual_seed(2101)
    cases = 0
    for n_pad in LATTICE_KERNEL_NPADS:
        for name, pl, tp in lattice_mask_cases(n_pad, gen, dev):
            e, _ = lattice_masks_case(pl, tp)
            torch.cuda.synchronize()
            err |= e
            cases += 1
            if e:
                log(f"[lattice-kernel] MISMATCH n_pad {n_pad} {name}")
    log(f"[lattice-kernel] lattice_masks against masks_plain on {cases} "
        f"random plane sets at n_pad {LATTICE_KERNEL_NPADS} (all zero, all "
        f"one, densities 1/n_pad, 0.01, 0.5): "
        f"{'equal bit for bit' if not err else 'DIFFER'}")
    log(f"[lattice-kernel] lattice_masks at n_pad {timing['n_pad']} (the "
        f"clean 10,000-txn check's planes, {timing['bytes']} bytes): "
        + timing_line(timing))
    for which in ("first", "last"):
        f = closure[which]
        log(f"[lattice-kernel] the {which} lattice round of the clean "
            f"10,000-txn closure (2 elle_tile_bits + 2 elle_pmm): "
            f"{'equal' if not f['err'] else 'DIFFERS'} to "
            f"lattice_round_plain; " + timing_line(f)
            + f"; bound parts {f['parts']}")
    c = closure["closure"]
    log(f"[lattice-kernel] the clean 10,000-txn closure's {c['rounds']} "
        f"rounds, summed: {c['ms']:.4f} ms launch to end, "
        f"{c['device_ms']:.4f} ms on the device; bound {c['bound_ms']:.4f} "
        f"ms ({c['bound_by']}), reached "
        f"{100 * c['bound_ms'] / c['device_ms']:.2f}% on the device")
    log(f"[lattice-kernel] rounds of the 10,000-txn checks {rounds}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if err:
        raise SystemExit("[lattice-kernel] a kernel differs from its plain "
                         "version")
    return dict(timing, err=err, closure=closure)


# ---------------------------------------------------------------------------
# The candidate-table route (wgl_cand_bits, wgl_cand_dense) and the relaxed
# tier's two-word lift (wgl_regs_relaxed at W = 2)
# ---------------------------------------------------------------------------

WIDE_N_OPS = 20_000                 # calls of the wide histories
WIDE_VMAX = 40                      # values 0..40: 42 states with None
WIDE_KEYS = 512                     # wide keys of [wide-main]'s check_many
CAND_TARGET = 64                    # returns a segment in [cand-kernel]
COUNTER_N_OPS = 4000                # calls of [wide-main]'s mod-3 counter


def wide_dicts(seed, vmax, n_calls=60, conc=4, max_open=0, burst=0,
               buggy=0.0, crash_rate=0.0):
    """A CAS register key whose history first writes every value
    0..vmax (so vmax + 2 states with the initial None), then runs
    `key_dicts`' random workload."""
    head = []
    for v in range(vmax + 1):
        head += [op(0, "invoke", "write", v), op(0, "ok", "write", v)]
    body = key_dicts(seed, n_calls=n_calls, conc=conc, vmax=vmax,
                     max_open=max_open, burst=burst, buggy=buggy,
                     crash_rate=crash_rate)
    return [dict(d, index=j) for j, d in enumerate(head + body)]


def cand_arrays(ret_slot, cand_slot, cand_uop, legal, next_state, dec, *,
                R, Sn, J, form):
    """Candidate tables in `planner.plan`'s layout ([K, L], [K, L, C])
    as the kernel of `form` takes them: host arrays and the shapes."""
    from jepsen_tpu_torch.ops import cand_kernel
    t = dict(ret=np.ascontiguousarray(ret_slot.T),
             cslot=np.ascontiguousarray(cand_slot.transpose(1, 0, 2)),
             cuop=np.ascontiguousarray(cand_uop.transpose(1, 0, 2)),
             R=R, Sn=Sn, J=J, form=form, decomposed=dec[0] is not None,
             K=ret_slot.shape[0])
    if form == "bits":
        t["a1"], t["a2"], t["t0"] = cand_kernel.bits_tables(
            t["cuop"], legal, next_state, *dec)
    else:
        t["tab"], t["nxt"] = cand_kernel.dense_tables(legal, next_state,
                                                      *dec)
    return t


def cand_tables(model, history, J, target=None, form=None):
    """The plan route's candidate tables of `history` (a History or a
    PreparedHistory) as check() builds them, for lanes entering every
    state (J = "Sn") or state 0 (J = 1), for the form `cand_gate` picks
    unless `form` names one (see cand_arrays)."""
    from jepsen_tpu_torch.ops import planner, wgl_seg
    from jepsen_tpu_torch.ops.prep import PreparedHistory, prepare
    prep = history if isinstance(history, PreparedHistory) \
        else prepare(history)
    pl = planner.plan(prep, model.device_spec(), model,
                      target_returns_per_segment=target
                      or wgl_seg.TARGET_RETURNS)
    R, Sn = int(pl.max_open), int(pl.states.shape[0])
    dec = (pl.diag_w, pl.const_w, pl.const_t0)
    return cand_arrays(pl.ret_slot, pl.cand_slot, pl.cand_uop, pl.legal,
                       pl.next_state, dec, R=R, Sn=Sn,
                       J=Sn if J == "Sn" else 1,
                       form=form or planner.cand_gate(R, Sn,
                                                      dec[0] is not None))


def cand_key_tables(model, histories):
    """The tables of check_many's one J = 1 candidate-table launch over
    `histories` (lane keys whose alphabet the key kernel refuses), built
    by check_many's own host half."""
    from jepsen_tpu_torch.ops import planner, wgl_seg
    spec = model.device_spec()
    keys = wgl_seg._sort_keys(spec, histories, 10, "cuda")
    states, legal, next_state, dec = wgl_seg._model_tables(
        spec, model, keys.rows, 64)
    R = max(int(fk.max_open) for _, fk, _ in keys.lanes)
    Sn = int(states.shape[0])
    return cand_arrays(*wgl_seg._cand_key_tables(keys, R), legal,
                       next_state, dec, R=R, Sn=Sn, J=1,
                       form=planner.cand_gate(R, Sn, dec[0] is not None))


def cand_names(t):
    """The names of t's kernel arguments, in order."""
    return (("ret", "cslot", "a1", "a2", "t0") if t["form"] == "bits"
            else ("ret", "cslot", "cuop", "tab", "nxt"))


def cand_call(t, dev):
    """A function launching t's kernel (its wrapper) on `dev`, on the
    tensors of t there."""
    from jepsen_tpu_torch.ops import cand_kernel
    d = torch.device(dev)
    args = [torch.from_numpy(t[n]).to(d) for n in cand_names(t)]
    kw = dict(R=t["R"], Sn=t["Sn"], J=t["J"])
    if t["form"] == "bits":
        return lambda: cand_kernel.cand_bits(*args, decomposed=t[
            "decomposed"], **kw)
    return lambda: cand_kernel.cand_dense(*args, **kw)


def cand_plain_job(t):
    """The plain version on CPU copies, in a worker process: (T, the
    integer operations the walk needs, seconds)."""
    from jepsen_tpu_torch.ops import cand_kernel
    torch.set_num_threads(1)
    tt = time.perf_counter()
    ret, cslot = torch.from_numpy(t["ret"]), torch.from_numpy(t["cslot"])
    if t["form"] == "bits":
        params = cand_kernel._bits_params(
            *(torch.from_numpy(t[n]) for n in ("a1", "a2", "t0")),
            t["decomposed"], t["Sn"])
    else:
        params = cand_kernel._dense_params(
            *(torch.from_numpy(t[n]) for n in ("cuop", "tab", "nxt")),
            t["Sn"])
    need = torch.zeros(t["K"], dtype=torch.int64)
    T = cand_kernel.walk_plain(ret, cslot, params, R=t["R"], Sn=t["Sn"],
                               J=t["J"], need=need)
    return T.numpy(), int(need.sum()), time.perf_counter() - tt


def cand_bytes(t):
    """Bytes the kernel must move: its tables read once, T written once."""
    return (sum(t[n].nbytes for n in cand_names(t))
            + t["K"] * t["J"] * t["Sn"])


def cand_kernel_cases():
    """(name, model, history, J) of [cand-kernel]: the dense form on
    decomposed wide registers at R = 1..6 (Sn 33..64) and an undecomposed
    counter mod 12; the bits form on decomposed registers at R = 7, 8, 10
    (Sn <= 32) and on the counter mod 3 (nibbles); each at J = Sn and
    J = 1.  Histories of a few hundred calls, cut every CAND_TARGET
    returns."""
    from jepsen_tpu_torch import convert
    from jepsen_tpu_torch.models import CASRegister
    reg = CASRegister()
    hs = []
    for R, vmax in zip(range(1, 7), (31, 38, 44, 50, 56, 62)):
        hs.append((f"dense-dec R={R} vmax={vmax}", reg, wide_dicts(
            900 + R, vmax, n_calls=300, conc=R, max_open=R, burst=R,
            buggy=0.01 if R % 2 else 0.0)))
    for R, n in ((3, 12), (5, 12)):
        hs.append((f"dense-table R={R} mod {n}", mod_counter(n),
                   counter_dicts(910 + R, n, n_calls=300, conc=R,
                                 max_open=R, buggy=0.01 * (R == 5))))
    for R, vmax in ((7, 30), (8, 9), (10, 6)):
        hs.append((f"bits-dec R={R} vmax={vmax}", reg, key_dicts(
            920 + R, n_calls=300, conc=R, vmax=vmax, max_open=R, burst=R,
            buggy=0.01 if R == 8 else 0.0)))
    for R in (2, 4, 6):
        hs.append((f"bits-nibble R={R} mod 3", mod_counter(3),
                   counter_dicts(930 + R, 3, n_calls=300, conc=R, max_open=R,
                                 buggy=0.01 * (R == 4))))
    return [(f"{name} J={J}", m, convert.history_from_dicts(d), J)
            for name, m, d in hs for J in ("Sn", 1)]


def phase_cand_kernel():
    """Both candidate-table kernels against their plain version (CPU
    copies of the same inputs, worker processes): transfer rows T bit
    for bit on every case of `cand_kernel_cases`."""
    from jepsen_tpu_torch.ops import cand_kernel
    t0 = time.perf_counter()
    cases = [(n, cand_tables(m, h, J, CAND_TARGET))
             for n, m, h, J in cand_kernel_cases()]
    ctx = multiprocessing.get_context("spawn")
    err = {"bits": 0, "dense": 0}
    seen = set()
    with ProcessPoolExecutor(4, mp_context=ctx) as pool:
        futs = [pool.submit(cand_plain_job, t) for _, t in cases]
        for (name, t), f in zip(cases, futs):
            fn = cand_call(t, DEV)
            T, bad = fn()
            T = T.cpu().numpy()
            ms, dms = launch_ms(fn, 3), device_ms(fn, 5)
            pT, need, _ = f.result()
            e = int(np.abs(T.astype(np.int64) - pT.astype(np.int64)).max())
            err[t["form"]] = max(err[t["form"]], e)
            seen.add((t["form"], t["decomposed"], t["Sn"] > 32,
                      t["J"] == 1))
            ok = e == 0 and int(bad.cpu()[0]) == 0
            log(f"[cand-kernel] {name}: wgl_cand_{t['form']} K={t['K']} "
                f"L={t['ret'].shape[0]} C={t['cslot'].shape[2]} "
                f"R={t['R']} Sn={t['Sn']} J={t['J']}: "
                f"{int(T.sum())} transfer bits, {need} operations; kernel "
                f"{ms:.4f} ms launch to end (mean of 3), {dms:.4f} ms on "
                f"the device; {'equal' if ok else 'DIFFERENT'}")
            if not ok:
                raise SystemExit(f"[cand-kernel] {name}: kernel and plain "
                                 f"version disagree")
    want = {("dense", True, True, False), ("dense", True, True, True),
            ("dense", False, False, False), ("dense", False, False, True),
            ("bits", True, False, False), ("bits", True, False, True),
            ("bits", False, False, False), ("bits", False, False, True)}
    if not want <= seen:
        raise SystemExit(f"[cand-kernel] cases miss {sorted(want - seen)}")
    log(f"[cand-kernel] {len(cases)} cases equal in "
        f"{time.perf_counter() - t0:.1f} s (launch counts: "
        f"{dict(cand_kernel.LAUNCHES)})")
    return err


def cand_timing(t, clock_hz, plain):
    """t's launch timed (launch to end, mean of 5; on the device, 10 back
    to back) beside its plain version (`plain`: cand_plain_job's result)
    and its bound: the larger of the operations the walk needs over
    every INT32 lane and its bytes over device memory."""
    fn = cand_call(t, DEV)
    T, bad = fn()
    pT, need, psecs = plain
    e = int(np.abs(T.cpu().numpy().astype(np.int64)
                   - pT.astype(np.int64)).max())
    if e or int(bad.cpu()[0]):
        raise SystemExit("[wide-main] a main-path launch and its plain "
                         "version disagree")
    ms = launch_ms(fn, 5)
    dms = device_ms(fn, 10)
    nbytes = cand_bytes(t)
    t_ops = 1e3 * need / (N_SM * INT32_LANES_PER_SM * clock_hz)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return dict(ms=ms, device_ms=dms, plain_ms=1e3 * psecs,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                err=e, ops=need, bytes=nbytes)


def timing_words(tag, r):
    return (f"{tag}: kernel {r['ms']:.4f} ms launch to end (mean of 5), "
            f"{r['device_ms']:.4f} ms on the device, plain (CPU, one "
            f"thread) {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']} ({r['ops']} operations, {r['bytes']} "
            f"bytes; {r['bound_ms'] / r['device_ms']:.4f} of the device "
            f"time); equal")


def phase_wide_main(clock_hz):
    """The candidate-table route on the main path: the crash-free twin of
    the JAX package's wide-state bench history (a 40-value CAS register,
    WIDE_N_OPS calls, 16 processes, max_open 6: 42 states) through
    Linearizable, valid on wgl_cand_dense, and its planted twin invalid
    at the CPU oracle's op; WIDE_KEYS wide keys through check_many in one
    J = 1 launch, verdicts equal to the CPU oracle's on a sample; a
    counter mod 3 (undecomposed, 3 states) through Linearizable on
    wgl_cand_bits' nibble form, valid and planted; and an envelope
    history at max_open 8 as a PreparedHistory through wgl_seg.check on
    wgl_cand_bits.  The launch counts are read over these calls.  Then
    the keys' launch, rebuilt by check_many's host half, held bit for bit
    against its plain version; the wide history's and the envelope's
    launches timed against their plain versions (started in worker
    processes before the checks); and the envelope's tables timed in both
    forms."""
    from jepsen_tpu_torch import convert
    from jepsen_tpu_torch.checker import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import cand_kernel, wgl_cpu, wgl_seg
    from jepsen_tpu_torch.ops.prep import prepare
    t00 = time.perf_counter()
    model = CASRegister()
    h = make_history(WIDE_N_OPS, 16, seed=67, vmax=WIDE_VMAX, max_open=6)
    hp = copy_history(h)
    planted = plant_stale_read(hp, 0.9, WIDE_VMAX)
    keys = [convert.history_from_dicts(key_dicts(
        5000 + k, n_calls=40, conc=5, vmax=WIDE_VMAX,
        buggy=0.05 if k % 97 == 3 else 0.0)) for k in range(WIDE_KEYS)]
    cm = mod_counter(3)
    ch = convert.history_from_dicts(counter_dicts(
        940, 3, n_calls=COUNTER_N_OPS, conc=5, max_open=5))
    chp = convert.history_from_dicts(counter_dicts(
        940, 3, n_calls=COUNTER_N_OPS, conc=5, max_open=5, buggy=0.01))
    env = make_history(WIDE_N_OPS, 16, seed=53, max_open=8)
    env_prep = prepare(env)
    # the main path's launches, for their plain versions (worker
    # processes, running while the checks run): the wide history's
    # (dense, J = Sn) and the envelope's (bits, J = Sn, R = 8)
    td = cand_tables(model, h, "Sn")
    tb = cand_tables(model, env_prep, "Sn")
    ctx = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(3, mp_context=ctx)
    fd, fb = (pool.submit(cand_plain_job, x) for x in (td, tb))
    attach_columns("the wide histories", [h, hp])
    # the run holds millions of earlier phases' ops: collect them now, so
    # a full collection does not land inside the first timed check
    t = time.perf_counter()
    gc.collect()
    log(f"[wide-main] gc.collect() before the checks: "
        f"{time.perf_counter() - t:.3f} s")
    out = {}
    for k in cand_kernel.LAUNCHES:
        cand_kernel.LAUNCHES[k] = 0
    t = time.perf_counter()
    r = Linearizable(model).check(None, h)
    out["valid"] = (r, time.perf_counter() - t)
    t = time.perf_counter()
    rp = Linearizable(model).check(None, hp)
    out["planted"] = (rp, time.perf_counter() - t)
    st: dict = {}
    t = time.perf_counter()
    rk = wgl_seg.check_many(model, keys, stats=st)
    out["keys"] = (rk, time.perf_counter() - t)
    t = time.perf_counter()
    rc = Linearizable(cm).check(None, ch)
    rcp = Linearizable(cm).check(None, chp)
    out["counter"] = ((rc, rcp), time.perf_counter() - t)
    t = time.perf_counter()
    re_ = wgl_seg.check(model, env_prep)
    out["prepared"] = (re_, time.perf_counter() - t)
    launches = dict(cand_kernel.LAUNCHES)
    # the verdicts against the CPU oracle
    t = time.perf_counter()
    o = wgl_cpu.check(model, hp)
    d = r["dispatch"]
    ok = (r["valid?"] is True and r["engine"] == "wgl_seg"
          and d.get("kernel") == "wgl_cand_dense" and r["states"] >= 33)
    log(f"[wide-main] {WIDE_N_OPS} calls, 16 processes, vmax {WIDE_VMAX}, "
        f"max_open 6 via Linearizable: valid?={r['valid?']} "
        f"engine={r['engine']} kernel={d.get('kernel')} "
        f"states={r.get('states')} R={r.get('max_open')} "
        f"segments={r.get('segments')} in {out['valid'][1]:.3f} s "
        f"(plan {r['time_plan_s']:.3f} s, kernel and composition "
        f"{r['time_kernel_s']:.4f} s) {'OK' if ok else 'WRONG'}")
    ok_p = (rp["valid?"] is False and rp.get("op_index") == planted
            == o.get("op_index") and o["valid?"] is False
            and rp["dispatch"].get("kernel") == "wgl_cand_dense")
    log(f"[wide-main] planted stale read via Linearizable: "
        f"valid?={rp['valid?']} op_index={rp.get('op_index')} "
        f"planted={planted} CPU oracle's={o.get('op_index')} "
        f"({time.perf_counter() - t:.2f} s) "
        f"dead_segment={rp.get('dead_segment')} in "
        f"{out['planted'][1]:.3f} s {'OK' if ok_p else 'WRONG'}")
    sample = [i for i, x in enumerate(rk) if x["valid?"] is False]
    sample += list(range(0, WIDE_KEYS, 16))
    want = {i: wgl_cpu.check(model, keys[i])["valid?"] for i in sample}
    ok_k = (all(rk[i]["valid?"] == v for i, v in want.items())
            and st.get("launches") == 1
            and all(x["engine"] == "wgl_seg_batch" for x in rk)
            and rk[0]["dispatch"].get("kernel") == "wgl_cand_dense")
    log(f"[wide-main] {WIDE_KEYS} wide keys (40 calls, vmax {WIDE_VMAX}) "
        f"via check_many: {sum(x['valid?'] is False for x in rk)} invalid, "
        f"engine {rk[0]['engine']}, kernel "
        f"{rk[0]['dispatch'].get('kernel')}, {st.get('launches')} launch, "
        f"kernel {st.get('kernel_ms', 0.0):.4f} ms on the device; "
        f"{len(want)} keys against the CPU oracle "
        f"(the invalid ones and every 16th) in {out['keys'][1]:.3f} s "
        f"{'OK' if ok_k else 'WRONG'}")
    oc = wgl_cpu.check(cm, chp)
    ok_c = (rc["valid?"] is True and rcp["valid?"] is False
            and rcp.get("op_index") == oc.get("op_index")
            and rc["dispatch"].get("kernel") == "wgl_cand_bits"
            and rc["dispatch"].get("form") == "bits")
    log(f"[wide-main] counter mod 3 ({COUNTER_N_OPS} calls, 5 processes) "
        f"via Linearizable: valid?={rc['valid?']} kernel="
        f"{rc['dispatch'].get('kernel')} states={rc.get('states')} "
        f"R={rc.get('max_open')}; planted twin valid?={rcp['valid?']} "
        f"op_index={rcp.get('op_index')} CPU oracle's="
        f"{oc.get('op_index')}; both in {out['counter'][1]:.3f} s "
        f"{'OK' if ok_c else 'WRONG'}")
    ok_e = (re_["valid?"] is True
            and re_["dispatch"].get("kernel") == "wgl_cand_bits")
    log(f"[wide-main] envelope history at max_open 8 ({WIDE_N_OPS} calls) "
        f"as a PreparedHistory via wgl_seg.check: valid?={re_['valid?']} "
        f"kernel={re_['dispatch'].get('kernel')} R={re_.get('max_open')} "
        f"states={re_.get('states')} segments={re_.get('segments')} in "
        f"{out['prepared'][1]:.3f} s {'OK' if ok_e else 'WRONG'}")
    log(f"[wide-main] launches on this path: {launches}")
    if not (ok and ok_p and ok_k and ok_c and ok_e):
        pool.shutdown(wait=False, cancel_futures=True)
        raise SystemExit("[wide-main] a verdict is wrong")
    if not (launches["wgl_cand_dense"] >= 3 and launches["wgl_cand_bits"]
            >= 3):
        pool.shutdown(wait=False, cancel_futures=True)
        raise SystemExit(f"[wide-main] the candidate-table kernels were not "
                         f"launched on the main path: {launches}")
    # the keys' J = 1 launch rebuilt by check_many's host half, against
    # its plain version bit for bit
    tk = cand_key_tables(model, keys)
    fk = pool.submit(cand_plain_job, tk)
    with pool:
        Tk, bad = cand_call(tk, DEV)()
        pTk, _, ksecs = fk.result()
        if int(bad.cpu()[0]) or not np.array_equal(Tk.cpu().numpy(), pTk):
            raise SystemExit("[wide-main] the keys' launch and its plain "
                             "version disagree")
        log(f"[wide-main] the {WIDE_KEYS} keys' wgl_cand_{tk['form']} "
            f"launch (K={tk['K']} L={tk['ret'].shape[0]} "
            f"C={tk['cslot'].shape[2]} R={tk['R']} Sn={tk['Sn']} J=1) "
            f"rebuilt by check_many's host half: equal to its plain "
            f"version bit for bit (plain {1e3 * ksecs:.1f} ms)")
        timing = {"dense": cand_timing(td, clock_hz, fd.result()),
                  "bits": cand_timing(tb, clock_hz, fb.result())}
    log("[wide-main] " + timing_words(
        f"wgl_cand_dense launch of the wide history (K={td['K']} "
        f"L={td['ret'].shape[0]} C={td['cslot'].shape[2]} R={td['R']} "
        f"Sn={td['Sn']} J={td['J']})", timing["dense"]))
    log("[wide-main] " + timing_words(
        f"wgl_cand_bits launch of the envelope history (K={tb['K']} "
        f"L={tb['ret'].shape[0]} C={tb['cslot'].shape[2]} R={tb['R']} "
        f"Sn={tb['Sn']} J={tb['J']})", timing["bits"]))
    # the envelope's tables in the dense form too: the same transfer rows,
    # each form timed on them in turn
    tbd = cand_tables(model, env_prep, "Sn", form="dense")
    fn_b, fn_d = cand_call(tb, DEV), cand_call(tbd, DEV)
    if not torch.equal(fn_b()[0], fn_d()[0]):
        raise SystemExit("[wide-main] the two forms disagree on the "
                         "envelope's tables")
    pair = [(device_ms(fn_b, 10), device_ms(fn_d, 10)) for _ in range(2)]
    log(f"[wide-main] the envelope's tables in both forms, equal; on the "
        f"device, bits then dense, twice: "
        + ", ".join(f"{b:.4f} / {d:.4f} ms" for b, d in pair))
    log(f"[wide-main] phase in {time.perf_counter() - t00:.1f} s")
    return launches, timing


def phase_wide_crash(clock_hz):
    """The JAX package's wide-state crash regime (bench.py:1717-1740: a
    40-value CAS register, WIDE_N_OPS calls, 16 processes, 1% crashed
    with values 0..30, max_open 6, a stale read planted at 90% depth with
    values 0..30 forbidden) through wgl_seg.check (localize off, as the
    bench): refuted by the relaxed tier at W = 2 with the planted read as
    its exact witness, the W = 2 launches counted; then the relaxed
    launch and the dead segment's death row against their plain version
    and timed."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import crash_kernel, regs_kernel, wgl_seg
    t00 = time.perf_counter()
    h = make_history(WIDE_N_OPS, 16, seed=67, vmax=WIDE_VMAX,
                     crash_rate=0.01, max_open=6, crash_vmax=30)
    planted = plant_stale_read(h, 0.9, WIDE_VMAX, forbidden=set(range(31)))
    if planted is None:
        raise SystemExit("[wide-crash] no plantable stale read")
    attach_columns("the wide crash history", [h])
    model = CASRegister()
    crash_kernel.LAUNCHES["wgl_regs_relaxed_w2"] = 0
    st: dict = {}
    t = time.perf_counter()
    r = wgl_seg.check(model, h, max_open_bits=12, localize=False, stats=st)
    wall = time.perf_counter() - t
    launches = crash_kernel.LAUNCHES["wgl_regs_relaxed_w2"]
    ok = (r["valid?"] is False and r.get("refutation") == "crash-relaxed"
          and r.get("witness") == "relaxed-exact"
          and r.get("op_index") == planted and r.get("states", 0) > 32
          and launches >= 2)
    log(f"[wide-crash] {WIDE_N_OPS} calls, {r.get('crashed')} crashed, "
        f"vmax {WIDE_VMAX}: valid?={r['valid?']} "
        f"refutation={r.get('refutation')} witness={r.get('witness')} "
        f"op_index={r.get('op_index')} planted={planted} "
        f"states={r.get('states')} R={r.get('max_open')} "
        f"dead_segment={r.get('dead_segment')} in {wall:.3f} s; "
        f"stages: {stage_line(st)}; W = 2 launches {launches} "
        f"{'OK' if ok else 'WRONG'}")
    if not ok:
        raise SystemExit("[wide-crash] the relaxed tier at W = 2 did not "
                         "refute the planted read exactly")
    # the plain version runs in PyTorch on the card here: on a CPU thread
    # the walk of this history takes minutes
    ri = relaxed_inputs(h)
    Tr, wr, _, (ms_r, dms_r) = crash_run(ri, DEV, "relaxed", reps=5)
    vd = regs_kernel.compose(torch.from_numpy(Tr).to(DEV),
                             [ri["K"]]).cpu()[0].tolist()
    dead = vd[1]
    seed = (vd[2] & 0xFFFFFFFF) | (vd[3] & 0xFFFFFFFF) << 32
    dr, dw, _, (ms_d, dms_d) = crash_run(ri, DEV, "death", [dead], seed,
                                         reps=5)
    pdr, pdw, pdn, pd_s = plain_crash_job(ri, "death", [dead], seed, DEV)
    pd_ms = 1e3 * pd_s
    pTr, pwr, pnr, rsecs = plain_crash_job(ri, "relaxed", dev=DEV)
    if not (np.array_equal(Tr, pTr) and np.array_equal(wr, pwr)
            and int(dr[0]) == int(pdr[0]) and np.array_equal(dw, pdw)):
        raise SystemExit("[wide-crash] the W = 2 relaxed kernel and its "
                         "plain version disagree")
    rbytes = crash_wire_bytes(ri, Tr.nbytes)
    br = seg_bound_ms(int(pnr.sum()), rbytes, clock_hz)
    dbytes = crash_wire_bytes(dict(ri, offs=ri["offs"][[dead]]), 4)
    bd = seg_bound_ms(int(pdn.sum()), dbytes, clock_hz)
    by = ("operations" if int(pnr.sum()) / (N_SM * INT32_LANES_PER_SM
                                             * clock_hz)
          >= rbytes / HBM_BYTES_PER_S else "bytes")
    res = dict(ms=ms_r, device_ms=dms_r, plain_ms=1e3 * rsecs, bound_ms=br,
               bound_by=by, err=int(np.abs(Tr.astype(np.int64)
                                           - pTr.astype(np.int64)).max()),
               death=dict(ms=ms_d, device_ms=dms_d, plain_ms=pd_ms,
                          bound_ms=bd))
    log(f"[wide-crash] W = 2 relaxed launch: K={ri['K']} segments, "
        f"rows={int(ri['nrows'].sum())}, R={ri['R']}, Sn={ri['Sn']}, "
        f"{ri['nC']} crash prefixes: dead segment {dead}, kernel "
        f"{ms_r:.3f} ms launch to end (mean of 5), {dms_r:.3f} ms on the "
        f"device, plain (PyTorch on the card) {1e3 * rsecs:.1f} ms, bound "
        f"{br:.4f} ms from the {int(pnr.sum())} integer operations it "
        f"needs ({br / dms_r:.4f} of the device time), work="
        f"{int(wr.sum())}; equal")
    log(f"[wide-crash] W = 2 death row of the dead segment: row "
        f"{int(dr[0])}, kernel {ms_d:.3f} ms launch to end (mean of 5), "
        f"{dms_d:.3f} ms on the device, plain (on the card) {pd_ms:.1f} "
        f"ms, bound {bd:.5f} ms from the {int(pdn.sum())} integer "
        f"operations it needs; equal")
    log(f"[wide-crash] phase in {time.perf_counter() - t00:.1f} s")
    return launches, res


#: Wall seconds of each phase of this run, in order (`timed`).
PHASE_S: dict = {}


def timed(fn, *args):
    """fn(*args), its wall seconds kept in PHASE_S under fn's name."""
    t = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[fn.__name__.removeprefix("phase_")] = \
            time.perf_counter() - t


def main() -> int:
    t_run = time.perf_counter()
    smi, clock_hz = timed(phase_device)
    built = timed(phase_build)
    err = timed(phase_kernel, clock_hz)
    seg_err = timed(phase_seg_kernel, clock_hz)
    batches, verdicts, launches = timed(phase_main)
    grid_err = timed(phase_grid, batches, verdicts)
    one = timed(phase_timing, batches, clock_hz)
    seg_hs, seg_launches = timed(phase_seg_main)
    timed(phase_scan, seg_hs, batches[12])
    seg = timed(phase_seg_grid, seg_hs, clock_hz)
    crash_err = timed(phase_crash_kernel, clock_hz)
    crash_main = timed(phase_crash_main, seg_hs)
    crash_launches = timed(phase_crash_pipeline, seg_hs, crash_main)
    crash = timed(phase_crash_timing, crash_main, clock_hz)
    compose_err = timed(phase_compose, seg, crash)
    many_hs, many_launches = timed(phase_many_main)
    timed(phase_many_crash)
    keys = timed(phase_many_kernel, many_hs, built, clock_hz)
    timed(phase_many_independent, many_hs)
    serial_err = timed(phase_serial_kernel, clock_hz)
    serial_launches, serial, serial_first = timed(phase_serial_main, clock_hz)
    timed(phase_serial_crash, clock_hz)
    elle_stacks = timed(elle_bench_stacks)
    elle = timed(phase_elle_kernel, built, elle_stacks, clock_hz)
    timed(phase_elle_main, elle_stacks)
    elle_launches = timed(phase_elle_check)
    fold = timed(phase_fold)
    cyc = timed(phase_cycle, clock_hz)
    lat_launches, lat_packed, lat_rounds = timed(phase_lattice)
    lat = timed(phase_lattice_kernel, lat_packed, lat_rounds, clock_hz)
    del lat_packed
    cand_err = timed(phase_cand_kernel)
    cand_launches, cand = timed(phase_wide_main, clock_hz)
    w2_launches, w2 = timed(phase_wide_crash, clock_hz)
    log("[time] seconds a phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_S.items())
        + f"; {time.perf_counter() - t_run:.1f} s since the start of main")
    kernels = [{"name": f"wgl_deep_{arm}", "route": "cuda",
                "source": "jepsen_tpu_torch/csrc/wgl_deep.cu",
                "replaces": "jepsen_tpu/ops/wgl_deep.py:358",
                "launches": launches[arm],
                "max_abs_err": max(err[arm], grid_err[arm],
                                   one[arm]["err"]),
                "ms": one[arm]["ms"], "device_ms": one[arm]["device_ms"],
                "plain_ms": one[arm]["plain_ms"],
                "bound_ms": one[arm]["bound_ms"], "bound_by": "bytes",
                "library_ms": None} for arm in ("warp", "block")]
    kernels.append({"name": "wgl_regs", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/wgl_regs.cu",
                    "replaces": "jepsen_tpu/ops/wgl_seg.py:258",
                    "launches": seg_launches["wgl_regs"],
                    "max_abs_err": max(seg_err, seg["err"]),
                    "ms": seg["group"]["ms"],
                    "device_ms": seg["group"]["device_ms"],
                    "plain_ms": seg["group"]["plain_ms"],
                    "bound_ms": seg["group"]["bound_ms"],
                    "bound_by": "operations", "library_ms": None})
    kernels.append({"name": "wgl_compose", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/wgl_regs.cu",
                    "replaces": "jepsen_tpu/ops/wgl_seg.py:700",
                    "launches": seg_launches["wgl_compose"],
                    "max_abs_err": compose_err,
                    "ms": seg["compose"]["ms"],
                    "device_ms": seg["compose"]["device_ms"],
                    "plain_ms": seg["compose"]["plain_ms"],
                    "bound_ms": seg["compose"]["bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": seg["compose"]["library_ms"]})
    for name, kind in (("wgl_regs_crash", "crash"),
                       ("wgl_regs_relaxed", "relaxed")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "jepsen_tpu_torch/csrc/wgl_crash.cu",
                        "replaces": "jepsen_tpu/ops/wgl_seg.py:258",
                        "launches": crash_launches[name],
                        "max_abs_err": max(crash_err[kind],
                                           crash[kind]["err"]),
                        "ms": crash[kind]["ms"],
                        "device_ms": crash[kind]["device_ms"],
                        "plain_ms": crash[kind]["plain_ms"],
                        "bound_ms": crash[kind]["bound_ms"],
                        "bound_by": "operations", "library_ms": None})
    kernels.append({"name": "wgl_regs_keys", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/wgl_regs.cu",
                    "replaces": "jepsen_tpu/ops/wgl_seg.py:725",
                    "launches": many_launches, "max_abs_err": keys["err"],
                    "ms": keys["ms"], "device_ms": keys["device_ms"],
                    "plain_ms": keys["plain_ms"],
                    "bound_ms": keys["bound_ms"],
                    "bound_by": "operations", "library_ms": None})
    kernels.append({"name": "wgl_frontier", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/wgl_frontier.cu",
                    "replaces": "jepsen_tpu/ops/wgl.py:212",
                    "launches": serial_launches,
                    "max_abs_err": max(serial_err, serial["err"],
                                       serial_first["err"]),
                    "ms": serial["ms"], "device_ms": serial["device_ms"],
                    "plain_ms": serial["plain_ms"],
                    "bound_ms": serial["bound_ms"],
                    "bound_by": serial["bound_by"], "library_ms": None,
                    "F": serial["F"], "plain_on": "cuda",
                    "ctas": serial["ctas"], "rounds_by_form": serial["forms"],
                    "first_walk": {k: serial_first[k] for k in (
                        "F", "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by")}})
    figures = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
    kernels.append({"name": "elle_pmm", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/elle_pmm.cu",
                    "replaces": "jepsen_tpu/ops/elle_mesh.py:261",
                    "launches": elle_launches["elle_pmm"]
                    + cyc["launches"]["elle_pmm"]
                    + lat_launches["elle_pmm"],
                    "launches_by_path": {
                        "elle-check": elle_launches["elle_pmm"],
                        "cycle": cyc["launches"]["elle_pmm"],
                        "lattice": lat_launches["elle_pmm"]},
                    "cycle_closures": cyc["closures"],
                    "max_abs_err": elle["err"],
                    **{k: elle["last"][k] for k in figures},
                    "first_round": {k: elle["first"][k] for k in figures},
                    "closure": elle["closure"]})
    kernels.append({"name": "elle_tile_bits", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/elle_pmm.cu",
                    "replaces": "jepsen_tpu/ops/elle_mesh.py:261",
                    "launches": elle_launches["elle_tile_bits"]
                    + cyc["launches"]["elle_tile_bits"]
                    + lat_launches["elle_tile_bits"],
                    "launches_by_path": {
                        "elle-check": elle_launches["elle_tile_bits"],
                        "cycle": cyc["launches"]["elle_tile_bits"],
                        "lattice": lat_launches["elle_tile_bits"]},
                    "max_abs_err": elle["tile_bits"]["err"],
                    **{k: elle["tile_bits"][k] for k in figures}})
    kernels.append({"name": "fold_member", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/fold.cu",
                    "replaces": "jepsen_tpu/ops/fold.py:24",
                    "launches": fold["launches"], "max_abs_err": fold["err"],
                    **{k: fold[k] for k in figures},
                    "dups": {k: fold["dups"][k] for k in figures},
                    "minus": {k: fold["minus"][k] for k in figures}})
    kernels.append({"name": "cycle_labels", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/cycle.cu",
                    "replaces": "jepsen_tpu/ops/cycle.py:64",
                    "launches": cyc["launches"]["cycle_labels"],
                    "max_abs_err": cyc["err"],
                    **{k: cyc[k] for k in figures},
                    "at_dsg": {k: cyc["at_dsg"][k]
                               for k in figures + ("n_pad",)}})
    kernels.append({"name": "lattice_masks", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/lattice_masks.cu",
                    "replaces": "jepsen_tpu/lattice/engine.py:352",
                    "launches": lat_launches["lattice_masks"],
                    "max_abs_err": lat["err"],
                    **{k: lat[k] for k in figures},
                    "lattice_closure": {
                        "rounds": lat["closure"]["closure"]["rounds"],
                        **{w: {k: lat["closure"][w][k] for k in figures}
                           for w in ("first", "last")},
                        "summed": {k: lat["closure"]["closure"][k]
                                   for k in ("ms", "device_ms", "bound_ms",
                                             "bound_by")}}})
    for form in ("bits", "dense"):
        kernels.append({"name": f"wgl_cand_{form}", "route": "cuda",
                        "source": "jepsen_tpu_torch/csrc/wgl_cand.cu",
                        "replaces": ("jepsen_tpu/ops/wgl_seg.py:105"
                                     if form == "bits" else
                                     "jepsen_tpu/ops/wgl_seg.py:787"),
                        "launches": cand_launches[f"wgl_cand_{form}"],
                        "max_abs_err": max(cand_err[form],
                                           cand[form]["err"]),
                        **{k: cand[form][k] for k in figures
                           if k != "library_ms"},
                        "library_ms": None})
    kernels.append({"name": "wgl_regs_relaxed_w2", "route": "cuda",
                    "source": "jepsen_tpu_torch/csrc/wgl_crash.cu",
                    "replaces": "jepsen_tpu/ops/wgl_seg.py:565",
                    "launches": w2_launches, "max_abs_err": w2["err"],
                    **{k: w2[k] for k in figures if k != "library_ms"},
                    "library_ms": None, "plain_on": "cuda",
                    "death_row": w2["death"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
