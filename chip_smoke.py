"""Smoke run of jepsen_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing what it measured on its own line; any failure
exits non-zero:

  1. device  - the card, and nvidia-smi's name and power limit;
  2. build   - nvcc builds csrc/wgl_deep.cu for sm_90a (timed); ptxas
               registers and spill bytes of each kernel instantiation
               (warp arm <SnP>, block arm <SnP>); a warp-arm spill fails;
  3. kernel  - each arm against the plain PyTorch version (on CPU
               copies of the same inputs) on 600-call histories at its
               edges and plane sizes: warp arm R = 3, 5, 8, 10 (twice),
               block arm R = 11 (twice), 12, 14, 15, 16 (twice), with
               SnP 8, 16 and 32 on each arm (vmax picks the model's
               states) and the global-memory plane at R = 16, SnP = 32;
               one valid and one planted-invalid history each: verdict,
               first dead row and plane words touched; kernel time (CUDA
               events) and bound per case; the R = 3 verdicts also
               against the exact CPU oracle;
  4. main    - the deep-overlap envelope at full size: 16 etcd-shaped
               register histories of 20,000 calls (concurrency 16, vmax
               9, read/read/write/cas) per depth max_open 8/10/12/14,
               through check_pipeline and Linearizable, plus planted
               stale reads at 90% depth (through Linearizable, and in
               one grid of mixed depths) whose exact witness must come
               back; the kernel launches of each arm are counted;
  5. grid    - the main path's grids rebuilt on the host exactly as
               check_pipeline built them (one aux table, mixed depths
               under one plane stride), launched once more: every CTA's
               verdict must equal the main path's, the mixed grid must
               launch both arms, and chosen CTAs (depth 8, 10, 12, both
               depths 13 and 14 of the depth-14 grid, and the planted
               histories of the mixed grid) must equal the plain version
               on CPU copies of the same device inputs, in worker
               processes;
  6. timing  - per arm, the kernel, its plain version and the bound on
               one main-path history (depth 8 on the warp arm, depth 12
               on the block arm), as the JSON kernel line.

The last line is {"ok": true, "device": {...}}.  Exits non-zero with
no result line when torch.cuda.is_available() is false or the package
is missing."""

from __future__ import annotations

import json
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

def make_history(n_ops, concurrency, seed, vmax=9, max_open=0, burst=0):
    """A register workload (read/read/write/cas) executed against a
    sequential in-memory register with process interleaving, bounded to
    `max_open` simultaneously-open calls; `n_ops` counts calls.  With
    `burst`, that many writes open together at the end, so the overlap
    depth is at least `burst`."""
    from jepsen_tpu_torch.history import (History, fail_op, invoke_op,
                                          ok_op)
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


def plant_stale_read(h, frac, vmax):
    """Rewrite one ok-read at `frac` depth to a legal value w that no
    linearization can produce: w is neither the register value at the
    read's invoke nor written by any call that can linearize inside the
    read's window.  Returns the op index of the read's INVOKE (the
    exact witness), or None."""
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
        w = next((x for x in range(vmax + 1) if x not in V), None)
        if w is None:
            continue
        ops[i].value = w
        return ops[lo].index
    return None


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
    from jepsen_tpu_torch.ops import deep_kernel
    t = time.perf_counter()
    lib = deep_kernel.build()
    deep_kernel._load()
    dt = time.perf_counter() - t
    ptxas = lib.parent / (lib.stem + ".ptxas.txt")
    kernels = ptxas_kernels(ptxas.read_text() if ptxas.exists() else "")
    if not kernels:
        raise SystemExit("[build] ptxas reported no kernel")
    log(f"[build] {lib.name} in {dt:.2f} s; ptxas: " + " | ".join(
        f"{k}: {v['regs']} registers, spill {v['spill']} bytes"
        for k, v in kernels.items()))
    spilled = [k for k, v in kernels.items()
               if k.startswith("wgl_warp") and v["spill"]]
    if spilled:
        raise SystemExit(f"[build] the register plane spills: {spilled}")


def ptxas_kernels(text):
    """{kernel<SnP>: {"regs": n, "spill": store + load bytes}} from
    `nvcc -Xptxas -v` output."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"entry function '_Z\d+(\w+?)ILi(\d+)E", ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            out[name] = {"regs": None, "spill": 0}
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
    return out


def tables_for(h, max_open_bits=16):
    """The port's host path for one history: scan, states, tables, wire.
    Returns (cbuf u8, G, aux i32, R, Sn, UP, fk, ret_t)."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import deep_kernel, planner, wgl_deep
    model = CASRegister()
    spec = model.device_spec()
    seen, rows = {}, []
    fk = planner._fast_scan(h, spec, seen, rows, max_open_bits)
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
    dead row), plane words touched, kernel ms by CUDA events)."""
    from jepsen_tpu_torch.ops import deep_kernel
    args, kw = walk_inputs(t, "cuda")
    work = torch.zeros(1, dtype=torch.int64, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    out = deep_kernel.deep_walk(*args, work=work, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    return (tuple(int(x) for x in out[0].cpu()), int(work.item()),
            ev[0].elapsed_time(ev[1]))


def abs_err(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


# (R, vmax) of phase 3: each arm at its edges and at SnP 8, 16 and 32
# (vmax 6 / 9 / 30 give 8 / 11 / 32 model states)
KERNEL_CASES = [(3, 6), (5, 30), (8, 9), (10, 30), (10, 6),
                (11, 30), (11, 6), (12, 9), (14, 6), (15, 30), (16, 9),
                (16, 30)]


def phase_kernel(clock_hz):
    """Each case on the card and in the plain version; returns the
    largest disagreement per arm."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import deep_kernel, wgl_cpu, wgl_deep
    seen = set()
    err = {"warp": 0, "block": 0}
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
            snp = wgl_deep._snp(t[4])
            arm = deep_kernel.arm_of(R)
            plane = deep_kernel.launch_plan(arm, R, snp)["plane"]
            seen.add((arm, snp))
            seen.add(plane)
            card, words, ms = timed_walk(t)
            work_plain = torch.zeros(1, dtype=torch.int64)
            t1 = time.perf_counter()
            plain = run_walk(t, "cpu", work=work_plain)
            plain_s = time.perf_counter() - t1
            err[arm] = max(err[arm], abs_err(card, plain))
            ok = (card == plain and words == int(work_plain.item())
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
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for (args, kw), w in zip(ins, work):
            deep_kernel.deep_walk(*args, work=w, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        serial_ms = ev[0].elapsed_time(ev[1])
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
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for _ in range(reps):
                deep_kernel.deep_walk(*args, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1]) / reps
            b = bound_ms(words, t[0].nbytes + t[2].nbytes, clock_hz)
            res[arm] = dict(card=card, words=words, ms=ms, bound_ms=b)
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
                f"{r['ms']:.3f} ms (mean of {reps} launches), plain (CPU, "
                f"one thread) {r['plain_ms']:.1f} ms, bound "
                f"{r['bound_ms']:.4f} ms from {r['words']} plane words")
    return res


def main() -> int:
    smi, clock_hz = phase_device()
    phase_build()
    err = phase_kernel(clock_hz)
    batches, verdicts, launches = phase_main()
    grid_err = phase_grid(batches, verdicts)
    one = phase_timing(batches, clock_hz)
    kernels = [{"name": f"wgl_deep_{arm}", "route": "cuda",
                "source": "jepsen_tpu_torch/csrc/wgl_deep.cu",
                "replaces": "jepsen_tpu/ops/wgl_deep.py:358",
                "launches": launches[arm],
                "max_abs_err": max(err[arm], grid_err[arm],
                                   one[arm]["err"]),
                "ms": one[arm]["ms"], "plain_ms": one[arm]["plain_ms"],
                "bound_ms": one[arm]["bound_ms"], "bound_by": "bytes",
                "library_ms": None} for arm in ("warp", "block")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
