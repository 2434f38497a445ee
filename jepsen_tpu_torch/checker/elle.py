"""Elle-style transactional isolation checker: the verdict layer (the
JAX package's `checker/elle.py`).

Maps the anomalies that inference (`elle.infer`) and the closure tiers
(`ops.elle_graph`, dense; `ops.elle_mesh`, bit-packed on the kernel
`elle_pmm`) find onto Adya's isolation hierarchy and the Checker
protocol:

  * every verdict names the **weakest violated consistency model**
    (`lattice.weakest_violated`) plus the Adya levels ruled out (`not`,
    Elle's :not field);
  * the tier is `ops.planner.plan_elle`'s: "auto" takes the packed tier
    (`elle-mesh`) at `mesh_threshold` transactions and the dense tier
    (`elle-device`) below it; "mesh" and "device" are strict; "host"
    runs the numpy oracle (`elle-host`) because the caller asks for it.
    The card tiers run on `device`, the card by default: without one
    they raise BackendUnavailable, and a failing build or launch
    raises.  Nothing degrades to a lower tier;
  * verdicts carry a dispatch record (engine, why, batch, device,
    n_max, n_pad, rounds, shards) and stage seconds (`stages`: infer_s,
    classify_s and round_s as the reference's, and the port's split of
    classify_s: stack_s, pack_s, transfer_s, then rounds_s and
    tpose_pick_s (packed) or closure_s (dense); verdict_s, the witness
    walks);
  * `batch_checker()` is the key-independent form: every per-key
    subhistory one history of one `check_many` call.

The reference's resilient runner (OOM bisection, quarantine) is ROADMAP
P4R: `check_many` runs its groups of `max_group` directly, and an OOM
raises.  The `elle.txt` render is P6's."""

from __future__ import annotations

import time
from typing import Optional

from jepsen_tpu_torch import lattice
from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.checker import Checker, merge_valid
from jepsen_tpu_torch.elle import infer as infer_mod
from jepsen_tpu_torch.errors import Unsupported
from jepsen_tpu_torch.ops import elle_graph, elle_mesh, planner

# Adya's lattice, weakest first.  An anomaly maps to the WEAKEST level
# that proscribes it; finding one rules out that level and everything
# stronger.
ISOLATION_LEVELS = ("read-uncommitted", "read-committed",
                    "snapshot-isolation", "serializable")

ANOMALY_LEVEL = {
    # dirty writes / double-installs break even read-uncommitted
    "G0": "read-uncommitted",
    "duplicate-elements": "read-uncommitted",
    # the G1 family (plus observations no version order can explain)
    # break read-committed
    "G1a": "read-committed",
    "G1b": "read-committed",
    "G1c": "read-committed",
    "incompatible-order": "read-committed",
    "cyclic-version-order": "read-committed",
    # a dirty/garbage predicate read breaks read-committed
    "G1-predicate": "read-committed",
    # a single anti-dependency cycle is read skew: breaks SI
    "G-single": "snapshot-isolation",
    # ≥2 anti-dependencies is write skew: breaks serializability only
    "G2-item": "serializable",
}

ALL_ANOMALIES = tuple(sorted(ANOMALY_LEVEL))


def violated_levels(found) -> list:
    """Adya-chain levels ruled out by the found anomaly types, weakest
    first: the full-lattice `not` list projected onto ISOLATION_LEVELS,
    so session/causal classes surface the chain levels they
    transitively rule out."""
    return [m for m in lattice.violated_models(found)
            if m in ISOLATION_LEVELS]


def weakest_violated(found) -> Optional[str]:
    """The weakest violated consistency model over the FULL lattice;
    on pure-Adya anomaly sets exactly the chain answer."""
    return lattice.weakest_violated(found)


class Elle(Checker):
    """Transactional isolation checker.

    workload: "list-append" | "rw-register" | "auto" (sniff micro-ops)
    anomalies: subset of anomaly types to FAIL on (default all);
        everything found is always reported.
    include_order: include the process/realtime order planes in every
        cycle combination (strict/strong-session flavor).  With False,
        pure Adya item anomalies only.
    algorithm: "auto" (packed above mesh_threshold txns, else dense),
        "mesh" (bit-packed `ops.elle_mesh`), "device" (dense
        `ops.elle_graph`), "host" (the numpy oracle).
    mesh_threshold: txn count at which "auto" takes the packed tier.
    host_deadline_s: wall budget of the numpy oracle (algorithm
        "host"): past it a history gets an `unknown` verdict.
    max_group: histories a dispatch on the batched path.
    device: where the card tiers run; None is the card.
    max_retries: the reference runner's; any other value than 2 raises
        Unsupported (ROADMAP P4R).
    """

    def __init__(self, workload: str = "auto", anomalies=None,
                 include_order: bool = True, algorithm: str = "auto",
                 max_retries: int = 2, max_group: int = 8,
                 mesh_threshold: int = 8192,
                 host_deadline_s: Optional[float] = 120.0, device=None):
        self.workload = workload
        self.anomalies = set(anomalies if anomalies is not None
                             else ALL_ANOMALIES)
        unknown = self.anomalies - set(ALL_ANOMALIES)
        if unknown:
            raise ValueError(f"unknown anomaly type(s): {sorted(unknown)}")
        self.include_order = include_order
        if algorithm not in ("auto", "mesh", "device", "host"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if max_retries != 2:
            raise Unsupported(f"max_retries: {planner.ITEM_RUNNER}")
        self.algorithm = algorithm
        self.max_retries = max_retries
        self.max_group = max_group
        self.mesh_threshold = mesh_threshold
        self.host_deadline_s = host_deadline_s
        self.device = device

    def _device(self):
        """The card tiers' device (raises BackendUnavailable without a
        card unless the caller named the CPU); None for "host"."""
        return None if self.algorithm == "host" \
            else resolve_device(self.device)

    # -- engine ---------------------------------------------------------------

    def _engine(self, inferences, dev, infer_s: float = 0.0) -> list:
        """Stacks -> classification on the planned tier -> verdicts,
        each with the dispatch record and stage seconds."""
        t0 = time.monotonic()
        stacks = [inf.stacked() for inf in inferences]
        split: dict = {"stack_s": time.monotonic() - t0}
        n_max = max((inf.n for inf in inferences), default=0)
        record = planner.plan_elle(n_max, batch=len(inferences),
                                   algorithm=self.algorithm,
                                   mesh_threshold=self.mesh_threshold)
        engine = record["engine"]
        if engine == "elle-mesh":
            # packed planes come from the inference edge lists (sparse
            # word insertion), not a re-pack of the dense stacks
            rows = elle_mesh.classify_mesh(
                stacks, include_order=self.include_order, device=dev,
                inferences=inferences, stats=split)
        elif engine == "elle-device":
            rows = elle_graph.classify_batch(
                stacks, include_order=self.include_order, device=dev,
                stats=split)
        else:
            rows = [self._host_fallback(s) for s in stacks]
        classify_s = time.monotonic() - t0
        stages = {"infer_s": infer_s, "classify_s": classify_s}
        rounds = [r.get("rounds") for r in rows if r.get("rounds")]
        if rounds:
            stages["round_s"] = classify_s / max(sum(rounds), 1)
        stages.update(split)
        t1 = time.monotonic()
        out = [self._verdict(inf, stack, row, engine)
               for inf, stack, row in zip(inferences, stacks, rows)]
        stages["verdict_s"] = time.monotonic() - t1
        backend = "cpu" if dev is None else dev.type
        self._attach_dispatch(out, record, n_max, stages, backend)
        for v in out:
            v.setdefault("backend", backend)
        return out

    def _host_fallback(self, stack, time_limit=None) -> dict:
        """One history's row from the deadline-capped numpy oracle
        (algorithm "host" only: no tier falls to it)."""
        deadline = time_limit if time_limit is not None \
            else self.host_deadline_s
        return elle_graph.classify_host(
            stack, include_order=self.include_order, deadline_s=deadline)

    # -- verdict shaping ------------------------------------------------------

    def _edge_label(self, inf, a: int, b: int, defining: bool) -> str:
        types = set(inf.edge_types.get((a, b), ()))
        if inf.planes["po"][a, b]:
            types.add("po")
        if inf.planes["rt"][a, b]:
            types.add("rt")
        if defining and "rw" in types:
            return "rw"
        # prefer the non-rw reading so rw counts stay conservative
        for t in ("ww", "wr", "po", "rt", "rw"):
            if t in types:
                return t
        return "?"

    def _verdict(self, inf, stack, row, engine: str) -> dict:
        if row.get("unknown"):
            # the oracle hit its deadline: an `unknown` verdict merges
            # through the validity lattice without masking real invalids
            out = {"valid?": "unknown",
                   "degraded": row.get("degraded"),
                   "anomaly-types": [], "anomalies": {},
                   "failing-anomaly-types": [],
                   "txn-count": inf.n, "workload": inf.workload,
                   "weakest-violated": None, "not": [],
                   "engine": engine, "elle": dict(inf.meta)}
            for k in ("deadline_s", "elapsed_s", "rw_probed"):
                if k in row:
                    out[k] = row[k]
            return out
        found: dict = {k: list(v) for k, v in inf.direct.items()}
        for cls, edge in row["anomalies"].items():
            cyc = elle_graph.find_witness(
                stack, cls, edge, include_order=self.include_order)
            if cyc is None:         # the tier flagged it; a witness must exist
                found.setdefault(cls, []).append(
                    {"edge": list(edge), "witness": "unrecovered"})
                continue
            labels = [
                self._edge_label(inf, x, y,
                                 defining=(j == 0 and (x, y) == tuple(edge)))
                for j, (x, y) in enumerate(zip(cyc, cyc[1:]))]
            found.setdefault(cls, []).append({
                "cycle": [inf.txns[i][1].to_dict() for i in cyc],
                "steps": list(map(int, cyc)),
                "edges": labels})
        bad = sorted(set(found) & self.anomalies)
        out = {
            "valid?": not bad,
            "anomaly-types": sorted(found),
            "anomalies": found,
            "failing-anomaly-types": bad,
            "txn-count": inf.n,
            "workload": inf.workload,
            "weakest-violated": weakest_violated(found),
            "not": violated_levels(found),
            "engine": engine,
            "elle": dict(inf.meta),
        }
        for k in ("rounds", "shards"):     # packed-tier provenance
            if k in row:
                out[k] = row[k]
        return out

    def _attach_dispatch(self, results, record: dict, n_max: int,
                         stages: Optional[dict], backend: str) -> None:
        rec = dict(record, device=backend)
        if rec["engine"] == "elle-mesh":
            rounds = [r["rounds"] for r in results if "rounds" in r]
            rec.update(n_pad=elle_mesh.pad_for_mesh(max(n_max, 1)),
                       rounds=max(rounds) if rounds else None, shards=1)
        else:
            rec.update(n_pad=elle_graph._pad_to_tile(max(n_max, 1)),
                       rounds=None, shards=None)
        st = None if stages is None else {
            k: round(float(v), 6) for k, v in stages.items()}
        for r in results:
            if "dispatch" not in r:
                r["dispatch"] = rec
                if st is not None:
                    r["stages"] = st

    # -- Checker protocol -----------------------------------------------------

    def check_many(self, test, histories, opts=None) -> list:
        """Batched classification of MANY txn histories: one dispatch
        per group of `max_group`."""
        del test
        dev = self._device()
        t0 = time.monotonic()
        infs = [infer_mod.infer(h, workload=self.workload)
                for h in histories]
        infer_s = (time.monotonic() - t0) / max(len(infs), 1)
        out: list = []
        for k in range(0, len(infs), self.max_group):
            out += self._engine(infs[k:k + self.max_group], dev,
                                infer_s=infer_s)
        return out

    def check(self, test, history, opts=None):
        dev = self._device()
        t0 = time.monotonic()
        inf = infer_mod.infer(history, workload=self.workload)
        infer_s = time.monotonic() - t0
        if inf.n == 0:
            a = self._verdict(inf, inf.stacked(),
                              {"anomalies": {}, "n": 0, "n_pad": 0},
                              "elle-host")
            self._attach_dispatch(
                [a], {"engine": "elle-host", "why": "no committed txns",
                      "batch": 1, "n_max": 0}, 0, None,
                "cpu" if dev is None else dev.type)
            return a
        return self._engine([inf], dev, infer_s=infer_s)[0]


def checker(workload: str = "auto", **kw) -> Elle:
    return Elle(workload=workload, **kw)


# ---------------------------------------------------------------------------
# Key-independent batching: every per-key subhistory one history
# ---------------------------------------------------------------------------

class BatchedElleChecker(Checker):
    """`independent.batch_checker` for txn workloads: split the keyed
    history, infer planes per key, classify every key through one
    `Elle.check_many`, merge through the validity lattice."""

    def __init__(self, sub: Optional[Elle] = None, **kw):
        self.sub = sub if sub is not None else Elle(**kw)

    def check(self, test, history, opts=None):
        from jepsen_tpu_torch import independent

        ks = sorted(independent.history_keys(history), key=repr)
        if not ks:
            return {"valid?": True, "results": {}, "failures": []}
        subs = [independent.subhistory(k, history) for k in ks]
        per_key = self.sub.check_many(test, subs, opts)
        results = dict(zip(ks, per_key))
        failures = [k for k, r in results.items()
                    if r["valid?"] is not True]
        return {"valid?": merge_valid(r["valid?"]
                                      for r in results.values()),
                "results": results,
                "failures": failures}


def batch_checker(workload: str = "auto", **kw) -> BatchedElleChecker:
    return BatchedElleChecker(Elle(workload=workload, **kw))
