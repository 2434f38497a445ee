"""Full-lattice post-hoc checker (the JAX package's `lattice/checker.py`).

`LatticeChecker` is the Checker-protocol face of the lattice engine:
infer the base planes, lower them to the 8-plane stack (`planes`),
classify on the planned tier (`engine.classify`: the packed tier at
`mesh_threshold` transactions and above, the dense tier below, the
numpy oracle when the caller asks for "host"), then the verdict.  The
verdict has `checker.elle`'s shape (`valid?`, `anomalies` with
recovered witness cycles, `weakest-violated`, `not`) over the full
consistency lattice: session guarantees, PRAM, causal, long fork and
the predicate classes join Adya's chain, and `weakest-violated` / `not`
name models of `lattice.MODELS`.  It carries a dispatch record (engine,
why, batch, n_max, device, n_pad, rounds, shards) and stage seconds
(`stages`: infer_s, planes_s, the tier's pack_s or stack_s, transfer_s,
rounds_s, tpose_s and masks_s (packed) or closure_s (dense), and
witness_s)."""

from __future__ import annotations

import time

from jepsen_tpu_torch.backend import resolve_device
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.elle import infer as infer_mod
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.lattice import engine as engine_mod
from jepsen_tpu_torch.lattice import lattice as lattice_mod
from jepsen_tpu_torch.lattice import planes as planes_mod
from jepsen_tpu_torch.ops import planner


class LatticeChecker(Checker):
    """Classify one txn history over the full consistency lattice.

    workload: "list-append" | "rw-register" | "auto" (sniffed)
    anomalies: subset of classes to FAIL on (default: every class the
        engine or the direct passes can name); everything found is
        always reported.
    algorithm / mesh_threshold: the tier, as `planner.plan_lattice`
        ("auto" takes the packed tier at mesh_threshold txns and above).
    device: where the card tiers run; None is the card.
    devices: the reference's device list; one device is taken as
        `device`, more raise Unsupported (ROADMAP P8).
    """

    def __init__(self, workload: str = "auto", anomalies=None,
                 algorithm: str = "auto", mesh_threshold: int = 4096,
                 devices=None, device=None):
        self.workload = workload
        self.anomalies = (None if anomalies is None
                          else set(anomalies))
        if algorithm not in ("auto", "mesh", "device", "host"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if devices is not None:
            devices = list(devices)
            if len(devices) > 1:
                raise Unsupported(f"devices: {planner.ITEM_MESH}")
            if not devices:
                raise BackendUnavailable("an empty device list")
            device = devices[0]
        self.algorithm = algorithm
        self.mesh_threshold = mesh_threshold
        self.device = device

    def _device(self):
        """The card tiers' device (raises BackendUnavailable without a
        card unless the caller named the CPU); None for "host"."""
        return None if self.algorithm == "host" \
            else resolve_device(self.device)

    def check(self, test, history, opts=None) -> dict:
        del test, opts
        dev = self._device()
        t0 = time.perf_counter()
        inf = infer_mod.infer(history, workload=self.workload)
        t1 = time.perf_counter()
        lp = planes_mod.from_inference(inf)
        stages = {"infer_s": t1 - t0, "planes_s": time.perf_counter() - t1}
        return self._check_planes(lp, inf, dev, stages)

    def check_planes(self, lp: planes_mod.LatticePlanes,
                     inf: infer_mod.Inference,
                     infer_s: float = 0.0) -> dict:
        return self._check_planes(lp, inf, self._device(),
                                  {"infer_s": infer_s})

    def _check_planes(self, lp, inf, dev, stages: dict) -> dict:
        row, engine, record = engine_mod.classify(
            lp, algorithm=self.algorithm,
            mesh_threshold=self.mesh_threshold, device=dev, stats=stages)
        t = time.perf_counter()
        found: dict = {k: list(v) for k, v in inf.direct.items()}
        stack = lp.stacked()
        for cls, edge in row["anomalies"].items():
            cyc = engine_mod.find_witness(stack, cls, edge)
            if cyc is None:         # the tier flagged it; a witness must exist
                found.setdefault(cls, []).append(
                    {"edge": [int(edge[0]), int(edge[1])],
                     "witness": "unrecovered"})
                continue
            found.setdefault(cls, []).append({
                "cycle": [inf.txns[i][1].to_dict() for i in cyc],
                "steps": list(map(int, cyc)),
            })
        stages["witness_s"] = time.perf_counter() - t
        bad = sorted(set(found) & self.anomalies
                     if self.anomalies is not None else found)
        out = {
            "valid?": not bad,
            "anomaly-types": sorted(found),
            "anomalies": found,
            "failing-anomaly-types": bad,
            "txn-count": lp.n,
            "workload": inf.workload,
            "weakest-violated": lattice_mod.weakest_violated(found),
            "not": lattice_mod.violated_models(found),
            "engine": engine,
            "lattice": dict(lp.meta),
        }
        for k in ("rounds", "n_pad", "shards"):
            if row.get(k) is not None:
                out[k] = row[k]
        out["dispatch"] = dict(
            record, planes=len(planes_mod.LATTICE_PLANES),
            device="cpu" if dev is None else dev.type,
            n_pad=row.get("n_pad"), rounds=row.get("rounds"),
            shards=row.get("shards"))
        out["stages"] = {k: round(float(v), 6) for k, v in stages.items()}
        return out


def checker(workload: str = "auto", **kw) -> LatticeChecker:
    return LatticeChecker(workload=workload, **kw)


def classify_history(history, workload: str = "auto",
                     **kw) -> dict:
    """One-shot convenience: history -> full-lattice verdict."""
    return LatticeChecker(workload=workload, **kw).check(
        None, history)
