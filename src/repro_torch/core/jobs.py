"""Job and workload containers.

A copy of ``repro.core.jobs`` so the port imports nothing of ``repro``.
A :class:`Workload` is a structure-of-arrays over jobs — the layout the
batched engine and its CUDA kernels operate on directly.  JSON import/export follows the ElastiSim job format
(the paper converts cleaned traces to exactly this shape, §2.2).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, Optional

import numpy as np

# Job state codes used by the simulators.
PENDING = 0   # not yet submitted
QUEUED = 1    # submitted, waiting
RUNNING = 2
DONE = 3

# Workload-class codes (scenario axis, see repro_torch.core.scenario.JobClasses).
CLASS_NORMAL = 0     # eligible for the rigid->malleable transform
CLASS_RIGID = 1      # pinned rigid: never transformed, normal queue rank
CLASS_ON_DEMAND = 2  # pinned rigid + queue priority (Fan & Lan on-demand)


@dataclasses.dataclass
class Workload:
    """Structure-of-arrays job container.

    All arrays share length ``n``.  Times are seconds from simulation start.

    Attributes:
      submit: submission timestamps (float64, sorted not required).
      runtime: *actual* runtime at the reference allocation ``nodes_req``
        (what the trace recorded).
      walltime: user-requested runtime limit.  The paper sets missing limits
        to 125% of runtime (§2.2); generators follow that rule.
      nodes_req: rigid node request == reference allocation for the speedup
        model.
      malleable: whether the scheduler may resize this job.
      min_nodes/max_nodes/pref_nodes: malleable resize range and the
        preferred allocation (speed/efficiency trade-off, Downey [5]).
        For rigid jobs all three equal ``nodes_req``.
      pfrac: per-job Amdahl parallel fraction used by the speedup model.
      job_class: workload class (CLASS_NORMAL / CLASS_RIGID /
        CLASS_ON_DEMAND).  Normal jobs are eligible for the
        rigid->malleable transform; the other classes are pinned rigid and
        on-demand jobs additionally take queue priority over every
        non-on-demand waiting job (see ``repro_torch.core.scenario.JobClasses``).
    """

    submit: np.ndarray
    runtime: np.ndarray
    walltime: np.ndarray
    nodes_req: np.ndarray
    malleable: np.ndarray
    min_nodes: np.ndarray
    max_nodes: np.ndarray
    pref_nodes: np.ndarray
    pfrac: np.ndarray
    job_class: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        n = len(self.submit)
        self.submit = np.asarray(self.submit, dtype=np.float64)
        self.runtime = np.asarray(self.runtime, dtype=np.float64)
        self.walltime = np.asarray(self.walltime, dtype=np.float64)
        self.nodes_req = np.asarray(self.nodes_req, dtype=np.int64)
        self.malleable = np.asarray(self.malleable, dtype=bool)
        self.min_nodes = np.asarray(self.min_nodes, dtype=np.int64)
        self.max_nodes = np.asarray(self.max_nodes, dtype=np.int64)
        self.pref_nodes = np.asarray(self.pref_nodes, dtype=np.int64)
        self.pfrac = np.asarray(self.pfrac, dtype=np.float64)
        if self.job_class is None:
            self.job_class = np.zeros(n, dtype=np.int8)
        self.job_class = np.asarray(self.job_class, dtype=np.int8)
        for f in dataclasses.fields(self):
            arr = getattr(self, f.name)
            if len(arr) != n:
                raise ValueError(f"field {f.name} has length {len(arr)} != {n}")

    # ------------------------------------------------------------------
    @property
    def n_jobs(self) -> int:
        return len(self.submit)

    @property
    def on_demand(self) -> np.ndarray:
        """Boolean mask of on-demand (queue-priority rigid) jobs."""
        return self.job_class == CLASS_ON_DEMAND

    @property
    def transformable(self) -> np.ndarray:
        """Boolean mask of jobs the malleable transform may convert."""
        return self.job_class == CLASS_NORMAL

    def validate(self, cluster_nodes: Optional[int] = None) -> None:
        """Raise if the workload violates basic invariants."""
        w = self
        if np.any(w.runtime <= 0):
            raise ValueError("non-positive runtime")
        if np.any(w.walltime < w.runtime):
            raise ValueError("walltime below runtime")
        if np.any(w.nodes_req < 1):
            raise ValueError("nodes_req < 1")
        if np.any(w.min_nodes < 1):
            raise ValueError("min_nodes < 1")
        if np.any(w.min_nodes > w.pref_nodes) or np.any(w.pref_nodes > w.max_nodes):
            raise ValueError("need min <= pref <= max")
        rigid = ~w.malleable
        for name in ("min_nodes", "max_nodes", "pref_nodes"):
            if np.any(getattr(w, name)[rigid] != w.nodes_req[rigid]):
                raise ValueError(f"rigid jobs must have {name} == nodes_req")
        if np.any((w.job_class < CLASS_NORMAL)
                  | (w.job_class > CLASS_ON_DEMAND)):
            raise ValueError("unknown job_class code")
        if np.any(w.malleable & (w.job_class != CLASS_NORMAL)):
            raise ValueError("class-pinned jobs must stay rigid")
        if cluster_nodes is not None:
            if np.any(w.min_nodes > cluster_nodes):
                raise ValueError("job min_nodes exceeds cluster capacity")
            if np.any(w.nodes_req[rigid] > cluster_nodes):
                raise ValueError("rigid job exceeds cluster capacity")
        if np.any((w.pfrac < 0) | (w.pfrac >= 1.0)):
            raise ValueError("pfrac must lie in [0, 1)")

    # ------------------------------------------------------------------
    @staticmethod
    def rigid(submit, runtime, nodes_req, walltime=None) -> "Workload":
        """Build a fully-rigid workload (the paper's 0%-malleable baseline)."""
        submit = np.asarray(submit, dtype=np.float64)
        runtime = np.asarray(runtime, dtype=np.float64)
        nodes_req = np.asarray(nodes_req, dtype=np.int64)
        if walltime is None:
            walltime = 1.25 * runtime  # paper §2.2: missing limits -> 125%
        n = len(submit)
        return Workload(
            submit=submit,
            runtime=runtime,
            walltime=np.asarray(walltime, dtype=np.float64),
            nodes_req=nodes_req,
            malleable=np.zeros(n, dtype=bool),
            min_nodes=nodes_req.copy(),
            max_nodes=nodes_req.copy(),
            pref_nodes=nodes_req.copy(),
            pfrac=np.full(n, 0.9),
        )

    def copy(self) -> "Workload":
        return Workload(**{
            f.name: getattr(self, f.name).copy() for f in dataclasses.fields(self)
        })

    def take(self, idx) -> "Workload":
        return Workload(**{
            f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)
        })

    # ------------------------------------------------------------------
    # ElastiSim-style JSON I/O (paper §2.2 converts traces to JSON jobs).
    def to_json(self) -> str:
        jobs = []
        for i in range(self.n_jobs):
            d: Dict[str, Any] = {
                "id": i,
                "submit_time": float(self.submit[i]),
                "runtime": float(self.runtime[i]),
                "time_limit": float(self.walltime[i]),
                "num_nodes": int(self.nodes_req[i]),
                "type": "malleable" if self.malleable[i] else "rigid",
            }
            if self.job_class[i] != CLASS_NORMAL:
                d["job_class"] = ("on_demand"
                                  if self.job_class[i] == CLASS_ON_DEMAND
                                  else "rigid_pinned")
            if self.malleable[i]:
                d.update(
                    num_nodes_min=int(self.min_nodes[i]),
                    num_nodes_max=int(self.max_nodes[i]),
                    num_nodes_pref=int(self.pref_nodes[i]),
                    parallel_fraction=float(self.pfrac[i]),
                )
            jobs.append(d)
        return json.dumps({"jobs": jobs}, indent=1)

    @staticmethod
    def from_json(text: str) -> "Workload":
        jobs = json.loads(text)["jobs"]
        n = len(jobs)
        w = Workload.rigid(
            submit=[j["submit_time"] for j in jobs],
            runtime=[j["runtime"] for j in jobs],
            nodes_req=[j["num_nodes"] for j in jobs],
            walltime=[j.get("time_limit", 1.25 * j["runtime"]) for j in jobs],
        )
        classes = {"on_demand": CLASS_ON_DEMAND, "rigid_pinned": CLASS_RIGID}
        for i, j in enumerate(jobs):
            if j.get("type") == "malleable":
                w.malleable[i] = True
                w.min_nodes[i] = j["num_nodes_min"]
                w.max_nodes[i] = j["num_nodes_max"]
                w.pref_nodes[i] = j["num_nodes_pref"]
                w.pfrac[i] = j.get("parallel_fraction", 0.9)
            if j.get("job_class") in classes:
                w.job_class[i] = classes[j["job_class"]]
        del n
        return w

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(self.n_jobs):
            yield {f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)}
