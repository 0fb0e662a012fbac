"""Paper Table 2 simulation configurations (workload x cluster x tick).

A copy of ``repro.configs.workloads`` over the port's
:mod:`repro_torch.core.cluster`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cluster import CLUSTERS, Cluster


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    name: str
    cluster: Cluster
    duration_days: float
    n_jobs: int        # paper Table 2 job counts
    tick: float

    @property
    def duration_s(self) -> float:
        return self.duration_days * 86400.0


WORKLOADS = {
    "theta": WorkloadConfig("theta", CLUSTERS["theta"], 28, 2_550, 1.0),
    "eagle": WorkloadConfig("eagle", CLUSTERS["eagle"], 28, 143_829, 10.0),
    "knl": WorkloadConfig("knl", CLUSTERS["knl"], 5, 41_524, 10.0),
    "haswell": WorkloadConfig("haswell", CLUSTERS["haswell"], 5, 28_259, 1.0),
}
