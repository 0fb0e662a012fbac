"""Property: the port's dense engine equals ``repro.core.sim_jax`` on
random small workloads under any registry strategy, bit for bit.

Each example draws a workload (job count, submissions, runtimes, node
requests, malleable proportion, on-demand classes) and a registry
strategy, queue order and backfill depth, and runs
``repro_torch.core.sim_dense.simulate_dense`` on the CPU beside
``simulate_jax``; every field of ``SimState`` and ``SimTrace`` must be
equal byte for byte.  The cluster, the tick and the horizon are fixed so
the JAX package compiles once per (strategy, queue order, classes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import sim_jax  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import sim_dense  # noqa: E402

CAP, TICK, TICKS = 10, 1.0, 400


def _workload(core, seed, n, prop, on_demand):
    rng = np.random.default_rng(seed)
    w = core.Workload.rigid(submit=np.sort(rng.uniform(0, 120, n)),
                            runtime=rng.uniform(10, 90, n),
                            nodes_req=rng.choice([1, 2, 3, 4, 8], n))
    if on_demand:
        w = core.apply_scenario(w, core.ScenarioConfig(
            job_classes=core.JobClasses(rigid=0.1, on_demand=on_demand,
                                        malleable=0.9 - on_demand)))
    return core.transform_rigid_to_malleable(w, prop, seed=seed,
                                             cluster_nodes=CAP)


@settings(max_examples=16, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**16), n=st.integers(6, 16),
       prop=st.sampled_from((0.0, 0.4, 1.0)),
       on_demand=st.sampled_from((0.0, 0.2)),
       name=st.sampled_from(sorted(jcore.STRATEGIES)),
       queue_order=st.sampled_from(("fcfs", "sjf")),
       depth=st.sampled_from((1, 3, 256)))
def test_dense_engine_equals_sim_jax_on_random_workloads(
        seed, n, prop, on_demand, name, queue_order, depth):
    args = (seed, n, prop, on_demand)
    ref = sim_jax.simulate_jax(_workload(jcore, *args), CAP, TICK, TICKS,
                               jcore.STRATEGIES[name], backfill_depth=depth,
                               queue_order=queue_order)
    got = sim_dense.simulate_dense(_workload(tcore, *args), CAP, TICK, TICKS,
                                   tcore.STRATEGIES[name],
                                   backfill_depth=depth,
                                   queue_order=queue_order, device="cpu")
    for r, g in zip(ref, got):
        for f in r._fields:
            a, b = np.asarray(getattr(r, f)), getattr(g, f).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (
                f, name, queue_order)
