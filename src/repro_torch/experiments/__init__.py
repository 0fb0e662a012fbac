"""Experiment layer of the port: spec -> cell store -> backend -> artifact.

- spec:          ExperimentSpec (grid + scenario axes) with canonical
                 content-hash fingerprints; prepare_workload realization
- run:           run_experiment over the two backends and the shared cell
                 store; artifact read/write helpers
- backend_torch: the batched engine on the card (CUDA kernels)
- backend_des:   the reference numpy DES on the host, cell-parallel
- crosscheck:    seeded DES crosscheck + tolerances (the fidelity gate)
- report:        renderers over the shared artifact schema
- cli:           argparse wiring of ``python -m repro_torch.experiments``
"""
from repro_torch.core.scenario import JobClasses, ScenarioConfig

from .report import (SCENARIO_AXES, best_improvements,
                     render_scenario_table, render_sweep_table,
                     scenario_variant)
from .run import (load_artifact_results, run_experiment,
                  sweep_scenario_axis, write_artifact)
from .spec import ENGINES, ExperimentSpec, prepare_workload

__all__ = [
    "ENGINES", "ExperimentSpec", "JobClasses", "ScenarioConfig",
    "SCENARIO_AXES", "prepare_workload",
    "run_experiment", "sweep_scenario_axis", "write_artifact",
    "load_artifact_results", "best_improvements", "render_sweep_table",
    "render_scenario_table", "scenario_variant",
]
