"""Architecture registry of the port: importing this package registers
every arch; ``WORKLOADS`` is the paper's Table 2 (workload x cluster x
tick).

``base.py`` and the arch modules are byte-for-byte copies of the JAX
package's (``tests/test_torch_inputs.py`` holds them to it);
``workloads.py`` is the JAX package's over the port's
:mod:`repro_torch.core.cluster`.
"""
from . import (deepseek_v2_236b, gemma3_4b, glm4_9b, internvl2_2b,
               mamba2_1_3b, olmoe_1b_7b, qwen2_72b, stablelm_1_6b,
               whisper_large_v3, zamba2_2_7b)
from .base import (SHAPES, ModelConfig, ShapeConfig, cell_is_applicable,
                   get_config, list_archs)
from .workloads import WORKLOADS

ALL_ARCHS = (
    "olmoe-1b-7b", "deepseek-v2-236b", "mamba2-1.3b", "zamba2-2.7b",
    "glm4-9b", "gemma3-4b", "stablelm-1.6b", "qwen2-72b",
    "internvl2-2b", "whisper-large-v3",
)

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig", "cell_is_applicable",
    "get_config", "list_archs", "ALL_ARCHS", "WORKLOADS",
    "deepseek_v2_236b", "gemma3_4b", "glm4_9b", "internvl2_2b",
    "mamba2_1_3b", "olmoe_1b_7b", "qwen2_72b", "stablelm_1_6b",
    "whisper_large_v3", "zamba2_2_7b",
]
