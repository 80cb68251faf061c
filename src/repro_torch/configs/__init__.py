"""Architecture configs the port serves — copies of the JAX package's,
all eleven of them.

Importing this package registers every config; ``get_config(name)`` /
``list_archs()`` are the public entry points.
"""

from repro_torch.configs.base import ArchConfig, get_config, list_archs, reduced

# registration side effects — one module per served architecture
from repro_torch.configs.dbrx_132b import DBRX_132B
from repro_torch.configs.granite_8b import GRANITE_8B
from repro_torch.configs.mamba2_2_7b import MAMBA2_2_7B
from repro_torch.configs.musicgen_medium import MUSICGEN_MEDIUM
from repro_torch.configs.nemotron_4_15b import NEMOTRON_4_15B
from repro_torch.configs.paper_agentic import PAPER_AGENTIC
from repro_torch.configs.pixtral_12b import PIXTRAL_12B
from repro_torch.configs.qwen2_1_5b import QWEN2_1_5B
from repro_torch.configs.qwen3_moe_235b_a22b import QWEN3_MOE_235B_A22B
from repro_torch.configs.stablelm_12b import STABLELM_12B
from repro_torch.configs.zamba2_7b import ZAMBA2_7B

#: the ten architectures the JAX package is assigned, in its order (the
#: paper's own ``paper-agentic`` is registered beside them)
ASSIGNED_ARCHS = [
    "granite-8b",
    "nemotron-4-15b",
    "stablelm-12b",
    "qwen2-1.5b",
    "pixtral-12b",
    "zamba2-7b",
    "qwen3-moe-235b-a22b",
    "dbrx-132b",
    "musicgen-medium",
    "mamba2-2.7b",
]

__all__ = [
    "ArchConfig", "get_config", "list_archs", "reduced", "ASSIGNED_ARCHS",
]
