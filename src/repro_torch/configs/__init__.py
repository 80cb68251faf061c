"""Architecture configs the port serves — copies of the JAX package's.

Importing this package registers every config; ``get_config(name)`` /
``list_archs()`` are the public entry points.
"""

from repro_torch.configs.base import ArchConfig, get_config, list_archs, reduced

# registration side effects — one module per served architecture
from repro_torch.configs.mamba2_2_7b import MAMBA2_2_7B
from repro_torch.configs.paper_agentic import PAPER_AGENTIC
from repro_torch.configs.qwen2_1_5b import QWEN2_1_5B

__all__ = ["ArchConfig", "get_config", "list_archs", "reduced",
           "MAMBA2_2_7B", "PAPER_AGENTIC", "QWEN2_1_5B"]
