"""Config registry: the paper's constants (``paper``) and the LM
architectures the port runs.  Importing this package registers every
assigned architecture: the dense transformers, the two MoE models,
Gemma-3's local windows, Chameleon, MusicGen and the recurrent pair
(RecurrentGemma's RG-LRU, RWKV-6)."""
from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    all_archs,
    cells,
    get_arch,
    register,
    shape_applicable,
)
# Importing registers each architecture.
from repro_torch.configs.phi35_moe import PHI35_MOE
from repro_torch.configs.olmoe import OLMOE
from repro_torch.configs.gemma3_27b import GEMMA3_27B
from repro_torch.configs.glm4_9b import GLM4_9B
from repro_torch.configs.nemotron4_15b import NEMOTRON4_15B
from repro_torch.configs.qwen15_4b import QWEN15_4B
from repro_torch.configs.chameleon_34b import CHAMELEON_34B
from repro_torch.configs.rwkv6_1b6 import RWKV6_1B6
from repro_torch.configs.musicgen_large import MUSICGEN_LARGE
from repro_torch.configs.recurrentgemma_2b import RECURRENTGEMMA_2B

from repro_torch.configs import paper

ASSIGNED = [
    "phi3.5-moe-42b-a6.6b",
    "olmoe-1b-7b",
    "gemma3-27b",
    "glm4-9b",
    "nemotron-4-15b",
    "qwen1.5-4b",
    "chameleon-34b",
    "rwkv6-1.6b",
    "musicgen-large",
    "recurrentgemma-2b",
]

__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "all_archs", "cells", "get_arch",
    "register", "shape_applicable", "paper", "ASSIGNED",
    "PHI35_MOE", "OLMOE", "GEMMA3_27B", "GLM4_9B", "NEMOTRON4_15B",
    "QWEN15_4B", "CHAMELEON_34B", "RWKV6_1B6", "MUSICGEN_LARGE",
    "RECURRENTGEMMA_2B",
]
