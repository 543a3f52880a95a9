"""Config registry: the paper's constants (``paper``) and the LM
architectures the port runs.  Importing this package registers the two
dense transformers ported so far (``glm4-9b``, ``qwen1.5-4b``);
``get_arch`` of another assigned architecture raises a ``KeyError``
naming what it still needs."""
from repro_torch.configs.base import (
    NOT_PORTED,
    SHAPES,
    ArchConfig,
    ShapeSpec,
    all_archs,
    cells,
    get_arch,
    register,
    shape_applicable,
)
from repro_torch.configs.glm4_9b import GLM4_9B
from repro_torch.configs.qwen15_4b import QWEN15_4B

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
    "register", "shape_applicable", "paper", "ASSIGNED", "NOT_PORTED",
    "GLM4_9B", "QWEN15_4B",
]
