"""Architecture registry: ``--arch <id>`` resolution for all assigned archs."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig, shape_applicable  # noqa: F401

ARCH_IDS = [
    "h2o-danube-3-4b",
    "smollm-360m",
    "deepseek-7b",
    "glm4-9b",
    "zamba2-7b",
    "olmoe-1b-7b",
    "arctic-480b",
    "llava-next-34b",
    "seamless-m4t-medium",
    "mamba2-130m",
    "boundswitch-h32",          # the paper's own model
]


def get_config(arch_id: str) -> ModelConfig:
    mod_name = arch_id.replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS if a != "boundswitch-h32"}
