from .config import (
    ExperimentConfig,
    FeatureConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    load_config,
    save_config,
)
from .device import resolve_device

__all__ = [
    "ExperimentConfig",
    "FeatureConfig",
    "MeshConfig",
    "ModelConfig",
    "TrainConfig",
    "load_config",
    "save_config",
    "resolve_device",
]
