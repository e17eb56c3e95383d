from audio2photoreal_tpu_torch.core.config import (
    DataConfig,
    DenoiserConfig,
    DiffusionConfig,
    GuideConfig,
    TrainConfig,
    VQConfig,
    load_config,
    save_config,
)

__all__ = [
    "DataConfig",
    "DenoiserConfig",
    "DiffusionConfig",
    "GuideConfig",
    "TrainConfig",
    "VQConfig",
    "load_config",
    "save_config",
]
