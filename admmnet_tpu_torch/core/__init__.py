from admmnet_tpu_torch.core.config import (
    ADMMOptions,
    DataConfig,
    ModelConfig,
    PeakSearchConfig,
    ProblemSpec,
    TrainConfig,
)

__all__ = [
    "ADMMOptions",
    "DataConfig",
    "ModelConfig",
    "PeakSearchConfig",
    "ProblemSpec",
    "TrainConfig",
]
