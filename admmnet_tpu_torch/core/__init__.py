from admmnet_tpu_torch.core.config import ADMMOptions, ModelConfig, PeakSearchConfig, ProblemSpec

__all__ = ["ADMMOptions", "ModelConfig", "PeakSearchConfig", "ProblemSpec"]
