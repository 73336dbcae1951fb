from admmnet_tpu_torch.core.config import ADMMOptions, PeakSearchConfig, ProblemSpec

__all__ = ["ADMMOptions", "PeakSearchConfig", "ProblemSpec"]
