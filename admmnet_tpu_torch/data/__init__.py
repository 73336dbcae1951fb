"""Input data: the bundled anchor case and the synthetic datasets."""

from admmnet_tpu_torch.data.anchor import AnchorScenario, load_anchor, make_anchor_batch

__all__ = ["AnchorScenario", "load_anchor", "make_anchor_batch"]
