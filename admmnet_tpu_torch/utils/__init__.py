"""Host-side utilities of the port: the host-device boundary helpers (as
``admmnet_tpu.utils`` re-exports them), device retries, plotting,
profiling, numerical debugging."""

from admmnet_tpu_torch.utils.host import cjit, to_device, to_host

__all__ = ["cjit", "to_device", "to_host"]
