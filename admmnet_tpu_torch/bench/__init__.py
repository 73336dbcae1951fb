"""Benchmarks of the port: scaling over the data mesh."""

from admmnet_tpu_torch.bench.scaling import measure_throughput, scaling_report

__all__ = ["measure_throughput", "scaling_report"]
