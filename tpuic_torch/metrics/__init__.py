"""Metrics primitives of the port."""

from tpuic_torch.metrics.meters import LatencyMeter, quantiles  # noqa: F401
