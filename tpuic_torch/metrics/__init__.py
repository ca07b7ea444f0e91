"""Metrics primitives of the port."""

from tpuic_torch.metrics.meters import (AverageMeter,  # noqa: F401
                                        LatencyMeter, accuracy, quantiles,
                                        topk_accuracy)
