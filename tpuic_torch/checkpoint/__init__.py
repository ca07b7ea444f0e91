"""Weights for the port's models: ``tpuic`` variables trees and synthetic init."""

from tpuic_torch.checkpoint.convert import (init_synthetic,  # noqa: F401
                                            load_jax_variables)
