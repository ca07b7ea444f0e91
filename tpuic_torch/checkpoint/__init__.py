"""Weights for the port's models: ``tpuic`` variables trees and optimizer
states, flax-default init for training, synthetic init for serving."""

from tpuic_torch.checkpoint.convert import (init_params,  # noqa: F401
                                            init_synthetic,
                                            load_jax_opt_state,
                                            load_jax_variables)
