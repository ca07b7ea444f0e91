"""Weights for the port's models: ``tpuic`` variables trees and optimizer
states, flax-default init for training, synthetic init for serving; and
the port's own checkpoints (best/latest tracks, the restore ladder)."""

from tpuic_torch.checkpoint.convert import (init_params,  # noqa: F401
                                            init_synthetic,
                                            load_jax_opt_state,
                                            load_jax_variables)
from tpuic_torch.checkpoint.loading import (  # noqa: F401
    load_candidate_variables, load_inference_variables, variables_digest)
from tpuic_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, lenient_restore)
