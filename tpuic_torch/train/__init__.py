"""Training for the port: loss, optimizers, schedules, state, the train
and eval steps, the ``Trainer`` and its CLI (``python -m
tpuic_torch.train``).  Importing the package loads nothing heavy."""
