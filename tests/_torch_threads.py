"""The CPU thread budget of the port's tests (``tests/test_torch_port_*``).

The suite runs as several pytest-xdist workers on one machine.  torch's
default intra-op pool has a thread per core in every worker, so six
workers on eight cores run 48 OpenMP threads that spin while they wait for
each other: a training-parity test that takes 14 s alone did not finish in
170 s six-wide, and took 32 s six-wide at one thread a worker.  Each port
test file sets ``torch.set_num_threads(TORCH_THREADS)`` at import, and
every process it starts gets :func:`subprocess_env`, where
``OMP_NUM_THREADS`` gives the child's torch the same pool.
"""

from __future__ import annotations

import os

TORCH_THREADS = 1


def subprocess_env(**extra) -> dict:
    """This process's environment, with the thread budget and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS=str(TORCH_THREADS), **extra)
