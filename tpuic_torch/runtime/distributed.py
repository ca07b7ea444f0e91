"""Multi-process runtime (``tpuic/runtime/distributed.py``).

``tpuic`` runs one JAX process per host over every local chip and lets the
TPU runtime find the others; the port runs one process per card, as the
reference does (its ``README.md``: ``torch.distributed.launch
--nproc_per_node=4 train.py``), and joins them with
``torch.distributed``:

- :func:`initialize` reads the same rendezvous as ``tpuic``: the
  ``TPUIC_COORDINATOR_ADDRESS`` / ``TPUIC_NUM_PROCESSES`` /
  ``TPUIC_PROCESS_ID`` trio fills every argument the caller left None,
  and a half-set trio raises with ``tpuic``'s message.  torchrun's
  ``RANK`` / ``WORLD_SIZE`` are not read (``tpuic`` has no such
  launcher).  With a coordinator it calls ``init_process_group`` over
  ``tcp://{address}``: NCCL for the card, gloo when the caller asked for
  the CPU.  Process ``r`` is bound to ``cuda:{r % device_count}``.
- A single process with no trio initializes nothing: no process group,
  no collective, nothing to pay.
- :func:`runtime_info` and :func:`data_parallel_replicas` answer from the
  process group (one process without one).  The gang supervisor
  (``runtime/gang.py``) passes each rank the trio with ``--coordinator``,
  and ``TPUIC_FLEET_RANK``/``TPUIC_FLEET_RANKS``, which the telemetry's
  tags and the rank-targeted fault points read.  ``tpuic``'s elastic
  membership file (``TPUIC_MEMBERSHIP_FILE``) is ROADMAP §1 item 13.

Usage, two processes on one host::

  TPUIC_COORDINATOR_ADDRESS=localhost:29500 TPUIC_NUM_PROCESSES=2 \\
      TPUIC_PROCESS_ID=0 python -m tpuic_torch.train --datadir D ... &
  TPUIC_COORDINATOR_ADDRESS=localhost:29500 TPUIC_NUM_PROCESSES=2 \\
      TPUIC_PROCESS_ID=1 python -m tpuic_torch.train --datadir D ...
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    platform: str

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1 or self.global_device_count > 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> RuntimeInfo:
    """Join the process group the trio names (idempotent: a process that
    already joined one keeps it).

    ``device`` is the caller's device choice (``None`` = the card):
    ``'cpu'`` gives gloo, anything else NCCL."""
    env_addr = os.environ.get("TPUIC_COORDINATOR_ADDRESS") or None
    env_num = os.environ.get("TPUIC_NUM_PROCESSES") or None
    env_pid = os.environ.get("TPUIC_PROCESS_ID") or None
    if coordinator_address is None:
        coordinator_address = env_addr
    if num_processes is None and env_num:
        num_processes = int(env_num)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if (env_addr is not None or env_pid is not None) and (
            coordinator_address is None or num_processes is None
            or process_id is None):
        raise ValueError(
            f"TPUIC env rendezvous is half-set: TPUIC_COORDINATOR_ADDRESS="
            f"{env_addr!r}, TPUIC_NUM_PROCESSES={env_num!r}, "
            f"TPUIC_PROCESS_ID={env_pid!r} — a launcher must set all "
            "three (or none; TPUIC_NUM_PROCESSES alone keeps the "
            "auto-discovery path)")
    if coordinator_address is None:
        if num_processes not in (None, 1):
            # tpuic's auto-discovery asks the TPU runtime; torch has none.
            raise ValueError(
                f"TPUIC_NUM_PROCESSES={num_processes} without "
                "TPUIC_COORDINATOR_ADDRESS: the port needs the coordinator "
                "address and the process id")
        return runtime_info()
    if dist.is_initialized():
        return runtime_info()
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return runtime_info()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def runtime_info() -> RuntimeInfo:
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return RuntimeInfo(process_index=process_index(),
                       process_count=process_count(),
                       local_device_count=max(1, cards),
                       global_device_count=process_count(),
                       platform="gpu" if cards else "cpu")


def data_parallel_replicas() -> int:
    """The data-parallel extent: the processes of the group (``tpuic``'s
    answer without a membership file or ``TPUIC_FLEET_RANKS``)."""
    return process_count()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
