"""The serve tier's typed verdicts (``tpuic/serve/admission.py``, in part).

Copied: the priority names and the typed errors that the wire format (``wire.py``) renders and rebuilds and that the CLI
raises: :class:`AdmissionError`, :class:`AdmissionRejected`,
:class:`DeadlineExceeded`, :class:`ReplicaLost` and :class:`SwapRejected`.
A client's error handling parses the same ``cause``/``priority`` labels
from the port's server as from ``tpuic``'s.

Not ported yet (ROADMAP, the engine's admission features): the
``TokenBucket`` quotas, the ``BrownoutController`` and the
``AdmissionController`` that the engine would consult at submit time;
``python -m tpuic_torch.serve`` refuses ``--admission``, ``--quota`` and
``--brownout-*``.
"""

from __future__ import annotations

import queue
from typing import Optional, Tuple

# The priority classes a verdict names, highest first.
PRIORITIES: Tuple[str, ...] = ("high", "normal", "low")
DEFAULT_PRIORITY = "normal"


class AdmissionError(RuntimeError):
    """Base of every typed admission verdict: ``cause`` names why
    (``queue_full``, ``deadline``, ``quota``, ``brownout``,
    ``replica_lost``, ``swap_corrupt`` or ``swap_accuracy``, as in
    ``tpuic``), ``priority``/``tenant`` name who."""

    def __init__(self, message: str, *, cause: str,
                 priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        super().__init__(message)
        self.cause = cause
        self.priority = priority
        self.tenant = tenant


class AdmissionRejected(AdmissionError, queue.Full):
    """Submit-time rejection (queue_full / quota / brownout) — also a
    ``queue.Full`` so pre-admission callers that handled backpressure
    with ``except queue.Full`` keep working unchanged."""


class DeadlineExceeded(AdmissionError):
    """Pop-time shed: the request's deadline expired (or would, within
    the estimated remaining service time) before it reached a batch
    slot.  Set on the request's future by the batcher."""

    def __init__(self, message: str, *, priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        super().__init__(message, cause="deadline", priority=priority,
                         tenant=tenant)


class ReplicaLost(AdmissionError):
    """Routing-tier verdict (tpuic/serve/router.py): the replica holding
    this request died (or wedged past the watchdog) and the request was
    NOT replayed — it was non-idempotent, its retry attempts were
    exhausted, or the global retry budget was dry (a storm of failovers
    must not amplify into a retry storm).  At-most-once delivery holds:
    a ``replica_lost`` verdict means the caller may safely retry
    end-to-end, knowing the router never emitted a response for it."""

    def __init__(self, message: str, *, priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        super().__init__(message, cause="replica_lost", priority=priority,
                         tenant=tenant)


class SwapRejected(AdmissionError):
    """Swap-time gate verdict (docs/serving.md, "Model lifecycle"):
    a hot-swap candidate was refused BEFORE the weight flip — it never
    served a request.  ``cause`` is ``swap_corrupt`` (the candidate
    failed the checkpoint CRC/manifest integrity check: missing,
    manifest-less, or bytes that don't match their recorded checksums)
    or ``swap_accuracy`` (the candidate failed the pinned-eval gate:
    non-finite outputs, or a dtype-ladder rung disagreeing with the
    candidate's own fp32 past the committed epsilon).  The incumbent
    keeps serving untouched — refusal is always zero-downtime."""

    def __init__(self, message: str, *, cause: str = "swap_corrupt",
                 priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None) -> None:
        if cause not in ("swap_corrupt", "swap_accuracy"):
            raise ValueError(f"SwapRejected cause must be swap_corrupt or "
                             f"swap_accuracy, got {cause!r}")
        super().__init__(message, cause=cause, priority=priority,
                         tenant=tenant)
