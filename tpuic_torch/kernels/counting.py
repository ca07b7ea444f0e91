"""The kernel wrappers' launch counters.

Each counted wrapper has a ``.launches`` count and calls ``count_launch``
where it launches its kernel, and nowhere else.  A thread inside
``tally()`` adds to a tally of its own instead: the serve engine captures
a CUDA graph that way, where a wrapper enqueues into the graph and
launches nothing, and the tally becomes the graph's launches per replay,
which ``add_launches`` adds to the counts at each replay.  So a capture
on one thread never touches the counts that replays on another thread
add to, and holds no lock that they wait on.  One lock keeps increments
from several threads from being lost.
"""

from __future__ import annotations

import contextlib
import threading

_LOCK = threading.Lock()
_LOCAL = threading.local()


def count_launch(fn) -> None:
    """One launch of ``fn``'s kernel (or, inside ``tally()``, one
    enqueue into the graph being captured)."""
    counts = getattr(_LOCAL, "tally", None)
    if counts is not None:
        counts[fn] = counts.get(fn, 0) + 1
        return
    with _LOCK:
        fn.launches += 1


def add_launches(pairs) -> None:
    """Add ``(wrapper, n)`` pairs to the counts: a graph's replay."""
    with _LOCK:
        for fn, n in pairs:
            fn.launches += n


@contextlib.contextmanager
def tally():
    """This thread's launches in the block go to the yielded
    ``{wrapper: n}`` dict, not to the wrappers' counts."""
    prev = getattr(_LOCAL, "tally", None)
    _LOCAL.tally = counts = {}
    try:
        yield counts
    finally:
        _LOCAL.tally = prev
