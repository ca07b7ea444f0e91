"""tpuic_torch.score — elastic, exactly-once bulk scoring over a packed
corpus (``tpuic/score/``).

The offline counterpart of ``tpuic_torch.serve``: ``python -m
tpuic_torch.score`` re-scores an image corpus against a trained
checkpoint as a gang of independent workers sharing a results directory:
shard leases for work distribution (a lost rank degrades throughput,
never the job), the checkpoint integrity ladder for per-shard commits (a
SIGKILL anywhere resumes without re-scoring or dropping a shard), and an
append-only per-rank ledger that ``python -m
tpuic_torch.telemetry.fleet --score-ledger`` audits (scored + quarantined
== corpus, duplicates loud).

Re-exports resolve lazily: the lease and commit layers import only the
stdlib; the driver pulls numpy and torch.
"""

from __future__ import annotations

_LAZY = {
    "LeaseDir": ("tpuic_torch.score.work", "LeaseDir"),
    "plan_shards": ("tpuic_torch.score.work", "plan_shards"),
    "write_or_verify_plan": ("tpuic_torch.score.work",
                             "write_or_verify_plan"),
    "ShardStore": ("tpuic_torch.score.commit", "ShardStore"),
    "result_line": ("tpuic_torch.score.commit", "result_line"),
    "run_score": ("tpuic_torch.score.driver", "run_score"),
    "main": ("tpuic_torch.score.driver", "main"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return __all__
