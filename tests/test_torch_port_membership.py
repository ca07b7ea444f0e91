"""The port's membership copy (``tpuic_torch.runtime.membership``) against
``tpuic/runtime/membership.py``: each package reads the file the other
wrote, the watcher surfaces the same versions, and both refuse the same
records."""

import dataclasses

import pytest

from tpuic_torch.runtime import membership as pm

VIEWS = [
    dict(version=1, world=2, active=[0, 1], resume_step=None,
         reason="init", t=1.5),
    dict(version=2, world=2, active=[0], resume_step=120, reason="degrade",
         rank=1, t=2.25),
    dict(version=3, world=2, active=[0, 1], resume_step=None,
         reason="rejoin", rank=1),
]


@pytest.fixture()
def tm():
    from tpuic.runtime import membership
    return membership


@pytest.mark.parametrize("writer", ["port", "tpuic"])
@pytest.mark.parametrize("view", VIEWS, ids=lambda v: v["reason"])
def test_each_reads_what_the_other_wrote(tm, tmp_path, writer, view):
    w, r = (pm, tm) if writer == "port" else (tm, pm)
    path = str(tmp_path / "membership.json")
    w.write_membership(path, w.Membership(**view))
    got = r.read_membership(path)
    assert dataclasses.asdict(got) == {"rank": None, "t": 0.0, **view}
    assert got.replicas == len(view["active"])
    assert open(path).read() == _written(tm, tmp_path, view)


def _written(tm, tmp_path, view) -> str:
    """The bytes ``tpuic`` writes for ``view``."""
    path = str(tmp_path / "tpuic.json")
    tm.write_membership(path, tm.Membership(**view))
    return open(path).read()


def test_watchers_surface_the_same_versions(tm, tmp_path):
    path = str(tmp_path / "membership.json")
    pm.write_membership(path, pm.Membership(**VIEWS[0]))
    watchers = {"port": pm.MembershipWatcher(path),
                "tpuic": tm.MembershipWatcher(path)}
    seen = {k: [] for k in watchers}
    for view in VIEWS[1:]:
        tm.write_membership(path, tm.Membership(**view))
        for k, w in watchers.items():
            m = w.poll()
            seen[k].append((None if m is None else m.version, w.skipped,
                            w.poll()))
    assert seen["port"] == seen["tpuic"] == [(2, 0, None), (3, 0, None)]
    assert pm.ENV_MEMBERSHIP_FILE == tm.ENV_MEMBERSHIP_FILE
    assert pm.REASONS == tm.REASONS


def test_both_refuse_a_bad_reason_and_read_torn_as_none(tm, tmp_path):
    path = str(tmp_path / "membership.json")
    for mod in (pm, tm):
        with pytest.raises(ValueError, match="not in"):
            mod.write_membership(path, mod.Membership(
                version=1, world=1, active=[0], resume_step=None,
                reason="shrink"))
    with open(path, "w") as f:
        f.write('{"version": 4, "world": 2, "act')
    assert pm.read_membership(path) is None
    assert tm.read_membership(path) is None
    assert pm.read_membership(str(tmp_path / "absent.json")) is None
