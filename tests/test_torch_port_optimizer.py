"""Port parity: ``tpuic_torch`` optimizers, schedules, the K2 update
kernels' plain versions and the optimizer-state carrier against
``tpuic``'s.

- Leaf updates against ``lars_leaf_update`` / ``lamb_leaf_update`` with
  ``impl="pallas", interpret=True`` (tests/test_fused_optimizer.py's
  way to run the TPU kernels on the CPU), zero-norm leaves included.
- 5-step parameter trajectories of every optimizer, with and without
  ``grad_clip_norm``, against ``tpuic.train.optimizer.make_optimizer``.
- The four schedules at sampled steps.
- A ``tpuic`` optimizer state carried into the port and continued.

Tolerances: leaf updates rtol 1e-5 / atol 1e-7 (the trust-ratio norms
and the LAMB debias are reduced or rounded in another order), and the
updated parameters atol 1e-6 (that tolerance at the update's scale);
trajectories rtol 2e-5 / atol 1e-6 over five steps; schedules rtol 1e-6.
JAX and ``tpuic`` are imported inside fixtures, so the ``cuda`` tests
run where JAX is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpuic_torch.checkpoint import load_jax_opt_state
from tpuic_torch.config import OptimConfig
from tpuic_torch.kernels import optimizer_update as K2
from tpuic_torch.kernels.optimizer_update import (LeafTable, lamb_debias,
                                                  lamb_update,
                                                  lamb_update_plain,
                                                  lars_update,
                                                  lars_update_plain)
from tpuic_torch.train import optimizer as port_opt
from tpuic_torch.train import schedule as port_sched
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

LEAF_TOL = dict(rtol=1e-5, atol=1e-7)
# w + update: the update's own tolerance, taken at its scale (~0.1).
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=2e-5, atol=1e-6)
OCFG = OptimConfig(optimizer="sgd", learning_rate=0.1, class_weights=(),
                   milestones=(2,), gamma=0.5, weight_decay=1e-3)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import optax
    from tpuic import config as jcfg
    from tpuic.kernels import optimizer_update as jk
    from tpuic.train import optimizer as jopt
    from tpuic.train import schedule as jsched
    return dict(jax=jax, jnp=jnp, optax=optax, cfg=jcfg, k=jk, opt=jopt,
                sched=jsched)


def _leaves(seed):
    """Leaves of mixed size (one larger than a kernel chunk), plus a zero
    parameter and a zero gradient: the trust ratio's safe edge."""
    rng = np.random.default_rng(seed)
    shapes = [(300, 130), (5,), (8,), (3, 3, 4, 6)]
    w = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    m = [0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    v = [rng.random(s).astype(np.float32) for s in shapes]
    w[2][:] = 0.0
    g[1][:] = 0.0
    return w, g, m, v


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def test_lars_leaves_match_pallas_interpret(jx):
    jnp = jx["jnp"]
    w, g, m, _ = _leaves(0)
    lr = 0.7
    want = [np.asarray(jx["k"].lars_leaf_update(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), lr=lr,
        weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9,
        impl="pallas", interpret=True)) for a, b, c in zip(w, g, m)]
    got = lars_update_plain(_t(w), _t(g), _t(m), torch.tensor(lr),
                            weight_decay=1e-4, trust_coefficient=0.001,
                            momentum=0.9)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **LEAF_TOL)
    # The wrapper (plain version on the CPU) updates in place.
    pw, pm = _t(w), _t(m)
    lars_update(pw, _t(g), pm, torch.tensor(lr), torch.tensor(True),
                weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9)
    for a, b, c in zip(pw, pm, want):
        np.testing.assert_allclose(b.numpy(), c, **LEAF_TOL)
    for a, w0, c in zip(pw, w, want):
        np.testing.assert_allclose(a.numpy(), w0 + c, **PARAM_TOL)


@pytest.mark.parametrize("count", [0, 6])
def test_lamb_leaves_match_pallas_interpret(jx, count):
    jnp = jx["jnp"]
    w, g, m, v = _leaves(1)
    lr = 0.05
    want = [[np.asarray(x) for x in jx["k"].lamb_leaf_update(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d),
        jnp.asarray(count, jnp.int32), lr=lr, b1=0.9, b2=0.999, eps=1e-6,
        weight_decay=0.01, impl="pallas", interpret=True)]
        for a, b, c, d in zip(w, g, m, v)]
    upd, mus, nus = lamb_update_plain(
        _t(w), _t(g), _t(m), _t(v), torch.tensor(count, dtype=torch.int32),
        torch.tensor(lr), b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    for (u, mu, nu), (wu, wm, wv) in zip(zip(upd, mus, nus), want):
        np.testing.assert_allclose(u.numpy(), wu, **LEAF_TOL)
        np.testing.assert_allclose(mu.numpy(), wm, **LEAF_TOL)
        np.testing.assert_allclose(nu.numpy(), wv, **LEAF_TOL)
    pw, pm, pv = _t(w), _t(m), _t(v)
    lamb_update(pw, _t(g), pm, pv, torch.tensor(count, dtype=torch.int32),
                torch.tensor(lr), torch.tensor(True), b1=0.9, b2=0.999,
                eps=1e-6, weight_decay=0.01)
    for a, w0, (wu, wm, _) in zip(pw, w, want):
        np.testing.assert_allclose(a.numpy(), w0 + wu, **PARAM_TOL)


def test_zero_norm_leaves_take_trust_one():
    z, one = torch.zeros(4), torch.ones(4)
    (m,) = lars_update_plain([z], [one], [z], torch.tensor(0.5),
                             weight_decay=1e-4, trust_coefficient=0.001,
                             momentum=0.9)
    torch.testing.assert_close(m, -0.5 * one)
    (u,), _, _ = lamb_update_plain([z], [z], [z], [z],
                                   torch.tensor(0, dtype=torch.int32),
                                   torch.tensor(0.1), b1=0.9, b2=0.999,
                                   eps=1e-6, weight_decay=0.01)
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) == 0.0


def test_non_finite_flag_leaves_everything_unchanged():
    w, g, m, v = _leaves(2)
    g[0][0, 0] = np.nan
    pw, pm, pv = _t(w), _t(m), _t(v)
    no = torch.tensor(False)
    lars_update(pw, _t(g), pm, torch.tensor(0.5), no, weight_decay=1e-4,
                trust_coefficient=0.001, momentum=0.9)
    lamb_update(pw, _t(g), pm, pv, torch.tensor(0, dtype=torch.int32),
                torch.tensor(0.5), no, b1=0.9, b2=0.999, eps=1e-6,
                weight_decay=0.01)
    for got, want in zip(pw + pm + pv, w + m + v):
        np.testing.assert_array_equal(got.numpy(), want)


# -- the kernels' leaf table ----------------------------------------------

def _table_lists():
    """(g, w, m) lists of two leaves; w's first leaf is square, so its
    transpose is a non-contiguous view at the same pointer."""
    rng = np.random.default_rng(5)
    shapes = [(6, 6), (10,)]
    return tuple([torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in shapes] for _ in range(3))


def _counting_checks(monkeypatch):
    """Counts calls of the table's checks and builds."""
    calls = {"check": 0, "build": 0}
    check, build = K2.check_leaves, LeafTable._build

    def counted_check(lists):
        calls["check"] += 1
        return check(lists)

    def counted_build(self, lists, chunk):
        calls["build"] += 1
        return build(self, lists, chunk)
    monkeypatch.setattr(K2, "check_leaves", counted_check)
    monkeypatch.setattr(LeafTable, "_build", counted_build)
    return calls


def test_leaf_table_repeat_call_does_not_rebuild(monkeypatch):
    """The same tensors again: one walk for the key, no check and no
    rebuild.  A new list with the same tensors is the same key."""
    calls = _counting_checks(monkeypatch)
    g, w, m = _table_lists()
    table = LeafTable()
    assert table.get((g, w, m)) is table
    first = (table.leaves, table.chunks, table.partials, table.a)
    assert calls == {"check": 1, "build": 1}
    table.get((g, w, m))
    table.get((list(g), list(w), list(m)))
    assert calls == {"check": 1, "build": 1}
    assert all(a is b for a, b in zip(
        first, (table.leaves, table.chunks, table.partials, table.a)))
    # a_l per leaf, then LAMB's c1, c2.
    assert table.a.shape == (len(g) + 2,) and table.n_leaves == len(g)
    # Another chunk size is another table.
    table.get((g, w, m), 4)
    assert calls == {"check": 2, "build": 2} and table.n_chunks == 9 + 3


def _non_contiguous(t):
    return t.t() if t.dim() == 2 else t[::2]


@pytest.mark.parametrize("change,match", [
    (_non_contiguous, "contiguous"),
    (lambda t: t.double(), "float32"),
    (lambda t: t.reshape(-1)[:-1], "shaped"),
])
def test_leaf_table_key_catches_what_the_kernel_relies_on(monkeypatch,
                                                          change, match):
    """A leaf that turns into a non-contiguous view at the same pointer, a
    float64 tensor or a tensor of another length changes the key: the
    check runs again and raises, and the table keeps its last good key."""
    calls = _counting_checks(monkeypatch)
    g, w, m = _table_lists()
    table = LeafTable()
    table.get((g, w, m))
    good = table.key
    bad = change(w[0])
    if change is _non_contiguous:
        assert bad.data_ptr() == w[0].data_ptr()
        assert bad.numel() == w[0].numel() and not bad.is_contiguous()
    with pytest.raises(ValueError, match=match):
        table.get((g, [bad, w[1]], m))
    assert calls == {"check": 2, "build": 1} and table.key == good
    # Until the lists are whole again, every call checks and raises.
    with pytest.raises(ValueError, match=match):
        table.get((g, [bad, w[1]], m))
    table.get((g, w, m))
    assert calls == {"check": 3, "build": 1}


@pytest.mark.parametrize("kind", ["lars", "lamb"])
def test_wrappers_take_plain_versions_for_cpu_tensors(kind):
    """On CPU tensors both wrappers take the plain version, in place, and
    count no launch."""
    w, g, m, v = (_t(x) for x in _leaves(6))
    lr = torch.tensor(0.2)
    count = torch.tensor(2, dtype=torch.int32)
    yes = torch.tensor(True)
    before = (lars_update.launches, lamb_update.launches)
    if kind == "lars":
        kw = dict(weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9)
        want = lars_update_plain(w, g, m, lr, **kw)
        pw, pm = [t.clone() for t in w], [t.clone() for t in m]
        lars_update(pw, g, pm, lr, yes, **kw)
        got = pm
    else:
        kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
        want = lamb_update_plain(w, g, m, v, count, lr, **kw)[1]
        pw, pm, pv = ([t.clone() for t in ts] for ts in (w, m, v))
        lamb_update(pw, g, pm, pv, count, lr, yes, **kw)
        got = pm
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (lars_update.launches, lamb_update.launches) == before


# -- trajectories ---------------------------------------------------------

def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": np.zeros((5,), np.float32),          # zero-norm at init
            "c": rng.standard_normal((2, 3, 4)).astype(np.float32)}


def _grad(params, k, rng_seed):
    """Gradients that depend on the parameters, so a step's error carries
    into the next one."""
    rng = np.random.default_rng(rng_seed + k)
    return {n: (0.5 * p + rng.standard_normal(p.shape)).astype(np.float32)
            for n, p in params.items()}


CASES = [("adam", False, 1e-2), ("sgd", False, 0.1), ("lars", False, 2.0),
         ("lamb", False, 0.05), ("lars", True, 2.0), ("lamb", True, 0.05)]


@pytest.mark.parametrize("clip", [0.0, 1.5])
@pytest.mark.parametrize("name,fused,lr", CASES)
def test_trajectory_matches_tpuic(jx, name, fused, lr, clip):
    jax, jnp, optax = jx["jax"], jx["jnp"], jx["optax"]
    cfg = dataclasses.replace(OCFG, optimizer=name, learning_rate=lr,
                              fused_optimizer=fused, grad_clip_norm=clip)
    jcfg = jx["cfg"].OptimConfig(**dataclasses.asdict(cfg))
    tx = jx["opt"].make_optimizer(jcfg, steps_per_epoch=1, total_epochs=10)
    p0 = _params(3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    ptx = port_opt.make_optimizer(cfg, steps_per_epoch=1, total_epochs=10)
    names = sorted(p0)
    pp = [torch.from_numpy(p0[n].copy()) for n in names]
    ps = ptx.init(pp)
    yes = torch.tensor(True)
    for k in range(5):
        jg = _grad({n: np.asarray(v) for n, v in jp.items()}, k, 11)
        upd, js = tx.update({n: jnp.asarray(v) for n, v in jg.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
        pg = _grad({n: t.numpy() for n, t in zip(names, pp)}, k, 11)
        ptx.update(pp, [torch.from_numpy(pg[n]) for n in names], ps, yes)
        for n, t in zip(names, pp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[n]),
                                       err_msg=f"{name} step {k} leaf {n}",
                                       **TRAJ_TOL)
    assert int(ps.count) == 5


def test_optimizer_options_build_and_unknown_optimizer_raises():
    """Accumulation and freeze_backbone are the optimizer's
    (test_torch_port_accum.py holds them against tpuic): the state gains
    the accumulator and its counters, the optimizer says it freezes."""
    tx = port_opt.make_optimizer(dataclasses.replace(OCFG,
                                                     grad_accum_steps=2))
    st = tx.init([torch.zeros(3)])
    assert tx.accum_steps == 2 and len(st.acc) == 1
    assert int(st.mini_step) == int(st.gradient_step) == 0
    assert port_opt.make_optimizer(dataclasses.replace(
        OCFG, freeze_backbone=True)).freeze_backbone
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_opt.make_optimizer(dataclasses.replace(OCFG, optimizer="rmsprop"))


# -- schedules ------------------------------------------------------------

STEPS = [0, 1, 2, 7, 29, 30, 31, 59, 60, 61, 150, 299, 300, 400]


def _both(jx, port, jax_sched):
    for t in STEPS:
        want = float(jax_sched(jx["jnp"].asarray(t, jx["jnp"].int32)))
        got = port(torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {t}")


def test_schedules_match_tpuic(jx):
    js, ps = jx["sched"], port_sched
    _both(jx, ps.multistep_schedule(0.1, (2, 5), 0.5, 30),
          js.multistep_schedule(0.1, (2, 5), 0.5, 30))
    _both(jx, ps.warmup_cosine_schedule(4.8, 2, 10, 30),
          js.warmup_cosine_schedule(4.8, 2, 10, 30))
    _both(jx, ps.warmup_cosine_schedule(1.0, 0, 10, 30, end_lr=0.1),
          js.warmup_cosine_schedule(1.0, 0, 10, 30, end_lr=0.1))
    _both(jx, ps.constant_schedule(0.3), js.constant_schedule(0.3))
    _both(jx, ps.batch_scaled_warmup_schedule(
        0.1, 1024, 256, 2, 30, ps.warmup_cosine_schedule(0.4, 2, 10, 30)),
        js.batch_scaled_warmup_schedule(
            0.1, 1024, 256, 2, 30, js.warmup_cosine_schedule(0.4, 2, 10,
                                                             30)))


@pytest.mark.parametrize("kw", [
    dict(warmup_epochs=5), dict(milestones=(3, 8)), dict(milestones=()),
    dict(base_batch_size=256, warmup_epochs=2),
    dict(base_batch_size=256, milestones=(4,)),
    dict(base_batch_size=256, milestones=())])
def test_make_schedule_matches_tpuic(jx, kw):
    cfg = dataclasses.replace(OCFG, learning_rate=0.2, **kw)
    jcfg = jx["cfg"].OptimConfig(**dataclasses.asdict(cfg))
    _both(jx, port_opt.make_schedule(cfg, 30, 10, global_batch=512),
          jx["opt"].make_schedule(jcfg, 30, 10, global_batch=512))


def test_rewarm_scale_matches_tpuic(jx):
    _both(jx, port_opt.rewarm_scale(40, 20), jx["opt"].rewarm_scale(40, 20))


# -- the optimizer-state carrier ------------------------------------------

TREE = {"backbone": {"conv1": {"kernel": (3, 3, 2, 4)}},
        "head": {"out": {"kernel": (4, 3), "bias": (3,)}}}
PORT_ORDER = ["backbone.conv1.weight", "head.out.weight", "head.out.bias"]


def _jax_tree(jnp, seed):
    rng = np.random.default_rng(seed)

    def build(node):
        if isinstance(node, tuple):
            return jnp.asarray(rng.standard_normal(node).astype(np.float32))
        return {k: build(v) for k, v in node.items()}

    return build(TREE)


def _port_layout(jtree):
    """Port tensors in PORT_ORDER: conv HWIO -> OIHW, dense transposed."""
    c = np.asarray(jtree["backbone"]["conv1"]["kernel"]).transpose(3, 2, 0, 1)
    k = np.asarray(jtree["head"]["out"]["kernel"]).T
    b = np.asarray(jtree["head"]["out"]["bias"])
    return [torch.from_numpy(np.array(a, order="C")) for a in (c, k, b)]


@pytest.mark.parametrize("name,fused", [("lars", True), ("lamb", True),
                                        ("adam", False), ("sgd", False),
                                        ("lars", False), ("lamb", False)])
def test_carried_opt_state_continues_like_tpuic(jx, name, fused):
    """Two tpuic steps, carry params and optimizer state, then two more
    steps on each side: the same parameters."""
    jax, jnp, optax = jx["jax"], jx["jnp"], jx["optax"]
    cfg = dataclasses.replace(OCFG, optimizer=name, learning_rate=0.05,
                              fused_optimizer=fused, grad_clip_norm=2.0)
    tx = jx["opt"].make_optimizer(jx["cfg"].OptimConfig(
        **dataclasses.asdict(cfg)), steps_per_epoch=1, total_epochs=10)
    jp = _jax_tree(jnp, 0)
    js = tx.init(jp)
    grads = [_jax_tree(jnp, 10 + k) for k in range(4)]
    for k in range(2):
        upd, js = tx.update(grads[k], js, jp)
        jp = optax.apply_updates(jp, upd)
    carried = load_jax_opt_state(jax.tree.map(np.asarray, js), PORT_ORDER,
                                 device="cpu")
    assert int(carried.count) == 2
    ptx = port_opt.make_optimizer(cfg, steps_per_epoch=1, total_epochs=10)
    pp = _port_layout(jp)
    for k in range(2, 4):
        upd, js = tx.update(grads[k], js, jp)
        jp = optax.apply_updates(jp, upd)
        ptx.update(pp, _port_layout(grads[k]), carried, torch.tensor(True))
    for got, want in zip(pp, _port_layout(jp)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TRAJ_TOL)
    assert int(carried.count) == 4


def test_carrier_is_strict(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    tx = jx["opt"].fused_lars(0.1, impl="jnp")
    state = jax.tree.map(np.asarray, tx.init(_jax_tree(jnp, 0)))
    with pytest.raises(KeyError, match="does not match the parameters"):
        load_jax_opt_state(state, PORT_ORDER[:2], device="cpu")
    bad = state._replace(count=np.asarray(3, np.int32))
    odd = (bad, jx["optax"].ScaleByScheduleState(np.asarray(4, np.int32)))
    with pytest.raises(KeyError, match="a second 'trace' tree"):
        load_jax_opt_state((bad, bad), PORT_ORDER, device="cpu")
    with pytest.raises(ValueError, match="counts disagree"):
        load_jax_opt_state(odd, PORT_ORDER, device="cpu")
    with pytest.raises(KeyError, match="does not carry"):
        load_jax_opt_state((state, np.zeros(3)), PORT_ORDER, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lars", "lamb"])
def test_cuda_kernels_match_plain(kind):
    """K2 on the card against its plain version: every leaf, the zero-norm
    edge and a leaf over one chunk; then a non-finite flag changes nothing.
    Tolerances: moments ``LEAF_TOL`` (the trust-ratio norms are reduced in
    another order: per chunk, then per leaf in double), parameters
    ``PARAM_TOL`` (that relative error taken at the update's scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    w, g, m, v = (_t(x) for x in _leaves(4))
    w, g, m, v = ([t.cuda() for t in ts] for ts in (w, g, m, v))
    lr = torch.tensor(0.3, device="cuda")
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    yes = torch.tensor(True, device="cuda")
    if kind == "lars":
        want_m = lars_update_plain(w, g, m, lr, weight_decay=1e-4,
                                   trust_coefficient=0.001, momentum=0.9)
        want = ([a + b for a, b in zip(w, want_m)], want_m)
        got = ([t.clone() for t in w], [t.clone() for t in m])
        before = lars_update.launches
        lars_update(got[0], g, got[1], lr, yes, weight_decay=1e-4,
                    trust_coefficient=0.001, momentum=0.9)
        launched = lars_update.launches - before
    else:
        upd, mus, nus = lamb_update_plain(w, g, m, v, count, lr, b1=0.9,
                                          b2=0.999, eps=1e-6,
                                          weight_decay=0.01)
        want = ([a + b for a, b in zip(w, upd)], mus, nus)
        got = tuple([t.clone() for t in ts] for ts in (w, m, v))
        before = lamb_update.launches
        lamb_update(got[0], g, got[1], got[2], count, lr, yes, b1=0.9,
                    b2=0.999, eps=1e-6, weight_decay=0.01)
        launched = lamb_update.launches - before
    torch.cuda.synchronize()
    assert launched == 1
    for k, (gs, ws) in enumerate(zip(got, want)):
        for a, b in zip(gs, ws):
            torch.testing.assert_close(a, b, **(PARAM_TOL if k == 0
                                                else LEAF_TOL))
    snapshot = [[t.clone() for t in gs] for gs in got]
    no = torch.tensor(False, device="cuda")
    if kind == "lars":
        lars_update(got[0], g, got[1], lr, no, weight_decay=1e-4,
                    trust_coefficient=0.001, momentum=0.9)
    else:
        lamb_update(got[0], g, got[1], got[2], count, lr, no, b1=0.9,
                    b2=0.999, eps=1e-6, weight_decay=0.01)
    torch.cuda.synchronize()
    for gs, ss in zip(got, snapshot):
        for a, b in zip(gs, ss):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_lars_takes_unaligned_ragged_leaves():
    """K2a on leaves whose lengths are not multiples of 4 and whose storage
    offsets are not 16-byte aligned (views 1, 2 and 3 elements into one
    buffer; one leaf longer than a chunk), beside an aligned leaf: the
    16-byte path and the scalar path against the plain version, the same
    bits on a second run, and nothing written under a non-finite flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from tpuic_torch.kernels.optimizer_update import CHUNK
    rng = np.random.default_rng(7)
    sizes = [(CHUNK + 5,), (7,), (3, 3, 3), (1,), (2 * CHUNK,)]

    def place(ts, offsets):
        """Copies of ``ts`` as views ``off`` elements into fresh buffers."""
        out = []
        for t, off in zip(ts, offsets):
            buf = torch.empty(t.numel() + off, device="cuda")
            out.append(buf[off:off + t.numel()].view(t.shape))
            out[-1].copy_(t)
        return out

    offsets = [1, 2, 3, 1, 0]
    w, g, m = ([torch.from_numpy(scale * rng.standard_normal(s).astype(
        np.float32)).cuda() for s in sizes] for scale in (1.0, 1.0, 0.1))
    g = place(g, offsets)
    assert [t.data_ptr() % 16 != 0 for t in g] == [True] * 4 + [False]
    lr = torch.tensor(0.3, device="cuda")
    kw = dict(weight_decay=1e-4, trust_coefficient=0.001, momentum=0.9)
    want_m = lars_update_plain(w, g, m, lr, **kw)
    want_w = [a + b for a, b in zip(w, want_m)]
    runs = []
    for flag in (True, True, False):
        got_w, got_m = place(w, offsets), place(m, offsets[::-1])
        lars_update(got_w, g, got_m, lr, torch.tensor(flag, device="cuda"),
                    **kw)
        torch.cuda.synchronize()
        runs.append((got_w, got_m))
    for a, b in zip(runs[0][0], want_w):
        torch.testing.assert_close(a, b, **PARAM_TOL)
    for a, b in zip(runs[0][1], want_m):
        torch.testing.assert_close(a, b, **LEAF_TOL)
    assert all(torch.equal(a, b) for x, y in zip(runs[0], runs[1])
               for a, b in zip(x, y))
    assert all(torch.equal(a, b) for a, b in zip(runs[2][0], w))
    assert all(torch.equal(a, b) for a, b in zip(runs[2][1], m))


@pytest.mark.cuda
def test_cuda_lamb_takes_unaligned_ragged_leaves():
    """K2b on leaves whose lengths are not multiples of 4 and whose storage
    offsets are not 16-byte aligned (views 1, 2 and 3 elements into one
    buffer; one leaf longer than a chunk), beside an aligned leaf: the
    16-byte path and the scalar path against the plain version, the same
    bits on a second run, and nothing written under a non-finite flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from tpuic_torch.kernels.optimizer_update import CHUNK
    rng = np.random.default_rng(8)
    sizes = [(CHUNK + 5,), (7,), (3, 3, 3), (1,), (2 * CHUNK,)]

    def place(ts, offsets):
        """Copies of ``ts`` as views ``off`` elements into fresh buffers."""
        out = []
        for t, off in zip(ts, offsets):
            buf = torch.empty(t.numel() + off, device="cuda")
            out.append(buf[off:off + t.numel()].view(t.shape))
            out[-1].copy_(t)
        return out

    offsets = [1, 2, 3, 1, 0]
    w, g, m = ([torch.from_numpy(scale * rng.standard_normal(s).astype(
        np.float32)).cuda() for s in sizes] for scale in (1.0, 1.0, 0.1))
    v = [torch.from_numpy(rng.random(s).astype(np.float32)).cuda()
         for s in sizes]
    g = place(g, offsets)
    assert [t.data_ptr() % 16 != 0 for t in g] == [True] * 4 + [False]
    lr = torch.tensor(0.3, device="cuda")
    count = torch.tensor(4, dtype=torch.int32, device="cuda")
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    upd, want_m, want_v = lamb_update_plain(w, g, m, v, count, lr, **kw)
    want_w = [a + b for a, b in zip(w, upd)]
    runs = []
    for flag in (True, True, False):
        got = (place(w, offsets), place(m, offsets[::-1]),
               place(v, offsets[1:] + offsets[:1]))
        lamb_update(*got[:1], g, *got[1:], count, lr,
                    torch.tensor(flag, device="cuda"), **kw)
        torch.cuda.synchronize()
        runs.append(got)
    for a, b in zip(runs[0][0], want_w):
        torch.testing.assert_close(a, b, **PARAM_TOL)
    for k, want in ((1, want_m), (2, want_v)):
        for a, b in zip(runs[0][k], want):
            torch.testing.assert_close(a, b, **LEAF_TOL)
    assert all(torch.equal(a, b) for x, y in zip(runs[0], runs[1])
               for a, b in zip(x, y))
    for got, before in zip(runs[2], (w, m, v)):
        assert all(torch.equal(a, b) for a, b in zip(got, before))


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 1, 6, 999])
def test_cuda_lamb_debias_matches_plain(count):
    """The c1, c2 the kernel computes from the device count (left by its
    first pass in the table's scratch) against ``lamb_debias`` on the card:
    within 1 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    w, g, m, v = ([t.cuda() for t in _t(x)] for x in _leaves(9))
    cnt = torch.tensor(count, dtype=torch.int32, device="cuda")
    table = LeafTable()
    lamb_update(w, g, m, v, cnt, torch.tensor(0.1, device="cuda"),
                torch.tensor(True, device="cuda"), b1=0.9, b2=0.999,
                eps=1e-6, weight_decay=0.01, table=table)
    got = table.a[-2:]
    want = torch.stack(lamb_debias(cnt, 0.9, 0.999))
    torch.cuda.synchronize()
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long())
    assert int(ulps.abs().max()) <= 1, (got.tolist(), want.tolist())
