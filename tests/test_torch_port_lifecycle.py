"""The port's model lifecycle on the CPU: the hot-swap gate's checkpoint
read, the engine's generations and ``swap_weights``, and swap lines
through ``python -m tpuic_torch.serve`` (``tests/test_lifecycle.py``'s
contract).

- ``load_candidate_variables`` / ``restore_exact``: a round trip with its
  digest; a missing track, flipped bytes and a missing manifest refused
  with ``swap_corrupt`` where ``tpuic``'s loader refuses them, never a
  fallback to ``.prev``; a partial restore a ``ValueError``; the serving
  engine untouched throughout.
- ``swap_weights`` against ``tpuic``'s engine on the same two numpy
  trees: the same answers before and after each swap (1e-5), the same
  ``generation`` and ``swaps``, a digest that changes and comes back on
  A -> B -> A, the ladder's tag-set check; a swap under live traffic
  drops nothing and answers every request with A's or B's weights.
- The CLI: swap lines by ``synthetic_seed`` and by checkpoint over stdin
  and ``--listen``, a byte-flipped candidate (``swap_corrupt``), a NaN
  candidate (``swap_accuracy``), ``--admission`` with SLA fields.
- A swap whose ``state_dict`` fails to load changes nothing served and
  leaves the standby's fold targets in place for the next swap.
- On the card (``cuda``): replays after a same-shape swap, and after a
  failed one, are bitwise an eager forward of the new weights (K3's
  folded weights are refolded in place), and a pinned staging buffer is
  never written before its copy's event has completed.

JAX and ``tpuic`` are imported inside fixtures and tests.
"""

import dataclasses
import io
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch.checkpoint import (CheckpointManager, init_params,
                                    load_candidate_variables,
                                    load_inference_variables,
                                    variables_digest)
from tpuic_torch.checkpoint.convert import load_jax_variables
from tpuic_torch.models import create_model
from tpuic_torch.serve import InferenceEngine, make_forward, wire
from tpuic_torch.serve import __main__ as pserve
from tpuic_torch.serve.admission import SwapRejected
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

MODEL, CLASSES, SIZE = "resnet18-cifar", 10, 16
OCFG = pcfg.OptimConfig(optimizer="sgd", class_weights=(), milestones=())


_WEIGHTS = {}


def _model(seed=0, nan=False, name=MODEL):
    """``name`` with flax-default weights from ``seed`` (drawn once)."""
    m = create_model(name, CLASSES, dtype="float32", fused_conv_bn=True,
                     image_size=SIZE, device="cpu")
    if (name, seed) not in _WEIGHTS:
        _WEIGHTS[name, seed] = {k: v.clone() for k, v in init_params(
            m, seed, device="cpu").state_dict().items()}
    m.load_state_dict(_WEIGHTS[name, seed])
    if nan:
        with torch.no_grad():
            for p in m.parameters():
                if p.dim() >= 2:
                    p.mul_(float("nan"))
    return m.eval()


def _commit(ckpt_dir, seed=0, nan=False, track="latest", epoch=0,
            name=MODEL):
    """A port checkpoint of ``name`` with the sidecars a Trainer
    writes."""
    mgr = CheckpointManager(str(ckpt_dir), name, async_commit=False,
                            log=lambda m: None)
    state = create_train_state(_model(seed, nan, name), make_optimizer(OCFG))
    getattr(mgr, f"save_{track}")(state, epoch, 1.0)
    mgr.wait()
    cfg = pcfg.Config(data=pcfg.DataConfig(resize_size=SIZE),
                      model=pcfg.ModelConfig(name=name, num_classes=CLASSES,
                                             dtype="float32"), optim=OCFG)
    with open(os.path.join(mgr.root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, default=str)
    return mgr


def _cfg(ckpt_dir, name=MODEL):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=".", resize_size=SIZE),
        model=pcfg.ModelConfig(name=name, num_classes=CLASSES,
                               dtype="float32", fused_conv_bn=True),
        optim=OCFG, run=pcfg.RunConfig(ckpt_dir=str(ckpt_dir)))


def _largest(track_dir):
    files = [os.path.join(d, f) for d, _, fs in os.walk(track_dir)
             for f in fs]
    return max(files, key=os.path.getsize)


def _flip(path, offset=4096, n=16):
    size = os.path.getsize(path)
    offset = min(offset, size - n)
    with open(path, "r+b") as f:
        f.seek(offset)
        data = f.read(n)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in data))


def _u8(seed, n, size=SIZE):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


# -- the gate-grade checkpoint read ------------------------------------------
def test_candidate_round_trip_digest_and_exact_restore(tmp_path):
    mgr = _commit(tmp_path, seed=3)
    logs = []
    model, digest = load_candidate_variables(_cfg(tmp_path), track="latest",
                                             log=logs.append, device="cpu")
    assert digest == variables_digest(model) == variables_digest(_model(3))
    assert not model.training and "verified" in logs[-1]
    boot = load_inference_variables(_cfg(tmp_path), track="latest",
                                     device="cpu", log=lambda *a: None)
    assert variables_digest(boot) == digest
    # restore_exact sets what restore_into sets, from the one rung.
    state = create_train_state(_model(5), make_optimizer(OCFG))
    _, start, best = mgr.restore_exact(state, "latest")
    assert (start, best) == (1, 1.0)
    assert mgr.last_restore_rung == "latest"
    loaded, total = mgr.last_restore_loaded
    assert loaded == total == len(state.model.state_dict())
    assert mgr.last_restore_meta == (0, -1)
    assert mgr.last_restore_geometry == (-1, -1, -1)
    assert mgr.last_restore_step_in_epoch is None
    assert variables_digest(state.model) == digest


#: The refusals do not depend on the model: the comparison runs on the
#: smallest one, whose ``tpuic`` state is the quickest to build.
REFUSAL_MODEL = "vit-tiny"


@pytest.fixture(scope="module")
def jax_lifecycle():
    """``tpuic``'s loader and a ``tpuic`` state to commit."""
    pytest.importorskip("jax")
    import jax

    from tpuic.checkpoint.loading import load_candidate_variables as jload
    from tpuic.checkpoint.manager import CheckpointManager as JaxManager
    from tpuic.config import Config, DataConfig, ModelConfig, OptimConfig
    from tpuic.config import RunConfig
    from tpuic.models import create_model as jcreate
    from tpuic.train.optimizer import make_optimizer as jopt
    from tpuic.train.state import create_train_state as jstate
    from tpuic.serve.admission import SwapRejected as JaxSwapRejected
    ocfg = OptimConfig(optimizer="sgd", class_weights=(), milestones=())
    state = jstate(jcreate(REFUSAL_MODEL, CLASSES, dtype="float32"),
                   jopt(ocfg), jax.random.key(0), (1, SIZE, SIZE, 3))

    def commit(ckpt_dir, epoch=0):
        mgr = JaxManager(str(ckpt_dir), REFUSAL_MODEL)
        mgr.save_latest(state, epoch=epoch, best_score=0.0)
        mgr.wait()

    def load(ckpt_dir):
        cfg = Config(data=DataConfig(data_dir=".", resize_size=SIZE),
                     model=ModelConfig(name=REFUSAL_MODEL,
                                       num_classes=CLASSES),
                     optim=ocfg, run=RunConfig(ckpt_dir=str(ckpt_dir)))
        return jload(cfg, track="latest", log=lambda *a: None)

    return dict(commit=commit, load=load, rejected=JaxSwapRejected)


def _fault(root, fault, name):
    """Apply one fault to ``root``'s ``name``/latest track."""
    track = os.path.join(root, name, "latest")
    if fault == "missing_track":
        shutil.rmtree(track)
    elif fault == "flipped_bytes":
        _flip(_largest(track))
    elif fault == "no_manifest":
        os.remove(track + ".manifest.json")
    elif fault == "flipped_with_intact_prev":
        _flip(_largest(track))
        assert os.path.isdir(track + ".prev")


@pytest.mark.parametrize("fault", [
    "missing_track", "flipped_bytes", "no_manifest",
    "flipped_with_intact_prev"])
def test_candidate_refusals_match_tpuic(tmp_path, jax_lifecycle, fault):
    """Each fault on each side's own checkpoint of the same model: the
    port refuses exactly where ``tpuic`` refuses, with the same cause and
    reason; a corrupt ``latest`` is refused although an intact
    ``latest.prev`` exists (no ladder), where ``restore_into`` takes
    ``.prev``."""
    outcomes = {}
    for side in ("port", "tpuic"):
        root = tmp_path / side
        commits = 2 if fault == "flipped_with_intact_prev" else 1
        for i in range(commits):
            if side == "port":
                _commit(root, seed=i, epoch=i, name=REFUSAL_MODEL)
            else:
                jax_lifecycle["commit"](root, epoch=i)
        _fault(str(root), fault, REFUSAL_MODEL)
        try:
            if side == "port":
                load_candidate_variables(_cfg(root, REFUSAL_MODEL),
                                         track="latest", log=lambda *a: None,
                                         device="cpu")
            else:
                jax_lifecycle["load"](root)
            outcomes[side] = "ok"
        except (SwapRejected, jax_lifecycle["rejected"]) as e:
            reason = next(r for r in ("missing", "checksum mismatch",
                                      "manifest") if r in str(e))
            outcomes[side] = (e.cause, reason)
    assert outcomes["port"] == outcomes["tpuic"]
    assert outcomes["port"][0] == "swap_corrupt"
    if fault == "flipped_with_intact_prev":
        mgr = CheckpointManager(str(tmp_path / "port"), REFUSAL_MODEL,
                                log=lambda m: None)
        state = create_train_state(_model(7, name=REFUSAL_MODEL),
                                   make_optimizer(OCFG))
        mgr.restore_into(state, track="latest")
        assert mgr.last_restore_rung == "latest.prev"
        assert variables_digest(state.model) == variables_digest(
            _model(0, name=REFUSAL_MODEL))


def test_unreadable_payload_and_partial_restore(tmp_path):
    """restore_exact raises on a payload it cannot read (no fallback);
    the candidate loader turns that into ``swap_corrupt``, and a
    checkpoint of another class count into a ``ValueError``."""
    mgr = _commit(tmp_path)
    payload = os.path.join(mgr.root, "latest", "state.pt")
    with open(payload, "r+b") as f:
        f.truncate(100)
    os.remove(os.path.join(mgr.root, "latest.manifest.json"))
    state = create_train_state(_model(1), make_optimizer(OCFG))
    with pytest.raises(Exception):
        mgr.restore_exact(state, "latest")
    assert mgr.last_restore_rung == "latest"
    _commit(tmp_path, seed=2)
    os.remove(os.path.join(mgr.root, "config.json"))  # no sidecar to fix it
    cfg = _cfg(tmp_path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=5))
    with pytest.raises(ValueError, match="restored only"):
        load_candidate_variables(cfg, track="latest", log=lambda *a: None,
                                 device="cpu")
    with open(payload, "r+b") as f:
        f.truncate(100)
    from tpuic_torch.checkpoint.manager import _dir_manifest
    with open(os.path.join(mgr.root, "latest.manifest.json"), "w") as f:
        json.dump({"version": 1, "files": _dir_manifest(
            os.path.join(mgr.root, "latest"))}, f)
    with pytest.raises(SwapRejected, match="failed to restore") as ei:
        load_candidate_variables(_cfg(tmp_path), track="latest",
                                 log=lambda *a: None, device="cpu")
    assert ei.value.cause == "swap_corrupt"


def test_failed_loads_never_touch_the_serving_engine(tmp_path):
    _commit(tmp_path, seed=4)
    eng = InferenceEngine(_model(0), image_size=SIZE, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 2), max_wait_ms=1.0,
                          device="cpu")
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    d0 = eng.model_digest
    stop, futs = threading.Event(), []

    def stream():
        i = 0
        while not stop.is_set():
            futs.append(eng.submit(_u8(i, 1)))
            i += 1
            time.sleep(0.002)

    t = threading.Thread(target=stream, daemon=True)
    t.start()
    try:
        _, cand = load_candidate_variables(_cfg(tmp_path), track="latest",
                                           log=lambda *a: None, device="cpu")
        assert cand != d0
        _flip(_largest(os.path.join(tmp_path, MODEL, "latest")))
        with pytest.raises(SwapRejected):
            load_candidate_variables(_cfg(tmp_path), track="latest",
                                     log=lambda *a: None, device="cpu")
    finally:
        stop.set()
        t.join(timeout=5.0)
    for f in futs:
        f.result(timeout=30)
    eng.close()
    assert eng.model_digest == d0 and eng.generation == 0
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- swap_weights against tpuic's engine -------------------------------------
@pytest.fixture(scope="module")
def trees():
    """Two numpy variables trees of ``tpuic``'s MODEL (traced shapes,
    seeded leaves: flax's default init by distribution)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from tpuic.models import create_model as jcreate
    jm = jcreate(MODEL, CLASSES, dtype="float32")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))

    def tree(seed):
        rng = np.random.default_rng(seed)

        def leaf(path, s):
            name = path[-1].key
            if name == "kernel":
                return (rng.standard_normal(s.shape)
                        / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
            if name in ("scale", "var"):
                return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

        return jax.tree_util.tree_map_with_path(leaf, shapes)

    return dict(jax=jax, jm=jm, A=tree(1), B=tree(2))


def _port_engine(tree, **kw):
    kw.setdefault("buckets", (1, 4))
    return InferenceEngine(
        create_model(MODEL, CLASSES, dtype="float32", fused_conv_bn=True,
                     device="cpu"), tree, image_size=SIZE,
        input_dtype=np.uint8, normalize=True, max_wait_ms=1.0,
        device="cpu", **kw)


def test_swap_weights_matches_tpuics_engine(trees):
    from tpuic.serve.engine import InferenceEngine as JaxEngine
    from tpuic.serve.engine import make_forward as jax_make_forward
    jax = trees["jax"]
    theirs = JaxEngine(forward_fn=jax_make_forward(trees["jm"],
                                                   normalize=True),
                       variables=trees["A"], image_size=SIZE,
                       input_dtype=np.uint8, buckets=(4,), max_wait_ms=1.0)
    ours = _port_engine(trees["A"], buckets=(4,))
    imgs = _u8(0, 4)
    digests = {"ours": [ours.model_digest], "theirs": [theirs.model_digest]}

    def answers(eng):
        futs = [eng.submit(imgs[:1]), eng.submit(imgs[1:])]
        return np.concatenate([np.asarray(f.result(timeout=120)[0])
                               for f in futs])

    try:
        for step, name in enumerate(("B", "A", "B")):
            a, b = answers(ours), answers(theirs)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            res = {"ours": ours.swap_weights(trees[name]),
                   "theirs": theirs.swap_weights(jax.tree.map(
                       np.asarray, trees[name]))}
            assert res["ours"]["generation"] == res["theirs"][
                "generation"] == step + 1
            assert res["ours"]["reused_executables"] and \
                res["theirs"]["reused_executables"]
            for side, eng in (("ours", ours), ("theirs", theirs)):
                assert eng.generation == step + 1
                assert eng.stats.snapshot()["swaps"] == step + 1
                assert eng.stats.snapshot()["generation"] == step + 1
                assert res[side]["digest"] == eng.model_digest
                digests[side].append(eng.model_digest)
        np.testing.assert_allclose(answers(ours), answers(theirs),
                                   rtol=1e-5, atol=1e-5)
        for side in digests:  # A, B, A, B
            d = digests[side]
            assert d[0] == d[2] != d[1] == d[3]
        for eng in (ours, theirs):
            with pytest.raises(ValueError, match="one unit"):
                eng.swap_weights(trees["A"], variants={"int8": trees["A"]})
            with pytest.raises(ValueError, match="one unit"):
                eng.swap_weights(None)
            with pytest.raises(ValueError, match="duplicate"):
                eng.swap_weights(trees["A"], variants={"fp32": trees["A"]})
            assert eng.generation == 3
    finally:
        ours.close()
        theirs.close()


def test_candidate_outputs_leave_traffic_untouched(trees):
    """The gate's outputs are the candidate's; what traffic sees stays
    the live weights' until swap_weights flips."""
    eng = _port_engine(trees["A"])
    imgs = _u8(1, 6)
    want_a = eng.predict(imgs[:4], timeout=60)[0]
    gate = eng.candidate_outputs(trees["B"], imgs)
    direct_b = make_forward(load_jax_variables(create_model(
        MODEL, CLASSES, dtype="float32", fused_conv_bn=True, device="cpu"),
        trees["B"]).eval(), normalize=True)(torch.from_numpy(imgs))
    np.testing.assert_allclose(gate[0], direct_b[0].numpy(), atol=1e-6)
    np.testing.assert_array_equal(gate[1][:, 0], direct_b[1][:, 0].numpy())
    np.testing.assert_array_equal(eng.predict(imgs[:4], timeout=60)[0],
                                  want_a)
    assert eng.generation == 0
    # The gate's candidate is in the standby already: swapping the same
    # object flips it without writing it again.
    writes, real = [], eng._write
    eng._write = lambda slot, cand: (writes.append(cand), real(slot, cand))
    res = eng.swap_weights(trees["B"])
    assert writes == [] and res["generation"] == 1
    assert res["digest"] == variables_digest(load_jax_variables(create_model(
        MODEL, CLASSES, dtype="float32", fused_conv_bn=True, device="cpu"),
        trees["B"]))
    np.testing.assert_allclose(eng.predict(imgs[:4], timeout=60)[0],
                               direct_b[0][:4].numpy(), atol=1e-6)
    eng.candidate_outputs(trees["A"], imgs)  # written: not the last one
    eng.swap_weights(trees["A"])
    assert len(writes) == 1
    del eng._write
    with pytest.raises(ValueError, match="unknown serve dtype"):
        eng.candidate_outputs(trees["B"], imgs, variant="int8")
    other = create_model(MODEL, 3, dtype="float32", fused_conv_bn=True,
                         device="cpu")
    with pytest.raises(ValueError, match="not shaped like"):
        eng.candidate_outputs(other, imgs)
    eng.close()


def test_swap_under_live_traffic_drops_nothing(trees):
    eng = _port_engine(trees["A"], buckets=(1, 2, 4))
    direct = {}
    for name in ("A", "B"):
        m = load_jax_variables(create_model(
            MODEL, CLASSES, dtype="float32", fused_conv_bn=True,
            device="cpu"), trees[name]).eval()
        direct[name] = make_forward(m, normalize=True)
    pool = _u8(2, 16)
    results, errors, swapped = [], [], threading.Event()

    def client(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(12):
                lo = int(rng.integers(0, 13))
                n = int(rng.integers(1, 4))
                after = swapped.is_set()
                out = eng.submit(pool[lo:lo + n]).result(timeout=60)
                results.append((lo, n, after, out[0]))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    res = eng.swap_weights(trees["B"])
    swapped.set()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    eng.close()
    assert not errors and len(results) == 48
    assert res["generation"] == 1
    seen = set()
    for lo, n, after, probs in results:
        x = torch.from_numpy(pool[lo:lo + n])
        match = [name for name in ("A", "B") if np.allclose(
            probs, direct[name](x)[0].numpy(), rtol=1e-5, atol=1e-5)]
        assert match, (lo, n)
        assert not after or match == ["B"], (lo, n)
        seen.update(match)
    assert eng.stats.snapshot()["requests"] == 48


def test_swap_to_other_shapes_builds_a_new_slot(trees):
    eng = _port_engine(trees["A"])
    eng.swap_weights(trees["B"])  # makes the standby
    other = init_params(create_model(MODEL, 3, dtype="float32",
                                     fused_conv_bn=True, device="cpu"), 9,
                        device="cpu").eval()
    res = eng.swap_weights(other)
    assert res["generation"] == 2 and eng.model is other
    assert eng._standby is None
    out = eng.predict(_u8(3, 2), timeout=60)
    assert out[0].shape == (2, 3)
    res = eng.swap_weights(init_params(create_model(
        MODEL, 3, dtype="float32", fused_conv_bn=True, device="cpu"), 8,
        device="cpu").state_dict())
    assert res["generation"] == 3 and eng._standby.model is other
    with pytest.raises(TypeError, match="swap candidate"):
        eng.swap_weights(42)
    eng.close()
    bare = InferenceEngine(forward_fn=lambda x: x.float().sum((1, 2, 3)),
                           image_size=SIZE, buckets=(1,), device="cpu",
                           autostart=False)
    with pytest.raises(ValueError, match="built from a model"):
        bare.swap_weights(trees["A"])


def _bad_state_dict(fault, seed):
    """A ``state_dict`` that ``load_state_dict`` refuses after it has
    written what matches: an extra key, a missing one, another head."""
    if fault == "other_classes":
        return init_params(create_model(MODEL, 3, dtype="float32",
                                        fused_conv_bn=True, device="cpu"),
                           seed, device="cpu").state_dict()
    sd = dict(_model(seed).state_dict())
    if fault == "extra_key":
        sd["extra.weight"] = torch.zeros(1)
    else:
        sd.pop(sorted(sd)[0])
    return sd


def _tensors(nest):
    if isinstance(nest, torch.Tensor):
        return [nest]
    items = nest.values() if isinstance(nest, dict) else nest
    return [t for x in items for t in _tensors(x)]


@pytest.mark.parametrize("fault", ["extra_key", "missing_key",
                                   "other_classes"])
def test_failed_swap_keeps_the_standbys_fold_targets(fault):
    """A swap whose state_dict fails to load raises and changes nothing
    served.  The standby's graphs read K3's folded weights from the
    tensors recorded at its first capture (on the card; set here by
    hand): the failed load must leave those as the model's fold, and the
    next swap must fold its weights into them, not into new tensors."""
    eng = InferenceEngine(_model(0), image_size=SIZE, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 4), max_wait_ms=1.0,
                          device="cpu")
    imgs = _u8(4, 4)
    try:
        eng.swap_weights(_model(1).state_dict())  # the standby: seed 0's
        standby = eng._standby
        standby.folded = tuple((m, m.packed_weights())
                               for m in standby.model.modules()
                               if hasattr(m, "_packed"))
        assert standby.folded
        identity = (eng.model_digest, eng.generation)
        served = eng.predict(imgs, timeout=60)[0]
        with pytest.raises(RuntimeError, match="state_dict"):
            eng.swap_weights(_bad_state_dict(fault, 2))
        assert (eng.model_digest, eng.generation) == identity
        np.testing.assert_array_equal(eng.predict(imgs, timeout=60)[0],
                                      served)
        assert all(m._packed is t for m, t in standby.folded)
        res = eng.swap_weights(_model(3).state_dict())
        assert eng._gen is standby and res["generation"] == 2
        fresh = _model(3)
        for (m, t), want in zip(standby.folded, (
                m for m in fresh.modules() if hasattr(m, "_packed"))):
            assert m._packed is t
            for got, ref in zip(_tensors(t),
                                _tensors(want.packed_weights())):
                assert torch.equal(got, ref)
        np.testing.assert_allclose(
            eng.predict(imgs, timeout=60)[0],
            make_forward(fresh, normalize=True)(torch.from_numpy(imgs))[0],
            rtol=1e-6, atol=1e-6)
    finally:
        eng.close()


# -- the CLI ------------------------------------------------------------------
@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The served checkpoint (seed 0), a candidate (seed 1), a NaN
    candidate and a byte-flipped copy of the candidate, and image
    files."""
    from PIL import Image
    root = tmp_path_factory.mktemp("lifecycle")
    out = {}
    for name, seed, nan in (("served", 0, False), ("cand", 1, False),
                            ("nan", 2, True)):
        _commit(root / name, seed=seed, nan=nan, track="best")
        out[name] = str(root / name)
    shutil.copytree(out["cand"], root / "flipped")
    _flip(_largest(str(root / "flipped" / MODEL / "best")))
    out["flipped"] = str(root / "flipped")
    rng = np.random.default_rng(0)
    out["images"] = []
    for i in range(4):
        p = str(root / f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (SIZE + 3, SIZE, 3),
                                     np.uint8)).save(p)
        out["images"].append(p)
    out["models"] = {"served": _model(0), "cand": _model(1)}
    return out


def _direct(model, paths):
    x = np.stack([pserve._load_image(p, SIZE) for p in paths])
    return make_forward(model, normalize=True)(torch.from_numpy(x))[0].numpy()


def _check(rec, model, path):
    want = _direct(model, [path])[0]
    order = np.argsort(-want, kind="stable")
    assert rec["pred"] == str(order[0])
    np.testing.assert_allclose([q for _, q in rec["topk"]], want[order[:2]],
                               atol=1e-5)


def _run_stdin(ckpts, lines, monkeypatch, tmp_path, *extra):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(x) + "\n" for x in lines)))
    out = tmp_path / "out.jsonl"
    assert pserve.main(["--device", "cpu", "--buckets", "1,2,4",
                        "--ckpt-dir", ckpts["served"], "--top-k", "2",
                        "--out", str(out), *extra]) == 0
    recs = {}
    for r in map(json.loads, out.read_text().splitlines()):
        recs.setdefault(r.get("id"), []).append(r)
    return recs


@pytest.mark.parametrize("how", ["synthetic", "checkpoint"])
def test_stdin_swap_line(ckpts, monkeypatch, tmp_path, capsys, how):
    img = ckpts["images"]
    swap = ({"op": "swap", "id": "s", "synthetic_seed": 4}
            if how == "synthetic" else
            {"op": "swap", "id": "s", "ckpt_dir": ckpts["cand"],
             "track": "best"})
    # Without --admission the SLA fields are ignored, as in tpuic: a
    # bogus priority is served.
    lines = ([{"id": "r0", "path": img[0]}, swap]
             + [{"id": f"r{i}", "path": img[i], "priority": "bogus"}
                for i in (1, 2)])
    recs = _run_stdin(ckpts, lines, monkeypatch, tmp_path)
    res = recs["s"][0]
    assert res["op"] == "swap_result" and res["ok"] and res["id"] == "s"
    assert res["generation"] == 1
    assert res["source"] == ("synthetic:4" if how == "synthetic" else
                             os.path.join(ckpts["cand"], MODEL, "best"))
    new = _model(4) if how == "synthetic" else ckpts["models"]["cand"]
    assert res["digest"] == variables_digest(new)
    for i in range(3):
        rec = recs[f"r{i}"][0]
        try:
            _check(rec, ckpts["models"]["served"], img[i])
        except AssertionError:
            _check(rec, new, img[i])
    err = capsys.readouterr().err
    assert "hot-swap OK" in err and '"swaps": 1' in err


def test_eval_images_are_tpuics():
    pytest.importorskip("jax")
    from tpuic.quant import eval_images as jax_eval_images
    for n, size in ((128, SIZE), (4, 224)):
        got, want = pserve.eval_images(n, size), jax_eval_images(n, size)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_stdin_admission_gives_typed_records(ckpts, monkeypatch, tmp_path,
                                             capsys):
    img = ckpts["images"]
    lines = [{"id": "q0", "path": img[0], "tenant": "capped"},
             {"id": "q1", "path": img[1], "tenant": "capped"},
             {"id": "late", "path": img[2], "deadline_ms": 1e-6,
              "priority": "high"},
             {"id": "bad", "path": img[2], "priority": "urgent"},
             {"id": "rung", "path": img[2], "serve_dtype": "int8"},
             {"id": "ok", "path": img[3], "priority": "low",
              "tenant": "free"}]
    recs = _run_stdin(ckpts, lines, monkeypatch, tmp_path, "--admission",
                      "--quota", "capped=1")
    _check(recs["q0"][0], ckpts["models"]["served"], img[0])
    _check(recs["ok"][0], ckpts["models"]["served"], img[3])
    assert recs["q1"][0]["cause"] == "quota"
    assert recs["late"][0]["cause"] == "deadline"
    assert recs["late"][0]["priority"] == "high"
    assert "unknown priority" in recs["bad"][0]["error"]
    assert "unknown serve dtype 'int8'" in recs["rung"][0]["error"]
    err = capsys.readouterr().err
    assert "admission control on" in err
    line = next(ln for ln in err.splitlines() if ln.startswith("[admission]"))
    rej = json.loads(line.split("rejected_by=", 1)[1])
    assert rej["quota"] == {"normal": 1} and rej["deadline"] == {"high": 1}
    assert set(rej) >= {"queue_full", "swap_corrupt", "swap_accuracy"}


def test_listen_swaps_and_verdicts(ckpts, tmp_path):
    """Over the socket: a swap by seed with requests in flight, then by
    checkpoint, then a byte-flipped and a NaN candidate refused with their
    causes (the digest stays), then back to the served checkpoint; pongs
    and the ready file carry each generation."""
    args = pserve.build_parser().parse_args(
        ["--device", "cpu", "--ckpt-dir", ckpts["served"], "--buckets",
         "1,2,4", "--max-wait-ms", "1"])
    eng, size, _, _ = pserve.build_engine(args)

    class Guard:
        triggered = False

    guard, ready_file = Guard(), str(tmp_path / "ready.json")
    t = threading.Thread(target=pserve.serve_socket, daemon=True,
                         kwargs=dict(engine=eng, listen="127.0.0.1:0",
                                     names={i: str(i) for i in range(10)},
                                     top_k=2, size=size, guard=guard,
                                     drain_timeout=5.0,
                                     ready_file=ready_file,
                                     log=lambda m: None))
    t.start()
    deadline = time.monotonic() + 30
    while (ready := wire.read_ready_file(ready_file)) is None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    import socket
    sock = socket.create_connection(("127.0.0.1", ready["port"]), timeout=60)
    buf = [b""]

    def ask(lines, until):
        sock.sendall("".join(json.dumps(x) + "\n" for x in lines).encode())
        got = {}
        while until not in got:
            chunk = sock.recv(1 << 16)
            assert chunk
            *recs, buf[0] = (buf[0] + chunk).split(b"\n")
            for r in recs:
                if r.strip():
                    rec = json.loads(r)
                    got[rec.get("id")] = rec
        return got

    img = ckpts["images"]
    served, cand = ckpts["models"]["served"], ckpts["models"]["cand"]
    seed5 = _model(5)
    try:
        got = ask([{"op": "ping", "id": "p0"}]
                  + [{"id": f"a{i}", "path": img[i]} for i in range(4)]
                  + [{"op": "swap", "id": "s1", "synthetic_seed": 5}]
                  + [{"id": f"b{i}", "path": img[i]} for i in range(4)]
                  + [{"op": "ping", "id": "p1"}], "s1")
        assert got["p0"]["generation"] == 0
        assert got["s1"]["op"] == "swap_result" and got["s1"]["ok"]
        assert got["s1"]["digest"] == variables_digest(seed5)
        got.update(ask([{"op": "ping", "id": "p2"}], "p2"))
        assert (got["p2"]["digest"], got["p2"]["generation"]) == (
            variables_digest(seed5), 1)
        ready = wire.read_ready_file(ready_file)
        assert (ready["digest"], ready["generation"]) == (
            variables_digest(seed5), 1)
        for i in range(4):
            for key in (f"a{i}", f"b{i}"):
                if key in got:
                    try:
                        _check(got[key], served, img[i])
                    except AssertionError:
                        _check(got[key], seed5, img[i])
        got = ask([{"op": "swap", "id": "s2", "ckpt_dir": ckpts["cand"],
                    "track": "best"}], "s2")
        assert got["s2"]["ok"] and got["s2"]["generation"] == 2
        assert got["s2"]["reused_executables"] is True
        got = ask([{"id": f"c{i}", "path": img[i]} for i in range(4)], "c3")
        for i in range(4):
            _check(got[f"c{i}"], cand, img[i])
        for sid, root, cause in (("s3", ckpts["flipped"], "swap_corrupt"),
                                 ("s4", ckpts["nan"], "swap_accuracy")):
            got = ask([{"op": "swap", "id": sid, "ckpt_dir": root,
                        "track": "best"}, {"op": "ping", "id": "p" + sid}],
                      sid)
            assert got[sid]["cause"] == cause, got[sid]
            got.update(ask([{"op": "ping", "id": "q" + sid}], "q" + sid))
            assert (got["q" + sid]["digest"], got["q" + sid]["generation"]) \
                == (variables_digest(cand), 2)
        got = ask([{"op": "swap", "id": "s5"}], "s5")  # the served ckpt
        assert got["s5"]["ok"] and got["s5"]["generation"] == 3
        got = ask([{"id": f"d{i}", "path": img[i]} for i in range(4)], "d3")
        for i in range(4):
            _check(got[f"d{i}"], served, img[i])
    finally:
        sock.close()
        guard.triggered = True
        t.join(timeout=10)
        eng.close()
    assert eng.stats.snapshot()["swaps"] == 3


# -- on the card ------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_replays_after_a_swap_are_the_new_weights_bits():
    """The stale-fold trap: the graphs bake in K3's folded weights, and a
    load into a model drops its fold.  After each same-shape swap every
    bucket's replay equals, bit for bit, an eager forward of a separate
    model holding the swapped-in weights; the graph memory stays flat."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine captures CUDA graphs")
    size = 32
    models = [init_params(create_model("resnet18", 10, dtype="float32",
                                       fused_conv_bn=True, image_size=size),
                          s).eval() for s in (0, 1)]
    eng = InferenceEngine(init_params(create_model(
        "resnet18", 10, dtype="float32", fused_conv_bn=True,
        image_size=size), 0), image_size=size, input_dtype=np.uint8,
        normalize=True, buckets=(1, 4), max_wait_ms=1.0)
    eng.warmup()
    x = torch.from_numpy(_u8(0, 4, size)).cuda()
    memory = []
    for step, k in enumerate((1, 0, 1, 0)):
        res = eng.swap_weights(models[k].state_dict())
        assert res["reused_executables"] == (step > 0)
        eager = make_forward(models[k], normalize=True)
        for b in (1, 4):
            want = eager(x[:b])
            got = [t.clone() for t in eng.replay(b, x[:b])]
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        memory.append(eng.graph_memory())
    eng.close()
    assert memory[1] == memory[3] and memory[1]["slots"] == 2


@pytest.mark.cuda
def test_cuda_a_failed_swap_leaves_no_stale_fold():
    """A swap whose state_dict fails to load (an extra key: torch writes
    every matching tensor first) raises; the next valid swap's replays
    are bit for bit an eager forward of its weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine captures CUDA graphs")
    size = 32

    def model(seed):
        return init_params(create_model("resnet18", 10, dtype="float32",
                                        fused_conv_bn=True,
                                        image_size=size), seed).eval()

    eng = InferenceEngine(model(0), image_size=size, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 4), max_wait_ms=1.0)
    eng.warmup()
    x = torch.from_numpy(_u8(0, 4, size)).cuda()
    eng.swap_weights(model(1).state_dict())  # the standby: seed 0's graphs
    bad = dict(model(2).state_dict())
    bad["extra.weight"] = torch.zeros(1, device="cuda")
    with pytest.raises(RuntimeError, match="state_dict"):
        eng.swap_weights(bad)
    new = model(3)
    res = eng.swap_weights(new.state_dict())
    assert res["generation"] == 2 and res["reused_executables"]
    eager = make_forward(new, normalize=True)
    for b in (1, 4):
        want = eager(x[:b])
        got = [t.clone() for t in eng.replay(b, x[:b])]
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    eng.close()


@pytest.mark.cuda
def test_cuda_staging_buffers_wait_for_their_copies(monkeypatch):
    """Every page-locked staging buffer the batcher hands out has its last
    copy's event completed, and host requests come back right."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned staging copies to the card")
    size = 32
    model = init_params(create_model("resnet18", 10, dtype="float32",
                                     fused_conv_bn=True, image_size=size), 0)
    eng = InferenceEngine(model, image_size=size, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 4), max_wait_ms=0.5)
    eng.warmup()
    handed, real = [], eng._pinned

    def checked(bucket):
        buf, ev = real(bucket)
        handed.append((buf.is_pinned(), ev.query()))
        return buf, ev

    monkeypatch.setattr(eng, "_pinned", checked)
    pool = _u8(1, 16, size)
    futs = [(i, eng.submit(pool[i:i + 1 + i % 4])) for i in range(12)]
    got = [(i, f.result(timeout=120)[0]) for i, f in futs]
    eng.close()
    eager = make_forward(eng.model, normalize=True)
    for i, probs in got:
        want = eager(torch.from_numpy(pool[i:i + 1 + i % 4]).cuda())[0]
        np.testing.assert_allclose(probs, want.cpu().numpy(), atol=1e-5)
    assert handed and all(p and q for p, q in handed)
    assert eng.host_requests == 12
    assert set(eng.graph_memory()["pinned_bytes"]) == {"1", "4"}
