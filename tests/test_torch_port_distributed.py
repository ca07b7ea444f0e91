"""Port parity: data-parallel training of ``tpuic_torch`` against
``tpuic`` on a 2-device ``data`` mesh, with two gloo ranks on the CPU.

Each multi-rank scenario starts its two processes once, in a
module-scoped fixture (``python -c`` running :func:`_rank_main` of this
file, the ``TPUIC_*`` trio in the environment), and the tests read what
the ranks wrote.  ``tpuic`` runs in the test process on
``make_mesh(MeshConfig(data=2), jax.devices()[:2])``.

- Three train steps of ``resnet18-cifar`` (32x32, global batch 8, 4 a
  rank) with the fused loss, fused LARS, the reference's 7 class weights,
  label smoothing 0.1 and a padded row, the labels spread unevenly over
  the ranks, from weights and optimizer state carried from ``tpuic``:
  loss, gradient norm and accuracy per step, then parameters, BN
  statistics and the optimizer trace, to the tolerances of
  ``test_torch_port_train.py::test_three_train_steps_match_tpuic``.  The
  gradients keep their addresses under DDP, and both ranks end equal.
- The control: a per-rank mean loss (``data_parallel=False``) under the
  same DDP fails that comparison.
- The aux tuple's global normalizer (main + 0.4 aux), both impls.
- SyncBN in both ``f32_stats`` modes against flax's BN on the mesh.
- The ``Loader``'s shard math against ``tpuic``'s, 1, 2 and 4 simulated
  ranks in one process; the half-set trio raising.
- The misclassified ids and the confusion matrix of a val pass against
  ``tpuic``'s ``Trainer`` on the mesh.
- ``python -m tpuic_torch.train`` as two processes for one epoch: process
  0 alone writes under the checkpoint and log dirs, both end with equal
  weights, and a resume restores the same save on both.

JAX and ``tpuic`` are imported inside fixtures, so the ``cuda`` tests of
this file collect where JAX is not installed.
"""

import contextlib
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuic_torch import config as pcfg
from tpuic_torch import models as port_models
from tpuic_torch.checkpoint import load_jax_opt_state, load_jax_variables
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.pipeline import Loader
from tpuic_torch.data.synthetic import make_synthetic_imagefolder
from tpuic_torch.models.layers import BatchNorm
from tpuic_torch.runtime import distributed
from tpuic_torch.train import loss as ploss
from tpuic_torch.train import step as pstep
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 2
CLASSES = 7
WEIGHTS = (3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0)
OPTIM = dict(optimizer="lars", learning_rate=0.1, milestones=(),
             class_weights=WEIGHTS, weight_decay=1e-4, label_smoothing=0.1,
             fused_loss=True, fused_optimizer=True)
GLOBAL = 8
SIZE = 32
STEPS = 3
# test_torch_port_train.py::test_three_train_steps_match_tpuic's: loss and
# accuracy, parameters and the LARS trace, BN statistics.
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
# The gradient norm of this net in float32 moves by up to 4.3e-4 between
# tpuic's own runs of these steps on the 2-device mesh and on one device
# (batches of seeds 6-11), and the port's one-process run of seed 6's
# global batches lies 7.5e-5 to 4.1e-4 from tpuic's mesh run; so against
# tpuic it is held to rtol 1e-3.  Against the port's own
# one-process run of the global batch the 2-rank run is held to the
# tolerances in ``test_two_ranks_equal_one_process_on_the_global_batch``.
GRAD_NORM_TOL = dict(rtol=1e-3, atol=1e-6)
VAL_CLASSES = ("a", "b", "c")


# -- the ranks ----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(workdir: str, argv=None) -> list:
    """Start ``WORLD`` processes of one group: :func:`_rank_main` on
    ``workdir``, or with ``argv`` the train CLI through :data:`_CLI_RANK`."""
    port = _free_port()
    if argv is None:
        cmd = ["-c", f"import sys; sys.path.insert(0, {HERE!r}); "
                     "import test_torch_port_distributed as t; "
                     f"t._rank_main({workdir!r})"]
    else:
        cmd = ["-c", _CLI_RANK, workdir, *argv]
    return [subprocess.Popen(
        [sys.executable, *cmd], cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=subprocess_env(
            PYTHONPATH=ROOT, TPUIC_COORDINATOR_ADDRESS=f"localhost:{port}",
            TPUIC_NUM_PROCESSES=str(WORLD), TPUIC_PROCESS_ID=str(r)))
        for r in range(WORLD)]


def _finish(procs: list, timeout: float = 600.0) -> list:
    """The processes' output; raises with it if one failed (and kills
    what is left)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{o[-4000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def _port_state(init: dict):
    """A port model and train state from the carried ``init``."""
    mcfg = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                            dtype="float32")
    ocfg = pcfg.OptimConfig(**OPTIM)
    model = port_models.create_model_from_config(mcfg, device="cpu")
    model.load_state_dict(init["model"])
    state = create_train_state(model, make_optimizer(ocfg, STEPS, 10))
    state.opt_state.count.copy_(init["count"])
    for dst, src in zip(state.opt_state.trace, init["trace"]):
        dst.copy_(src)
    return mcfg, ocfg, state


def _shard(batch: dict, rank: int) -> dict:
    lb = GLOBAL // WORLD
    return {k: torch.from_numpy(v[rank * lb:(rank + 1) * lb])
            for k, v in batch.items()}


def _rank_train(inp: dict, rank: int) -> dict:
    """The 3 steps through the data-parallel step: metrics, gradient
    addresses per step, the final state."""
    mcfg, ocfg, state = _port_state(inp["init"])
    step = pstep.make_train_step(ocfg, mcfg,
                                 lr_schedule=make_schedule(ocfg, STEPS, 10),
                                 device="cpu")
    metrics, ptrs = [], []
    for batch in inp["batches"]:
        state, m = step(state, _shard(batch, rank))
        metrics.append({k: float(v) for k, v in m.items()})
        ptrs.append([p.grad.data_ptr() for p in state.params])
    return {"metrics": metrics, "grad_ptrs": ptrs,
            "model": {k: v.numpy() for k, v in
                      state.model.state_dict().items()},
            "trace": [t.numpy() for t in state.opt_state.trace],
            "count": int(state.opt_state.count), "step": int(state.step)}


@contextlib.contextmanager
def _per_rank_mean():
    """The naive normalizer: each rank's loss divided by its own sum(w)."""
    real = pstep.classification_loss
    pstep.classification_loss = lambda *a, **k: real(
        *a, **dict(k, data_parallel=False))
    try:
        yield
    finally:
        pstep.classification_loss = real


def _rank_aux(inp: dict, rank: int) -> dict:
    """Each rank's share of the aux tuple's loss and its logits' grads."""
    a = inp["aux"]
    lb = GLOBAL // WORLD
    rows = slice(rank * lb, (rank + 1) * lb)
    out = {}
    for impl in ploss.LOSS_IMPLS:
        main = torch.tensor(a["main"][rows], requires_grad=True)
        aux = torch.tensor(a["aux"][rows], requires_grad=True)
        loss = ploss.classification_loss(
            (main, aux), torch.from_numpy(a["labels"][rows]),
            class_weights=torch.tensor(WEIGHTS),
            mask=torch.from_numpy(a["mask"][rows]), label_smoothing=0.1,
            impl=impl, data_parallel=True)
        loss.backward()
        out[impl] = (float(loss), main.grad.numpy(), aux.grad.numpy())
    return out


def _rank_bn(inp: dict, rank: int) -> dict:
    """SyncBN on this rank's rows, both ``f32_stats`` modes: outputs,
    running statistics, and (float32) the input and affine gradients of
    ``sum(y * cot)``."""
    b = inp["bn"]
    lb = GLOBAL // WORLD
    rows = slice(rank * lb, (rank + 1) * lb)
    out = {}
    for f32 in (True, False):
        dtype = torch.float32 if f32 else torch.bfloat16
        c = b["x"].shape[-1]
        bn = BatchNorm(c, dtype=dtype, f32_stats=f32, device="cpu")
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(b["scale"]))
            bn.bias.copy_(torch.from_numpy(b["bias"]))
        bn.train()
        x = torch.tensor(b["x"][rows]).permute(0, 3, 1, 2).to(dtype)
        x.requires_grad_(True)
        y = bn(x)
        res = {"y": y.float().permute(0, 2, 3, 1).detach().numpy(),
               "mean": bn.running_mean.numpy().copy(),
               "var": bn.running_var.numpy().copy()}
        if f32:
            cot = torch.from_numpy(b["cot"][rows]).permute(0, 3, 1, 2)
            torch.sum(y * cot).backward()
            res.update(dx=x.grad.permute(0, 2, 3, 1).numpy(),
                       dscale=bn.weight.grad.numpy(),
                       dbias=bn.bias.grad.numpy())
        out["f32" if f32 else "bf16"] = res
    return out


def _val_config(root: str, work: str):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=root, resize_size=SIZE, batch_size=2,
                             val_batch_size=3, num_workers=2, native=False,
                             pack=False),
        model=pcfg.ModelConfig(name="resnet18-cifar", num_classes=0,
                               dtype="float32"),
        optim=pcfg.OptimConfig(optimizer="adam", learning_rate=1e-3,
                               class_weights=(), milestones=()),
        run=pcfg.RunConfig(epochs=1, ckpt_dir=os.path.join(work, "ck"),
                           resume=False, collect_misclassified=True,
                           per_class_metrics=True))


def _rank_val(inp: dict, rank: int, workdir: str) -> dict:
    """A val pass of the port's Trainer over ``tpuic``'s weights."""
    from tpuic_torch.train.loop import Trainer
    log_dir = os.path.join(workdir, "val_logs")
    t = Trainer(_val_config(inp["val_root"], workdir), device="cpu",
                log_dir=log_dir)
    t.model.load_state_dict(inp["val_model"])
    score = t.val_epoch(0)
    return {"score": score, "loss": t.last_val["loss"],
            "misclassified": t.last_misclassified,
            "confusion": t.last_confusion, "logger_root": t.logger.root,
            "batches": len(t.val_loader)}


def _rank_main(workdir: str) -> None:
    """One rank: join the group from the trio, run every scenario on
    ``workdir``'s inputs, write ``rank{r}.pkl``."""
    info = distributed.initialize(device="cpu")
    rank = info.process_index
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"info": (info.process_index, info.process_count),
           "train": _rank_train(inp, rank)}
    with _per_rank_mean():
        out["naive"] = _rank_train(inp, rank)
    out.update(aux=_rank_aux(inp, rank), bn=_rank_bn(inp, rank),
               val=_rank_val(inp, rank, workdir))
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    distributed.shutdown()


# One rank of ``python -m tpuic_torch.train`` (run as ``__main__`` through
# runpy), with an audit hook that records every write under the run's
# directories and a wrap of ``Trainer.fit`` that reports the weights.
_CLI_RANK = r'''
import json, os, runpy, sys, zlib
out_dir, argv = sys.argv[1], sys.argv[2:]
watched = [os.path.realpath(argv[argv.index(f) + 1])
           for f in ("--ckpt-dir", "--log-dir")]
writes = []

def _under(path):
    try:
        p = os.path.realpath(os.fsdecode(path))
    except TypeError:
        return False
    return any(p == w or p.startswith(w + os.sep) for w in watched)

def _audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        mode, flags = args[1] or "", args[2] or 0
        writing = any(c in mode for c in "wax+") or flags & (
            os.O_WRONLY | os.O_RDWR | os.O_CREAT)
        if writing and _under(args[0]):
            writes.append(["open", os.fsdecode(args[0])])
    elif event in ("os.rename", "os.replace", "os.mkdir", "os.remove",
                   "os.rmdir", "shutil.rmtree") and _under(args[0]):
        writes.append([event, os.fsdecode(args[0])])

sys.addaudithook(_audit)
from tpuic_torch.runtime import distributed
from tpuic_torch.train import loop
_fit = loop.Trainer.fit

def fit(self, *a, **k):
    best = _fit(self, *a, **k)
    sd = self.model.state_dict()
    digest = 0
    for name in sorted(sd):
        digest = zlib.crc32(sd[name].contiguous().numpy().tobytes(), digest)
    rec = {"rank": self.rank, "world": self.world, "best": best,
           "start_epoch": self.start_epoch, "digest": digest,
           "rung": self.ckpt.last_restore_rung, "step": int(self.state.step),
           "writes": list(writes)}
    path = os.path.join(out_dir, "rank%d.json" % self.rank)
    with open(path, "w") as f:
        json.dump(rec, f)
    return best

loop.Trainer.fit = fit
sys.argv = ["python -m tpuic_torch.train"] + argv
runpy.run_module("tpuic_torch.train", run_name="__main__", alter_sys=True)
'''


# -- the reference ------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from tpuic import config as jcfg
    from tpuic.data import folder as jfolder
    from tpuic.data import pipeline as jpipe
    from tpuic.models import create_model_from_config
    from tpuic.models import layers as jlayers
    from tpuic.runtime.mesh import make_mesh
    from tpuic.train import loss as jloss
    from tpuic.train import optimizer as jopt
    from tpuic.train.loop import Trainer as JTrainer
    from tpuic.train.state import create_train_state as jstate
    from tpuic.train.step import make_train_step as jtrain
    mesh = make_mesh(jcfg.MeshConfig(data=WORLD), jax.devices()[:WORLD])
    return dict(jax=jax, jnp=jnp, cfg=jcfg, folder=jfolder, pipe=jpipe,
                create=create_model_from_config, layers=jlayers, opt=jopt,
                loss=jloss, trainer=JTrainer, state=jstate, train=jtrain,
                mesh=mesh, data=NamedSharding(mesh, PartitionSpec("data")))


def _np(tree, jax):
    return jax.tree.map(np.asarray, tree)


def _batches(seed: int = 7) -> list:
    """``STEPS`` global batches whose labels sit unevenly on the ranks:
    rank 0's rows draw from the heavy classes (weights 10, 5, 4), rank
    1's from the light ones (1, 3, 3); the global batch's last row is
    padding.

    This net's float32 steps are ill-conditioned at these batch sizes (see
    ``test_three_train_steps_match_tpuic``): after 3 steps ``tpuic``'s own
    runs on the 2-device mesh and on one device differ by up to 3.7e-5
    (seed 6), 4.6e-5 (seed 7) and 1.0e-4 (seed 8) in a parameter, and the
    port's one-process run lies 7.4e-5, 2.3e-5 and 3.0e-5 from the mesh
    run.  Seed 7's batches are ones on which the float32 runs agree within
    the train test's tolerances, as that test's are."""
    rng = np.random.default_rng(seed)
    lb = GLOBAL // WORLD
    out = []
    for _ in range(STEPS):
        labels = np.concatenate([rng.choice([2, 6, 4], lb),
                                 rng.choice([3, 0, 1], lb)]).astype(np.int32)
        out.append({
            "image": rng.standard_normal((GLOBAL, SIZE, SIZE, 3)).astype(
                np.float32),
            "label": labels,
            "mask": np.array([1.0] * (GLOBAL - 1) + [0.0], np.float32)})
    return out


def _folder(root: str, train_per_class: int = 4) -> str:
    make_synthetic_imagefolder(root, classes=VAL_CLASSES,
                               per_class=train_per_class, size=SIZE,
                               folds=("train",))
    make_synthetic_imagefolder(root, classes=VAL_CLASSES, per_class=5,
                               size=SIZE, folds=("val",), seed=1)
    return root


def _jax_val(jx, root: str, log_dir: str):
    """``tpuic``'s Trainer on the mesh with the val config's settings."""
    c = jx["cfg"]
    cfg = c.Config(
        data=c.DataConfig(data_dir=root, resize_size=SIZE, batch_size=2,
                          val_batch_size=3, num_workers=2, native=False,
                          pack=False),
        model=c.ModelConfig(name="resnet18-cifar", num_classes=0,
                            dtype="float32"),
        optim=c.OptimConfig(optimizer="adam", learning_rate=1e-3,
                            class_weights=(), milestones=()),
        run=c.RunConfig(epochs=1, ckpt_dir=os.path.join(log_dir, "ck"),
                        resume=False, collect_misclassified=True,
                        per_class_metrics=True),
        mesh=c.MeshConfig(data=WORLD))
    return jx["trainer"](cfg, mesh=jx["mesh"], log_dir=log_dir)


def _bn_inputs(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    c = 6
    return {"x": (2.0 * rng.standard_normal((GLOBAL, 3, 3, c))
                  + 0.5).astype(np.float32),
            "cot": rng.standard_normal((GLOBAL, 3, 3, c)).astype(np.float32),
            "scale": (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}


def _aux_inputs(seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {"main": rng.standard_normal((GLOBAL, CLASSES)).astype(
                np.float32),
            "aux": rng.standard_normal((GLOBAL, CLASSES)).astype(np.float32),
            "labels": _batches()[0]["label"],
            "mask": _batches()[0]["mask"]}


@pytest.fixture(scope="module")
def parity(jx, tmp_path_factory):
    """Inputs carried from ``tpuic``, the two ranks started on them, the
    references computed on the mesh while they run, the ranks' results."""
    jax, jnp = jx["jax"], jx["jnp"]
    work = str(tmp_path_factory.mktemp("ddp_parity"))
    mcfg = jx["cfg"].ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                                 dtype="float32")
    ocfg = jx["cfg"].OptimConfig(**OPTIM)
    jstate = jx["state"](jx["create"](mcfg), jx["opt"].make_optimizer(
        ocfg, STEPS, 10), jax.random.key(0), (GLOBAL, SIZE, SIZE, 3))
    s0 = _np(jstate, jax)
    model = port_models.create_model_from_config(
        pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                         dtype="float32"), device="cpu")
    load_jax_variables(model, {"params": s0.params,
                               "batch_stats": s0.batch_stats})
    opt = load_jax_opt_state(s0.opt_state,
                             [n for n, _ in model.named_parameters()],
                             device="cpu")
    root = _folder(os.path.join(work, "folder"))
    jval = _jax_val(jx, root, os.path.join(work, "jax_logs"))
    vmodel = port_models.create_model("resnet18-cifar", len(VAL_CLASSES),
                                      dtype="float32", device="cpu")
    load_jax_variables(vmodel, {
        "params": _np(jval.state.params, jax),
        "batch_stats": _np(jval.state.batch_stats, jax)})
    batches = _batches()
    inp = {"init": {"model": model.state_dict(), "count": opt.count,
                    "trace": list(opt.trace)},
           "batches": batches, "aux": _aux_inputs(), "bn": _bn_inputs(),
           "val_root": root, "val_model": vmodel.state_dict()}
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    procs = _start(work)
    try:
        # The references, on the mesh, while the ranks run.
        jstep = jx["train"](ocfg, mcfg, jx["mesh"],
                            lr_schedule=jx["opt"].make_schedule(ocfg, STEPS,
                                                                10),
                            donate=False)
        jmetrics = []
        for batch in batches:
            jstate, m = jstep(jstate, {k: jax.device_put(jnp.asarray(v),
                                                         jx["data"])
                                       for k, v in batch.items()})
            jmetrics.append({k: float(v) for k, v in m.items()})
        # The port in one process on the global batch.
        mcfg1, ocfg1, state1 = _port_state(inp["init"])
        step1 = pstep.make_train_step(
            ocfg1, mcfg1, lr_schedule=make_schedule(ocfg1, STEPS, 10),
            device="cpu")
        one = []
        for batch in batches:
            state1, m = step1(state1, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
            one.append({k: float(v) for k, v in m.items()})
        ref = {"metrics": jmetrics, "state": _np(jstate, jax),
               "one_process": {"metrics": one, "model": {
                   k: v.numpy() for k, v in state1.model.state_dict().items()},
                   "trace": [t.numpy() for t in state1.opt_state.trace]},
               "val_score": jval.val_epoch(0),
               "val_misclassified": list(jval.last_misclassified),
               "val_confusion": np.load(os.path.join(
                   work, "jax_logs", "confusion_e0.npy"))}
    finally:
        _finish(procs)
    got = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return {"ref": ref, "got": got, "inputs": inp, "work": work}


def _compare(jx, ref: dict, arm: dict) -> None:
    """``arm``'s metrics and final state against the reference's, to the
    stated tolerances; raises AssertionError where they differ."""
    for k, (jm, m) in enumerate(zip(ref["metrics"], arm["metrics"])):
        for key in ("loss", "grad_norm", "accuracy", "lr", "skipped",
                    "skip_count"):
            tol = GRAD_NORM_TOL if key == "grad_norm" else METRIC_TOL
            np.testing.assert_allclose(m[key], jm[key], err_msg=f"step {k} "
                                       f"{key}", **tol)
    assert arm["step"] == int(ref["state"].step) == STEPS
    want_model = port_models.create_model("resnet18-cifar", CLASSES,
                                          dtype="float32", device="cpu")
    load_jax_variables(want_model, {"params": ref["state"].params,
                                    "batch_stats":
                                        ref["state"].batch_stats})
    want = want_model.state_dict()
    for name, got in arm["model"].items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = STATS_TOL if "running" in name else PARAM_TOL
        np.testing.assert_allclose(got, want[name].numpy(), err_msg=name,
                                   **tol)
    carried = load_jax_opt_state(
        ref["state"].opt_state, [n for n, _ in want_model.named_parameters()],
        device="cpu")
    assert int(carried.count) == arm["count"]
    for a, b in zip(arm["trace"], carried.trace):
        np.testing.assert_allclose(a, b.numpy(), **PARAM_TOL)


def test_two_rank_train_steps_match_tpuic_on_a_data_mesh(jx, parity):
    """Both ranks against ``tpuic``'s 3 steps on the 2-device mesh: the
    global loss and accuracy, the gradient norm after DDP's all-reduce,
    then parameters, BN statistics (SyncBN: global batch statistics) and
    the LARS trace; the ranks' states are equal bit for bit."""
    a, b = (g["train"] for g in parity["got"])
    for arm in (a, b):
        _compare(jx, parity["ref"], arm)
    assert a["metrics"] == b["metrics"]
    for name in a["model"]:
        np.testing.assert_array_equal(a["model"][name], b["model"][name],
                                      err_msg=name)
    for x, y in zip(a["trace"], b["trace"]):
        np.testing.assert_array_equal(x, y)
    assert [g["info"] for g in parity["got"]] == [(0, WORLD), (1, WORLD)]


def test_two_ranks_equal_one_process_on_the_global_batch(parity):
    """The 2-rank steps against the port's own one-process steps on the
    same global batch of 8: loss and accuracy rtol 1e-6, the gradient norm
    rtol 1e-4 (float32 sums in another order through 3 LARS steps of an
    ill-conditioned net), parameters, BN statistics and trace within
    atol 1e-5."""
    one = parity["ref"]["one_process"]
    got = parity["got"][0]["train"]
    for k, (a, b) in enumerate(zip(got["metrics"], one["metrics"])):
        for key in ("loss", "accuracy", "lr", "skipped"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {k} {key}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-4, err_msg=f"step {k}")
    for name, want in one["model"].items():
        np.testing.assert_allclose(got["model"][name], want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for a, b in zip(got["trace"], one["trace"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_gradients_keep_their_addresses_under_ddp(parity):
    """DDP copies each reduced bucket back into ``p.grad``: the tensors
    the K2 leaf table points at stay put from step to step."""
    for g in parity["got"]:
        ptrs = g["train"]["grad_ptrs"]
        assert ptrs[0] == ptrs[1] == ptrs[2]


def test_per_rank_mean_loss_fails_the_same_comparison(jx, parity):
    """The control: each rank dividing by its own ``sum(w)`` (rank 0's
    heavy classes against rank 1's light ones) gives another loss and
    another gradient, and the comparison above catches it."""
    naive = parity["got"][0]["naive"]
    with pytest.raises(AssertionError):
        _compare(jx, parity["ref"], naive)
    rel = abs(naive["metrics"][0]["loss"]
              - parity["ref"]["metrics"][0]["loss"]) \
        / parity["ref"]["metrics"][0]["loss"]
    assert rel > 100 * METRIC_TOL["rtol"]


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_aux_tuple_takes_the_global_normalizer(jx, parity, impl):
    """main + 0.4 aux: the mean of the ranks' shares is ``tpuic``'s loss of
    the global batch, and each rank's logits gradient over the world size
    is that loss's gradient at its rows (DDP's mean), rtol 1e-5."""
    jax, jnp = jx["jax"], jx["jnp"]
    a = parity["inputs"]["aux"]

    def loss(main, aux):
        return jx["loss"].classification_loss(
            (main, aux), jnp.asarray(a["labels"]),
            class_weights=jnp.asarray(WEIGHTS), mask=jnp.asarray(a["mask"]),
            label_smoothing=0.1)

    want, (gmain, gaux) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(a["main"]), jnp.asarray(a["aux"]))
    shares = [g["aux"][impl] for g in parity["got"]]
    np.testing.assert_allclose(np.mean([s[0] for s in shares]), float(want),
                               rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([s[1] for s in shares]) / WORLD,
                               np.asarray(gmain), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([s[2] for s in shares]) / WORLD,
                               np.asarray(gaux), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_sync_bn_matches_flax_bn_on_the_mesh(jx, parity, mode):
    """Train-mode BN over the global batch: flax's ``batch_norm`` jitted
    with the batch sharded over the ``data`` axis, against each rank's
    SyncBN on its rows.  float32 (``f32_stats``): outputs rtol/atol 1e-5,
    running statistics rtol 1e-6 / atol 1e-7 (as the one-process BN test),
    and the input and affine gradients rtol/atol 1e-5 (the all-reduce's
    backward).  bf16 statistics (``--bn-bf16-stats``): outputs and
    statistics within 2e-2 (bf16 rounding of the moments)."""
    jax, jnp = jx["jax"], jx["jnp"]
    b = parity["inputs"]["bn"]
    f32 = mode == "f32"
    dtype = jnp.float32 if f32 else jnp.bfloat16
    bn = jx["layers"].batch_norm(train=True, dtype=dtype, f32_stats=f32)
    c = b["x"].shape[-1]
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def apply(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(b["cot"])), (
            y, upd["batch_stats"])

    params = {"scale": jnp.asarray(b["scale"]), "bias": jnp.asarray(b["bias"])}
    x = jax.device_put(jnp.asarray(b["x"]).astype(dtype), jx["data"])
    (_, (y, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        apply, argnums=(0, 1), has_aux=True))(params, x)
    got = [g["bn"][mode] for g in parity["got"]]
    ytol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               np.asarray(y.astype(jnp.float32)), **ytol)
    stol = dict(rtol=1e-6, atol=1e-7) if f32 else dict(rtol=2e-2, atol=2e-3)
    for g in got:
        np.testing.assert_allclose(g["mean"], np.asarray(upd["mean"]), **stol)
        np.testing.assert_allclose(g["var"], np.asarray(upd["var"]), **stol)
    np.testing.assert_array_equal(got[0]["var"], got[1]["var"])
    if f32:
        np.testing.assert_allclose(np.concatenate([g["dx"] for g in got]),
                                   np.asarray(gx), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sum(g["dscale"] for g in got),
                                   np.asarray(gp["scale"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(sum(g["dbias"] for g in got),
                                   np.asarray(gp["bias"]), rtol=1e-5,
                                   atol=1e-5)


def test_val_pass_names_tpuics_misclassified_images(parity):
    """Every rank names every misclassified image of the val pass (15
    images, a global batch of 6: the last padded on both ranks) and holds
    the global confusion matrix: both equal ``tpuic``'s Trainer on the
    mesh, as does the accuracy; rank 0 alone writes the per-class
    files."""
    ref = parity["ref"]
    for g in parity["got"]:
        v = g["val"]
        assert v["batches"] == 3
        assert v["misclassified"] == ref["val_misclassified"]
        np.testing.assert_array_equal(v["confusion"], ref["val_confusion"])
        assert v["score"] == pytest.approx(ref["val_score"], abs=1e-9)
    assert ref["val_confusion"].sum() == 15
    assert len(ref["val_misclassified"]) == 15 - np.trace(
        ref["val_confusion"])
    roots = [g["val"]["logger_root"] for g in parity["got"]]
    assert roots[0] is not None and roots[1] is None
    logs = os.path.join(parity["work"], "val_logs")
    # Process 0's files alone, its TensorBoard events file among them.
    names = sorted(os.listdir(logs))
    tb = [n for n in names if n.startswith("events.out.tfevents.")]
    assert len(tb) == 1
    assert [n for n in names if n not in tb] == [
        "confusion_e0.npy", "metrics.jsonl", "per_class.jsonl"]
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["n_misclassified"] == len(ref["val_misclassified"])
    assert "val_balanced_acc" in rec and "val_worst_class_acc" in rec


# -- in one process -----------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 4])
def test_loader_shards_match_tpuics(jx, tmp_path, count):
    """For ``count`` simulated ranks: each rank's rows equal ``tpuic``'s
    Loader's for that rank bit for bit (images, labels, mask, ids), and
    together they are the one-process batch: disjoint and covering.  Two
    train epochs (augmentation on, the partial global batch dropped) and
    the val fold (padded with mask-0 rows on every rank)."""
    root = _folder(str(tmp_path / "f"), train_per_class=5)
    gb = 4
    dcfg = pcfg.DataConfig(data_dir=root, resize_size=16, native=False,
                           pack=False)
    jdcfg = jx["cfg"].DataConfig(data_dir=root, resize_size=16, native=False,
                                 pack=False)

    def port(fold, r, n, **kw):
        ds = ImageFolderDataset(root, fold, 16, dcfg)
        return Loader(ds, gb, num_workers=2, device="cpu", process_index=r,
                      process_count=n, **kw)

    def tpuic(fold, r, n, **kw):
        ds = jx["folder"].ImageFolderDataset(root, fold, 16, jdcfg)
        return jx["pipe"].Loader(ds, gb, num_workers=2, process_index=r,
                                 process_count=n, **kw)

    for fold, kw, epochs in (("train", dict(drop_last=True, seed=5), (0, 1)),
                             ("val", dict(shuffle=False), (0,))):
        for epoch in epochs:
            whole = list(port(fold, 0, 1, **kw).epoch(epoch))
            shards = [list(port(fold, r, count, **kw).epoch(epoch))
                      for r in range(count)]
            refs = [list(tpuic(fold, r, count, **kw).epoch(epoch))
                    for r in range(count)]
            n_steps = len(whole)
            assert n_steps == (3 if fold == "train" else 4)
            for r in range(count):
                assert len(shards[r]) == len(refs[r]) == n_steps
                for got, want in zip(shards[r], refs[r]):
                    for k in ("image", "label", "mask"):
                        np.testing.assert_array_equal(got[k].numpy(),
                                                      np.asarray(want[k]))
                    assert got.image_ids == want.image_ids
                    np.testing.assert_array_equal(got.indices, want.indices)
            for s, one in enumerate(whole):
                for k in ("image", "label", "mask"):
                    np.testing.assert_array_equal(
                        torch.cat([shards[r][s][k]
                                   for r in range(count)]).numpy(),
                        one[k].numpy())
                ids = [i for r in range(count) for i in shards[r][s].image_ids]
                assert ids == one.image_ids
            if fold == "train":
                seen = [i for b in whole for i in b.image_ids]
                assert len(seen) == len(set(seen)) == 12
            else:
                assert sum(float(b["mask"].sum()) for b in whole) == 15


def test_loader_refuses_a_batch_that_does_not_divide(tmp_path):
    root = _folder(str(tmp_path / "f"))
    ds = ImageFolderDataset(root, "train", 16, pcfg.DataConfig(
        data_dir=root, resize_size=16))
    with pytest.raises(ValueError, match="divide across processes"):
        Loader(ds, 6, device="cpu", process_index=0, process_count=4)


@pytest.mark.parametrize("env", [
    {"TPUIC_COORDINATOR_ADDRESS": "localhost:1"},
    {"TPUIC_PROCESS_ID": "0", "TPUIC_NUM_PROCESSES": "2"},
    {"TPUIC_COORDINATOR_ADDRESS": "localhost:1", "TPUIC_PROCESS_ID": "1"},
])
def test_half_set_trio_raises(monkeypatch, env):
    for k in ("TPUIC_COORDINATOR_ADDRESS", "TPUIC_NUM_PROCESSES",
              "TPUIC_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="TPUIC env rendezvous is half-set"):
        distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_one_process_without_a_trio_initializes_nothing(monkeypatch):
    for k in ("TPUIC_COORDINATOR_ADDRESS", "TPUIC_NUM_PROCESSES",
              "TPUIC_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    info = distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (info.process_index, info.process_count) == (0, 1)
    assert not info.is_distributed
    assert distributed.data_parallel_replicas() == 1


def test_trainer_refuses_a_data_axis_of_another_size(tmp_path):
    from tpuic_torch.train.loop import Trainer
    cfg = _val_config(_folder(str(tmp_path / "f")), str(tmp_path))
    cfg = cfg.replace(mesh=pcfg.MeshConfig(data=2))
    with pytest.raises(ValueError, match="mesh.data is 2 but 1 process"):
        Trainer(cfg, device="cpu", log=lambda m: None)


# -- the CLI as two processes -------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One epoch as two processes, then a resume to two epochs."""
    work = tmp_path_factory.mktemp("ddp_cli")
    root = _folder(str(work / "folder"))
    runs = []
    for epochs in (1, 2):
        out = work / f"run{epochs}"
        out.mkdir()
        argv = ["--datadir", root, "--device", "cpu", "--model",
                "resnet18-cifar", "--resize", "16", "--batchsize", "2",
                "--epochs", str(epochs), "--lr", "1e-3",
                "--no-class-weights", "--milestones", "--dtype", "float32",
                "--no-pack", "--no-native", "--workers", "2",
                "--log-every-steps", "1", "--no-async-checkpoint",
                "--save-period", "1", "--collect-misclassified",
                "--per-class-metrics", "--ckpt-dir", str(work / "ck"),
                "--log-dir", str(work / "logs")]
        logs = _finish(_start(str(out), argv))
        recs = []
        for r in range(WORLD):
            with open(out / f"rank{r}.json") as f:
                recs.append(json.load(f))
        runs.append({"logs": logs, "recs": recs})
    return {"runs": runs, "ck": work / "ck" / "resnet18-cifar",
            "logs": work / "logs"}


def test_cli_two_processes_write_from_process_0_only(cli_runs):
    """Process 0 alone writes checkpoints, sidecars and logs, and alone
    prints; both processes end with the same weights."""
    first = cli_runs["runs"][0]
    r0, r1 = first["recs"]
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, WORLD)
    assert r1["writes"] == []
    written = {os.path.basename(p) for _, p in r0["writes"]}
    assert {"best.new", "latest.new", "config.json", "class_to_idx.json",
            "metrics.jsonl", "per_class.jsonl", "confusion_e0.npy"} <= written
    assert r0["digest"] == r1["digest"] and r0["step"] == r1["step"] == 3
    assert "Val Accuracy" in first["logs"][0]
    assert "Val Accuracy" not in first["logs"][1]
    assert os.path.isfile(cli_runs["ck"] / "latest" / "state.pt")


def test_cli_resume_restores_the_same_save_on_both(cli_runs):
    """The second run resumes at epoch 1 from ``latest`` on both
    processes, trains one more epoch, and ends equal on both."""
    r0, r1 = cli_runs["runs"][1]["recs"]
    assert r0["start_epoch"] == r1["start_epoch"] == 1
    assert r0["rung"] == r1["rung"] == "latest"
    assert r0["step"] == r1["step"] == 6
    assert r0["digest"] == r1["digest"]
    assert r1["writes"] == []
    with open(cli_runs["logs"] / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "val_accuracy" in r] == [3, 6]


# -- on the card --------------------------------------------------------------

def _cuda_state(seed: int = 0):
    from tpuic_torch.checkpoint import init_params
    mcfg = pcfg.ModelConfig(name="resnet18-cifar", num_classes=CLASSES,
                            dtype="float32")
    ocfg = pcfg.OptimConfig(**OPTIM)
    model = init_params(port_models.create_model_from_config(
        mcfg, device="cuda"), seed, device="cuda")
    return mcfg, ocfg, create_train_state(model, make_optimizer(ocfg, 3, 10))


@pytest.mark.cuda
def test_cuda_world_1_nccl_steps_equal_the_one_process_steps():
    """On the card: 3 steps in a one-process NCCL group (DDP around the
    model, the K1 and K2 kernels) equal 3 steps with no group from the
    same state, losses and parameters within 1e-5 (cuDNN deterministic);
    K2's leaf table is built at the first step and kept (DDP copies its
    buckets back into the same ``p.grad``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    batches = [{k: torch.from_numpy(v[:4]).cuda() for k, v in b.items()}
               for b in _batches()]
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        arms = []
        for grouped in (False, True):
            if grouped:
                distributed.initialize(f"localhost:{_free_port()}", 1, 0)
            try:
                mcfg, ocfg, state = _cuda_state()
                step = pstep.make_train_step(
                    ocfg, mcfg, lr_schedule=make_schedule(ocfg, 3, 10),
                    device="cuda")
                losses, tables = [], []
                for b in batches:
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
                    tables.append(id(state.tx._table.leaves))
                arms.append((losses, tables, {
                    k: v.detach().cpu() for k, v in
                    state.model.state_dict().items()}))
            finally:
                distributed.shutdown()
        (l0, _, s0), (l1, t1, s1) = arms
        np.testing.assert_allclose(l1, l0, rtol=1e-5)
        assert t1[0] == t1[1] == t1[2]
        for k in s0:
            np.testing.assert_allclose(s1[k].numpy(), s0[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
