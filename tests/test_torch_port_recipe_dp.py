"""The step's randomness under data parallelism: two gloo ranks on the
CPU equal one process at the same seed.

``vit-tiny`` (16 px, global batch 8, 4 a rank) with the ViT recipe's
mixup 0.2 / CutMix 1.0 (one picked a step), random erasing 0.25 and
drop-path 0.3, the 7 class weights (so ``L(y)`` and ``L(y_perm)`` have
their own global ``sum(w)``, stacked into one all-reduce), label
smoothing, the fused loss, AdamW and EMA 0.9; three steps drawn by the
port itself from ``(seed, step)``.  Every draw has the global batch's
shape and each rank takes its rows; the mix partners come from one
``all_gather`` of the batch.  Per step: the loss rtol 1e-4, the gradient
norm rtol 1e-3 (``test_torch_port_distributed.py``'s tolerance), the
accuracy exactly; then parameters and the EMA atol 5e-5 on both ranks
(the attention's key bias aside, as in ``test_torch_port_vit.py``).
The draws picked mixup on one step and CutMix on another.
"""

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
from tpuic_torch.checkpoint import init_params
from tpuic_torch.runtime import distributed
from tpuic_torch.train.optimizer import make_optimizer, make_schedule
from tpuic_torch.train.state import create_train_state
from tpuic_torch.train.step import make_train_step
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 2
GLOBAL = 8
SIZE = 16
CLASSES = 7
SEED = 4
OPTIM = dict(optimizer="adam", learning_rate=1e-3, weight_decay=0.05,
             grad_clip_norm=1.0, milestones=(),
             class_weights=(3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0),
             label_smoothing=0.1, fused_loss=True, mixup_alpha=0.2,
             cutmix_alpha=1.0, random_erase=0.25, ema_decay=0.9)


def _batches(k=3, seed=8):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((GLOBAL, SIZE, SIZE, 3)).astype(
                np.float32),
             "label": rng.integers(0, CLASSES, GLOBAL).astype(np.int32),
             "mask": np.ones(GLOBAL, np.float32)} for _ in range(k)]


def _run(rank: int = 0, world: int = 1) -> dict:
    """Three steps on this process's rows of the global batches."""
    mcfg = pcfg.ModelConfig(name="vit-tiny", num_classes=CLASSES,
                            dtype="float32", drop_path=0.3)
    ocfg = pcfg.OptimConfig(**OPTIM)
    model = init_params(port_models.create_model_from_config(
        mcfg, device="cpu", image_size=SIZE), 3, device="cpu")
    state = create_train_state(model, make_optimizer(ocfg, 3, 10), ema=True)
    step = make_train_step(ocfg, mcfg, lr_schedule=make_schedule(ocfg, 3, 10),
                           device="cpu", seed=SEED)
    lb = GLOBAL // world
    metrics = []
    for k, batch in enumerate(_batches()):
        state, m = step(state, {n: torch.from_numpy(v[rank * lb:
                                                      (rank + 1) * lb])
                                for n, v in batch.items()}, step=k)
        metrics.append({n: float(v) for n, v in m.items()})
    names = [n for n, _ in model.named_parameters()]
    return {"metrics": metrics, "names": names + names,
            "values": [p.detach().numpy() for p in model.parameters()]
            + [e.numpy() for e in state.ema_params]}


def _rank_main(workdir: str) -> None:
    info = distributed.initialize(device="cpu")
    out = _run(info.process_index, info.process_count)
    with open(os.path.join(workdir, f"rank{info.process_index}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("recipe_dp"))
    port = _free_port()
    cmd = ["-c", f"import sys; sys.path.insert(0, {HERE!r}); "
                 "import test_torch_port_recipe_dp as t; "
                 f"t._rank_main({work!r})"]
    procs = [subprocess.Popen(
        [sys.executable, *cmd], cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=subprocess_env(
            PYTHONPATH=ROOT, TPUIC_COORDINATOR_ADDRESS=f"localhost:{port}",
            TPUIC_NUM_PROCESSES=str(WORLD), TPUIC_PROCESS_ID=str(r)))
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert not any(p.returncode for p in procs), "\n".join(
        o[-3000:] for o in outs)
    got = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got


def test_two_ranks_draw_and_step_as_one_process(ranks):
    want = _run()
    for r, got in enumerate(ranks):
        for k, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4,
                                       err_msg=f"rank {r} step {k}")
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                       rtol=1e-3,
                                       err_msg=f"rank {r} step {k}")
            assert a["accuracy"] == b["accuracy"]
        for name, a, b in zip(want["names"], got["values"],
                              want["values"]):
            if name.endswith("attn.qkv.bias"):
                # The key bias: Adam's step on a gradient that is 0 up to
                # rounding (test_torch_port_vit.py), up to lr a step.
                third = a.shape[0] // 3
                key = slice(third, 2 * third)
                assert np.abs(a[key] - b[key]).max() <= \
                    2 * 3 * OPTIM["learning_rate"]
                a, b = np.delete(a, key, 0), np.delete(b, key, 0)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5,
                                       err_msg=f"rank {r} {name}")


def test_the_steps_picked_both_mix_modes():
    from tpuic_torch.train import augment
    gen = torch.Generator()
    picks = {bool(augment.draw_step(gen, SEED, k, GLOBAL, mixup_alpha=0.2,
                                    cutmix_alpha=1.0, device="cpu")
                  .mix.use_mixup) for k in range(3)}
    assert picks == {True, False}
