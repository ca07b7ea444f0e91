"""``python -m tpuic_torch.serve`` on the CPU (``--device cpu``), its
torch-checkpoint converter, and the engine's device-resident requests.

- Transports: stdin JSONL, ``--watch --once`` and ``--listen`` answer
  with ``{"id", "pred", "prob", "topk"}``; over the socket a ping gets a
  pong with the model's digest and generation, a bad line a typed error
  line, and SIGTERM drains with typed stragglers
  (tests/test_serve.py's contract).
- Flags: ``tpuic``'s operating flags (``--slo``, ``--brownout-*``,
  ``--prom-*``) serve, and their start-time errors (a brownout coupled to
  no ``--slo`` objective, a malformed ``--quota``, an unknown
  ``--serve-dtypes`` rung) are refused by name; a refused swap line gets
  a typed error line and the server keeps answering.  ``--serve-dtypes fp32,int8`` serves: a request line's
  ``serve_dtype`` picks the int8 rung (its own forward within 1e-5), an
  unknown one gets a typed error line.
- Whole-CLI parity: one reference-format torch checkpoint (``module.``
  prefixed, written by ``tpuic``'s ``export_state_dict`` from a
  ``tpuic``-initialised model) served by ``tpuic``'s CLI and the port's,
  both with ``--init-from``: the same top-1 and top-k names, the
  probabilities within 1e-5.  ``tpuic``'s CLIs compute in its
  ``ModelConfig`` default, bfloat16, and the port's fp32 rung serves
  float32, so the reference side runs with its model factory wrapped to
  float32; nothing of ``tpuic`` is edited.
- Converter parity: the port's ``convert_resnet`` / ``convert_vit`` give
  ``tpuic``'s trees exactly, and the lenient merge leaves fresh exactly
  the leaves ``tpuic`` leaves fresh (a head of another class count).
  InceptionV3 and EfficientNet keys convert; ``--model auto`` serves a
  checkpoint of each family (1e-5 against a direct forward).

JAX and ``tpuic`` are imported inside fixtures and tests.
"""

import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tpuic_torch import config as pcfg
from tpuic_torch.checkpoint import CheckpointManager, init_params
from tpuic_torch.checkpoint import torch_convert as ptc
from tpuic_torch.checkpoint.convert import _port_name
from tpuic_torch.models import create_model
from tpuic_torch.serve import InferenceEngine, make_forward
from tpuic_torch.serve import __main__ as pserve
from tpuic_torch.serve import wire
from tpuic_torch.train.optimizer import make_optimizer
from tpuic_torch.train.state import create_train_state
from _torch_threads import TORCH_THREADS, subprocess_env

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 32
CLASSES = ("ant", "bee", "cicada")


def _write_images(folder, n, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"im_{i}.png")
        Image.fromarray(rng.integers(0, 256, (SIZE + 5, SIZE - 3, 3),
                                     np.uint8)).save(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port checkpoint of resnet18 (3 classes, 32 px) with the sidecars
    a Trainer writes, and a few image files."""
    root = tmp_path_factory.mktemp("served")
    ckpt = str(root / "ckpt")
    model = init_params(create_model("resnet18", 3, dtype="float32",
                                     fused_conv_bn=True, device="cpu"), 1,
                        device="cpu")
    ocfg = pcfg.OptimConfig(optimizer="sgd", class_weights=(),
                            milestones=())
    mgr = CheckpointManager(ckpt, "resnet18", async_commit=False,
                            log=lambda m: None)
    mgr.save_best(create_train_state(model, make_optimizer(ocfg)), 0, 50.0)
    mgr.wait()
    cfg = pcfg.Config(data=pcfg.DataConfig(resize_size=SIZE),
                      model=pcfg.ModelConfig(name="resnet18", num_classes=3,
                                             dtype="float32"), optim=ocfg)
    with open(os.path.join(mgr.root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, default=str)
    with open(os.path.join(mgr.root, "class_to_idx.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(CLASSES)}, f)
    images = _write_images(str(root / "images"), 5, 0)
    return dict(root=root, ckpt=ckpt, model=model.eval(), images=images)


def _direct(model, paths):
    """Probabilities of a direct forward of the CLI's decoded pixels."""
    x = np.stack([pserve._load_image(p, SIZE) for p in paths])
    probs, _ = make_forward(model, normalize=True)(torch.from_numpy(x))
    return probs.numpy()


def _check_records(recs, served, k):
    want = _direct(served["model"], [r["id"] for r in recs])
    for rec, p in zip(recs, want):
        assert set(rec) == {"id", "pred", "prob", "topk"}
        assert len(rec["topk"]) == k
        order = np.argsort(-p, kind="stable")
        assert [n for n, _ in rec["topk"]] == [CLASSES[j] for j in order[:k]]
        assert rec["pred"] == rec["topk"][0][0]
        np.testing.assert_allclose([q for _, q in rec["topk"]],
                                   p[order[:k]], atol=1e-5)


def _cli(args, stdin_text=None, monkeypatch=None):
    if stdin_text is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    return pserve.main(["--device", "cpu", "--buckets", "1,2,4"] + args)


def test_stdin_jsonl_answers_each_request(served, tmp_path, monkeypatch):
    lines = [json.dumps({"id": p, "path": p}) for p in served["images"]]
    lines += ['{"op": "swap", "id": "s1", "ckpt_dir": "/nonexistent"}',
              "not json", json.dumps({"id": "miss", "path": "/nope.png"}),
              json.dumps({"id": "d", "path": served["images"][0],
                          "serve_dtype": "int8"}),
              json.dumps({"id": "e", "path": served["images"][0],
                          "serve_dtype": "fp8"}),
              json.dumps({"id": served["images"][1],
                          "path": served["images"][1]})]
    out = tmp_path / "out.jsonl"
    assert _cli(["--ckpt-dir", served["ckpt"], "--model", "auto",
                 "--top-k", "2", "--out", str(out), "--serve-dtypes",
                 "fp32,int8"], "\n".join(lines) + "\n", monkeypatch) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    by_id = {}
    for r in recs:
        by_id.setdefault(r.get("id"), []).append(r)
    # The refused swap gets a typed error; the server went on answering.
    assert by_id["s1"][0]["cause"] == "swap_corrupt"
    assert "swap candidate missing" in by_id["s1"][0]["error"]
    assert "bad request line" in by_id[None][0]["error"]
    assert by_id["miss"][0]["error"].startswith("decode:")
    # The int8 rung answers with its own forward (1e-5); an unknown rung
    # gets a typed error line.
    from tpuic_torch import quant
    rung = by_id.pop("d")[0]
    x = np.stack([pserve._load_image(served["images"][0], SIZE)])
    probs, order = make_forward(quant.quantized_forward(served["model"]),
                                normalize=True)(torch.from_numpy(x))
    assert rung["pred"] == CLASSES[int(order[0, 0])]
    np.testing.assert_allclose([q for _, q in rung["topk"]],
                               probs[0].numpy()[order[0, :2].numpy()],
                               atol=1e-5)
    assert "unknown serve dtype 'fp8'" in by_id["e"][0]["error"]
    answers = [r for r in recs if "pred" in r and r["id"] != "d"]
    assert len(answers) == len(served["images"]) + 1
    _check_records(answers, served, 2)


def test_watch_once_answers_each_file(served, tmp_path, monkeypatch):
    watch = tmp_path / "incoming"
    watch.mkdir()
    for p in served["images"]:
        (watch / os.path.basename(p)).write_bytes(Path(p).read_bytes())
    (watch / "notes.txt").write_text("ignored")
    out = tmp_path / "w.jsonl"
    assert _cli(["--ckpt-dir", served["ckpt"], "--watch", str(watch),
                 "--once", "--out", str(out), "--top-k", "3"]) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert sorted(r["id"] for r in recs) == sorted(
        os.path.basename(p) for p in served["images"])
    for r in recs:
        r["id"] = str(watch / r["id"])
    _check_records(recs, served, 3)


# A served case: (its flags, a line its stderr must hold).
_SMALL = ["--resize", "32", "--buckets", "1"]


@pytest.mark.parametrize("flag,match", [
    pytest.param(["--admission", "--brownout-slo", "x"],
                 "--brownout-slo 'x' names no --slo objective",
                 id="--admission"),
    pytest.param(["--quota", "a=0"], "--quota: bad quota spec 'a=0'",
                 id="--quota"),
    pytest.param(["--brownout-slo", "x"],
                 "--brownout-slo 'x' names no --slo objective "
                 "\\(configured: none\\)", id="--brownout-slo"),
    pytest.param(["--brownout-tighten", "3"] + _SMALL,
                 (None, "warmup ran 1 buckets eagerly"),
                 id="--brownout-tighten"),
    pytest.param(["--brownout-recover", "0.5"] + _SMALL,
                 (None, "warmup ran 1 buckets eagerly"),
                 id="--brownout-recover"),
    pytest.param(["--slo", "serve_latency:p99<=5ms"] + _SMALL,
                 (None, "[serve] slo: serve_latency_p99"), id="--slo"),
    pytest.param(["--prom-port", "-1"] + _SMALL,
                 (None, "[serve] prometheus /metrics on 127.0.0.1:"),
                 id="--prom-port"),
    pytest.param(["--prom-host", "0.0.0.0"] + _SMALL,
                 (None, "warmup ran 1 buckets eagerly"), id="--prom-host"),
    pytest.param(["--prom-dump", "PROM"] + _SMALL,
                 (None, "[serve] prometheus exposition -> "),
                 id="--prom-dump"),
    # The dtype ladder: served, its rungs past the start gate.
    pytest.param(["--serve-dtypes", "fp32,int8"] + _SMALL,
                 (None, "dtype ladder rung int8: top-1 agreement"),
                 id="--serve-dtypes"),
    pytest.param(["--serve-dtypes", "fp32,fp8"],
                 "--serve-dtypes: unknown dtype 'fp8'", id="fp8")])
def test_unported_flag_is_refused_by_name(flag, match, monkeypatch, capsys,
                                          tmp_path):
    """Every flag of ``tpuic``'s server is ported: ``--slo``,
    ``--brownout-*`` and ``--prom-*`` serve (an empty stdin: start, exit
    0, the line each leaves on stderr), and what cannot serve is refused
    by name before the model loads: a ``--brownout-slo`` naming no
    ``--slo`` objective (with or without ``--admission``), a malformed
    ``--quota``, an unknown ladder rung."""
    argv = ["--device", "cpu", "--synthetic-init", "--model", "resnet18",
            "--num-classes", "3"] + [str(tmp_path / "m.prom") if f == "PROM"
                                     else f for f in flag]
    if isinstance(match, tuple):
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        assert pserve.main(argv) == 0
        assert match[1] in capsys.readouterr().err
        if "PROM" in flag:
            assert "tpuic_serve_requests_total 0" in (
                tmp_path / "m.prom").read_text()
        return
    with pytest.raises(SystemExit, match=match):
        pserve.main(argv)


def _ema_checkpoint(served, ckpt: str) -> torch.nn.Module:
    """``served``'s save with ``ema_params`` of other weights (a second
    seeded init) and a sidecar saying ``ema_decay`` 0.999; returns a model
    holding those EMA weights and the save's BN statistics."""
    import shutil
    shutil.copytree(served["ckpt"], ckpt)
    model = init_params(create_model("resnet18", 3, dtype="float32",
                                     fused_conv_bn=True, device="cpu"), 1,
                        device="cpu")
    other = init_params(create_model("resnet18", 3, dtype="float32",
                                     device="cpu"), 5, device="cpu")
    state = create_train_state(model, make_optimizer(pcfg.OptimConfig(
        optimizer="sgd", class_weights=(), milestones=())), ema=True)
    state.ema_params = [p.detach().clone() for p in other.parameters()]
    mgr = CheckpointManager(ckpt, "resnet18", async_commit=False,
                            log=lambda m: None)
    mgr.save_best(state, 1, 60.0)
    mgr.wait()
    side = os.path.join(mgr.root, "config.json")
    with open(side) as f:
        cfg = json.load(f)
    cfg["optim"]["ema_decay"] = 0.999
    with open(side, "w") as f:
        json.dump(cfg, f)
    with torch.no_grad():
        for p, e in zip(model.parameters(), state.ema_params):
            p.copy_(e)
    return model.eval()


def test_ema_checkpoint_serves_its_ema_and_fault_points_are_refused(
        served, tmp_path, monkeypatch):
    """``tpuic`` serves an EMA-trained checkpoint's EMA weights, at start
    and as a swap candidate: records within 1e-5 of a direct forward of
    ``ema_params``.  A ``TPUIC_FAULTS`` point the serving path does not
    fire, and a malformed spec, are refused by name at start."""
    ckpt = str(tmp_path / "ema")
    ema_model = _ema_checkpoint(served, ckpt)
    lines = [json.dumps({"id": p, "path": p}) for p in served["images"]]
    out = tmp_path / "out.jsonl"
    assert _cli(["--ckpt-dir", ckpt, "--model", "auto", "--top-k", "2",
                 "--out", str(out)], "\n".join(lines) + "\n",
                monkeypatch) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    _check_records(recs, dict(served, model=ema_model), 2)
    # Swapped to from the raw save, it flips to the EMA weights' digest.
    from tpuic_torch.checkpoint import variables_digest
    out = tmp_path / "swap.jsonl"
    assert _cli(["--ckpt-dir", served["ckpt"], "--model", "auto",
                 "--out", str(out)],
                json.dumps({"op": "swap", "id": "s", "ckpt_dir": ckpt})
                + "\n", monkeypatch) == 0
    result = json.loads(out.read_text().splitlines()[0])
    assert result["ok"] is True
    assert result["digest"] == variables_digest(ema_model) != \
        variables_digest(served["model"])
    # The serving fault points are ported; a point the serving path does
    # not fire, or a spec that does not parse, still fails at start.
    monkeypatch.setenv("TPUIC_FAULTS", "ckpt_kill@1")
    with pytest.raises(SystemExit, match="TPUIC_FAULTS: 'ckpt_kill' not "
                       "fired by the port's serve path \\(the train path "
                       "fires 'ckpt_kill'\\)"):
        pserve.main(["--device", "cpu", "--ckpt-dir", served["ckpt"]])
    monkeypatch.setenv("TPUIC_FAULTS", "flood#ten")
    with pytest.raises(SystemExit, match="malformed directive 'flood#ten'"):
        pserve.main(["--device", "cpu", "--ckpt-dir", served["ckpt"]])


def test_synthetic_init_replicas_carry_the_same_bits():
    args = pserve.build_parser().parse_args(
        ["--device", "cpu", "--synthetic-init", "--model", "vit-tiny",
         "--num-classes", "3", "--resize", "16", "--buckets", "1"])
    digests = []
    for _ in range(2):
        eng, size, n, name = pserve.build_engine(args)
        digests.append(eng.model_digest)
        eng.close()
    assert (size, n, name) == (16, 3, "vit-tiny")
    assert digests[0] == digests[1] and len(digests[0]) == 8


# -- the socket transport -----------------------------------------------------
class _Guard:
    triggered = False


def _socket_server(engine, tmp_path):
    guard = _Guard()
    ready_file = str(tmp_path / "ready.json")
    t = threading.Thread(target=pserve.serve_socket, daemon=True, kwargs=dict(
        engine=engine, listen="127.0.0.1:0", names=dict(enumerate(CLASSES)),
        top_k=2, size=SIZE, guard=guard, drain_timeout=5.0,
        ready_file=ready_file, log=lambda msg: None))
    t.start()
    deadline = time.monotonic() + 10.0
    while (ready := wire.read_ready_file(ready_file)) is None:
        assert time.monotonic() < deadline, "no ready file"
        time.sleep(0.01)

    def stop():
        guard.triggered = True
        t.join(timeout=10.0)
        engine.close()
        assert not os.path.exists(ready_file)

    return ready, stop


def _sock_request(port, lines, n_responses, timeout=30.0):
    import socket
    out, buf = [], b""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as sock:
        for line in lines:
            payload = line if isinstance(line, str) else json.dumps(line)
            sock.sendall((payload + "\n").encode())
        while len(out) < n_responses:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            *recs, buf = (buf + chunk).split(b"\n")
            out.extend(json.loads(r) for r in recs if r.strip())
    return out


def test_listen_answers_pings_requests_and_typed_errors(served, tmp_path):
    eng = InferenceEngine(served["model"], image_size=SIZE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 2, 4), max_wait_ms=2.0, device="cpu")
    eng.warmup()
    ready, stop = _socket_server(eng, tmp_path)
    try:
        from tpuic_torch.checkpoint import variables_digest
        assert ready["pid"] == os.getpid()
        assert ready["digest"] == variables_digest(served["model"])
        assert ready["generation"] == 0 and ready["dtypes"] == ["fp32"]
        img = pserve._load_image(served["images"][0], SIZE)[None]
        recs = _sock_request(ready["port"], [
            {"id": "a", **wire.encode_array(img)},
            {"id": "p", "path": served["images"][1]},
            {"op": "ping", "id": "p1"},
            {"op": "swap", "id": "s1", "synthetic_seed": 2},
            {"id": "bad", "b64": "!!!", "shape": [1]},
            {"id": "noimg"}, "not-an-object",
            {"id": "after", **wire.encode_array(img)}], 8)
        by_id = {r.get("id"): r for r in recs}
        assert by_id["p1"]["op"] == "pong"
        assert by_id["p1"]["digest"] == ready["digest"]
        assert by_id["p1"]["generation"] == 0
        assert "swap unsupported" in by_id["s1"]["error"]
        assert by_id["bad"]["error"].startswith("decode:")
        assert "needs 'path' or 'b64'" in by_id["noimg"]["error"]
        assert "bad request line" in by_id[None]["error"]
        by_id["a"]["id"] = by_id["after"]["id"] = served["images"][0]
        by_id["p"]["id"] = served["images"][1]
        _check_records([by_id["a"], by_id["p"], by_id["after"]], served, 2)
    finally:
        stop()


def test_listen_sigterm_drains_with_typed_stragglers(served, tmp_path):
    """A real ``--listen`` process: requests accepted before SIGTERM are
    answered, a request still queued when the drain window closes gets a
    typed error line (never a silent drop), and the server exits 0."""
    ready_file = tmp_path / "ready.json"
    env = subprocess_env(PYTHONPATH=str(ROOT))
    env.pop("TPUIC_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuic_torch.serve", "--device", "cpu",
         "--ckpt-dir", served["ckpt"], "--buckets", "1,2",
         "--max-wait-ms", "1", "--listen", "127.0.0.1:0", "--ready-file",
         str(ready_file), "--drain-timeout", "0"], cwd=str(tmp_path),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120.0
        while (ready := wire.read_ready_file(str(ready_file))) is None:
            assert proc.poll() is None, proc.communicate(timeout=30)[1]
            assert time.monotonic() < deadline, "no ready file"
            time.sleep(0.05)
        img = pserve._load_image(served["images"][0], SIZE)[None]
        first = _sock_request(ready["port"],
                              [{"id": f"d{i}", **wire.encode_array(img)}
                               for i in range(3)], 3)
        assert sorted(r["id"] for r in first) == ["d0", "d1", "d2"]
        assert all("pred" in r for r in first)
        import socket
        with socket.create_connection(("127.0.0.1", ready["port"]),
                                      timeout=60) as sock:
            # The pong after the burst means the server read every burst
            # line: SIGTERM then finds them all accepted.
            burst = "".join(json.dumps({"id": f"s{i}",
                                        **wire.encode_array(img)}) + "\n"
                            for i in range(64))
            sock.sendall((burst + '{"op": "ping", "id": "pg"}\n').encode())
            buf = b""
            while b'"pong"' not in buf:
                buf += sock.recv(1 << 16)
            proc.send_signal(signal.SIGTERM)
            while chunk := sock.recv(1 << 16):
                buf += chunk
        recs = [r for r in (json.loads(ln) for ln in buf.split(b"\n")
                            if ln.strip()) if r.get("op") != "pong"]
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    # Every accepted request got a line: an answer or a typed straggler.
    assert sorted(r["id"] for r in recs) == sorted(f"s{i}"
                                                   for i in range(64))
    for r in recs:
        assert "pred" in r or r["error"].startswith("drain timeout")
    err = proc.stderr.read()
    assert "SIGTERM: draining" in err and "[serve] served" in err


# -- device-resident requests -------------------------------------------------
def test_engine_takes_tensors_on_its_device_and_refuses_others(served):
    eng = InferenceEngine(served["model"], image_size=SIZE,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 4), max_wait_ms=50.0, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (3, SIZE, SIZE, 3), np.uint8)
    with pytest.raises(ValueError, match="tensor on meta"):
        eng.submit(torch.empty((1, SIZE, SIZE, 3), dtype=torch.uint8,
                               device="meta"))
    with pytest.raises(ValueError, match="expected torch.uint8"):
        eng.submit(torch.zeros((1, SIZE, SIZE, 3)))
    # Tensors and arrays in one padded batch, and an exact fit.
    futs = [eng.submit(torch.from_numpy(x[:2])), eng.submit(x[2:])]
    exact = eng.submit(torch.from_numpy(np.concatenate([x, x[:1]])))
    got = np.concatenate([f.result(timeout=60)[0] for f in futs])
    want, _ = make_forward(served["model"], normalize=True)(
        torch.from_numpy(x))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(exact.result(timeout=60)[0][:3], got,
                               rtol=1e-5, atol=1e-5)
    eng.close()
    assert eng.device_requests == 2 and eng.host_requests == 1


# -- converter parity ---------------------------------------------------------
@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from tpuic.checkpoint import manager as jmanager
    from tpuic.checkpoint import torch_convert as jtc
    from tpuic.models import create_model as jcreate

    def init(name, classes, size, seed=7):
        """A variables tree of ``tpuic``'s structure, drawn as flax's
        default init draws it (kernels normal with variance 1/fan_in,
        BN the identity, biases 0), from the traced shapes: compiling
        ``tpuic``'s init would cost seconds."""
        m = jcreate(name, classes, dtype="float32")
        shapes = jax.eval_shape(lambda: m.init(
            jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False))
        rng = np.random.default_rng(seed)

        def leaf(path, s):
            name = path[-1].key
            if name == "kernel":
                return (rng.standard_normal(s.shape)
                        / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
            if name in ("scale", "var"):
                return np.ones(s.shape, np.float32)
            return np.zeros(s.shape, np.float32)

        return jax.tree_util.tree_map_with_path(leaf, shapes)

    def random_tree(name, classes, size, seed=0):
        """A variables tree of ``tpuic``'s structure and shapes, every leaf
        drawn at random (traced, not compiled: converters only need the
        tree)."""
        m = jcreate(name, classes, dtype="float32")
        shapes = jax.eval_shape(lambda: m.init(
            jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False))
        rng = np.random.default_rng(seed)
        return jax.tree.map(lambda s: rng.standard_normal(
            s.shape).astype(np.float32), shapes)

    return dict(jax=jax, tc=jtc, init=init, random_tree=random_tree,
                manager=jmanager)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = np.asarray(getattr(v, "value", v))
    return out


@pytest.mark.parametrize("name,size", [("resnet18", SIZE), ("resnet50", 32),
                                       ("vit-tiny", 16)])
def test_converted_trees_equal_tpuics(jx, name, size):
    v = jx["random_tree"](name, 5, size)
    sd = jx["tc"].export_state_dict(v["params"], v.get("batch_stats", {}))
    sd = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}
    assert ptc.detect_arch(sd) == jx["tc"].detect_arch(sd)
    if name.startswith("resnet"):
        assert ptc.detect_resnet_depth(sd) == name
        got, want = ptc.convert_resnet(sd), jx["tc"].convert_resnet(sd)
    else:
        got, want = ptc.convert_vit(sd), jx["tc"].convert_vit(sd)
    for coll in ("params", "batch_stats"):
        g, w = _flat(got[coll]), _flat(want[coll])
        assert sorted(g) == sorted(w)
        for path in w:
            assert g[path].dtype == w[path].dtype, path
            np.testing.assert_array_equal(g[path], w[path], err_msg=path)


@pytest.mark.parametrize("name,size,ckpt_size", [
    ("resnet18", SIZE, SIZE), ("vit-tiny", 16, 32)])
def test_lenient_merge_leaves_fresh_what_tpuic_leaves_fresh(jx, tmp_path,
                                                             name, size,
                                                             ckpt_size):
    """A 5-class checkpoint into a 3-class model: the head's out layer is
    shape-skipped on both sides; a ViT checkpoint of another image size
    gets its position embedding interpolated as ``tpuic`` does."""
    v = jx["random_tree"](name, 5, ckpt_size)
    sd = jx["tc"].export_state_dict(v["params"], v.get("batch_stats", {}))
    path = str(tmp_path / "ref.pth")
    torch.save({"epoch": 3, "best_score": 1.0, "state_dict": {
        k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}},
        path)
    tree = jx["tc"].convert_reference_checkpoint(path)
    cur = jx["random_tree"](name, 3, size, seed=1)
    if name.startswith("vit"):
        # tpuic's init_state_from_torch interpolates before its merge.
        bb = tree["params"]["backbone"]
        bb["pos_embed"] = jx["tc"].interpolate_pos_embed(
            bb["pos_embed"], cur["params"]["backbone"]["pos_embed"].shape[1])
    want_written, want_counts = set(), {}
    for coll in ("params", "batch_stats"):
        c, r = _flat(cur.get(coll, {})), _flat(tree[coll])
        hit = {p for p in c if p in r and r[p].shape == c[p].shape}
        _, n, total = jx["manager"].lenient_restore(cur.get(coll, {}),
                                                    tree[coll])
        assert (n, total) == (len(hit), len(c))
        want_counts[coll] = (n, total)
        want_written |= {_port_name(coll, p) for p in hit}
    model = create_model(name, 3, dtype="float32", image_size=size,
                         device="cpu")
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.fill_(float("nan"))  # "fresh": what the merge leaves
    logs = []
    counts = ptc.init_from_torch(model, path, name, log=logs.append)
    assert counts == want_counts
    assert f"loaded {counts['params'][0]}/{counts['params'][1]} param" \
        in logs[-1]
    after = model.state_dict()
    written = {k for k, t in after.items()
               if t.is_floating_point() and not torch.isnan(t).any()}
    assert "head.out.weight" not in written and "head.out.bias" not in written
    assert written == want_written
    if name.startswith("vit"):
        np.testing.assert_allclose(after["backbone.pos_embed"].numpy(),
                                   tree["params"]["backbone"]["pos_embed"],
                                   atol=1e-6)


def test_inception_and_efficientnet_checkpoints_are_not_ported_yet():
    """Both families are ported now: their keys convert to ``tpuic``'s
    names, and a bare ``efficientnet`` needs the checkpoint's blocks to
    name its variant."""
    w = np.zeros((4, 3, 3, 3), np.float32)
    tree = ptc.convert_state_dict({"Mixed_5b.branch1x1.conv.weight": w})
    assert tree["params"]["backbone"]["mixed5b"]["b1x1"]["conv"][
        "kernel"].shape == (3, 3, 3, 4)
    tree = ptc.convert_state_dict({"_conv_stem.weight": w},
                                  arch="efficientnet-b0")
    assert tree["params"]["backbone"]["stem_conv"]["kernel"].shape == \
        (3, 3, 3, 4)
    with pytest.raises(ValueError, match="no _blocks"):
        ptc.convert_state_dict({"_conv_stem.weight": w})


@pytest.mark.parametrize("name,size", [("inceptionv3", 75),
                                       ("efficientnet-b0", SIZE)])
def test_model_auto_serves_inception_and_efficientnet(tmp_path, monkeypatch,
                                                      name, size):
    """``--model auto`` on a port checkpoint of each new family: every
    stdin request answered with the top-2 of a direct eval forward of the
    same weights (1e-5)."""
    ckpt = str(tmp_path / "ckpt")
    model = init_params(create_model(name, 3, dtype="float32",
                                     device="cpu"), 2, device="cpu")
    ocfg = pcfg.OptimConfig(optimizer="sgd", class_weights=(),
                            milestones=())
    mgr = CheckpointManager(ckpt, name, async_commit=False,
                            log=lambda m: None)
    mgr.save_best(create_train_state(model, make_optimizer(ocfg)), 0, 50.0)
    mgr.wait()
    cfg = pcfg.Config(data=pcfg.DataConfig(resize_size=size),
                      model=pcfg.ModelConfig(name=name, num_classes=3,
                                             dtype="float32"), optim=ocfg)
    with open(os.path.join(mgr.root, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, default=str)
    with open(os.path.join(mgr.root, "class_to_idx.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(CLASSES)}, f)
    images = _write_images(str(tmp_path / "images"), 3, 1)
    out = tmp_path / "out.jsonl"
    lines = [json.dumps({"id": p, "path": p}) for p in images]
    assert _cli(["--ckpt-dir", ckpt, "--model", "auto", "--top-k", "2",
                 "--out", str(out)], "\n".join(lines) + "\n",
                monkeypatch) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert sorted(r["id"] for r in recs) == sorted(images)
    x = np.stack([pserve._load_image(r["id"], size) for r in recs])
    want, _ = make_forward(model.eval(), normalize=True)(torch.from_numpy(x))
    for rec, p in zip(recs, want.numpy()):
        order = np.argsort(-p, kind="stable")
        assert [n for n, _ in rec["topk"]] == [CLASSES[j] for j in order[:2]]
        np.testing.assert_allclose([q for _, q in rec["topk"]],
                                   p[order[:2]], atol=1e-5)


# -- the whole CLI against tpuic's --------------------------------------------
def test_cli_matches_tpuic_cli_on_one_torch_checkpoint(jx, served, tmp_path,
                                                       monkeypatch):
    import tpuic.models as jmodels
    import tpuic.serve.__main__ as jserve
    v = jx["init"]("resnet18", 3, SIZE)
    sd = jx["tc"].export_state_dict(v["params"], v["batch_stats"])
    ckpt = str(tmp_path / "best_model.pth")
    torch.save({"epoch": 1, "best_score": 0.5, "state_dict": {
        k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}},
        ckpt)
    assert all(k.startswith("module.") for k in sd)
    real = jmodels.create_model_from_config
    monkeypatch.setattr(jmodels, "create_model_from_config",
                        lambda cfg, *a, **kw: real(dataclasses.replace(
                            cfg, dtype="float32"), *a, **kw))
    lines = "".join(json.dumps({"id": p, "path": p}) + "\n"
                    for p in served["images"])
    common = ["--init-from", ckpt, "--model", "resnet18", "--num-classes",
              "3", "--resize", str(SIZE), "--buckets", "4", "--top-k",
              "3", "--ckpt-dir", str(tmp_path / "none")]
    outs = {}
    for side, main, extra in (("tpuic", jserve.main,
                               ["--compile-cache-dir", ""]),
                              ("port", pserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        out = tmp_path / f"{side}.jsonl"
        assert main(common + extra + ["--out", str(out)]) == 0
        outs[side] = {r["id"]: r for r in map(
            json.loads, out.read_text().splitlines())}
    assert sorted(outs["port"]) == sorted(outs["tpuic"]) == sorted(
        served["images"])
    for rid, want in outs["tpuic"].items():
        got = outs["port"][rid]
        assert got["pred"] == want["pred"]
        assert [n for n, _ in got["topk"]] == [n for n, _ in want["topk"]]
        np.testing.assert_allclose([p for _, p in got["topk"]],
                                   [p for _, p in want["topk"]], atol=1e-5)


# -- on the card: one CUDA graph per bucket ------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("name,counter,per_call", [
    ("resnet18", "fused_conv_bn_relu", 20),
    ("vit-tiny", "flash_attention_fwd", 2)])
def test_cuda_graphs_replay_eager_bits_and_count_launches(name, counter,
                                                          per_call):
    """Each bucket's graph replay against an eager forward of the same
    batch (the same bits, or 1e-6); every device call adds its graph's
    launches to the kernel's counter and no other; a tensor on the card
    is served without a host bounce, a CPU tensor is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine captures CUDA graphs")
    import tpuic_torch.kernels as K
    model = init_params(create_model(name, 10, dtype="float32",
                                     fused_conv_bn=True, attention="flash",
                                     image_size=SIZE), 0)
    eng = InferenceEngine(model, image_size=SIZE, input_dtype=np.uint8,
                          normalize=True, buckets=(1, 4), max_wait_ms=1.0)
    eng.warmup()
    assert sorted(eng._graphs) == [1, 4]
    mem = eng.graph_memory()
    assert mem["pool_bytes"] > 0 and mem["static_input_bytes"] == 5 * SIZE \
        * SIZE * 3
    fn = getattr(K, counter)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (4, SIZE, SIZE, 3), np.uint8)
    eager = make_forward(eng.model, normalize=True)
    for b in (1, 4):
        xb = torch.from_numpy(x[:b]).cuda()
        want = eager(xb)
        got = [t.clone() for t in eng.replay(b, xb)]
        torch.cuda.synchronize()
        assert torch.equal(got[1][:, 0], want[1][:, 0])
        assert (got[0] - want[0]).abs().max().item() <= 1e-6
    counts = {f: f.launches for f in K.counted_kernels()}
    futs = [eng.submit(torch.from_numpy(x[:3]).cuda()), eng.submit(x[3:])]
    got = np.concatenate([f.result(timeout=120)[0] for f in futs])
    with pytest.raises(ValueError, match="tensor on cpu"):
        eng.submit(torch.from_numpy(x))
    eng.close()
    calls = eng.stats.snapshot()["device_calls"]
    assert fn.launches - counts[fn] == per_call * calls
    assert all(f.launches == n for f, n in counts.items() if f is not fn)
    want = eager(torch.from_numpy(x).cuda())[0].cpu().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert eng.device_requests >= 1
    # Not warmed: each bucket is captured at its first use, once.
    lazy = InferenceEngine(eng.model, image_size=SIZE, input_dtype=np.uint8,
                           normalize=True, buckets=(1, 4), max_wait_ms=0.0)
    outs = [lazy.submit(x[i:i + 1]).result(timeout=120)[0]
            for i in range(3)]
    lazy.close()
    assert lazy.stats.snapshot()["compiles_by_bucket"] == {"1": 1}
    np.testing.assert_allclose(np.concatenate(outs), want[:3], atol=1e-5,
                               rtol=1e-5)


def test_copied_wire_errors_and_guard_match_tpuic():
    """The port's copies of ``tpuic``'s wire format, typed errors and
    preemption latch give the same records, exceptions and latch states
    for the same inputs."""
    pytest.importorskip("jax")
    from tpuic.runtime.preemption import PreemptionGuard as JaxGuard
    from tpuic.serve import admission as jadm
    from tpuic.serve import wire as jwire

    from tpuic_torch.runtime.preemption import PreemptionGuard
    from tpuic_torch.serve import admission as padm
    assert padm.PRIORITIES == jadm.PRIORITIES
    assert padm.DEFAULT_PRIORITY == jadm.DEFAULT_PRIORITY
    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    assert wire.encode_array(arr) == jwire.encode_array(arr)
    np.testing.assert_array_equal(
        wire.decode_array(jwire.encode_array(arr)), arr)
    for spec in ("127.0.0.1:0", "host:8000"):
        assert wire.parse_hostport(spec) == jwire.parse_hostport(spec)
    for name in ("AdmissionRejected", "DeadlineExceeded", "ReplicaLost",
                 "SwapRejected"):
        kw = {"cause": "quota"} if name == "AdmissionRejected" else {}
        ours = getattr(padm, name)("no", priority="low", tenant="t", **kw)
        theirs = getattr(jadm, name)("no", priority="low", tenant="t", **kw)
        rec = wire.error_record("r", ours)
        assert rec == jwire.error_record("r", theirs)
        back = wire.rebuild_error(rec)
        assert type(back).__name__ == type(jwire.rebuild_error(
            rec)).__name__ == name
        assert (back.cause, back.priority) == (ours.cause, "low")
    assert wire.error_line(None, "x") == jwire.error_line(None, "x")
    with pytest.raises(ValueError):
        padm.SwapRejected("no", cause="quota")
    ready = wire.read_ready_file("/nonexistent/ready.json")
    assert ready is None is jwire.read_ready_file("/nonexistent/ready.json")
    for cls in (PreemptionGuard, JaxGuard):
        g = cls(signals=(signal.SIGUSR1,)).install()
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not g.triggered and time.monotonic() < deadline:
            time.sleep(0.01)
        g.uninstall()
        assert g.triggered
        g.install()  # a new span clears the latch
        assert not g.triggered
        g.uninstall()
