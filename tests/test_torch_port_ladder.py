"""The serve engine's dtype ladder (``tpuic/serve/engine.py``'s
``variants``) and the serve CLI's ladder gates, on the CPU.

- ``warmup`` readies every (rung, bucket) and returns ``{variant:
  {bucket: secs}}``; requests of each rung at each bucket then run with
  no new compile (on the card, no new graph capture: the ``cuda`` case),
  and each answer equals that rung's own forward of the same images
  (1e-6: the same function, padded to its bucket).
- ``submit(dtype=...)`` picks the rung; a tag not configured (or
  unknown, ``fp8``) is refused at submit; a rung boundary closes a batch
  the way an overflow does; a bf16 rung whose convolutions run on cuDNN
  runs at the largest bucket only (a lone row then equals its row in a
  full request, bit for bit), and ``rows_follow_batch`` says which
  backbones those are.
- ``swap_weights`` replaces the whole ladder as one unit: afterwards each
  rung answers with the new weights' rung; a swap that misses a tag (or
  adds one) is refused and changes nothing.
- The CLI's startup gate exits nonzero naming the rung when a rung is
  corrupted (``quant.corrupt_variables``), and a swap whose candidate
  ladder carries a corrupted rung gets a typed ``swap_accuracy``
  refusal, the served generation unchanged.

Sizes: ``resnet18-cifar`` / ``resnet18`` at 32 px, buckets 1, 2, 4.
"""

import numpy as np
import pytest
import torch

from tpuic_torch import quant
from tpuic_torch.checkpoint import init_params
from tpuic_torch.models import create_model
from tpuic_torch.serve import InferenceEngine, make_forward
from tpuic_torch.serve.engine import rows_follow_batch
from tpuic_torch.serve import __main__ as pserve
from tpuic_torch.serve.admission import SwapRejected

SIZE = 32
CLASSES = 10
TAGS = quant.DTYPE_TAGS


def _model(seed, device="cpu", fused=True):
    return init_params(create_model("resnet18-cifar", CLASSES,
                                    dtype="float32", fused_conv_bn=fused,
                                    device=device), seed,
                       device=device).eval()


def _engine(seed=0, tags=TAGS, device="cpu", fused=True, **kw):
    rungs = quant.serve_variants(_model(seed, device, fused), tags)
    return InferenceEngine(rungs["fp32"], image_size=SIZE,
                           input_dtype=np.uint8, normalize=True,
                           buckets=(1, 2, 4), max_wait_ms=1.0, device=device,
                           variants={t: m for t, m in rungs.items()
                                     if t != "fp32"}, **kw), rungs


def _direct(rung, imgs):
    dev = next(iter(rung.state_dict().values())).device
    out = make_forward(rung, normalize=True)(torch.from_numpy(imgs).to(dev))
    return tuple(t.cpu().numpy() for t in out)


def test_each_rung_and_bucket_serves_after_warmup_with_no_new_compile():
    eng, rungs = _engine()
    try:
        t = eng.warmup()
        assert list(t) == list(TAGS) == list(eng.variant_tags())
        assert all(sorted(v) == [1, 2, 4] for v in t.values())
        compiles = eng.stats.snapshot()["compiles"]
        assert compiles == len(TAGS) * 3
        imgs = quant.eval_images(7, SIZE)
        for tag in TAGS:
            for n in (1, 2, 4, 3):
                probs, order = eng.submit(imgs[:n], dtype=tag).result(60)
                want = _direct(rungs[tag], imgs[:n])
                np.testing.assert_allclose(probs, want[0], rtol=0,
                                           atol=1e-6, err_msg=tag)
                np.testing.assert_array_equal(order[:, 0], want[1][:, 0])
        assert eng.stats.snapshot()["compiles"] == compiles
        # The rungs differ: the int8 and bf16 weights are not fp32's.
        fp32 = eng.submit(imgs[:4]).result(60)[0]
        for tag in ("bf16", "int8"):
            assert not np.array_equal(
                eng.submit(imgs[:4], dtype=tag).result(60)[0], fp32)
        assert quant.weight_bytes(rungs["int8"]) < \
            0.4 * quant.weight_bytes(rungs["fp32"])
        # Half (BN's int64 batch counters stay as they are).
        assert quant.weight_bytes(rungs["bf16"]) < \
            0.51 * quant.weight_bytes(rungs["fp32"])
    finally:
        eng.close()


def test_the_bf16_rung_runs_at_the_largest_bucket():
    """A bf16 rung whose convolutions run on cuDNN (an unfused ResNet
    here) runs at the largest bucket only: it warms that one bucket, a
    one-image bf16 request rides it, and its row equals the same row
    inside a full request bit for bit; fp32 and int8 keep every bucket."""
    eng, _ = _engine(fused=False)
    try:
        t = eng.warmup()
        assert sorted(t["bf16"]) == [4]
        assert sorted(t["fp32"]) == sorted(t["int8"]) == [1, 2, 4]
        assert eng.bucket_for(1, "bf16") == 4 and eng.bucket_for(1) == 1
        imgs = quant.eval_images(4, SIZE)
        full = eng.submit(imgs, dtype="bf16").result(60)[0]
        eng.stats.reset()
        one = eng.submit(imgs[2:3], dtype="bf16").result(60)[0]
        assert eng.stats.snapshot()["batch_hist"] == {"4": 1}
        np.testing.assert_array_equal(one[0], full[2])
    finally:
        eng.close()


@pytest.mark.parametrize("name, kw, pinned", [
    ("resnet18-cifar", {"fused_conv_bn": True}, False),   # K3
    ("resnet18-cifar", {}, True),                         # cuDNN
    ("vit-tiny", {"attention": "flash"}, False),          # cuBLAS, K4f
    ("efficientnet-b0", {}, True),
    ("inceptionv3", {}, True),
])
def test_rows_follow_batch_by_backbone(name, kw, pinned):
    """Which rungs the engine pins to its largest bucket: the bf16 rung of
    a backbone whose convolutions run on cuDNN, never fp32 or int8."""
    model = create_model(name, CLASSES, dtype="float32", device="cpu",
                         **kw).eval()
    rungs = quant.serve_variants(model, TAGS)
    assert [rows_follow_batch(t, m) for t, m in rungs.items()] == \
        [False, pinned, False]


def test_unknown_serve_dtype_is_refused_at_submit():
    eng, _ = _engine(tags=("fp32", "int8"))
    try:
        for tag in ("bf16", "fp8"):
            with pytest.raises(ValueError,
                               match=f"unknown serve dtype '{tag}'"):
                eng.submit(quant.eval_images(1, SIZE), dtype=tag)
            with pytest.raises(ValueError,
                               match=f"unknown serve dtype '{tag}'"):
                eng.candidate_outputs(_model(1).state_dict(),
                                      quant.eval_images(1, SIZE),
                                      variant=tag)
        assert eng.variant_tags() == ("fp32", "int8")
    finally:
        eng.close()


def test_a_rung_boundary_closes_a_batch():
    eng, _ = _engine(autostart=False)
    imgs = quant.eval_images(3, SIZE)
    futs = [eng.submit(imgs[i:i + 1], dtype=tag)
            for i, tag in enumerate(("fp32", "fp32", "int8"))]
    first = eng._gather(0.01)
    assert [r.variant for r in first] == ["fp32", "fp32"]
    second = eng._gather(0.01)
    assert [r.variant for r in second] == ["int8"]
    eng.start()
    try:
        for batch in (first, second):
            eng._resolve(eng._dispatch(batch))
        assert all(f.result(60)[0].shape == (1, CLASSES) for f in futs)
    finally:
        eng.close()


def test_swap_replaces_the_ladder_as_one_unit():
    eng, _ = _engine()
    imgs = quant.eval_images(4, SIZE)
    try:
        new = quant.serve_variants(_model(1), TAGS)
        gate = eng.candidate_outputs(new["int8"], imgs, variant="int8")
        np.testing.assert_allclose(gate[0], _direct(new["int8"], imgs)[0],
                                   rtol=0, atol=1e-6)
        assert eng.generation == 0  # the gate touched nothing served
        res = eng.swap_weights(new["fp32"], variants={
            t: new[t] for t in TAGS[1:]})
        assert res["generation"] == eng.generation == 1
        for tag in TAGS:
            np.testing.assert_allclose(
                eng.submit(imgs, dtype=tag).result(60)[0],
                _direct(new[tag], imgs)[0], rtol=0, atol=1e-6,
                err_msg=tag)
        digest = eng.model_digest
        with pytest.raises(ValueError, match="one unit"):
            eng.swap_weights(new["fp32"], variants={"bf16": new["bf16"]})
        with pytest.raises(ValueError, match="one unit"):
            eng.swap_weights(new["fp32"], variants={
                "bf16": new["bf16"], "int8": new["int8"],
                "fp8": new["int8"]})
        assert (eng.generation, eng.model_digest) == (1, digest)
    finally:
        eng.close()


def _corrupting(monkeypatch):
    """``quant.serve_variants`` whose int8 rung comes from corrupted
    weights (the gate's must-fail arm)."""
    real = quant.serve_variants

    def corrupted(model, tags):
        out = real(model, tags)
        if "int8" in out:
            out["int8"] = quant.quantized_forward(
                quant.corrupt_variables(model, seed=0))
        return out

    monkeypatch.setattr(quant, "serve_variants", corrupted)


_ARGS = ["--device", "cpu", "--synthetic-init", "--model", "resnet18",
         "--num-classes", "3", "--resize", str(SIZE), "--buckets", "1,2"]


def test_cli_start_gate_refuses_a_corrupted_rung(monkeypatch):
    _corrupting(monkeypatch)
    with pytest.raises(SystemExit, match="dtype ladder rung 'int8' FAILED "
                                         "the accuracy gate"):
        pserve.main(_ARGS + ["--serve-dtypes", "fp32,bf16,int8"])


def test_cli_swap_gate_refuses_a_corrupted_rung(monkeypatch):
    args = pserve.build_parser().parse_args(
        _ARGS + ["--serve-dtypes", "fp32,int8"])
    engine, *_ = pserve.build_engine(args)
    try:
        assert engine.variant_tags() == ("fp32", "int8")
        identity = (engine.generation, engine.model_digest)
        _corrupting(monkeypatch)
        with pytest.raises(SwapRejected, match="rung 'int8' FAILED") as e:
            pserve.run_swap(engine, {"op": "swap", "synthetic_seed": 1},
                            log=lambda m: None)
        assert e.value.cause == "swap_accuracy"
        assert (engine.generation, engine.model_digest) == identity
        monkeypatch.undo()
        res = pserve.run_swap(engine, {"op": "swap", "synthetic_seed": 1},
                              log=lambda m: None)
        assert res["ok"] and res["generation"] == engine.generation == 1
    finally:
        engine.close()


@pytest.mark.cuda
def test_cuda_ladder_replays_each_rung_with_no_new_capture():
    """On the card: warmup captures a graph per (rung, bucket); requests
    of every rung at every bucket replay them, with no capture after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    eng, rungs = _engine(device="cuda")
    try:
        eng.warmup()
        mem = eng.graph_memory()
        assert set(mem["pool_bytes_by_variant"]) == set(TAGS)
        captures = eng._gen.captures
        imgs = quant.eval_images(4, SIZE)
        for tag in TAGS:
            for n in (1, 2, 4):
                probs, _ = eng.submit(imgs[:n], dtype=tag).result(60)
                want = _direct(rungs[tag], imgs[:n])
                np.testing.assert_allclose(probs, want[0], rtol=0,
                                           atol=1e-5, err_msg=tag)
        assert eng._gen.captures == captures
        assert all(len(r.graphs) == 3 for r in eng._gen.rungs.values())
    finally:
        eng.close()
