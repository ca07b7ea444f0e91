"""The port's packed data path (``tpuic_torch/data/pack.py``, the packed
``Loader`` of ``data/pipeline.py``) and sample quarantine
(``data/folder.py``) against ``tpuic``'s, on the CPU.

- Pack: the port's ``.bin`` of a PNG + JPEG tree is ``tpuic``'s byte for
  byte and its meta ``tpuic``'s (labels, ids, CRCs, fingerprint); each
  package reuses the other's cache; a truncated file is quarantined the
  same way in both, its row a same-class replacement with that sample's
  label and id; ``quarantine=False`` re-raises.
- The decode path's quarantine is ``tpuic``'s: the replacement's image,
  label and id, and the count.
- The packed ``Loader``, streaming and resident, over two augmented
  epochs: images within 1e-5 of the port's decode loader and of
  ``tpuic``'s packed ``Loader``, labels, masks and ids equal; the same
  with 2 simulated ranks.
- The resident upload in chunks of a tiny ``TPUIC_UPLOAD_CHUNK_MB``.
- The ``Trainer``: both folds packed, the device-cache budget split
  (train first, val the rest), the decoder and ``[quarantine]`` lines.
- The train CLI's cache and quarantine flags reach ``DataConfig``, whose
  fields are now ``tpuic``'s.
- On the card (``cuda``): a resident batch lies there and equals the CPU
  loader's batch.

``tpuic`` and JAX are imported inside fixtures and tests.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tpuic_torch import config as pcfg
from tpuic_torch.data.folder import ImageFolderDataset
from tpuic_torch.data.pack import PackedDataset, pack_dataset
from tpuic_torch.data.pipeline import Loader, upload_resident
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

SIZE = 24
CLASSES = ("ant", "bee", "cicada")


@pytest.fixture(scope="module")
def jx():
    from tpuic import config
    from tpuic.data import folder, pack, pipeline
    return {"cfg": config, "folder": folder, "pack": pack,
            "pipe": pipeline}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 classes, 7 train and 3 val images a class, 16-48 px, PNG with a
    JPEG copy of two train images a class."""
    root = str(tmp_path_factory.mktemp("packtree"))
    rng = np.random.default_rng(0)
    for fold, per in (("train", 7), ("val", 3)):
        for cls in CLASSES:
            d = os.path.join(root, fold, cls)
            os.makedirs(d)
            for i in range(per):
                h, w = rng.integers(16, 49, 2)
                img = Image.fromarray(
                    rng.integers(0, 256, (h, w, 3), np.uint8))
                img.save(os.path.join(d, f"{cls}{i}.png"))
                if fold == "train" and i < 2:
                    img.save(os.path.join(d, f"{cls}{i}j.jpg"), quality=90)
    return root


def _cfgs(jx, root, **kw):
    return (pcfg.DataConfig(data_dir=root, resize_size=SIZE, **kw),
            jx["cfg"].DataConfig(data_dir=root, resize_size=SIZE, **kw))


def _both_packs(jx, root, fold, work, **kw):
    pc, jc = _cfgs(jx, root, **kw)
    port_ds = ImageFolderDataset(root, fold, SIZE, pc)
    jax_ds = jx["folder"].ImageFolderDataset(root, fold, SIZE, jc)
    port = pack_dataset(port_ds, os.path.join(work, "port"), verbose=False)
    ref = jx["pack"].pack_dataset(jax_ds, os.path.join(work, "tpuic"),
                                  verbose=False)
    return port, ref


def _meta(path):
    with open(path[:-len(".bin")] + ".json") as f:
        return json.load(f)


def test_data_config_fields_are_tpuics(jx):
    port = {f.name: f.default for f in dataclasses.fields(pcfg.DataConfig)}
    ref = {f.name: f.default
           for f in dataclasses.fields(jx["cfg"].DataConfig)}
    assert port == ref
    for name in ("cache_dir", "device_cache_mb", "quarantine",
                 "quarantine_retries", "quarantine_backoff_s"):
        assert name in port


@pytest.mark.parametrize("fold", ["train", "val"])
def test_pack_is_tpuics_byte_for_byte(jx, tree, tmp_path, fold):
    port, ref = _both_packs(jx, tree, fold, str(tmp_path))
    assert os.path.basename(port.bin_path) == os.path.basename(ref.bin_path)
    assert os.path.basename(port.bin_path) == f"pack-{fold}-{SIZE}.bin"
    with open(port.bin_path, "rb") as a, open(ref.bin_path, "rb") as b:
        assert a.read() == b.read()
    assert _meta(port.bin_path) == _meta(ref.bin_path)
    assert len(port) == len(ref) == (27 if fold == "train" else 9)
    from tpuic_torch import native
    n = len(port)
    assert port.decoded == ({"native": n, "pil": 0}
                            if native.decode_available()
                            else {"native": 0, "pil": n})
    idx = np.arange(len(port))
    np.testing.assert_array_equal(port.raw_batch(idx), ref.raw_batch(idx))
    np.testing.assert_array_equal(port.label_batch(idx),
                                  ref.label_batch(idx))
    assert all(port.verify_row(i) and port.row_crc32(i) == ref.row_crc32(i)
               for i in idx)
    assert port.class_counts().tolist() == ref.class_counts().tolist()
    for i in (0, 5):
        got, want = port.load(i), ref.load(i)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        assert got[1:] == want[1:]


def test_each_package_reuses_the_others_cache(jx, tree, tmp_path):
    pc, jc = _cfgs(jx, tree)
    cache = str(tmp_path / "shared")
    ref = jx["pack"].pack_dataset(
        jx["folder"].ImageFolderDataset(tree, "val", SIZE, jc), cache,
        verbose=False)
    stamp = os.stat(ref.bin_path).st_mtime_ns
    port = pack_dataset(ImageFolderDataset(tree, "val", SIZE, pc), cache,
                        verbose=False)
    assert port.decoded is None and port.bin_path == ref.bin_path
    assert os.stat(ref.bin_path).st_mtime_ns == stamp
    # And the other way round: the port's train pack is tpuic's hit.
    port = pack_dataset(ImageFolderDataset(tree, "train", SIZE, pc), cache,
                        verbose=False)
    stamp = os.stat(port.bin_path).st_mtime_ns
    jx["pack"].pack_dataset(
        jx["folder"].ImageFolderDataset(tree, "train", SIZE, jc), cache,
        verbose=False)
    assert os.stat(port.bin_path).st_mtime_ns == stamp


def test_a_corrupt_file_is_quarantined_as_tpuic_does(jx, tree, tmp_path):
    root = str(tmp_path / "rotted")
    shutil.copytree(tree, root)
    victim = os.path.join(root, "train", "bee", "bee3.png")
    with open(victim, "r+b") as f:
        f.truncate(8)
    port, ref = _both_packs(jx, root, "train", str(tmp_path),
                            quarantine_retries=0, quarantine_backoff_s=0.0)
    assert port.quarantine_count == ref.quarantine_count == 1
    with open(port.bin_path, "rb") as a, open(ref.bin_path, "rb") as b:
        assert a.read() == b.read()
    assert _meta(port.bin_path) == _meta(ref.bin_path)
    ds = ImageFolderDataset(root, "train", SIZE, port.cfg)
    i = [p for p, _ in ds.samples].index(victim)
    # The row holds another bee, under that bee's id.
    assert port.label(i) == ds.samples[i][1]
    assert port.image_id(i) not in ("bee3", "") and \
        port.image_id(i).startswith("bee")
    assert all(port.verify_row(j) for j in range(len(port)))
    strict = dataclasses.replace(port.cfg, quarantine=False)
    with pytest.raises(OSError):
        pack_dataset(ImageFolderDataset(root, "train", SIZE, strict),
                     str(tmp_path / "strict"), verbose=False)


@pytest.mark.parametrize("native", [True, False])
def test_decode_path_quarantine_is_tpuics(jx, tree, tmp_path, native):
    root = str(tmp_path / "rotted")
    shutil.copytree(tree, root)
    victim = os.path.join(root, "train", "ant", "ant2.png")
    with open(victim, "r+b") as f:
        f.truncate(40)
    pc, jc = _cfgs(jx, root, native=native, quarantine_retries=1,
                   quarantine_backoff_s=0.0)
    port = ImageFolderDataset(root, "train", SIZE, pc)
    ref = jx["folder"].ImageFolderDataset(root, "train", SIZE, jc)
    i = [p for p, _ in port.samples].index(victim)
    got = port.load(i, np.random.default_rng(3))
    want = ref.load(i, np.random.default_rng(3))
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert got[1:] == want[1:] and got[2] != "ant2"
    assert port.quarantine_count == ref.quarantine_count == 1
    assert port.quarantined == ref.quarantined == {victim: 1}
    strict = ImageFolderDataset(root, "train", SIZE,
                                dataclasses.replace(pc, quarantine=False))
    with pytest.raises(OSError):
        strict.load(i)


def _loaders(ds, packed, *, cache_mb, rank=0, count=1, **kw):
    decode = Loader(ds, 4, num_workers=2, device="cpu", process_index=rank,
                    process_count=count, **kw)
    fast = Loader(packed, 4, device="cpu", process_index=rank,
                  process_count=count, device_cache_bytes=cache_mb << 20,
                  **kw)
    return decode, fast


@pytest.mark.parametrize("cache_mb", [4096, 0], ids=["resident",
                                                     "streaming"])
@pytest.mark.parametrize("fold", ["train", "val"])
def test_packed_loader_matches_decode_loader_and_tpuics(jx, tree, tmp_path,
                                                        cache_mb, fold):
    pc, jc = _cfgs(jx, tree)
    kw = (dict(seed=7, drop_last=True) if fold == "train"
          else dict(shuffle=False))
    train = ImageFolderDataset(tree, "train", SIZE, pc)
    ds = (train if fold == "train" else ImageFolderDataset(
        tree, fold, SIZE, pc, class_to_idx=train.class_to_idx))
    packed = pack_dataset(ds, str(tmp_path / "c"), verbose=False)
    decode, fast = _loaders(ds, packed, cache_mb=cache_mb, **kw)
    assert fast.packed and not decode.packed
    assert fast.resident == (cache_mb > 0)
    jpacked = jx["pack"].pack_dataset(
        jx["folder"].ImageFolderDataset(
            tree, fold, SIZE, jc,
            class_to_idx=None if fold == "train" else train.class_to_idx),
        str(tmp_path / "j"), verbose=False)
    ref = jx["pipe"].Loader(jpacked, 4, device_cache_bytes=cache_mb << 20,
                            process_index=0, process_count=1, **kw)
    assert ref.resident == fast.resident
    for epoch in (0, 1):
        n = 0
        for a, b, r in zip(decode.epoch(epoch), fast.epoch(epoch),
                           ref.epoch(epoch)):
            assert b["image"].dtype == torch.float32
            assert b["image"].shape == (4, SIZE, SIZE, 3)
            for want in (a["image"].numpy(), np.asarray(r["image"])):
                assert np.abs(b["image"].numpy() - want).max() < 1e-5
            for k in ("label", "mask"):
                np.testing.assert_array_equal(b[k].numpy(), a[k].numpy())
                np.testing.assert_array_equal(b[k].numpy(),
                                              np.asarray(r[k]))
            assert b.image_ids == a.image_ids == r.image_ids
            np.testing.assert_array_equal(b.indices, r.indices)
            n += 1
        assert n == len(fast) == len(ref) == (6 if fold == "train" else 3)
    assert fast.bytes_per_batch() == (
        4 * 4 if cache_mb else 4 * SIZE * SIZE * 3) + 4 * 8 + 4 * 20
    assert decode.bytes_per_batch() == 4 * SIZE * SIZE * 3 * 4 + 4 * 8


@pytest.mark.parametrize("cache_mb", [4096, 0], ids=["resident",
                                                     "streaming"])
def test_packed_loader_shards_over_two_ranks(jx, tree, tmp_path, cache_mb):
    pc, jc = _cfgs(jx, tree)
    ds = ImageFolderDataset(tree, "train", SIZE, pc)
    packed = pack_dataset(ds, str(tmp_path / "c"), verbose=False)
    jpacked = jx["pack"].pack_dataset(
        jx["folder"].ImageFolderDataset(tree, "train", SIZE, jc),
        str(tmp_path / "j"), verbose=False)
    kw = dict(seed=3, drop_last=True)
    _, whole = _loaders(ds, packed, cache_mb=cache_mb, **kw)
    for epoch in (0, 1):
        ones = list(whole.epoch(epoch))
        shards, refs = [], []
        for r in range(2):
            decode, fast = _loaders(ds, packed, cache_mb=cache_mb, rank=r,
                                    count=2, **kw)
            shards.append(list(fast.epoch(epoch)))
            ref = jx["pipe"].Loader(jpacked, 4, process_index=r,
                                    process_count=2,
                                    device_cache_bytes=cache_mb << 20, **kw)
            refs.append(list(ref.epoch(epoch)))
            for got, want in zip(shards[r], decode.epoch(epoch)):
                assert np.abs(got["image"].numpy()
                              - want["image"].numpy()).max() < 1e-5
                assert got.image_ids == want.image_ids
        for s, one in enumerate(ones):
            for k in ("image", "label", "mask"):
                assert torch.equal(torch.cat([shards[r][s][k]
                                              for r in range(2)]), one[k])
            assert [i for r in range(2) for i in shards[r][s].image_ids] \
                == one.image_ids
            for r in range(2):
                assert shards[r][s]["image"].shape[0] == 2
                assert np.abs(shards[r][s]["image"].numpy() - np.asarray(
                    refs[r][s]["image"])).max() < 1e-5
                assert shards[r][s].image_ids == refs[r][s].image_ids


def test_resident_upload_in_tiny_chunks(tree, tmp_path, monkeypatch):
    ds = ImageFolderDataset(tree, "train", SIZE, pcfg.DataConfig(
        data_dir=tree, resize_size=SIZE))
    packed = pack_dataset(ds, str(tmp_path / "c"), verbose=False)
    row = SIZE * SIZE * 3
    # 5 rows a chunk: 5 + 5 + ... + 2 for 27 rows.
    monkeypatch.setenv("TPUIC_UPLOAD_CHUNK_MB", str(5 * row / 2**20))
    from tpuic_torch.data import pipeline
    assert pipeline._upload_chunk_bytes() == 5 * row
    data = upload_resident(packed.array(), torch.device("cpu"))
    np.testing.assert_array_equal(data.numpy(), np.asarray(packed.array()))
    loader = Loader(packed, 4, device="cpu", seed=1, drop_last=True)
    assert loader.resident and loader.resident_bytes == 27 * row
    assert torch.equal(loader._data, data)
    assert len(list(loader.epoch(0))) == len(loader) == 6


def _trainer_cfg(root, ckpt, **data):
    return pcfg.Config(
        data=pcfg.DataConfig(data_dir=root, resize_size=16, batch_size=4,
                             num_workers=2, quarantine_retries=0,
                             quarantine_backoff_s=0.0, **data),
        model=pcfg.ModelConfig(name="resnet18-cifar", dtype="float32"),
        optim=pcfg.OptimConfig(optimizer="sgd", learning_rate=0.01,
                               class_weights=(), milestones=()),
        run=pcfg.RunConfig(epochs=1, ckpt_dir=ckpt, max_steps=1,
                           resume=False))


def test_trainer_packs_both_folds_and_splits_the_budget(tree, tmp_path):
    from tpuic_torch.train.loop import Trainer
    root = str(tmp_path / "rotted")
    shutil.copytree(tree, root)
    with open(os.path.join(root, "train", "cicada", "cicada1.png"),
              "r+b") as f:
        f.truncate(8)
    lines = []
    t = Trainer(_trainer_cfg(root, str(tmp_path / "ck"), device_cache_mb=1),
                device="cpu", log=lines.append)
    assert isinstance(t.train_ds, PackedDataset)
    assert isinstance(t.val_ds, PackedDataset)
    cache = os.path.join(root, ".tpuic_pack")
    assert sorted(os.listdir(cache)) == [
        "pack-train-16.bin", "pack-train-16.json", "pack-val-16.bin",
        "pack-val-16.json"]
    row = 16 * 16 * 3
    assert t.train_loader.resident and t.val_loader.resident
    assert t.train_loader.resident_bytes == 27 * row
    assert t.val_loader.device_cache_bytes == (1 << 20) - 27 * row
    assert any(ln.startswith("[pack] train: packed 27 rows")
               and "decoded by the native core" in ln
               and "1 quarantined" in ln for ln in lines), lines
    assert any(ln.startswith("[pack] val: packed 9 rows") for ln in lines)
    assert any(ln.startswith("[data] train resident") for ln in lines)
    t.fit()
    assert "[quarantine] epoch 0: 1 sample load(s) served a replacement " \
        "(total 1)" in lines
    # Again, from the cache, with no device budget: both stream.
    lines.clear()
    t = Trainer(_trainer_cfg(root, str(tmp_path / "ck2"), device_cache_mb=0,
                             cache_dir=cache), device="cpu",
                log=lines.append)
    assert t.train_loader.packed and not t.train_loader.resident
    assert t.val_loader.packed and not t.val_loader.resident
    assert any(ln.startswith("[pack] train: reused") for ln in lines)
    assert "[data] train streaming, val streaming" in lines


def test_train_cli_data_flags_reach_the_config():
    from tpuic_torch.train.__main__ import build_parser, config_from_args
    p = build_parser()
    cfg = config_from_args(p.parse_args(["--datadir", "D"]), p).data
    assert (cfg.pack, cfg.native, cfg.cache_dir, cfg.device_cache_mb,
            cfg.quarantine) == (True, True, "", 4096, True)
    cfg = config_from_args(p.parse_args(
        ["--datadir", "D", "--no-pack", "--no-native", "--cache-dir", "C",
         "--device-cache-mb", "0", "--no-quarantine"]), p).data
    assert (cfg.pack, cfg.native, cfg.cache_dir, cfg.device_cache_mb,
            cfg.quarantine) == (False, False, "C", 0, False)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_mb", [4096, 0], ids=["resident",
                                                     "streaming"])
def test_packed_batch_on_the_card_equals_the_cpu_batch(tree, tmp_path,
                                                       cache_mb):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's batches")
    ds = ImageFolderDataset(tree, "train", SIZE, pcfg.DataConfig(
        data_dir=tree, resize_size=SIZE))
    packed = pack_dataset(ds, str(tmp_path / "c"), verbose=False)
    kw = dict(seed=5, drop_last=True, device_cache_bytes=cache_mb << 20)
    card = Loader(packed, 4, device="cuda", **kw)
    cpu = Loader(packed, 4, device="cpu", **kw)
    assert card.resident == cpu.resident == (cache_mb > 0)
    if card.resident:
        assert card._data.is_cuda
    for epoch in (0, 1):
        for a, b in zip(card.epoch(epoch), cpu.epoch(epoch)):
            assert a["image"].is_cuda and a["label"].is_cuda
            assert (a["image"].cpu() - b["image"]).abs().max() < 1e-5
            assert torch.equal(a["label"].cpu(), b["label"])
            assert torch.equal(a["mask"].cpu(), b["mask"])
            assert a.image_ids == b.image_ids
