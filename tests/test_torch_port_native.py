"""The port's native C++ data core (``tpuic_torch/native``) against
``tpuic``'s (``tpuic/native``).

- The C++ sources are ``tpuic``'s byte for byte.
- The port builds into ``tpuic_torch/_build/``, its library named by a
  hash of the flags and the source, and writes nothing beside the source.
- ``decode_resize`` gives ``tpuic``'s bits for PNG (RGB, grayscale,
  palette) and JPEG (DCT-scaled at several sizes), and both reject the
  same garbage.
- ``prep_image`` gives ``tpuic``'s bits for every rot/flip/colour
  combination.
- A source that does not compile leaves the binding unavailable with the
  compiler's first error line, and the dataset then decodes with PIL: the
  same PNG bits.

``tpuic`` is imported inside the tests.
"""

import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tpuic_torch import native
from tpuic_torch.data import transforms as T
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

ROOT = Path(__file__).resolve().parent.parent


def _need_both():
    from tpuic import native as jnative
    if not (native.decode_available() and jnative.decode_available()):
        pytest.skip("the native decode core does not build here")
    return jnative


def _encode(img: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", ["decode.cpp", "dataprep.cpp"])
def test_cpp_sources_are_tpuics_byte_for_byte(name):
    assert ((ROOT / "tpuic_torch" / "native" / name).read_bytes()
            == (ROOT / "tpuic" / "native" / name).read_bytes())


def test_libraries_build_into_the_build_dir_named_by_a_hash():
    assert native.decode_available() and native.available()
    for lib in (native._decode, native._dataprep):
        path = lib.path
        assert path.parent == ROOT / "tpuic_torch" / "_build"
        assert path.is_file()
        stem = path.name[:-len(".so")]
        assert stem.startswith(f"lib{lib.name}-") and len(
            stem.split("-")[-1]) == 16
    assert native.status() == {"decode": "built", "dataprep": "built"}
    assert not list((ROOT / "tpuic_torch" / "native").glob("*.so"))


@pytest.mark.parametrize("kind", ["rgb", "gray", "palette"])
@pytest.mark.parametrize("size", [16, 48])
def test_decode_resize_png_is_tpuics_bitwise(kind, size):
    jnative = _need_both()
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (50, 37, 3), np.uint8)
    if kind == "rgb":
        data, ref = _encode(rgb, "PNG"), rgb
    elif kind == "gray":
        gray = rgb[..., 0]
        data, ref = _encode(gray, "PNG"), T.to_rgb(gray)
    else:
        pal = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE)
        buf = io.BytesIO()
        pal.save(buf, "PNG")
        data, ref = buf.getvalue(), np.asarray(pal.convert("RGB"))
    got = native.decode_resize(data, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, jnative.decode_resize(data, size))
    # PNG: the PIL + NumPy path's bits too.
    np.testing.assert_array_equal(got, T.resize_nearest(ref, size))


@pytest.mark.parametrize("size", [12, 32, 48, 130])
@pytest.mark.parametrize("quality", [75, 95])
def test_decode_resize_jpeg_is_tpuics_bitwise(size, quality):
    """DCT-scaled below full size, so held against ``tpuic``'s native
    output, not PIL's."""
    jnative = _need_both()
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (96, 128, 3), np.uint8)
    data = _encode(img, "JPEG", quality=quality)
    got = native.decode_resize(data, size)
    assert got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, jnative.decode_resize(data, size))


@pytest.mark.parametrize("data", [b"\x00" * 64, b"\xff\xd8corrupt jpeg!",
                                  b"\x89PNG\r\n\x1a\n" + b"\x00" * 32, b""])
def test_garbage_is_rejected_by_both(data):
    jnative = _need_both()
    assert native.decode_resize(data, 32) is None
    assert jnative.decode_resize(data, 32) is None


def test_truncated_png_is_rejected_by_both():
    jnative = _need_both()
    data = _encode(np.zeros((40, 40, 3), np.uint8) + 7, "PNG")
    assert native.decode_resize(data[:len(data) // 2], 32) is None
    assert jnative.decode_resize(data[:len(data) // 2], 32) is None


@pytest.mark.parametrize("rot", range(4))
@pytest.mark.parametrize("color", range(4))
def test_prep_image_is_tpuics_bitwise(rot, color):
    from tpuic import native as jnative
    if not (native.available() and jnative.available()):
        pytest.skip("the native prep core does not build here")
    rng = np.random.default_rng(10 * rot + color)
    img = rng.integers(0, 256, (41, 29, 3), np.uint8)
    for vflip, hflip in ((False, False), (True, False), (False, True),
                         (True, True)):
        kw = dict(rot_k=rot, vflip=vflip, hflip=hflip, color_op=color,
                  factor=0.93 + 0.04 * rot)
        got = native.prep_image(img, 24, **kw)
        np.testing.assert_array_equal(got, jnative.prep_image(img, 24, **kw))
        ref = T.normalize(T.apply_augment(T.resize_nearest(img, 24), rot,
                                          vflip, hflip, color,
                                          kw["factor"]))
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_a_failed_build_reports_its_first_error_line(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    lib = native._Lib("broken.cpp", "broken", "broken_abi_version", 1)
    assert lib.load() is None
    assert "error" in lib.error.lower() and "broken.cpp" in lib.error
    assert lib.load() is None  # tried once
    assert not list((tmp_path / "build").glob("*.so"))


def test_without_the_core_the_dataset_decodes_with_pil(tmp_path,
                                                       monkeypatch):
    from tpuic_torch.config import DataConfig
    from tpuic_torch.data.folder import ImageFolderDataset
    rng = np.random.default_rng(4)
    for fold in ("train", "val"):
        os.makedirs(tmp_path / fold / "a")
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (30, 22, 3), np.uint8)).save(
                tmp_path / fold / "a" / f"im{i}.png")
    ds = ImageFolderDataset(str(tmp_path), "train", 16,
                            DataConfig(data_dir=str(tmp_path)))
    with_core = [ds.load(i, np.random.default_rng(i)) for i in range(2)]
    monkeypatch.setattr(native, "decode_available", lambda: False)
    monkeypatch.setattr(native, "prep_image", lambda *a, **k: None)
    without = [ds.load(i, np.random.default_rng(i)) for i in range(2)]
    for (a, la, ia), (b, lb, ib) in zip(with_core, without):
        np.testing.assert_allclose(a, b, atol=1e-5)
        assert (la, ia) == (lb, ib)
