"""The port's device-side augmentation (``tpuic_torch/data/device_prep.py``)
against ``tpuic``'s (``tpuic/data/device_prep.py``) and the NumPy
transforms, on the CPU.

- ``apply_batch_augment`` over every rot/vflip/hflip/colour combination
  (64 rows): the geometry bitwise the NumPy path's, the whole output
  within 1e-5 of ``tpuic``'s and of the NumPy path's (the contrast mean
  sums in another order; ``tests/test_pack.py`` pins ``tpuic`` the same).
- ``pack_params`` is ``tpuic``'s bit for bit; identity params normalise
  only; the resident prep (gather, then augment) equals the streaming
  prep on the gathered rows; a bf16 ``out_dtype`` is the float32 output
  rounded.

``tpuic`` is imported inside the tests.
"""

import itertools

import numpy as np
import pytest
import torch

from tpuic_torch.data import transforms as T
from tpuic_torch.data.device_prep import (_geometry, apply_batch_augment,
                                          identity_params, make_device_prep,
                                          make_resident_prep, pack_params)
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

COMBOS = list(itertools.product(range(4), (0, 1), (0, 1), range(4)))


def _batch(size: int, seed: int = 0):
    """One row per combination, ``factor`` varied."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (len(COMBOS), size, size, 3), np.uint8)
    params = {"rot": [], "vflip": [], "hflip": [], "color": [],
              "factor": []}
    for i, (k, vf, hf, c) in enumerate(COMBOS):
        for key, v in zip(("rot", "vflip", "hflip", "color", "factor"),
                          (k, vf, hf, c, 0.9 + 0.2 * i / len(COMBOS))):
            params[key].append(v)
    params = {k: np.asarray(v, np.float32 if k == "factor" else np.int32)
              for k, v in params.items()}
    return imgs, params


def _torch_params(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


@pytest.mark.parametrize("size", [16, 33])
def test_geometry_is_the_numpy_permutation_bitwise(size):
    imgs, p = _batch(size)
    got = _geometry(torch.from_numpy(imgs), torch.from_numpy(p["rot"]),
                    torch.from_numpy(p["vflip"]),
                    torch.from_numpy(p["hflip"])).numpy()
    for i, (k, vf, hf, _) in enumerate(COMBOS):
        want = T.apply_augment(imgs[i], k, bool(vf), bool(hf), 0, 1.0)
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("size", [16, 33])
def test_batch_augment_matches_tpuic_and_numpy(size):
    from tpuic.data.device_prep import apply_batch_augment as jaug
    imgs, p = _batch(size, seed=size)
    got = apply_batch_augment(torch.from_numpy(imgs), _torch_params(p))
    assert got.dtype == torch.float32 and got.shape == imgs.shape
    got = got.numpy()
    want = np.asarray(jaug(imgs, p))
    assert np.abs(got - want).max() < 1e-5
    ref = np.stack([T.normalize(T.apply_augment(
        imgs[i], k, bool(vf), bool(hf), c, float(p["factor"][i])))
        for i, (k, vf, hf, c) in enumerate(COMBOS)])
    assert np.abs(got - ref).max() < 1e-5
    # The rows without a colour op are exact permutations of one
    # normalisation: the same bits whichever row they came from.
    plain = [i for i, combo in enumerate(COMBOS) if combo[3] == 0]
    assert np.abs(got[plain] - ref[plain]).max() < 1e-6


def test_pack_params_is_tpuics_and_identity_params_normalise_only():
    from tpuic.data.device_prep import pack_params as jpack
    _, p = _batch(8)
    np.testing.assert_array_equal(pack_params(p), jpack(p))
    assert pack_params(p).dtype == np.float32
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (4, 16, 16, 3), np.uint8)
    out = make_device_prep()(torch.from_numpy(imgs),
                             torch.from_numpy(pack_params(
                                 identity_params(4)))).numpy()
    ref = np.stack([T.normalize(im) for im in imgs])
    assert np.abs(out - ref).max() < 1e-6


def test_resident_prep_is_the_streaming_prep_on_the_gathered_rows():
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (20, 16, 16, 3), np.uint8)
    idx = np.array([3, 19, 0, 3, 7, 11, 2, 5], np.int32)
    _, p = _batch(16)
    packed = torch.from_numpy(pack_params(p)[:len(idx)])
    got = make_resident_prep()(torch.from_numpy(data), torch.from_numpy(idx),
                               packed)
    want = make_device_prep()(torch.from_numpy(data[idx]), packed)
    assert torch.equal(got, want)


def test_out_dtype_rounds_the_float32_output():
    imgs, p = _batch(16)
    f32 = apply_batch_augment(torch.from_numpy(imgs), _torch_params(p))
    bf16 = apply_batch_augment(torch.from_numpy(imgs), _torch_params(p),
                               out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


def test_custom_mean_and_std():
    from tpuic.data.device_prep import apply_batch_augment as jaug
    imgs, p = _batch(16, seed=3)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    got = apply_batch_augment(torch.from_numpy(imgs), _torch_params(p),
                              mean=mean, std=std).numpy()
    want = np.asarray(jaug(imgs, p, mean=mean, std=std))
    assert np.abs(got - want).max() < 1e-5
