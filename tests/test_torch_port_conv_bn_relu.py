"""Port parity: ``tpuic_torch`` fused conv + folded-BN + ReLU against the
``tpuic`` Pallas kernel.

The JAX side runs as tests/test_kernels.py runs it on the CPU (Pallas
interpret mode); the port side is the plain PyTorch version, which is
what the wrapper takes for a CPU tensor.  Inputs come from numpy with a
seed.  Tolerance: atol/rtol 1e-4, the pin of tests/test_kernels.py (the
tap-matmul f32 accumulation order differs from a convolution's).

JAX and ``tpuic`` are imported inside the ``ref`` fixture, so that the
``cuda`` tests of this file also run where JAX is not installed
(``pytest --noconftest -m cuda`` on a GPU machine).
"""

import numpy as np
import pytest
import torch

from tpuic_torch.kernels import (fold_bn, fused_conv_bn_from_params,
                                 fused_conv_bn_relu, fused_conv_bn_relu_plain,
                                 no_tf32)
from tpuic_torch.kernels.conv_bn_relu import norm_padding

CASES = [
    # (h, w, cin, cout, k, stride, pad, relu) — tests/test_kernels.py CASES
    (8, 8, 3, 16, 3, 1, 1, True),           # conv3x3 stride 1
    (9, 11, 4, 8, 3, 2, 1, True),           # conv3x3 stride 2, odd dims
    (32, 32, 3, 16, 7, 2, 3, True),         # the 7x7/s2 stem
    (8, 8, 16, 32, 1, 2, 0, True),          # downsample conv1x1 stride 2
    (8, 8, 16, 32, 1, 1, 0, True),          # bottleneck conv1x1
    # and the port's additions:
    (16, 16, 12, 16, 4, 1, ((2, 1), (2, 1)), True),  # the s2d stem
    (8, 8, 4, 8, 3, 1, 1, False),           # residual tail: no ReLU
]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from tpuic.kernels import conv_bn_relu
    return conv_bn_relu


def _case(seed, h, w, cin, cout, k, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, h, w, cin)).astype(np.float32)
    wk = (0.1 * rng.standard_normal((k, k, cin, cout))).astype(np.float32)
    sc = rng.standard_normal(cout).astype(np.float32)
    bi = rng.standard_normal(cout).astype(np.float32)
    return x, wk, sc, bi


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("h,w,cin,cout,k,s,p,relu", CASES)
def test_plain_matches_pallas_kernel(ref, h, w, cin, cout, k, s, p, relu):
    x, wk, sc, bi = _case(h + k + s, h, w, cin, cout, k)
    want = np.asarray(ref.fused_conv_bn_relu(x, wk, sc, bi, strides=s,
                                             padding=p, relu=relu))
    got = fused_conv_bn_relu_plain(*_t(x, wk, sc, bi), s, p, relu)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if not relu:
        assert float(got.min()) < 0.0  # negative values survive


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x, wk, sc, bi = _case(5, 9, 11, 4, 8, 3)
    before = fused_conv_bn_relu.launches
    got = fused_conv_bn_relu(*_t(x, wk, sc, bi), strides=2, padding=1)
    want = fused_conv_bn_relu_plain(*_t(x, wk, sc, bi), 2, 1, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_conv_bn_relu.launches == before  # no kernel launched


def test_fold_bn_matches_jax(ref):
    rng = np.random.default_rng(3)
    c = 12
    gamma, beta, mean = (rng.standard_normal(c).astype(np.float32)
                         for _ in range(3))
    var = (rng.random(c) + 0.1).astype(np.float32)
    want = [np.asarray(a) for a in ref.fold_bn(gamma, beta, mean, var, 1e-5)]
    got = fold_bn(*_t(gamma, beta, mean, var), 1e-5)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-6, atol=1e-6)


def test_from_params_matches_folded_call():
    """``fused_conv_bn_from_params`` (OIHW weight + BN leaves) equals
    folding by hand and calling the kernel's function on HWIO."""
    rng = np.random.default_rng(7)
    x, wk, _, _ = _case(7, 8, 8, 4, 8, 3)
    gamma, beta, mean = (torch.from_numpy(rng.standard_normal(8)
                                          .astype(np.float32))
                         for _ in range(3))
    var = torch.from_numpy((rng.random(8) + 0.5).astype(np.float32))
    w_oihw = torch.from_numpy(wk).permute(3, 2, 0, 1).contiguous()
    got = fused_conv_bn_from_params(torch.from_numpy(x), w_oihw, gamma, beta,
                                    mean, var, padding=1, eps=1e-3)
    sc, bi = fold_bn(gamma, beta, mean, var, 1e-3)
    want = fused_conv_bn_relu_plain(torch.from_numpy(x), torch.from_numpy(wk),
                                    sc, bi, 1, 1, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_output_dtype_follows_bf16_input():
    x, wk, sc, bi = _case(13, 8, 8, 4, 8, 3)
    xt, wt, st, bt = _t(x, wk, sc, bi)
    out = fused_conv_bn_relu(xt.to(torch.bfloat16), wt, st, bt, padding=1)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())


def test_rejects_wrong_cin_and_empty_output():
    x, wk, sc, bi = _case(1, 8, 8, 4, 8, 3)
    xt, wt, st, bt = _t(x, wk, sc, bi)
    with pytest.raises(ValueError, match="kernel expects Cin=4, input has 3"):
        fused_conv_bn_relu(xt[..., :3], wt, st, bt, padding=1)
    with pytest.raises(ValueError, match="empty output"):
        fused_conv_bn_relu(xt[:, :2, :2], wt, st, bt, padding=0)
    with pytest.raises(ValueError, match="empty output"):
        fused_conv_bn_relu_plain(xt[:, :2, :2], wt, st, bt, 1, 0, True)


def test_padding_is_four_sided():
    assert norm_padding(1) == ((1, 1), (1, 1))
    assert norm_padding(((2, 1), (0, 3))) == ((2, 1), (0, 3))
    x, wk, sc, bi = _case(2, 6, 6, 2, 4, 4)
    out = fused_conv_bn_relu_plain(*_t(x, wk, sc, bi), 1, ((2, 1), (0, 3)),
                                   False)
    assert out.shape == (2, 6 + 3 - 4 + 1, 6 + 3 - 4 + 1, 4)


def test_no_tf32_restores_flags():
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    with no_tf32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (conv, mm)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,cout,k,s,p,relu", CASES)
def test_cuda_kernel_matches_plain(h, w, cin, cout, k, s, p, relu):
    """The hand-written kernel against its plain version on the card
    (TF32 off in the plain version; f32 tolerance 1e-4 as above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, wk, sc, bi = (t.cuda() for t in _t(*_case(h + k, h, w, cin, cout, k,
                                                    batch=3)))
    before = fused_conv_bn_relu.launches
    got = fused_conv_bn_relu(x, wk, sc, bi, strides=s, padding=p, relu=relu)
    torch.cuda.synchronize()
    assert fused_conv_bn_relu.launches == before + 1
    want = fused_conv_bn_relu_plain(x, wk, sc, bi, s, p, relu)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # bf16 activations: the same rounded inputs on both sides; bf16
    # output rounding (8 mantissa bits) sets the tolerance.
    xb = x.to(torch.bfloat16)
    torch.testing.assert_close(
        fused_conv_bn_relu(xb, wk, sc, bi, strides=s, padding=p,
                           relu=relu).float(),
        fused_conv_bn_relu_plain(xb, wk, sc, bi, s, p, relu).float(),
        rtol=1.6e-2, atol=1.6e-2)
