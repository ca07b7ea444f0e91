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

The kernel's tiling (``plan``) is checked on the CPU at every conv shape a
ResNet-50 forward at 224x224 launches and at the space-to-depth stem: it
must not depend on the batch (a served row's bits must not depend on the
bucket it rides in).  The ``cuda`` tests hold the kernel against its plain
version at those shapes, and check the batch invariance and the TF32
flags bit for bit on the card.
"""

import numpy as np
import pytest
import torch

from tpuic_torch.kernels import (fold_bn, fused_conv_bn_from_params,
                                 fused_conv_bn_relu, fused_conv_bn_relu_plain,
                                 no_tf32)
from tpuic_torch.kernels.conv_bn_relu import norm_padding, plan
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

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


# Every distinct conv of a ResNet-50 forward at 224x224, in launch order
# (x without its batch, w, stride, padding, ReLU), then the s2d stem: the
# 23 shapes chip_smoke.py's [kernel] phase times, and the one it adds.
RESNET50 = [
    ((224, 224, 3), (7, 7, 3, 64), 2, 3, True),
    ((56, 56, 64), (1, 1, 64, 64), 1, 0, True),
    ((56, 56, 64), (3, 3, 64, 64), 1, 1, True),
    ((56, 56, 64), (1, 1, 64, 256), 1, 0, False),
    ((56, 56, 256), (1, 1, 256, 64), 1, 0, True),
    ((56, 56, 256), (1, 1, 256, 128), 1, 0, True),
    ((56, 56, 128), (3, 3, 128, 128), 2, 1, True),
    ((28, 28, 128), (1, 1, 128, 512), 1, 0, False),
    ((56, 56, 256), (1, 1, 256, 512), 2, 0, False),
    ((28, 28, 512), (1, 1, 512, 128), 1, 0, True),
    ((28, 28, 128), (3, 3, 128, 128), 1, 1, True),
    ((28, 28, 512), (1, 1, 512, 256), 1, 0, True),
    ((28, 28, 256), (3, 3, 256, 256), 2, 1, True),
    ((14, 14, 256), (1, 1, 256, 1024), 1, 0, False),
    ((28, 28, 512), (1, 1, 512, 1024), 2, 0, False),
    ((14, 14, 1024), (1, 1, 1024, 256), 1, 0, True),
    ((14, 14, 256), (3, 3, 256, 256), 1, 1, True),
    ((14, 14, 1024), (1, 1, 1024, 512), 1, 0, True),
    ((14, 14, 512), (3, 3, 512, 512), 2, 1, True),
    ((7, 7, 512), (1, 1, 512, 2048), 1, 0, False),
    ((14, 14, 1024), (1, 1, 1024, 2048), 2, 0, False),
    ((7, 7, 2048), (1, 1, 2048, 512), 1, 0, True),
    ((7, 7, 512), (3, 3, 512, 512), 1, 1, True),
]
S2D_STEM = ((112, 112, 12), (4, 4, 12, 64), 1, ((2, 1), (2, 1)), True)
SHAPES = RESNET50 + [S2D_STEM]
# The stage-4 shapes: the grid these give at batch 8 without split-K is 56
# blocks of 64 x 64 (or 4 waves short of one at 128 pixels).
STAGE4 = [sh for sh in RESNET50 if sh[0][0] == 7 or sh[1][3] == 2048
          or sh[1][2] == 512 and sh[1][0] == 3 and sh[2] == 2]


def _id(shape):
    (h, _, cin), (k, _, _, cout), s, _, _ = shape
    return f"{h}x{cin}-{k}x{k}x{cout}-s{s}"


def _grid(shape, batch, pl):
    (h, w, _), (kh, kw, _, cout), s, p, _ = shape
    (pt, pb), (pl_, pr) = norm_padding(p)
    ho, wo = (h + pt + pb - kh) // s + 1, (w + pl_ + pr - kw) // s + 1
    return -(-batch * ho * wo // pl.bm) * -(-cout // 64) * pl.splits


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


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_plan_does_not_depend_on_batch(shape):
    """The split count, and so the order of every output's K sum, is the
    same at batch 1, 8 and 32 (the engine's buckets), in both activation
    types; so is the rest of the plan."""
    xs, ws, s, p, _ = shape
    for dtype in (torch.float32, torch.bfloat16):
        plans = {plan((b,) + xs, ws, s, p, dtype) for b in (1, 8, 32)}
        assert len(plans) == 1, plans
        (pl,) = plans
        assert pl.bm in (64, 128)
        k = ws[0] * ws[1] * ws[2]
        stages = -(-k // 32)
        per = -(-stages // pl.splits)
        assert 1 <= pl.splits <= 16 and (pl.splits - 1) * per < stages


def test_plan_gathers_the_stems_one_element_a_copy():
    """The 7x7x3 stem (K = 147, 12-byte pixel rows) cannot take 16-byte
    copies: float32 takes 4-byte copies, bf16 one 2-byte element; the s2d
    stem (Cin 12) takes 16-byte copies in float32, and every other ResNet-50
    shape in both types."""
    stem = RESNET50[0]
    assert plan((8,) + stem[0], stem[1], 2, 3).gather == 4
    assert plan((8,) + stem[0], stem[1], 2, 3, torch.bfloat16).gather == 2
    s2d = S2D_STEM
    assert plan((8,) + s2d[0], s2d[1], 1, s2d[3]).gather == 16
    assert plan((8,) + s2d[0], s2d[1], 1, s2d[3], torch.bfloat16).gather == 2
    for xs, ws, s, p, _ in RESNET50[1:]:
        for dtype in (torch.float32, torch.bfloat16):
            pl = plan((8,) + xs, ws, s, p, dtype)
            assert (pl.gather, pl.wgather) == (16, 16), (xs, ws, pl)


@pytest.mark.parametrize("shape", STAGE4, ids=_id)
def test_plan_fills_the_card_at_stage4(shape):
    """At batch 8 every stage-4 shape's grid has at least one block for
    each of an H100's 132 SMs (56 blocks without split-K)."""
    xs, ws, s, p, _ = shape
    pl = plan((8,) + xs, ws, s, p)
    assert _grid(shape, 8, pl) >= 132, pl


def test_plan_routes_other_shapes_and_types():
    """Cout % 4 != 0 takes 4-byte weight copies; the 3x3 conv at 56x56
    (392 blocks of 64 pixels at batch 8) and the short 1x1 convs there (2
    stages of K) take no split."""
    assert plan((2, 9, 9, 5), (3, 3, 5, 7), 1, 1).wgather == 4
    assert plan((2, 9, 9, 5), (3, 3, 5, 7), 1, 1).gather == 4
    pl = plan((8, 56, 56, 64), (3, 3, 64, 64), 1, 1)
    assert (pl.bm, pl.splits) == (64, 1)
    assert plan((8, 56, 56, 64), (1, 1, 64, 256)).splits == 1


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


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _cuda_case(seed, xs, ws, batch):
    """Inputs as chip_smoke.py makes them (weights scaled by 1/sqrt(K), so
    outputs are O(1)), from numpy with a seed, on the card."""
    rng = np.random.default_rng(seed)
    k = ws[0] * ws[1] * ws[2]
    x = rng.standard_normal((batch,) + tuple(xs)).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(k)).astype(np.float32)
    sc = (1.0 + 0.1 * rng.standard_normal(ws[3])).astype(np.float32)
    bi = (0.1 * rng.standard_normal(ws[3])).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, w, sc, bi)]


def _tf32_round(t):
    """t rounded to TF32 (10 mantissa bits, to nearest, ties away): the
    inputs of a single-pass TF32 product."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_cuda_resnet50_shapes_match_plain(shape):
    """Every ResNet-50 conv shape and the s2d stem at batch 2: float32
    against the plain version at atol/rtol 1e-4, and bf16 x with float32 w
    (the default model's types) at 1e-2, two bf16 ulps of the output."""
    _gpu()
    xs, ws, s, p, relu = shape
    x, w, sc, bi = _cuda_case(sum(ws), xs, ws, 2)
    before = fused_conv_bn_relu.launches
    got = fused_conv_bn_relu(x, w, sc, bi, strides=s, padding=p, relu=relu)
    torch.cuda.synchronize()
    assert fused_conv_bn_relu.launches == before + 1
    want = fused_conv_bn_relu_plain(x, w, sc, bi, s, p, relu)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    xb = x.to(torch.bfloat16)
    got = fused_conv_bn_relu(xb, w, sc, bi, strides=s, padding=p, relu=relu)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), fused_conv_bn_relu_plain(xb, w, sc, bi, s, p,
                                              relu).float(),
        rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [RESNET50[-1], RESNET50[2], RESNET50[0]],
                         ids=_id)
def test_cuda_row_bits_do_not_depend_on_batch(shape):
    """A row's output at batch 1 is bitwise the row inside a batch of 32:
    a split-K shape (3x3x512 at 7x7), a plain one (3x3x64 at 56x56) and the
    stem (4-byte gather, 128-pixel blocks)."""
    _gpu()
    xs, ws, s, p, relu = shape
    x, w, sc, bi = _cuda_case(5, xs, ws, 32)
    if shape is RESNET50[-1]:
        assert plan(x.shape, ws, s, p).splits > 1
    big = fused_conv_bn_relu(x, w, sc, bi, strides=s, padding=p, relu=relu)
    for row in (0, 13, 31):
        one = fused_conv_bn_relu(x[row:row + 1].contiguous(), w, sc, bi,
                                 strides=s, padding=p, relu=relu)
        assert torch.equal(one[0], big[row]), row


@pytest.mark.cuda
def test_cuda_bits_ignore_allow_tf32_and_tf32_control():
    """The kernel is 3xTF32 whatever the TF32 flags say: the same bits
    with TF32 allowed.  And the tolerance tells 3xTF32 from one TF32 pass:
    the plain version on TF32-rounded x and w falls outside atol/rtol 1e-4
    (3x3x512 at 7x7, K = 4,608)."""
    _gpu()
    xs, ws, s, p, relu = RESNET50[-1]
    x, w, sc, bi = _cuda_case(11, xs, ws, 2)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        off = fused_conv_bn_relu(x, w, sc, bi, strides=s, padding=p)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        on = fused_conv_bn_relu(x, w, sc, bi, strides=s, padding=p)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert torch.equal(off, on)
    want = fused_conv_bn_relu_plain(x, w, sc, bi, s, p, relu)
    torch.testing.assert_close(off, want, rtol=1e-4, atol=1e-4)
    single = fused_conv_bn_relu_plain(_tf32_round(x), _tf32_round(w), sc, bi,
                                      s, p, relu)
    assert not torch.allclose(single, want, rtol=1e-4, atol=1e-4), \
        float((single - want).abs().max())


@pytest.mark.cuda
def test_cuda_unaligned_input_takes_element_copies():
    """An x that starts off a 16-byte boundary (a contiguous view into a
    larger buffer) is gathered one element a copy, with the same bits as
    the aligned copy of it."""
    _gpu()
    xs, ws, s, p, relu = RESNET50[10]
    x, w, sc, bi = _cuda_case(3, xs, ws, 2)
    buf = torch.empty(x.numel() + 1, device="cuda")
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 == 4
    got = fused_conv_bn_relu(xu, w, sc, bi, strides=s, padding=p, relu=relu)
    assert torch.equal(got, fused_conv_bn_relu(x, w, sc, bi, strides=s,
                                               padding=p, relu=relu))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [RESNET50[2], RESNET50[-1]], ids=_id)
def test_cuda_bf16_weights_match_plain(shape):
    """bf16 weights (on no path of the port) are widened to float32 before
    the launch: the same bits as the widened weights, and the plain version
    within 1e-4 for float32 x and 1e-2 for bf16 x; a plain shape and a
    split-K one."""
    _gpu()
    xs, ws, s, p, relu = shape
    x, w, sc, bi = _cuda_case(17, xs, ws, 2)
    wb = w.to(torch.bfloat16)
    kw = dict(strides=s, padding=p, relu=relu)
    for xt, tol in ((x, 1e-4), (x.to(torch.bfloat16), 1e-2)):
        before = fused_conv_bn_relu.launches
        got = fused_conv_bn_relu(xt, wb, sc, bi, **kw)
        torch.cuda.synchronize()
        assert fused_conv_bn_relu.launches == before + 1
        assert got.dtype == xt.dtype
        assert torch.equal(got, fused_conv_bn_relu(xt, wb.float(), sc, bi,
                                                   **kw))
        torch.testing.assert_close(
            got.float(),
            fused_conv_bn_relu_plain(xt, wb, sc, bi, s, p, relu).float(),
            rtol=tol, atol=tol)


def test_design_variants_apply_to_the_kernel_source():
    """The design variants the card times beside the kernel
    (``conv_bn_relu_bench.py``) are built from the source as it ships:
    every substitution occurs once in it, and the shapes they are timed at
    are this file's SHAPES."""
    from tpuic_torch.kernels import _build
    from tpuic_torch.kernels.conv_bn_relu_bench import (VARIANTS,
                                                        distinct_shapes,
                                                        variant_source)
    src = (_build.CSRC / "conv_bn_relu.cu").read_text()
    for name, subs in VARIANTS.items():
        assert (variant_source(src, subs) == src) == (not subs), name
    with pytest.raises(ValueError, match="occurs 0 times"):
        variant_source(src, [("no such text", "")])
    assert [(xs[1:], ws, s, p, relu)
            for xs, ws, s, p, relu in distinct_shapes(8)] == SHAPES
