"""Port parity: ``tpuic_torch`` flash attention (K4) against ``tpuic``'s.

The JAX side runs as tests/test_kernels.py runs it on the CPU: the Pallas
kernels in interpret mode, through the public ``flash_attention``
custom-vjp (which dispatches the lane-packed kernels at head dim 64 with
an even head count) and through ``_flash_fwd`` for the padded
``[B*H, 1, N_padded]`` lse.  The port side is the plain versions, which
the wrappers take for CPU tensors, and the ``autograd.Function``.  Inputs
come from numpy with a seed.  Tolerances: forward and lse atol/rtol 1e-5
(float32 sums in another order), gradients 1e-4 (tests/test_kernels.py's
pin of the flash backward against dense).

JAX and ``tpuic`` are imported inside fixtures, so the ``cuda`` tests of
this file also run where JAX is not installed.
"""

import importlib

import numpy as np
import pytest
import torch

from tpuic_torch.kernels import no_tf32
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

# tpuic_torch.kernels re-exports the function under the module's name.
FA = importlib.import_module("tpuic_torch.kernels.flash_attention")


@pytest.fixture(scope="module")
def jfa():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    fa = importlib.import_module("tpuic.kernels.flash_attention")
    return jax, jnp, fa.flash_attention, fa


def _qkv(seed, b, n, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, d)).astype(np.float32)
            for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n", [8, 17, 64])
def test_forward_matches_pallas(jfa, n):
    jax, jnp, flash, _ = jfa
    q, k, v = _qkv(n, 2, n, 4, 16)
    want = flash(*(jnp.asarray(a) for a in (q, k, v)), block_q=8, block_k=8)
    got = FA.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [70, 130])
@pytest.mark.parametrize("h", [2, 4])
def test_forward_matches_packed_pallas(jfa, n, h):
    """Head dim 64, an even head count: JAX runs the lane-packed kernels,
    whose Hopper counterpart is the same K4 forward."""
    jax, jnp, flash, fa = jfa
    assert fa._use_packed(h, 64)
    q, k, v = _qkv(n + h, 2, n, h, 64)
    want = flash(*(jnp.asarray(a) for a in (q, k, v)))
    got = FA.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,h,d,packed", [(17, 4, 16, False),
                                          (130, 2, 64, False),
                                          (130, 2, 64, True)])
def test_lse_matches_pallas(jfa, n, h, d, packed):
    """The port's unpadded [B, H, N] lse is the reference's [B*H, 1,
    N_padded] lse reshaped and sliced to N."""
    jax, jnp, _, fa = jfa
    b = 2
    q, k, v = _qkv(3 * n, b, n, h, d)
    bq, bk = fa._resolve_blocks(n, None, None)
    fwd = fa._flash_fwd_packed if packed else fa._flash_fwd
    want_o, want_lse = fwd(*(jnp.asarray(a) for a in (q, k, v)), bq, bk, True,
                           with_lse=True)
    want_lse = np.asarray(want_lse).reshape(b, h, -1)[:, :, :n]
    got_o, got_lse = FA.flash_attention_fwd(*_t(q, k, v))
    assert got_lse.shape == (b, h, n) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,n,h,d,valid_len", [(2, 17, 4, 16, None),
                                               (2, 70, 2, 64, None),
                                               (1, 64, 2, 64, 50)])
def test_gradients_match_jax_grad(jfa, b, n, h, d, valid_len):
    """The port's autograd.Function against ``jax.grad`` through
    ``tpuic``'s custom-vjp (folded kernels at D = 16, packed at D = 64),
    with and without a key mask."""
    jax, jnp, flash, _ = jfa
    q, k, v = _qkv(b * n + d, b, n, h, d)

    def jloss(q, k, v):
        return jnp.sum(flash(q, k, v, valid_len=valid_len) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    loss = torch.sum(FA.flash_attention(tq, tk, tv, valid_len=valid_len) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(
        *(jnp.asarray(a) for a in (q, k, v)))), rtol=1e-5)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_valid_len_masks_keys_like_pallas(jfa):
    """``valid_len = 50`` of N = 64 (the packed kernel's ``static_valid``)
    and the same count as a device ``valid`` tensor: every row attends to
    the first 50 keys only."""
    jax, jnp, flash, _ = jfa
    q, k, v = _qkv(50, 1, 64, 2, 64)
    want = np.asarray(flash(*(jnp.asarray(a) for a in (q, k, v)),
                            valid_len=50))
    o_len, lse_len = FA.flash_attention_fwd(*_t(q, k, v), valid_len=50)
    o_dev, lse_dev = FA.flash_attention_fwd(
        *_t(q, k, v), valid=torch.tensor([50], dtype=torch.int32))
    np.testing.assert_allclose(o_len.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(o_len, o_dev) and torch.equal(lse_len, lse_dev)
    short, _ = FA.flash_attention_fwd(*_t(q[:, :50], k[:, :50], v[:, :50]))
    np.testing.assert_allclose(o_len.numpy()[:, :50], short.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sentinel", [0.0, -1e30])
def test_fully_masked_rows_write_zero_and_the_sentinel(jfa, sentinel):
    """No valid key: o = 0 and lse = ``masked_sentinel``, the lse the
    reference writes (``_finish_tile``); the backward stays finite."""
    jax, jnp, _, fa = jfa
    q, k, v = _qkv(7, 2, 20, 2, 16)
    valid = torch.tensor([0], dtype=torch.int32)
    o, lse = FA.flash_attention_fwd(*_t(q, k, v), valid=valid,
                                    masked_sentinel=sentinel)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.full_like(lse, sentinel))
    _, want_lse = fa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), 8, 8,
                                True, with_lse=True,
                                valid=jnp.zeros((1,), jnp.int32),
                                masked_sentinel=sentinel)
    np.testing.assert_array_equal(
        lse.numpy(), np.asarray(want_lse).reshape(2, 2, -1)[:, :, :20])
    grads = FA.flash_attention_bwd(*_t(q, k, v), o, lse,
                                   torch.ones_like(o), valid=valid)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_residuals_are_linear_in_n():
    """The saved tensors are (q, k, v, o, lse): O(N*D), never [N, N]
    (the counterpart of tests/test_kernels.py's residual check)."""
    b, n, h, d = 1, 64, 1, 8
    q, k, v = (t.requires_grad_(True) for t in _t(*_qkv(0, b, n, h, d)))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        out = FA.flash_attention(q, k, v)
    assert len(saved) == 5
    assert max(saved) <= b * n * h * d < n * n
    out.sum().backward()
    assert q.grad.shape == q.shape


def test_strided_qkv_views_need_no_copy():
    """q/k/v as the ViT makes them, [B, N, H, D] views of one [B, N, 3*H*D]
    projection: the same result as contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 19, 3 * 64)).astype(
        np.float32))
    views = [t.view(2, 19, 4, 16) for t in qkv.split(64, dim=-1)]
    assert not views[0].is_contiguous()
    got = FA.flash_attention_fwd(*views)
    want = FA.flash_attention_fwd(*(t.contiguous() for t in views))
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_wrappers_take_plain_versions_for_cpu_tensors():
    q, k, v = _t(*_qkv(1, 1, 9, 2, 16))
    before = (FA.flash_attention_fwd.launches,
              FA.flash_attention_bwd_dq.launches,
              FA.flash_attention_bwd_dkv.launches)
    o, lse = FA.flash_attention_fwd(q, k, v)
    want = FA.flash_attention_fwd_plain(q, k, v)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    do = torch.ones_like(o)
    for a, w in zip(FA.flash_attention_bwd(q, k, v, o, lse, do),
                    FA.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        assert torch.equal(a, w)
    with pytest.raises(ValueError, match="no dq kernel"):
        FA.flash_attention_bwd_dq(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="no dk/dv kernel"):
        FA.flash_attention_bwd_dkv(q, k, v, lse, lse, do)
    assert (FA.flash_attention_fwd.launches,
            FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n,h,d,valid", [(70, 4, 64, None), (17, 4, 16, None),
                                         (64, 2, 32, 50), (33, 1, 128, None),
                                         (20, 2, 64, 0), (197, 12, 64, None),
                                         (520, 2, 64, None), (1, 2, 64, None),
                                         (197, 2, 128, 150)])
def test_cuda_kernels_match_plain(dtype, tol, n, h, d, valid):
    """K4 forward, dq and dk/dv against their plain versions on the card,
    on strided q/k/v views of one projection, TF32 off.  float32 at
    atol/rtol 1e-4 (the backward's 3xTF32 products and sums in another
    order); bfloat16 at 1e-2 (the outputs round to bf16 on both sides, and
    the backward rounds p and ds to bf16 as the reference does).  The
    shapes: ViT-B/16's heads at N = 197 (a ragged last tile); N = 520,
    which passes through the backward's two-stage copy ring nine times;
    N = 1; D = 128, whose backward splits its columns over two blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n * d)
    qkv = torch.randn((2, n, 3 * h * d), generator=g, device="cuda")
    q, k, v = (t.to(dtype).view(2, n, h, d)
               for t in qkv.split(h * d, dim=-1))
    do = torch.randn((2, n, h, d), generator=g, device="cuda").to(dtype)
    vt = None if valid is None else torch.tensor([valid], dtype=torch.int32,
                                                 device="cuda")
    before = (FA.flash_attention_fwd.launches,
              FA.flash_attention_bwd_dq.launches,
              FA.flash_attention_bwd_dkv.launches)
    with no_tf32():
        o, lse = FA.flash_attention_fwd(q, k, v, valid=vt)
        dq, delta = FA.flash_attention_bwd_dq(q, k, v, o, lse, do, valid=vt)
        dk, dv = FA.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                            valid=vt)
        torch.cuda.synchronize()
        want_o, want_lse = FA.flash_attention_fwd_plain(q, k, v, valid=vt)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, valid=vt)
    assert (FA.flash_attention_fwd.launches - before[0],
            FA.flash_attention_bwd_dq.launches - before[1],
            FA.flash_attention_bwd_dkv.launches - before[2]) == (1, 1, 1)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        delta, (do.float() * o.float()).sum(-1).transpose(1, 2), rtol=1e-4,
        atol=1e-4)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), w.float(), rtol=tol, atol=tol)
    # Determinism: no atomics, so a second run gives the same bits.
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, valid=vt)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))


def _views(n, h, d, dtype, seed, offset=0):
    """q, k, v as [2, n, h, d] views of one projection, and do; ``offset``
    elements into the buffer (to misalign the rows)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn((2 * n * 3 * h * d + offset,), generator=g,
                      device="cuda").to(dtype)
    qkv = buf[offset:].view(2, n, 3 * h * d)
    q, k, v = (t.view(2, n, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn((2, n, h, d), generator=g, device="cuda").to(dtype)
    return q, k, v, do


@pytest.mark.cuda
def test_cuda_backward_bits_ignore_allow_tf32():
    """The float32 backward is 3xTF32 whatever torch's TF32 flags say: the
    same bits with ``allow_tf32`` off and on, at the ViT-B/16 head shape.
    The control: the plain backward with its products in single-pass TF32
    falls outside the 1e-4 tolerance the kernels are held to, so that
    tolerance tells TF32 from 3xTF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, do = _views(197, 12, 64, torch.float32, 5)
    o, lse = FA.flash_attention_fwd(q, k, v)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    runs, plain = [], []
    try:
        for on in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
            runs.append(FA.flash_attention_bwd(q, k, v, o, lse, do))
            plain.append(FA.flash_attention_bwd_plain(q, k, v, o, lse, do))
            torch.cuda.synchronize()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
               for a, b in zip(runs[0], plain[0]))
    assert not all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                   for a, b in zip(plain[1], plain[0]))


@pytest.mark.cuda
def test_cuda_forward_bits_ignore_allow_tf32():
    """The float32 forward is 3xTF32 whatever torch's TF32 flags say: the
    same o and lse bits with ``allow_tf32`` off and on, at the ViT-B/16
    head shape.  The control: the plain forward with its products in
    single-pass TF32 falls outside the 1e-4 tolerance the kernel is held
    to, so that tolerance tells TF32 from 3xTF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, _ = _views(197, 12, 64, torch.float32, 6)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    runs, plain = [], []
    try:
        for on in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
            runs.append(FA.flash_attention_fwd(q, k, v))
            plain.append(FA.flash_attention_fwd_plain(q, k, v))
            torch.cuda.synchronize()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
               for a, b in zip(runs[0], plain[0]))
    assert not all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                   for a, b in zip(plain[1], plain[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_rows_ignore_their_batch(dtype):
    """A (b, h) slice's forward depends on that slice alone: the rows of
    batch element 13 of 32 have the same bits when it runs alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(13)
    qkv = torch.randn((32, 197, 3 * 4 * 64), generator=g,
                      device="cuda").to(dtype)
    q, k, v = (t.view(32, 197, 4, 64) for t in qkv.split(256, dim=-1))
    o, lse = FA.flash_attention_fwd(q, k, v)
    o1, lse1 = FA.flash_attention_fwd(q[13:14], k[13:14], v[13:14])
    torch.cuda.synchronize()
    assert torch.equal(o1[0], o[13]) and torch.equal(lse1[0], lse[13])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_takes_misaligned_rows(dtype):
    """Rows that do not start on 16 bytes (a view one element into its
    buffer) go through a contiguous copy: the forward gives the same o and
    lse as on aligned copies of the same values, and matches its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, _ = _views(37, 2, 32, dtype, 10, offset=1)
    assert q.data_ptr() % 16 != 0
    got = FA.flash_attention_fwd(q, k, v)
    want = FA.flash_attention_fwd(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with no_tf32():
        plain = FA.flash_attention_fwd_plain(q, k, v)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[0].float(), plain[0].float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_takes_misaligned_rows(dtype):
    """Rows that do not start on 16 bytes (a view one element into its
    buffer) go through a contiguous copy: the same gradients as aligned
    copies of the same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, do = _views(37, 2, 32, dtype, 9, offset=1)
    assert q.data_ptr() % 16 != 0
    o, lse = FA.flash_attention_fwd(q, k, v)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do)
    want = FA.flash_attention_bwd(*(t.contiguous() for t in (q, k, v)), o,
                                  lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_row_aligned_copies_only_misaligned_rows():
    """The backward wrappers' guard: aligned strided views (the ViT's q/k/v
    of one projection) pass as they are; a view whose rows start off a
    16-byte boundary becomes a contiguous, aligned copy."""
    qkv = torch.zeros((2, 19, 3 * 64), dtype=torch.float32)
    view = qkv.split(64, dim=-1)[1].view(2, 19, 4, 16)
    assert FA._row_aligned(view) is view
    off = torch.zeros(2 * 19 * 64 + 1)[1:].view(2, 19, 4, 16)
    odd = torch.zeros((2, 19, 4, 18))[..., :16]
    for t in (off, odd):
        got = FA._row_aligned(t)
        assert got is not t and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
