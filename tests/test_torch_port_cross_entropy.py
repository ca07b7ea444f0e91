"""Port parity: ``tpuic_torch`` fused weighted cross-entropy (K1) and the
reference loss against ``tpuic``'s.

The JAX side runs as tests/test_kernels.py runs it on the CPU: the Pallas
kernels in interpret mode (``fused_weighted_cross_entropy(...,
interpret=True)``) and the plain ``weighted_cross_entropy``.  The port
side is the ``autograd.Function`` on CPU tensors, which takes the plain
versions of the kernels.  Inputs come from numpy with a seed.
Tolerances are tests/test_kernels.py's: loss rtol 1e-6, gradient rtol
1e-5 / atol 1e-6 (float32 sums in another order).

JAX and ``tpuic`` are imported inside fixtures, so the ``cuda`` tests of
this file also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from tpuic_torch.kernels.cross_entropy import (cross_entropy_bwd,
                                               cross_entropy_bwd_plain,
                                               cross_entropy_fwd,
                                               cross_entropy_fwd_plain,
                                               fused_weighted_cross_entropy)
from tpuic_torch.train.loss import classification_loss, weighted_cross_entropy
from _torch_threads import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)

B = 37  # not a multiple of 8: the Pallas side pads the batch


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuic.kernels.cross_entropy import \
        fused_weighted_cross_entropy as jfused
    from tpuic.train import loss as jloss
    return jax, jnp, jfused, jloss


def _case(seed, c, weighted, masked, b=B):
    rng = np.random.default_rng(seed)
    logits = (5.0 * rng.standard_normal((b, c))).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[3] = c + 2          # one out-of-range label
    cw = (rng.random(c) * 4 + 0.5).astype(np.float32) if weighted else None
    mask = ((rng.random(b) > 0.2).astype(np.float32) if masked else None)
    return logits, labels, cw, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _port_value_and_grad(fn, logits, *args):
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = fn(x, *args)
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("c", [1, 7, 1000])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted,masked", [(False, False), (True, True)])
def test_fused_matches_pallas_kernel(jref, c, smoothing, weighted, masked):
    jax, jnp, jfused, _ = jref
    logits, labels, cw, mask = _case(c + int(10 * smoothing), c, weighted,
                                     masked)

    def jloss_fn(x):
        return jfused(x, jnp.asarray(labels),
                      None if cw is None else jnp.asarray(cw),
                      None if mask is None else jnp.asarray(mask),
                      smoothing, 128, True)

    want, want_g = jax.value_and_grad(jloss_fn)(jnp.asarray(logits))
    got, got_g = _port_value_and_grad(
        lambda x: fused_weighted_cross_entropy(x, _t(labels), _t(cw),
                                               _t(mask), smoothing), logits)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(got_g[3]).max() == 0.0  # out-of-range label: w = 0


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted,masked", [(False, False), (True, False),
                                             (False, True)])
def test_reference_loss_matches_tpuic(jref, smoothing, weighted, masked):
    """The plain loss, including tpuic's out-of-range-label behaviour: with
    no class weights such a row weighs 1 with NLL 0 (smoothing aside)."""
    jax, jnp, _, jloss = jref
    logits, labels, cw, mask = _case(5, 7, weighted, masked)

    def jloss_fn(x):
        return jloss.weighted_cross_entropy(
            x, jnp.asarray(labels), None if cw is None else jnp.asarray(cw),
            None if mask is None else jnp.asarray(mask), smoothing)

    want, want_g = jax.value_and_grad(jloss_fn)(jnp.asarray(logits))
    got, got_g = _port_value_and_grad(
        lambda x: weighted_cross_entropy(x, _t(labels), _t(cw), _t(mask),
                                         smoothing), logits)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)


def test_out_of_range_label_weights_differ_by_path():
    """Pinned as each side of tpuic has it: the kernel gives an
    out-of-range row w = 0, the reference (no class weights) w = 1."""
    logits = np.zeros((2, 4), np.float32)
    labels = np.array([1, 9], np.int32)
    ones = torch.ones(4)
    _, w = cross_entropy_fwd_plain(_t(logits), _t(labels), ones,
                                   torch.ones(2))
    assert w.tolist() == [1.0, 0.0]
    # Reference: both rows weigh 1; row 1's NLL is 0, so the loss halves.
    ref = weighted_cross_entropy(_t(logits), _t(labels))
    np.testing.assert_allclose(float(ref), np.log(4.0) / 2, rtol=1e-6)
    fused = fused_weighted_cross_entropy(_t(logits), _t(labels))
    np.testing.assert_allclose(float(fused), np.log(4.0), rtol=1e-6)


def test_classification_loss_aux_term_and_impls():
    logits, labels, cw, mask = _case(9, 7, True, True)
    aux = logits[::-1].copy()
    for impl in ("reference", "fused"):
        got = classification_loss((_t(logits), _t(aux)), _t(labels),
                                  class_weights=_t(cw), mask=_t(mask),
                                  label_smoothing=0.1, impl=impl)
        main = classification_loss(_t(logits), _t(labels),
                                   class_weights=_t(cw), mask=_t(mask),
                                   label_smoothing=0.1, impl=impl)
        side = classification_loss(_t(aux), _t(labels), class_weights=_t(cw),
                                   mask=_t(mask), label_smoothing=0.1,
                                   impl=impl)
        torch.testing.assert_close(got, main + 0.4 * side, rtol=1e-6,
                                   atol=0)
    with pytest.raises(ValueError, match="unknown loss impl"):
        classification_loss(_t(logits), _t(labels), impl="nope")


def test_wrappers_take_plain_versions_for_cpu_tensors():
    logits, labels, cw, mask = _case(2, 7, True, True)
    before = (cross_entropy_fwd.launches, cross_entropy_bwd.launches)
    args = (_t(logits), _t(labels), _t(cw), _t(mask))
    for a, b in zip(cross_entropy_fwd(*args, 0.1),
                    cross_entropy_fwd_plain(*args, 0.1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    scale = torch.tensor(0.25)
    torch.testing.assert_close(cross_entropy_bwd(*args, scale, 0.1),
                               cross_entropy_bwd_plain(*args, scale, 0.1),
                               rtol=0, atol=0)
    assert (cross_entropy_fwd.launches, cross_entropy_bwd.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(128, 1000), (128, 7), (B, 1), (B, 7),
                                 (B, 1000), (B, 21843)])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cuda_kernels_match_plain(b, c, smoothing):
    """K1 forward and backward against their plain versions on the card.
    Tolerance 1e-5 relative / 1e-6 absolute: float32 row sums in another
    order, and the forward's algebraic form of the smoothed NLL.  At C =
    21843 the backward streams its rows (past 1024 they do not stay in
    registers), and only every fourth row is 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    logits, labels, cw, mask = (None if a is None else torch.from_numpy(
        a).cuda() for a in _case(b + c, c, True, True, b=b))
    scale = torch.tensor(0.37, device="cuda")
    before = (cross_entropy_fwd.launches, cross_entropy_bwd.launches)
    wnll, w = cross_entropy_fwd(logits, labels, cw, mask, smoothing)
    dx = cross_entropy_bwd(logits, labels, cw, mask, scale, smoothing)
    torch.cuda.synchronize()
    assert (cross_entropy_fwd.launches, cross_entropy_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want_wnll, want_w = cross_entropy_fwd_plain(logits, labels, cw, mask,
                                                smoothing)
    torch.testing.assert_close(wnll, want_wnll, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(w, want_w, rtol=0, atol=0)
    torch.testing.assert_close(
        dx, cross_entropy_bwd_plain(logits, labels, cw, mask, scale,
                                    smoothing), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="labels must be"):
        cross_entropy_fwd(logits, labels.long(), cw, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_row", "one_class", "spread_1e4"])
def test_cuda_forward_edge_rows(case):
    """K1f's warp per row at its edges, against the plain version at the
    kernels' tolerance (1e-5 / 1e-6), w exact: a long row (C = 21843, whose
    rows are 16-byte aligned only every fourth row, so both load paths
    run), a single class (31 lanes of the warp see no element), and logits
    spread over +-1e4 (exp underflows to 0 for all but the largest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c = {"long_row": 21843, "one_class": 1, "spread_1e4": 1000}[case]
    logits, labels, cw, mask = (torch.from_numpy(a).cuda() for a in _case(
        c, c, True, True))
    if case == "spread_1e4":
        rng = np.random.default_rng(3)
        logits = torch.from_numpy(rng.uniform(-1e4, 1e4, (B, c)).astype(
            np.float32)).cuda()
    for smoothing in (0.0, 0.1):
        wnll, w = cross_entropy_fwd(logits, labels, cw, mask, smoothing)
        want_wnll, want_w = cross_entropy_fwd_plain(logits, labels, cw, mask,
                                                    smoothing)
        torch.cuda.synchronize()
        torch.testing.assert_close(wnll, want_wnll, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(w, want_w, rtol=0, atol=0)
        assert float(w[3]) == 0.0  # out-of-range label


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 7, 1000, 21843])
def test_cuda_backward_rows_ignore_their_batch(c):
    """K1b's dx for each row of a batch of 128 equals, bit for bit, the
    same row's dx at batch 1, and two calls give the same bits.  A row is
    one team of threads that owns the same elements whatever the row's
    alignment (at C = 7 and 21843 a row in the batch is 16-byte aligned
    only every fourth row, alone always)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    logits, labels, cw, mask = (torch.from_numpy(a).cuda() for a in _case(
        c + 1, c, True, True, b=128))
    scale = torch.tensor(0.37, device="cuda")
    whole = cross_entropy_bwd(logits, labels, cw, mask, scale, 0.1)
    again = cross_entropy_bwd(logits, labels, cw, mask, scale, 0.1)
    alone = torch.cat([cross_entropy_bwd(
        logits[r:r + 1].clone(), labels[r:r + 1].clone(), cw,
        mask[r:r + 1].clone(), scale, 0.1) for r in range(128)])
    torch.cuda.synchronize()
    assert torch.equal(whole, again)
    assert torch.equal(whole, alone)
