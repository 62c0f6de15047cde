"""The fused contrastive losses of the PyTorch port against the JAX
package, in float32 on the same numpy inputs (tolerance 1e-5 absolute:
the same arithmetic, summed in another order):

  * ``contrastive_ref`` and ``fwd_ref`` against JAX ``contrastive_ref``
    (and ``fwd_ref``'s s_pos / lse against their definitions);
  * ``bwd_ref`` (the closed form the backward kernel computes) against
    ``jax.vjp`` of JAX ``contrastive_ref`` with random cotangents (at the
    scale of a batch mean's), and against ``torch.autograd`` through the
    port's plain forward;
  * all margins inactive, and one dominant logit (lse stability);
  * the tolerance ``chip_smoke.py`` holds the card's gradients to.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_contrastive.ref import contrastive_ref as jax_ref
from repro_torch.kernels.fused_contrastive.ops import contrastive
from repro_torch.kernels.fused_contrastive.ref import (bwd_ref,
                                                       contrastive_ref,
                                                       fwd_ref)

torch.set_num_threads(2)

TOL = 1e-5
MARGIN, TAU = 0.1, 0.06


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(B, N, d, seed, case="random"):
    rng = np.random.default_rng(seed)
    src = _unit(rng.normal(size=(B, d)))
    dst = _unit(rng.normal(size=(B, d)))
    negs = _unit(rng.normal(size=(B, N, d)))
    if case == "inactive":        # dst == src, negs orthogonal-ish far
        dst = src.copy()
        negs = _unit(-src[:, None, :] + 0.05 * rng.normal(size=(B, N, d)))
    elif case == "dominant":      # one negative equal to src: s = 1
        negs[:, 0] = src
        dst = _unit(-src + 0.1 * rng.normal(size=(B, d)))
    # cotangents at the scale a batch mean feeds the backward (the train
    # step takes the mean of each loss): N(0, 1) / B
    gm = (rng.normal(size=B) / B).astype(np.float32)
    gi = (rng.normal(size=B) / B).astype(np.float32)
    return src, dst, negs, gm, gi


CASES = [(64, 100, 32, "random"), (7, 10, 16, "random"),
         (130, 24, 48, "random"), (32, 12, 16, "inactive"),
         (32, 12, 16, "dominant")]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("B,N,d,case", CASES)
def test_forward_matches_jax(B, N, d, case):
    src, dst, negs, _, _ = _inputs(B, N, d, B + N, case)
    jm, ji = jax_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(negs),
                     margin=MARGIN, tau=TAU)
    pm, pi = contrastive_ref(*_t(src, dst, negs), margin=MARGIN, tau=TAU)
    fm, fi, sp, lse = fwd_ref(*_t(src, dst, negs), margin=MARGIN, tau=TAU)
    for a in (pm, fm):
        np.testing.assert_allclose(a.numpy(), np.asarray(jm), atol=TOL,
                                   rtol=0)
    for a in (pi, fi):
        np.testing.assert_allclose(a.numpy(), np.asarray(ji), atol=TOL,
                                   rtol=0)
    np.testing.assert_allclose(sp.numpy(), (src * dst).sum(-1), atol=TOL)
    np.testing.assert_allclose((lse - sp / TAU).numpy(), np.asarray(ji),
                               atol=TOL, rtol=0)
    if case == "inactive":
        assert float(fm.abs().max()) == 0.0
    if case == "dominant":
        assert np.isfinite(fi.numpy()).all() and float(fi.min()) > 1.0


@pytest.mark.parametrize("B,N,d,case", CASES)
def test_closed_form_backward_matches_jax_vjp_and_autograd(B, N, d, case):
    src, dst, negs, gm, gi = _inputs(B, N, d, 3 * B + N, case)
    _, vjp = jax.vjp(lambda s, t, n: jax_ref(s, t, n, margin=MARGIN,
                                             tau=TAU),
                     jnp.asarray(src), jnp.asarray(dst), jnp.asarray(negs))
    jgrads = vjp((jnp.asarray(gm), jnp.asarray(gi)))
    s, t, n = _t(src, dst, negs)
    _, _, sp, lse = fwd_ref(s, t, n, margin=MARGIN, tau=TAU)
    grads = bwd_ref(s, t, n, *_t(gm, gi), sp, lse, margin=MARGIN, tau=TAU)
    leaves = [x.clone().requires_grad_(True) for x in (s, t, n)]
    m, i = contrastive(*leaves, margin=MARGIN, tau=TAU)     # CPU: plain
    ((m * torch.from_numpy(gm)).sum()
     + (i * torch.from_numpy(gi)).sum()).backward()
    for got, want, auto in zip(grads, jgrads, leaves):
        assert got.dtype == torch.float32 and got.shape == auto.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), auto.grad.numpy(), atol=TOL,
                                   rtol=0)


def test_bfloat16_inputs_give_float32_losses():
    src, dst, negs, gm, gi = _inputs(16, 12, 32, 0)
    bf = [x.to(torch.bfloat16) for x in _t(src, dst, negs)]
    fm, fi, sp, lse = fwd_ref(*bf, margin=MARGIN, tau=TAU)
    assert all(x.dtype == torch.float32 for x in (fm, fi, sp, lse))
    ref = fwd_ref(*[x.float() for x in bf], margin=MARGIN, tau=TAU)
    for a, b in zip((fm, fi, sp, lse), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    g = bwd_ref(*bf, *_t(gm, gi), sp, lse, margin=MARGIN, tau=TAU)
    assert all(x.dtype == torch.float32 for x in g)


def test_chip_smoke_tolerance_catches_wrong_gradients():
    """The card check's tolerance (``chip_smoke.close``) at the train
    step's scale (cotangents N(0, 1) / 10,922): reordered f32 sums pass,
    a zeroed or a 1%-scaled ``d_negs`` fails."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src, dst, negs, gm, gi = _inputs(64, 100, 256, 5)
    gm, gi = gm * 64 / 10922, gi * 64 / 10922
    s, t, n = _t(src, dst, negs)
    _, _, sp, lse = fwd_ref(s, t, n, margin=MARGIN, tau=TAU)
    grads = bwd_ref(s, t, n, *_t(gm, gi), sp, lse, margin=MARGIN, tau=TAU)
    d_negs = grads[2]
    # an absolute 1e-4 would let zeros stand for nearly all of d_negs
    assert float((d_negs.abs() <= 1e-4).float().mean()) > 0.99
    for g in grads:
        assert smoke.close(g * (1 + 2e-5), g, 1e-4)
        assert smoke.close(g.to(torch.bfloat16), g, 2.0 ** -7)
    assert not smoke.close(torch.zeros_like(d_negs), d_negs, 1e-4)
    assert not smoke.close(d_negs * 0.99, d_negs, 1e-4)
    assert not smoke.close(torch.zeros_like(d_negs).to(torch.bfloat16),
                           d_negs, 2.0 ** -7)
