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
  * the tolerance ``chip_smoke.py`` holds the card's gradients to;
  * a numpy model of the backward kernel's one pass (each a[n] from its
    own dot and the saved lse, a[n] * negs[n] summed per warp in the
    kernel's order, the warps in turn, c * dst last) against ``jax.vjp``;
  * the backward's launch plan (``bwd_plan``) and its limit check: every
    shape the earlier kernel took (one row's negatives staged in shared
    memory) is taken, and only rows wider than ``D_MAX`` are refused.
"""
import contextlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_contrastive.ref import contrastive_ref as jax_ref
from repro_torch.kernels.fused_contrastive.fused_contrastive import (
    D_MAX, SMEM_LIMIT, BwdPlan, bwd_plan, bwd_smem_bytes, check_bwd_shape)
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


@contextlib.contextmanager
def _one_torch_thread():
    """The port's side of a comparison with JAX on one torch thread.  Its
    CPU kernels (MKL's batched product under ``einsum``, ATen's
    reductions) pick their code path, and with it the order of their f32
    sums, by the machine's instruction set, and MKL also by the threads it
    is given: on this case the margin loss sits 7.6e-6 off JAX's with the
    AVX-512 paths and 9.5e-6 with MKL's AVX2 one, against ``TOL`` 1e-5,
    where JAX's side did not move (its outputs were bitwise the same over
    18,705 runs, idle and under load).  One thread takes the thread count
    out of that choice, as tests/test_torch_recsys.py's train-step
    comparison does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("B,N,d,case", CASES)
def test_forward_matches_jax(B, N, d, case):
    src, dst, negs, _, _ = _inputs(B, N, d, B + N, case)
    jm, ji = jax_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(negs),
                     margin=MARGIN, tau=TAU)
    with _one_torch_thread():
        pm, pi = contrastive_ref(*_t(src, dst, negs), margin=MARGIN, tau=TAU)
        fm, fi, sp, lse = fwd_ref(*_t(src, dst, negs), margin=MARGIN,
                                  tau=TAU)
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


def _warp_negatives(N, d):
    """Each warp's negatives, in the order the backward kernel takes
    them for f32 rows of width d (16-byte aligned): groups of G
    consecutive negatives dealt to the warps in turn; the wide kernel
    takes them all in one sequence."""
    plan = bwd_plan(N, d, torch.float32)
    if plan.path == "wide":
        return [list(range(N))]
    G = 4 // plan.vpl if plan.path == "vector" else 4
    return [[n for n0 in range(G * w, N, G * plan.warps)
             for n in range(n0, min(n0 + G, N))]
            for w in range(plan.warps)]


def _one_pass_model(src, dst, negs, gm, gi, s_pos, lse):
    """The backward kernel's one pass in float32 numpy: each a[n] from
    negative n's own dot and the saved s_pos and lse, d_negs[n] = a[n] *
    src at once, a[n] * negs[n] and the active bit summed per warp in the
    kernel's order, the warps' sums added in warp order, c * dst last."""
    f32 = np.float32
    margin, tau = f32(MARGIN), f32(TAU)
    d_negs = np.empty_like(negs)
    sums, counts = [], []
    for ns in _warp_negatives(negs.shape[1], negs.shape[2]):
        acc = np.zeros_like(src)
        cnt = np.zeros_like(gm)
        for n in ns:
            s = np.einsum("bd,bd->b", src, negs[:, n])
            act = (s - s_pos + margin > 0).astype(f32)
            a = gm * act + gi * (np.exp(s / tau - lse) / tau)
            d_negs[:, n] = a[:, None] * src
            acc = acc + a[:, None] * negs[:, n]
            cnt = cnt + act
        sums.append(acc)
        counts.append(cnt)
    acc, cnt = sums[0], counts[0]
    for a_w, c_w in zip(sums[1:], counts[1:]):
        acc, cnt = acc + a_w, cnt + c_w
    c = -gm * cnt + gi * (np.exp(s_pos / tau - lse) - f32(1)) / tau
    return acc + c[:, None] * dst, c[:, None] * src, d_negs


# the file's shapes, plus rows of no whole 16-byte units (scalar loads)
# and rows wider than the register path (the wide kernel)
MODEL_CASES = CASES + [(9, 7, 102, "random"), (3, 5, 516, "random")]


@pytest.mark.parametrize("B,N,d,case", MODEL_CASES)
def test_one_pass_order_matches_jax_vjp(B, N, d, case):
    src, dst, negs, gm, gi = _inputs(B, N, d, 5 * B + N, case)
    _, vjp = jax.vjp(lambda s, t, n: jax_ref(s, t, n, margin=MARGIN,
                                             tau=TAU),
                     jnp.asarray(src), jnp.asarray(dst), jnp.asarray(negs))
    jgrads = vjp((jnp.asarray(gm), jnp.asarray(gi)))
    _, _, sp, lse = fwd_ref(*_t(src, dst, negs), margin=MARGIN, tau=TAU)
    got = _one_pass_model(src, dst, negs, gm, gi, sp.numpy(), lse.numpy())
    assert sum(map(len, _warp_negatives(N, d))) == N
    for g, want in zip(got, jgrads):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(want), atol=TOL, rtol=0)


def _old_smem(N, d, dtype):
    """Shared memory of the earlier backward block, which staged one
    row's N x d negatives: what decided the shapes it took."""
    return 4 * (2 * d + N + 4) + torch.finfo(dtype).bits // 8 * N * d


GRID_D = (1, 24, 33, 100, 256, 512, 1024, 1032, 4096, 19_369, 23_242)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 7, 100, 224, 1000, 10_000, 29_000])
def test_limit_takes_every_shape_the_old_kernel_took(N, dtype):
    taken = [d for d in GRID_D if _old_smem(N, d, dtype) <= SMEM_LIMIT]
    assert taken                      # d 1 fits at every N of the grid
    for d in taken:
        check_bwd_shape(N, d, dtype)
        for aligned in (True, False):
            plan = bwd_plan(N, d, dtype, aligned)
            assert 1 <= plan.warps <= 8 and plan.smem <= SMEM_LIMIT
            # the register path launches without raising its block's
            # shared memory past the default 48 KB
            assert plan.path == "wide" or plan.smem <= 48 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_limit_raises_beyond_the_wide_kernel(dtype):
    check_bwd_shape(1, D_MAX, dtype)
    assert bwd_smem_bytes(1, D_MAX, dtype) <= SMEM_LIMIT
    assert bwd_smem_bytes(1, D_MAX + 1, dtype) > SMEM_LIMIT
    for N, d in ((1, D_MAX + 1), (100, 2 * D_MAX), (1, 10 ** 6)):
        with pytest.raises(ValueError, match="shared memory"):
            check_bwd_shape(N, d, dtype)


def test_bwd_plan_at_the_main_path_and_its_edges():
    bf16, f32 = torch.bfloat16, torch.float32
    # the train step: 25 groups of 4 negatives over 7 warps, 4 a warp
    assert bwd_plan(100, 256, bf16) == BwdPlan("vector", 1, 7, 6172)
    assert bwd_plan(100, 256, f32) == BwdPlan("vector", 2, 8, 7200)
    assert bwd_plan(100, 256, bf16, aligned=False) == \
        BwdPlan("scalar", 8, 7, 6172)
    assert bwd_plan(16, 24, bf16) == BwdPlan("vector", 1, 4, 304)
    assert bwd_plan(7, 100, bf16).path == "scalar"
    assert bwd_plan(7, 100, f32).path == "vector"
    assert bwd_plan(1, 256, bf16) == BwdPlan("vector", 1, 1, 4)
    assert bwd_plan(16, 1024, bf16).vpl == 4
    assert bwd_plan(16, 1032, bf16) == BwdPlan("wide", 0, 8, 8320)
    assert bwd_plan(16, 257, f32).path == "wide"
