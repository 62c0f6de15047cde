"""The EmbeddingBag op of the PyTorch port against the JAX package, on the
same numpy inputs:

  * the forward (plain version, and the op on CPU tensors) against the
    JAX Pallas kernel in interpret mode and against ``embedding_bag_ref``,
    over the sweep of ``tests/test_kernels.py`` plus a bag longer than a
    warp's 32 ids: sum / mean x weighted / unweighted, ids at -1; f32
    within rtol = atol = 3e-5 (the same f32 sums in another order);
  * the gradients of the table and the weights (the plain backward and
    autograd through the op) against JAX's custom VJP with a random
    cotangent: rtol 2e-4, atol 1e-5 (as ``tests/test_kernels.py``);
  * the model path's bf16: an f32 table gathered, then rounded to bf16
    (``compute_dtype``), equals JAX's op on the bf16-cast table, and the
    gradient of the f32 table through that cast equals JAX's, both up to
    the order of the f32 sum: within one bf16 rounding, 2^-7 relative;
  * bags of padding only; the kernel wrappers refuse CPU tensors;
  * the backward kernel's segment plan (``segment_plan``) against numpy's
    stable argsort and searchsorted, and d_table summed in the kernel's
    order (each row's terms in plan order, a hot row's whole pieces
    summed apart, then rounded once) against JAX's custom VJP: GRAD_TOL
    in f32, BF16_REL with bf16 compute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as jax_op
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref
from repro_torch.kernels.embedding_bag import embedding_bag as K
from repro_torch.kernels.embedding_bag.embedding_bag import (rows_per_tile,
                                                             segment_plan)
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_bwd_ref,
                                                   embedding_bag_ref)

torch.set_num_threads(2)

F32_TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
BF16_REL = 2.0 ** -7          # one bf16 rounding step, relative
SHAPES = [(50, 16, 8, 3), (300, 64, 16, 8), (1000, 32, 5, 1),
          (400, 24, 6, 40)]


def _inputs(V, D, B, L, weighted, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(-1, V, (B, L)).astype(np.int32)
    w = rng.uniform(size=(B, L)).astype(np.float32) if weighted else None
    g = rng.normal(size=(B, D)).astype(np.float32)
    return table, ids, w, g


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("V,D,B,L", SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_forward_matches_jax_kernel_and_ref(V, D, B, L, mode, weighted):
    table, ids, w, _ = _inputs(V, D, B, L, weighted, V + D + L)
    jw = None if w is None else jnp.asarray(w)
    want_k = np.asarray(jax_op(jnp.asarray(table), jnp.asarray(ids), jw,
                               mode, True))          # Pallas, interpret
    want_r = np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(ids), jw,
                                mode))
    got = embedding_bag_ref(_t(table), _t(ids), _t(w), mode).numpy()
    np.testing.assert_allclose(got, want_k, **F32_TOL)
    np.testing.assert_allclose(got, want_r, **F32_TOL)
    op = embedding_bag(_t(table), _t(ids), _t(w), mode).numpy()
    np.testing.assert_array_equal(op, got)


@pytest.mark.parametrize("V,D,B,L", SHAPES[:2] + SHAPES[3:])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match_jax_custom_vjp(V, D, B, L, mode, weighted):
    table, ids, w, g = _inputs(V, D, B, L, weighted, 7 * V + L)
    jids = jnp.asarray(ids)
    if weighted:
        _, vjp = jax.vjp(lambda t, ww: jax_op(t, jids, ww, mode, False),
                         jnp.asarray(table), jnp.asarray(w))
        want_t, want_w = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    else:
        _, vjp = jax.vjp(lambda t: jax_op(t, jids, None, mode, False),
                         jnp.asarray(table))
        want_t, want_w = np.asarray(vjp(jnp.asarray(g))[0]), None
    d_t, d_w = embedding_bag_bwd_ref(_t(g), _t(table), _t(ids), _t(w), mode)
    np.testing.assert_allclose(d_t.numpy(), want_t, **GRAD_TOL)
    # autograd through the op takes the same backward
    tt = _t(table).requires_grad_(True)
    tw = _t(w).requires_grad_(True) if weighted else None
    out = embedding_bag(tt, _t(ids), tw, mode)
    grads = torch.autograd.grad(out, [tt] + ([tw] if weighted else []),
                                _t(g))
    np.testing.assert_allclose(grads[0].numpy(), want_t, **GRAD_TOL)
    if weighted:
        np.testing.assert_allclose(d_w.numpy(), want_w, **GRAD_TOL)
        np.testing.assert_allclose(grads[1].numpy(), want_w, **GRAD_TOL)
        assert (d_w.numpy()[ids < 0] == 0).all()
    else:
        assert d_w is None


def _bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= BF16_REL * np.abs(want) + 1e-7), \
        np.abs(got - want).max()


@pytest.mark.parametrize("V,D,B,L", [(300, 64, 32, 16), (2000, 64, 64, 8)])
def test_bf16_model_path_matches_jax(V, D, B, L):
    table, ids, _, g = _inputs(V, D, B, L, False, V)
    t16 = jnp.asarray(table).astype(jnp.bfloat16)
    want = jax_op(t16, jnp.asarray(ids), None, "sum", False)    # ref path
    want_k = jax_op(t16, jnp.asarray(ids), None, "sum", True)   # Pallas
    assert want.dtype == jnp.bfloat16
    tt = _t(table).requires_grad_(True)
    got = embedding_bag(tt, _t(ids), None, "sum",
                        compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _bf16_close(got.detach().float(), want.astype(jnp.float32))
    _bf16_close(got.detach().float(), want_k.astype(jnp.float32))
    # the same values from a bf16 table as from the f32 table rounded
    got16 = embedding_bag(torch.from_numpy(np.array(
        t16.astype(jnp.float32))).to(torch.bfloat16), _t(ids))
    np.testing.assert_array_equal(got16.float().numpy(),
                                  got.detach().float().numpy())
    # the f32 table's gradient through the cast: f32 sums rounded once
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: jax_op(t.astype(jnp.bfloat16),
                                      jnp.asarray(ids), None, "sum", False),
                     jnp.asarray(table))
    want_t = np.asarray(vjp(gb)[0])
    assert want_t.dtype == np.float32
    d_t, = torch.autograd.grad(got, tt, torch.from_numpy(
        np.array(gb.astype(jnp.float32))).to(torch.bfloat16))
    assert d_t.dtype == torch.float32
    _bf16_close(d_t.numpy(), want_t)
    # each entry is a bf16 value
    assert torch.equal(d_t, d_t.to(torch.bfloat16).float())


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_padding_only_bags(mode):
    table, _, w, g = _inputs(40, 8, 4, 5, True, 3)
    ids = np.full((4, 5), -1, np.int32)
    ids[2, 1] = 7
    out = embedding_bag_ref(_t(table), _t(ids), _t(w), mode).numpy()
    want = np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(w), mode))
    np.testing.assert_allclose(out, want, **F32_TOL)
    assert (out[[0, 1, 3]] == 0).all()
    d_t, d_w = embedding_bag_bwd_ref(_t(g), _t(table), _t(ids), _t(w), mode)
    rows = np.abs(d_t.numpy()).sum(axis=1)
    assert rows[7] > 0 and (np.delete(rows, 7) == 0).all()
    assert (d_w.numpy()[ids < 0] == 0).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    table, ids, w, g = _inputs(50, 16, 8, 3, True, 0)
    with pytest.raises(ValueError, match="CUDA"):
        K.embedding_bag_fwd(_t(table), _t(ids), _t(w))
    with pytest.raises(ValueError, match="CUDA"):
        K.embedding_bag_bwd(_t(g), _t(table), _t(ids), _t(w))


def _plan_ids(case):
    """(ids, V) of one segment-plan case: (N, L) int32, -1 = padding."""
    rng = np.random.default_rng(len(case))
    V = 50
    ids = rng.integers(-1, V, (12, 7)).astype(np.int32)
    if case == "last_row":
        ids[::2, 3] = V - 1
    elif case == "empty_bag":
        ids[4] = -1
    elif case == "all_padding":
        ids[:] = -1
    elif case == "shared_row":
        ids[:, :4] = 17                  # one row in every bag, 48 times
    elif case == "out_of_range":
        ids[1, :3] = [V, V + 9, -5]      # keyed V: dropped like padding
    return ids, V


@pytest.mark.parametrize("case", ["padding", "last_row", "empty_bag",
                                  "all_padding", "shared_row",
                                  "out_of_range"])
@pytest.mark.parametrize("tile", [1, 4])
def test_segment_plan_matches_numpy(case, tile):
    ids, V = _plan_ids(case)
    keys, slots, bounds = segment_plan(_t(ids), V, tile)
    keyed = np.where((ids >= 0) & (ids < V), ids, V).ravel()
    order = np.argsort(keyed, kind="stable")
    rows = np.minimum(np.arange(0, V + tile, tile), V)
    assert (keys.dtype, slots.dtype, bounds.dtype) == (
        torch.int32, torch.int64, torch.int32)
    np.testing.assert_array_equal(slots.numpy(), order)
    np.testing.assert_array_equal(keys.numpy(), keyed[order])
    np.testing.assert_array_equal(bounds.numpy(),
                                  np.searchsorted(keyed[order], rows))
    if tile == 1:                        # each row's ids, in slot order
        for v in (0, 17, V - 1):
            got = slots.numpy()[bounds[v]:bounds[v + 1]]
            np.testing.assert_array_equal(got, np.flatnonzero(
                ids.ravel() == v))


def test_rows_per_tile_fits_the_kernel():
    for D in range(1, K.MAX_DIM + 1):
        tile = rows_per_tile(D)
        assert tile >= 4 and tile % 4 == 0
        assert tile * D <= K.TILE_FLOATS < (tile + 4) * D


def _plan_order_d_table(g, ids, weights, mode, V, piece, compute_dtype):
    """d_table as the backward kernel sums it: each row's terms g[b] *
    w_eff (f32 products) added in ``segment_plan``'s order from 0, except
    that a row holding whole pieces of ``piece`` sorted positions adds
    each piece's own sum, in order, between its head and tail terms;
    rounded once to the compute type."""
    N, L = ids.shape
    keys, slots, bounds = segment_plan(ids, V, 1)
    w = ((ids >= 0) & (ids < V)).float()
    if weights is not None:
        w = w * weights
    if mode == "mean":
        w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-9)
    terms = g.float()[slots // L] * w.flatten()[slots][:, None]
    zero = torch.zeros(g.shape[1])

    def run(lo, hi, acc):
        for x in range(lo, hi):
            acc = acc + terms[x]
        return acc
    out = torch.zeros((V, g.shape[1]))
    for v in range(V):
        a, b = int(bounds[v]), int(bounds[v + 1])
        p0, p1 = -(-a // piece), b // piece
        if p1 > p0:
            acc = run(a, p0 * piece, zero)
            for p in range(p0, p1):
                acc = acc + run(p * piece, (p + 1) * piece, zero)
            out[v] = run(p1 * piece, b, acc)
        else:
            out[v] = run(a, b, zero)
    return out.to(compute_dtype).float()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plan_order_sum_matches_jax_bwd(mode, weighted):
    V, D, B, L = 40, 16, 24, 6
    table, ids, w, g = _inputs(V, D, B, L, weighted, 11)
    ids[:, 0] = 9                        # a hot row: 24 ids, 6 pieces of 4
    jids = jnp.asarray(ids)
    if weighted:
        _, vjp = jax.vjp(lambda t, ww: jax_op(t, jids, ww, mode, False),
                         jnp.asarray(table), jnp.asarray(w))
    else:
        _, vjp = jax.vjp(lambda t: jax_op(t, jids, None, mode, False),
                         jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _plan_order_d_table(_t(g), _t(ids), _t(w), mode, V, 4,
                              torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize("piece", [4, 512])
def test_plan_order_sum_matches_jax_bwd_bf16(piece):
    V, D, B, L = 300, 64, 32, 16
    table, ids, _, g = _inputs(V, D, B, L, False, V)
    ids[:, 1] = V - 1                    # a row shared by every bag
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: jax_op(t.astype(jnp.bfloat16),
                                      jnp.asarray(ids), None, "sum", False),
                     jnp.asarray(table))
    want = np.asarray(vjp(gb)[0])
    g16 = torch.from_numpy(np.array(gb.astype(jnp.float32))).to(
        torch.bfloat16)
    got = _plan_order_d_table(g16, _t(ids), None, "sum", V, piece,
                              torch.bfloat16)
    _bf16_close(got.numpy(), want)
    assert torch.equal(got, got.to(torch.bfloat16).float())
