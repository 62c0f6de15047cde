"""Port ``rq_assign`` (plain version, the CPU path of ``ops``) against the
JAX package's oracle and its Pallas kernel in interpret mode, on the
same numpy inputs.

Codes are discrete: they must be equal on every row except where the
deciding top-2 squared-distance gap is within 1e-4 * (1 + |d2|) (float
rounding may legitimately flip such a near-tie; each is reported).
Recon must match to 1e-5 (f32) on rows whose codes match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rq_assign.ops import (flat_codes_np,
                                         rq_assign as jax_rq_assign,
                                         rq_assign_corpus as jax_corpus)
from repro.kernels.rq_assign.ref import rq_assign_ref as jax_rq_ref
from repro_torch.kernels.rq_assign import rq_assign as port_kernel
from repro_torch.kernels.rq_assign.ops import (flat_codes, rq_assign,
                                               rq_assign_corpus)

torch.set_num_threads(2)

NEAR_TIE = 1e-4
SWEEP = [(64, 32, (16,)), (100, 64, (32, 8)), (256, 128, (500, 50)),
         (33, 16, (7, 5, 3))]


def near_tie_mismatches(x, books, codes_a, codes_b) -> int:
    """Count rows whose codes differ; fail unless each one's first
    differing layer is a near-tie (f64 distances along ``codes_b``'s
    path)."""
    x = np.asarray(x, np.float64)
    books = [np.asarray(c, np.float64) for c in books]
    codes_a, codes_b = np.asarray(codes_a), np.asarray(codes_b)
    n = 0
    for row in np.flatnonzero((codes_a != codes_b).any(axis=1)):
        r = x[row]
        for l, C in enumerate(books):
            if codes_a[row, l] != codes_b[row, l]:
                d2 = np.sort(((r[None, :] - C) ** 2).sum(axis=1))
                assert d2[1] - d2[0] <= NEAR_TIE * (1 + abs(d2[0])), (
                    f"row {row} layer {l}: codes {codes_a[row, l]} vs "
                    f"{codes_b[row, l]} with top-2 gap {d2[1] - d2[0]}")
                n += 1
                break
            r = r - C[codes_b[row, l]]
    if n:
        print(f"rq_assign: {n} near-tie rows differ")
    return n


def _inputs(B, d, sizes, dtype):
    rng = np.random.default_rng(B + d)
    x = rng.normal(size=(B, d)).astype(np.float32)
    books = [(rng.normal(size=(n, d)) * 0.5).astype(np.float32)
             for n in sizes]
    if dtype == "bfloat16":      # both sides see the same bf16 values
        x, *books = [np.array(jnp.asarray(a, jnp.bfloat16)
                                .astype(jnp.float32)) for a in [x, *books]]
    return x, books


def _assert_agree(x, books, codes_p, recon_p, codes_j, recon_j):
    codes_p, recon_p = codes_p.numpy(), recon_p.numpy()
    codes_j, recon_j = np.asarray(codes_j), np.asarray(recon_j)
    near_tie_mismatches(x, books, codes_p, codes_j)
    same = (codes_p == codes_j).all(axis=1)
    np.testing.assert_allclose(recon_p[same], recon_j[same], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,d,sizes", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle(B, d, sizes, dtype):
    x, books = _inputs(B, d, sizes, dtype)
    codes_j, recon_j = jax_rq_ref(jnp.asarray(x), [jnp.asarray(c)
                                                   for c in books])
    codes_p, recon_p = rq_assign(torch.from_numpy(x),
                                 [torch.from_numpy(c) for c in books])
    assert codes_p.dtype == torch.int32 and recon_p.dtype == torch.float32
    _assert_agree(x, books, codes_p, recon_p, codes_j, recon_j)


def test_plain_matches_pallas_interpret():
    x, books = _inputs(100, 64, (32, 8), "float32")
    codes_j, recon_j = jax_rq_assign(jnp.asarray(x),
                                     [jnp.asarray(c) for c in books],
                                     use_kernel=True, block_b=64)
    codes_p, recon_p = rq_assign(torch.from_numpy(x),
                                 [torch.from_numpy(c) for c in books])
    _assert_agree(x, books, codes_p, recon_p, codes_j, recon_j)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_corpus_is_chunk_invariant_and_matches_jax(chunk):
    x, books = _inputs(150, 32, (20, 6), "float32")
    tx, tb = torch.from_numpy(x), [torch.from_numpy(c) for c in books]
    codes, recon = rq_assign_corpus(tx, tb, chunk=chunk)
    whole_c, whole_r = rq_assign(tx, tb)
    assert torch.equal(codes, whole_c) and torch.equal(recon, whole_r)
    codes_j, recon_j = jax_corpus(x, books, chunk=chunk)
    _assert_agree(x, books, codes, recon, codes_j, recon_j)
    np.testing.assert_array_equal(
        flat_codes(codes, (20, 6)).numpy(), flat_codes_np(codes.numpy(),
                                                          (20, 6)))


def test_kernel_wrapper_takes_only_cuda_tensors():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.rq_assign(x, [torch.zeros((3, 8))])
    with pytest.raises(ValueError, match="cuda or cpu"):
        rq_assign(torch.zeros((4, 8), device="meta"),
                  [torch.zeros((3, 8), device="meta")])
