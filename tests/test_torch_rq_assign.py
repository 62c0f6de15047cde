"""Port ``rq_assign`` (plain version, the CPU path of ``ops``) against the
JAX package's oracle and its Pallas kernel in interpret mode, on the
same numpy inputs.

Codes are discrete: they must be equal on every row except where the
deciding top-2 squared-distance gap is within 1e-4 * (1 + |d2|) (float
rounding may legitimately flip such a near-tie; each is reported).
Recon must match to 1e-5 (f32) on rows whose codes match.
"""
import re
from pathlib import Path

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
         (33, 16, (7, 5, 3)),
         # the kernel's edges: one row, one code, d not a multiple of the
         # k-tile, MAX_L layers, the largest d the kernel takes
         (1, 36, (5, 1)), (40, 36, (9, 1, 3)),
         (17, 260, (7, 6, 5, 4, 3, 2, 1, 1)),
         (130, port_kernel.D_MAX, (129, 50))]


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


def test_kernel_constants_match_the_cuda_source():
    src = (Path(port_kernel.__file__).resolve().parents[2] / "csrc"
           / "rq_assign.cu").read_text()
    defs = dict(re.findall(r"^#define (\w+) (\d+)", src, re.M))
    assert (int(defs["BM"]), int(defs["BN"]), int(defs["BK"]),
            int(defs["STAGES"]), int(defs["MAX_L"])) == (
        port_kernel._BM, port_kernel._BN, port_kernel._BK,
        port_kernel._STAGES, port_kernel.MAX_L)


def test_shared_memory_plan_fits_at_the_main_width():
    assert port_kernel.smem_bytes(256) <= port_kernel.SMEM_LIMIT == 232448


def test_stated_d_limit_agrees_with_smem_bytes():
    d_max = port_kernel.D_MAX
    assert d_max % 4 == 0 and d_max >= 256
    assert port_kernel.smem_bytes(d_max) <= port_kernel.SMEM_LIMIT
    assert port_kernel.smem_bytes(d_max + 4) > port_kernel.SMEM_LIMIT
    port_kernel.check_shape(d_max, port_kernel.MAX_L)
    for d, L in ((d_max + 4, 1), (6, 1), (0, 1)):
        with pytest.raises(ValueError, match=f"d <= {d_max}"):
            port_kernel.check_shape(d, L)
    for L in (0, port_kernel.MAX_L + 1):
        with pytest.raises(ValueError, match="codebooks"):
            port_kernel.check_shape(256, L)


def test_scratch_holds_padded_transposes_and_norms():
    # each layer: d x npad transposed codes plus npad norms, npad = n
    # rounded up to the code tile
    bn = port_kernel._BN
    assert port_kernel.scratch_floats(256, (5000, 50)) == (
        257 * (40 * bn) + 257 * bn)
    assert port_kernel.scratch_floats(36, (1,)) == 37 * bn
