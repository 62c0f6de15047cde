"""The dense LM serve path of the PyTorch port against the JAX package, on
the same weights (JAX ``init_params`` carried over by
``lm_params_from_jax``) and the same numpy tokens:

  * ``olmo-1b``, ``llama3.2-3b`` and ``gemma-2b`` cut as in
    ``tests/test_models.py::_reduced_lm`` (2 layers, d 64, 4 heads, head
    dim 16): ``forward`` logits, ``prefill`` last logits and caches, and
    ``decode_step`` logits and caches, in f32 within 1e-4 (the same f32
    arithmetic, sums in another order) and in bf16 within 5e-2 (bf16
    rounds at other places in the two frameworks);
  * the JAX params in both layouts, stacked (``scan_layers=True``) and a
    list of layers;
  * the port's own prefill/decode consistency, as
    ``tests/test_lm_family.py::test_prefill_decode_matches_forward``
    holds the JAX model, for its dense and gemma configs;
  * ``apply_rope``, the norms, the serve steps (``lm_prefill_step``,
    ``lm_decode_step`` against a cache filled to ``S - 1``), the configs
    and the registry (the MoE archs too); an MoE config builds and runs on
    the CPU, and CUDA without a card raises;
  * the attention at kimi-k2's head dim 112 (the plain version, which the
    CPU path takes) against JAX's ``_chunked_attention``, causal and with
    a ragged ``kv_len``, within 1e-5 (f32 sums in another order).
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.base import LMConfig as JaxLMConfig
from repro.configs.base import get_arch as jax_get_arch
from repro.distributed.sharding import NULL_CTX
from repro.models.lm import model as JLM
from repro.nn import core as jnn
from repro_torch.configs import base as port_base
from repro_torch.configs.base import LMConfig, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import lm_decode_step, lm_prefill_step
from repro_torch.models.lm import model as LM
from repro_torch.nn import core as nn

torch.set_num_threads(2)

ARCHS = ["olmo-1b", "llama3.2-3b", "gemma-2b"]
MOE_ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, S = 2, 16


def _reduced(arch_id: str, dtype: str = "float32", scan: bool = True):
    """tests/test_models.py::_reduced_lm's cut (dense archs), as a JAX
    config and the port's."""
    cfg = jax_get_arch(arch_id).config
    j = dc.replace(cfg, n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=16, d_ff=128,
                   vocab_size=128, dtype=dtype, param_dtype="float32",
                   scan_layers=scan)
    return j, LMConfig(**dc.asdict(j))


def _jax_params(jcfg, seed: int = 0):
    params, _ = JLM.init_params(jax.random.key(seed), jcfg)
    return jax.tree.map(np.asarray, params)


def _tokens(cfg, seed: int, n: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pad(caches, n):
    """(L, B, T, Hkv, D) caches padded with n zero positions."""
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
            for k, v in caches.items()}


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_prefill_decode_match_jax(arch_id, dtype, tol, scan):
    jcfg, cfg = _reduced(arch_id, dtype, scan)
    jp = _jax_params(jcfg, seed=len(arch_id))
    params = lm_params_from_jax(jp, device="cpu")
    assert len(params["layers"]) == jcfg.n_layers
    toks = _tokens(cfg, seed=len(arch_id) + 1)
    tt = torch.from_numpy(toks).long()

    want, _ = JLM.forward(jp, jcfg, jnp.asarray(toks))
    got = LM.forward(params, cfg, tt)
    assert got.dtype == LM.DTYPES[dtype] and got.shape == (B, S, 128)
    np.testing.assert_allclose(_np(got), _jnp(want), **tol)

    j_last, j_caches = JLM.prefill(jp, jcfg, jnp.asarray(toks), block_q=8)
    last, caches = LM.prefill(params, cfg, tt, block_q=8)
    np.testing.assert_allclose(_np(last), _jnp(j_last), **tol)
    for n in ("k", "v"):
        assert caches[n].shape == j_caches[n].shape
        np.testing.assert_allclose(_np(caches[n]), _jnp(j_caches[n]), **tol)

    # one decode step against the prompt's caches, padded to S + 4
    nxt = _tokens(cfg, seed=7, n=1)
    j_pad = jax.tree.map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))),
        j_caches)
    j_dec, j_new = JLM.decode_step(jp, jcfg, jnp.asarray(nxt), j_pad, S)
    dec, new = LM.decode_step(params, cfg, torch.from_numpy(nxt).long(),
                              _pad(caches, 4), S)
    np.testing.assert_allclose(_np(dec), _jnp(j_dec), **tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(new[n]), _jnp(j_new[n]), **tol)


# the configs of tests/test_lm_family.py (dense: olmo's norm with GQA;
# gemma: MQA, head dim 32, GeGLU, RMSNorm(+1), tied head)
FAMILY = {
    "dense": LMConfig(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=97, norm="layernorm_np",
                      dtype="float32", param_dtype="float32"),
    "gemma": LMConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                      head_dim=32, d_ff=128, vocab_size=64, act="gelu",
                      norm="rmsnorm_p1", tie_embeddings=True,
                      dtype="float32", param_dtype="float32"),
}


@pytest.mark.parametrize("name", list(FAMILY))
def test_prefill_decode_matches_forward(name):
    cfg = FAMILY[name]
    params = LM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=1)).long()
    logits_full = LM.forward(params, cfg, toks)
    last, caches = LM.prefill(params, cfg, toks, block_q=8)
    np.testing.assert_allclose(_np(last), _np(logits_full[:, -1]),
                               rtol=3e-4, atol=3e-4)
    caches = _pad(caches, 16)
    nxt = torch.argmax(last, -1)[:, None]
    dec, caches = LM.decode_step(params, cfg, nxt, caches, 16)
    logits2 = LM.forward(params, cfg, torch.cat([toks, nxt], dim=1))
    np.testing.assert_allclose(_np(dec), _np(logits2[:, -1]),
                               rtol=3e-3, atol=3e-3)
    # the step wrote its keys at position 16 and nothing past it
    assert bool(caches["k"][:, :, 16].abs().sum() > 0)
    assert bool((caches["k"][:, :, 17:] == 0).all())


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(int(theta) % 97)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 524288, (2, 5)).astype(np.int32)
    want = np.asarray(JLM.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta))
    got = LM.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        LM.rope_freqs(16, theta).numpy(),
        np.asarray(JLM.rope_freqs(16, theta)), rtol=1e-6)


def test_norms_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 32)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    tx, ts = torch.from_numpy(x), torch.from_numpy(scale)
    for plus_one in (False, True):
        want = jnn.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x), plus_one=plus_one)
        np.testing.assert_allclose(
            nn.rmsnorm_apply(ts, tx, plus_one=plus_one).numpy(),
            np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        nn.layernorm_apply(tx).numpy(),
        np.asarray(jnn.layernorm_apply(None, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_serve_steps_match_jax(arch_id):
    """The JAX decode cell's step: one token against caches of S
    positions filled to S - 1 (here: a prompt of S - 1 tokens)."""
    jcfg, cfg = _reduced(arch_id, "bfloat16")
    jp = _jax_params(jcfg, seed=3)
    params = lm_params_from_jax(jp, device="cpu")
    toks = _tokens(cfg, seed=4)
    j_last, j_caches = JLM.prefill(jp, jcfg, jnp.asarray(toks))
    last, caches = lm_prefill_step(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(last), _jnp(j_last), **BF16_TOL)
    j_half, j_caches = JLM.prefill(jp, jcfg, jnp.asarray(toks[:, :-1]))
    j_caches = jax.tree.map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))),
        j_caches)
    _, caches = lm_prefill_step(params, cfg,
                                torch.from_numpy(toks[:, :-1]).long())
    caches = _pad(caches, 1)
    nxt = toks[:, -1:]
    j_dec, _ = JLM.decode_step(jp, jcfg, jnp.asarray(nxt), j_caches, S - 1)
    dec, caches = lm_decode_step(params, cfg, caches,
                                 torch.from_numpy(nxt).long())
    assert dec.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(_np(dec), _jnp(j_dec), **BF16_TOL)
    # the last token's step equals the prefill's last position
    np.testing.assert_allclose(_np(dec), _np(last), **BF16_TOL)


def test_lm_config_fields_shapes_and_registry():
    jf = [(f.name, f.type, f.default) for f in dc.fields(JaxLMConfig)]
    pf = [(f.name, f.type, f.default) for f in dc.fields(LMConfig)]
    assert pf == jf
    assert ([(s.name, s.step, s.dims) for s in port_base.LM_SHAPES]
            == [(s.name, s.step, s.dims) for s in jax_base.LM_SHAPES])
    for a in ARCHS + MOE_ARCHS:
        pj, pp = jax_get_arch(a), get_arch(a)
        assert (pp.family, pp.source) == (pj.family, pj.source) \
            and pp.family == "lm"
        assert dc.asdict(pp.config) == dc.asdict(pj.config)
        assert [s.name for s in pp.shapes] == [s.name for s in pj.shapes]
    for a in ARCHS + MOE_ARCHS:
        jc, pc = jax_get_arch(a).config, get_arch(a).config
        assert (pc.n_params(), pc.n_active_params(),
                pc.resolved_head_dim) == (jc.n_params(),
                                          jc.n_active_params(),
                                          jc.resolved_head_dim)


def test_moe_and_cuda_without_a_card_raise():
    """An MoE config (grok's, narrowed) builds and runs on the CPU: init,
    ``forward``, ``prefill``, ``decode_step`` and ``lm_loss`` with its aux
    term; CUDA without a card raises."""
    moe = dc.replace(get_arch("grok-1-314b").config, n_layers=1, d_model=8,
                     vocab_size=8, n_heads=2, n_kv_heads=2, head_dim=4,
                     d_ff=8, moe_d_ff=8, n_experts=2, param_dtype="float32",
                     dtype="float32")
    params = LM.init_params(moe, device="cpu")
    assert params["layers"][0]["w_gate"].shape == (2, 8, 8)
    toks = torch.from_numpy(_tokens(moe, seed=2)).long() % 8
    logits = LM.forward(params, moe, toks)
    last, caches = LM.prefill(params, moe, toks)
    dec, _ = LM.decode_step(params, moe, toks[:, :1], _pad(caches, 1), S)
    loss = LM.lm_loss(params, moe, toks)
    assert logits.shape == (B, S, 8) and dec.shape == last.shape == (B, 8)
    assert all(bool(torch.isfinite(t).all()) for t in (logits, dec, loss))
    cfg = FAMILY["dense"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LM.init_params(cfg)                  # the default device: cuda
        with pytest.raises(RuntimeError):
            LM.init_kv_cache(cfg, 1, 8)


@pytest.mark.parametrize("case", ["causal", "kv_len"])
def test_head_dim_112_attention_matches_jax(case):
    """kimi-k2's head dim 112: 64 query heads over 8 cut to 8 over 2."""
    rng = np.random.default_rng(112)
    S, T = (24, 24) if case == "causal" else (1, 40)
    q = rng.standard_normal((B, S, 8, 112)).astype(np.float32)
    k = rng.standard_normal((B, T, 2, 112)).astype(np.float32)
    v = rng.standard_normal((B, T, 2, 112)).astype(np.float32)
    kv_len = None if case == "causal" else np.array([17, 40], np.int32)
    kw = dict(causal=case == "causal", q_offset=0, block_q=8,
              scale=112 ** -0.5)
    want = JLM._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        ctx=NULL_CTX, **kw)
    got = LM.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_len=None if kv_len is None else torch.from_numpy(kv_len), **kw)
    assert got.shape == (B, S, 8, 112)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
