"""The recsys slice of the PyTorch port against the JAX package, on the
same numpy inputs and the JAX parameters carried over with
``recsys_params_from_jax``:

  * configs and the arch registry: field for field;
  * the four forwards (dlrm with single ids and with multi-hot bags,
    wide-deep, sasrec's user representation and scores, bst) at the
    tiny config of ``tests/test_models.py`` (vocab 200, float32): within
    rtol = atol = 1e-5 (the same f32 arithmetic in another order); in
    bf16 compute (f32 parameters) within one bf16 step of the largest
    output, 2^-7 of its magnitude: both frameworks round to bf16 after
    every product and accumulate in f32, but in their own order, so a
    rounding may fall the other way (at these sizes they agreed
    exactly);
  * four f32 ``recsys_train_step``s for dlrm (bags) and sasrec on the
    same batches: the loss within 1e-4 relative at every step (as
    ``tests/test_torch_train.py``), which a wrong route, clip or update
    would break (sasrec's step 3 read 1.0e-5 to 1.2e-5 apart with 1 to
    4 CPU threads); the torch side runs on one thread, because with two
    its sums changed with the machine's load.  After the last step each
    parameter's median gap is within 1e-4 and at most 1% of its entries
    are more than 1e-3 apart;
    there is no bound on the largest gap, because both optimizers
    amplify tiny differences: the first AdaGrad / AdamW update is
    g / (|g| + 1e-8) per entry, whatever |g|, and a ReLU input near 0
    that rounds to the other side changes one sample's gradient, and so
    whole table rows, by O(1) of it.  Seen after four steps: sasrec
    median gaps up to 1.9e-5, 0.04% of one matrix's entries beyond
    1e-3, the largest 5.6e-3 (dlrm 8.5e-4 here; on the H100 against the
    CPU, 0.04, two AdaGrad steps of lr 0.02 in opposite directions);
  * ``recsys_retrieval_step`` (dlrm and bst, bf16 scores) and ``top_k``:
    the top-100 indices bitwise equal to ``jax.lax.top_k``'s, with
    planted ties (lower index first);
  * optimizer routing by name, and the launcher at ``_reduced`` size.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.base import get_arch as jax_get_arch
from repro.distributed.sharding import NULL_CTX
from repro.models.recsys import models as JR
from repro.optim import optimizers as JO
from repro_torch.configs import base as port_base
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.convert import recsys_params_from_jax
from repro_torch.launch import steps as S
from repro_torch.launch import train as LT
from repro_torch.models.recsys import models as R
from repro_torch.optim import optimizers as O

torch.set_num_threads(2)

ARCHS = ["dlrm-rm2", "wide-deep", "sasrec", "bst"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_FRAC = 2.0 ** -7
PARAM_MEDIAN, PARAM_FAR, PARAM_FAR_SHARE = 1e-4, 1e-3, 0.01
VOCAB, B = 200, 8


def _cfgs(arch_id, dtype="float32"):
    kw = dict(default_vocab=VOCAB, dtype=dtype, param_dtype="float32")
    return (dataclasses.replace(jax_get_arch(arch_id).config, **kw),
            dataclasses.replace(get_arch(arch_id).config, **kw))


def _jax_init(jcfg, seed=0):
    init = {"dlrm": JR.dlrm_init, "wide_deep": JR.wide_deep_init,
            "sasrec": JR.sasrec_init, "bst": JR.bst_init}[jcfg.kind]
    return init(jax.random.key(seed), jcfg)[0]


def _port(jparams, kind):
    return recsys_params_from_jax(jax.tree.map(np.asarray, jparams), kind,
                                  device="cpu")


def _batch(cfg, rng, n, bags=0):
    """numpy batch of ``n`` rows for ``cfg.kind``; ``bags`` > 0 gives dlrm
    multi-hot ids (n, F, bags) with -1 padding.  dlrm / wide-deep ids run
    past the vocab (taken mod V)."""
    V = cfg.default_vocab
    lab = (rng.random(n) > .5).astype(np.float32)
    if cfg.kind == "dlrm":
        if bags:
            sparse = rng.integers(0, 3 * V, (n, cfg.n_sparse, bags))
            sparse[rng.random(sparse.shape) < 0.3] = -1
        else:
            sparse = rng.integers(0, 3 * V, (n, cfg.n_sparse))
        return {"dense": rng.normal(size=(n, cfg.n_dense)).astype(
            np.float32), "sparse": sparse.astype(np.int32), "labels": lab}
    if cfg.kind == "wide_deep":
        return {"sparse": rng.integers(0, 3 * V, (n, cfg.n_sparse)
                                       ).astype(np.int32), "labels": lab}
    seq = rng.integers(-1, V, (n, cfg.seq_len)).astype(np.int32)
    if cfg.kind == "sasrec":
        return {"seq": seq, "pos": rng.integers(0, V, n).astype(np.int32),
                "neg": rng.integers(0, V, (n, 20)).astype(np.int32)}
    return {"seq": seq, "target": rng.integers(0, V, n).astype(np.int32),
            "other": rng.integers(0, V, (n, cfg.n_sparse)).astype(np.int32),
            "labels": lab}


def _jax_forward(p, cfg, b):
    j = {k: jnp.asarray(v) for k, v in b.items()}
    if cfg.kind == "dlrm":
        return JR.dlrm_forward(p, cfg, j["dense"], j["sparse"], NULL_CTX)
    if cfg.kind == "wide_deep":
        return JR.wide_deep_forward(p, cfg, None, j["sparse"], NULL_CTX)
    if cfg.kind == "sasrec":
        return JR.sasrec_user_repr(p, cfg, j["seq"], NULL_CTX)
    return JR.bst_forward(p, cfg, j["seq"], j["target"], j["other"],
                          NULL_CTX)


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_recsys_config_fields_shapes_and_registry():
    jf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(jax_base.RecsysConfig)]
    pf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(port_base.RecsysConfig)]
    assert pf == jf
    assert ([(s.name, s.step, s.dims) for s in port_base.RECSYS_SHAPES]
            == [(s.name, s.step, s.dims) for s in jax_base.RECSYS_SHAPES])
    assert list_archs() == sorted(ARCHS + [
        "rankgraph2", "gemma-2b", "llama3.2-3b", "olmo-1b", "grok-1-314b",
        "kimi-k2-1t-a32b"])
    for a in ARCHS + ["rankgraph2"]:
        pj, pp = jax_get_arch(a), get_arch(a)
        assert (pp.family, pp.source) == (pj.family, pj.source)
        assert dataclasses.asdict(pp.config) == dataclasses.asdict(pj.config)
        assert [s.name for s in pp.shapes] == [s.name for s in pj.shapes]
    with pytest.raises(KeyError):          # the GNN family is not ported
        get_arch("equiformer-v2")


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

CASES = [("dlrm-rm2", 0), ("dlrm-rm2", 5), ("wide-deep", 0), ("sasrec", 0),
         ("bst", 0)]


@pytest.mark.parametrize("arch_id,bags", CASES)
def test_forward_f32_matches_jax(arch_id, bags):
    jcfg, cfg = _cfgs(arch_id)
    jp = _jax_init(jcfg, seed=len(arch_id) + bags)
    b = _batch(cfg, np.random.default_rng(bags + 1), B, bags)
    want = np.asarray(_jax_forward(jp, jcfg, b))
    got = S.recsys_serve_step(_port(jp, cfg.kind), cfg, _torch(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("arch_id,bags", CASES)
def test_forward_bf16_matches_jax(arch_id, bags):
    jcfg, cfg = _cfgs(arch_id, "bfloat16")
    jp = _jax_init(jcfg, seed=3)
    b = _batch(cfg, np.random.default_rng(bags + 2), B, bags)
    want = _f32(_jax_forward(jp, jcfg, b))
    got = S.recsys_serve_step(_port(jp, cfg.kind), cfg, _torch(b))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_FRAC * np.abs(want).max(), (err, np.abs(want).max())


def test_sasrec_scores_match_jax():
    jcfg, cfg = _cfgs("sasrec")
    jp = _jax_init(jcfg)
    b = _batch(cfg, np.random.default_rng(4), B)
    cand = np.arange(-5, 3 * VOCAB, 7).astype(np.int32)
    u = JR.sasrec_user_repr(jp, jcfg, jnp.asarray(b["seq"]))
    want = np.asarray(JR.sasrec_scores(jp, jcfg, u, jnp.asarray(cand)))
    p = _port(jp, "sasrec")
    got = R.sasrec_scores(p, cfg, R.sasrec_user_repr(
        p, cfg, torch.from_numpy(b["seq"])), torch.from_numpy(cand))
    np.testing.assert_allclose(got.detach().numpy(), want, **F32_TOL)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _jax_train_step(cfg, optimizer):
    def loss_fn(p, b):
        if cfg.kind == "sasrec":
            return JR.sasrec_loss(p, cfg, b["seq"], b["pos"], b["neg"])
        return JR.bce_loss(_jax_forward(p, cfg, b), b["labels"])

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        grads, _ = JO.clip_by_global_norm(grads, 1.0)
        upd, opt_state = optimizer.update(grads, opt_state, params)
        return loss, JO.apply_updates(params, upd), opt_state

    return step


@contextlib.contextmanager
def _one_torch_thread():
    """Run torch's CPU ops on one thread, then restore the count.  With
    two threads the steps' float sums depended on the machine's load:
    with more processes than cores, some runs left the two-thread
    trajectory (one gave sasrec's step 2 a relative gap of 1.6e-4), while
    one-thread runs under the same load agreed to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("arch_id,bags", [("dlrm-rm2", 4), ("sasrec", 0)])
def test_four_train_steps_match_jax(arch_id, bags):
    with _one_torch_thread():
        _four_train_steps_match_jax(arch_id, bags)


def _four_train_steps_match_jax(arch_id, bags):
    jcfg, cfg = _cfgs(arch_id)
    jp = _jax_init(jcfg, seed=11)
    p = _port(jp, cfg.kind)
    jopt, opt = JO.rankgraph2_optimizer(), O.rankgraph2_optimizer()
    jst, st = jopt.init(jp), opt.init(R.flatten_params(p))
    jstep = _jax_train_step(jcfg, jopt)
    rng = np.random.default_rng(12)
    for t in range(4):
        b = _batch(cfg, rng, 16, bags)
        jloss, jp, jst = jstep(jp, jst, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        loss, st = S.recsys_train_step(p, st, _torch(b), cfg, opt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   err_msg=f"step {t}")
    want = R.flatten_params(_port(jp, cfg.kind))
    got = R.flatten_params(p)
    assert sorted(got) == sorted(want)
    for k in want:
        d = np.abs(got[k].detach().numpy() - want[k].numpy())
        far = float((d > PARAM_FAR).mean())
        assert np.median(d) <= PARAM_MEDIAN and far <= PARAM_FAR_SHARE, \
            (k, np.median(d), far, d.max())


@pytest.mark.parametrize("arch_id,sparse,some", [
    ("dlrm-rm2", {"tables"}, {"bot.0.w", "top.3.b"}),
    ("wide-deep", {"tables"}, {"wide", "deep.3.w"}),
    ("sasrec", set(), {"items", "pos", "blocks.1.wq", "blocks.0.ff1.w"}),
    ("bst", set(), {"other", "blocks.0.wo", "mlp.0.b"})])
def test_optimizer_routes_tables_to_adagrad(arch_id, sparse, some):
    _, cfg = _cfgs(arch_id)
    flat = R.flatten_params(R.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    assert some <= set(flat)
    st = O.rankgraph2_optimizer().init(flat)
    assert set(st["true"]) == sparse
    assert set(st["false"].mu) == set(flat) - sparse


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def _jax_retrieval(p, cfg, b, cand):
    if cfg.kind == "bst":
        V = p["items"].shape[0]
        e = JR.take_rows(p["items"], b["seq"][0] % V, NULL_CTX)
        table = p["items"]
    else:
        tab = p["tables"]
        e = JR.take_rows(tab[0], b["sparse"][0] % tab.shape[1], NULL_CTX)
        table = tab[0]
    u = jnp.mean(e, axis=0, keepdims=True).astype(jnp.dtype(cfg.dtype))
    cvec = JR.take_rows(table, cand % table.shape[0], NULL_CTX)
    scores = (u @ cvec.astype(u.dtype).T)[0]
    return jax.lax.top_k(scores, 100)


@pytest.mark.parametrize("arch_id", ["dlrm-rm2", "bst"])
def test_retrieval_top100_bitwise_with_ties(arch_id):
    jcfg, cfg = _cfgs(arch_id, "bfloat16")
    jcfg = dataclasses.replace(jcfg, default_vocab=5000)
    cfg = dataclasses.replace(cfg, default_vocab=5000)
    jp = jax.tree.map(np.asarray, _jax_init(jcfg, seed=5))
    key = "items" if cfg.kind == "bst" else "tables"
    tab = jp[key] if cfg.kind == "bst" else jp[key][0]
    tab = np.array(tab)
    rng = np.random.default_rng(6)
    # planted ties: 40 rows copied onto others, so equal scores abound
    src = rng.integers(0, 5000, 40)
    for s_ in src:
        tab[rng.integers(0, 5000, 3)] = tab[s_]
    if cfg.kind == "bst":
        jp[key] = tab
    else:
        jp[key] = np.array(jp[key])
        jp[key][0] = tab
    b = _batch(cfg, rng, 1)
    # candidates: every row once, plus repeats (equal rows -> equal scores)
    cand = np.concatenate([np.arange(5000), rng.integers(-3, 9000, 3000)]
                          ).astype(np.int32)
    jv, ji = _jax_retrieval({k: jnp.asarray(v) if not isinstance(v, list)
                             else v for k, v in jp.items()}, jcfg,
                            {k: jnp.asarray(v) for k, v in b.items()},
                            jnp.asarray(cand))
    vals, idx = S.recsys_retrieval_step(_port(jp, cfg.kind), cfg, _torch(b),
                                        torch.from_numpy(cand))
    ji = np.asarray(ji)
    assert len(set(_f32(jv).tolist())) < 100      # ties among the top 100
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(vals.float().numpy(), _f32(jv))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_lowest_index_first_like_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, 5000).astype(np.float32) / 8   # many ties
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    jv, ji = jax.lax.top_k(x16, 100)
    v, i = S.top_k(torch.from_numpy(x).to(torch.bfloat16), 100)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.float().numpy(), _f32(jv))
    assert S.top_k(torch.arange(5.0), 100)[1].tolist() == [4, 3, 2, 1, 0]


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_dlrm_reduced_on_cpu(capsys):
    cfg = LT._reduced(get_arch("dlrm-rm2").config)
    assert cfg.default_vocab == 5000 and cfg.dtype == "float32"
    loss = LT.run_recsys(cfg, 3, device="cpu")
    assert np.isfinite(loss)
    assert "dlrm bce" in capsys.readouterr().out


def test_chip_smoke_compact_serve_check_equals_the_full_forward():
    """Phase 4 holds the card's bulk logits against a CPU forward on only
    the rows that a strided sample of the requests touches; that forward
    must equal the full one."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_t", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, cfg = _cfgs("dlrm-rm2")
    p = R.init_params(cfg, generator=torch.Generator().manual_seed(1),
                      device="cpu")
    g = torch.Generator().manual_seed(2)
    b = cs.recsys_batch(cfg, g, 64, "cpu", bags=6, labels=False)
    assert b["sparse"].shape == (64, cfg.n_sparse, 6)
    assert ((b["sparse"] >= 0).sum(-1) >= 1).all()
    sel = torch.arange(0, 64, 4)
    full = S.recsys_serve_step(p, cfg, b)[sel]
    cp, cb = cs.compact_dlrm(p, b, sel)
    assert cp["tables"].shape[1] < cfg.default_vocab
    np.testing.assert_array_equal(
        S.recsys_serve_step(cp, cfg, cb).numpy(), full.numpy())


def test_chip_smoke_embedding_bag_bound_counts_only_needed_bytes():
    """The card's bound for embedding_bag moves each input once: forward,
    ids, each distinct valid row and the bf16 output; backward, ids, the
    bf16 cotangent and the dense f32 d_table, with no atomic traffic."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_b", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ids = torch.tensor([[3, 3, -1], [5, -1, -1]], dtype=torch.int32)
    D, V, peaks = 4, 10, (1e30, 1e3)          # bytes always bound
    fwd, by = cs.eb_bound(ids, D, V, False, peaks)
    assert by == "bytes"
    assert fwd == (4 * 6 + 4 * 2 * D + 2 * 2 * D) / 1e3 * 1e3
    bwd, _ = cs.eb_bound(ids, D, V, True, peaks)
    assert bwd == (4 * 6 + 2 * 2 * D + 4 * V * D) / 1e3 * 1e3
