"""The decode rules' sequence-sharded KV cache (``kv_seq``), the port
against the JAX package under the same mesh:

  * the JAX side runs in a child with 4 host devices and meshes with
    ``AxisType.Auto`` axes, ``decode_step`` under ``_rules_for``'s rules
    for ``decode_32k`` (``kv_seq -> model``, the batch over ``data``) and
    ``long_500k`` (``kv_seq -> ("data", "model")``, the batch whole) at
    meshes (1, 4) and (2, 2), B 4 and B 1, on caches of T 16 positions
    drawn from noise with numpy, from ``init_params(key(0))``, f32;
  * the port runs the same in four gloo ranks on the CPU, each from
    ``lm_params_from_jax(ctx=)`` (its shards), its rows of the tokens
    (``rank_rows``: the whole batch under the 500k rules) and
    ``shard_caches`` of the same caches (its rows and block ``j`` of the
    positions, ``j = di * nm + mi`` under ``("data", "model")``);
  * a GQA cut of llama3.2-3b, an MQA cut of gemma-2b and a kimi-k2 cut
    (its MoE under the batch-whole rules), each at three ``cache_len``:
    T - 1 (every rank holds keys), T / 4 (the new token the first of
    block 1 at n 4) and T / 4 + 1 (blocks 2 and 3 hold no key at n 4).

Held: every rank's logits within 1e-5 of the largest magnitude of JAX's
rows for the rank, the ranks of a model group bitwise equal; each rank's
caches after the step its rows and sequence block of JAX's: the new key
and value (which the rank whose block holds ``cache_len`` writes) within
1e-5 of the largest, every other position bitwise; a rank whose block
holds no key runs no attention (``decode_attention_lse`` is not called
there).  ``fold_seq``
of each rank's plain partials (``_seq_attention``) against
``chunked_attention_ref`` on the whole cache within 1e-5 of the largest;
three mutations fail those checks: a rank with no key folded with lse 0,
a fold of bf16-rounded outputs, and blocks ordered model-major.
"""
import dataclasses as dc
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models.lm import model as JLM
from repro_torch.configs.base import LMConfig

from test_torch_lm_mesh_train import _run, _wait

torch.set_num_threads(2)

CUTS = {
    "llama3.2-3b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
                        head_dim=8, d_ff=128, vocab_size=128),
    "gemma-2b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
                     head_dim=6, d_ff=128, vocab_size=128),
    "kimi-k2-1t-a32b": dict(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, head_dim=16, d_ff=48, moe_d_ff=48,
                            vocab_size=128, n_experts=8, n_experts_per_tok=2,
                            scan_layers=False),
}
# case -> (the shape whose rules it runs under, mesh, batch)
CASES = {"decode-1x4": ("decode_32k", (1, 4), 4),
         "decode-2x2": ("decode_32k", (2, 2), 4),
         "long-1x4": ("long_500k", (1, 4), 1),
         "long-2x2": ("long_500k", (2, 2), 1)}
MESHES = sorted({m for _, m, _ in CASES.values()})
T = 16
LENS = {"last": T - 1, "first-of-block-1": T // 4, "keyless": T // 4 + 1}
OF_MAX = 1e-5
FOLD_D, FOLD_HQ, FOLD_HKV = 16, 4, 2


def _cfgs(arch_id):
    j = dc.replace(jax_get_arch(arch_id).config, dtype="float32",
                   param_dtype="float32", **CUTS[arch_id])
    return j, LMConfig(**dc.asdict(j))


def _caches(arch_id, b):
    """The noise caches (L, B, T, Hkv, hd) of one arch and batch."""
    cfg = _cfgs(arch_id)[1]
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, b, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}


JAX_CHILD = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses as dc
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.sharding import ShardingCtx
    from repro.launch import steps as JS
    from repro.models.lm import model as LM
    inp = pickle.load(open(sys.argv[1], "rb"))
    AUTO = (jax.sharding.AxisType.Auto,) * 2
    out = {}
    for arch_id, cut in inp["cuts"].items():
        arch = get_arch(arch_id)
        cfg = dc.replace(arch.config, dtype="float32",
                         param_dtype="float32", **cut)
        params = LM.init_params(jax.random.key(0), cfg)[0]
        for name, (shape_name, mshape, b) in inp["cases"].items():
            shape = next(s for s in arch.shapes if s.name == shape_name)
            mesh = jax.make_mesh(mshape, ("data", "model"), axis_types=AUTO)
            ctx = ShardingCtx(JS._rules_for(arch_id, shape, mesh), mesh)
            step = jax.jit(lambda p, t, c, n: LM.decode_step(
                p, cfg, t, c, n, ctx=ctx))
            caches = {k: jnp.asarray(v)
                      for k, v in inp["caches"][(arch_id, b)].items()}
            t = jnp.asarray(inp["tokens"][arch_id][:b])
            for lname, n in inp["lens"].items():
                dec, new = step(params, t, caches, jnp.int32(n))
                tag = f"{arch_id}/{name}/{lname}"
                out[f"{tag}/logits"] = np.asarray(dec)
                for k in ("k", "v"):
                    out[f"{tag}/{k}"] = np.asarray(new[k])
    np.savez(sys.argv[2], **out)
    print("JAX_DECODE_SEQ_OK")
""")

RANK = textwrap.dedent("""
    import sys, pickle, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.flash_attention.ref import chunked_attention_ref
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import lm_rules
    from repro_torch.models.lm import model as LM
    rank, world, tmp, mtag = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], sys.argv[4]
    mshape = tuple(int(v) for v in mtag.split("x"))
    init_distributed(rank, world, f"{tmp}/rdv-{mtag}", device="cpu")
    mesh = make_mesh(mshape, ("data", "model"))
    inp = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
    calls = []
    real_attn = LM.decode_attention_lse

    def counted(*a, **kw):
        calls.append(kw["kv_len"])
        return real_attn(*a, **kw)
    LM.decode_attention_lse = counted
    res = {}
    torch.set_grad_enabled(False)
    for arch_id, cfg in inp["cfgs"].items():
        for name, (shape_name, cmesh, b) in inp["cases"].items():
            if tuple(cmesh) != mshape:
                continue
            shape = next(s for s in get_arch(arch_id).shapes
                         if s.name == shape_name)
            ctx = ShardingCtx(lm_rules(arch_id, shape, mesh), mesh)
            params = lm_params_from_jax(inp["init"][arch_id], ctx=ctx,
                                        cfg=cfg, device="cpu")
            toks = LM.rank_rows(torch.from_numpy(
                inp["tokens"][arch_id][:b]).long(), ctx)
            whole = {k: torch.from_numpy(v)
                     for k, v in inp["caches"][(arch_id, b)].items()}
            seq = LM._kv_seq(ctx)
            for lname, n in inp["lens"].items():
                caches = LM.shard_caches(whole, cfg, ctx)
                calls.clear()
                dec, caches = LM.decode_step(params, cfg, toks, caches, n,
                                             ctx=ctx)
                res[f"{arch_id}/{name}/{lname}"] = dict(
                    logits=dec, k=caches["k"], v=caches["v"],
                    calls=list(calls), seq=(seq.n, seq.j),
                    rows=(LM.rank_rows(torch.arange(b), ctx).tolist()),
                    kind=LM.moe_dispatch(cfg, toks.numel(), ctx)
                    if cfg.n_experts else None)
            if name == "long-2x2" and arch_id == "llama3.2-3b":
                # blocks ordered model-major: a rank holds another block
                nd, nm = mshape
                real_seq = LM._kv_seq
                LM._kv_seq = lambda c: LM._Seq(
                    seq.n, (seq.j % nm) * nd + seq.j // nm, seq.group)
                caches = LM.shard_caches(whole, cfg, ctx)
                dec, caches = LM.decode_step(params, cfg, toks, caches,
                                             inp["lens"]["keyless"], ctx=ctx)
                LM._kv_seq = real_seq
                res["model-major"] = dict(logits=dec, k=caches["k"],
                                          v=caches["v"])
    # fold_seq of the plain partials against the whole cache's attention,
    # and two mutations of the fold
    g = torch.Generator().manual_seed(11)
    D, Hq, Hkv, B = inp["fold"]
    q = torch.randn((B, 1, Hq, D), generator=g)
    k = torch.randn((B, inp["T"], Hkv, D), generator=g)
    v = torch.randn((B, inp["T"], Hkv, D), generator=g)
    real_fold = C.fold_seq
    mutants = {
        "plain": real_fold,
        "lse0": lambda o, l, gr: real_fold(
            o, torch.where(torch.isinf(l), torch.zeros_like(l), l), gr),
        "bf16": lambda o, l, gr: real_fold(
            o.to(torch.bfloat16).to(torch.float32), l, gr)}
    for shape_name in ("decode_32k", "long_500k"):
        shape = next(s for s in get_arch("llama3.2-3b").shapes
                     if s.name == shape_name)
        ctx = ShardingCtx(lm_rules("llama3.2-3b", shape, mesh), mesh)
        seq = LM._kv_seq(ctx)
        blk = slice(seq.j * inp["T"] // seq.n,
                    (seq.j + 1) * inp["T"] // seq.n)
        for lname, n in inp["lens"].items():
            want = chunked_attention_ref(q, k, v, causal=False, kv_len=n + 1,
                                         block_q=1, scale=D ** -0.5)
            for mname, fn in mutants.items():
                C.fold_seq = fn
                got = LM._seq_attention(q, k[:, blk], v[:, blk], n, seq,
                                        D ** -0.5)
                C.fold_seq = real_fold
                res[f"fold/{shape_name}/{lname}/{mname}"] = (got, want)
    torch.save(res, f"{tmp}/dseq-{mtag}-rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX child and both meshes' ranks, all at once, from the same
    ``init_params(key(0))`` (drawn here too), tokens and caches."""
    import pickle
    tmp = tmp_path_factory.mktemp("decode_seq")
    rng = np.random.default_rng(3)
    toks = {a: rng.integers(0, _cfgs(a)[0].vocab_size, (4, 1)).astype(
        np.int32) for a in CUTS}
    caches = {(a, b): _caches(a, b) for a in CUTS
              for b in {c[2] for c in CASES.values()}}
    inp = dict(cuts=CUTS, cases=CASES, lens=LENS, tokens=toks,
               caches=caches, T=T, fold=(FOLD_D, FOLD_HQ, FOLD_HKV, 2),
               cfgs={a: _cfgs(a)[1] for a in CUTS},
               init={a: jax.tree.map(np.asarray, JLM.init_params(
                   jax.random.key(0), _cfgs(a)[0])[0]) for a in CUTS})
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    tags = [f"{m[0]}x{m[1]}" for m in MESHES]
    outs = _wait([_run([JAX_CHILD, str(tmp / "inputs.pkl"),
                        str(tmp / "jax.npz")])]
                 + [_run([RANK, str(r), "4", str(tmp), tag])
                    for tag in tags for r in range(4)])
    assert "JAX_DECODE_SEQ_OK" in outs[0]
    ranks = {m: [torch.load(tmp / f"dseq-{tag}-rank{r}.pt",
                            weights_only=False) for r in range(4)]
             for m, tag in zip(MESHES, tags)}
    return dict(np.load(tmp / "jax.npz")), ranks


def _of_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _block(want, rows, n, j):
    """Rows ``rows`` and sequence block ``j`` of ``n`` of whole caches
    (L, B, T, Hkv, hd)."""
    t = want.shape[2] // n
    return want[:, rows][:, :, j * t:(j + 1) * t]


@pytest.mark.parametrize("lname", list(LENS))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_decode_seq_matches_jax(runs, arch_id, case, lname):
    j, all_ranks = runs
    shape_name, mshape, b = CASES[case]
    tag = f"{arch_id}/{case}/{lname}"
    ranks = [r[tag] for r in all_ranks[mshape]]
    n_seq = mshape[1] if shape_name == "decode_32k" else 4
    cache_len = LENS[lname]
    if arch_id == "kimi-k2-1t-a32b":
        want_kind = "scatter" if b == 1 else "shard_map"
        assert all(r["kind"] == want_kind for r in ranks), tag
    for r, got in enumerate(ranks):
        di, mi = divmod(r, mshape[1])
        n, blk = got["seq"]
        # the block index: data major under ("data", "model")
        assert n == n_seq, (tag, n)
        assert blk == (mi if shape_name == "decode_32k"
                       else di * mshape[1] + mi), (tag, r, blk)
        rows = got["rows"]
        # the 500k rules keep the batch whole on every data rank
        assert len(rows) == (b if shape_name == "long_500k"
                             else b // mshape[0]), (tag, rows)
        want = j[f"{tag}/logits"][rows]
        assert got["logits"].shape == want.shape, (tag, r)
        assert _of_max(got["logits"], want) <= OF_MAX, (tag, r)
        peer = ranks[di * mshape[1]]
        assert torch.equal(got["logits"], peer["logits"]), (tag, r)
        t = T // n
        for k in ("k", "v"):
            w = _block(j[f"{tag}/{k}"], rows, n, blk)
            assert got[k].shape == w.shape, (tag, r, k)
            assert _of_max(got[k], w) <= OF_MAX, (tag, r, k)
            # every position but the new one is the noise, unchanged
            keep = [p for p in range(t) if blk * t + p != cache_len]
            np.testing.assert_array_equal(got[k].numpy()[:, :, keep],
                                          w[:, :, keep],
                                          err_msg=f"{tag} {r} {k}")
        # a rank whose block holds no key launches no attention
        kv_len = min(max(cache_len + 1 - blk * t, 0), t)
        n_layers = _cfgs(arch_id)[1].n_layers
        assert got["calls"] == ([kv_len] * n_layers if kv_len else []), \
            (tag, r, got["calls"])


def test_some_ranks_hold_no_key():
    """The keyless length leaves blocks 2 and 3 of four without a key."""
    t = T // 4
    held = [min(max(LENS["keyless"] + 1 - j * t, 0), t) for j in range(4)]
    assert held[2] == held[3] == 0 and held[1] > 0


@pytest.mark.parametrize("lname", list(LENS))
@pytest.mark.parametrize("shape_name", ("decode_32k", "long_500k"))
@pytest.mark.parametrize("mshape", MESHES)
def test_fold_of_the_plain_partials(runs, mshape, shape_name, lname):
    _, all_ranks = runs
    for r, res in enumerate(all_ranks[mshape]):
        got, want = res[f"fold/{shape_name}/{lname}/plain"]
        assert got.dtype == torch.float32
        assert _of_max(got, want) <= OF_MAX, (mshape, shape_name, lname, r)
        assert torch.equal(got, all_ranks[mshape][0][
            f"fold/{shape_name}/{lname}/plain"][0])


@pytest.mark.parametrize("mutant", ("lse0", "bf16"))
def test_fold_mutations_fail(runs, mutant):
    """A keyless rank folded with lse 0, or bf16-rounded outputs folded,
    break the fold's check where it applies (lse 0: where some rank of
    the 500k rules' four holds no key)."""
    _, all_ranks = runs
    lnames = ["keyless"] if mutant == "lse0" else list(LENS)
    for mshape in MESHES:
        for lname in lnames:
            got, want = all_ranks[mshape][0][
                f"fold/long_500k/{lname}/{mutant}"]
            assert _of_max(got, want) > OF_MAX, (mutant, mshape, lname)


def test_model_major_blocks_fail(runs):
    """Blocks ordered model-major put other positions on the ranks (0, 1)
    and (1, 0) of mesh (2, 2) than JAX's ``P(("data", "model"))``."""
    j, all_ranks = runs
    tag = "llama3.2-3b/long-2x2/keyless"
    for r in (1, 2):
        got = all_ranks[(2, 2)][r]["model-major"]
        rows = all_ranks[(2, 2)][r][tag]["rows"]
        w = _block(j[f"{tag}/k"], rows, 4, r)
        assert got["k"].shape == w.shape
        assert not np.array_equal(got["k"].numpy(), w), r
