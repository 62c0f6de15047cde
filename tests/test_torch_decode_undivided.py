"""A decode cache that the ``kv_seq`` ranks do not divide, the port
against the JAX package under the same mesh:

  * the JAX side runs in a child with 4 host devices and meshes with
    ``AxisType.Auto`` axes: ``decode_step`` under ``_rules_for``'s rules
    for ``decode_32k`` (``kv_seq -> model``) and ``long_500k`` (``kv_seq
    -> ("data", "model")``, the batch whole) at meshes (1, 4) and (2, 2),
    B 4 and B 1, on caches of T = S + 1 = 17 positions (a prompt of S 16
    and its next token), drawn from noise with numpy, from
    ``init_params(key(0))``, f32.  No ``kv_seq`` size of 2 or 4 divides
    17, so ``_safe`` keeps the caches whole;
  * the port runs the same in four gloo ranks on the CPU, each from
    ``lm_params_from_jax(ctx=)`` (its shards), its rows of the tokens and
    ``shard_caches`` of the same caches, and once more on
    ``init_kv_cache(ctx=)`` through ``lm_decode_step``;
  * a GQA cut of llama3.2-3b and an MQA cut of gemma-2b, each at two
    ``cache_len``: T - 1 (the last position) and 5.

Held: every rank holds the whole cache (its rows, all T positions) and
``cache_length`` reads T from it; every rank's logits within 1e-5 of the
largest magnitude of JAX's rows for the rank, the ranks of a model group
bitwise equal; each rank's caches after the step its rows of JAX's: the
new key and value within 1e-5 of the largest, every other position
bitwise; no rank folds (``decode_attention_lse`` is not called).  Caches
of a plain dict under a ``kv_seq`` split raise.
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
}
# case -> (the shape whose rules it runs under, mesh, batch)
CASES = {"decode-1x4": ("decode_32k", (1, 4), 4),
         "decode-2x2": ("decode_32k", (2, 2), 4),
         "long-1x4": ("long_500k", (1, 4), 1),
         "long-2x2": ("long_500k", (2, 2), 1)}
MESHES = sorted({m for _, m, _ in CASES.values()})
S = 16
T = S + 1
LENS = {"last": T - 1, "early": 5}
OF_MAX = 1e-5


def _cfgs(arch_id):
    j = dc.replace(jax_get_arch(arch_id).config, dtype="float32",
                   param_dtype="float32", **CUTS[arch_id])
    return j, LMConfig(**dc.asdict(j))


def _caches(arch_id, b):
    cfg = _cfgs(arch_id)[1]
    rng = np.random.default_rng(17)
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
    print("JAX_DECODE_UNDIVIDED_OK")
""")

RANK = textwrap.dedent("""
    import sys, pickle, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import lm_decode_step, lm_rules
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
            for lname, n in inp["lens"].items():
                caches = LM.shard_caches(whole, cfg, ctx)
                held = (tuple(caches["k"].shape),
                        LM.cache_length(caches, ctx))
                calls.clear()
                dec, caches = LM.decode_step(params, cfg, toks, caches, n,
                                             ctx=ctx)
                res[f"{arch_id}/{name}/{lname}"] = dict(
                    logits=dec, k=caches["k"], v=caches["v"],
                    calls=list(calls), held=held,
                    rows=(LM.rank_rows(torch.arange(b), ctx).tolist()))
            # zeroed whole caches from init_kv_cache, through the step a
            # server calls (its cache_len read from the caches)
            fresh = LM.init_kv_cache(cfg, toks.shape[0], inp["T"],
                                     device="cpu", ctx=ctx)
            dec, _ = lm_decode_step(params, cfg, fresh, toks, ctx=ctx)
            res[f"{arch_id}/{name}/init"] = dict(
                shape=tuple(fresh["k"].shape), logits=dec,
                length=LM.cache_length(fresh, ctx))
            try:
                LM.decode_step(params, cfg, toks, dict(whole), 3, ctx=ctx)
                res[f"{arch_id}/{name}/plain"] = "ran"
            except ValueError as e:
                res[f"{arch_id}/{name}/plain"] = str(e)
    torch.save(res, f"{tmp}/undiv-{mtag}-rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX child and both meshes' ranks, all at once, from the same
    ``init_params(key(0))`` (drawn here too), tokens and caches."""
    import pickle
    tmp = tmp_path_factory.mktemp("decode_undivided")
    rng = np.random.default_rng(5)
    toks = {a: rng.integers(0, _cfgs(a)[0].vocab_size, (4, 1)).astype(
        np.int32) for a in CUTS}
    caches = {(a, b): _caches(a, b) for a in CUTS
              for b in {c[2] for c in CASES.values()}}
    inp = dict(cuts=CUTS, cases=CASES, lens=LENS, tokens=toks,
               caches=caches, T=T, cfgs={a: _cfgs(a)[1] for a in CUTS},
               init={a: jax.tree.map(np.asarray, JLM.init_params(
                   jax.random.key(0), _cfgs(a)[0])[0]) for a in CUTS})
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    tags = [f"{m[0]}x{m[1]}" for m in MESHES]
    outs = _wait([_run([JAX_CHILD, str(tmp / "inputs.pkl"),
                        str(tmp / "jax.npz")])]
                 + [_run([RANK, str(r), "4", str(tmp), tag])
                    for tag in tags for r in range(4)])
    assert "JAX_DECODE_UNDIVIDED_OK" in outs[0]
    ranks = {m: [torch.load(tmp / f"undiv-{tag}-rank{r}.pt",
                            weights_only=False) for r in range(4)]
             for m, tag in zip(MESHES, tags)}
    return dict(np.load(tmp / "jax.npz")), ranks


def _of_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("lname", list(LENS))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_undivided_decode_matches_jax(runs, arch_id, case, lname):
    j, all_ranks = runs
    shape_name, mshape, b = CASES[case]
    tag = f"{arch_id}/{case}/{lname}"
    ranks = [r[tag] for r in all_ranks[mshape]]
    cfg = _cfgs(arch_id)[1]
    cache_len = LENS[lname]
    for r, got in enumerate(ranks):
        di, _ = divmod(r, mshape[1])
        rows = got["rows"]
        assert len(rows) == (b if shape_name == "long_500k"
                             else b // mshape[0]), (tag, rows)
        # the whole cache on every rank: its rows, all T positions
        assert got["held"] == ((cfg.n_layers, len(rows), T, cfg.n_kv_heads,
                                cfg.resolved_head_dim), T), (tag, r)
        want = j[f"{tag}/logits"][rows]
        assert got["logits"].shape == want.shape, (tag, r)
        assert _of_max(got["logits"], want) <= OF_MAX, (tag, r)
        peer = ranks[di * mshape[1]]
        assert torch.equal(got["logits"], peer["logits"]), (tag, r)
        for k in ("k", "v"):
            w = j[f"{tag}/{k}"][:, rows]
            assert got[k].shape == w.shape, (tag, r, k)
            assert _of_max(got[k], w) <= OF_MAX, (tag, r, k)
            keep = [p for p in range(T) if p != cache_len]
            np.testing.assert_array_equal(got[k].numpy()[:, :, keep],
                                          w[:, :, keep],
                                          err_msg=f"{tag} {r} {k}")
        # no rank folds: attention over the whole cache, no partials
        assert got["calls"] == [], (tag, r, got["calls"])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_init_kv_cache_keeps_an_undivided_cache_whole(runs, arch_id, case):
    """``init_kv_cache(ctx=)`` of T positions holds all T on every rank
    and keeps T, so ``lm_decode_step`` decodes at T - 1 with finite
    logits, the same on the ranks of a model group; plain caches under
    the split raise, naming the constructors."""
    _, all_ranks = runs
    shape_name, mshape, b = CASES[case]
    cfg = _cfgs(arch_id)[1]
    for r, res in enumerate(all_ranks[mshape]):
        got = res[f"{arch_id}/{case}/init"]
        rows = b if shape_name == "long_500k" else b // mshape[0]
        assert got["shape"] == (cfg.n_layers, rows, T, cfg.n_kv_heads,
                                cfg.resolved_head_dim), (case, r)
        assert got["length"] == T
        assert torch.isfinite(got["logits"]).all()
        peer = all_ranks[mshape][(r // mshape[1]) * mshape[1]]
        assert torch.equal(got["logits"],
                           peer[f"{arch_id}/{case}/init"]["logits"])
        assert "init_kv_cache" in res[f"{arch_id}/{case}/plain"], \
            res[f"{arch_id}/{case}/plain"]


def _abstract_ctx(arch_id, coords):
    """The decode_32k rules (``kv_seq -> model``) on a (1, 4) mesh with
    no process group, seen from the rank at ``coords``."""
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import lm_rules
    mesh = AbstractMesh((1, 4), ("data", "model"), coords)
    shape = get_arch(arch_id).shape("decode_32k")
    return ShardingCtx(lm_rules(arch_id, shape, mesh), mesh)


@pytest.mark.parametrize("arch_id", list(CUTS))
def test_whole_cache_under_a_dividing_split_raises(arch_id):
    """A whole cache of T = 16 positions (``init_kv_cache`` without
    ``ctx``) under a split over 4 ranks that divide 16 is not taken for
    a block: the step raises before it reads a process group."""
    from repro_torch.models.lm import model as LM
    cfg = _cfgs(arch_id)[1]
    ctx = _abstract_ctx(arch_id, (0, 2))
    params = LM.init_params(cfg, device="cpu")
    whole = LM.init_kv_cache(cfg, 1, 16, device="cpu")
    assert whole["k"].shape[2] == 16 and LM.cache_length(whole, ctx) == 16
    with pytest.raises(ValueError, match="hold 4 a rank here, not 16"):
        LM.decode_step(params, cfg, torch.zeros((1, 1), dtype=torch.long),
                       whole, 3, ctx=ctx)


@pytest.mark.parametrize("arch_id", list(CUTS))
def test_shard_caches_copies_a_contiguous_block(arch_id):
    """With one layer and one row, block 2 of 4 of the sequence is
    contiguous in the caller's storage at an offset; ``shard_caches``
    still returns a copy, so the in-place decode never writes into the
    caller's caches."""
    from repro_torch.models.lm import model as LM
    cfg = dc.replace(_cfgs(arch_id)[1], n_layers=1)
    ctx = _abstract_ctx(arch_id, (0, 2))
    whole = {k: torch.from_numpy(v[:1, :1, :16].copy())
             for k, v in _caches(arch_id, 1).items()}
    h = LM.cache_heads(cfg, ctx)
    mine = LM.shard_caches(whole, cfg, ctx)
    assert mine.positions == 16
    for k in "kv":
        want = whole[k][:, :, 8:12]
        want = want[:, :, :, 2 * h:3 * h] if h < cfg.n_kv_heads else want
        assert torch.equal(mine[k], want), k
        assert (mine[k].untyped_storage().data_ptr()
                != whole[k].untyped_storage().data_ptr()), k
        before = whole[k].clone()
        mine[k].fill_(7.0)
        assert torch.equal(whole[k], before), k
