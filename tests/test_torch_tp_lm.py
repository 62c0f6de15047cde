"""Tensor parallelism of the LM family over the ``model`` axis, the port
against the JAX package under the same mesh:

  * ``param_layout`` equals ``repro/launch/steps.py::_param_shardings``'s
    specs (the reference's ``_safe`` of its logical specs) for every LM
    arch and shape at full width, on both production meshes' axis names
    and sizes ((16, 16) and (2, 16, 16));
  * the JAX side runs in a child with 4 host devices and meshes with
    ``AxisType.Auto`` axes; the port runs in four gloo ranks on the CPU a
    mesh, each from ``lm_params_from_jax(ctx=)`` (its shards), f32;
  * ``lm_loss`` and its gradients (``value_and_grad``; the port's
    ``lm_loss_and_grads``) under the train rules (FSDP, tensor and
    sequence parallelism) at meshes (1, 4) and (2, 2), B 4 x S 32, for a
    dense GQA cut of llama3.2-3b (8 heads over 4 KV heads: 2 over 1 a
    rank at model 4), an MQA cut of gemma-2b (8 heads over one KV head of
    dim 6, tied embeddings: the KV head whole among a rank's split
    products at model 4, split within the head at model 2), a grok-1-314b
    cut (4 experts over ``expert_mlp``: ``_moe_dense`` at B 4 x S 512 a
    mesh of 2 data ranks, B 2 x S 512 at 1, ``_moe_scatter`` at B 4 x S
    8) and a kimi-k2 cut (heads over ``model`` beside ``_moe_shard_map``);
  * ``prefill`` (last logits and caches) and ``decode_step`` (logits, on
    the prefill's caches padded to S + 4 positions; under the decode rules
    a rank's rows and sequence block of them, ``shard_caches``) under the
    prefill and decode rules at both meshes, B 4 x S 16, for the GQA and
    MQA cuts and grok's.

Held (the tolerances of ``tests/test_torch_lm_mesh_train.py`` and
``tests/test_torch_lm_mesh_serve.py``): every rank's loss within 1e-5
relative of the mean of JAX's per-device losses; each rank's block of
each gradient within 1e-5 relative, norm-wise, of its block of JAX's;
the logits and caches within 1e-5 of the largest magnitude of JAX's rows
for the rank (a rank's caches against its KV heads of JAX's), the ranks
of a model group bitwise equal in their logits.
"""
import dataclasses as dc
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch import steps as JS
from repro.models.lm import model as JLM
from repro_torch.configs.base import LMConfig, get_arch, list_archs
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch.steps import lm_rules
from repro_torch.models.lm import model as LM

from test_torch_lm_mesh import _block
from test_torch_lm_mesh_train import _flat, _nest, _norm_rel, _run, _wait

torch.set_num_threads(2)

CUTS = {
    "llama3.2-3b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
                        head_dim=8, d_ff=128, vocab_size=128),
    "gemma-2b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
                     head_dim=6, d_ff=128, vocab_size=128),
    "grok-1-314b": dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                        head_dim=8, d_ff=48, moe_d_ff=48, vocab_size=64,
                        n_experts=4, n_experts_per_tok=2,
                        scan_layers=False),
    "kimi-k2-1t-a32b": dict(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, head_dim=16, d_ff=48, moe_d_ff=48,
                            vocab_size=128, n_experts=8, n_experts_per_tok=2,
                            scan_layers=False),
}
MESHES = ((1, 4), (2, 2))
# loss cases: name -> (arch, B, S); grok's dense loop needs 1,024 tokens
# a data rank
LOSS = {"llama": ("llama3.2-3b", 4, 32), "gemma": ("gemma-2b", 4, 32),
        "grok-dense": ("grok-1-314b", 4, 512),
        "grok-scatter": ("grok-1-314b", 4, 8),
        "kimi": ("kimi-k2-1t-a32b", 4, 32)}
DENSE_B1 = 2            # grok-dense's batch at one data rank
SERVE_ARCHS = ("llama3.2-3b", "gemma-2b", "grok-1-314b")
SERVE_SHAPES = ("prefill_32k", "decode_32k")
B, S_SERVE = 4, 16
PAD = 4                  # decode caches of S + PAD positions
LOSS_REL, GRAD_REL, OF_MAX = 1e-5, 1e-5, 1e-5


def _cfgs(arch_id):
    j = dc.replace(jax_get_arch(arch_id).config, dtype="float32",
                   param_dtype="float32", **CUTS[arch_id])
    return j, LMConfig(**dc.asdict(j))


def _loss_batch(case, mshape):
    arch, b, s = LOSS[case]
    return (DENSE_B1 if case == "grok-dense" and mshape[0] == 1 else b), s


JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses as dc
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.sharding import ShardingCtx
    from repro.launch import steps as JS
    from repro.models.lm import model as LM
    CUTS, MESHES, LOSS, DENSE_B1, SERVE_ARCHS, SERVE_SHAPES, S, PAD = %s
    AUTO = (jax.sharding.AxisType.Auto,) * 2
    toks = np.load(sys.argv[2])
    out = {}

    def put(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(f"{prefix}/{k}", v)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                put(f"{prefix}/{i}", v)
        else:
            out[prefix] = np.asarray(tree)

    def cfg_of(arch_id):
        return dc.replace(get_arch(arch_id).config, dtype="float32",
                          param_dtype="float32", **CUTS[arch_id])
    params = {a: LM.init_params(jax.random.key(0), cfg_of(a))[0]
              for a in CUTS}
    for mshape in MESHES:
        mesh = jax.make_mesh(mshape, ("data", "model"), axis_types=AUTO)
        mtag = f"{mshape[0]}x{mshape[1]}"
        for case, (arch_id, b, s) in LOSS.items():
            cfg = cfg_of(arch_id)
            if case == "grok-dense" and mshape[0] == 1:
                b = DENSE_B1
            shape = [x for x in get_arch(arch_id).shapes
                     if x.step == "train"][0]
            ctx = ShardingCtx(JS._rules_for(arch_id, shape, mesh), mesh)
            t = jnp.asarray(toks[case][:b, :s])
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: LM.lm_loss(p, cfg, t, ctx=ctx)))(params[arch_id])
            out[f"{mtag}/{case}/loss"] = np.array(
                [float(np.asarray(x.data)) for x in loss.addressable_shards])
            put(f"{mtag}/{case}/grads", grads)
        for arch_id in SERVE_ARCHS:
            cfg = cfg_of(arch_id)
            for shape_name in SERVE_SHAPES:
                shape = next(x for x in get_arch(arch_id).shapes
                             if x.name == shape_name)
                ctx = ShardingCtx(JS._rules_for(arch_id, shape, mesh), mesh)
                t = jnp.asarray(toks["serve"])
                last, caches = jax.jit(lambda p, t: LM.prefill(
                    p, cfg, t, ctx=ctx))(params[arch_id], t[:, :S])
                padded = jax.tree.map(lambda c: jnp.pad(
                    c, ((0, 0), (0, 0), (0, PAD), (0, 0), (0, 0))), caches)
                dec, _ = jax.jit(lambda p, t, c: LM.decode_step(
                    p, cfg, t, c, S, ctx=ctx))(params[arch_id],
                                               t[:, S:S + 1], padded)
                tag = f"{mtag}/{arch_id}/{shape_name}"
                out[f"{tag}/last"] = np.asarray(last)
                out[f"{tag}/decode"] = np.asarray(dec)
                for k in ("k", "v"):
                    out[f"{tag}/caches/{k}"] = np.asarray(caches[k])
    np.savez(sys.argv[1], **out)
    print("JAX_TP_LM_OK")
""")

RANK = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import lm_loss_and_grads, lm_rules
    from repro_torch.models.lm import model as LM
    rank, world, tmp, mtag = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], sys.argv[4]
    mshape = tuple(int(v) for v in mtag.split("x"))
    init_distributed(rank, world, f"{tmp}/rdv-{mtag}", device="cpu")
    mesh = make_mesh(mshape, ("data", "model"))
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    res = {}
    for case, (arch_id, toks) in inp["loss"][mtag].items():
        cfg = inp["cfgs"][arch_id]
        shape = [s for s in get_arch(arch_id).shapes if s.step == "train"][0]
        ctx = ShardingCtx(lm_rules(arch_id, shape, mesh), mesh)
        params = lm_params_from_jax(inp["init"][arch_id], ctx=ctx, cfg=cfg,
                                    device="cpu")
        loss, grads = lm_loss_and_grads(params, cfg, toks, ctx)
        res[case] = dict(loss=float(loss), grads=grads,
                         layout=LM.named_params(LM.param_layout(cfg, ctx)),
                         kind=LM.moe_dispatch(cfg, LM.rank_rows(
                             toks, ctx).numel(), ctx) if cfg.n_experts
                         else None)
    S, T = inp["S"], inp["S"] + inp["PAD"]
    for arch_id in inp["serve_archs"]:
        cfg = inp["cfgs"][arch_id]
        for shape_name in inp["serve_shapes"]:
            shape = next(s for s in get_arch(arch_id).shapes
                         if s.name == shape_name)
            ctx = ShardingCtx(lm_rules(arch_id, shape, mesh), mesh)
            params = lm_params_from_jax(inp["init"][arch_id], ctx=ctx,
                                        cfg=cfg, device="cpu")
            toks = LM.rank_rows(inp["serve"], ctx)
            with torch.no_grad():
                last, caches = LM.prefill(params, cfg, toks[:, :S], ctx=ctx)
                if ctx.axis_size("kv_seq") > 1:
                    # the whole batch's caches, padded, then this rank's
                    # rows and sequence block
                    whole = {}
                    for k, x in caches.items():
                        if mshape[0] > 1:
                            parts = [torch.empty_like(x)
                                     for _ in range(mshape[0])]
                            dist.all_gather(parts, x.contiguous(),
                                            group=ctx.group("data"))
                            x = torch.cat(parts, dim=1)
                        whole[k] = torch.nn.functional.pad(
                            x, (0, 0, 0, 0, 0, T - S))
                    full = LM.shard_caches(whole, cfg, ctx)
                else:
                    full = LM.init_kv_cache(cfg, toks.shape[0], T,
                                            device="cpu", ctx=ctx)
                    for k in full:
                        full[k][:, :, :S] = caches[k]
                dec, _ = LM.decode_step(params, cfg, toks[:, S:S + 1], full,
                                        S, ctx=ctx)
            res[f"{arch_id}/{shape_name}"] = {
                "rows": (ctx.axis_index("data"), toks.shape[0]),
                "last": last, "decode": dec, "caches/k": caches["k"],
                "caches/v": caches["v"]}
    torch.save(res, f"{tmp}/tplm-{mtag}-rank{rank}.pt")
    torch.distributed.barrier()     # no rank tears down mid-exchange
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX child and both meshes' ranks, all at once, from the same
    ``init_params(key(0))`` (drawn here too) and tokens."""
    tmp = tmp_path_factory.mktemp("tplm")
    rng = np.random.default_rng(4)
    toks = {case: rng.integers(0, _cfgs(a)[0].vocab_size, (b, s)).astype(
        np.int32) for case, (a, b, s) in LOSS.items()}
    toks["serve"] = rng.integers(0, 64, (B, S_SERVE + 1)).astype(np.int32)
    np.savez(tmp / "tokens.npz", **toks)
    mtags = [f"{m[0]}x{m[1]}" for m in MESHES]
    loss = {f"{m[0]}x{m[1]}": {
        case: (a, torch.from_numpy(
            toks[case][:_loss_batch(case, m)[0]]).long())
        for case, (a, _, _) in LOSS.items()} for m in MESHES}
    torch.save(dict(
        cfgs={a: _cfgs(a)[1] for a in CUTS}, loss=loss, S=S_SERVE, PAD=PAD,
        serve=torch.from_numpy(toks["serve"]).long(),
        serve_archs=SERVE_ARCHS, serve_shapes=SERVE_SHAPES,
        init={a: jax.tree.map(np.asarray, JLM.init_params(
            jax.random.key(0), _cfgs(a)[0])[0]) for a in CUTS}),
        tmp / "inputs.pt")
    consts = repr((CUTS, MESHES, LOSS, DENSE_B1, SERVE_ARCHS, SERVE_SHAPES,
                   S_SERVE, PAD))
    outs = _wait([_run([JAX_CHILD % consts, str(tmp / "jax.npz"),
                        str(tmp / "tokens.npz")])]
                 + [_run([RANK, str(r), "4", str(tmp), tag])
                    for tag in mtags for r in range(4)])
    assert "JAX_TP_LM_OK" in outs[0]
    ranks = {m: [torch.load(tmp / f"tplm-{tag}-rank{r}.pt",
                            weights_only=False) for r in range(4)]
             for m, tag in zip(MESHES, mtags)}
    return dict(np.load(tmp / "jax.npz")), ranks


def _of_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("case", list(LOSS))
def test_tp_lm_loss_and_grads_match_jax(runs, case, mshape):
    j, all_ranks = runs
    ranks = [r[case] for r in all_ranks[mshape]]
    mtag = f"{mshape[0]}x{mshape[1]}"
    sizes = dict(zip(("data", "model"), mshape))
    lay = ranks[0]["layout"]
    # tensor parallelism is on: the head, the attention's query heads and
    # the MLP (or the experts' ff, unless kimi's experts take the axis)
    # split over the model axis
    on = {k for k, s in lay.items() if "model" in s}
    arch = LOSS[case][0]
    assert "layers.0.wq" in on and ("embed" in on or "lm_head" in on), on
    if arch != "kimi-k2-1t-a32b":
        assert "layers.0.w_down" in on, on
    if case.startswith("grok"):
        assert all(r["kind"] == case.split("-")[1] for r in ranks), case
    want_loss = float(np.mean(j[f"{mtag}/{case}/loss"]))
    want = _flat(_nest(j, f"{mtag}/{case}/grads"))
    assert set(want) == set(lay)
    for r, got in enumerate(ranks):
        assert abs(got["loss"] - want_loss) <= LOSS_REL * abs(want_loss), \
            (case, r, got["loss"], want_loss)
        coords = {"data": r // mshape[1], "model": r % mshape[1]}
        for name, spec in lay.items():
            w = _block(want[name], spec, coords, sizes)
            assert got["grads"][name].shape == w.shape, (case, name)
            rel = _norm_rel(got["grads"][name].numpy(), w)
            assert rel <= GRAD_REL, (case, r, name, rel)


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("shape_name", SERVE_SHAPES)
@pytest.mark.parametrize("arch_id", SERVE_ARCHS)
def test_tp_prefill_and_decode_match_jax(runs, arch_id, shape_name, mshape):
    j, all_ranks = runs
    tag = f"{mshape[0]}x{mshape[1]}/{arch_id}/{shape_name}"
    ranks = [r[f"{arch_id}/{shape_name}"] for r in all_ranks[mshape]]
    Hkv = _cfgs(arch_id)[1].n_kv_heads
    for r, got in enumerate(ranks):
        di, rows = got["rows"]
        mi = r % mshape[1]
        sl = slice(di * rows, (di + 1) * rows)
        peer = ranks[di * mshape[1]]
        for n in ("last", "decode"):
            want = j[f"{tag}/{n}"][sl]
            assert got[n].shape == want.shape, (tag, r, n)
            assert _of_max(got[n], want) <= OF_MAX, (tag, r, n)
            assert torch.equal(got[n], peer[n]), (tag, r, n)
        for n in ("caches/k", "caches/v"):
            want = j[f"{tag}/{n}"][:, sl]
            h = got[n].shape[3]
            # the prefill rules split the KV heads where the axis divides
            # them; the decode rules keep them whole
            assert (h < Hkv) == (shape_name == "prefill_32k"
                                 and Hkv % mshape[1] == 0), (tag, h)
            if h < Hkv:
                want = want[:, :, :, mi * h:(mi + 1) * h]
            assert got[n].shape == want.shape, (tag, r, n)
            assert _of_max(got[n], want) <= OF_MAX, (tag, r, n)


@pytest.mark.parametrize("names,shape", [(("data", "model"), (16, 16)),
                                         (("pod", "data", "model"),
                                          (2, 16, 16))])
def test_param_layout_matches_the_reference(monkeypatch, names, shape):
    """``param_layout`` against ``_param_shardings`` (``_safe`` of the
    reference's specs under ``_rules_for``) for every LM arch and shape at
    full width, its layers unscanned, the mesh a stand-in with the
    production sizes (``_safe`` reads only its axis names and shape)."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(JS, "_named", lambda mesh, spec: spec)
    jmesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    pmesh = SimpleNamespace(mesh_dim_names=names, shape=shape)
    archs = [a for a in list_archs() if get_arch(a).family == "lm"]
    assert len(archs) == 5
    seen = set()
    for a in archs:
        jcfg = dc.replace(jax_get_arch(a).config, scan_layers=False)
        cfg = LMConfig(**dc.asdict(jcfg))
        shapes = jax.eval_shape(
            lambda: JLM.init_params(jax.random.key(0), jcfg)[0])
        specs = JS._lm_specs(jcfg)
        for pshape, jshape in zip(get_arch(a).shapes,
                                  jax_get_arch(a).shapes):
            rules = JS._rules_for(a, jshape, jmesh)
            ref = LM.named_params(JLM_tree(JS._param_shardings(
                specs, rules, jmesh, shapes)))
            got = LM.named_params(LM.param_layout(cfg, ShardingCtx(
                lm_rules(a, pshape, names), pmesh)))
            assert set(got) == set(ref), (a, pshape.name)
            for k, spec in got.items():
                want = tuple(ref[k]) + (None,) * (len(spec) - len(ref[k]))
                assert spec == want, (a, pshape.name, k, spec, want)
                seen.update(s for s in spec if s is not None)
    assert {"data", "model"} <= {s for s in seen if isinstance(s, str)}


def JLM_tree(tree):
    """The reference's per-layer list of spec dicts as ``named_params``
    reads a tree (a list of dicts under ``layers``)."""
    return {k: (list(v) if k == "layers" else v) for k, v in tree.items()}
