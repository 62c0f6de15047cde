"""The LM serve paths under a mesh (``forward``, ``prefill`` and
``decode_step`` with ``ctx=``), the port against the JAX package's under
the same mesh:

  * the JAX side runs in a child with 4 host devices and meshes with
    ``AxisType.Auto`` axes, under ``_rules_for``'s rules for the shape
    named: ``forward`` of S tokens, ``prefill`` of the same, the prefill's
    caches padded to T = S + 4 positions (which the ``kv_seq`` ranks
    divide) and a ``decode_step`` of the next token at ``cache_len`` S,
    from ``init_params(key(0))``;
  * the port runs the same in four gloo ranks on the CPU, each from
    ``lm_params_from_jax(ctx=)`` (its shards) on its data rank's rows
    (``rank_rows``), under ``lm_rules``;
  * a narrow olmo-1b cut (2 layers, d 64, scanned layers in JAX) and a
    narrow kimi-k2 cut (2 layers, d 64, 8 experts top-2), f32, S 16: the
    prefill shape's rules at meshes (2, 2) and (1, 4), B 4 (kimi's MoE
    blocks on ``_moe_shard_map``); the decode shape's at (2, 2) and
    (1, 4), B 4 (kimi's decode step on ``_moe_shard_map`` too, 4 tokens
    over 4 or 2 x 2 ranks); the 500k decode shape's (the batch whole) at
    (1, 4), B 1 (the prefill on ``_moe_shard_map``, the decode step on
    the scatter).

The port runs tensor parallelism over ``model`` under these rules: under
the prefill rules attention by heads (a rank's caches are its own KV
heads, ``init_kv_cache(ctx=)``), the MLP and the vocabulary; under the
decode rules heads whole, the caches' sequence over ``kv_seq`` (a rank
decodes on ``shard_caches`` of the prefill's caches, gathered over the
data ranks and padded, and holds its block of the positions after the
step), the MLP and the vocabulary split.  Held: every output (the
forward's logits, the prefill's last logits and caches, the decode
step's logits and caches) on every rank within 1e-5 of the largest
magnitude of JAX's rows for that rank (a rank's caches against its KV
heads of JAX's, its decode caches against its sequence block of JAX's;
seen: 1.1e-6); the ranks of a model group bitwise equal, but for caches
split by heads or by sequence.  In one process: the 500k decode shape's
rules at a data axis of 2 (the batch whole over two data ranks) make
``forward``, ``prefill`` and ``lm_loss`` raise (``decode_step`` runs
there: ``tests/test_torch_decode_seq.py``), and ``rank_rows`` raises for
a batch the data ranks do not divide.
"""
import dataclasses as dc
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models.lm import model as JLM
from repro_torch.configs.base import LMConfig, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch.steps import lm_rules
from repro_torch.models.lm import model as LM

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUTS = {
    "olmo-1b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                    head_dim=16, d_ff=128, vocab_size=128),
    "kimi-k2-1t-a32b": dict(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, head_dim=16, d_ff=48, moe_d_ff=48,
                            vocab_size=128, n_experts=8, n_experts_per_tok=2,
                            scan_layers=False),
}
# case -> (the shape whose rules it runs under, mesh, batch)
CASES = {"prefill-2x2": ("prefill_32k", (2, 2), 4),
         "prefill-1x4": ("prefill_32k", (1, 4), 4),
         "decode-2x2": ("decode_32k", (2, 2), 4),
         "decode-1x4": ("decode_32k", (1, 4), 4),
         "long-1x4": ("long_500k", (1, 4), 1)}
MESHES = sorted({m for _, m, _ in CASES.values()})
S, B = 16, 4
PAD = 4                  # decode caches of S + PAD positions
OUTS = ("forward", "last", "caches/k", "caches/v", "decode",
        "decode_caches/k", "decode_caches/v")
OF_MAX = 1e-5


def _run(args):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", *args], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout: float = 240.0):
    """Every process must exit 0 within ``timeout`` seconds."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, o[-2000:], e[-3000:])
    return [o for o, _ in outs]


JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses as dc
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.sharding import ShardingCtx
    from repro.launch import steps as JS
    from repro.models.lm import model as LM
    CUTS, CASES, S, PAD = %s
    AUTO = (jax.sharding.AxisType.Auto,) * 2
    toks = np.load(sys.argv[2])
    out = {}
    for arch_id, cut in CUTS.items():
        arch = get_arch(arch_id)
        cfg = dc.replace(arch.config, dtype="float32",
                         param_dtype="float32", **cut)
        params = LM.init_params(jax.random.key(0), cfg)[0]
        for name, (shape_name, mshape, b) in CASES.items():
            shape = next(s for s in arch.shapes if s.name == shape_name)
            mesh = jax.make_mesh(mshape, ("data", "model"), axis_types=AUTO)
            ctx = ShardingCtx(JS._rules_for(arch_id, shape, mesh), mesh)
            t = jnp.asarray(toks[arch_id][:b])
            logits, _ = jax.jit(lambda p, t: LM.forward(
                p, cfg, t, ctx=ctx))(params, t[:, :S])
            last, caches = jax.jit(lambda p, t: LM.prefill(
                p, cfg, t, ctx=ctx))(params, t[:, :S])
            padded = jax.tree.map(lambda c: jnp.pad(
                c, ((0, 0), (0, 0), (0, PAD), (0, 0), (0, 0))), caches)
            dec, dcaches = jax.jit(lambda p, t, c: LM.decode_step(
                p, cfg, t, c, S, ctx=ctx))(params, t[:, S:S + 1], padded)
            tag = f"{arch_id}/{name}"
            out[f"{tag}/forward"] = np.asarray(logits)
            out[f"{tag}/last"] = np.asarray(last)
            out[f"{tag}/decode"] = np.asarray(dec)
            for k in ("k", "v"):
                out[f"{tag}/caches/{k}"] = np.asarray(caches[k])
                out[f"{tag}/decode_caches/{k}"] = np.asarray(dcaches[k])
    np.savez(sys.argv[1], **out)
    print("JAX_SERVE_OK")
""")

RANK = textwrap.dedent("""
    import sys, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import lm_rules
    from repro_torch.models.lm import model as LM
    rank, world, tmp, mtag = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], sys.argv[4]
    mshape = tuple(int(v) for v in mtag.split("x"))
    init_distributed(rank, world, f"{tmp}/rdv-{mtag}", device="cpu")
    mesh = make_mesh(mshape, ("data", "model"))
    inp = torch.load(f"{tmp}/serve_inputs.pt", weights_only=False)
    S, T = inp["S"], inp["S"] + inp["PAD"]
    res = {}
    for arch_id, c in inp["archs"].items():
        cfg = c["cfg"]
        for name, (shape_name, cmesh, b) in inp["cases"].items():
            if tuple(cmesh) != mshape:
                continue
            shape = next(s for s in get_arch(arch_id).shapes
                         if s.name == shape_name)
            ctx = ShardingCtx(lm_rules(arch_id, shape, mesh), mesh)
            params = lm_params_from_jax(c["init"], ctx=ctx, cfg=cfg,
                                        device="cpu")
            toks = LM.rank_rows(c["tokens"][:b], ctx)
            rows = toks.shape[0]
            with torch.no_grad():
                logits = LM.forward(params, cfg, toks[:, :S], ctx=ctx)
                last, caches = LM.prefill(params, cfg, toks[:, :S], ctx=ctx)
                if ctx.axis_size("kv_seq") > 1:
                    # the whole batch's caches, padded, then this rank's
                    # rows and sequence block
                    whole = {}
                    for k, x in caches.items():
                        if LM.data_axes(ctx) and mshape[0] > 1:
                            parts = [torch.empty_like(x)
                                     for _ in range(mshape[0])]
                            dist.all_gather(parts, x.contiguous(),
                                            group=ctx.group("data"))
                            x = torch.cat(parts, dim=1)
                        whole[k] = torch.nn.functional.pad(
                            x, (0, 0, 0, 0, 0, T - S))
                    full = LM.shard_caches(whole, cfg, ctx)
                else:
                    full = LM.init_kv_cache(cfg, rows, T, device="cpu",
                                            ctx=ctx)
                    for k in full:
                        full[k][:, :, :S] = caches[k]
                dec, full = LM.decode_step(params, cfg, toks[:, S:S + 1],
                                           full, S, ctx=ctx)
            res[f"{arch_id}/{name}"] = {
                "rows": (ctx.axis_index("data"), rows),
                "seq": (ctx.axis_size("kv_seq"),
                        ctx.axis_index(ctx.mesh_axes("kv_seq"))
                        if ctx.mesh_axes("kv_seq") else 0),
                "kinds": (LM.moe_dispatch(cfg, rows * S, ctx),
                          LM.moe_dispatch(cfg, rows, ctx)),
                "forward": logits, "last": last, "decode": dec,
                "caches/k": caches["k"], "caches/v": caches["v"],
                "decode_caches/k": full["k"], "decode_caches/v": full["v"]}
    torch.save(res, f"{tmp}/serve-{mtag}-rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


def _cfgs(arch_id):
    j = dc.replace(jax_get_arch(arch_id).config, dtype="float32",
                   param_dtype="float32", **CUTS[arch_id])
    return j, LMConfig(**dc.asdict(j))


def _of_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX child and both meshes' ranks, all at once, from the same
    ``init_params(key(0))`` (drawn here too) and tokens."""
    tmp = tmp_path_factory.mktemp("lmserve")
    toks = {a: np.random.default_rng(2).integers(
        0, _cfgs(a)[0].vocab_size, (B, S + 1)).astype(np.int32)
        for a in CUTS}
    np.savez(tmp / "tokens.npz", **toks)
    torch.save(dict(S=S, PAD=PAD, cases=CASES, archs={a: dict(
        cfg=_cfgs(a)[1], tokens=torch.from_numpy(toks[a]).long(),
        init=jax.tree.map(np.asarray, JLM.init_params(
            jax.random.key(0), _cfgs(a)[0])[0])) for a in CUTS}),
        tmp / "serve_inputs.pt")
    tags = [f"{m[0]}x{m[1]}" for m in MESHES]
    outs = _wait([_run([JAX_CHILD % repr((CUTS, CASES, S, PAD)),
                        str(tmp / "jax.npz"), str(tmp / "tokens.npz")])]
                 + [_run([RANK, str(r), "4", str(tmp), tag])
                    for tag in tags for r in range(4)])
    assert "JAX_SERVE_OK" in outs[0]
    ranks = {m: [torch.load(tmp / f"serve-{tag}-rank{r}.pt",
                            weights_only=False) for r in range(4)]
             for m, tag in zip(MESHES, tags)}
    return dict(np.load(tmp / "jax.npz")), ranks


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_lm_serve_matches_jax_under_a_mesh(runs, arch_id, case):
    j, all_ranks = runs
    _, mshape, b = CASES[case]
    tag = f"{arch_id}/{case}"
    ranks = [r[tag] for r in all_ranks[mshape]]
    if arch_id == "kimi-k2-1t-a32b":
        # (prefill, decode): one decode token cannot split over 4 ranks
        want = ("shard_map", "scatter") if b == 1 \
            else ("shard_map", "shard_map")
        assert all(r["kinds"] == want for r in ranks), tag
    for r, got in enumerate(ranks):
        di, rows = got["rows"]
        assert rows * mshape[0] == b
        sl = slice(di * rows, (di + 1) * rows)
        peer = ranks[di * mshape[1]]
        mi = r % mshape[1]
        n_seq, blk = got["seq"]
        for n in OUTS:
            # the caches are (L, B, T, Hkv, hd): rows on dim 1, a rank's
            # own KV heads on dim 3 where the rules split them, and after
            # the decode step its block of the positions on dim 2 where
            # they split ``kv_seq``
            want = j[f"{tag}/{n}"][:, sl] if "caches" in n \
                else j[f"{tag}/{n}"][sl]
            split = "caches" in n and got[n].shape[3] < want.shape[3]
            if split:
                h = got[n].shape[3]
                want = want[:, :, :, mi * h:(mi + 1) * h]
            if n.startswith("decode_caches") and n_seq > 1:
                t = want.shape[2] // n_seq
                assert got[n].shape[2] == t, (tag, r, n)
                want = want[:, :, blk * t:(blk + 1) * t]
                split = True
            assert got[n].shape == want.shape, (tag, r, n)
            assert _of_max(got[n], want) <= OF_MAX, (tag, r, n)
            if not split:
                assert torch.equal(got[n], peer[n]), (tag, r, n)
        # the prefill rules split the KV heads over the model axis where
        # it divides them; the decode rules keep them whole
        heads, Hkv = got["caches/k"].shape[3], _cfgs(arch_id)[1].n_kv_heads
        assert (heads < Hkv) == (CASES[case][0] == "prefill_32k"
                                 and Hkv % mshape[1] == 0), (tag, heads)


def test_a_batch_kept_whole_over_data_ranks_raises():
    names = ("data", "model")
    mesh = SimpleNamespace(mesh_dim_names=names, shape=(2, 2))
    shapes = {s.name: s for s in get_arch("kimi-k2-1t-a32b").shapes}
    _, cfg = _cfgs("kimi-k2-1t-a32b")
    ctx = ShardingCtx(lm_rules("kimi-k2-1t-a32b", shapes["long_500k"],
                               names), mesh)
    assert ctx.rules["batch"] is None
    params = LM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    calls = {
        "forward": lambda: LM.forward(params, cfg, toks, ctx=ctx),
        "prefill": lambda: LM.prefill(params, cfg, toks, ctx=ctx),
        "lm_loss": lambda: LM.lm_loss(params, cfg, toks, ctx=ctx)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match="batch whole"):
            call()
    ctx = ShardingCtx(lm_rules("kimi-k2-1t-a32b", shapes["decode_32k"],
                               names), mesh)
    with pytest.raises(ValueError, match="cannot be split"):
        LM.rank_rows(torch.zeros((3, 4), dtype=torch.long), ctx)
