"""The LM train step under a mesh (FSDP and data parallelism, expert
parallelism in the MoE layers), the port against the JAX package's
``_lm_cell`` step under the same mesh:

  * the JAX side runs in a child with 4 host devices and meshes with
    ``AxisType.Auto`` axes: the train_4k cell's step written out
    (``value_and_grad`` of ``lm_loss(..., ctx=ctx)``,
    ``clip_by_global_norm(1.0)``, ``make_optimizer(cfg.optimizer)``,
    ``apply_updates``) under ``_rules_for``'s rules (``embed -> data``,
    ``seq -> model``), two steps from ``init_params(key(0))``;
  * the port runs the same two steps in four gloo ranks on the CPU, each
    from ``lm_params_from_jax(ctx=)`` (its shards), with
    ``lm_train_step(ctx=)`` on the whole batch (each rank takes its data
    rank's rows) and ``make_optimizer(cfg.optimizer,
    shards=shard_groups(cfg, ctx))``;
  * at meshes (4, 1) and (2, 2), on a narrow olmo-1b cut (2 layers, d 64,
    AdamW, scanned layers in JAX) and a narrow kimi-k2 cut (2 layers, d
    64, 8 experts top-2, Adafactor, ``scan_layers=False``: its factors
    span one layer's leaf, as the port's do), B 4 x S 32, f32.

Held: every rank's loss and gradient norm within 1e-5 relative of JAX's
(JAX's loss array holds on each device its own data rank's aux, the MoE
slices routing their own tokens: the port's is the mean over the data
ranks, the value both gradients are of); each parameter's gradient,
reassembled from the ranks' shards, within 1e-5 relative norm-wise;
the ranks of a model group with bitwise equal shards and gradients; the
parameters after the two steps, reassembled, by the distribution of
their gaps (``tests/test_torch_dp_train.py``'s rule: median within
1e-6, at most 1% of entries more than 1e-4 apart).  Seen: losses and
norms within 3.2e-7, gradients within 2.7e-6, parameters' medians
within 1.5e-8 and none beyond 1e-4.  Also: ``lm_train_step`` refuses an
Adafactor made for another layout (without the step's shards under the
mesh, or with them and no mesh) before it touches a parameter.
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
MESHES = ((4, 1), (2, 2))
B, S, STEPS = 4, 32, 2
LOSS_REL, GRAD_REL = 1e-5, 1e-5
GAP_MEDIAN, GAP_FAR, GAP_FAR_SHARE = 1e-6, 1e-4, 0.01


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
    from repro.optim import optimizers as opt_lib
    CUTS, MESHES, B, S, STEPS = %s
    AUTO = (jax.sharding.AxisType.Auto,) * 2
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

    for arch_id, cut in CUTS.items():
        arch = get_arch(arch_id)
        cfg = dc.replace(arch.config, dtype="float32",
                         param_dtype="float32", **cut)
        shape = [s for s in arch.shapes if s.step == "train"][0]
        params = LM.init_params(jax.random.key(0), cfg)[0]
        toks = np.load(sys.argv[2])[arch_id]
        for mshape in MESHES:
            mesh = jax.make_mesh(mshape, ("data", "model"), axis_types=AUTO)
            ctx = ShardingCtx(JS._rules_for(arch_id, shape, mesh), mesh)
            optimizer = opt_lib.make_optimizer(cfg.optimizer)

            def step(params, opt_state, tokens):
                loss, grads = jax.value_and_grad(
                    lambda p: LM.lm_loss(p, cfg, tokens, ctx=ctx))(params)
                clipped, gnorm = opt_lib.clip_by_global_norm(grads, 1.0)
                upd, opt_state = optimizer.update(clipped, opt_state, params)
                params = opt_lib.apply_updates(params, upd)
                return loss, gnorm, grads, params, opt_state
            step = jax.jit(step)
            p, st = params, optimizer.init(params)
            tag = f"{arch_id}/{mshape[0]}x{mshape[1]}"
            for t in range(STEPS):
                loss, gnorm, grads, p, st = step(p, st, jnp.asarray(toks))
                # each device's loss: each adds its own data rank's aux
                out[f"{tag}/loss{t}"] = np.array(
                    [float(np.asarray(s.data))
                     for s in loss.addressable_shards])
                out[f"{tag}/gnorm{t}"] = np.asarray(gnorm)
                put(f"{tag}/grads{t}", grads)
            put(f"{tag}/params", p)
    np.savez(sys.argv[1], **out)
    print("JAX_TRAIN_OK")
""")

RANK = textwrap.dedent("""
    import sys, dataclasses as dc, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import (lm_loss_and_grads, lm_rules,
                                          lm_train_step)
    from repro_torch.models.lm import model as LM
    from repro_torch.optim import optimizers as O
    rank, world, tmp, mshape = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], tuple(int(v) for v in sys.argv[4].split("x"))
    init_distributed(rank, world, f"{tmp}/rdv-{sys.argv[4]}", device="cpu")
    mesh = make_mesh(mshape, ("data", "model"))
    inp = torch.load(f"{tmp}/train_inputs.pt", weights_only=False)
    res = {}
    for arch_id, c in inp.items():
        arch = get_arch(arch_id)
        cfg = c["cfg"]
        shape = [s for s in arch.shapes if s.step == "train"][0]
        ctx = ShardingCtx(lm_rules(arch_id, shape, mesh), mesh)
        params = lm_params_from_jax(c["init"], ctx=ctx, cfg=cfg,
                                    device="cpu")
        opt = O.make_optimizer(cfg.optimizer,
                               shards=LM.shard_groups(cfg, ctx))
        st = opt.init(LM.named_params(params))
        # an Adafactor made for another layout: refused before the step
        refused = []
        for o, cx in ((O.make_optimizer(cfg.optimizer), ctx), (opt, None)):
            try:
                if cfg.optimizer == "adafactor":
                    lm_train_step(params, cfg, o, st, c["tokens"], cx)
                else:
                    O.check_shards(o, None if cx is None
                                   else LM.shard_groups(cfg, cx))
                refused.append(False)
            except ValueError as e:
                refused.append("another layout" in str(e))
        steps = []
        for t in range(c["steps"]):
            _, grads = lm_loss_and_grads(params, cfg, c["tokens"], ctx)
            grads = {k: g.detach().clone() for k, g in grads.items()}
            loss, gnorm, st = lm_train_step(params, cfg, opt, st,
                                            c["tokens"], ctx)
            steps.append((float(loss), float(gnorm), grads))
        res[arch_id] = dict(steps=steps, refused=refused, params={
            k: v.detach().clone()
            for k, v in LM.named_params(params).items()})
    torch.save(res, f"{tmp}/train-{sys.argv[4]}-rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


def _cfgs(arch_id):
    j = dc.replace(jax_get_arch(arch_id).config, dtype="float32",
                   param_dtype="float32", **CUTS[arch_id])
    return j, LMConfig(**dc.asdict(j))


def _nest(flat, prefix):
    """``prefix/...`` keys -> the tree they flatten (digit keys: lists)."""
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/"):
            node, parts = out, k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v

    def lists(t):
        if isinstance(t, dict):
            t = {k: lists(v) for k, v in t.items()}
            if t and all(k.isdigit() for k in t):
                return [t[str(i)] for i in range(len(t))]
        return t
    return lists(out)


def _flat(tree):
    """A JAX tree (numpy leaves) -> ``named_params``' flat numpy dict."""
    return {k: v.numpy() for k, v in LM.named_params(
        lm_params_from_jax(tree, device="cpu")).items()}


def _layout(arch_id, cfg, mshape):
    """``named_params``' names -> each leaf's spec at mesh ``mshape``."""
    names = ("data", "model")
    train = [s for s in get_arch(arch_id).shapes if s.step == "train"][0]
    ctx = ShardingCtx(lm_rules(arch_id, train, names),
                      SimpleNamespace(mesh_dim_names=names, shape=mshape))
    return LM.named_params(LM.param_layout(cfg, ctx))


def _assemble(parts, spec, mshape):
    """Each rank's shard (rank order, row-major over (data, model)) ->
    the whole leaf; the ranks that hold the same block must agree
    bitwise."""
    sizes = dict(zip(("data", "model"), mshape))
    blocks = {}
    for r, x in enumerate(parts):
        coords = {"data": r // mshape[1], "model": r % mshape[1]}
        key = tuple(coords[a] if a is not None else 0 for a in spec)
        if key in blocks:
            assert torch.equal(blocks[key], x), (key, r)
        blocks[key] = x

    def build(dim, prefix):
        if dim == len(spec):
            return blocks[prefix]
        n = sizes[spec[dim]] if spec[dim] is not None else 1
        return torch.cat([build(dim + 1, prefix + (i,)) for i in range(n)],
                         dim=dim)
    return build(0, ()).numpy()


def _norm_rel(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(np.asarray(b).ravel()), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX child and both meshes' ranks, all at once, from the same
    ``init_params(key(0))`` (drawn here too) and tokens."""
    tmp = tmp_path_factory.mktemp("lmtrain")
    toks = {a: np.random.default_rng(1).integers(
        0, _cfgs(a)[0].vocab_size, (B, S)).astype(np.int32) for a in CUTS}
    np.savez(tmp / "tokens.npz", **toks)
    torch.save({a: dict(cfg=_cfgs(a)[1], init=jax.tree.map(
        np.asarray, JLM.init_params(jax.random.key(0), _cfgs(a)[0])[0]),
        tokens=torch.from_numpy(toks[a]).long(), steps=STEPS)
        for a in CUTS}, tmp / "train_inputs.pt")
    tags = [f"{m[0]}x{m[1]}" for m in MESHES]
    outs = _wait([_run([JAX_CHILD % repr((CUTS, MESHES, B, S, STEPS)),
                        str(tmp / "jax.npz"), str(tmp / "tokens.npz")])]
                 + [_run([RANK, str(r), "4", str(tmp), tag])
                    for tag in tags for r in range(4)])
    assert "JAX_TRAIN_OK" in outs[0]
    ranks = {m: [torch.load(tmp / f"train-{tag}-rank{r}.pt",
                            weights_only=False) for r in range(4)]
             for m, tag in zip(MESHES, tags)}
    return dict(np.load(tmp / "jax.npz")), ranks


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("arch_id", list(CUTS))
def test_lm_train_step_matches_jax_under_a_mesh(runs, arch_id, mshape):
    j, all_ranks = runs
    ranks = [r[arch_id] for r in all_ranks[mshape]]
    _, cfg = _cfgs(arch_id)
    tag = f"{arch_id}/{mshape[0]}x{mshape[1]}"
    lay = _layout(arch_id, cfg, mshape)
    assert any(s is not None for spec in lay.values() for s in spec)
    for t in range(STEPS):
        want_loss = float(np.mean(j[f"{tag}/loss{t}"]))
        want_norm = float(j[f"{tag}/gnorm{t}"])
        for r in ranks:
            loss, gnorm, _ = r["steps"][t]
            assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss), \
                (t, loss, want_loss)
            assert abs(gnorm - want_norm) <= LOSS_REL * want_norm, \
                (t, gnorm, want_norm)
        want = _flat(_nest(j, f"{tag}/grads{t}"))
        assert set(want) == set(lay)
        for name, spec in lay.items():
            got = _assemble([r["steps"][t][2][name] for r in ranks], spec,
                            mshape)
            assert _norm_rel(got, want[name]) <= GRAD_REL, (t, name)
    want = _flat(_nest(j, f"{tag}/params"))
    for name, spec in lay.items():
        got = _assemble([r["params"][name] for r in ranks], spec, mshape)
        d = np.abs(got - want[name]).ravel()
        far = float(np.mean(d > GAP_FAR))
        assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE, \
            (name, np.median(d), far, d.max())


@pytest.mark.parametrize("mshape", MESHES)
def test_lm_train_step_refuses_an_optimizer_of_another_layout(runs, mshape):
    """Adafactor made without the step's shards under a mesh, or with
    them and no mesh, raises before the step; AdamW suits any layout."""
    _, all_ranks = runs
    for arch_id in CUTS:
        want = [_cfgs(arch_id)[1].optimizer == "adafactor"] * 2
        for r in all_ranks[mshape]:
            assert r[arch_id]["refused"] == want, (arch_id, r)
