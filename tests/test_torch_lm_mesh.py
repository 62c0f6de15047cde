"""The LM family's MoE under a mesh, the port against the JAX package under
the same mesh, at a narrow MoE cut (d 32, 8 experts top-2, expert ff 48,
SwiGLU, f32), B 4 x S 32:

  * the JAX side runs in a child with 4 host devices (``_run_child``) and
    meshes with ``AxisType.Auto`` axes; the port runs in four gloo ranks
    on the CPU (``_run_ranks``: one process a rank, rendezvous through a
    file under ``tmp_path``), each with its data rank's rows and its
    shards (``shard_params``);
  * ``_moe_shard_map`` at mesh (2, 2) with ``embed -> data`` (FSDP) and at
    (1, 4), each at capacity factor 8 (nothing dropped) and 1.25 (slots
    dropped; the router scaled by 4 and a row shared by every token added
    to x, so that the slices' loads are skewed): the output, each
    device's aux and the gradients of x, the router and the experts'
    shards of ``sum(out * R) + aux`` (the rank weighs its aux by 1 / dp,
    the mean the reference's transpose takes) within 1e-5 of the largest
    magnitude (seen: 1.2e-6);
  * ``_moe_shard_map_plain`` (one process, the nm slices in turn) against
    the same JAX outputs and aux at both meshes, with no ranks;
  * ``_moe_block`` under grok's train rules at (2, 2): the dense loop at
    1,024 tokens a data rank and the scatter at 4 (the whole batch's
    router statistics, capacity and slot order through the data group),
    output, aux and gradients as above;
  * ``moe_dispatch`` picks the reference's branch (recorded by patching
    the three JAX functions under ``jax.eval_shape``): E divisible by nm
    and not, grok's rules at 1,024 and 1,023 tokens a data rank,
    decode-sized T, no mesh;
  * ``adafactor(shards=)`` on blocks split along each of the last two
    dims, along an expert dim and dim -2, and of a 1-D leaf: two steps'
    updates equal to the whole leaf's block within 1e-6 relative;
  * ``lm_rules`` equal to ``repro/launch/steps.py::_rules_for`` for every
    LM arch and shape on both production meshes' axis names;
  * ``param_specs`` equal to the specs ``init_params`` returns (with
    ``scan_layers=False``) and the layout's shapes to its parameters',
    for every LM arch at a narrow cut.
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
from repro.launch import steps as JS
from repro.models.lm import model as JLM
from repro_torch.configs.base import LMConfig, get_arch, list_archs
from repro_torch.distributed.sharding import ShardingCtx, make_rules
from repro_torch.launch.steps import lm_rules
from repro_torch.models.lm import model as LM

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(name="moe-cut", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
           head_dim=8, d_ff=48, moe_d_ff=48, vocab_size=64, n_experts=8,
           n_experts_per_tok=2, dtype="float32", param_dtype="float32",
           norm="rmsnorm", act="silu", router_aux_coef=0.01)
GROK_CUT = dict(CUT, name="grok-cut", n_experts=4, act="gelu")
B, S = 4, 32
MESHES = {"2x2": ((2, 2), {"embed": "data"}), "1x4": ((1, 4), {})}
CFS = (8.0, 1.25)
ROUTER_SCALE = 4.0
# grok's rules at (2, 2): (batch, seq) whole, so T // dp is 1,024 and 4
GROK_CASES = {"dense": (4, 512), "scatter": (2, 4)}
OF_MAX, ADA_REL = 1e-5, 1e-6


def _run_child(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, *args], env=env,
                       capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def _run_ranks(script: str, world: int, tmp, runs, timeout: float = 180.0):
    """Run ``script`` as ``world`` processes for each argument of ``runs``,
    all at once (argv: rank, world, tmp dir, the argument), the port's
    ranks on the CPU; every one must exit 0 in ``timeout`` seconds."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(world), str(tmp), arg], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for arg in runs for r in range(world)]
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


JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses as dc
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import LMConfig, get_arch
    from repro.distributed.sharding import ShardingCtx, make_rules
    from repro.launch import steps as JS
    from repro.models.lm import model as JLM
    CUT, GROK_CUT, B, S, MESHES, CFS, SCALE, GROK_CASES = %s
    AUTO = (jax.sharding.AxisType.Auto,) * 2
    out = {}
    rng = np.random.default_rng(0)

    def layer(cut, seed):
        cfg = LMConfig(**cut)
        p = JLM._layer_init(jax.random.key(seed), cfg, jnp.float32)[0]
        p = {k: np.asarray(v) for k, v in p.items()}
        p["router"] = p["router"] * SCALE
        return cfg, p

    def held(tag, fn, cfg, p, x, mesh, ctx):
        R = rng.standard_normal(x.shape).astype(np.float32)
        names = ("router", "w_gate", "w_up", "w_down")

        def f(x, ws):
            o, aux = fn({**p, **dict(zip(names, ws))}, cfg, x, ctx)
            return jnp.sum(o * R) + aux, (o, aux)
        ws = [jnp.asarray(p[n]) for n in names]
        (_, (o, aux)), (gx, gws) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), ws)
        out[f"{tag}/x"], out[f"{tag}/R"], out[f"{tag}/out"] = x, R, \\
            np.asarray(o)
        for n, v in p.items():
            out[f"{tag}/p/{n}"] = v
        out[f"{tag}/g/x"] = np.asarray(gx)
        for n, g in zip(names, gws):
            out[f"{tag}/g/{n}"] = np.asarray(g)
        # each device's aux, in mesh order (the port's rank order): a
        # replicated output holds each data rank's own value
        aux = jax.jit(lambda x: fn(p, cfg, x, ctx)[1])(jnp.asarray(x))
        by_dev = {s.device.id: float(np.asarray(s.data))
                  for s in aux.addressable_shards}
        one = next(iter(by_dev.values()))
        out[f"{tag}/aux"] = np.array([by_dev.get(d.id, one)
                                      for d in mesh.devices.reshape(-1)])

    cfg, p = layer(CUT, 1)
    for mname, (shape, ov) in MESHES.items():
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=AUTO)
        ctx = ShardingCtx(make_rules(mesh, ov), mesh)
        for cf in CFS:
            c = dc.replace(cfg, capacity_factor=cf)
            x = (rng.standard_normal((B, S, c.d_model))
                 + rng.standard_normal(c.d_model)).astype(np.float32)
            held(f"{mname}/cf{cf}", JLM._moe_shard_map, c, p, x, mesh, ctx)
    gcfg, gp = layer(GROK_CUT, 2)
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=AUTO)
    shape = [s for s in get_arch("grok-1-314b").shapes
             if s.step == "train"][0]
    ctx = ShardingCtx(JS._rules_for("grok-1-314b", shape, mesh), mesh)
    for kind, (b, s) in GROK_CASES.items():
        x = rng.standard_normal((b, s, gcfg.d_model)).astype(np.float32)
        held(f"grok/{kind}", JLM._moe_block, gcfg, gp, x, mesh, ctx)

    # the branch _moe_block takes, recorded
    took = []
    def rec(name):
        def f(p, cfg, x, ctx):
            took.append(name)
            return x, jnp.zeros((), jnp.float32)
        return f
    JLM._moe_shard_map, JLM._moe_dense, JLM._moe_scatter = (
        rec("shard_map"), rec("dense"), rec("scatter"))
    cases = []
    for shape2, rules, E, b, s in (
            ((2, 2), None, 8, 4, 32), ((1, 4), None, 8, 2, 8),
            ((2, 2), None, 6, 4, 32), ((1, 4), None, 6, 1, 2048),
            ((2, 2), "grok", 8, 2, 1024), ((2, 2), "grok", 8, 2, 1023),
            ((2, 2), None, 8, 2, 1), ((2, 2), None, 8, 8, 1),
            ((1, 4), None, 8, 1, 2), (None, None, 8, 4, 2048)):
        c = dc.replace(cfg, n_experts=E)
        if shape2 is None:
            ctx = ShardingCtx(None)
        else:
            m = jax.make_mesh(shape2, ("data", "model"), axis_types=AUTO)
            r = JS._rules_for("grok-1-314b", shape, m) if rules \\
                else make_rules(m)
            ctx = ShardingCtx(r, m)
        jax.eval_shape(lambda x: JLM._moe_block(p, c, x, ctx),
                       jax.ShapeDtypeStruct((b, s, c.d_model), jnp.float32))
        cases.append((shape2, rules, E, b, s, took[-1]))
    out["dispatch"] = np.array(repr(cases))
    np.savez(sys.argv[1], **out)
    print("JAX_MOE_OK")
""")

RANK = textwrap.dedent("""
    import sys, dataclasses as dc, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import LMConfig, get_arch
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import lm_rules
    from repro_torch.models.lm import model as LM
    from repro_torch.optim import optimizers as O
    rank, world, tmp, mname = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], sys.argv[4]
    init_distributed(rank, world, f"{tmp}/rdv-{mname}", device="cpu")
    inp = torch.load(f"{tmp}/moe_inputs.pt", weights_only=False)
    shape, ov = inp["meshes"][mname]
    mesh = make_mesh(shape, ("data", "model"))
    res = {}

    def run(tag, cfg, ctx, fn):
        c = inp["cases"][tag]
        dp = ctx.size("data")
        di = ctx.axis_index("data")
        rows = c["x"].shape[0] // dp
        x = c["x"][di * rows:(di + 1) * rows].clone().requires_grad_(True)
        R = c["R"][di * rows:(di + 1) * rows]
        full = {"layers": [c["p"]], "embed": torch.zeros(cfg.vocab_size,
                cfg.d_model), "final_norm": torch.ones(cfg.d_model),
                "lm_head": torch.zeros(cfg.d_model, cfg.vocab_size)}
        p = LM.shard_params(full, cfg, ctx)["layers"][0]
        names = ("router", "w_gate", "w_up", "w_down")
        for n in names:
            p[n].requires_grad_(True)
        o, aux = fn(p, cfg, x, ctx, LM.param_layout(cfg, ctx)["layers"][0])
        loss = torch.sum(o * R) + aux / dp
        grads = torch.autograd.grad(loss, [x] + [p[n] for n in names])
        res[tag] = dict(out=o.detach(), aux=float(aux.detach()),
                        rows=(di, rows),
                        grads=dict(zip(("x",) + names,
                                       [g.detach() for g in grads])),
                        kind=LM.moe_dispatch(cfg, x.shape[0] * x.shape[1],
                                             ctx))

    cfg = LMConfig(**inp["cut"])
    ctx = ShardingCtx(make_rules(mesh, ov), mesh)
    for cf in inp["cfs"]:
        run(f"{mname}/cf{cf}", dc.replace(cfg, capacity_factor=cf), ctx,
            LM._moe_shard_map)
    if mname == "2x2":
        gcfg = LMConfig(**inp["grok_cut"])
        train = [s for s in get_arch("grok-1-314b").shapes
                 if s.step == "train"][0]
        gctx = ShardingCtx(lm_rules("grok-1-314b", train, mesh), mesh)
        for kind in inp["grok_cases"]:
            run(f"grok/{kind}", gcfg, gctx, LM._moe_block)
        # Adafactor on blocks against the whole leaf's block
        dg, mg = ctx.group("data"), ctx.group("model")
        di, mi = ctx.axis_index("data"), ctx.axis_index("model")
        gen = torch.Generator().manual_seed(5)
        leaves = {"rows": ((8, 12), (dg, None)), "cols": ((3, 8, 12),
                  (None, None, mg)), "expert": ((4, 8, 12), (mg, dg, None)),
                  "vec": ((16,), (dg,))}
        whole = {k: [torch.randn(s, generator=gen) for _ in range(2)]
                 for k, (s, _) in leaves.items()}
        idx = {id(dg): (di, 2), id(mg): (mi, 2)}

        def block(t, groups):
            for d, g in enumerate(groups):
                if g is not None:
                    i, n = idx[id(g)]
                    t = torch.chunk(t, n, dim=d)[i]
            return t
        mine = {k: [block(g, gr) for g in whole[k]]
                for k, (_, gr) in leaves.items()}
        shards = {k: gr for k, (_, gr) in leaves.items()}
        opt_w, opt_s = O.adafactor(), O.adafactor(shards=shards)
        st_w = opt_w.init({k: v[0] for k, v in whole.items()})
        st_s = opt_s.init({k: v[0] for k, v in mine.items()})
        gaps = []
        for t in range(2):
            uw, st_w = opt_w.update({k: v[t] for k, v in whole.items()},
                                    st_w)
            us, st_s = opt_s.update({k: v[t] for k, v in mine.items()},
                                    st_s)
            for k, (_, gr) in leaves.items():
                want = block(uw[k], gr)
                gaps.append((t, k, float((us[k] - want).norm()
                                         / want.norm())))
        res["adafactor"] = gaps
    torch.save(res, f"{tmp}/moe-{mname}-rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("jaxmoe") / "jax.npz"
    consts = repr((CUT, GROK_CUT, B, S, MESHES, CFS, ROUTER_SCALE,
                   GROK_CASES))
    assert "JAX_MOE_OK" in _run_child(JAX_CHILD % consts, str(path))
    return dict(np.load(path))


def _case(j, tag):
    return dict(x=_t(j[f"{tag}/x"]), R=_t(j[f"{tag}/R"]),
                p={k[len(tag) + 3:]: _t(v) for k, v in j.items()
                   if k.startswith(f"{tag}/p/")})


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("portmoe")
    tags = [f"{m}/cf{cf}" for m in MESHES for cf in CFS] \
        + [f"grok/{k}" for k in GROK_CASES]
    torch.save(dict(cut=CUT, grok_cut=GROK_CUT, cfs=CFS, meshes=MESHES,
                    grok_cases=list(GROK_CASES),
                    cases={t: _case(jax_run, t) for t in tags}),
               tmp / "moe_inputs.pt")
    _run_ranks(RANK, 4, tmp, list(MESHES))
    return {m: [torch.load(tmp / f"moe-{m}-rank{r}.pt", weights_only=False)
                for r in range(4)] for m in MESHES}


def _of_max(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _block(full, spec, coords, sizes):
    """The block of ``full`` a rank at ``coords`` holds under ``spec``."""
    for d, ax in enumerate(spec):
        if ax is not None:
            full = np.array_split(full, sizes[ax], axis=d)[coords[ax]]
    return full


def _held(j, tag, ranks, shape, rules, cfg):
    sizes = dict(zip(("data", "model"), shape))
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    lay = LM.param_layout(cfg, ShardingCtx(rules, mesh))["layers"][0]
    for r, res in enumerate(ranks):
        got = res[tag]
        coords = {"data": r // shape[1], "model": r % shape[1]}
        di, rows = got["rows"]
        sl = slice(di * rows, (di + 1) * rows)
        assert _of_max(got["out"], j[f"{tag}/out"][sl]) <= OF_MAX, (tag, r)
        assert abs(got["aux"] - j[f"{tag}/aux"][r]) <= OF_MAX * abs(
            j[f"{tag}/aux"][r]), (tag, r, got["aux"], j[f"{tag}/aux"][r])
        assert _of_max(got["grads"]["x"], j[f"{tag}/g/x"][sl]) <= OF_MAX, \
            (tag, r)
        for n in ("router", "w_gate", "w_up", "w_down"):
            want = _block(j[f"{tag}/g/{n}"], lay[n], coords, sizes)
            assert got["grads"][n].shape == want.shape, (tag, n)
            assert _of_max(got["grads"][n], want) <= OF_MAX, (tag, r, n)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("cf", CFS)
def test_moe_shard_map_matches_jax(jax_run, port_runs, mname, cf):
    shape, ov = MESHES[mname]
    cfg = LMConfig(**{**CUT, "capacity_factor": cf})
    tag = f"{mname}/cf{cf}"
    _held(jax_run, tag, port_runs[mname], shape,
          make_rules(("data", "model"), ov), cfg)
    assert all(r[tag]["kind"] == "shard_map" for r in port_runs[mname])
    # cf 8 drops nothing; 1.25 drops slots in some slice
    x = _t(jax_run[f"{tag}/x"]).reshape(-1, CUT["d_model"])
    p = _case(jax_run, tag)["p"]
    nm, dp = shape[1], shape[0]
    T_my = x.shape[0] // dp // nm
    dropped = 0
    for i in range(dp * nm):
        _, eid, _ = LM._router(p, cfg, x[i * T_my:(i + 1) * T_my])
        pos = LM._pos_in_group(eid.reshape(-1))
        dropped += int((pos >= LM.shard_map_capacity(cfg, T_my)).sum())
    assert (dropped == 0) == (cf == 8.0), dropped


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("cf", CFS)
def test_moe_shard_map_plain_matches_jax(jax_run, mname, cf):
    (dp, nm), _ = MESHES[mname]
    cfg = LMConfig(**{**CUT, "capacity_factor": cf})
    tag = f"{mname}/cf{cf}"
    c = _case(jax_run, tag)
    rows = B // dp
    for di in range(dp):
        out, aux = LM._moe_shard_map_plain(
            c["p"], cfg, c["x"][di * rows:(di + 1) * rows], nm)
        want = jax_run[f"{tag}/out"][di * rows:(di + 1) * rows]
        assert _of_max(out, want) <= OF_MAX, (tag, di)
        for r in range(di * nm, (di + 1) * nm):
            assert abs(float(aux) - jax_run[f"{tag}/aux"][r]) <= OF_MAX \
                * abs(jax_run[f"{tag}/aux"][r]), (tag, di, r)


@pytest.mark.parametrize("kind", list(GROK_CASES))
def test_moe_block_dense_and_scatter_under_a_data_mesh(jax_run, port_runs,
                                                       kind):
    cfg = LMConfig(**GROK_CUT)
    train = [s for s in get_arch("grok-1-314b").shapes
             if s.step == "train"][0]
    rules = lm_rules("grok-1-314b", train, ("data", "model"))
    tag = f"grok/{kind}"
    assert all(r[tag]["kind"] == kind for r in port_runs["2x2"])
    _held(jax_run, tag, port_runs["2x2"], (2, 2), rules, cfg)


def test_moe_dispatch_matches_jax(jax_run):
    cases = eval(str(jax_run["dispatch"]))
    assert {c[-1] for c in cases} == {"shard_map", "dense", "scatter"}
    for shape, rules, E, b, s, want in cases:
        cfg = LMConfig(**{**CUT, "n_experts": E})
        if shape is None:
            ctx = None
        else:
            names = ("data", "model")
            mesh = SimpleNamespace(mesh_dim_names=names, shape=shape)
            train = [x for x in get_arch("grok-1-314b").shapes
                     if x.step == "train"][0]
            r = lm_rules("grok-1-314b", train, names) if rules \
                else make_rules(names)
            ctx = ShardingCtx(r, mesh)
        dp = 1 if shape is None else shape[0]
        assert LM.moe_dispatch(cfg, b * s // dp, ctx) == want, \
            (shape, rules, E, b, s)


def test_adafactor_on_shards_matches_the_whole_leaf(port_runs):
    for res in port_runs["2x2"]:
        assert len(res["adafactor"]) == 8
        for t, k, gap in res["adafactor"]:
            assert gap <= ADA_REL, (t, k, gap)


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
def test_lm_rules_match_jax(names):
    jmesh = jax.make_mesh((1,) * len(names), names)
    archs = [a for a in list_archs() if get_arch(a).family == "lm"]
    assert "grok-1-314b" in archs
    for a in archs:
        for shape, jshape in zip(get_arch(a).shapes,
                                 jax_get_arch(a).shapes):
            assert shape.name == jshape.name
            assert lm_rules(a, shape, names) == JS._rules_for(
                a, jshape, jmesh), (a, shape.name)
    from repro.configs import grok_1_314b as JG
    from repro_torch.configs import grok_1_314b as PG
    assert PG.RULES_OVERRIDE == JG.RULES_OVERRIDE


@pytest.mark.parametrize("arch_id", [a for a in list_archs()
                                     if get_arch(a).family == "lm"])
def test_param_specs_match_jax(arch_id):
    j = dc.replace(jax_get_arch(arch_id).config, n_layers=2,
                   scan_layers=False, d_model=32, n_heads=4, n_kv_heads=2,
                   head_dim=8, d_ff=48, moe_d_ff=48, vocab_size=64)
    params, specs = JLM.init_params(jax.random.key(0), j)
    cfg = LMConfig(**dc.asdict(j))
    assert LM.param_specs(cfg) == specs
    shapes = LM._tree_map(lambda leaf: leaf[0], LM._leaves(cfg))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), params)
