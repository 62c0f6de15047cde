"""The port's optimizers that LM training uses (``sgd``, ``adafactor``,
``make_optimizer``) against the JAX package's, and the leaf-by-leaf
update (``apply_leafwise``) against the whole-dict one:

  * five steps on the same numpy parameters and gradients (leaves of 3, 2
    and 1 dims, so Adafactor runs factored and full statistics): each
    update and each state leaf within 1e-6 of its largest magnitude (f32
    on both sides; the means, ``rsqrt`` and powers round in another order;
    seen: within 3e-7), step counts exact.  ``sgd`` with momentum 0 and
    0.9; ``adafactor`` with and without ``lr_schedule`` and with a clip
    threshold of 0.5, where the RMS clipping binds on every step;
    ``make_optimizer`` for every name (the default rates and a given one),
    and both packages refuse an unknown name;
  * ``apply_leafwise`` bitwise equal to ``update`` + ``apply_updates`` for
    SGD, AdaGrad, AdamW, Adafactor and ``rankgraph2_optimizer``, its step
    counted once, its gradients consumed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as JO
from repro_torch.optim import optimizers as O

torch.set_num_threads(2)

SHAPES = {"emb": (12, 8), "w3": (3, 5, 7), "bias": (9,),
          "tables": (6, 4)}
STEPS, OF_MAX = 5, 1e-6


def _params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(rng) -> dict:
    # rows of different scales: the factored statistics differ by row
    return {k: (rng.standard_normal(s) * np.exp(rng.standard_normal(
        s[:1] + (1,) * (len(s) - 1)))).astype(np.float32)
        for k, s in SHAPES.items()}


def _near(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().numpy() - want).max(initial=0.0))
    assert err <= OF_MAX * float(np.abs(want).max(initial=0.0)), (what, err)


def _state_leaves(jst, st):
    """(JAX dict, port dict) pairs of the per-parameter state, and the
    (JAX, port) step counts."""
    if isinstance(st, O.AdamState):
        return [(jst.mu, st.mu), (jst.nu, st.nu)], (jst.count, st.count)
    if isinstance(st, O.FactorState):
        return [(jst.vr, st.vr), (jst.vc, st.vc)], (jst.count, st.count)
    if isinstance(st, dict) and st:
        return [(jst, st)], None
    return [], None


CASES = {
    "sgd": (lambda: JO.sgd(0.1), lambda: O.sgd(0.1)),
    "sgd momentum": (lambda: JO.sgd(0.05, 0.9), lambda: O.sgd(0.05, 0.9)),
    "adafactor": (lambda: JO.adafactor(), lambda: O.adafactor()),
    "adafactor constant lr": (lambda: JO.adafactor(0.02, lr_schedule=False),
                              lambda: O.adafactor(0.02, lr_schedule=False)),
    "adafactor clipping": (lambda: JO.adafactor(clip_threshold=0.5),
                           lambda: O.adafactor(clip_threshold=0.5)),
    "make adamw": (lambda: JO.make_optimizer("adamw"),
                   lambda: O.make_optimizer("adamw")),
    "make adagrad": (lambda: JO.make_optimizer("adagrad"),
                     lambda: O.make_optimizer("adagrad")),
    "make adafactor": (lambda: JO.make_optimizer("adafactor"),
                       lambda: O.make_optimizer("adafactor")),
    "make sgd": (lambda: JO.make_optimizer("sgd"),
                 lambda: O.make_optimizer("sgd")),
    "make rankgraph2": (lambda: JO.make_optimizer("rankgraph2"),
                        lambda: O.make_optimizer("rankgraph2")),
    "make adamw at 1e-3": (lambda: JO.make_optimizer("adamw", 1e-3),
                           lambda: O.make_optimizer("adamw", 1e-3)),
    "make adafactor at 0.05": (lambda: JO.make_optimizer("adafactor", 0.05),
                               lambda: O.make_optimizer("adafactor", 0.05)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax(case):
    jopt, opt = (f() for f in CASES[case])
    params = _params(seed=len(case))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, st = jopt.init(jp), opt.init(tp)
    rng = np.random.default_rng(len(case) + 1)
    for t in range(STEPS):
        g = _grads(rng)
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        upd, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, tp)
        jp = JO.apply_updates(jp, ju)
        O.apply_updates(tp, upd)
        for k in SHAPES:
            assert upd[k].dtype == torch.float32
            _near(upd[k], ju[k], f"{case} step {t} update {k}")
            _near(tp[k], jp[k], f"{case} step {t} param {k}")
        if case != "make rankgraph2":       # JAX's partition state is a tree
            pairs, counts = _state_leaves(jst, st)
            for jd, td in pairs:
                assert sorted(td) == sorted(jd)
                for k in td:
                    _near(td[k], jd[k], f"{case} step {t} state {k}")
            if counts is not None:
                assert counts[1] == int(counts[0]) == t + 1
    if case == "adafactor clipping":      # the clipping bound: |u| <= lr_t * 0.5 RMS
        rms = float(torch.sqrt(torch.mean(torch.square(upd["w3"]))))
        lr_t = 0.01 / np.sqrt(STEPS)
        assert rms == pytest.approx(lr_t * 0.5, rel=1e-5)


def test_make_optimizer_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        JO.make_optimizer("lion")
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        O.make_optimizer("lion")


LEAFWISE = {"sgd": lambda: O.sgd(0.1), "sgd momentum": lambda: O.sgd(0.1, 0.9),
            "adagrad": lambda: O.adagrad(), "adamw": lambda: O.adamw(1e-3),
            "adafactor": lambda: O.adafactor(),
            "rankgraph2": lambda: O.rankgraph2_optimizer()}


def _flat_state(st) -> list:
    if isinstance(st, dict):
        return [x for k in sorted(st) for x in _flat_state(st[k])]
    if isinstance(st, torch.Tensor):
        return [st]
    if isinstance(st, tuple):
        return [x for s in st for x in _flat_state(s)]
    return [st]


@pytest.mark.parametrize("name", list(LEAFWISE))
def test_apply_leafwise_is_bitwise_the_whole_dict_update(name):
    opt = LEAFWISE[name]()
    params = _params(seed=7)
    whole = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    leaf = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sw, sl = opt.init(whole), opt.init(leaf)
    rng = np.random.default_rng(8)
    for _ in range(3):
        g = {k: torch.from_numpy(v) for k, v in _grads(rng).items()}
        upd, sw = opt.update(g, sw, whole)
        O.apply_updates(whole, upd)
        given = dict(g)
        sl = O.apply_leafwise(opt, given, sl, leaf)
        assert given == {}                       # every gradient consumed
    for k in whole:
        assert torch.equal(whole[k], leaf[k]), k
    a, b = _flat_state(sw), _flat_state(sl)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y                        # counts: 3, counted once
    if name in ("adamw", "adafactor"):
        assert sl.count == 3


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_in_place_matches_jax(max_norm):
    """``clip_by_global_norm_`` against JAX's ``clip_by_global_norm``: the
    norm, and each gradient in the type JAX's ``g * scale`` promotes it
    to (a bf16 gradient comes back f32); at 100 nothing is scaled."""
    rng = np.random.default_rng(3)
    g = _grads(rng)
    bf = {"emb": True, "bias": True}
    jg = {k: jnp.asarray(v, jnp.bfloat16 if k in bf else jnp.float32)
          for k, v in g.items()}
    tg = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf
                                    else torch.float32)
          for k, v in g.items()}
    want, jnorm = JO.clip_by_global_norm(jg, max_norm)
    f32_before = {k: t for k, t in tg.items() if k not in bf}
    norm = O.clip_by_global_norm_(tg, max_norm)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k, t in tg.items():
        assert t.dtype == torch.float32 and want[k].dtype == jnp.float32
        _near(t, want[k], f"clipped {k}")
    for k, t in f32_before.items():
        assert tg[k] is t                        # scaled where it lies
