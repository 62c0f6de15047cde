"""Hour-level incremental refresh of the PyTorch port against the JAX
package, bitwise, on the same numpy-made logs: ``refresh_graph`` (edge
sets and weights, ``group1`` masks, the retained ``RefreshState`` with
its hub draws), ``refresh_ppr_neighbors`` through ``incremental_refresh``
(both tables, ``PPRState.visited``, the affected and touched sets) with
the port's ``numpy`` backend and its ``device`` backend on the CPU (the
plain ``ppr_walk``), against the JAX ``numpy`` backend.  Each case also
holds the port's refresh against its own from-scratch rebuild on the
merged log: affected rows equal the rebuild's, the others the remapped
old tables.  Then ``_expand_affected``, ``merge_edge_aggregates``,
``group2_neighbors`` and ``ppr_visit_counts`` alone, and the errors."""
import numpy as np
import pytest
import torch

from repro.core import graph_builder as JGB
from repro.core import ppr as JP
from repro.data import edge_dataset as JED
from repro.data import synthetic as JS
from repro_torch.core import graph_builder as GB
from repro_torch.core import ppr as P
from repro_torch.data import edge_dataset as ED
from repro_torch.data import synthetic as S

torch.set_num_threads(2)

BACKENDS = ("numpy", "device")
PW = dict(k_imp=6, n_walks=8, walk_len=3, seed=0)


def _as(mod, lg):
    """The same numpy arrays as the given package's EngagementLog."""
    return mod.EngagementLog(lg.user_id, lg.item_id, lg.event_type,
                             lg.timestamp, lg.n_users, lg.n_items)


def _merge(a, b, nu, ni):
    return JGB.EngagementLog(
        np.r_[a.user_id, b.user_id], np.r_[a.item_id, b.item_id],
        np.r_[a.event_type, b.event_type], np.r_[a.timestamp, b.timestamp],
        nu, ni)


def _split(log, t_cut):
    m = log.timestamp <= t_cut
    old = JGB.EngagementLog(log.user_id[m], log.item_id[m],
                            log.event_type[m], log.timestamp[m],
                            log.n_users, log.n_items)
    return old, log.window(86400.0, 86400.0 - t_cut)


def _case_rebuild():
    w = JS.make_world(n_users=60, n_items=80, events_per_user=8.0, seed=5)
    old, delta = _split(w.day0, 79200.0)               # 22h | 2h delta
    return dict(old=old, delta=delta, merged=w.day0,
                kw=dict(k_cap=12, hub_cap=512), pw=PW, prev_emb=None)


def _case_fractional():
    w = JS.make_world(n_users=40, n_items=50, events_per_user=8.0, seed=13)
    old, delta = _split(w.day0, 79200.0)
    ew = {0: 0.1, 1: 0.3, 2: 0.7, 3: 1.3}
    return dict(old=old, delta=delta, merged=w.day0,
                kw=dict(k_cap=8, hub_cap=512, event_weights=ew),
                pw=dict(k_imp=5, n_walks=8, walk_len=2, seed=0),
                prev_emb=None)


def _case_item_growth():
    w = JS.make_world(n_users=50, n_items=60, events_per_user=8.0, seed=2)
    ni_new = 65
    rng = np.random.default_rng(9)
    du = rng.integers(0, 50, 30).astype(np.int64)
    di = np.r_[rng.integers(0, 60, 25), np.arange(60, 65)].astype(np.int64)
    delta = JGB.EngagementLog(du, di,
                              rng.integers(0, 4, 30).astype(np.int32),
                              np.full(30, 90000.0), 50, ni_new)
    prev_emb = rng.normal(0, 1, (50 + ni_new, 16)).astype(np.float32)
    return dict(old=w.day0, delta=delta,
                merged=_merge(w.day0, delta, 50, ni_new),
                kw=dict(k_cap=12, hub_cap=512), pw=PW, prev_emb=prev_emb)


def _case_user_growth():
    nu, ni, nu_new = 50, 60, 56
    w = JS.make_world(n_users=nu, n_items=ni, events_per_user=8.0, seed=21)
    rng = np.random.default_rng(17)
    # some old users re-engage + 6 brand-new users engage
    du = np.r_[rng.integers(0, nu, 20), np.arange(nu, nu_new)
               ].astype(np.int64)
    di = rng.integers(0, ni, len(du)).astype(np.int64)
    delta = JGB.EngagementLog(du, di,
                              rng.integers(0, 4, len(du)).astype(np.int32),
                              np.full(len(du), 90000.0), nu_new, ni)
    prev_emb = rng.normal(0, 1, (nu_new + ni, 16)).astype(np.float32)
    return dict(old=w.day0, delta=delta,
                merged=_merge(w.day0, delta, nu_new, ni),
                kw=dict(k_cap=12, hub_cap=512), pw=PW, prev_emb=prev_emb)


def _case_hub():
    w = JS.make_world(n_users=50, n_items=40, events_per_user=20.0, seed=11)
    old, delta = _split(w.day0, 79200.0)
    return dict(old=old, delta=delta, merged=w.day0,
                kw=dict(k_cap=12, hub_cap=6), pw=PW, prev_emb=None)


def _case_isolated():
    """Two disjoint communities; the delta touches community 0 only."""
    nu, ni = 20, 20
    rng = np.random.default_rng(0)
    ev_u, ev_i = [], []
    for base in (0, 10):
        ev_u.append(rng.integers(base, base + 10, 120))
        ev_i.append(rng.integers(base, base + 10, 120))
    log = JGB.EngagementLog(
        np.concatenate(ev_u), np.concatenate(ev_i),
        rng.integers(0, 4, 240).astype(np.int32),
        rng.random(240) * 80000.0, nu, ni)
    delta = JGB.EngagementLog(
        rng.integers(0, 10, 15), rng.integers(0, 10, 15),
        rng.integers(0, 4, 15).astype(np.int32), np.full(15, 85000.0),
        nu, ni)
    return dict(old=log, delta=delta, merged=_merge(log, delta, nu, ni),
                kw=dict(k_cap=8, hub_cap=512),
                pw=dict(k_imp=5, n_walks=8, walk_len=3, seed=0),
                prev_emb=None)


CASES = {"rebuild": _case_rebuild, "fractional": _case_fractional,
         "item_growth": _case_item_growth, "user_growth": _case_user_growth,
         "hub": _case_hub, "isolated": _case_isolated}


def _same_edges(a, b, what):
    for f in ("src", "dst", "weight"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f}")


def _same_graph(a, b):
    for et in ("ui", "uu", "ii"):
        _same_edges(getattr(a, et), getattr(b, et), et)
    np.testing.assert_array_equal(a.group1_users, b.group1_users)
    np.testing.assert_array_equal(a.group1_items, b.group1_items)
    assert (a.n_users, a.n_items) == (b.n_users, b.n_items)


@pytest.fixture(scope="module", params=list(CASES))
def jax_run(request):
    """The JAX package's refresh of a case (numpy backend), cached per
    case for both port backends."""
    c = CASES[request.param]()
    g_old = JGB.build_graph(c["old"], keep_state=True, **c["kw"])
    t_old = JED.build_neighbor_tables(g_old, keep_state=True, **c["pw"])
    g_ref, t_ref, rep = JED.incremental_refresh(g_old, t_old, c["delta"],
                                                prev_emb=c["prev_emb"])
    return request.param, c, (g_ref, t_ref, rep)


@pytest.mark.parametrize("backend", BACKENDS)
def test_incremental_refresh_matches_jax_and_a_rebuild(jax_run, backend):
    name, c, (jg, jt, jrep) = jax_run
    old, delta, merged = (_as(GB, c[k]) for k in ("old", "delta", "merged"))
    g_old = GB.build_graph(old, keep_state=True, **c["kw"])
    t_old = ED.build_neighbor_tables(g_old, keep_state=True,
                                     backend=backend, device="cpu",
                                     **c["pw"])
    old_user, old_item = t_old.user_nbrs.copy(), t_old.item_nbrs.copy()
    g_ref, t_ref, rep = ED.incremental_refresh(
        g_old, t_old, delta, prev_emb=c["prev_emb"], backend=backend,
        device="cpu")

    # against the JAX package, bitwise
    _same_graph(g_ref, jg)
    for f in ("ui_full", "uu_raw", "ii_raw"):
        _same_edges(getattr(g_ref.refresh, f), getattr(jg.refresh, f), f)
    assert g_ref.refresh.params == jg.refresh.params
    for tag in ("uu", "ii"):
        a, b = g_ref.refresh.hub_draws[tag], jg.refresh.hub_draws[tag]
        for f in ("anchor_ids", "offsets", "lens"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("user_nbrs", "item_nbrs"):
        x, y = getattr(t_ref, f), getattr(jt, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (t_ref.n_users, t_ref.n_items) == (jt.n_users, jt.n_items)
    for f in ("visited", "nbrs", "cum"):
        x, y = getattr(t_ref.ppr, f), getattr(jt.ppr, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert t_ref.ppr.n_users == jt.ppr.n_users
    assert t_ref.ppr.backend == backend
    for k in ("touched_users", "touched_items", "affected_nodes"):
        np.testing.assert_array_equal(rep[k], jrep[k], err_msg=k)
    assert rep["refresh_seconds"] >= sum(rep["seconds"].values()) - 1e-9
    assert set(rep["seconds"]) == {"refresh_graph", "ppr_refresh",
                                   "group2_fill"}

    # against the port's own from-scratch rebuild on the merged log
    g_full = GB.build_graph(merged, **c["kw"])
    t_full = ED.build_neighbor_tables(g_full, prev_emb=c["prev_emb"],
                                      backend=backend, device="cpu",
                                      **c["pw"])
    _same_graph(g_ref, g_full)
    nu_old, nu = g_old.n_users, g_ref.n_users
    n = nu + g_ref.n_items
    am = np.zeros(n, bool)
    am[rep["affected_nodes"]] = True
    for a, b in ((t_ref.user_nbrs, t_full.user_nbrs),
                 (t_ref.item_nbrs, t_full.item_nbrs)):
        np.testing.assert_array_equal(a[am], b[am])
    shift = nu - nu_old
    old_pos = np.r_[np.arange(nu_old),
                    np.arange(nu_old, g_old.n_users + g_old.n_items) + shift]
    carried = ~am[old_pos]
    for a, b in ((t_ref.user_nbrs, old_user), (t_ref.item_nbrs, old_item)):
        np.testing.assert_array_equal(
            a[old_pos[carried]], np.where(b >= nu_old, b + shift, b)[carried])

    if name == "hub":       # the subsample triggered; all rows rebuilt
        st = g_old.refresh
        assert len(st.hub_draws["uu"].anchor_ids) or \
            len(st.hub_draws["ii"].anchor_ids)
        np.testing.assert_array_equal(t_ref.user_nbrs, t_full.user_nbrs)
        np.testing.assert_array_equal(t_ref.item_nbrs, t_full.item_nbrs)
    if name in ("item_growth", "user_growth"):
        new = (np.arange(nu_old, nu) if name == "user_growth"
               else nu + np.arange(g_old.n_items, g_ref.n_items))
        assert am[new].all()             # brand-new rows are affected
    if name == "item_growth":
        # fresh items without same-type co-engagement route through the
        # Group-2 KNN fallback
        fresh = [gid for gid in nu + np.arange(60, 65)
                 if not g_ref.group1_items[gid - nu]]
        assert fresh
        g1i = np.flatnonzero(g_ref.group1_items)
        for gid in fresh:
            row = t_ref.item_nbrs[gid]
            assert (row >= 0).any() and (row[row >= 0] >= nu).all()
            knn = P.group2_neighbors(c["prev_emb"][nu:], g1i,
                                     np.array([gid - nu]), 6)[0]
            m = knn >= 0
            np.testing.assert_array_equal(row[m], nu + knn[m])
    if name == "isolated":
        iso = np.r_[np.arange(10, 20), 20 + np.arange(10, 20)]
        assert not np.isin(iso, rep["affected_nodes"]).any()
        np.testing.assert_array_equal(t_ref.user_nbrs[iso], old_user[iso])
        np.testing.assert_array_equal(t_ref.item_nbrs[iso], old_item[iso])


def test_hub_draws_persisted_and_reused():
    """Persisted offsets are a pure function of (seed, tag, anchor id,
    degree) and equal the JAX package's; a refresh with one event keeps
    the untouched anchors' rows verbatim."""
    w = JS.make_world(n_users=40, n_items=30, events_per_user=20.0, seed=3)
    g = GB.build_graph(_as(GB, w.day0), k_cap=12, hub_cap=6, keep_state=True)
    jg = JGB.build_graph(w.day0, k_cap=12, hub_cap=6, keep_state=True)
    d0 = g.refresh.hub_draws
    assert len(d0["uu"].anchor_ids) and len(d0["ii"].anchor_ids)
    for tag in ("uu", "ii"):
        hd = d0[tag]
        for f in ("anchor_ids", "offsets", "lens"):
            np.testing.assert_array_equal(getattr(hd, f),
                                          getattr(jg.refresh.hub_draws[tag],
                                                  f))
        u = GB.hub_uniforms(0, tag, hd.anchor_ids, hd.offsets.shape[1])
        o = (u * hd.lens[:, None]).astype(np.int64)
        o.sort(axis=1)
        dup = np.zeros_like(o, bool)
        dup[:, 1:] = o[:, 1:] == o[:, :-1]
        o[dup] = -1
        np.testing.assert_array_equal(o, hd.offsets)
    one = dict(user_id=np.array([0]), item_id=np.array([0]),
               event_type=np.array([0], np.int32),
               timestamp=np.array([90000.0]), n_users=40, n_items=30)
    g2, rep = GB.refresh_graph(g, GB.EngagementLog(**one))
    jg2, jrep = JGB.refresh_graph(jg, JGB.EngagementLog(**one))
    for tag in ("uu", "ii"):
        a, b = g2.refresh.hub_draws[tag], jg2.refresh.hub_draws[tag]
        for f in ("anchor_ids", "offsets", "lens"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        # anchors whose degree did not change keep their persisted rows
        prev = d0[tag]
        pos = np.searchsorted(a.anchor_ids, prev.anchor_ids)
        pos = np.minimum(pos, len(a.anchor_ids) - 1)
        same = (a.anchor_ids[pos] == prev.anchor_ids) & \
            (a.lens[pos] == prev.lens)
        assert same.any()
        np.testing.assert_array_equal(a.offsets[pos[same]],
                                      prev.offsets[same])
    for k in ("touched_users", "touched_items"):
        np.testing.assert_array_equal(rep[k], jrep[k])


# ---------------------------------------------------------------------------
# the pieces alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hops", [0, 1, 2, 4])
def test_expand_affected_matches_jax(hops):
    rng = np.random.default_rng(hops)
    n, D = 200, 6
    nbrs = np.where(rng.random((n, D)) < 0.3, -1,
                    rng.integers(0, n, (n, D))).astype(np.int64)
    changed = rng.random(n) < 0.03
    got = P._expand_affected(nbrs, changed, hops)
    np.testing.assert_array_equal(got, JP._expand_affected(nbrs, changed,
                                                           hops))
    assert (got >= changed).all()
    if hops == 0:
        np.testing.assert_array_equal(got, changed)


def _edge_set(mod, rng, n, n_src, n_dst, frac):
    w = rng.integers(0, 4, n).astype(np.float64)
    if frac:
        w = w * 0.1 + rng.random(n) * (w > 0)
    return mod.EdgeSet(rng.integers(0, n_src, n).astype(np.int64),
                       rng.integers(0, n_dst, n).astype(np.int64), w)


@pytest.mark.parametrize("na,nb,frac", [
    (50, 40, False), (50, 40, True), (0, 30, False), (30, 0, True),
    (0, 0, False), (400, 400, True),
])
def test_merge_edge_aggregates_matches_jax(na, nb, frac):
    n_src, n_dst = 12, 17
    out = []
    for mod in (GB, JGB):
        rng = np.random.default_rng(na * 1000 + nb + frac)
        a = _edge_set(mod, rng, na, n_src, n_dst, frac)
        b = _edge_set(mod, rng, nb, n_src, n_dst, frac)
        # aggregates come in key order without duplicates
        a = mod.merge_edge_aggregates(a, mod.EdgeSet(
            np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)),
            n_dst)
        out.append(mod.merge_edge_aggregates(a, b, n_dst))
    _same_edges(out[0], out[1], "merged")
    m = out[0]
    assert m.weight.dtype == np.float64 and (m.weight > 0).all()
    key = m.src * n_dst + m.dst
    assert (np.diff(key) > 0).all()


@pytest.mark.parametrize("n1,n2,k,chunk", [
    (40, 25, 6, 4096), (40, 25, 6, 7), (3, 10, 6, 4096), (1, 5, 4, 2),
    (0, 5, 4, 4096), (30, 0, 4, 4096),
])
def test_group2_neighbors_matches_jax(n1, n2, k, chunk):
    rng = np.random.default_rng(n1 + 7 * n2 + chunk)
    n = n1 + n2 + 5
    emb = rng.normal(size=(n, 12)).astype(np.float32)
    emb[2] = 0.0                        # a zero row: the norm floor
    ids = rng.permutation(n)
    g1, g2 = np.sort(ids[:n1]), ids[n1:n1 + n2]
    got = P.group2_neighbors(emb, g1, g2, k, chunk=chunk)
    want = JP.group2_neighbors(emb, g1, g2, k, chunk=chunk)
    assert got.dtype == want.dtype and got.shape == (n2, k)
    np.testing.assert_array_equal(got, want)
    if 0 < n1 < k and n2:               # fewer Group-1 nodes than k
        assert (got[:, n1:] == -1).all() and (got[:, :n1] >= 0).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_ppr_visit_counts_matches_jax(backend):
    w = S.make_world(n_users=40, n_items=60, events_per_user=10.0, seed=7)
    jw = JS.make_world(n_users=40, n_items=60, events_per_user=10.0, seed=7)
    adj = P.build_padded_hetero_adj(GB.build_graph(w.day0, k_cap=8), 5)
    jadj = JP.build_padded_hetero_adj(JGB.build_graph(jw.day0, k_cap=8), 5)
    starts = np.r_[0:adj.n_nodes:3, 99].astype(np.int64)
    kw = dict(n_walks=8, walk_len=3, seed=1, chunk=40)
    vis, st = P.ppr_visit_counts(adj, starts, backend=backend,
                                 device="cpu", **kw)
    jvis, jst = JP.ppr_visit_counts(jadj, starts, backend="numpy", **kw)
    assert vis.dtype == jvis.dtype == np.int64
    np.testing.assert_array_equal(vis, jvis)
    np.testing.assert_array_equal(st, jst)


def test_ppr_visit_counts_unknown_backend_raises():
    w = S.make_world(n_users=10, n_items=12, events_per_user=10.0, seed=1)
    adj = P.build_padded_hetero_adj(GB.build_graph(w.day0, k_cap=8), 4)
    with pytest.raises(ValueError, match="backend"):
        P.ppr_visit_counts(adj, np.arange(4), backend="pallas")


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def _tiny_log(nu=10, ni=12):
    return GB.EngagementLog(np.array([0]), np.array([0]),
                            np.array([0], np.int32), np.array([0.0]), nu, ni)


def _tiny_graph(**kw):
    w = S.make_world(n_users=10, n_items=12, events_per_user=10.0, seed=3)
    return GB.build_graph(w.day0, k_cap=8, hub_cap=64, **kw)


def test_refresh_requires_state():
    g = _tiny_graph(keep_state=False)
    assert g.refresh is None
    with pytest.raises(ValueError, match="keep_state"):
        GB.refresh_graph(g, _tiny_log())
    t = ED.build_neighbor_tables(g, k_imp=4, n_walks=4, walk_len=2,
                                 backend="numpy")
    assert t.ppr is None
    with pytest.raises(ValueError, match="keep_state"):
        ED.incremental_refresh(g, t, _tiny_log())


def test_refresh_rejects_a_user_budget():
    g = _tiny_graph(keep_state=True, user_budget=5)
    with pytest.raises(ValueError, match="budget"):
        GB.refresh_graph(g, _tiny_log())


def test_refresh_rejects_shrinking_id_spaces():
    g = _tiny_graph(keep_state=True)
    with pytest.raises(ValueError, match="user space"):
        GB.refresh_graph(g, _tiny_log(9, 12))
    with pytest.raises(ValueError, match="item space"):
        GB.refresh_graph(g, _tiny_log(10, 11))


def test_refresh_ppr_unknown_backend_raises():
    g = _tiny_graph(keep_state=True)
    t = ED.build_neighbor_tables(g, k_imp=4, n_walks=4, walk_len=2,
                                 backend="numpy", keep_state=True)
    with pytest.raises(ValueError, match="backend"):
        P.refresh_ppr_neighbors(g, t.user_nbrs, t.item_nbrs, t.ppr,
                                backend="pallas")
