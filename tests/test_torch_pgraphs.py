"""The paper's other graphs in the port vs the JAX package, on the CPU:
``knn_ids``' selection against the full sort it replaced and against JAX
(ties included), HNSW built from the JAX builder's permutation, ``descend``
on a JAX-built HNSW, NSG and its connectivity repair, and the engines'
``entry_fn`` (HNSW descent) on tie-free codes."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.graphs import hnsw as jhnsw
from repro.graphs import nsg as jnsg
from repro.graphs.knn import knn_ids as j_knn_ids
from repro.search.engine import HybridEngine as JHybrid
from repro.search.engine import InMemoryEngine as JInMemory
from repro_torch import convert
from repro_torch.graphs import hnsw, nsg
from repro_torch.graphs.knn import knn_ids, knn_prefix
from repro_torch.search.engine import HybridEngine, InMemoryEngine

N, D, NQ = 2000, 16, 64
M_HNSW = 8
M, K = 8, 16          # the engines' tie-free codes: 16^8 distinct rows


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _clustered(seed, n, d, nc=16):
    r = np.random.default_rng(seed)
    centers = r.normal(size=(nc, d)) * 2.0
    return (centers[r.integers(0, nc, n)]
            + r.normal(size=(n, d))).astype(np.float32)


def _sort_knn(x, q, k, *, block, exclude_self):
    """The former ``knn_ids``: a stable sort of each whole distance tile."""
    n = x.shape[0]
    x2 = (x * x).sum(dim=1)
    cols = torch.arange(n)
    ids, dists = [], []
    for s in range(0, q.shape[0], block):
        qi = q[s:s + block]
        d2 = (qi * qi).sum(dim=1)[:, None] - 2.0 * qi @ x.T + x2[None, :]
        if exclude_self:
            rows = s + torch.arange(qi.shape[0])
            d2 = torch.where(cols[None, :] == rows[:, None], float("inf"), d2)
        vals, order = torch.sort(d2, dim=1, stable=True)
        ids.append(order[:, :k].to(torch.int32))
        dists.append(vals[:, :k])
    return torch.cat(ids), torch.cat(dists)


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("data", ["float_repeats", "int_repeats", "int"])
def test_knn_ids_select_equals_sort_and_jax(exclude_self, data):
    """Ids exact and distances bit-equal to the sort, ties included (rows
    repeated three times; small integer coordinates also tie distances
    between distinct rows). Ids exact against JAX's ``lax.top_k`` where the
    arithmetic is exact (integer data): on float data the two libraries'
    products round a repeated row's columns differently, so their ties
    are not the same ties."""
    r = np.random.default_rng(11)
    if data == "float_repeats":
        x = np.repeat(_clustered(12, 300, 8), 3, axis=0)[r.permutation(900)]
    elif data == "int_repeats":
        x = np.repeat(r.integers(-3, 4, (300, 8)), 3, axis=0)[r.permutation(900)]
    else:
        x = r.integers(-3, 4, (900, 8))
    x = x.astype(np.float32)
    q = x[:200] if exclude_self else np.concatenate([x[:100], x[::9][:100] + 0.5])
    got = knn_ids(T(x), T(q), 12, block=64, exclude_self=exclude_self)
    want = _sort_knn(T(x), T(q), 12, block=64, exclude_self=exclude_self)
    assert got[0].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if data.startswith("int"):
        jid, jd = j_knn_ids(jnp.asarray(x), jnp.asarray(q), 12, block=64,
                            exclude_self=exclude_self)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jid))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jd))


def test_build_vamana_verbose_prints_what_jax_prints(capsys):
    """``build_vamana(verbose=True)`` on the JAX builder's draws prints the
    reference's line for each pass (the mean degree)."""
    from repro.graphs.vamana import build_vamana as j_build_vamana
    from repro_torch.graphs.vamana import build_vamana_from_draws

    x = _clustered(9, 300, 8)
    key = jax.random.PRNGKey(0)
    j_build_vamana(key, jnp.asarray(x), r=8, l=16, batch=128, verbose=True)
    want = capsys.readouterr().out
    key, kinit = jax.random.split(key)
    init = np.array(jax.random.randint(kinit, (300, 8), 0, 300, jnp.int32))
    orders = []
    for _ in range(2):
        key, kperm = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(kperm, 300)))
    build_vamana_from_draws(T(x), init, orders, r=8, l=16, batch=128, verbose=True)
    got = capsys.readouterr().out
    assert got == want and got.count("[vamana] pass") == 2


def _jax_hnsw_perm(key, n):
    """The one draw ``repro.graphs.hnsw.build_hnsw`` takes from ``key``."""
    _, kperm = jax.random.split(key)
    return np.asarray(jax.random.permutation(kperm, n))


@pytest.fixture(scope="module")
def hnsw_pair():
    x = _clustered(1, N, D)
    jh = jhnsw.build_hnsw(jax.random.PRNGKey(2), jnp.asarray(x), m=M_HNSW)
    th = hnsw.build_hnsw_from_draws(T(x), _jax_hnsw_perm(jax.random.PRNGKey(2), N),
                                    m=M_HNSW)
    conv = convert.hnsw_from_numpy(
        np.asarray(jh.base.neighbors), np.asarray(jh.base.medoid),
        [np.asarray(g.neighbors) for g in jh.layers],
        [np.asarray(g.medoid) for g in jh.layers],
        [np.asarray(mb) for mb in jh.members], np.asarray(jh.top_entry),
        device="cpu")
    return dict(x=x, q=_clustered(2, NQ, D), jh=jh, th=th, conv=conv)


def _rows_equal(a, b) -> float:
    return float(np.mean(np.all(np.asarray(a) == np.asarray(b), axis=1)))


def test_build_hnsw_with_jax_draw_matches_jax(hnsw_pair):
    """``members`` and ``top_entry`` exact; every layer's rows equal on
    ≥ 99% (2000 rows, layers of 250 and 31 members)."""
    jh, th = hnsw_pair["jh"], hnsw_pair["th"]
    assert len(th.layers) == len(jh.layers) == 2
    for tm, jm in zip(th.members, jh.members):
        assert tm.dtype == torch.int64
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(th.top_entry) == int(jh.top_entry)
    assert int(th.base.medoid) == int(jh.base.medoid)
    assert th.base.neighbors.shape == (N, 2 * M_HNSW)
    assert _rows_equal(th.base.neighbors, jh.base.neighbors) >= 0.99
    for tg, jg in zip(th.layers, jh.layers):
        assert tg.neighbors.dtype == torch.int32 and tg.degree == M_HNSW
        assert int(tg.medoid) == int(jg.medoid)
        assert _rows_equal(tg.neighbors, jg.neighbors) >= 0.99


def test_build_hnsw_from_generator_is_layered():
    x = T(_clustered(3, 600, 8))
    h = hnsw.build_hnsw(x, generator=torch.Generator().manual_seed(0), m=4,
                        scale=4, device="cpu")
    assert [int(mb.shape[0]) for mb in h.members] == [150, 37]
    for mb in h.members:
        assert torch.equal(mb, torch.sort(mb).values) and int(mb.max()) < 600
    nb = h.base.neighbors
    assert not bool((nb == torch.arange(600)[:, None]).any())
    assert int(nb.max()) <= 600 and h.to("cpu").layers[1].n == 37


def test_descend_matches_jax(hnsw_pair):
    x, q = hnsw_pair["x"], hnsw_pair["q"]
    want = jhnsw.descend(hnsw_pair["jh"], jnp.asarray(q), jnp.asarray(x))
    got = hnsw.descend(hnsw_pair["conv"], T(q), T(x))
    assert got.dtype == torch.int32 and got.shape == (NQ,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_descend_without_upper_layers_is_the_medoid():
    x = T(_clustered(4, 40, 8))
    h = hnsw.build_hnsw(x, generator=torch.Generator().manual_seed(0), m=8,
                        device="cpu")
    assert h.layers == () and int(h.top_entry) == int(h.base.medoid)
    got = hnsw.descend(h, x[:5], x)
    assert got.tolist() == [int(h.base.medoid)] * 5


def test_build_nsg_matches_jax(monkeypatch):
    """NSG ignores its key; rows equal on ≥ 99%, the medoid exact. The
    reference's one repair pass leaves nodes unreachable here (a full
    parent row's last slot is overwritten by the next adoptee): one port
    pass on the same table equals it exactly (1000+ adoptions, full rows
    included), and the port repeats the pass until its BFS reaches every
    node, which changes only the rows of those parents."""
    x = _clustered(5, N, D)
    jg = jnsg.build_nsg(jax.random.PRNGKey(3), jnp.asarray(x), r=16, k=24,
                        search_l=24)
    before = {}
    repair = nsg._repair_connectivity

    def capture(xx, nbrs, medoid, r):
        before["nbrs"] = nbrs.copy()
        return repair(xx, nbrs, medoid, r)

    monkeypatch.setattr(nsg, "_repair_connectivity", capture)
    tg = nsg.build_nsg(T(x), r=16, k=24, search_l=24, batch=700, device="cpu")
    assert int(tg.medoid) == int(jg.medoid)
    assert tg.neighbors.dtype == torch.int32 and tg.degree == 16
    assert _rows_equal(tg.neighbors, jg.neighbors) >= 0.99
    assert len(nsg.unreachable(np.asarray(jg.neighbors), int(jg.medoid))) > 0
    assert len(nsg.unreachable(tg.neighbors.numpy(), int(tg.medoid))) == 0
    table, med = before["nbrs"], int(tg.medoid)
    one_pass = table.copy()
    nsg._adopt(T(x), one_pass, nsg.unreachable(table, med), 16)
    np.testing.assert_array_equal(one_pass,
                                  jnsg._repair_connectivity(x, table.copy(), med, 16))


def test_repair_connectivity_matches_jax_on_three_components():
    """Three rings (the medoid's and two unreachable ones), one full row
    among the adopting candidates: the repaired tables are equal."""
    n, r = 90, 4
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    nbrs = np.full((n, r), n, np.int32)
    for lo, hi in ((0, 30), (30, 55), (55, 90)):
        ids = np.arange(lo, hi)
        nbrs[ids, 0] = np.roll(ids, -1)
        nbrs[ids, 1] = np.roll(ids, 1)
    nbrs[:30, 2:] = rng.integers(0, 30, (30, 2))          # full rows
    assert len(nsg.unreachable(nbrs, 0)) == 60
    want = jnsg._repair_connectivity(x, nbrs.copy(), 0, r)
    got = nsg._repair_connectivity(T(x), nbrs.copy(), 0, r)
    np.testing.assert_array_equal(got, want)
    assert len(nsg.unreachable(got, 0)) == 0


@pytest.fixture(scope="module")
def tie_free():
    """Unique codes and random f32 LUTs: every ADC distance is distinct."""
    r = np.random.default_rng(8)
    codes = r.integers(0, K, (N, M)).astype(np.uint8)
    while np.unique(codes, axis=0).shape[0] != N:  # pragma: no cover
        codes = r.integers(0, K, (N, M)).astype(np.uint8)
    luts = r.random((NQ, M, K)).astype(np.float32)
    return codes, luts


def _assert_same_result(t_res, j_res):
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    for name in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(getattr(t_res, name).numpy(),
                                      np.asarray(getattr(j_res, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("engine", ["inmemory", "hybrid"])
def test_engines_with_entry_fn_match_jax(hnsw_pair, tie_free, engine):
    """``entry_fn=descend`` over the JAX-built HNSW: ids, dists, hops,
    n_dist and rounds exact; ``entries=4`` still wins over ``entry_fn``."""
    x, q, jh, th = hnsw_pair["x"], hnsw_pair["q"], hnsw_pair["jh"], hnsw_pair["conv"]
    codes, luts = tie_free
    jx = jnp.asarray(x)
    jentry = lambda qq: jhnsw.descend(jh, qq, jx)
    tentry = lambda qq: hnsw.descend(th, qq, T(x))
    jlut, tlut = (lambda qq: jnp.asarray(luts)), (lambda qq: T(luts))
    if engine == "inmemory":
        je = JInMemory(jh.base, jnp.asarray(codes), jlut, entry_fn=jentry)
        te = InMemoryEngine(th.base, T(codes), tlut, device="cpu", entry_fn=tentry)
        plain = InMemoryEngine(th.base, T(codes), tlut, device="cpu")
    else:
        je = JHybrid(jh.base, jnp.asarray(codes), jlut, vectors=jx, entry_fn=jentry)
        te = HybridEngine(th.base, T(codes), tlut, vectors=T(x), device="cpu",
                          entry_fn=tentry)
        plain = HybridEngine(th.base, T(codes), tlut, vectors=T(x), device="cpu")
    res = te.search(T(q), k=10, h=24)
    _assert_same_result(res, je.search(jnp.asarray(q), k=10, h=24))
    assert not torch.equal(res.hops, plain.search(T(q), k=10, h=24).hops)
    seeded = te.search(T(q), k=10, h=24, entries=4)
    _assert_same_result(seeded, je.search(jnp.asarray(q), k=10, h=24, entries=4))
    _assert_same_result(seeded, plain.search(T(q), k=10, h=24, entries=4))


@pytest.mark.parametrize("data", ["float_repeats", "int_repeats"])
def test_one_shared_knn_serves_hnsw_and_nsg(data):
    """The first 32 columns of the k=48 kNN are the k=32 kNN bit for bit,
    ties included, so HNSW's layer 0 (m=12: k=48) and NSG (k=32) can share
    one exact kNN; HNSW and NSG then give the graphs they build alone."""
    r = np.random.default_rng(21)
    if data == "float_repeats":
        x = np.repeat(_clustered(22, 200, 8), 3, axis=0)[r.permutation(600)]
    else:
        x = np.repeat(r.integers(-3, 4, (200, 8)), 3, axis=0)[r.permutation(600)]
    x = T(x.astype(np.float32))
    ids48, d48 = knn_ids(x, x, 48, block=256, exclude_self=True)
    ids32, d32 = knn_ids(x, x, 32, block=256, exclude_self=True)
    assert torch.equal(knn_prefix(ids48, 32), ids32) and torch.equal(d48[:, :32], d32)
    with pytest.raises(ValueError):
        knn_prefix(ids32, 48)
    perm = np.random.default_rng(4).permutation(600)
    alone = hnsw.build_hnsw_from_draws(x, perm, m=12)
    shared = hnsw.build_hnsw_from_draws(x, perm, m=12, knn0=ids48)
    for a, b in zip((alone.base, *alone.layers), (shared.base, *shared.layers)):
        assert torch.equal(a.neighbors, b.neighbors) and int(a.medoid) == int(b.medoid)
    g1 = nsg.build_nsg(x, r=16, k=32, search_l=24, batch=300, device="cpu")
    g2 = nsg.build_nsg(x, r=16, k=32, search_l=24, batch=300, device="cpu", knn=ids48)
    assert torch.equal(g1.neighbors, g2.neighbors) and int(g1.medoid) == int(g2.medoid)
