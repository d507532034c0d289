"""Port graph builders vs the JAX package, on the CPU: exact kNN ids,
id-exact RobustPrune on identical tables, and a Vamana build fed the JAX
builder's own random draws."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.graphs.adjacency import find_medoid as j_find_medoid
from repro.graphs.knn import knn_ids as j_knn_ids
from repro.graphs.prune import prune_from_vectors as j_prune_from_vectors
from repro.graphs.prune import robust_prune as j_robust_prune
from repro.graphs.vamana import build_vamana as j_build_vamana
from repro_torch.graphs.adjacency import find_medoid as t_find_medoid
from repro_torch.graphs.knn import knn_ids as t_knn_ids
from repro_torch.graphs.prune import prune_from_vectors as t_prune_from_vectors
from repro_torch.graphs.prune import robust_prune as t_robust_prune
from repro_torch.graphs.vamana import build_vamana, build_vamana_from_draws


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _clustered(seed, n, d, nc=12):
    r = np.random.default_rng(seed)
    centers = r.normal(size=(nc, d)) * 2.0
    return (centers[r.integers(0, nc, n)]
            + r.normal(size=(n, d))).astype(np.float32)


def _jax_vamana_draws(key, n, r, passes):
    """The draws repro.graphs.vamana.build_vamana takes from ``key``."""
    key, kinit = jax.random.split(key)
    init = np.array(jax.random.randint(kinit, (n, r), 0, n, jnp.int32))
    orders = []
    for _ in range(passes):
        key, kperm = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(kperm, n)))
    return init, orders


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_ids_match_jax(exclude_self):
    x = _clustered(1, 700, 16)
    q = x[:130] if exclude_self else _clustered(2, 130, 16)
    jid, jd = j_knn_ids(jnp.asarray(x), jnp.asarray(q), 10, block=64,
                        exclude_self=exclude_self)
    tid, td = t_knn_ids(T(x), T(q), 10, block=64, exclude_self=exclude_self)
    assert tid.dtype == torch.int32
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-3)


def test_find_medoid_matches_jax():
    x = _clustered(3, 900, 8)
    assert int(t_find_medoid(T(x))) == int(j_find_medoid(jnp.asarray(x)))
    assert int(t_find_medoid(T(x), sample=100)) == int(
        j_find_medoid(jnp.asarray(x), sample=100))


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_robust_prune_id_exact(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    b, c, r, n = 40, 30, 8, 500
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    ids[:, 5:9] = ids[:, 0:4]                               # duplicates
    ids[rng.random((b, c)) < 0.15] = n                      # padding
    pts = rng.normal(size=(b, c, 4)).astype(np.float32)
    pair = ((pts[:, :, None] - pts[:, None, :]) ** 2).sum(-1).astype(np.float32)
    dv = rng.random((b, c)).astype(np.float32) * 8.0
    dv[ids == n] = np.inf
    want = j_robust_prune(jnp.asarray(ids), jnp.asarray(dv), jnp.asarray(pair),
                          alpha, r, n)
    got = t_robust_prune(T(ids), T(dv), T(pair), alpha, r, n)
    assert got.dtype == torch.int32 and got.shape == (b, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prune_from_vectors_matches_jax(monkeypatch):
    # small chunks: the pairwise table is assembled from several row chunks
    monkeypatch.setattr("repro_torch.graphs.prune.PAIR_CHUNK_ELEMS", 5000)
    rng = np.random.default_rng(4)
    n, d = 300, 12
    xp = np.concatenate([_clustered(5, n, d), np.zeros((1, d), np.float32)])
    nodes = rng.permutation(n)[:64].astype(np.int32)
    cand = rng.integers(0, n + 1, (64, 40)).astype(np.int32)
    cand[cand == nodes[:, None]] = n
    want = j_prune_from_vectors(jnp.asarray(xp), jnp.asarray(nodes),
                                jnp.asarray(cand), 1.2, 10, n)
    got = t_prune_from_vectors(T(xp), T(nodes), T(cand), 1.2, 10, n)
    same = np.mean(np.all(got.numpy() == np.asarray(want), axis=1))
    assert same >= 0.99


def test_build_vamana_with_jax_draws_matches_jax():
    x = _clustered(6, 700, 16)
    r, l, passes, batch = 12, 24, 2, 256                    # padded batches
    jg = j_build_vamana(jax.random.PRNGKey(0), jnp.asarray(x), r=r, l=l,
                        passes=passes, batch=batch)
    init, orders = _jax_vamana_draws(jax.random.PRNGKey(0), len(x), r, passes)
    tg = build_vamana_from_draws(T(x), init, orders, r=r, l=l, batch=batch)
    assert int(tg.medoid) == int(jg.medoid)
    jn, tn = np.asarray(jg.neighbors), tg.neighbors.numpy()
    assert tn.shape == jn.shape and tg.neighbors.dtype == torch.int32
    same = np.mean([set(a.tolist()) == set(b.tolist()) for a, b in zip(tn, jn)])
    assert same >= 0.99


def test_build_vamana_from_generator_is_a_valid_graph():
    x = T(_clustered(7, 400, 8))
    g = build_vamana(x, generator=torch.Generator().manual_seed(0), r=10, l=20,
                     batch=128, device="cpu")
    nb = g.neighbors
    n = x.shape[0]
    assert nb.shape == (n, 10) and int(nb.min()) >= 0 and int(nb.max()) <= n
    assert not bool((nb == torch.arange(n)[:, None]).any())  # no self loops
    assert float((nb < n).sum(1).float().mean()) > 5.0


def test_from_lists_degree_stats_symmetrize_match_jax():
    from repro.graphs.adjacency import degree_stats as j_degree_stats
    from repro.graphs.adjacency import from_lists as j_from_lists
    from repro.graphs.adjacency import symmetrize as j_symmetrize
    from repro_torch.graphs.adjacency import degree_stats, from_lists, symmetrize

    rng = np.random.default_rng(4)
    lists = [rng.choice(50, rng.integers(0, 9), replace=False) for _ in range(50)]
    jg, tg = j_from_lists(lists, 6, 3), from_lists(lists, 6, 3, device="cpu")
    np.testing.assert_array_equal(tg.neighbors.numpy(), np.asarray(jg.neighbors))
    assert int(tg.medoid) == int(jg.medoid)
    assert degree_stats(tg) == j_degree_stats(jg)
    nb = np.asarray(jg.neighbors)
    np.testing.assert_array_equal(symmetrize(nb, 8), j_symmetrize(nb, 8))


def test_find_medoid_with_a_generator_samples_rows():
    """Keyed medoid: the closest-to-centroid row among ``sample`` rows drawn
    without replacement (the port draws them from a torch.Generator, JAX
    from its key, so the rows differ; the rule does not)."""
    x = _clustered(6, 3000, 16)
    g = torch.Generator().manual_seed(0)
    med = int(t_find_medoid(T(x), sample=256, generator=g))
    idx = torch.randperm(3000, generator=torch.Generator().manual_seed(0))[:256].numpy()
    c = x.mean(axis=0)
    assert med == idx[np.argmin(((x[idx] - c) ** 2).sum(axis=1))]
    # at N <= sample it is the keyless medoid, as in JAX
    assert int(t_find_medoid(T(x[:200]), generator=g)) == int(
        j_find_medoid(jnp.asarray(x[:200]), key=jax.random.PRNGKey(0)))
