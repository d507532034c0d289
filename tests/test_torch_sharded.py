"""The sharded engines with S > 1, port vs the JAX package, on the CPU.

* **Partition**: ``shard_bounds`` over the reference's table, and the
  partitioned Vamana build fed the JAX builder's per-shard draws.
* **Scan**: ``ShardedEngine(n_shards=4)`` against the JAX ``ShardedEngine``
  on 4 forced host devices (one subprocess for the module, results in an
  ``.npz``), with the dead-shard merge, the rerank and ``n_dist``.
* **Graph-routed**: the reference's ``ShardedGraphEngine`` does not run
  under the installed jax (its ``shard_map`` carry raises), so the port's
  S=4 engine is held to JAX ``InMemoryEngine`` (``HybridEngine`` for the
  rerank) over each ``shard_subgraph(pg, s)`` followed by JAX
  ``partial_merge``: ids and counters exactly, distances exactly on the
  ADC paths. Both layouts, seeding, pruning, budgets, the dead shard and
  the quorum; and the port's own per-shard engines bit for bit.
* **CLI**: ``serve --scenario sharded-graph --shards 4`` and the
  ``graph_part4.npz`` cache, read by either package.

Exactness: LUTs are INTEGER-valued f32 (fs4: uint8 tables with a
power-of-two scale and a bias on a 1/64 grid), so every ADC distance is
exact in any summation order and ties break to the lower index on both
sides; codes are tie-free (``codes_uniq``, all rows distinct).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.dist.fault import partial_merge as j_partial_merge
from repro.dist.fault import resolve_quorum as j_resolve_quorum
from repro.graphs.adjacency import Graph as JGraph
from repro.graphs.partition import build_partitioned_vamana as j_build_partitioned
from repro.graphs.partition import shard_bounds as j_shard_bounds
from repro.launch import serve as jserve
from repro.pq import pack as jpack
from repro.search.engine import HybridEngine as JHybrid
from repro.search.engine import InMemoryEngine as JInMemory
from repro_torch.dist.fault import partial_merge
from repro_torch.graphs.partition import (PartitionedGraph, block_diagonal,
                                          build_partitioned_vamana,
                                          build_partitioned_vamana_from_draws,
                                          shard_bounds, shard_subgraph)
from repro_torch.launch import serve as tserve
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.search import beam as tbeam
from repro_torch.search.engine import (HybridEngine, InMemoryEngine, ShardedEngine,
                                       ShardedGraphEngine, merge_shard_topk)

N, D, Q, M, K, S = 256, 32, 12, 8, 32, 4
TOPK, H = 10, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _uniq_codes(r, n, m, k):
    codes = r.integers(0, k, (n, m)).astype(np.uint8)
    while np.unique(codes, axis=0).shape[0] != n:  # pragma: no cover
        codes = r.integers(0, k, (n, m)).astype(np.uint8)
    return codes


@pytest.fixture(scope="module")
def setup():
    r = np.random.default_rng(3)
    centers = r.normal(size=(8, D)) * 2.5
    x = (centers[r.integers(0, 8, N)] + r.normal(size=(N, D))).astype(np.float32)
    q = (centers[r.integers(0, 8, Q)] + r.normal(size=(Q, D))).astype(np.float32)
    codes = _uniq_codes(r, N, M, K)
    luts = r.integers(0, 64, (Q, M, K)).astype(np.float32)
    codes4 = _uniq_codes(r, N, M, 16)
    packed = np.asarray(jpack.pack_codes(jnp.asarray(codes4)))
    ql = (r.integers(0, 256, (Q, M, 16)).astype(np.uint8),
          (2.0 ** -r.integers(0, 4, Q)).astype(np.float32),
          (r.integers(0, 64, Q) / 64).astype(np.float32))
    pg = build_partitioned_vamana(T(x), S, generator=torch.Generator().manual_seed(1),
                                  r=12, l=24, device="cpu")
    return dict(x=x, q=q, codes=codes, luts=luts, packed=packed, ql=ql, pg=pg)


def _layout(setup, layout):
    """(codes, port lut_fn, JAX lut_fn) of a layout, the LUTs fixed."""
    if layout == "fs4":
        return (setup["packed"], lambda _: QuantizedLUT(*(T(a) for a in setup["ql"])),
                lambda _: jpack.QuantizedLUT(*(jnp.asarray(a) for a in setup["ql"])))
    return (setup["codes"], lambda _: T(setup["luts"]),
            lambda _: jnp.asarray(setup["luts"]))


# --------------------------------------------------------------------------
# partition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,s", [(240, 4), (241, 4), (9, 4), (7, 7), (100, 1)])
def test_shard_bounds_match_jax(n, s):
    assert shard_bounds(n, s) == j_shard_bounds(n, s)


def _jax_vamana_draws(key, n, r, passes):
    """The draws repro.graphs.vamana.build_vamana takes from ``key``."""
    key, kinit = jax.random.split(key)
    init = np.array(jax.random.randint(kinit, (n, r), 0, n, jnp.int32))
    orders = []
    for _ in range(passes):
        key, kperm = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(kperm, n)))
    return init, orders


@pytest.mark.parametrize("n", [250, 9])
def test_partition_with_jax_draws_matches_jax(n):
    """n=250: n not divisible by 4 (63 rows a shard, 61 in the last); n=9:
    the last shard is empty. The port's build, fed the JAX builder's draws
    (one key split per non-degenerate shard), equals JAX's adjacency on
    ≥ 99% of rows with equal medoids."""
    x = np.random.default_rng(n).normal(size=(n, 16)).astype(np.float32)
    jpg = j_build_partitioned(jax.random.PRNGKey(1), jnp.asarray(x), S, r=12, l=24)
    key, draws = jax.random.PRNGKey(1), []
    for lo, hi in shard_bounds(n, S):
        if hi - lo <= 1:
            draws.append(None)
            continue
        key, ks = jax.random.split(key)
        draws.append(_jax_vamana_draws(ks, hi - lo, 12, 2))
    tpg = build_partitioned_vamana_from_draws(T(x), S, draws, r=12, l=24)
    want, got = np.asarray(jpg.neighbors), tpg.neighbors.numpy()
    assert got.shape == want.shape and tpg.n == jpg.n == n
    same = (np.sort(got, axis=-1) == np.sort(want, axis=-1)).all(axis=-1).mean()
    assert same >= 0.99, same
    np.testing.assert_array_equal(tpg.medoids.numpy(), np.asarray(jpg.medoids))
    if n == 9:
        assert tpg.shard_rows(3) == (9, 9) and (got[3] == tpg.n_local).all()


def test_partition_invariants_and_block_diagonal(setup):
    pg = setup["pg"]
    assert pg.n_shards == S and pg.n == N and pg.degree == 12
    nb, med = pg.neighbors.numpy(), pg.medoids.numpy()
    for s in range(S):
        lo, hi = pg.shard_rows(s)
        assert (nb[s] <= pg.n_local).all() and 0 <= med[s] < hi - lo
        rows = np.arange(pg.n_local)[:, None]
        assert not ((nb[s] == rows) & (nb[s] < pg.n_local)).any()
    assert shard_subgraph(pg, 1).neighbors.shape == (pg.n_local, 12)
    glob, entries = block_diagonal(pg)
    nl = pg.n_local
    assert glob.shape == (S * nl, 12) and entries.tolist() == [
        int(med[s]) + s * nl for s in range(S)]
    g = glob.numpy().reshape(S, nl, 12)
    for s in range(S):   # no edge leaves its block; sentinels are S·n_local
        real = g[s] < S * nl
        assert ((g[s][real] >= s * nl) & (g[s][real] < (s + 1) * nl)).all()
        np.testing.assert_array_equal(np.where(real, g[s] - s * nl, nl), nb[s])
    with pytest.raises(ValueError, match="cannot split"):
        build_partitioned_vamana(T(setup["x"][:3]), 4, generator=torch.Generator(),
                                 device="cpu")


# --------------------------------------------------------------------------
# the scan engine at S = 4 vs the JAX engine on 4 forced host devices
# --------------------------------------------------------------------------

SCAN_CASES = [("u8", N, False), ("u8", N, True), ("fs4", N, False), ("fs4", N, True),
              ("u8", 250, False), ("u8", 250, True)]
DEAD = [True, False, True, True]

_SCAN_SUBPROC = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.pq import pack as jpack
from repro.search.engine import ShardedEngine

assert len(jax.devices()) == 4
z = np.load({path!r})
out = {{}}
for i, (layout, n, rerank) in enumerate({cases!r}):
    if layout == "fs4":
        codes = jnp.asarray(z["packed"][:n])
        ql = jpack.QuantizedLUT(*(jnp.asarray(z[k]) for k in ("ql0", "ql1", "ql2")))
        lut_fn = lambda qq: ql
    else:
        codes = jnp.asarray(z["codes"][:n])
        luts = jnp.asarray(z["luts"])
        lut_fn = lambda qq: luts
    eng = ShardedEngine(codes, lut_fn, vectors=jnp.asarray(z["x"][:n]) if rerank else None)
    assert eng.n_shards == 4
    for tag, alive in (("all", None), ("dead", {dead!r})):
        res = eng.search(jnp.asarray(z["q"]), k={topk}, alive=alive)
        out[f"{{i}}_{{tag}}_ids"] = np.asarray(res.ids)
        out[f"{{i}}_{{tag}}_dists"] = np.asarray(res.dists)
        out[f"{{i}}_{{tag}}_n_dist"] = np.asarray(res.n_dist)
        out[f"{{i}}_{{tag}}_degraded"] = np.asarray(res.degraded)
    out[f"{{i}}_memory"] = np.asarray(eng.memory_bytes())
np.savez({out!r}, **out)
print("SCAN_OK")
"""


@pytest.fixture(scope="module")
def jax_scan(setup, tmp_path_factory):
    """Every scan case through the JAX ``ShardedEngine`` on 4 forced host
    devices, in ONE subprocess (this process keeps its one device)."""
    d = tmp_path_factory.mktemp("scan")
    path, out = str(d / "in.npz"), str(d / "out.npz")
    np.savez(path, x=setup["x"], q=setup["q"], codes=setup["codes"],
             luts=setup["luts"], packed=setup["packed"],
             **{f"ql{i}": a for i, a in enumerate(setup["ql"])})
    code = _SCAN_SUBPROC.format(path=path, out=out, cases=SCAN_CASES, dead=DEAD,
                                topk=TOPK)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    assert "SCAN_OK" in r.stdout, (r.stdout[-1500:], r.stderr[-3000:])
    return dict(np.load(out))


@pytest.mark.parametrize("case", range(len(SCAN_CASES)))
def test_sharded_scan_4_shards_vs_jax_4_devices(setup, jax_scan, case):
    layout, n, rerank = SCAN_CASES[case]
    codes, lut_fn, _ = _layout(setup, layout)
    eng = ShardedEngine(T(codes[:n]), lut_fn, vectors=T(setup["x"][:n]) if rerank else None,
                        device="cpu", n_shards=S)
    for tag, alive in (("all", None), ("dead", DEAD)):
        res = eng.search(T(setup["q"]), k=TOPK, alive=alive)
        np.testing.assert_array_equal(res.ids.numpy(), jax_scan[f"{case}_{tag}_ids"])
        np.testing.assert_allclose(res.dists.numpy(), jax_scan[f"{case}_{tag}_dists"],
                                   rtol=0 if not rerank else 1e-5)
        np.testing.assert_array_equal(res.n_dist.numpy(), jax_scan[f"{case}_{tag}_n_dist"])
        assert res.degraded == bool(jax_scan[f"{case}_{tag}_degraded"]) == (tag == "dead")
    # n_dist counts real rows (250 = 63 + 63 + 63 + 61), memory is unpadded
    assert int(eng.search(T(setup["q"]), k=TOPK).n_dist[0]) == n
    assert eng.memory_bytes() == int(jax_scan[f"{case}_memory"])


def test_sharded_scan_one_launch_equals_per_shard_scans_and_merge(setup):
    """The S=4 scan's sorted distances equal the one-shard scan's, and
    ``merge_shard_topk`` equals ``partial_merge`` with every shard alive."""
    from repro_torch.search.engine import sharded_adc_scan

    codes, lut_fn, _ = _layout(setup, "u8")
    one = ShardedEngine(T(codes), lut_fn, device="cpu", n_shards=1).search(
        T(setup["q"]), k=TOPK)
    four = ShardedEngine(T(codes), lut_fn, device="cpu", n_shards=S).search(
        T(setup["q"]), k=TOPK)
    torch.testing.assert_close(four.dists, one.dists, rtol=0, atol=0)
    gids, dists = sharded_adc_scan(T(codes), lut_fn(None), n_shards=S, k=TOPK)
    assert gids.shape == (S, Q, TOPK)
    mi, md = merge_shard_topk(gids, dists, TOPK)
    pm = partial_merge(list(gids), list(dists), [True] * S, TOPK)
    torch.testing.assert_close(mi.to(torch.int32), pm.ids, rtol=0, atol=0)
    torch.testing.assert_close(md, pm.dists, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the graph-routed engine at S = 4
# --------------------------------------------------------------------------

def _jax_shards(setup, layout, kw, rerank):
    """JAX ``InMemoryEngine`` (``HybridEngine`` with ``rerank``) over each
    ``shard_subgraph``, local ids masked to global as the reference's
    ``_mask_to_global`` does: per shard (ids, dists) and (Q, S) counters."""
    pg = setup["pg"]
    nl = pg.n_local
    codes, _, jlut = _layout(setup, layout)
    ids, dists, counters = [], [], {k: [] for k in ("hops", "n_dist", "rounds",
                                                    "truncated")}
    for s in range(S):
        g = JGraph(jnp.asarray(pg.neighbors[s].numpy()), jnp.asarray(int(pg.medoids[s]),
                                                                     jnp.int32))
        c = jnp.asarray(codes[s * nl:(s + 1) * nl])
        if rerank:
            eng = JHybrid(g, c, jlut, vectors=jnp.asarray(setup["x"][s * nl:(s + 1) * nl]))
        else:
            eng = JInMemory(g, c, jlut)
        res = eng.search(jnp.asarray(setup["q"]), k=TOPK, h=H, **kw)
        li, ld = np.asarray(res.ids), np.asarray(res.dists)
        ok = (li < min(N - s * nl, nl)) & np.isfinite(ld)
        ids.append(np.where(ok, li + s * nl, -1))
        dists.append(np.where(ok, ld, np.inf))
        for k in counters:
            counters[k].append(np.asarray(getattr(res, k)))
    return ids, dists, {k: np.stack(v, axis=1) for k, v in counters.items()}


def _merged(ids, dists, counters, alive):
    m = j_partial_merge(ids, dists, alive, TOPK)
    a = np.asarray(alive)
    return dict(ids=np.asarray(m.ids), dists=np.asarray(m.dists),
                hops=counters["hops"][:, a].sum(1), n_dist=counters["n_dist"][:, a].sum(1),
                rounds=counters["rounds"][:, a].max(1),
                truncated=counters["truncated"][:, a].any(1))


def _assert_result(res, want, exact_dists=True):
    np.testing.assert_array_equal(res.ids.numpy(), want["ids"])
    np.testing.assert_allclose(res.dists.numpy(), want["dists"],
                               rtol=0 if exact_dists else 1e-5)
    for k in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(getattr(res, k).numpy(), want[k], err_msg=k)


GRAPH_CASES = [("u8", {}, False), ("u8", {"entries": 4, "prune_eps": 0.2}, False),
               ("u8", {"max_rounds": 3}, False), ("u8", {"expand": 2}, False),
               ("u8", {}, True), ("fs4", {}, False),
               ("fs4", {"entries": 4, "prune_eps": 0.2, "max_rounds": 4}, False),
               ("fs4", {}, True)]


@pytest.mark.parametrize("case", range(len(GRAPH_CASES)))
def test_sharded_graph_4_shards_vs_jax_per_shard_inmemory(setup, case):
    layout, kw, rerank = GRAPH_CASES[case]
    codes, lut_fn, _ = _layout(setup, layout)
    eng = ShardedGraphEngine(setup["pg"], T(codes), lut_fn, device="cpu", n_shards=S,
                             vectors=T(setup["x"]) if rerank else None)
    ids, dists, counters = _jax_shards(setup, layout, kw, rerank)
    res = eng.search(T(setup["q"]), k=TOPK, h=H, **kw)
    _assert_result(res, _merged(ids, dists, counters, [True] * S),
                   exact_dists=not rerank)
    assert not res.degraded
    if "max_rounds" in kw:
        assert int(res.rounds.max()) <= kw["max_rounds"] and bool(res.truncated.any())
    if case == 0:
        # a dead shard: its row range vanishes, counters over the survivors
        rd = eng.search(T(setup["q"]), k=TOPK, h=H, alive=DEAD)
        _assert_result(rd, _merged(ids, dists, counters, DEAD))
        nl = setup["pg"].n_local
        assert rd.degraded and not ((rd.ids >= nl) & (rd.ids < 2 * nl)).any()
        # the quorum: shard 2 over the deadline is dropped (3 of 4 ≥ majority)
        lat = [0.001, 0.001, 0.2, 0.001]
        decision = j_resolve_quorum([True] * S, lat, 0.05, None)
        assert list(decision.alive) == [True, True, False, True]
        rq = eng.search(T(setup["q"]), k=TOPK, h=H, deadline_s=0.05, shard_latency_s=lat)
        _assert_result(rq, _merged(ids, dists, counters, list(decision.alive)))
        assert rq.degraded
        # a quorum of 4 outranks the deadline: every shard is waited for
        rw = eng.search(T(setup["q"]), k=TOPK, h=H, deadline_s=0.05,
                        shard_latency_s=lat, quorum=4)
        _assert_result(rw, _merged(ids, dists, counters, [True] * S))
        # every shard dead: sentinel rows, zero-work counters
        rz = eng.search(T(setup["q"]), k=TOPK, h=H, alive=[False] * S)
        assert rz.degraded and bool((rz.ids == -1).all()) and int(rz.hops.sum()) == 0


@pytest.mark.parametrize("layout,kw", [("u8", {}), ("u8", {"entries": 4, "prune_eps": 0.2}),
                                       ("u8", {"max_rounds": 2, "expand": 2}),
                                       ("fs4", {"entries": 4, "prune_eps": 0.2}),
                                       ("fs4", {"max_n_dist": 40})])
def test_sharded_graph_equals_port_per_shard_inmemory(setup, layout, kw):
    """The port's lockstep S=4 engine against the port's own
    ``InMemoryEngine`` per shard + ``partial_merge``, bit for bit, on float
    LUTs (no integer grid needed: both sides run the same kernels' plain
    versions on the same rows)."""
    pg, nl = setup["pg"], setup["pg"].n_local
    codes, lut_fn, _ = _layout(setup, layout)
    if layout == "u8":
        luts = T(np.random.default_rng(7).random((Q, M, K)).astype(np.float32))
        lut_fn = lambda _: luts
    eng = ShardedGraphEngine(pg, T(codes), lut_fn, device="cpu", n_shards=S)
    res = eng.search(T(setup["q"]), k=TOPK, h=H, **kw)
    ids, dists, counters = [], [], []
    for s in range(S):
        mem = InMemoryEngine(shard_subgraph(pg, s), T(codes[s * nl:(s + 1) * nl]), lut_fn,
                             device="cpu")
        r = mem.search(T(setup["q"]), k=TOPK, h=H, **kw)
        ok = (r.ids < nl) & torch.isfinite(r.dists)
        ids.append(torch.where(ok, r.ids.long() + s * nl, -1))
        dists.append(torch.where(ok, r.dists, float("inf")))
        counters.append(r)
    m = partial_merge(ids, dists, [True] * S, TOPK)
    torch.testing.assert_close(res.ids, m.ids, rtol=0, atol=0)
    torch.testing.assert_close(res.dists, m.dists, rtol=0, atol=0)
    for name, red in (("hops", sum), ("n_dist", sum)):
        torch.testing.assert_close(getattr(res, name),
                                   red(getattr(c, name) for c in counters), rtol=0, atol=0)
    torch.testing.assert_close(res.rounds, torch.stack([c.rounds for c in counters]).amax(0),
                               rtol=0, atol=0)
    assert torch.equal(res.truncated, torch.stack([c.truncated for c in counters]).any(0))


def test_lanes_per_query_runs_shard_beams_in_one_batch(setup):
    """``beam_search(lanes_per_query=S)`` over the block-diagonal graph: lane
    q·S + s equals shard s's own beam for query q (ids offset by s·n_local)
    and every distance call is ONE call for the batch; ``lanes_per_query=1``
    is the classic beam."""
    pg, nl = setup["pg"], setup["pg"].n_local
    codes_p = np.concatenate([setup["codes"], np.zeros((1, M), np.uint8)])
    glob, entries = block_diagonal(pg)
    calls = []
    fn = tbeam.make_adc_dist_fn(T(codes_p))

    def counting(luts, ids):
        calls.append(tuple(ids.shape))
        return fn(luts, ids)
    luts = T(setup["luts"])
    res = tbeam.beam_search(glob, entries.repeat(Q), luts, counting, h=H,
                            lanes_per_query=S)
    assert all(c[0] == Q for c in calls) and len(calls) == int(res.rounds.max()) + 1
    for s in range(S):
        local = np.concatenate([setup["codes"][s * nl:(s + 1) * nl],
                                np.zeros((1, M), np.uint8)])
        one = tbeam.beam_search(pg.neighbors[s], pg.medoids[s], luts,
                                tbeam.make_adc_dist_fn(T(local)), h=H)
        lane = slice(s, None, S)
        got = res.ids[lane].long()
        np.testing.assert_array_equal(torch.where(got < S * nl, got - s * nl, nl).numpy(),
                                      one.ids.numpy())
        torch.testing.assert_close(res.dists[lane], one.dists, rtol=0, atol=0)
        for name in ("hops", "n_dist", "rounds", "truncated"):
            assert torch.equal(getattr(res, name)[lane], getattr(one, name)), name
    g0 = shard_subgraph(pg, 0)
    c0 = T(np.concatenate([setup["codes"][:nl], np.zeros((1, M), np.uint8)]))
    a = tbeam.beam_search(g0.neighbors, g0.medoid, luts, tbeam.make_adc_dist_fn(c0), h=H)
    b = tbeam.beam_search(g0.neighbors, g0.medoid, luts, tbeam.make_adc_dist_fn(c0), h=H,
                          lanes_per_query=1)
    for name in ("ids", "dists", "hops", "n_dist", "rounds", "truncated"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_sharded_graph_engine_validates_and_counts_memory(setup):
    pg = setup["pg"]
    codes, lut_fn, _ = _layout(setup, "u8")
    with pytest.raises(ValueError, match="shards"):
        ShardedGraphEngine(pg, T(codes), lut_fn, device="cpu", n_shards=2)
    with pytest.raises(ValueError, match="rows"):
        ShardedGraphEngine(pg, T(codes[:-3]), lut_fn, device="cpu", n_shards=S)
    eng = ShardedGraphEngine(pg, T(codes), lut_fn, device="cpu", n_shards=S)
    assert eng.memory_bytes() == codes.size + pg.neighbors.numel() * 4
    # n not divisible by S: padding rows are never returned
    pg250 = build_partitioned_vamana(T(setup["x"][:250]), S,
                                     generator=torch.Generator().manual_seed(2),
                                     r=12, l=24, device="cpu")
    e250 = ShardedGraphEngine(pg250, T(codes[:250]), lut_fn, device="cpu", n_shards=S,
                              vectors=T(setup["x"][:250]))
    res = e250.search(T(setup["q"]), k=TOPK, h=H, entries=4)
    assert bool((res.ids < 250).all()) and bool((res.ids >= 0).all())
    assert e250.memory_bytes() == 250 * M + pg250.neighbors.numel() * 4 + 250 * D * 4


# --------------------------------------------------------------------------
# serve --scenario sharded-graph and the partition cache
# --------------------------------------------------------------------------

def test_partition_cache_is_read_by_either_package(setup, tmp_path):
    x = setup["x"][:64]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jpg = jserve.build_or_load_partitioned_graph(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 jpath, S, 8, 16)
    got = tserve.build_or_load_partitioned_graph(torch.Generator(), T(x), jpath, S, 8, 16)
    np.testing.assert_array_equal(got.neighbors.numpy(), np.asarray(jpg.neighbors))
    np.testing.assert_array_equal(got.medoids.numpy(), np.asarray(jpg.medoids))
    tpg = tserve.build_or_load_partitioned_graph(torch.Generator().manual_seed(0), T(x),
                                                 tpath, S, 8, 16)
    back = jserve.build_or_load_partitioned_graph(jax.random.PRNGKey(5), jnp.asarray(x),
                                                  tpath, S, 8, 16)
    assert back.n == tpg.n == 64
    np.testing.assert_array_equal(np.asarray(back.neighbors), tpg.neighbors.numpy())
    np.testing.assert_array_equal(np.asarray(back.medoids), tpg.medoids.numpy())


def test_serve_sharded_graph_cli_builds_caches_and_drills_chaos(tmp_path, capsys):
    from repro_torch.launch import train as ttrain

    d = str(tmp_path)
    ttrain.main(["--dataset", "unit-test", "--steps", "2", "--m", "4", "--k", "16",
                 "--batch", "32", "--routing-queries", "8", "--graph-r", "8",
                 "--graph-l", "16", "--beam", "16", "--checkpoint-every", "4",
                 "--quiet", "--device", "cpu", "--ckpt-dir", d])
    argv = ["--ckpt-dir", d, "--scenario", "sharded-graph", "--shards", "4",
            "--graph-r", "8", "--graph-l", "16", "--device", "cpu"]
    capsys.readouterr()
    first = tserve.main(argv)
    assert os.path.exists(os.path.join(d, "graph_part4.npz"))
    second = tserve.main(argv)
    chaos = tserve.main(argv + ["--chaos", "dead=1,straggler=2,straggler_ms=50",
                                "--deadline-ms", "20"])
    out = capsys.readouterr().out
    assert out.count("[serve] partition built in") == 1
    assert out.count("[serve] partition loaded from") == 2
    assert "graph-routed over 4 shard(s), 500 rows/shard, R=8" in out
    assert out.count("[serve] sharded-graph: recall@10=") == 3
    assert "[serve] chaos: 1/4 shard(s) dead, stragglers [2] at 50ms" in out
    torch.testing.assert_close(first["result"].ids, second["result"].ids, rtol=0, atol=0)
    assert not first["result"].degraded and chaos["result"].degraded
    nl = first["engine"].n_local
    ids = chaos["result"].ids
    assert not bool(((ids >= nl) & (ids < 3 * nl)).any())   # shards 1 and 2 dropped
    jpg = jserve.build_or_load_partitioned_graph(
        jax.random.PRNGKey(0), jnp.zeros((2000, 32)), os.path.join(d, "graph_part4.npz"),
        4, 8, 16)
    assert isinstance(first["engine"].graph, PartitionedGraph) and jpg.n == 2000
    np.testing.assert_array_equal(np.asarray(jpg.neighbors),
                                  first["engine"].graph.neighbors.numpy())
