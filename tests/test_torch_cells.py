"""The port's dry-run cells (``repro_torch/launch/cells.py``, ``dryrun.py``)
against the reference's (``repro/launch/cells.py``), and the graph-routed
scatter body ``search.engine.sharded_graph_topk`` against its engine.

The JAX cells are built on ``AbstractMesh``es (no devices): their ``meta``
and the per-device argument bytes — ``NamedSharding.shard_shape`` of every
argument under the cell's in-shardings — must equal the port's for all 47
cells on both production meshes.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, NamedSharding

from repro.launch import cells as jcells

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.graphs.partition import build_partitioned_vamana, shard_subgraph
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.pq import base as tbase, train_pq
from repro_torch.search import engine as se

MESHES = {"1pod_16x16": ((16, 16), ("data", "model")),
          "2pod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the reference test's cells (tests/test_dryrun_cells.py) — the two
# sharded_graph ones are not meta-runnable (the beam syncs the host)
REF_CELLS = [("gat-cora", "molecule"), ("deepfm", "serve_p99"), ("rpq", "adc_bulk"),
             ("rpq", "sharded_graph_fs4"), ("rpq", "sharded_graph_wide"),
             ("granite-moe-1b-a400m", "long_500k")]
META_RUNNABLE_RPQ = [("rpq", "quant_train"), ("rpq", "serve_1m"), ("rpq", "encode_bulk")]
# per-device argument bytes worked out from the reference's cells
KNOWN_BYTES = {
    ("deepfm", "serve_p99"): (4_396_292, 4_393_796),
    ("rpq", "adc_bulk"): (16_839_728, 16_808_480),
    ("rpq", "sharded_graph_fs4"): (598_940, 333_332),
    ("granite-moe-1b-a400m", "train_4k"): (53_727_236, 53_465_092),
    ("llama3-405b", "long_500k"): (4_219_535_368, 3_691_053_064),
    ("gat-cora", "molecule"): (1_051_476, 1_117_892),
}
# the reference's quant_train takes a PRNG key (uint32[2]) that the port's
# step has no counterpart for (its Gumbel noise comes from torch's RNG)
NO_COUNTERPART_BYTES = {("rpq", "quant_train"): 8}


def _jmesh(name):
    return AbstractMesh(*MESHES[name])


def _tmesh(name):
    return tmesh.make_mesh(*MESHES[name])


def _jax_bytes(args, shardings) -> int:
    total = [0]

    def add(sh, sub):
        for leaf in jax.tree_util.tree_leaves(sub):
            shape = sh.shard_shape(leaf.shape) if sh is not None else leaf.shape
            total[0] += math.prod(shape) * leaf.dtype.itemsize

    jax.tree_util.tree_map(add, shardings, args,
                           is_leaf=lambda x: isinstance(x, NamedSharding) or x is None)
    return total[0]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_every_cell_meta_and_argument_bytes_equal_the_reference(mesh_name):
    cells = tcells.all_cells()
    assert cells == jcells.all_cells() and len(cells) == 47
    jm, tm = _jmesh(mesh_name), _tmesh(mesh_name)
    col = list(MESHES).index(mesh_name)
    for arch, shape in cells:
        jc = jcells.build_cell(arch, shape, jm)
        tc = tcells.build_cell(arch, shape, tm)
        assert tc.meta == jc.meta, (arch, shape)
        got = dryrun.per_device_bytes(tc.args, tc.in_shardings)
        want = _jax_bytes(jc.args, jc.in_shardings)
        assert got + NO_COUNTERPART_BYTES.get((arch, shape), 0) == want, (arch, shape)
        if (arch, shape) in KNOWN_BYTES:
            assert got == KNOWN_BYTES[(arch, shape)][col]


def _shapes(tree):
    return [tuple(x.shape) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch,shape", [c for c in REF_CELLS if not c[1].startswith("sharded")]
                         + META_RUNNABLE_RPQ)
def test_meta_run_output_shapes_equal_eval_shape(arch, shape):
    jm, tm = _jmesh("2pod_2x16x16"), _tmesh("2pod_2x16x16")
    tc = tcells.build_cell(arch, shape, tm)
    _, out, _ = dryrun.count_flops(tc)
    jc = jcells.build_cell(arch, shape, jm)
    with jax.sharding.use_abstract_mesh(jm):
        want = jax.eval_shape(jc.fn, *jc.args)
    got = [tuple(t.shape) for t in dryrun._tensors(out)]
    assert got == _shapes(want)


@pytest.mark.parametrize("shape", ["sharded_graph", "sharded_graph_fs4",
                                   "sharded_graph_wide"])
def test_beam_cells_declare_the_outputs_their_step_returns(shape):
    """The beam's cells cannot run on meta (and the reference's
    ``eval_shape`` of them fails on jax 0.9: shard_map carry types); their
    declared outputs equal a real CPU run of the same step on a small
    input of the cell's layouts (4 shards of 40 rows, 6 queries)."""
    from repro_torch.pq.pack import QuantizedLUT

    tm = _tmesh("1pod_16x16")
    cell = tcells.build_cell("rpq", shape, tm)
    assert "live.any()" in cell.host_sync
    g = torch.Generator().manual_seed(0)
    nbrs, med, codes, luts = cell.args
    s, nl, q = 4, 40, 6
    ints = lambda shp, hi, dt: torch.randint(0, hi, shp, generator=g, dtype=dt)
    small = (ints((s, nl, nbrs.shape[2]), nl, torch.int32), ints((s,), nl, torch.int32),
             ints((s, nl, codes.shape[2]), 256, torch.uint8))
    if isinstance(luts, QuantizedLUT):
        small += (QuantizedLUT(ints((q, 16, 16), 256, torch.uint8),
                               torch.rand(q, generator=g) + 0.01, torch.rand(q, generator=g)),)
    else:
        small += (torch.rand((q, 16, 256), generator=g),)
    out = cell.fn(*small)
    declared = cell.out_shapes
    assert [t.dtype for t in out] == [t.dtype for t in declared]
    assert [tuple(t.shape) for t in out] == [(q, 10), (q, 10), (s, q), (s, q), (s, q)]
    assert [tuple(t.shape) for t in declared] == [(256, 10), (256, 10)] + [(256, 256)] * 3


def _small_lm(kind: str, seq: int, batch: int, **cfg_overrides):
    arch = "llama3-405b"
    cfg = dataclasses.replace(get_arch(arch).make_reduced(), **cfg_overrides)
    shape = ShapeSpec(f"small_{kind}", kind, dict(seq_len=seq, global_batch=batch))
    return tcells._lm_cell(arch, shape, tmesh.make_mesh((1, 1), ("data", "model")), cfg=cfg)


@pytest.mark.parametrize("case", ["train_blocks", "train_layers", "prefill"])
def test_flop_count_extrapolation_equals_the_full_count(case):
    """The dry run counts an LM train step at one and two layer units on
    one microbatch (and every LM step in 2×2 attention chunks); on a
    4-layer reduced LM that equals the count of the step as built."""
    chunks = dict(attn_q_chunk=8, attn_kv_chunk=8)
    if case == "train_blocks":
        cell = _small_lm("train", 32, 8, n_layers=4, microbatches=2, remat=True,
                         layer_block=2, **chunks)
        assert cell.layer_unit == 2
    elif case == "train_layers":
        cell = _small_lm("train", 32, 8, n_layers=4, microbatches=2, remat=True,
                         layer_block=1, **chunks)
        assert cell.layer_unit == 1
    else:
        cell = _small_lm("prefill", 64, 4, n_layers=4, **chunks)
    full, _ = dryrun._count(cell)
    scaled, _, how = dryrun.count_flops(cell)
    assert full > 0 and scaled == full, how


def test_dryrun_cli_rpq_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --device cpu --arch rpq``, through
    its ``main``: 14 records, all ok, exit code 0."""
    import json

    out = tmp_path / "dry.json"
    assert dryrun.main(["--device", "cpu", "--arch", "rpq", "--out", str(out)]) == 0
    assert "14/14 records ok" in capsys.readouterr().out
    recs = json.load(open(out))
    assert len(recs) == 14 and all(x["ok"] for x in recs)
    for x in recs:
        assert x["collectives"] is None and x["memory"]["temp_bytes"] is None
        assert x["fits"] and x["memory"]["argument_bytes"] > 0
        assert (x["cost"]["flops_global"] is None) == x["shape"].startswith("sharded_graph")


def _partition(n=300, d=16, s=4, r=8):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(12, d)).astype(np.float32))
    pg = build_partitioned_vamana(x, s, generator=torch.Generator().manual_seed(0),
                                  r=r, l=16, device="cpu")
    model = train_pq(x, 4, 16, generator=torch.Generator().manual_seed(1), iters=4,
                     device="cpu")
    return x, q, pg, model


@pytest.mark.parametrize("rerank", [False, True])
def test_sharded_graph_topk_is_the_engines_body(rerank):
    """``sharded_graph_topk`` / ``_serve`` on an S=4 stacked partition equal
    the engine's answer and, shard by shard, S standalone beams over the
    shards' subgraphs: ids and counters bit for bit."""
    x, q, pg, model = _partition()
    s, n_local = pg.n_shards, pg.n_local
    codes = tbase.encode(model, x)
    lut_fn = lambda qq: tbase.build_lut(model, qq)
    luts = lut_fn(q)
    k, h = 5, 16
    codes_stk = se._stack_rows(codes, s, n_local)
    if rerank:
        out = se.sharded_graph_serve(pg.neighbors, pg.medoids, codes_stk,
                                     se._stack_rows(x, s, n_local), luts, q, k=k, h=h,
                                     n_valid=pg.n)
    else:
        out = se.sharded_graph_topk(pg.neighbors, pg.medoids, codes_stk, luts, k=k, h=h,
                                    n_valid=pg.n)
    gids, dists, hops, n_dist, rounds, trunc = out
    assert gids.shape == (s, q.shape[0], k) and hops.shape == (s, q.shape[0])
    eng = se.ShardedGraphEngine(pg, codes, lut_fn, vectors=x if rerank else None,
                                n_shards=s, device="cpu")
    res = eng.search(q, k=k, h=h)
    merged = se.merge_shard_topk(gids, dists, k)
    np.testing.assert_array_equal(res.ids.numpy(), merged[0].numpy())
    np.testing.assert_array_equal(res.hops.numpy(), hops.sum(0).numpy())
    np.testing.assert_array_equal(res.n_dist.numpy(), n_dist.sum(0).numpy())
    np.testing.assert_array_equal(res.rounds.numpy(), rounds.amax(0).numpy())
    for i in range(s):
        one = se.InMemoryEngine(shard_subgraph(pg, i), codes_stk[i], lut_fn, device="cpu")
        r1 = one.search(q, k=h if rerank else k, h=h)
        np.testing.assert_array_equal(hops[i].numpy(), r1.hops.numpy())
        np.testing.assert_array_equal(n_dist[i].numpy(), r1.n_dist.numpy())
        np.testing.assert_array_equal(rounds[i].numpy(), r1.rounds.numpy())
        if not rerank:
            loc = r1.ids.long()
            want = torch.where(loc < n_local, loc + i * n_local, -1)
            want = torch.where(want < pg.n, want, -1)
            np.testing.assert_array_equal(gids[i].numpy(), want.numpy())
