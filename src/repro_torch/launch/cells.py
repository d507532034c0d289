"""Dry-run cells: (arch × input shape × mesh) → a step on meta
tensors. Port of ``repro/launch/cells.py``.

Each cell bundles a step function that calls the port's own functions,
its arguments as tensors on the ``meta`` device (shapes and dtypes, no
memory), and in/out shardings from ``dist/sharding.py``.
``launch/dryrun.py`` checks every cell: per-device bytes under the
shardings, a run of the step on meta (output shapes, matmul FLOPs) and,
for the ``rpq`` cells, a real run on the card.

Uneven-dimension note: sharding requires divisible dims, so edge lists /
candidate pools / code rows are padded to multiples of the mesh's device
count (the real data pipeline does the same padding), and LM vocabs use
``cfg.vocab_padded``.

The reference compiles each cell for a TPU mesh. The port runs on one
card and has no partitioner, so the shardings here are data: they give
each device's share of every argument, and the step runs unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.common import adam, constant_schedule
from repro_torch.configs import get_arch
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import Mesh, data_axes

META = torch.device("meta")

# why the beam's cells cannot run on the meta device
BEAM_HOST_SYNC = ("search/beam.py ends its round loop on the host "
                  "(bool(live.any()) each round)")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _n_dp(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def _n_dev(mesh: Mesh) -> int:
    return _n_dp(mesh) * mesh.shape["model"]


@dataclasses.dataclass
class Cell:
    """One (arch, shape) step on one mesh.

    ``host_sync`` says why the step cannot run on the meta device (its
    outputs are then ``out_shapes``, declared meta tensors). ``param_pspecs``
    are the LM train cell's parameter specs (the reference pins them inside
    its step; one card has nothing to pin). ``rebuild(**overrides)`` builds
    the same LM cell from a changed config (``n_layers``, ``microbatches``,
    attention chunks), and ``count_overrides`` are the changes under which
    ``dryrun.count_flops`` runs it: attention in 2×2 chunks, which changes
    no matmul FLOP (no chunk is skipped)."""
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    meta: dict = dataclasses.field(default_factory=dict)
    param_pspecs: Any = None
    host_sync: Optional[str] = None
    out_shapes: Any = None
    n_layers: Optional[int] = None
    layer_unit: int = 1
    microbatches: int = 1
    rebuild: Optional[Callable[..., "Cell"]] = None
    count_overrides: dict = dataclasses.field(default_factory=dict)


# ==========================================================================
# LM family
# ==========================================================================

def _lm_cell(arch_id: str, shape, mesh: Mesh, cfg=None, **overrides) -> Cell:
    from repro_torch.models import transformer as tf

    spec = get_arch(arch_id)
    cfg = cfg if cfg is not None else spec.make_config()
    base_cfg = cfg
    dims = shape.dims
    dp = data_axes(mesh)
    n_dp = _n_dp(mesh)
    # fit the microbatch count to the mesh (per-microbatch batch must
    # divide the dp axes); record the activation batch placement
    if shape.kind == "train":
        mb = cfg.microbatches
        while mb > 1 and dims["global_batch"] % (mb * n_dp):
            mb //= 2
        cfg = dataclasses.replace(cfg, microbatches=max(mb, 1),
                                  act_batch_axes=tuple(dp))
    else:
        cfg = dataclasses.replace(cfg, act_batch_axes=tuple(dp)
                                  if dims["global_batch"] % n_dp == 0 else None)
    full = cfg
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    bspec = shd.named(mesh, shd.lm_batch_spec(mesh))
    params = tf.init_lm(torch.Generator(), cfg, device=META)
    meta = {"params": int(full.param_count),
            "active_params": int(full.active_param_count)}
    lb = full.layer_block
    unit = lb if (shape.kind == "train" and full.remat and lb > 1
                  and full.n_layers % lb == 0) else 1
    b, s = dims["global_batch"], dims["seq_len"]
    chunk = max(full.attn_kv_chunk, s // 2)
    common = dict(n_layers=full.n_layers, layer_unit=unit,
                  rebuild=lambda **o: _lm_cell(arch_id, shape, mesh, cfg=base_cfg, **o),
                  count_overrides=(dict(attn_q_chunk=chunk, attn_kv_chunk=chunk)
                                   if full.attn_kv_chunk > 0 else {}))

    if shape.kind == "train":
        pspecs = shd.tree_pspecs(params, shd.lm_param_rule(mesh))
        fns = tf.make_train_step(cfg)
        opt = fns.opt_init(params)
        p_sh, o_sh = shd.lm_shardings(mesh, cfg, params, opt)
        rows = b // (full.microbatches // cfg.microbatches)
        toks = _meta((rows, s), torch.int32)
        # a train step returns its params and optimizer state in their own
        # shapes and a scalar loss
        outs = (params, opt, _meta((), torch.float32))
        return Cell(arch_id, shape.name, fns.train_step, (params, opt, toks, toks),
                    (p_sh, o_sh, bspec, bspec), (p_sh, o_sh, shd.named(mesh, P())), meta={**meta, "tokens": b * s, "mode": "train"},
                    param_pspecs=pspecs, out_shapes=outs,
                    microbatches=full.microbatches, **common)

    p_sh, _ = shd.lm_shardings(mesh, cfg, params, params)

    if shape.kind == "prefill":
        toks = _meta((b, s), torch.int32)
        cache_spec = shd.named(mesh, shd.lm_cache_spec(mesh, b, s))

        def fn(params, tokens):
            return tf.prefill(cfg, params, tokens, max_len=s)

        out_sh = (shd.named(mesh, P(dp, "model")),
                  tf.KVCache(k=cache_spec, v=cache_spec, length=shd.named(mesh, P())))
        return Cell(arch_id, shape.name, fn, (params, toks), (p_sh, bspec), out_sh,
                    meta={**meta, "tokens": b * s, "mode": "prefill"}, **common)

    # decode (decode_32k, long_500k): one token against a seq_len KV cache
    cache_p = shd.lm_cache_spec(mesh, b, s)
    cache_spec = shd.named(mesh, cache_p)
    kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    cache = tf.KVCache(k=_meta(kv, cfg.dtype), v=_meta(kv, cfg.dtype),
                       length=_meta((), torch.int32))
    cache_sh = tf.KVCache(k=cache_spec, v=cache_spec, length=shd.named(mesh, P()))
    # the decode attention's sequence placement follows the cache's
    cfg = dataclasses.replace(cfg, act_seq_axis=cache_p[2])
    tok_spec = shd.named(mesh, P(dp) if b % n_dp == 0 else P())
    toks = _meta((b,), torch.int32)

    def fn(params, cache, tokens):
        return tf.decode_step(cfg, params, cache, tokens)

    logit_sh = shd.named(mesh, P(dp, "model") if b % n_dp == 0 else P(None, "model"))
    return Cell(arch_id, shape.name, fn, (params, cache, toks),
                (p_sh, cache_sh, tok_spec), (logit_sh, cache_sh),
                meta={**meta, "tokens": b, "kv_len": s, "mode": "decode"}, **common)


# ==========================================================================
# GNN family (gat-cora): 4 shapes with different graph regimes
# ==========================================================================

def _adam_step(optimizer, loss_fn):
    from repro_torch.models.layers import value_and_grad

    def step(params, opt_state, *batch):
        loss, g = value_and_grad(lambda p: loss_fn(p, *batch), params)
        params, opt_state = optimizer.update(g, opt_state, params)
        return params, opt_state, loss
    return step


def _gnn_cell(arch_id: str, shape, mesh: Mesh) -> Cell:
    from repro_torch.models import gnn

    spec = get_arch(arch_id)
    dims = shape.dims
    n_dev = _n_dev(mesh)
    edge_spec = shd.named(mesh, shd.gnn_edge_spec(mesh))
    rep = shd.named(mesh, P())
    optimizer = adam(constant_schedule(5e-3))

    def tree_rep(tree):
        return shd.tree_shardings(mesh, tree, lambda p, l: P())

    def cell(fn, args, meta):
        params, opt = args[0], args[1]
        p_sh, o_sh = tree_rep(params), tree_rep(opt)
        return Cell(arch_id, shape.name, fn, args,
                    (p_sh, o_sh, rep, edge_spec, edge_spec, edge_spec, rep, rep),
                    (p_sh, o_sh, rep), meta=meta)

    def init(cfg):
        params = gnn.init_gat(torch.Generator(), cfg, device=META)
        return params, optimizer.init(params)

    if shape.name in ("full_graph_sm", "ogb_products"):
        n, e = dims["n_nodes"], dims["n_edges"]
        d_feat = dims.get("d_feat", 1433)
        cfg = dataclasses.replace(spec.make_config(), d_in=d_feat,
                                  n_classes=47 if shape.name == "ogb_products" else 7)
        e_pad = _pad_to(e, n_dev)

        def loss(p, x, src, dst, emask, labels, lmask):
            return gnn.node_loss(cfg, p, x, src, dst, labels, lmask, edge_mask=emask)

        args = (*init(cfg), _meta((n, d_feat), torch.float32),
                _meta((e_pad,), torch.int32), _meta((e_pad,), torch.int32),
                _meta((e_pad,), torch.bool), _meta((n,), torch.int32),
                _meta((n,), torch.bool))
        return cell(_adam_step(optimizer, loss), args,
                    {"mode": "train", "edges": e, "nodes": n})

    if shape.name == "minibatch_lg":
        # Reddit-scale fanout-sampled block (d_feat=602, fanout 15×10)
        cfg = dataclasses.replace(spec.make_config(), d_in=602, n_classes=41)
        b = dims["batch_nodes"]
        f1, f2 = dims["fanout"]
        n_slots = _pad_to(b * (1 + f1 + f1 * f2) * 2, n_dev)
        e_slots = _pad_to(b * f1 + b * f1 * f2, n_dev)

        def loss(p, feats, src, dst, emask, seed_local, labels):
            h = gnn.forward(cfg, p, feats, src, dst, edge_mask=emask)
            sel = h[seed_local.long()]
            logp = torch.log_softmax(sel.float(), -1)
            return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))

        args = (*init(cfg), _meta((n_slots, 602), torch.float32),
                _meta((e_slots,), torch.int32), _meta((e_slots,), torch.int32),
                _meta((e_slots,), torch.bool), _meta((b,), torch.int32),
                _meta((b,), torch.int32))
        return cell(_adam_step(optimizer, loss), args,
                    {"mode": "train", "edges": e_slots, "nodes": n_slots})

    # molecule: batched small graphs, graph-level prediction
    cfg = dataclasses.replace(spec.make_config(), d_in=64, n_classes=2)
    b, n_per, e_per = dims["batch"], dims["n_nodes"], dims["n_edges"]
    n = _pad_to(b * n_per, n_dev)
    e = _pad_to(b * e_per, n_dev)

    def loss(p, x, src, dst, emask, graph_id, y):
        return gnn.graph_pool_loss(cfg, p, x, src, dst, graph_id, b, y, edge_mask=emask)

    args = (*init(cfg), _meta((n, 64), torch.float32),
            _meta((e,), torch.int32), _meta((e,), torch.int32), _meta((e,), torch.bool),
            _meta((n,), torch.int32), _meta((b,), torch.int32))
    return cell(_adam_step(optimizer, loss), args,
                {"mode": "train", "edges": e, "nodes": n})


# ==========================================================================
# Recsys family
# ==========================================================================

def _recsys_batch(arch_id: str, cfg, batch: int) -> dict:
    if arch_id == "dlrm-mlperf":
        return {"dense": _meta((batch, cfg.n_dense), torch.float32),
                "sparse": _meta((batch, cfg.n_sparse), torch.int32),
                "label": _meta((batch,), torch.float32)}
    if arch_id == "deepfm":
        return {"sparse": _meta((batch, cfg.n_fields), torch.int32),
                "label": _meta((batch,), torch.float32)}
    if arch_id == "din":
        return {"hist": _meta((batch, cfg.seq_len), torch.int32),
                "hist_mask": _meta((batch, cfg.seq_len), torch.bool),
                "target": _meta((batch,), torch.int32),
                "label": _meta((batch,), torch.float32)}
    # bert4rec: MLM batch (20 masked positions of 200)
    return {"items": _meta((batch, cfg.seq_len), torch.int32),
            "pad_mask": _meta((batch, cfg.seq_len), torch.bool),
            "mlm_positions": _meta((batch, 20), torch.int32),
            "mlm_labels": _meta((batch, 20), torch.int32)}


def _recsys_forward(arch_id: str, cfg):
    from repro_torch.models import recsys as rs

    if arch_id == "dlrm-mlperf":
        return lambda p, b: rs.dlrm_forward(cfg, p, b["dense"], b["sparse"])
    if arch_id == "deepfm":
        return lambda p, b: rs.deepfm_forward(cfg, p, b["sparse"])
    if arch_id == "din":
        return lambda p, b: rs.din_forward(cfg, p, b["hist"], b["hist_mask"], b["target"])
    return None  # bert4rec handled via its MLM loss


def _recsys_loss(arch_id: str, cfg):
    from repro_torch.models import recsys as rs

    if arch_id == "bert4rec":
        return lambda p, b: rs.bert4rec_mlm_loss(cfg, p, b["items"], b["pad_mask"],
                                                 b["mlm_positions"], b["mlm_labels"])
    fwd = _recsys_forward(arch_id, cfg)
    return lambda p, b: rs.bce_loss(fwd(p, b), b["label"])


def _recsys_cell(arch_id: str, shape, mesh: Mesh) -> Cell:
    from repro_torch.models import recsys as rs

    spec = get_arch(arch_id)
    cfg = spec.make_config()
    dims = shape.dims
    dp = data_axes(mesh)
    table_axes = "all" if arch_id == "dlrm-mlperf" else "model"
    init_fn = {"dlrm-mlperf": rs.init_dlrm, "deepfm": rs.init_deepfm,
               "din": rs.init_din, "bert4rec": rs.init_bert4rec}[arch_id]
    params = init_fn(torch.Generator(), cfg, device=META)
    bsp = lambda leaf: shd.named(mesh, P(dp, *([None] * (leaf.dim() - 1))))

    if shape.kind == "train":
        batch = dims["batch"]
        optimizer = adam(constant_schedule(1e-3))
        opt = optimizer.init(params)
        p_sh, o_sh = shd.recsys_shardings(mesh, params, opt, table_axes=table_axes)
        batch_in = _recsys_batch(arch_id, cfg, batch)
        b_sh = {k: bsp(v) for k, v in batch_in.items()}
        return Cell(arch_id, shape.name, _adam_step(optimizer, _recsys_loss(arch_id, cfg)),
                    (params, opt, batch_in), (p_sh, o_sh, b_sh),
                    (p_sh, o_sh, shd.named(mesh, P())),
                    meta={"mode": "train", "batch": batch})

    if shape.kind == "serve":
        batch = dims["batch"]
        p_sh, _ = shd.recsys_shardings(mesh, params, params, table_axes=table_axes)
        if arch_id == "bert4rec":
            @torch.no_grad()
            def fn(params, b):
                h = rs.bert4rec_encode(cfg, params, b["items"], b["pad_mask"])
                return (h[:, -1] @ params["item_emb"].T).float()
            keep = ("items", "pad_mask")
        else:
            fwd = _recsys_forward(arch_id, cfg)
            fn = torch.no_grad()(lambda params, b: fwd(params, b))
            keep = tuple(k for k in _recsys_batch(arch_id, cfg, 1) if k != "label")
        batch_in = {k: v for k, v in _recsys_batch(arch_id, cfg, batch).items() if k in keep}
        b_sh = {k: bsp(v) for k, v in batch_in.items()}
        return Cell(arch_id, shape.name, fn, (params, batch_in), (p_sh, b_sh), None,
                    meta={"mode": "serve", "batch": batch})

    # retrieval_cand: 1 query × 1M candidates (exact-dot baseline path)
    n_cand = _pad_to(dims["n_candidates"], _n_dev(mesh))
    d_emb = {"dlrm-mlperf": 128, "deepfm": 10, "din": 18, "bert4rec": 64}[arch_id]

    def fn(cand_emb, query):
        return rs.score_candidates_exact(query, cand_emb, k=100)

    cand_sh = shd.named(mesh, shd.rpq_rows_spec(mesh))
    return Cell(arch_id, shape.name, fn,
                (_meta((n_cand, d_emb), torch.float32), _meta((d_emb,), torch.float32)),
                (cand_sh, shd.named(mesh, P())), None,
                meta={"mode": "retrieval", "n_candidates": n_cand, "d_emb": d_emb})


# ==========================================================================
# RPQ (the paper's system)
# ==========================================================================

def quant_train_step(qcfg, optimizer):
    """The reference cell's quantizer step: triplet + routing losses
    through the Gumbel straight-through quantizer (``pq_pairwise`` forward
    and its backward), mixed by the learned ``log_alpha``, one Adam update.
    The three triplet arms share one Gumbel draw, as the reference's share
    one key."""
    from repro_torch.core import quantizer as Q
    from repro_torch.models.layers import value_and_grad

    def fn(params, opt_state, trip_x, route_q, route_cand, route_label):
        b = trip_x.shape[0]
        bq, hh, d = route_cand.shape
        g_t = Q.gumbel_noise((b, qcfg.m, qcfg.k), generator=None, device=trip_x.device)
        g_r = Q.gumbel_noise((bq * hh, qcfg.m, qcfg.k), generator=None,
                             device=trip_x.device)

        def loss_fn(p):
            xa = Q.quantize_st(qcfg, p, trip_x[:, 0], noise=g_t)
            xp = Q.quantize_st(qcfg, p, trip_x[:, 1], noise=g_t)
            xn = Q.quantize_st(qcfg, p, trip_x[:, 2], noise=g_t)
            dpd = torch.sum((xa - xp) ** 2, -1)
            dnd = torch.sum((xa - xn) ** 2, -1)
            scale = (torch.mean(dpd) + 1e-9).detach()
            ln = torch.mean(torch.clamp(1.0 + (dpd - dnd) / scale, min=0.0))
            xq = Q.quantize_st(qcfg, p, route_cand.reshape(bq * hh, d),
                               noise=g_r).reshape(bq, hh, d)
            r = Q.rotation_matrix(qcfg, p)
            qrot = route_q @ r.T
            dd = torch.sum((xq - qrot[:, None, :]) ** 2, -1)
            logits = -dd / (torch.std(dd, correction=0) + 1e-9).detach()
            logp = torch.log_softmax(logits, -1)
            lr_ = -torch.mean(torch.gather(logp, 1, route_label.long()[:, None]))
            s = p.log_alpha
            return lr_ + torch.exp(-s) * ln + s

        loss, g = value_and_grad(loss_fn, params)
        params, opt_state = optimizer.update(g, opt_state, params)
        return params, opt_state, loss

    return fn


def _rpq_cell(arch_id: str, shape, mesh: Mesh) -> Cell:
    from repro_torch.core import quantizer as Q
    from repro_torch.search import engine as se

    spec = get_arch(arch_id)
    qcfg = spec.make_config().quant
    dp = data_axes(mesh)
    dims = shape.dims
    n_dev = _n_dev(mesh)
    params = Q.init_params(qcfg, _meta((qcfg.m, qcfg.k, qcfg.dsub), torch.float32))
    p_sh = shd.rpq_param_spec(mesh, params)
    rep = shd.named(mesh, P())

    if shape.name == "quant_train":
        b, rb, h = dims["batch"], dims["routing_batch"], dims["h"]
        optimizer = adam(constant_schedule(1e-3))
        opt = optimizer.init(params)
        o_sh = shd.tree_shardings(mesh, opt, lambda p, l: P())
        args = (params, opt, _meta((b, 3, qcfg.dim), torch.float32),
                _meta((rb, qcfg.dim), torch.float32),
                _meta((rb, h, qcfg.dim), torch.float32), _meta((rb,), torch.int32))
        bspec = lambda nd: shd.named(mesh, P(dp, *([None] * (nd - 1))))
        return Cell(arch_id, shape.name, quant_train_step(qcfg, optimizer), args,
                    (p_sh, o_sh, bspec(3), bspec(2), bspec(3), bspec(1)),
                    (p_sh, o_sh, rep), meta={"mode": "train", "batch": b})

    rows = shd.named(mesh, shd.rpq_rows_spec(mesh))

    if shape.name == "encode_bulk":
        n = _pad_to(dims["batch"], n_dev)

        def fn(params, x):
            return Q.encode(qcfg, params, x)

        return Cell(arch_id, shape.name, fn,
                    (params, _meta((n, qcfg.dim), torch.float32)),
                    (p_sh, rows), rows, meta={"mode": "serve", "n": n})

    if shape.name == "adc_bulk":
        # scatter-gather ADC: each shard's LOCAL top-k, then the merge
        n = _pad_to(dims["n_codes"], n_dev)
        qb = dims["query_batch"]
        kk = 10

        def fn(codes, luts):
            gids, dists = se.sharded_adc_scan(codes, luts, n_shards=n_dev, k=kk)
            return se.merge_shard_topk(gids, dists, kk)

        return Cell(arch_id, shape.name, fn,
                    (_meta((n, qcfg.m), torch.uint8),
                     _meta((qb, qcfg.m, qcfg.k), torch.float32)),
                    (rows, rep), None,
                    meta={"mode": "retrieval", "n_codes": n, "queries": qb})

    if shape.name in ("sharded_graph", "sharded_graph_fs4", "sharded_graph_wide"):
        # graph-ROUTED scatter-gather: every shard beam-searches its OWN
        # subgraph (search/engine.sharded_graph_topk, the body
        # ShardedGraphEngine serves with); fs4 feeds packed 4-bit codes and
        # a QuantizedLUT; _wide the frontier-batched beam (expand=4, R=64)
        from repro_torch.pq.pack import QuantizedLUT, packed_width

        n = _pad_to(dims["n_base"], n_dev)
        qb, kk, hh, rr = dims["query_batch"], dims["k"], dims["h"], dims["r"]
        ee = dims.get("expand", 1)
        n_local = n // n_dev
        fs4 = shape.name.endswith("_fs4")

        def fn(neighbors, medoids, codes, luts):
            gids, dists, hops, ndist, rounds, _trunc = se.sharded_graph_topk(
                neighbors, medoids, codes, luts, k=kk, h=hh, max_steps=4 * hh,
                expand=ee)
            ids, ds = se.merge_shard_topk(gids, dists, kk)
            return ids, ds, hops, ndist, rounds

        if fs4:
            m_codes = packed_width(qcfg.m)
            luts = QuantizedLUT(lut=_meta((qb, qcfg.m, 16), torch.uint8),
                                scale=_meta((qb,), torch.float32),
                                bias=_meta((qb,), torch.float32))
            luts_sh = QuantizedLUT(lut=rep, scale=rep, bias=rep)
        else:
            m_codes = qcfg.m
            luts = _meta((qb, qcfg.m, qcfg.k), torch.float32)
            luts_sh = rep
        rows3 = shd.named(mesh, shd.rpq_shard_stack_spec(mesh))
        shards1 = shd.named(mesh, shd.rpq_shard_stack_spec(mesh, 1))
        outs = (_meta((qb, kk), torch.int64), _meta((qb, kk), torch.float32),
                *(_meta((n_dev, qb), torch.int32) for _ in range(3)))
        return Cell(arch_id, shape.name, fn,
                    (_meta((n_dev, n_local, rr), torch.int32),
                     _meta((n_dev,), torch.int32),
                     _meta((n_dev, n_local, m_codes), torch.uint8), luts),
                    (rows3, shards1, rows3, luts_sh), None,
                    meta={"mode": "serve", "n_base": n, "queries": qb, "beam_h": hh,
                          "graph_r": rr, "expand": ee, "layout": "fs4" if fs4 else "u8"},
                    host_sync=BEAM_HOST_SYNC, out_shapes=outs)

    # serve_1m: scatter-gather ADC + LOCAL exact rerank per shard, then a
    # global top-k merge (DiskANN-style shortlist, faiss-style distribution)
    n = _pad_to(dims["n_base"], n_dev)
    qb = dims["query_batch"]
    kk = dims["k"]

    def fn(codes, vectors, luts, queries):
        gids, dists = se.sharded_adc_serve(codes, vectors, luts, queries,
                                           n_shards=n_dev, k=kk, shortlist=4 * kk)
        return se.merge_shard_topk(gids, dists, kk)

    return Cell(arch_id, shape.name, fn,
                (_meta((n, qcfg.m), torch.uint8), _meta((n, qcfg.dim), torch.float32),
                 _meta((qb, qcfg.m, qcfg.k), torch.float32),
                 _meta((qb, qcfg.dim), torch.float32)),
                (rows, rows, rep, rep), None,
                meta={"mode": "serve", "n_base": n, "queries": qb})


# ==========================================================================
# dispatcher
# ==========================================================================

def build_cell(arch_id: str, shape_name: str, mesh: Mesh) -> Cell:
    spec = get_arch(arch_id)
    shape = next(s for s in spec.shapes if s.name == shape_name)
    if spec.family == "lm":
        return _lm_cell(arch_id, shape, mesh)
    if spec.family == "gnn":
        return _gnn_cell(arch_id, shape, mesh)
    if spec.family == "recsys":
        return _recsys_cell(arch_id, shape, mesh)
    if spec.family == "rpq":
        return _rpq_cell(arch_id, shape, mesh)
    raise KeyError(spec.family)


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import list_archs
    return [(a, s.name) for a in list_archs() for s in get_arch(a).shapes]
