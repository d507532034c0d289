"""The port's recsys models and GAT vs the JAX package, on the CPU.

Params are initialised by the reference and carried across with
``repro_torch.convert``; both packages then run the same function on the
same numpy inputs. f32 compares within rtol 1e-5, atol 1e-6 unless a test
says why it needs more. ``sample_block`` is numpy on both sides and
compares bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import gnn as jgnn
from repro.models import recsys as jrs
from repro_torch import convert
from repro_torch.common.treeutil import tree_leaves
from repro_torch.configs import get_arch
from repro_torch.models import gnn, recsys

B = 16


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _params(arch, jinit, conv, seed=0):
    jcfg, tcfg = jget_arch(arch).make_reduced(), get_arch(arch).make_reduced()
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, conv(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


# --------------------------------------------------------------------------
# embedding substrate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_vs_jax(mode):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    bags = np.sort(rng.integers(0, 12, 40)).astype(np.int32)   # some bags empty
    want = jrs.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 12,
                             mode=mode)
    close(recsys.embedding_bag(T(table), T(ids), T(bags), 12, mode=mode), want)


def test_field_lookup_and_offsets_vs_jax():
    rows = (7, 3, 11, 5)
    off = recsys.field_offsets(rows, device="cpu")
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), np.asarray(jrs.field_offsets(rows)))
    table, off2 = recsys.make_mega_table(torch.Generator().manual_seed(0), rows, 4,
                                         device="cpu")
    assert table.shape == (512, 4) and torch.equal(off, off2)
    ids = np.random.default_rng(1).integers(0, 3, (9, 4)).astype(np.int32)
    close(recsys.field_lookup(table, off, T(ids)),
          jrs.field_lookup(jnp.asarray(table.numpy()), jrs.field_offsets(rows),
                           jnp.asarray(ids)))
    # DLRM's pair order: torch.triu_indices is jnp.triu_indices' row-major order
    np.testing.assert_array_equal(torch.triu_indices(27, 27, 1).numpy(),
                                  np.stack(np.asarray(jnp.triu_indices(27, k=1))))


# --------------------------------------------------------------------------
# the four recsys models
# --------------------------------------------------------------------------

def _dlrm_batch(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
            "sparse": rng.integers(0, min(cfg.row_counts), (B, cfg.n_sparse)).astype(np.int32),
            "label": (rng.random(B) < 0.3).astype(np.float32)}


def test_dlrm_forward_vs_jax():
    jcfg, tcfg, jp, tp = _params("dlrm-mlperf", jrs.init_dlrm, convert.dlrm_from_numpy)
    bt = _dlrm_batch(jcfg)
    close(recsys.dlrm_forward(tcfg, tp, T(bt["dense"]), T(bt["sparse"])),
          jrs.dlrm_forward(jcfg, jp, jnp.asarray(bt["dense"]), jnp.asarray(bt["sparse"])))


def test_deepfm_forward_vs_jax():
    jcfg, tcfg, jp, tp = _params("deepfm", jrs.init_deepfm, convert.deepfm_from_numpy)
    sparse = np.random.default_rng(3).integers(0, 50, (B, jcfg.n_fields)).astype(np.int32)
    close(recsys.deepfm_forward(tcfg, tp, T(sparse)),
          jrs.deepfm_forward(jcfg, jp, jnp.asarray(sparse)))


def test_din_forward_vs_jax():
    jcfg, tcfg, jp, tp = _params("din", jrs.init_din, convert.din_from_numpy)
    rng = np.random.default_rng(4)
    hist = rng.integers(0, jcfg.n_items, (B, jcfg.seq_len)).astype(np.int32)
    mask = np.arange(jcfg.seq_len)[None, :] < rng.integers(1, jcfg.seq_len, (B, 1))
    target = rng.integers(0, jcfg.n_items, (B,)).astype(np.int32)
    close(recsys.din_forward(tcfg, tp, T(hist), T(mask), T(target)),
          jrs.din_forward(jcfg, jp, jnp.asarray(hist), jnp.asarray(mask),
                          jnp.asarray(target)))


@pytest.fixture(scope="module")
def b4r():
    jcfg, tcfg, jp, tp = _params("bert4rec", jrs.init_bert4rec, convert.bert4rec_from_numpy)
    rng = np.random.default_rng(5)
    s, p = jcfg.seq_len, 4
    items = rng.integers(0, jcfg.n_items, (B, s)).astype(np.int32)
    pad = np.arange(s)[None, :] < rng.integers(s // 2, s + 1, (B, 1))
    pos = rng.integers(0, s // 2, (B, p)).astype(np.int32)
    labels = rng.integers(0, jcfg.n_items, (B, p)).astype(np.int32)
    labels[rng.random((B, p)) < 0.3] = -1                      # unscored positions
    items[np.arange(B)[:, None], pos] = jcfg.mask_token
    return jcfg, tcfg, jp, tp, (items, pad, pos, labels)


def test_bert4rec_encode_vs_jax(b4r):
    jcfg, tcfg, jp, tp, (items, pad, _, _) = b4r
    close(recsys.bert4rec_encode(tcfg, tp, T(items), T(pad)),
          jrs.bert4rec_encode(jcfg, jp, jnp.asarray(items), jnp.asarray(pad)), atol=1e-5)


def test_bert4rec_mlm_loss_vs_jax(b4r):
    jcfg, tcfg, jp, tp, batch = b4r
    want = jrs.bert4rec_mlm_loss(jcfg, jp, *map(jnp.asarray, batch))
    close(recsys.bert4rec_mlm_loss(tcfg, tp, *map(T, batch)), want)
    # the same loss with gradients: equal in the port to the plain call
    loss, grads = recsys.nn.value_and_grad(
        lambda p: recsys.bert4rec_mlm_loss(tcfg, p, *map(T, batch)), tp)
    close(loss, want)
    jg = jax.grad(lambda p: jrs.bert4rec_mlm_loss(jcfg, p, *map(jnp.asarray, batch)))(jp)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(grads)):
        close(b, a, atol=1e-6)


def test_bce_train_step_vs_jax():
    """One ``make_bce_train_step`` step on DLRM (JAX's jitted: op by op,
    its optimizer's many small updates take longer than the compile).
    Adam's first step moves a param by lr·g/(|g| + 1e-8), which turns on a
    gradient's last bits where |g| is near 1e-8: params are held within
    1e-5 relative where |g| ≥ 1e-5 (read from JAX's first moment,
    m = 0.1·g) and within 2·lr elsewhere."""
    jcfg, tcfg, jp, tp = _params("dlrm-mlperf", jrs.init_dlrm, convert.dlrm_from_numpy)
    bt = _dlrm_batch(jcfg, seed=6)
    jfwd = lambda p, b: jrs.dlrm_forward(jcfg, p, b["dense"], b["sparse"])
    tfwd = lambda p, b: recsys.dlrm_forward(tcfg, p, b["dense"], b["sparse"])
    _, jstep, jinit = jrs.make_bce_train_step(jfwd, None, lr=1e-2)
    _, tstep, tinit = recsys.make_bce_train_step(tfwd, None, lr=1e-2)
    jparams, jstate, jloss = jax.jit(jstep)(jp, jinit(jp), jax.tree.map(jnp.asarray, bt))
    tparams, tstate, tloss = tstep(tp, tinit(tp), {k: T(v) for k, v in bt.items()})
    close(tloss, jloss)
    jm = jax.tree.leaves(jstate.inner[0])
    for a, b, m in zip(jax.tree.leaves(jparams), tree_leaves(tparams), jm):
        a, b, g = np.asarray(a), b.numpy(), np.abs(np.asarray(m)) / 0.1
        sure = g >= 1e-5
        np.testing.assert_allclose(b[sure], a[sure], rtol=1e-5, atol=1e-7)
        assert np.all(np.abs(b - a)[~sure] <= 2e-2 + 1e-6)
    # the table's rows no id reaches get no gradient and stay where they were
    hit = np.zeros(tp["table"].shape[0], bool)
    hit[(bt["sparse"] + np.asarray(jrs.field_offsets(jcfg.row_counts))).reshape(-1)] = True
    assert torch.equal(tparams["table"][T(~hit)], tp["table"][T(~hit)])


# --------------------------------------------------------------------------
# GAT
# --------------------------------------------------------------------------

def _graph(cfg, n=40, e=160, seed=7, isolated=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 3 if isolated else n, e).astype(np.int32)  # 3 with no in-edge
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    lmask = rng.random(n) < 0.6
    emask = rng.random(e) < 0.9
    return x, src, dst, labels, lmask, emask


@pytest.fixture(scope="module")
def gat():
    return _params("gat-cora", jgnn.init_gat, convert.gat_from_numpy)


@pytest.mark.parametrize("masked", [False, True])
def test_gat_forward_and_loss_vs_jax(gat, masked):
    jcfg, tcfg, jp, tp = gat
    x, src, dst, labels, lmask, emask = _graph(jcfg)
    em = emask if masked else None
    want = jgnn.forward(jcfg, jp, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                        None if em is None else jnp.asarray(em))
    got = gnn.forward(tcfg, tp, T(x), T(src), T(dst), None if em is None else T(em))
    close(got, want, atol=1e-5)
    close(gnn.node_loss(tcfg, tp, T(x), T(src), T(dst), T(labels), T(lmask),
                        None if em is None else T(em)),
          jgnn.node_loss(jcfg, jp, *map(jnp.asarray, (x, src, dst, labels, lmask)),
                         None if em is None else jnp.asarray(em)))


def test_gat_train_step_vs_jax(gat):
    """One Adam step at the reference's lr (5e-3); params held as in
    ``test_bce_train_step_vs_jax``."""
    jcfg, tcfg, jp, tp = gat
    x, src, dst, labels, lmask, _ = _graph(jcfg, seed=8)
    _, jstep, jinit = jgnn.make_train_step(jcfg)
    _, tstep, tinit = gnn.make_train_step(tcfg)
    jparams, jstate, jloss = jax.jit(jstep)(jp, jinit(jp), *map(jnp.asarray, (
        x, src, dst, labels, lmask)))
    tparams, tstate, tloss = tstep(tp, tinit(tp), *map(T, (x, src, dst, labels, lmask)))
    close(tloss, jloss)
    jm = jax.tree.leaves(jstate.inner[0])
    for a, b, m in zip(jax.tree.leaves(jparams), tree_leaves(tparams), jm):
        a, b, g = np.asarray(a), b.numpy(), np.abs(np.asarray(m)) / 0.1
        sure = g >= 1e-5
        np.testing.assert_allclose(b[sure], a[sure], rtol=1e-5, atol=1e-7)
        assert np.all(np.abs(b - a)[~sure] <= 1e-2 + 1e-6)


def test_graph_pool_loss_vs_jax(gat):
    jcfg, tcfg, jp, tp = gat
    rng = np.random.default_rng(9)
    nb, n_per, e_per = 6, 8, 14
    x = rng.normal(size=(nb * n_per, jcfg.d_in)).astype(np.float32)
    base = np.repeat(np.arange(nb) * n_per, e_per)
    src = (rng.integers(0, n_per, nb * e_per) + base).astype(np.int32)
    dst = (rng.integers(0, n_per, nb * e_per) + base).astype(np.int32)
    gid = np.repeat(np.arange(nb), n_per).astype(np.int32)
    y = rng.integers(0, jcfg.n_classes, nb).astype(np.int32)
    want = jgnn.graph_pool_loss(jcfg, jp, *map(jnp.asarray, (x, src, dst, gid)), nb,
                                jnp.asarray(y))
    close(gnn.graph_pool_loss(tcfg, tp, *map(T, (x, src, dst, gid)), nb, T(y)), want)


@pytest.mark.parametrize("fanouts", [(3, 2), (4,)])
def test_sample_block_bit_equal(fanouts):
    rng = np.random.default_rng(10)
    n = 200
    deg = rng.integers(0, 8, n)                                # some isolated nodes
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, indptr[-1]).astype(np.int64)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    seeds = rng.choice(n, 8, replace=False)
    want = jgnn.sample_block(np.random.default_rng(11), indptr, indices, feats, labels,
                             seeds, fanouts)
    got = gnn.sample_block(np.random.default_rng(11), indptr, indices, feats, labels,
                           seeds, fanouts, device="cpu")
    for name in gnn.SampledBlock._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    # and a GAT over the block, padded edges masked
    cfg = gnn.GATConfig(name="t", d_in=16, d_hidden=4, n_heads=2, n_classes=4)
    out = gnn.forward(cfg, gnn.init_gat(torch.Generator().manual_seed(0), cfg,
                                        device="cpu"),
                      got.feats, got.src, got.dst, edge_mask=got.edge_mask)
    assert out.shape == (got.feats.shape[0], 4) and bool(torch.isfinite(out).all())
