"""The port's sharding rules (``repro_torch/dist/sharding.py``) against
JAX's (``repro/dist/sharding.py``), spec for spec.

For every arch, the parameter tree and the optimizer-state tree — JAX's
from ``jax.eval_shape``, the port's from its ``meta``-device init — get
the same spec on every leaf, keyed by the same ``keystr`` path, on the two
production meshes (as ``AbstractMesh``es: no devices needed) and a (1, 1)
host mesh; each leaf's per-device block equals ``NamedSharding``'s. The
KV-cache spec, the shard-index arithmetic and the engines' row order are
held too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro import configs as jconfigs
from repro.common import adam as j_adam, constant_schedule as j_const
from repro.dist import sharding as jshd

from repro_torch import configs as tconfigs
from repro_torch.common import adam as t_adam, constant_schedule as t_const
from repro_torch.dist import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.search.engine import _stack_rows

MESHES = {
    "1pod_16x16": ((16, 16), ("data", "model")),
    "2pod_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "host_1x1": ((1, 1), ("data", "model")),
}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), tmesh.make_mesh(sizes, names)


def test_production_and_host_meshes():
    assert tmesh.make_production_mesh() == tmesh.make_mesh((16, 16), ("data", "model"))
    two = tmesh.make_production_mesh(multi_pod=True)
    assert two.axis_names == ("pod", "data", "model")
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.data_axes(two) == ("pod", "data")
    host = tmesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert tmesh.hbm_capacity_bytes("cpu") == int(tmesh.HBM_BYTES)


def _jax_trees(arch):
    spec = jconfigs.get_arch(arch)
    cfg = spec.make_config()
    key = jax.random.PRNGKey(0)
    if spec.family == "lm":
        from repro.models import transformer as tf
        params = jax.eval_shape(lambda: tf.init_lm(key, cfg))
        opt = jax.eval_shape(tf.make_train_step(cfg).opt_init, params)
    elif spec.family == "gnn":
        from repro.models import gnn
        params = jax.eval_shape(lambda: gnn.init_gat(key, cfg))
        opt = jax.eval_shape(j_adam(j_const(5e-3)).init, params)
    elif spec.family == "recsys":
        from repro.models import recsys as rs
        init = {"dlrm-mlperf": rs.init_dlrm, "deepfm": rs.init_deepfm,
                "din": rs.init_din, "bert4rec": rs.init_bert4rec}[arch]
        params = jax.eval_shape(lambda: init(key, cfg))
        opt = jax.eval_shape(j_adam(j_const(1e-3)).init, params)
    else:
        from repro.core import quantizer as Q
        q = cfg.quant
        params = jax.eval_shape(lambda: Q.init_params(q, jnp.zeros((q.m, q.k, q.dsub))))
        opt = jax.eval_shape(j_adam(j_const(1e-3)).init, params)
    return spec.family, params, opt


def _port_trees(arch):
    spec = tconfigs.get_arch(arch)
    cfg = spec.make_config()
    gen, meta = torch.Generator(), torch.device("meta")
    if spec.family == "lm":
        from repro_torch.models import transformer as tf
        params = tf.init_lm(gen, cfg, device=meta)
        return params, tf.make_train_step(cfg).opt_init(params)
    if spec.family == "gnn":
        from repro_torch.models import gnn
        params = gnn.init_gat(gen, cfg, device=meta)
        return params, t_adam(t_const(5e-3)).init(params)
    if spec.family == "recsys":
        from repro_torch.models import recsys as rs
        init = {"dlrm-mlperf": rs.init_dlrm, "deepfm": rs.init_deepfm,
                "din": rs.init_din, "bert4rec": rs.init_bert4rec}[arch]
        params = init(gen, cfg, device=meta)
        return params, t_adam(t_const(1e-3)).init(params)
    from repro_torch.core import quantizer as Q
    q = cfg.quant
    params = Q.init_params(q, torch.empty((q.m, q.k, q.dsub), device=meta))
    return params, t_adam(t_const(1e-3)).init(params)


def _rule(shd, family, arch, mesh):
    """The family's path-keyed rule, as launch/cells.py applies it to both
    trees (GNN and RPQ trees replicate)."""
    if family == "lm":
        return shd.lm_param_rule(mesh)
    if family == "recsys":
        return shd.recsys_table_rule(mesh, "all" if arch == "dlrm-mlperf" else "model")
    replicated = tshd.P() if shd is tshd else JP()
    return lambda p, l: replicated


def _jax_specs(tree, rule):
    specs = jshd.tree_pspecs(tree, rule)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    leaves = dict((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(tree)[0])
    return {jax.tree_util.keystr(k): (tuple(v), leaves[jax.tree_util.keystr(k)])
            for k, v in flat}


def _port_specs(tree, rule):
    specs = tshd.tree_paths(tshd.tree_pspecs(tree, rule))
    leaves = tshd.tree_paths(tree)
    return {k: (tuple(v), leaves[k]) for k, v in specs.items()}


@pytest.fixture(scope="module")
def trees():
    return {a: (_jax_trees(a), _port_trees(a)) for a in tconfigs.list_archs()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(jconfigs.list_archs()))
def test_param_and_opt_specs_leaf_for_leaf(trees, arch, mesh_name):
    (family, jparams, jopt), (tparams, topt) = trees[arch]
    jm, tm = _meshes(mesh_name)
    jrule, trule = _rule(jshd, family, arch, jm), _rule(tshd, family, arch, tm)
    for jtree, ttree in ((jparams, tparams), (jopt, topt)):
        want, got = _jax_specs(jtree, jrule), _port_specs(ttree, trule)
        assert sorted(got) == sorted(want)
        for path, (jspec, jleaf) in want.items():
            tspec, tleaf = got[path]
            assert tspec == jspec, (path, tspec, jspec)
            assert tuple(tleaf.shape) == tuple(jleaf.shape), path
            assert (tshd.Sharding(tm, tshd.P(*tspec)).shard_shape(tleaf.shape)
                    == NamedSharding(jm, JP(*jspec)).shard_shape(jleaf.shape)), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_shape_and_its_refusal_match_named_sharding(mesh_name):
    jm, tm = _meshes(mesh_name)
    names = jm.axis_names
    cases = [((512, 64), (names, None)), ((64, 48), (names[-1], names[0])),
             ((10, 32), (names[-1],)), ((32,), ()), ((6, 4, 32), (None, None, names))]
    for shape, spec in cases:
        try:
            want = NamedSharding(jm, JP(*spec)).shard_shape(shape)
        except ValueError:
            with pytest.raises(ValueError):
                tshd.Sharding(tm, tshd.P(*spec)).shard_shape(shape)
            continue
        assert tshd.Sharding(tm, tshd.P(*spec)).shard_shape(shape) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_family_specs_and_cache_spec(mesh_name):
    jm, tm = _meshes(mesh_name)
    pairs = [(jshd.lm_batch_spec(jm), tshd.lm_batch_spec(tm)),
             (jshd.gnn_edge_spec(jm), tshd.gnn_edge_spec(tm)),
             (jshd.rpq_rows_spec(jm), tshd.rpq_rows_spec(tm)),
             (jshd.rpq_shard_stack_spec(jm), tshd.rpq_shard_stack_spec(tm)),
             (jshd.rpq_shard_stack_spec(jm, 1), tshd.rpq_shard_stack_spec(tm, 1))]
    for batch in (1, 128):
        for seq in (32768, 524288):
            pairs.append((jshd.lm_cache_spec(jm, batch, seq),
                          tshd.lm_cache_spec(tm, batch, seq)))
    for want, got in pairs:
        assert tuple(got) == tuple(want)
    assert tshd.row_axes(tm) == jshd.row_axes(jm)
    for axes in (None, "model", tshd.row_axes(tm)):
        assert tshd.axis_size(tm, axes) == jshd.axis_size(jm, axes)
        assert tshd._fit(tm, axes, 48) == jshd._fit(jm, axes, 48)


def test_p_normalises_entries_as_jax():
    for entries in [(("data",),), ((),), (("pod", "data"), None), (None, "model"), ()]:
        assert tuple(tshd.P(*entries)) == tuple(JP(*entries))


@pytest.mark.parametrize("mesh_name", ["1pod_16x16", "2pod_2x16x16"])
def test_flat_shard_index_matches_jax_axis_index(mesh_name):
    jm, tm = _meshes(mesh_name)
    names = jm.axis_names
    for axes in (names, names[1:], names[-1:], tuple(reversed(names))):
        fn = lambda _: jshd.flat_shard_index(jm, axes)
        for a in reversed(names):
            fn = jax.vmap(fn, axis_name=a)
        want = np.asarray(fn(jnp.zeros(tuple(jm.shape[a] for a in names))))
        got = np.zeros_like(want)
        for coords in np.ndindex(*want.shape):
            got[coords] = tshd.flat_shard_index(tm, axes, dict(zip(names, coords)))
        np.testing.assert_array_equal(got, want)


def test_engine_row_order_is_the_row_sharding():
    """Shard s of the port's engines (``_stack_rows``) is the row block
    that ``rpq_rows_spec`` gives the device of flat index s."""
    tm = tmesh.make_mesh((2, 4), ("data", "model"))
    n, s = 37, 8
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    n_local = -(-n // s)
    stk = _stack_rows(x, s, n_local)
    padded = torch.cat([x, x.new_zeros((s * n_local - n, 3))])
    spec = tshd.rpq_rows_spec(tm)
    block = tshd.Sharding(tm, spec).shard_shape(padded.shape)[0]
    assert block == n_local
    for coords in np.ndindex(2, 4):
        idx = tshd.flat_shard_index(tm, tshd.row_axes(tm), dict(zip(tm.axis_names, coords)))
        np.testing.assert_array_equal(stk[idx].numpy(),
                                      padded[idx * block:(idx + 1) * block].numpy())
