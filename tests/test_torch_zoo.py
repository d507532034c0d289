"""The model zoo's substrate on the port vs the JAX package, on the CPU: the
arch registry and its configs, the token and index streams, the optimizer
options, the param converters, and the ``examples/arch_zoo_torch.py``
twin end to end.

The token stream, the index stream and every registry field compare
exactly (dtypes mapped by name). The optimizers run three updates on a
mixed f32/bf16 tree from the same numpy inputs in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import common as jcommon
from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.data import pipeline as jpipe
from repro.data import tokens as jtokens
from repro.models import gnn as jgnn
from repro.models import recsys as jrs
from repro.models import transformer as jtf
from repro_torch import common as tcommon
from repro_torch import convert
from repro_torch.common.treeutil import tree_leaves
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch, list_archs
from repro_torch.data import pipeline as tpipe
from repro_torch.data import tokens as ttokens
from repro_torch.models import gnn, recsys, transformer

LM_ARCHS = ["granite-3-8b", "llama3-405b", "starcoder2-3b", "granite-moe-1b-a400m",
            "olmoe-1b-7b"]
MODEL_ARCHS = LM_ARCHS + ["gat-cora", "bert4rec", "deepfm", "din", "dlrm-mlperf"]


def _np(t):
    """A tensor as numpy (bf16 as ml_dtypes.bfloat16, by its bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# --------------------------------------------------------------------------
# token and index streams: bit-equal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 17])
def test_tokens_bit_equal(seed):
    np.testing.assert_array_equal(ttokens.zipf_tokens(seed, 3, 11, 97),
                                  jtokens.zipf_tokens(seed, 3, 11, 97))
    for a, b in zip(ttokens.lm_batch(seed, 4, 9, 256), jtokens.lm_batch(seed, 4, 9, 256)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_index_stream_bit_equal(n_hosts):
    kw = dict(n=103, batch=16, seed=5)
    for host in range(n_hosts):
        t = tpipe.IndexStream(**kw, host_id=host, n_hosts=n_hosts)
        j = jpipe.IndexStream(**kw, host_id=host, n_hosts=n_hosts)
        # 6 batches an epoch: 14 steps cross two reshuffles
        for step in range(14):
            np.testing.assert_array_equal(t.peek(), j.peek())
            np.testing.assert_array_equal(next(t), next(j))
        assert t.state() == j.state()
        assert not np.array_equal(t.peek(0), t.peek(t.batches_per_epoch))  # reshuffled
        # resume from the state, under a different host count too
        for hosts in (n_hosts, 1):
            rt = tpipe.IndexStream.from_state(t.state(), host_id=0, n_hosts=hosts)
            rj = jpipe.IndexStream.from_state(j.state(), host_id=0, n_hosts=hosts)
            for _ in range(3):
                np.testing.assert_array_equal(next(rt), next(rj))
            np.testing.assert_array_equal(rt.shard(np.arange(16)), rj.shard(np.arange(16)))


# --------------------------------------------------------------------------
# optimizers and schedules
# --------------------------------------------------------------------------

def _trees(seed=0):
    """A mixed f32/bf16 tree: params and three gradient trees, as numpy."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(5, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16),
         "stack": [rng.normal(size=(3, 2, 6)).astype(np.float32),
                   rng.normal(size=(3, 6)).astype(ml_dtypes.bfloat16)]}
    gs = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.5).astype(a.dtype), p)
          for _ in range(3)]
    return p, gs


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_t(v) for v in tree]
    return convert._leaf_from_numpy(tree, torch.device("cpu"))


def _run_both(j_opt, t_opt):
    p, gs = _trees()
    jp, tp = jax.tree.map(jnp.asarray, p), _to_t(p)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for g in gs:
        jp, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = t_opt.update(_to_t(g), ts, tp)
    return (jp, js), (tp, ts)


def _close(j_tree, t_leaves, f32_tol=(1e-5, 1e-6)):
    """Leaves equal within f32's tolerance; a bf16 leaf within one bf16 ulp
    (2^-8 relative), since the two packages may round a last f32 sum the
    other way before the cast."""
    for a, b in zip(jax.tree.leaves(j_tree), t_leaves):
        a = np.asarray(a)
        assert a.dtype == _np(b).dtype, (a.dtype, b.dtype)
        rtol, atol = f32_tol if a.dtype == np.float32 else (2 ** -8, 1e-6)
        np.testing.assert_allclose(_np(b).astype(np.float32), a.astype(np.float32),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("momentum,nesterov,wd", [(0.0, False, 0.0), (0.9, False, 0.0),
                                                  (0.9, True, 1e-2)])
def test_sgd_vs_jax(momentum, nesterov, wd):
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=wd)
    (jp, js), (tp, ts) = _run_both(
        jcommon.sgd(jcommon.constant_schedule(0.1), **kw),
        tcommon.sgd(tcommon.constant_schedule(0.1), **kw))
    _close(jp, tree_leaves(tp))
    assert int(ts.step) == int(js.step) == 3
    if momentum:
        _close(js.inner, tree_leaves(ts.inner))


@pytest.mark.parametrize("slot_dtype,chunk", [(None, 1 << 62), (jnp.bfloat16, 32)])
def test_adam_vs_jax(slot_dtype, chunk):
    """AdamW with weight decay; moments in each param's dtype by default,
    bf16 when asked; ``chunk_bytes`` small enough that the stacked leaves
    update one leading index at a time."""
    tslot = None if slot_dtype is None else torch.bfloat16
    (jp, js), (tp, ts) = _run_both(
        jcommon.adam(jcommon.warmup_cosine(1e-2, 10, 2), weight_decay=1e-2,
                     slot_dtype=slot_dtype, chunk_bytes=chunk),
        tcommon.adam(tcommon.warmup_cosine(1e-2, 10, 2), weight_decay=1e-2,
                     slot_dtype=tslot, chunk_bytes=chunk))
    _close(jp, tree_leaves(tp))
    _close(js.inner, tree_leaves(ts.inner))
    want = [np.asarray(a).dtype for a in jax.tree.leaves(js.inner)]
    assert [_np(b).dtype for b in tree_leaves(ts.inner)] == want


def test_schedules_vs_jax():
    cases = [(jcommon.cosine_schedule(0.3, 50), tcommon.cosine_schedule(0.3, 50)),
             (jcommon.cosine_schedule(0.3, 50, 0.1), tcommon.cosine_schedule(0.3, 50, 0.1)),
             (jcommon.warmup_cosine(1e-3, 100, 10), tcommon.warmup_cosine(1e-3, 100, 10)),
             (jcommon.warmup_cosine(1e-3, 100, 10, 0.05),
              tcommon.warmup_cosine(1e-3, 100, 10, 0.05))]
    for js, ts in cases:
        for step in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 250):
            want = np.asarray(js(jnp.asarray(step, jnp.int32)))
            got = ts(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the registry and its configs
# --------------------------------------------------------------------------

def test_list_archs_equal():
    assert list_archs() == jlist_archs()
    assert len(list_archs()) == 11


def _same_value(a, b):
    """A config field of the reference (a) against the port's (b)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same_value(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            _same_value(x, y)
    elif isinstance(b, torch.dtype):
        assert np.dtype(a).name == str(b).removeprefix("torch."), (a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("arch", sorted(jlist_archs()))
def test_config_and_shapes_equal(arch):
    j, t = jget_arch(arch), get_arch(arch)
    assert (t.arch_id, t.family, t.source, t.notes) == (j.arch_id, j.family, j.source,
                                                         j.notes)
    _same_value(j.make_config(), t.make_config())
    _same_value(j.make_reduced(), t.make_reduced())
    assert [dataclasses.astuple(s) for s in t.shapes] == \
        [dataclasses.astuple(s) for s in j.shapes]


def test_shape_sets_equal():
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        assert [dataclasses.astuple(s) for s in getattr(tbase, name)] == \
            [dataclasses.astuple(s) for s in getattr(jbase, name)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_counts_full(arch):
    """The full configs' counts (405B included), with nothing instantiated."""
    j, t = jget_arch(arch).make_config(), get_arch(arch).make_config()
    assert t.param_count == j.param_count
    assert t.active_param_count == j.active_param_count
    assert t.vocab_padded == j.vocab_padded


_INITS = {"lm": (jtf.init_lm, transformer.init_lm), "gnn": (jgnn.init_gat, gnn.init_gat),
          "bert4rec": (jrs.init_bert4rec, recsys.init_bert4rec),
          "deepfm": (jrs.init_deepfm, recsys.init_deepfm),
          "din": (jrs.init_din, recsys.init_din),
          "dlrm-mlperf": (jrs.init_dlrm, recsys.init_dlrm)}


def _inits(arch):
    spec = get_arch(arch)
    return _INITS[spec.family if spec.family in ("lm", "gnn") else arch]


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_init_tree_equals_eval_shape(arch, size):
    """The port's init on the meta device against ``jax.eval_shape`` of the
    reference's: the same paths, shapes and dtypes, full configs included
    (nothing is allocated)."""
    make = "make_config" if size == "full" else "make_reduced"
    jcfg, tcfg = getattr(jget_arch(arch), make)(), getattr(get_arch(arch), make)()
    jinit, tinit = _inits(arch)
    want = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    got = tinit(torch.Generator(), tcfg, device="meta")
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = tree_leaves(got)
    assert len(wl) == len(gl)
    for (path, a), b in zip(wl, gl):
        assert b.device.type == "meta"
        assert tuple(b.shape) == a.shape, jax.tree_util.keystr(path)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, jax.tree_util.keystr(path)


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------

def test_lm_converter_carries_bf16_bits_and_refuses_mismatches():
    """A bf16 LM tree (the reduced config at the full configs' dtype) comes
    across bit for bit; a wrong shape, dtype or key is refused."""
    jcfg = dataclasses.replace(jget_arch("granite-moe-1b-a400m").make_reduced(),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").make_reduced(),
                               dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(3), jcfg))
    got = convert.lm_from_numpy(tcfg, tree, device="cpu")
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(got)):
        assert a.dtype == _np(b).dtype
        np.testing.assert_array_equal(_np(b).view(np.uint8), a.view(np.uint8))
    assert got["moe"]["router"].dtype == torch.float32
    bad = dict(tree, ln_f=tree["ln_f"][:-1])
    with pytest.raises(ValueError, match="ln_f"):
        convert.lm_from_numpy(tcfg, bad, device="cpu")
    bad = dict(tree, ln_f=tree["ln_f"].astype(np.float32))
    with pytest.raises(ValueError, match="ln_f"):
        convert.lm_from_numpy(tcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy(tcfg, {k: v for k, v in tree.items() if k != "moe"},
                              device="cpu")


# --------------------------------------------------------------------------
# the slice as a whole: the example twin, one arch per family
# --------------------------------------------------------------------------

def test_arch_zoo_twin_on_cpu(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "arch_zoo_torch.py"
    spec = importlib.util.spec_from_file_location("arch_zoo_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    archs = ["granite-moe-1b-a400m", "gat-cora", "dlrm-mlperf", "bert4rec"]
    out = {}
    for arch in archs:
        out.update(mod.main(["--arch", arch, "--device", "cpu"]))
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == archs
    assert "decode_logits=(4, 256)" in lines[0] and "loss=" in lines[1]
    assert all(np.isfinite(v) for v in out.values())
    assert out["granite-moe-1b-a400m"] > 0 and out["gat-cora"] > 0
