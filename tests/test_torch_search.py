"""Port beam search + engines vs the JAX package, on the CPU, over a
JAX-built graph and quantizer carried across with ``repro_torch.convert``;
the slice end to end at the quickstart's ``--dry-run`` sizes; and the
port's import hygiene and device rule."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.data import load_dataset as j_load
from repro.graphs import build_vamana as j_build_vamana
from repro.graphs.knn import knn_ids as j_knn_ids
from repro.pq import base as jbase
from repro.pq import pack as jpack
from repro.pq.pq import train_pq as j_train_pq
from repro.search import beam as jbeam
from repro.search.engine import HybridEngine as JHybrid
from repro.search.engine import InMemoryEngine as JInMemory
from repro.search.metrics import recall_at_k as j_recall
from repro_torch import convert
from repro_torch.data import load_dataset as t_load
from repro_torch.graphs.vamana import build_vamana as t_build_vamana
from repro_torch.kernels import ops as tops
from repro_torch.pq import base as tbase
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.pq.pq import train_pq as t_train_pq
from repro_torch.search import beam as tbeam
from repro_torch.search.engine import HybridEngine, InMemoryEngine
from repro_torch.search.metrics import measure_qps, recall_at_k

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, Q, M, K = 240, 32, 8, 4, 16
TOPK = 10


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


@pytest.fixture(scope="module")
def setup():
    """The tests/test_engine.py fixture, plus its port-side twins."""
    r = np.random.default_rng(7)
    centers = r.normal(size=(8, D)) * 2.5
    x = (centers[r.integers(0, 8, N)] + r.normal(size=(N, D))).astype(np.float32)
    q = (centers[r.integers(0, 8, Q)] + r.normal(size=(Q, D))).astype(np.float32)
    jx, jq = jnp.asarray(x), jnp.asarray(q)
    jmodel = j_train_pq(jax.random.PRNGKey(0), jx, M, K, iters=8)
    jgraph = j_build_vamana(jax.random.PRNGKey(1), jx, r=24, l=48)
    # tie-free ADC distances need UNIQUE codes (see tests/test_engine.py)
    codes_uniq = r.integers(0, K, (N, M)).astype(np.uint8)
    while np.unique(codes_uniq, axis=0).shape[0] != N:  # pragma: no cover
        codes_uniq = r.integers(0, K, (N, M)).astype(np.uint8)
    tmodel = convert.quantizer_from_numpy(np.asarray(jmodel.r),
                                          np.asarray(jmodel.codebooks),
                                          device="cpu")
    tgraph = convert.graph_from_numpy(np.asarray(jgraph.neighbors),
                                      np.asarray(jgraph.medoid), device="cpu")
    jluts = np.asarray(jbase.build_lut(jmodel, jq))
    return dict(x=x, q=q, jx=jx, jq=jq, jmodel=jmodel, jgraph=jgraph,
                tmodel=tmodel, tgraph=tgraph, codes_uniq=codes_uniq,
                jluts=jluts)


def _assert_same_result(t_res, j_res, *, dists=True):
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(j_res.ids))
    for name in ("hops", "n_dist", "rounds", "truncated"):
        np.testing.assert_array_equal(getattr(t_res, name).numpy(),
                                      np.asarray(getattr(j_res, name)),
                                      err_msg=name)
    if dists:
        np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("w", [64, 300])   # JAX's all-pairs / sort branch
def test_first_occurrence_vs_jax(w):
    rng = np.random.default_rng(w)
    idx = rng.integers(0, 40, (5, w)).astype(np.int32)     # many duplicates
    on = rng.random((5, w)) < 0.7
    want = np.stack([np.asarray(jbeam._first_occurrence(jnp.asarray(i), jnp.asarray(o)))
                     for i, o in zip(idx, on)])
    got = tbeam._first_occurrence(T(idx.astype(np.int64)), T(on))
    np.testing.assert_array_equal(got.numpy(), want)


def test_visited_bitset_word_layout_vs_jax():
    """int32 words hold the same 32 bits as JAX's uint32 words, bit 31 and
    word boundaries included."""
    n = 200
    nwords = (n + 31) // 32 + 1
    ids = np.array([[0, 31, 32, 63, 64, 199, 5, 100],
                    [200, 1, 30, 33, 95, 96, 127, 128]], np.int64)
    on = np.ones_like(ids, bool)
    on[0, 6] = False
    bits = torch.zeros((2, nwords), dtype=torch.int32)
    tbeam._scatter_bits_(bits, T(ids), T(on))
    for q in range(2):
        want = jbeam._scatter_bits(jnp.zeros((nwords,), jnp.uint32),
                                   jnp.asarray(ids[q], jnp.int32), jnp.asarray(on[q]))
        np.testing.assert_array_equal(bits[q].numpy().view(np.uint32), np.asarray(want))
        probe = np.arange(n + 1)
        np.testing.assert_array_equal(
            tbeam._bit_get(bits[q:q + 1], T(probe[None])).numpy()[0],
            np.asarray(jbeam._bit_get(want, jnp.asarray(probe))).astype(bool))


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("h", [16, 48])
def test_beam_search_adc_exact_vs_jax(setup, expand, h):
    codes_p = np.concatenate([setup["codes_uniq"], np.zeros((1, M), np.uint8)])
    jfn = jbeam.make_adc_dist_fn(jnp.asarray(codes_p))
    j_res = jbeam.beam_search(setup["jgraph"].neighbors, setup["jgraph"].medoid,
                              jnp.asarray(setup["jluts"]), jfn, h=h,
                              expand=expand)
    tfn = tbeam.make_adc_dist_fn(T(codes_p))
    t_res = tbeam.beam_search(setup["tgraph"].neighbors, setup["tgraph"].medoid,
                              T(setup["jluts"]), tfn, h=h, expand=expand)
    _assert_same_result(t_res, j_res)


@pytest.mark.parametrize("expand", [1, 4])
def test_beam_search_exact_dist_vs_jax(setup, expand):
    xp = np.concatenate([setup["x"], np.zeros((1, D), np.float32)])
    j_res = jbeam.beam_search(setup["jgraph"].neighbors, setup["jgraph"].medoid,
                              setup["jq"], jbeam.make_exact_dist_fn(jnp.asarray(xp)),
                              h=32, expand=expand)
    t_res = tbeam.beam_search(setup["tgraph"].neighbors, setup["tgraph"].medoid,
                              T(setup["q"]), tbeam.make_exact_dist_fn(T(xp)),
                              h=32, expand=expand)
    _assert_same_result(t_res, j_res)


def test_beam_search_max_steps_truncates_like_jax(setup):
    codes_p = np.concatenate([setup["codes_uniq"], np.zeros((1, M), np.uint8)])
    entries = np.arange(Q, dtype=np.int32) * 7                # per-query
    j_res = jbeam.beam_search(setup["jgraph"].neighbors, jnp.asarray(entries),
                              jnp.asarray(setup["jluts"]),
                              jbeam.make_adc_dist_fn(jnp.asarray(codes_p)),
                              h=32, max_steps=5, expand=2)
    t_res = tbeam.beam_search(setup["tgraph"].neighbors, T(entries),
                              T(setup["jluts"]),
                              tbeam.make_adc_dist_fn(T(codes_p)),
                              h=32, max_steps=5, expand=2)
    _assert_same_result(t_res, j_res)
    assert bool(t_res.truncated.all())


def test_adc_m_prefix_dist_fn_vs_jax(setup):
    codes_p = np.concatenate([setup["codes_uniq"], np.zeros((1, M), np.uint8)])
    ids = np.random.default_rng(0).integers(0, N + 1, (Q, 24)).astype(np.int32)
    jfn = jbeam.make_adc_dist_fn(jnp.asarray(codes_p), m_prefix=2)
    want = jax.vmap(jfn)(jnp.asarray(setup["jluts"]), jnp.asarray(ids))
    got = tbeam.make_adc_dist_fn(T(codes_p), m_prefix=2)(T(setup["jluts"]), T(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _tie_free_fs4(seed):
    """M=2 fs4 codes, one distinct packed byte per vertex, and per-query
    LUTs ``lut[q, 0, c] = p(c)``, ``lut[q, 1, c] = 16·p'(c)`` for two
    permutations of 0..15: the int32 sum p(c0) + 16·p'(c1) is injective
    over the (c0, c1) pairs, so no two vertices tie in any query."""
    r = np.random.default_rng(seed)
    byte = r.permutation(256)[:N].astype(np.uint8)
    packed_p = np.concatenate([byte, [0]]).astype(np.uint8)[:, None]  # (N+1, 1)
    lut = np.stack([np.stack([r.permutation(16), 16 * r.permutation(16)])
                    for _ in range(Q)]).astype(np.uint8)             # (Q, 2, 16)
    scale = r.uniform(0.1, 2.0, Q).astype(np.float32)
    bias = r.uniform(0.0, 1.0, Q).astype(np.float32)
    return packed_p, (lut, scale, bias)


def _fs4_beams(setup, packed_p, ql, **kw):
    jql = jpack.QuantizedLUT(*(jnp.asarray(a) for a in ql))
    tql = QuantizedLUT(*(T(a) for a in ql))
    j_res = jbeam.beam_search(setup["jgraph"].neighbors, setup["jgraph"].medoid, jql,
                              jbeam.make_adc_dist_fn(jnp.asarray(packed_p),
                                                     packed=True), **kw)
    t_res = tbeam.beam_search(setup["tgraph"].neighbors, setup["tgraph"].medoid, tql,
                              tbeam.make_adc_dist_fn(T(packed_p), packed=True), **kw)
    return t_res, j_res


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("h", [16, 48])
def test_beam_search_fs4_tie_free_vs_jax(setup, expand, h):
    packed_p, ql = _tie_free_fs4(h + expand)
    t_res, j_res = _fs4_beams(setup, packed_p, ql, h=h, expand=expand)
    _assert_same_result(t_res, j_res)


@pytest.mark.parametrize("expand", [1, 4])
def test_beam_search_fs4_natural_ties_vs_jax(setup, expand):
    """Quantized LUTs of a real model over its own (non-unique) codes tie
    often; equal int32 sums dequantize to equal distances on both sides
    and both break ties toward the lower index, so the ids and counters
    still match JAX's."""
    jmodel = setup["jmodel"]
    codes = np.asarray(jbase.encode(jmodel, setup["jx"]))
    packed_p = np.asarray(jpack.pack_codes(jnp.asarray(
        np.concatenate([codes, np.zeros((1, M), codes.dtype)]))))
    jql = jbase.build_lut(jmodel, setup["jq"], quantize=True)
    ql = tuple(np.asarray(a) for a in jql)
    t_res, j_res = _fs4_beams(setup, packed_p, ql, h=32, expand=expand)
    _assert_same_result(t_res, j_res)
    d = t_res.dists.numpy()
    assert (d[:, 1:] == d[:, :-1]).any()          # the fixture does tie


def test_adc_fs_m_prefix_dist_fn_vs_jax(setup):
    packed_p, ql = _tie_free_fs4(3)
    ids = np.random.default_rng(1).integers(0, N + 1, (Q, 24)).astype(np.int32)
    jfn = jbeam.make_adc_dist_fn(jnp.asarray(packed_p), packed=True, m_prefix=1)
    want = jax.vmap(jfn)(jpack.QuantizedLUT(*(jnp.asarray(a) for a in ql)),
                         jnp.asarray(ids))
    got = tbeam.make_adc_dist_fn(T(packed_p), packed=True, m_prefix=1)(
        QuantizedLUT(*(T(a) for a in ql)), T(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_beam_and_engine_results_are_not_degraded(setup):
    packed_p, ql = _tie_free_fs4(4)
    t_res, _ = _fs4_beams(setup, packed_p, ql, h=16)
    assert t_res.degraded is False


def test_engines_vs_jax(setup):
    jlut = lambda qq: jbase.build_lut(setup["jmodel"], qq)
    tlut = lambda qq: tbase.build_lut(setup["tmodel"], qq)
    cu = setup["codes_uniq"]
    tcodes = convert.codes_from_numpy(cu.astype(np.int32), device="cpu")
    assert tcodes.dtype == torch.uint8
    jm = JInMemory(setup["jgraph"], jnp.asarray(cu), jlut)
    tm = InMemoryEngine(setup["tgraph"], tcodes, tlut, device="cpu")
    _assert_same_result(tm.search(T(setup["q"]), k=TOPK, h=48),
                        jm.search(setup["jq"], k=TOPK, h=48))
    assert tm.memory_bytes() == jm.memory_bytes()
    jh = JHybrid(setup["jgraph"], jnp.asarray(cu), jlut, vectors=setup["jx"])
    th = HybridEngine(setup["tgraph"], tcodes, tlut, vectors=T(setup["x"]),
                      device="cpu")
    for kw in ({}, {"expand": 4}):
        j_res = jh.search(setup["jq"], k=TOPK, h=48, **kw)
        t_res = th.search(T(setup["q"]), k=TOPK, h=48, **kw)
        _assert_same_result(t_res, j_res)
        np.testing.assert_allclose(th.io_time(t_res).numpy(),
                                   np.asarray(jh.io_time(j_res)), rtol=1e-6)
    assert th.memory_bytes() == jh.memory_bytes()


def test_exhaustive_beam_is_adc_topk(setup):
    """With h = N the beam visits every vertex: the answer is the ADC
    top-k of the exhaustive scan (pq.base.adc)."""
    tlut = lambda qq: tbase.build_lut(setup["tmodel"], qq)
    eng = InMemoryEngine(setup["tgraph"], T(setup["codes_uniq"]), tlut,
                         device="cpu")
    res = eng.search(T(setup["q"]), k=TOPK, h=N, max_steps=2 * N)
    adc = tbase.adc(setup["tmodel"], T(setup["codes_uniq"]), T(setup["q"]))
    top = torch.sort(adc, dim=1, stable=True)[1][:, :TOPK]
    np.testing.assert_array_equal(res.ids.numpy(), top.numpy())


def test_quickstart_dry_run_slice_vs_jax():
    """The serving slice end to end at examples/quickstart.py --dry-run
    sizes: JAX vs port with the graph and the PQ model carried across."""
    jds = j_load("unit-test")
    base, queries, train = jds.base[:400], jds.queries[:20], jds.train[:200]
    jgraph = j_build_vamana(jax.random.PRNGKey(0), base, r=16, l=32)
    gt, _ = j_knn_ids(base, queries, 10)
    jm = j_train_pq(jax.random.PRNGKey(1), train, 4, 32)
    jcodes = jbase.encode(jm, base)
    jeng = JHybrid(jgraph, jcodes, lambda qq: jbase.build_lut(jm, qq),
                   vectors=base)
    j_rec = j_recall(jeng.search(queries, k=10, h=32).ids, gt, 10)

    tds = t_load("unit-test", device="cpu")
    tb, tq = tds.base[:400], tds.queries[:20]
    tgraph = convert.graph_from_numpy(np.asarray(jgraph.neighbors),
                                      np.asarray(jgraph.medoid), device="cpu")
    tm = convert.quantizer_from_numpy(np.asarray(jm.r), np.asarray(jm.codebooks),
                                      device="cpu")
    tcodes = tbase.encode(tm, tb)
    teng = HybridEngine(tgraph, tcodes, lambda qq: tbase.build_lut(tm, qq),
                        vectors=tb, device="cpu")
    qps, res = measure_qps(lambda qq: teng.search(qq, k=10, h=32), tq,
                           repeats=1)
    t_rec = recall_at_k(res.ids, np.asarray(gt), 10)
    assert qps > 0 and abs(t_rec - j_rec) <= 0.01


def test_port_trains_and_serves_end_to_end_on_cpu():
    tds = t_load("unit-test", device="cpu")
    base, queries = tds.base[:400], tds.queries[:20]
    g = t_build_vamana(base, generator=torch.Generator().manual_seed(0), r=16,
                       l=32, device="cpu")
    m = t_train_pq(tds.train[:200], 4, 32,
                   generator=torch.Generator().manual_seed(1), device="cpu")
    eng = InMemoryEngine(g, tbase.encode(m, base),
                         lambda qq: tbase.build_lut(m, qq), device="cpu")
    res = eng.search(queries, k=10, h=32)
    assert res.ids.shape == (20, 10) and bool(torch.isfinite(res.dists).all())
    assert bool((res.rounds == res.hops).all())              # expand=1
    assert int(res.ids.max()) < 400


_SRC_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "disk_serving_torch.py", ROOT / "examples" / "arch_zoo_torch.py"]


@pytest.mark.parametrize("path", _SRC_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_import_repro_torch_loads_no_jax():
    """Fresh interpreter WITHOUT PYTHONPATH=src (src/sitecustomize.py would
    import jax at startup): importing the whole port pulls in no jax."""
    code = ("import sys; sys.path.insert(0, 'src'); import repro_torch, "
            "repro_torch.convert, repro_torch.search.engine, "
            "repro_torch.graphs.vamana, repro_torch.pq, repro_torch.pq.pack, "
            "repro_torch.dist.fault, repro_torch.data, repro_torch.common, "
            "repro_torch.core, repro_torch.core.trainer, repro_torch.core.rpq, "
            "repro_torch.models.recsys, repro_torch.kernels.hop_gather, "
            "repro_torch.dist.checkpoint, repro_torch.dist.retry, "
            "repro_torch.search.seed, repro_torch.search.degrade, "
            "repro_torch.launch.train, repro_torch.launch.serve, repro_torch.pq.opq, "
            "repro_torch.configs, repro_torch.models.layers, repro_torch.models.moe, "
            "repro_torch.models.transformer, repro_torch.models.gnn, "
            "repro_torch.data.tokens, repro_torch.data.pipeline; "
            "repro_torch.configs.list_archs(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_refuse_to_run_on_cpu_unasked(setup, monkeypatch):
    """No CUDA and no device="cpu": every entry point raises instead of
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tlut = lambda qq: tbase.build_lut(setup["tmodel"], qq)
    codes = T(setup["codes_uniq"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InMemoryEngine(setup["tgraph"], codes, tlut)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridEngine(setup["tgraph"], codes, tlut, vectors=T(setup["x"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_load("unit-test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train_pq(T(setup["x"]), M, K, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build_vamana(T(setup["x"]), generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.codes_from_numpy(setup["codes_uniq"])


def test_launch_counters_see_no_cpu_launches(setup):
    tops.reset_launch_counts()
    tlut = lambda qq: tbase.build_lut(setup["tmodel"], qq)
    InMemoryEngine(setup["tgraph"], T(setup["codes_uniq"]), tlut,
                   device="cpu").search(T(setup["q"]))
    assert sum(tops.launch_counts().values()) == 0


# --------------------------------------------------------------------------
# The classic round's plain versions (kernels/ref.py) against the rules the
# CUDA kernels of csrc/beam_round.cu follow, written out here in numpy: the
# pick is the first unexpanded finite slot of the sorted beam, and the
# merge places each frontier entry by counting the entries ranked before it
# and lets the beam fill the places left in its own order.
# --------------------------------------------------------------------------

def _order_key(d):
    """The kernels' sort key of f32 distances: -0 as +0, NaN above +inf."""
    d = np.asarray(d, np.float32)
    b = np.where(d == 0, np.float32(0), d).view(np.uint32).astype(np.int64)
    key = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return np.where(np.isnan(d), 0xFFFFFFFF, key)


def _first_unexpanded_finite(dists, exp):
    ok = ~exp & (dists < np.inf)
    return np.where(ok.any(axis=1), ok.argmax(axis=1), -1)


def _counted_merge(bd, bi, be, fd, fi):
    """One lane: frontier slot j goes to #{frontier keys below it, or equal
    and before it} + #{beam keys at or below it} (an upper bound in the
    sorted beam); the beam slots keep their order in the places left, slot
    i in the i-th; the first h places are the new beam."""
    h, r = len(bd), len(fd)
    kb, kf = _order_key(bd), _order_key(fd)
    assert (np.diff(kb) >= 0).all()                      # the beam is sorted
    before = (kf[None, :] < kf[:, None]) | ((kf[None, :] == kf[:, None])
                                            & (np.arange(r)[None, :] < np.arange(r)[:, None]))
    place_f = before.sum(axis=1) + np.searchsorted(kb, kf, side="right")
    place_b = np.setdiff1d(np.arange(h + r), place_f)[:h]
    out_d, out_i, out_e = np.empty(h, np.float32), np.empty(h, np.int64), np.empty(h, bool)
    for places, d, i, e in ((place_b, bd, bi, be),
                            (place_f, fd, fi, np.zeros(r, bool))):
        for p, dd, ii, ee in zip(places, d, i, e):
            if p < h:
                out_d[p], out_i[p], out_e[p] = dd, ii, ee or dd == np.inf
    assert sorted(np.concatenate([place_b, place_f])) == list(range(h + r))
    return out_d, out_i, out_e


def _round_state(dists, exp, n, nwords):
    q, h = dists.shape
    ids = torch.from_numpy(np.where(dists < np.inf, np.arange(q * h).reshape(q, h) % n,
                                    n)).long()
    return dict(ids=ids, dists=T(dists.astype(np.float32)), exp=T(exp),
                visited=torch.zeros((q, nwords), dtype=torch.int32),
                hops=torch.zeros(q, dtype=torch.int32),
                ndist=torch.ones(q, dtype=torch.int32),
                count=torch.full((), 7, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["all_expanded", "all_inf", "mixed", "not_live"])
def test_round_pick_is_the_first_unexpanded_finite_slot(kind):
    rng = np.random.default_rng(3)
    q, h, n, r = 6, 40, 50, 8
    dists = np.sort(rng.integers(0, 6, (q, h)).astype(np.float32), axis=1)  # ties
    exp = rng.random((q, h)) < 0.5
    if kind == "all_expanded":
        exp[:] = True
    elif kind == "all_inf":
        dists[:] = np.inf
    else:
        dists[:, h - 5:] = np.inf
        exp[0, :] = True                         # an all-expanded row among them
        exp[1, :h - 5] = True                    # only +inf left unexpanded
    live = torch.full((q,), kind != "not_live")
    st = _round_state(dists, exp, n, (n + 31) // 32 + 1)
    before = st["exp"].clone()
    nbrs = torch.from_numpy(rng.integers(0, n + 1, (n, r)).astype(np.int32))
    front, fresh = tops.beam_expand(nbrs, st["ids"], st["dists"], st["exp"], live,
                                    st["visited"], st["hops"], st["ndist"], st["count"])
    want = _first_unexpanded_finite(dists, exp) if kind != "not_live" else np.full(q, -1)
    got = st["exp"].numpy() & ~before.numpy()
    assert (got.sum(axis=1) <= 1).all()
    np.testing.assert_array_equal(np.where(got.any(axis=1), got.argmax(axis=1), -1), want)
    np.testing.assert_array_equal(st["hops"].numpy(), want >= 0)
    assert not fresh[torch.from_numpy(want < 0)].any()
    assert (front[~fresh] == 0).all() and front.dtype == torch.int32
    assert int(st["count"]) == 0
    if kind == "mixed":
        assert (want >= 0).sum() >= 3 and (want < 0).sum() == 2


def _merge_case(rng, q, h, r, n, ties):
    """A sorted beam with +inf tails and a frontier full of ties: integer
    distances, some slots not fresh, tombstoned ids among the fresh."""
    bd = np.sort(rng.integers(0, ties, (q, h)).astype(np.float32), axis=1)
    bd[:, h - h // 4:] = np.inf
    be = rng.random((q, h)) < 0.4
    be |= bd == np.inf
    bi = np.where(bd < np.inf, rng.integers(0, n, (q, h)), n)
    fd = rng.integers(0, ties, (q, r)).astype(np.float32)
    fi = rng.integers(0, n, (q, r)).astype(np.int32)
    fresh = rng.random((q, r)) < 0.7
    return bd, be, bi, fd, np.where(fresh, fi, 0).astype(np.int32), fresh


@pytest.mark.parametrize("h,r,ties", [(8, 6, 3), (32, 16, 4), (96, 64, 20)])
def test_round_merge_ranks_beam_first_then_lower_slot(h, r, ties):
    rng = np.random.default_rng(h + r)
    q, n = 5, 90
    bd, be, bi, fd, fi, fresh = _merge_case(rng, q, h, r, n, ties)
    tomb = np.zeros((n + 31) // 32, np.uint32)
    dead = rng.choice(n, 25, replace=False)
    np.bitwise_or.at(tomb, dead >> 5, (1 << (dead & 31)).astype(np.uint32))
    live = np.array([True, True, False, True, True])
    ids, dists, exp = T(bi).long(), T(bd), T(be)
    step = torch.zeros(q, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int32)
    tops.beam_merge(ids, dists, exp, T(fi), T(fresh), T(fd), T(live), step,
                    torch.zeros(q, dtype=torch.int32), count, n=n,
                    tombstones=tbeam.as_bitset(tomb, "cpu"), max_steps=10)
    is_dead = ((tomb[fi >> 5] >> (fi & 31)) & 1) == 1
    fd_eff = np.where(fresh & ~is_dead, fd, np.inf).astype(np.float32)
    fi_eff = np.where(fresh, fi, n)
    for lane in range(q):
        if live[lane]:
            want = _counted_merge(bd[lane], bi[lane], be[lane], fd_eff[lane], fi_eff[lane])
        else:
            want = (bd[lane], bi[lane], be[lane])
        np.testing.assert_array_equal(dists[lane].numpy(), want[0])
        np.testing.assert_array_equal(ids[lane].numpy(), want[1])
        np.testing.assert_array_equal(exp[lane].numpy(), want[2])
    np.testing.assert_array_equal(step.numpy(), live)
    # +inf entries that carry ids: a tombstoned fresh slot keeps its id
    carried = fresh & is_dead & live[:, None]
    assert carried.any()
    pending = (~exp.numpy() & (dists.numpy() < np.inf)).any(axis=1)
    assert int(count) == int((pending & (step.numpy() < 10)).sum())


def test_round_merge_tie_order_by_hand():
    """Beam (1, 2, inf, inf, inf) and frontier (2, 1, 2 tombstoned, 0 not
    fresh): the beam's 1 before the frontier's 1, the beam's 2 before the
    frontier's; the dead entry ranks +inf with its id, after the beam's +inf
    slots, as does the slot not fresh with the sentinel id, so neither
    enters the beam."""
    n = 10
    ids = torch.tensor([[4, 5, n, n, n]])
    dists = torch.tensor([[1.0, 2.0] + [float("inf")] * 3])
    exp = torch.tensor([[True, False, True, True, True]])
    front = torch.tensor([[6, 7, 8, 0]], dtype=torch.int32)
    fresh = torch.tensor([[True, True, True, False]])
    tomb = tbeam.as_bitset(np.array([1 << 8], np.uint32), "cpu")
    live, step = torch.tensor([True]), torch.zeros(1, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int32)
    tops.beam_merge(ids, dists, exp, front, fresh, torch.tensor([[2.0, 1.0, 2.0, 0.0]]),
                    live, step, torch.zeros(1, dtype=torch.int32), count, n=n,
                    tombstones=tomb, max_steps=4)
    assert ids.tolist() == [[4, 7, 5, 6, n]]
    assert dists.tolist() == [[1.0, 1.0, 2.0, 2.0, float("inf")]]
    assert exp.tolist() == [[True, False, False, False, True]]
    assert step.tolist() == [1] and live.tolist() == [True] and int(count) == 1
    want = _counted_merge(np.array([1, 2] + [np.inf] * 3, np.float32),
                          np.array([4, 5, n, n, n]), np.array([1, 0, 1, 1, 1], bool),
                          np.array([2, 1, np.inf, np.inf], np.float32),
                          np.array([6, 7, 8, n]))
    assert want[1].tolist() == ids[0].tolist()


def test_round_expand_scores_an_in_row_duplicate_twice_and_sets_its_bit_once():
    n, h = 40, 4
    nbrs = torch.full((n, 6), n, dtype=torch.int32)
    nbrs[3] = torch.tensor([9, 33, 9, n, 33, 2], dtype=torch.int32)
    st = _round_state(np.array([[0.5, np.inf, np.inf, np.inf]], np.float32),
                      np.array([[False, True, True, True]]), n, (n + 31) // 32 + 1)
    st["ids"][0, 0] = 3
    st["visited"][0, 0] = 1 << 2                   # vertex 2 already visited
    front, fresh = tops.beam_expand(nbrs, st["ids"], st["dists"], st["exp"],
                                    torch.tensor([True]), st["visited"], st["hops"],
                                    st["ndist"], st["count"])
    assert fresh.tolist() == [[True, True, True, False, True, False]]
    assert front.tolist() == [[9, 33, 9, 0, 33, 0]]
    assert st["visited"][0].tolist() == [(1 << 2) | (1 << 9), 1 << 1, 0]
    assert st["ndist"].tolist() == [1 + 4] and st["hops"].tolist() == [1]
    assert st["exp"].tolist() == [[True, True, True, True]]


def test_round_wrappers_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels import beam_round
    q, h, n, r = 3, 8, 20, 4
    nbrs = torch.zeros((n, r), dtype=torch.int32)
    ids = torch.zeros((q, h), dtype=torch.int64)
    dists = torch.zeros((q, h))
    exp = torch.zeros((q, h), dtype=torch.bool)
    live = torch.ones(q, dtype=torch.bool)
    vis = torch.zeros((q, 2), dtype=torch.int32)
    cnt = torch.zeros(q, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):          # a CPU beam
        beam_round.beam_expand(nbrs, ids, dists, exp, live, vis, cnt, cnt, count)
    with pytest.raises(ValueError, match="CUDA"):
        beam_round.beam_merge(ids, dists, exp, nbrs[:q], exp[:, :r], dists[:, :r],
                              live, cnt, cnt, count, n=n, max_steps=4)
    for bad_h, bad_r in ((0, 4), (257, 4), (8, 0), (8, 129)):
        with pytest.raises(ValueError, match="h <= 256"):
            beam_round._limits("beam_expand", torch.zeros((q, bad_h)), bad_h, bad_r)
    with pytest.raises(ValueError, match="CUDA"):
        beam_round._limits("beam_expand", ids, 256, 128)
    cpu = ids.get_device()                                 # -1
    beam_round._check("beam_merge", cpu, (("ids", ids, torch.int64, (q, h)),))
    for t, dtype, shape in ((ids.int(), torch.int64, (q, h)),       # dtype
                            (ids, torch.int64, (q, h + 1)),         # shape
                            (ids[:, :h], torch.int64, (q, h, 1)),   # rank
                            (ids.t(), torch.int64, (h, q))):         # layout
        with pytest.raises(ValueError, match="contiguous"):
            beam_round._check("beam_merge", cpu, (("ids", t, dtype, shape),))
    with pytest.raises(ValueError, match="on cuda:0, got .* on cpu"):  # device
        beam_round._check("beam_merge", 0, (("ids", ids, torch.int64, (q, h)),))


def test_round_entry_points_launch_nothing_on_the_cpu(setup):
    tops.reset_launch_counts()
    codes_p = np.concatenate([setup["codes_uniq"], np.zeros((1, M), np.uint8)])
    tbeam.beam_search(setup["tgraph"].neighbors, setup["tgraph"].medoid,
                      T(setup["jluts"]), tbeam.make_adc_dist_fn(T(codes_p)), h=16)
    counts = tops.launch_counts()
    assert counts["beam_expand"] == counts["beam_merge"] == 0
