"""The four example twins (``examples/*_torch.py``) at their dry-run sizes
on the CPU, in process.

Each prints the reference example's lines. Where the reference prints a
recall, the twin's index (its graph, quantizer and codes) is handed to the
JAX package's own engine on the same seeded data, and the twin's printed
recall must be within 0.01 of the reference engine's — the tolerance of
``tests/test_torch_search.py``'s carried-across slice.
"""

import importlib
import os
import pathlib
import re

import numpy as np
import pytest

import jax.numpy as jnp

from repro.graphs.adjacency import Graph as JGraph
from repro.pq import base as jbase
from repro.search import engine as jengine
from repro.search.metrics import recall_at_k as j_recall

from repro_torch.search.metrics import live_ground_truth

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 0.01


@pytest.fixture
def twin(monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.syspath_prepend(str(ROOT / "examples"))

    def load(name):
        return importlib.import_module(name)
    return load


def _jax_index(graph, model, codes):
    jg = JGraph(jnp.asarray(graph.neighbors.numpy()), jnp.asarray(int(graph.medoid), jnp.int32))
    jm = jbase.QuantizerModel(jnp.asarray(model.r.numpy()), jnp.asarray(model.codebooks.numpy()))
    return jg, jm, jnp.asarray(codes.numpy())


def test_adaptive_routing_twin(twin, capsys):
    mod = twin("adaptive_routing_torch")
    out = mod.main(["--dry-run", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.match(r"seed index: \d+ buckets on the first \d+ sub-code\(s\) \(base K=64\), "
                    r"\d+ occupied, \d+ candidates probed per query", lines[0])
    table = [l for l in lines if l[:28].strip() in [t for t, _ in mod.ROWS]]
    assert [l[:28].strip() for l in table] == [t for t, _ in mod.ROWS]
    ds = out["ds"]
    jg, jm, jcodes = _jax_index(out["graph"], out["model"], out["codes"])
    eng = jengine.InMemoryEngine(jg, jcodes, lambda q: jbase.build_lut(jm, q))
    q, gt = jnp.asarray(ds.queries.numpy()), np.asarray(out["gt"])
    for (tag, kw), row in zip(mod.ROWS, out["rows"]):
        res = eng.search(q, k=10, h=32, **kw)
        assert abs(row["recall"] - j_recall(res.ids, gt, 10)) <= TOL, tag
        assert f"{row['recall']:10.3f}" in next(l for l in table if l.startswith(tag))


def test_serve_ann_twin(twin, capsys):
    mod = twin("serve_ann_torch")
    out = mod.main(["--dry-run", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert any(re.match(r"index: n=1000 codes=8B/vec resident=[\d.]+MB \(full vectors "
                        r"would be [\d.]+MB\)", l) for l in lines)
    head = next(i for i, l in enumerate(lines) if l.startswith("engine"))
    assert lines[head].split() == ["engine", "h", "recall@10", "QPS", "hops", "SSD", "ms/q"]
    rows = [l.split() for l in lines[head + 1:]]
    assert [(r[0], int(r[1])) for r in rows] == [("inmem", 16), ("hybrid", 16),
                                                 ("inmem", 32), ("hybrid", 32)]
    ds = out["ds"]
    jg, jm, jcodes = _jax_index(out["graph"], out["model"], out["codes"])
    lut = lambda q: jbase.build_lut(jm, q)
    engines = {"inmem": jengine.InMemoryEngine(jg, jcodes, lut),
               "hybrid": jengine.HybridEngine(jg, jcodes, lut,
                                              vectors=jnp.asarray(ds.base.numpy()))}
    q, gt = jnp.asarray(ds.queries.numpy()), np.asarray(out["gt"])
    for row in out["rows"]:
        res = engines[row["engine"]].search(q, k=10, h=row["h"])
        assert abs(row["recall"] - j_recall(res.ids, gt, 10)) <= TOL, row


def test_streaming_twin(twin, capsys):
    from repro.index import BaseSegment as JBase, StreamingEngine as JStreaming

    mod = twin("streaming_torch")
    out = mod.main(["--dry-run", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "corpus: 450 base rows + 50 streamed, dim 32"
    starts = ["frozen base        : recall@10 = ", "after insert       : recall@10 = ",
              "deleted 6 rows (incl. the medoid) — never returned again",
              "consolidated: dropped 6, folded 50 delta rows → 494 rows",
              "generation 1: recall@10 = ", "refreshed consolidation → generation 2: ",
              "self-contained restore: snapshot → engine, no caller-side model"]
    assert [l[:len(s)] for l, s in zip(lines[1:], starts)] == starts
    assert "live rows = 450  generation = 0" in lines[1]
    seg, model = out["seg"], out["model"]
    jg, jm, jcodes = _jax_index(seg.graph, model, seg.codes)
    jeng = JStreaming(JBase(graph=jg, codes=jcodes, vectors=jnp.asarray(out["base_x"])),
                      jm, delta_capacity=50)
    gt = live_ground_truth(out["base_x"], np.arange(450), out["queries"], 10)
    rec = j_recall(jeng.search(jnp.asarray(out["queries"]), k=10, h=32).ids, gt, 10)
    assert abs(out["recalls"]["frozen base"] - rec) <= TOL


def test_train_rpq_e2e_twin_with_a_restart(twin, capsys, tmp_path):
    from repro_torch.core import quantizer as Q
    from repro_torch.core import trainer as T
    from repro_torch.data import load_dataset
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.graphs import knn_ids
    from repro_torch.launch.train import template_state

    mod = twin("train_rpq_e2e_torch")
    args = mod.Args()
    for k, v in dict(device="cpu", dataset="unit-test", steps=20, fail_at_step=12,
                     checkpoint_every=5, log_every=10, m=4, k=16, batch=64,
                     routing_queries=16, refresh_every=10, graph_r=8, graph_l=16, beam=16,
                     ckpt_dir=str(tmp_path / "e2e")).items():
        setattr(args, k, v)
    out = mod.main(args)
    text = capsys.readouterr().out
    assert "[e2e] training RPQ on unit-test for 20 steps; a crash will be injected at step 12" in text
    assert "[e2e] supervisor restart #1: injected failure at step 12" in text
    assert "[train] resumed from step 10" in text
    assert f"[e2e] finished with 1 restart(s); final recall@10 = {out['recall']:.3f}" in text
    assert out["restarts"] == 1 and (tmp_path / "e2e" / "graph_base.npz").exists()

    cfg = Q.RPQConfig(dim=32, m=4, k=16)
    tcfg = T.TrainConfig(steps=20)
    like = dict(zip(("params", "opt"), template_state(cfg, tcfg, "cpu")))
    state = ckpt.restore(args.ckpt_dir, 20, like=like, device="cpu")
    model = T.to_model(cfg, state["params"])
    z = np.load(os.path.join(args.ckpt_dir, "graph_base.npz"))
    ds = load_dataset("unit-test", device="cpu")
    jg = JGraph(jnp.asarray(z["neighbors"]), jnp.asarray(int(z["medoid"]), jnp.int32))
    jm = jbase.QuantizerModel(jnp.asarray(model.r.numpy()),
                              jnp.asarray(model.codebooks.numpy()))
    base = jnp.asarray(ds.base.numpy())
    eng = jengine.HybridEngine(jg, jbase.encode(jm, base), lambda q: jbase.build_lut(jm, q),
                               vectors=base)
    gt, _ = knn_ids(ds.base, ds.queries, 10)
    rec = j_recall(eng.search(jnp.asarray(ds.queries.numpy()), k=10, h=16).ids,
                   np.asarray(gt), 10)
    assert abs(out["recall"] - rec) <= TOL
