"""The port's train → checkpoint → serve command lines, in process, on the
CPU (``--device cpu``, the unit-test dataset, M=4, K=16):

* a crash at a step, a supervised restart and a resume reach the final
  params of an uninterrupted run bit for bit;
* a checkpoint written by the JAX package, plus a ``graph_base.npz`` built
  by it, served by the port's ``serve`` gives the ids of the JAX engines on
  the same quantizer and graph (every id equal);
* the ``--port-stdin`` loop survives garbage lines;
* the scenario that waited for a later slice (``sharded-graph``) serves;
* without CUDA, both drivers raise unless given ``--device cpu``.
"""

import io
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import RPQConfig as JRPQConfig
from repro.core import trainer as JT
from repro.data import load_dataset as j_load
from repro.dist import checkpoint as jckpt
from repro.graphs import build_vamana as j_build_vamana
from repro.pq import base as jbase
from repro.search.engine import HybridEngine as JHybrid
from repro.search.engine import InMemoryEngine as JInMemory
from repro_torch.dist import checkpoint as tckpt
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

@pytest.fixture(autouse=True)
def _no_io_fault_hook():
    """``serve --chaos io=p`` installs a process-wide checkpoint-read fault
    hook, as the reference's driver does; in process, take it down after
    each test."""
    yield
    tckpt.set_io_fault_hook(None)


TRAIN_ARGV = ["--dataset", "unit-test", "--steps", "16", "--m", "4", "--k", "16",
              "--batch", "32", "--routing-queries", "8", "--graph-r", "8",
              "--graph-l", "16", "--beam", "16", "--checkpoint-every", "4",
              "--log-every", "8", "--quiet", "--device", "cpu"]


def test_train_cli_crash_resume_is_bit_exact(tmp_path, capsys):
    """``--refresh-every 1``: the routing pool is re-extracted at every
    step, so the resumed run's pool at its first step equals the
    uninterrupted run's (with a longer period the restart re-extracts it at
    the resume step, from later params — the reference documents the same
    for its driver); the per-step generators replay every other draw."""
    clean, crashy = str(tmp_path / "clean"), str(tmp_path / "crashy")
    argv = TRAIN_ARGV + ["--refresh-every", "1"]
    ttrain.main(argv + ["--ckpt-dir", clean])
    ttrain.main(argv + ["--ckpt-dir", crashy, "--fail-at-step", "10"])
    out = capsys.readouterr().out
    assert "[supervise] restart 1 after: injected failure at step 10" in out
    assert "[train] resumed from step 8" in out
    a = tckpt.restore(clean, device="cpu")
    b = tckpt.restore(crashy, device="cpu")
    assert a["step"] == b["step"] == 16 and a["extra"] == b["extra"]
    for name in ("theta", "codebooks", "log_alpha"):
        assert torch.equal(a["params"][name], b["params"][name]), name
        for i in (0, 1):            # Adam's two moments
            assert torch.equal(a["opt"]["inner"][i][name], b["opt"]["inner"][i][name])
    assert torch.equal(a["opt"]["step"], b["opt"]["step"])
    assert tckpt.all_steps(crashy) == [8, 12, 16]          # keep=3 rotation


def _jax_checkpoint(ckpt_dir: str, m: int = 4, k: int = 16):
    """A JAX-trained checkpoint (a few steps of the reference's ``fit``)
    and the reference's base graph cached where ``serve`` looks for it."""
    ds = j_load("unit-test")
    cfg = JRPQConfig(dim=ds.dim, m=m, k=k)
    train_graph = j_build_vamana(jax.random.PRNGKey(2), ds.train, r=8, l=16)
    tcfg = JT.TrainConfig(steps=3, triplet_batch=32, routing_batch=32,
                          routing_pool_queries=8, refresh_every=2, log_every=8)
    state = JT.fit(jax.random.PRNGKey(0), cfg, tcfg, ds.train, train_graph,
                   verbose=False)
    jckpt.save(ckpt_dir, 3, params=state.params, opt=state.opt_state,
               extra={"final": True, "dataset": "unit-test", "m": m, "k": k})
    graph = j_build_vamana(jax.random.PRNGKey(0), ds.base, r=8, l=16)
    np.savez(os.path.join(ckpt_dir, "graph_base.npz"),
             neighbors=np.asarray(graph.neighbors), medoid=np.asarray(graph.medoid))
    return ds, JT.to_model(cfg, state.params), graph


def test_port_serves_a_jax_checkpoint_with_jax_ids(tmp_path, capsys):
    d = str(tmp_path)
    ds, jmodel, jgraph = _jax_checkpoint(d)
    jcodes = jbase.encode(jmodel, ds.base)
    jlut = lambda q: jbase.build_lut(jmodel, q)
    engines = {"memory": JInMemory(jgraph, jcodes, jlut),
               "hybrid": JHybrid(jgraph, jcodes, jlut, vectors=ds.base)}
    for scenario, kw in (("memory", {}), ("hybrid", {}),
                         ("memory", {"entries": 8, "prune_eps": 0.2}),
                         ("hybrid", {"entries": 4, "expand": 2})):
        flags = [f"--{k.replace('_', '-')}={v}" for k, v in kw.items()]
        out = tserve.main(["--ckpt-dir", d, "--scenario", scenario, "--graph-r", "8",
                           "--graph-l", "16", "--device", "cpu"] + flags)
        want = engines[scenario].search(ds.queries, k=10, h=32, **kw)
        np.testing.assert_array_equal(out["result"].ids.numpy(), np.asarray(want.ids),
                                      err_msg=f"{scenario} {kw}")
        np.testing.assert_array_equal(out["result"].hops.numpy(), np.asarray(want.hops))
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[serve] ")]
    assert any("restored step 3 quantizer (M=4, K=16)" in l for l in lines)
    assert sum(l.startswith(("[serve] memory: recall@10=", "[serve] hybrid: recall@10="))
               for l in lines) == 4


def _tiny_port_checkpoint(ckpt_dir: str):
    ttrain.main(TRAIN_ARGV[:2] + ["--steps", "2"] + TRAIN_ARGV[4:]
                + ["--ckpt-dir", ckpt_dir])


def test_serve_cli_scenarios_budget_ladder_and_chaos(tmp_path, capsys):
    d = str(tmp_path)
    _tiny_port_checkpoint(d)
    capsys.readouterr()
    tserve.main(["--ckpt-dir", d, "--scenario", "hybrid", "--entries", "8",
                 "--prune-eps", "0.2", "--deadline-ms", "5", "--degrade-level", "2",
                 "--chaos", "io=0.05", "--graph-r", "8", "--graph-l", "16",
                 "--device", "cpu"])
    res = tserve.main(["--ckpt-dir", d, "--scenario", "sharded", "--chaos", "dead=0",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] chaos: transient I/O fault p=0.05" in out
    assert "max_rounds=" in out
    assert "[serve] chaos: 1/1 shard(s) dead" in out
    assert res["result"].degraded and bool((res["result"].ids == -1).all())
    assert "DEGRADED" in out


def test_serve_stdin_survives_garbage_lines(tmp_path, capsys, monkeypatch):
    d = str(tmp_path)
    _tiny_port_checkpoint(d)
    q = " ".join(["0.5"] * 32)
    monkeypatch.setattr("sys.stdin", io.StringIO(f"1 2 3\nnot numbers\n{q}\n\n"))
    tserve.main(["--ckpt-dir", d, "--scenario", "memory", "--port-stdin",
                 "--graph-r", "8", "--graph-l", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "!! expected 32 floats, got 3" in out
    assert "!! expected 32 floats, got unparseable input" in out
    assert "!! expected 32 floats, got 0" in out
    assert sum(l.startswith("ids=") for l in out) == 1


@pytest.mark.parametrize("scenario,item", [("sharded-graph", "item 14")])
def test_unported_scenario_exits_with_its_queue_item(tmp_path, capsys, scenario, item):
    """Every scenario of the reference is ported now: the one that waited
    for its queue item serves instead of exiting."""
    d = str(tmp_path)
    _tiny_port_checkpoint(d)
    capsys.readouterr()
    res = tserve.main(["--ckpt-dir", d, "--scenario", scenario, "--shards", "2",
                       "--graph-r", "8", "--graph-l", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "not ported" not in out and f"[serve] {scenario}: recall@10=" in out
    assert res["engine"].n_shards == 2 and res["result"].ids.shape[1] == 10


@pytest.mark.parametrize("batch", [1024, 64])
def test_graph_batch_reaches_the_builders(tmp_path, batch):
    """``--graph-batch`` (default 1024, the reference builder's batch) is the
    batch of every graph the drivers build: the cached graph and partition
    equal ``build_vamana`` / ``build_partitioned_vamana`` at that batch."""
    from repro_torch.graphs import build_vamana
    from repro_torch.graphs.partition import build_partitioned_vamana

    assert ttrain.parser().parse_args([]).graph_batch == 1024
    assert tserve.parser().parse_args(["--ckpt-dir", "d"]).graph_batch == 1024
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(0)
    g = ttrain.build_or_load_graph(gen(), x, str(tmp_path / "g.npz"), 8, 16, batch)
    want = build_vamana(x, generator=gen(), r=8, l=16, batch=batch, device="cpu")
    assert torch.equal(g.neighbors, want.neighbors) and int(g.medoid) == int(want.medoid)
    pg = tserve.build_or_load_partitioned_graph(gen(), x, str(tmp_path / "p.npz"), 2, 8, 16,
                                                batch)
    pwant = build_partitioned_vamana(x, 2, generator=gen(), r=8, l=16, batch=batch,
                                     device="cpu")
    assert torch.equal(pg.neighbors, pwant.neighbors)
    assert torch.equal(pg.medoids, pwant.medoids)


def test_drivers_refuse_the_cpu_unasked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--dataset", "unit-test", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--ckpt-dir", str(tmp_path), "--scenario", "memory"])
    assert not os.listdir(tmp_path)


def test_template_state_restores_the_driver_checkpoint_types(tmp_path):
    d = str(tmp_path)
    _tiny_port_checkpoint(d)
    from repro_torch.core import quantizer as Q
    from repro_torch.core import trainer as T
    cfg = Q.RPQConfig(dim=32, m=4, k=16)
    p, o = ttrain.template_state(cfg, T.TrainConfig(steps=2), "cpu")
    out = tckpt.restore(d, like={"params": p, "opt": o}, device="cpu")
    assert isinstance(out["params"], Q.RPQParams)
    assert out["params"].codebooks.shape == (4, 16, 8)
    assert int(out["opt"].step) == 2


def test_quickstart_twin_dry_run_on_cpu():
    """``examples/quickstart_torch.py --dry-run`` end to end, in a fresh
    interpreter without ``PYTHONPATH`` (the script puts ``src`` on its path
    itself, and so loads no JAX)."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "examples/quickstart_torch.py", "--dry-run",
                          "--device", "cpu"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "dataset: 400 base vectors, dim 32"
    assert [l[:3] for l in lines if l.startswith(("PQ ", "RPQ"))] == ["PQ ", "RPQ"]
