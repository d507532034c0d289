"""Shared pieces of the benchmark's CPU tests: a tiny size of each cell and
an in-process run of the harness on the CPU (the card tests are marked
``cuda`` and look for a card inside the test)."""

import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# a size at which a cell's whole run takes seconds on the CPU
TINY = {"n_base": 3000, "graph_r": 16, "graph_l": 32, "graph_batch": 512,
        "train_steps": 2, "batch": 400, "max_batch": 400, "rate_qps": 300}


def tiny_args(workload, seed=7, seconds=1.5, trace=0):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    for k, v in TINY.items():
        argv += ["--dev-set", f"{k}={json.dumps(v)}"]
    return argv


@pytest.fixture(scope="session")
def index_cache(tmp_path_factory):
    """One index cache for the session's runs: each tiny index is built once."""
    from perfbench import index

    path = tmp_path_factory.mktemp("index_cache")
    old, index.CACHE = index.CACHE, path
    yield path
    index.CACHE = old


def run_cpu(argv, **kw):
    """harness.main on the CPU; returns (exit code, result dict or None).
    The look for JAX is left to ``test_bench_jaxguard.py``'s subprocess:
    this process may have loaded it through ``src/sitecustomize.py``."""
    from perfbench import harness

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.main(argv, device="cpu", forbidden=(), **kw)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
