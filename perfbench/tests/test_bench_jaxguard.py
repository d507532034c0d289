"""No module of JAX or of the JAX package is loaded by a run of any cell:
a subprocess started as BENCHMARK.json's command starts it (``-E``, with
``PYTHONPATH=src`` set as the tests set it) drives a run of each cell on
the CPU and lists the top-level names it loaded, compared whole (the port
``repro_torch`` begins with ``repro`` and passes)."""

import json
import os
import subprocess
import sys

from perfbench.tests.conftest import ROOT, TINY

CHILD = r"""
import io, json, sys
from contextlib import redirect_stdout
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
import tempfile
from perfbench import harness, index
index.CACHE = Path(tempfile.mkdtemp())
bench = harness.load_benchmark()
tiny = json.loads(sys.argv[2])
rcs = []
for cell in bench["workloads"]:
    for trace in (0, 1):
        argv = ["--workload", cell["name"], "--seed", "3", "--seconds", "1", "--trace", str(trace)]
        for k, v in tiny.items():
            argv += ["--dev-set", f"{k}={json.dumps(v)}"]
        with redirect_stdout(io.StringIO()):
            rcs.append(harness.main(argv, device="cpu"))
print(json.dumps({"rcs": rcs, "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_no_jax_in_a_run_of_any_cell():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run([sys.executable, "-E", "-c", CHILD, str(ROOT), json.dumps(TINY)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rcs"] and all(rc == 0 for rc in got["rcs"]), proc.stderr[-3000:]
    assert "repro_torch" in got["modules"] and "perfbench" in got["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])


def test_without_the_flag_the_guard_trips():
    """The same start without ``-E`` loads JAX through src/sitecustomize.py:
    the guard's comparison sees it, so the test above can fail."""
    env = dict(os.environ, PYTHONPATH="src")
    code = "import sys; print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'repro'}))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300).stdout
    assert "jax" in out
