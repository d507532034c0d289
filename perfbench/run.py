"""Run one cell of the benchmark of ``repro_torch``; see ``harness.py``.

    python3 -E perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``-E`` keeps ``PYTHONPATH`` out, so ``src/sitecustomize.py`` (which loads
the JAX package) never runs; this file puts the checkout and ``src`` on
``sys.path`` itself and keeps every build and kernel cache in the checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# the script's own folder would shadow modules such as the standard `trace`
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T0))
