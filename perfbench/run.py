"""Run one cell of the benchmark of ``repro_torch``; see ``harness.py``.

    python3 -E perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``-E`` keeps ``PYTHONPATH`` out, so ``src/sitecustomize.py`` (which loads
the JAX package) never runs; this file puts the checkout and ``src`` on
``sys.path`` itself and keeps every build and kernel cache in the checkout.

Set-up is mostly host work, and ``import torch`` is most of it: the CUDA
driver's initialisation and the first card's primary context are made in a
thread meanwhile (``ctypes`` calls run without the interpreter's lock;
PyTorch later takes the same primary context), and the cyclic garbage
collector stays off through set-up and the window (``harness.run_window``
turns it on when its windows close).
"""

import time

T0 = time.perf_counter()

import ctypes  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

gc.disable()


def _cuda_context() -> None:
    """cuInit and the primary context of device 0; on any failure nothing,
    and PyTorch's own look for a card decides."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    if lib.cuInit(0) == 0 and lib.cuDeviceGet(ctypes.byref(dev), 0) == 0:
        lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)


ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
CUDA = threading.Thread(target=_cuda_context, daemon=True)
CUDA.start()
# the script's own folder would shadow modules such as the standard `trace`
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    CUDA.join()
    sys.exit(main(t_start=T0))
