"""PyTorch + CUDA port of the RPQ serving path (the JAX package ``repro`` is
the reference).

Module paths and public names mirror ``src/repro/``: the counterpart of
``repro/search/beam.py`` is ``repro_torch/search/beam.py``, and so on. The
port imports ``torch`` and ``numpy`` only. Entry points (``load_dataset``,
``train_pq``, ``build_vamana``, the engines) run on ``cuda`` unless the
caller passes ``device="cpu"``; kernels are hand-written CUDA for
``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` at first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
