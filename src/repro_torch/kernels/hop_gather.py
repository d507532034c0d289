"""Wrapper of the per-hop ADC kernel on pre-gathered rows
(``csrc/hop_gather.cu``).

Replaces ``repro/kernels/hop_gather.py::hop_gather``: the beam round's LUT
reduce over code rows the caller has already gathered, (Q, R, M) uint8 or
(K > 256) int32 codes × (Q, M, K) LUTs → (Q, R), in subspace chunks when a
LUT passes shared memory. ``hop_adc`` fuses the gather and supersedes it on
the serving path. It is bound by the per-query LUT bytes (16 MB at Q=1000,
M=16, K=256). Callers go through :func:`repro_torch.kernels.ops.hop_gather`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hop_adc import CODE_DTYPES, subspace_chunks

# kernel launches since the last reset (chip_smoke.py reads them)
launches = 0       # uint8 codes
launches_i32 = 0   # int32 codes (K > 256)

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("hop_gather").hop_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(codes: torch.Tensor, luts: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors, one launch per subspace chunk
    (``hop_adc.subspace_chunks``); no validation here."""
    global launches, launches_i32
    q, r, m = codes.shape
    k = luts.shape[2]
    if q and r:
        size = codes.element_size()
        for j0, j1 in subspace_chunks(m, k):
            err = _entry()(codes.data_ptr() + j0 * size, size, q, r, m,
                           luts.data_ptr() + j0 * k * 4, m * k, k, j1 - j0,
                           int(j0 > 0), out.data_ptr(),
                           _build.stream_handle(codes.device))
            _build.check("hop_gather", err)
            if codes.dtype == torch.int32:
                launches_i32 += 1
            else:
                launches += 1
    return out


def hop_gather(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(Q, R, M) uint8 or int32 codes × (Q, M, K) f32 LUTs → (Q, R) f32 on
    the card. Codes must be below K."""
    for name, t, dtypes in (("codes", codes, CODE_DTYPES),
                            ("luts", luts, (torch.float32,))):
        if t.device.type != "cuda" or t.device != codes.device:
            raise ValueError(f"hop_gather: {name} must be on {codes.device} (CUDA)")
        if t.dtype not in dtypes or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"hop_gather: {name} must be a contiguous 3-d "
                             f"{' or '.join(map(str, dtypes))} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    q, r, m = codes.shape
    if luts.shape[:2] != (q, m):
        raise ValueError(f"hop_gather: luts {tuple(luts.shape)} do not match "
                         f"codes {tuple(codes.shape)}")
    if q > 2**31 - 1:
        raise ValueError("hop_gather: at most 2**31 - 1 queries")
    out = torch.empty((q, r), dtype=torch.float32, device=codes.device)
    return launch(codes, luts, out)
