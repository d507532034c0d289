"""Wrapper of the per-hop ADC kernel on pre-gathered rows
(``csrc/hop_gather.cu``).

Replaces ``repro/kernels/hop_gather.py::hop_gather``: the beam round's LUT
reduce over code rows the caller has already gathered, (Q, R, M) codes ×
(Q, M, K) LUTs → (Q, R). ``hop_adc`` fuses the gather and supersedes it on
the serving path. It is bound by the per-query LUT bytes (16 MB at Q=1000,
M=16, K=256). Callers go through :func:`repro_torch.kernels.ops.hop_gather`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("hop_gather").hop_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(codes: torch.Tensor, luts: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors; no validation here."""
    global launches
    q, r, m = codes.shape
    if q and r:
        err = _entry()(codes.data_ptr(), q, r, m, luts.data_ptr(), luts.shape[2],
                       out.data_ptr(), _build.stream_handle(codes.device))
        _build.check("hop_gather", err)
        launches += 1
    return out


def hop_gather(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(Q, R, M) uint8 codes × (Q, M, K) f32 LUTs → (Q, R) f32 on the card."""
    for name, t, dtype in (("codes", codes, torch.uint8),
                           ("luts", luts, torch.float32)):
        if t.device.type != "cuda" or t.device != codes.device:
            raise ValueError(f"hop_gather: {name} must be on {codes.device} (CUDA)")
        if t.dtype != dtype or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"hop_gather: {name} must be a contiguous 3-d "
                             f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    q, r, m = codes.shape
    if luts.shape[:2] != (q, m):
        raise ValueError(f"hop_gather: luts {tuple(luts.shape)} do not match "
                         f"codes {tuple(codes.shape)}")
    if luts.shape[2] > 256:
        raise ValueError("hop_gather: uint8 codes address at most K=256 codewords")
    if m * luts.shape[2] * 4 > 200 * 1024:
        raise ValueError("hop_gather: one query's LUT must fit in shared memory")
    if q > 2**31 - 1:
        raise ValueError("hop_gather: at most 2**31 - 1 queries")
    out = torch.empty((q, r), dtype=torch.float32, device=codes.device)
    return launch(codes, luts, out)
